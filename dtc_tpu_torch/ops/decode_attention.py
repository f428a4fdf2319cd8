"""Single-query decode attention over the packed KV cache — one kernel
launch per layer per token.

The cache is ``(B, S, H·D)``, the byte layout the k/v projections write.
The query is ONE new token at position ``start`` (its own k/v already
written there), so cache columns ``col <= start`` are valid. ``start`` is
a scalar (every row at one position, the ``generate`` path) or a ``(B,)``
vector (the serving slots, each at its own frontier). An int8 cache
carries ``(B, S, H)`` fp32 per-(position, head) scales and is dequantized
in registers.

:func:`fused_decode_attention` is the wrapper: on a CUDA tensor it
launches the hand-written Hopper kernel ``csrc/decode_attention.cu`` (or
raises), on a CPU tensor it runs :func:`decode_attention_reference`, the
plain PyTorch version of the same arithmetic. There is no fallback from
the one to the other. ``launches`` counts the wrapper's calls that
launched the kernel.

The kernel is split-KV (flash-decoding): each row's visible columns are
cut into splits of :func:`split_len` positions, each split's softmax is
taken against its own max, and the float32 partials are combined in
split order by a second, small kernel. :func:`decode_split_twin` is the eager PyTorch twin of that
schedule, for the tests; the main path never calls it.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e9

#: Smallest per-head amplitude the int8 quantizer treats as non-zero, so
#: all-zero heads (fresh cache rows) round-trip exactly.
KV_SCALE_FLOOR = 1e-8

#: Head dims the kernel is instantiated for: the flash kernels' set.
KERNEL_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)

#: Positions times threads of one of the kernel's splits: its block's
#: threads times the positions each holds (``csrc/decode_attention.cu``
#: kThreads × kPerGroup).
SPLIT_THREAD_POSITIONS = 1024

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

#: Wrapper calls that launched the kernel since the last reset (the
#: wrapper adds one where it launches, nowhere else).
launches = 0


def quantize_kv(x: torch.Tensor, n_heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(position, head) int8 quantization of a packed
    ``(..., H·D)`` tensor: scale ``max(|x|)/127`` per head (floored at
    :data:`KV_SCALE_FLOOR`), round half to even, clip to ±127. Returns
    ``(int8 payload of x's shape, fp32 scales (..., H))``."""
    *lead, hd = x.shape
    d = hd // n_heads
    xr = x.reshape(*lead, n_heads, d).float()
    amax = xr.abs().amax(dim=-1)
    scale = torch.clamp_min(amax, KV_SCALE_FLOOR) / 127.0
    q = torch.clamp(torch.round(xr / scale[..., None]), -127.0, 127.0)
    return q.to(torch.int8).reshape(x.shape), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, n_heads: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: int8 payload + fp32 scales ->
    ``dtype`` values of the payload's shape."""
    *lead, hd = q.shape
    d = hd // n_heads
    qr = q.reshape(*lead, n_heads, d).float()
    return (qr * scale[..., None]).reshape(q.shape).to(dtype)


def _frontier(start, b: int, device) -> tuple[torch.Tensor, bool]:
    """``start`` as an int32 tensor on ``device`` plus whether it is one
    frontier per row (only a ``(B,)`` vector with B > 1 is)."""
    start = torch.as_tensor(start, dtype=torch.int32, device=device)
    per_row = start.ndim == 1 and start.shape[0] == b and b > 1
    if not per_row:
        if start.numel() != 1:
            raise ValueError(
                f"start must be a scalar or ({b},), got shape {tuple(start.shape)}"
            )
        start = start.reshape(1)
    return start.contiguous(), per_row


def _check(q, k, v, h, d, k_scale, v_scale) -> None:
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError("q, k, v must be (B, 1, H·D), (B, S, H·D), (B, S, H·D)")
    b, t, hd = q.shape
    if t != 1:
        raise ValueError(f"fused decode attention is single-query; got T={t}")
    if hd != h * d:
        raise ValueError(f"packed width {hd} != n_heads*head_dim {h}*{d}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != hd:
        raise ValueError(
            f"cache shapes {tuple(k.shape)}/{tuple(v.shape)} do not match "
            f"q {tuple(q.shape)}"
        )
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    if (k_scale is not None) != (k.dtype == torch.int8):
        raise ValueError("an int8 cache needs scales, and scales an int8 cache")
    if k_scale is not None:
        want = (b, k.shape[1], h)
        if tuple(k_scale.shape) != want or tuple(v_scale.shape) != want:
            raise ValueError(f"scales must be {want}")


def _scores(q, k, v, start, h, d, k_scale, v_scale):
    """What the reference and the twin share: fp32 scores ``(B, H, S)`` of
    q scaled by ``d**-0.5`` in q's dtype against k in q's dtype (int8
    dequantized per head first), v ``(B, S, H, D)`` in q's dtype, and the
    visible columns of each row, ``n = clamp(start + 1, 1, S)``."""
    _check(q, k, v, h, d, k_scale, v_scale)
    b = q.shape[0]
    s = k.shape[1]
    qdt = q.dtype
    start, per_row = _frontier(start, b, q.device)
    qs = (q.reshape(b, h, d) * torch.tensor(d ** -0.5, dtype=qdt)).float()
    kh, vh = k.reshape(b, s, h, d), v.reshape(b, s, h, d)
    if k_scale is not None:
        kh = (kh.float() * k_scale[..., None]).to(qdt)
        vh = (vh.float() * v_scale[..., None]).to(qdt)
    else:
        kh, vh = kh.to(qdt), vh.to(qdt)
    sc = torch.einsum("bhd,bshd->bhs", qs, kh.float())
    st = start if per_row else start.expand(b)
    return sc, vh, (st.long() + 1).clamp(1, s)


def decode_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, start, *, h: int,
    d: int, k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain version of the kernel's arithmetic, in the TPU kernel's
    single-tile form: q is scaled by ``d**-0.5`` in q's dtype; k/v are
    brought to q's dtype (int8 dequantized per head first); scores are
    fp32 and masked to ``col <= start`` with -1e9; one-pass softmax; p is
    cast to v's (that is q's) dtype before the fp32-accumulated PV
    product; the result is cast to q's dtype. Returns ``(B, 1, H·D)``."""
    b, _, hd = q.shape
    sc, vh, n = _scores(q, k, v, start, h, d, k_scale, v_scale)
    mask = torch.arange(k.shape[1], device=q.device)[None, :] < n[:, None]
    sc = torch.where(mask[:, None, :], sc, NEG_INF)
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhs,bshd->bhd", p.to(vh.dtype).float(), vh.float())
    return (acc / l).to(q.dtype).reshape(b, 1, hd)


def split_len(d: int, kv_dtype: torch.dtype) -> int:
    """Positions in one of the kernel's splits at head dim ``d`` over a
    ``kv_dtype`` cache (``csrc/decode_attention.cu`` Geometry): a thread
    holds one 16-byte chunk of a head row and a group of threads (the
    chunk count rounded up to a power of two) one position, so a split is
    :data:`SPLIT_THREAD_POSITIONS` over the group. The boundaries depend
    on position alone."""
    chunks = max(1, -(-d * kv_dtype.itemsize // 16))
    group = 1 << (chunks - 1).bit_length()
    return max(1, SPLIT_THREAD_POSITIONS // group)


def split_partials(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, start, *, h: int,
    d: int, k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's per-split float32 partials ``(m, l, acc, live)``: m
    and l ``(B, H, J)``, acc ``(B, H, J, D)``, live ``(B, J)`` (the split
    holds a visible column), J = ceil(S / :func:`split_len`). Split j of
    a row covers its visible columns ``[j·L, min((j+1)·L, n))``: m is
    their max score, p = exp(s - m) in fp32, l the sum of p, acc the
    fp32 sum of p rounded to q's dtype times v. A dead split holds
    zeros."""
    b = q.shape[0]
    s = k.shape[1]
    sc, vh, n = _scores(q, k, v, start, h, d, k_scale, v_scale)
    sl = split_len(d, k.dtype)
    j = -(-s // sl)
    pad = j * sl - s
    visible = torch.arange(j * sl, device=q.device)[None, :] < n[:, None]  # (B, J·L)
    sc = torch.nn.functional.pad(sc, (0, pad))
    sc = torch.where(visible[:, None, :], sc, -torch.inf).view(b, h, j, sl)
    live = visible.view(b, j, sl)[..., 0]
    m = torch.where(live[:, None, :], sc.amax(dim=-1), 0.0)
    p = torch.where(visible.view(b, 1, j, sl), torch.exp(sc - m[..., None]), 0.0)
    vs = torch.nn.functional.pad(vh, (0, 0, 0, 0, 0, pad)).view(b, j, sl, h, d)
    acc = torch.einsum("bhjl,bjlhd->bhjd", p.to(vh.dtype).float(), vs.float())
    return m, p.sum(dim=-1), acc, live


def combine_splits(m, l, acc, live, dtype: torch.dtype) -> torch.Tensor:
    """The kernel's combine of :func:`split_partials`: M is the max of the
    live splits' m, w_j = exp(m_j - M) in fp32 (0 for a dead split), and
    the output ``sum_j w_j acc_j / sum_j w_j l_j``, summed in split order
    and cast to ``dtype``. Returns ``(B, 1, H·D)``."""
    b, h, j, d = acc.shape
    live = live[:, None, :]
    big = torch.where(live, m, -torch.inf).amax(dim=-1, keepdim=True)
    w = torch.where(live, torch.exp(m - big), 0.0)
    num = torch.zeros(b, h, d, dtype=torch.float32, device=acc.device)
    den = torch.zeros(b, h, dtype=torch.float32, device=acc.device)
    for i in range(j):  # split order, as the kernel sums
        num = num + acc[:, :, i] * w[:, :, i, None]
        den = den + l[:, :, i] * w[:, :, i]
    return (num / den[..., None]).to(dtype).reshape(b, 1, h * d)


def decode_split_twin(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, start, *, h: int,
    d: int, k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Eager PyTorch twin of the kernel's split schedule: the same splits,
    p rounded against each split's max, the partials combined in split
    order (:func:`split_partials`, :func:`combine_splits`). For tests;
    the main path never calls it. Returns ``(B, 1, H·D)``."""
    parts = split_partials(q, k, v, start, h=h, d=d, k_scale=k_scale, v_scale=v_scale)
    return combine_splits(*parts, q.dtype)


def _launch(lib, q, k, v, start, *, h, d, k_scale=None, v_scale=None) -> torch.Tensor:
    """One call of ``lib``'s ``dtc_decode_attention`` (a split-KV decode
    library, this checkout's or another's) on checked CUDA tensors, on the
    current stream, with the output and the call's scratch for the
    partials allocated here. Raises ValueError where the library has no
    instance at ``d`` and RuntimeError where it refuses the call or a
    launch fails."""
    b = q.shape[0]
    s = k.shape[1]
    sl = lib.dtc_decode_split_len(_DTYPE_CODES[k.dtype], d)
    if sl == 0:
        raise ValueError(f"the decode library has no instance at head_dim {d}")
    start, per_row = _frontier(start, b, q.device)
    out = torch.empty_like(q)
    splits = -(-s // sl)
    part = (torch.empty(b * h * splits * (d + 2), dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    # The scale is rounded to q's dtype first, as the reference rounds it.
    scale = float(torch.tensor(d ** -0.5, dtype=q.dtype))
    null = ctypes.c_void_p(0)
    rc = lib.dtc_decode_attention(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()),
        ctypes.c_void_p(k_scale.data_ptr()) if k_scale is not None else null,
        ctypes.c_void_p(v_scale.data_ptr()) if v_scale is not None else null,
        ctypes.c_void_p(start.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(part.data_ptr()) if part is not None else null,
        part.numel() if part is not None else 0,
        b, s, h, d, int(per_row), ctypes.c_float(scale),
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype], ctypes.c_void_p(stream),
    )
    if rc != 0:
        from dtc_tpu_torch.ops import _build

        raise RuntimeError(
            f"decode attention kernel launch failed: {_build.error_string(lib, rc)}"
        )
    return out


def fused_decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, start, *, h: int,
    d: int, k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Decode attention on the packed cache, for any cache length. CPU
    tensors take :func:`decode_attention_reference`; CUDA tensors launch
    the Hopper kernels on the current stream (:func:`_launch`): the split
    kernel, then, where the cache holds more than one split, the small
    kernel that combines the partials (two launches, counted as one call
    in ``launches``). Raises if the library cannot be built or loaded or a
    launch fails. Replaces the JAX package's ``fused_decode_attention``
    (both its single-tile and blocked kernels)."""
    global launches
    _check(q, k, v, h, d, k_scale, v_scale)
    if q.device.type == "cpu":
        return decode_attention_reference(
            q, k, v, start, h=h, d=d, k_scale=k_scale, v_scale=v_scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    tensors = [q, k, v] + ([k_scale, v_scale] if k_scale is not None else [])
    if any(x.device != q.device for x in tensors):
        raise ValueError("q, k, v (and scales) must be on one device")
    if any(not x.is_contiguous() for x in tensors):
        raise ValueError("q, k, v (and scales) must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != v.dtype or k.dtype not in _DTYPE_CODES:
        raise ValueError(f"cache must be float32, bfloat16 or int8, got {k.dtype}")
    if k_scale is not None and (
        k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
    ):
        raise ValueError("scales must be float32")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in the kernel's {KERNEL_HEAD_DIMS}")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("q, k, v must be 16-byte aligned")
    from dtc_tpu_torch.ops import _build

    out = _launch(_build.load("decode_attention"), q, k, v, start, h=h, d=d,
                  k_scale=k_scale, v_scale=v_scale)
    launches += 1
    return out
