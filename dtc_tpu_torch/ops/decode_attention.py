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
the one to the other. ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e9

#: Smallest per-head amplitude the int8 quantizer treats as non-zero, so
#: all-zero heads (fresh cache rows) round-trip exactly.
KV_SCALE_FLOOR = 1e-8

#: Head dims the kernel is instantiated for.
KERNEL_HEAD_DIMS = (16, 32, 64, 128)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

#: Kernel launches since the last reset (the wrapper adds one per launch,
#: nowhere else).
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


def decode_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, start, *, h: int,
    d: int, k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain version of the kernel's arithmetic, which is the TPU
    kernel's: q is scaled by ``d**-0.5`` in q's dtype; k/v are brought to
    q's dtype (int8 dequantized per head first); scores are fp32 and
    masked to ``col <= start`` with -1e9; one-pass softmax; p is cast to
    v's (that is q's) dtype before the fp32-accumulated PV product; the
    result is cast to q's dtype. Returns ``(B, 1, H·D)``."""
    _check(q, k, v, h, d, k_scale, v_scale)
    b, _, hd = q.shape
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
    mask = torch.arange(s, device=q.device)[None, :] <= st[:, None].long()
    sc = torch.where(mask[:, None, :], sc, NEG_INF)
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhs,bshd->bhd", p.to(vh.dtype).float(), vh.float())
    return (acc / l).to(qdt).reshape(b, 1, hd)


def fused_decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, start, *, h: int,
    d: int, k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Decode attention on the packed cache, for any cache length. CPU
    tensors take :func:`decode_attention_reference`; CUDA tensors launch
    the Hopper kernel on the current stream, with the output allocated
    here, and raise if the library cannot be built or loaded or the launch
    fails. Replaces the JAX package's ``fused_decode_attention`` (both its
    single-tile and blocked kernels)."""
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

    lib = _build.load("decode_attention")
    b, _, hd = q.shape
    s = k.shape[1]
    start, per_row = _frontier(start, b, q.device)
    out = torch.empty_like(q)
    # The scale is rounded to q's dtype first, as the reference rounds it.
    scale = float(torch.tensor(d ** -0.5, dtype=q.dtype))
    null = ctypes.c_void_p(0)
    rc = lib.dtc_decode_attention(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()),
        ctypes.c_void_p(k_scale.data_ptr()) if k_scale is not None else null,
        ctypes.c_void_p(v_scale.data_ptr()) if v_scale is not None else null,
        ctypes.c_void_p(start.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        b, s, h, d, int(per_row), ctypes.c_float(scale),
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype],
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    if rc != 0:
        raise RuntimeError(
            f"decode attention kernel launch failed: {_build.error_string(lib, rc)}"
        )
    launches += 1
    return out
