"""Causal flash attention for training: forward and backward kernels.

The public function is :func:`flash_causal_attention` over ``(B, T, H, D)``
tensors, the JAX package's layout; inside, q, k, v are the packed
``(B, T, H·D)`` bytes the projections write (a reshape, no copy), and the
log-sum-exp travels as ``(B, H, T)`` float32.

Arithmetic (the TPU kernels' rounding points, ``dtc_tpu/ops/
flash_attention.py`` ``_packed_scores`` / ``_packed_tile_bwd``): q is
scaled by ``D**-0.5`` in q's dtype with the scale rounded to that dtype;
scores are float32, masked to key <= query; one-pass softmax per row; p is
cast to v's dtype before the float32-accumulated P·V product;
``out = acc / l`` in q's dtype and ``lse = m + log l``. The backward
recomputes ``p = exp(s - lse)``, ``delta = rowsum(dO ⊙ O)`` in float32,
``ds = p·(dO·Vᵀ - delta)``, ``dq = (ds in k's dtype)·K·scale``,
``dk = (ds in q's dtype)ᵀ·(q scaled)``, ``dv = (p in dO's dtype)ᵀ·dO``.

:func:`flash_attention_forward` and :func:`flash_attention_backward` are
the wrappers: on a CUDA tensor they launch the hand-written Hopper kernels
in ``csrc/flash_attention.cu`` (or raise), on a CPU tensor they run
:func:`flash_attention_reference` / :func:`flash_attention_backward_reference`,
the plain PyTorch versions of the same arithmetic. There is no fallback
from the one to the other. ``fwd_launches`` and ``bwd_launches`` count
kernel launches (the backward launches two kernels per call: dq, then
dk/dv).

The kernels take any T and any head count, and every head dim in
:data:`KERNEL_HEAD_DIMS`. So they stand for all of the JAX package's
flash kernels that run on one chip: the packed ones, the split backward
it takes past T 4096 (``_dq_kernel_packed`` / ``_dkv_kernel_packed``), and
the transpose-layout family it takes where 128-lane head groups do not fit
(``_flash``). The TPU tilings (``attention_block_*``) do not apply: the
kernels' tiles are 64 x 64 at every T.

The same kernels, without the causal mask and with float32 gradients, are
the zigzag ring's block kernels (``_block_fwd_kernel`` /
``_block_bwd_kernel``, reached through ``_block_call``):
:func:`flash_block_forward` gives ``(out in q's dtype, lse)`` over one
``(B, tc, H·D)`` chunk pair, causal or not; :func:`flash_block_backward`
takes the ring's merged lse and out (delta comes from them) and returns
float32 ``(dq, dk, dv)`` whatever the inputs' dtype. Their plain versions
are :func:`flash_block_reference` / :func:`flash_block_backward_reference`;
``block_fwd_launches`` / ``block_bwd_launches`` count their launches apart
from the causal wrappers'. The JAX package keeps a block's lse as
``(B, H·D/128, tc, 128/D)``; the port keeps ``(B, H, tc)`` as everywhere.

Routes. :func:`flash_plan` chooses, before each launch, the kernel a
forward, dq or dk/dv launch takes from the dtype and head dim alone:
bfloat16 goes to the tensor cores (route ``"tc"``: ``wgmma`` on tiles that
TMA stages in shared memory, swizzled to the widest atom that divides D,
library ``flash_attention_tc``), float32 to the CUDA cores (``"fma"``,
library ``flash_attention``; TF32 would break float32's 1e-5 limit).
``fwd_route_launches``, ``dq_route_launches`` and ``dkv_route_launches``
count the three kinds of launch by route. On a CUDA tensor a plan's
kernel launches or the wrapper raises; nothing falls back to another
kernel or to the plain version. The tensor-core forward takes the softmax
in one pass with an online rescale, as JAX's ``_fwd_kernel_packed_multi``
does; :func:`flash_forward_twin` is its eager twin for the tests, and the
two-pass plain version holds it within the same limit as the CUDA-core
kernels. The tensor-core dq kernel sums dQ over 64-key tiles in float32,
dS rounded to k's dtype a tile at a time; :func:`flash_dq_twin` is its
eager twin.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

NEG_INF = -1e9

#: Head dims the kernels are instantiated for: every multiple of 16 up to
#: 128. The JAX package's transpose-layout kernels also take head dims up
#: to 512; those are still to port (ROADMAP.md §B).
KERNEL_HEAD_DIMS = tuple(range(16, 129, 16))

#: Kernels one backward call launches (dq + delta, then dk/dv).
BWD_KERNELS = 2

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches since the last reset (the wrappers add one per launch,
#: nowhere else): the causal wrappers' and the ring blocks', and the
#: forward, dq and dk/dv launches of both by their plan's route.
fwd_launches = 0
bwd_launches = 0
block_fwd_launches = 0
block_bwd_launches = 0
fwd_route_launches = {"tc": 0, "fma": 0}
dq_route_launches = {"tc": 0, "fma": 0}
dkv_route_launches = {"tc": 0, "fma": 0}


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """How a forward, dq or dk/dv launch runs. ``route`` ``"tc"`` (bfloat16:
    tensor cores, tiles staged by TMA) or ``"fma"`` (float32: CUDA cores);
    ``tile``: the rows of a q and of a KV tile. For ``"tc"``: ``swizzle``,
    the bytes of a staged box row (128, 64 or 32: the widest swizzle atom
    whose width in bf16 divides D), ``boxes`` the boxes a 64 x D tile (TMA's
    box may be no wider than its swizzle), ``stages`` the shared-memory
    stages (as many two-tile stages as 64 KB holds, 2 to 4); 0 for
    ``"fma"``."""

    route: str
    tile: int
    swizzle: int
    boxes: int
    stages: int


#: The kernels' tile: 64 query rows, 64 keys.
TILE = 64


@functools.lru_cache(maxsize=None)
def flash_plan(dtype: torch.dtype, d: int, causal: bool) -> FlashPlan:
    """The plan of a forward, dq or dk/dv launch on inputs of ``dtype`` at
    head dim ``d`` (the causal mask is a runtime flag of either route; the
    three kernels share a route's box geometry and stage count). Raises
    ``ValueError`` for a head dim or dtype no kernel takes."""
    check_head_dim(d)
    if dtype == torch.float32:
        return FlashPlan("fma", TILE, 0, 0, 0)
    if dtype != torch.bfloat16:
        raise ValueError(f"flash kernels: unsupported dtype {dtype}")
    width = 64 if d % 64 == 0 else 32 if d % 32 == 0 else 16
    tile_bytes = TILE * d * 2
    stages = max(2, min(4, 65536 // (2 * tile_bytes)))
    return FlashPlan("tc", TILE, 2 * width, d // width, stages)


#: The tensor-core kernels' dynamic shared memory a block, by kind: the
#: C library's ``TcGeo`` (1 KB of alignment slack; Q, or K and V, or Q, dO
#: and O loaded once; the plan's stages; per-row statistics; barriers).
_TC_SMEM = {
    "fwd": lambda tile, st: 1024 + tile + st * 2 * tile + 9 * 8,
    "dkv": lambda tile, st: 1024 + 2 * tile + st * (2 * tile + 2 * TILE * 4) + 13 * 8,
    "dq": lambda tile, st: 1024 + 3 * tile + st * 2 * tile + 2 * TILE * 4 + 9 * 8,
}


def tc_smem_bytes(kind: str, d: int) -> int:
    """Dynamic shared memory a block of the tensor-core ``kind`` kernel
    (``"fwd"``, ``"dkv"`` or ``"dq"``) takes at head dim ``d`` under its
    plan; the card's library reports the same (``dtc_flash_tc_smem_bytes``)."""
    plan = flash_plan(torch.bfloat16, d, True)
    return _TC_SMEM[kind](TILE * d * 2, plan.stages)


def _scale_q(d: int, dtype: torch.dtype) -> float:
    """``D**-0.5`` rounded to q's dtype, as the reference's weakly typed
    Python scalar is when it multiplies a q tile. Multiplying a q tensor by
    it rounds once, to q's dtype, as the reference's product does."""
    return float(torch.tensor(d ** -0.5, dtype=dtype))


def _scale(d: int) -> float:
    """``D**-0.5`` in float32: the factor the backward applies to dq."""
    return float(torch.tensor(d ** -0.5, dtype=torch.float32))


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, t, hd = x.shape
    return x.reshape(b, t, h, hd // h)


def _causal(t: int, device) -> torch.Tensor:
    ar = torch.arange(t, device=device)
    return ar[None, :] <= ar[:, None]                     # (query, key)


def flash_attention_reference(q, k, v, h: int, causal: bool = True):
    """Plain version of the forward kernel on packed ``(B, T, H·D)``
    tensors, causal unless ``causal`` is false. Returns ``(out (B, T, H·D)
    in q's dtype, lse (B, H, T) float32)``."""
    b, t, hd = q.shape
    d = hd // h
    qs = _heads(q, h) * _scale_q(d, q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), _heads(k, h).float())
    if causal:
        s = torch.where(_causal(t, q.device), s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), _heads(v, h).float())
    out = (acc / l).to(q.dtype).permute(0, 2, 1, 3).reshape(b, t, hd)
    return out, (m + torch.log(l)).squeeze(-1)


def flash_attention_backward_reference(q, k, v, out, lse, do, h: int, causal: bool = True,
                                       grad_dtype: torch.dtype | None = None):
    """Plain version of the backward kernels. Returns ``(dq, dk, dv)``,
    each packed ``(B, T, H·D)`` in ``grad_dtype``, or in its input's dtype
    when that is None."""
    b, t, hd = q.shape
    d = hd // h
    qs = _heads(q, h) * _scale_q(d, q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), _heads(k, h).float())
    p = torch.exp(s - lse[..., None])
    if causal:
        p = torch.where(_causal(t, q.device), p, 0.0)
    do4 = _heads(do, h)
    delta = (do4.float() * _heads(out, h).float()).sum(-1).permute(0, 2, 1)  # (B, H, T)
    dp = torch.einsum("bqhd,bkhd->bhqk", do4.float(), _heads(v, h).float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), _heads(k, h).float())
    dq = dq * _scale(d)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), qs.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do4.float())
    return tuple(
        g.to(grad_dtype or x.dtype).reshape(b, t, hd) for g, x in ((dq, q), (dk, k), (dv, v))
    )


def flash_forward_twin(q, k, v, h: int, causal: bool = True, key_tile: int = TILE,
                       rows: tuple[int, int] | None = None):
    """Eager twin of the tensor-core forward's tiling, for the tests (the
    port never calls it): one pass over key tiles of ``key_tile`` with an
    online rescale, at the kernel's rounding points (q scaled in its dtype;
    float32 scores; ``m``, ``l`` and ``acc`` rescaled by ``exp(m_old -
    m_new)``; ``p = exp(s - m_new)`` summed unrounded into ``l`` and cast to
    v's dtype for P·V; ``out = acc / l`` in q's dtype, ``lse = m + log l``).
    ``rows``: only query rows ``[start, stop)`` (the keys up to ``stop``).
    Returns ``(out (B, rows, H·D), lse (B, H, rows))``."""
    b, t, hd = q.shape
    d = hd // h
    r0, r1 = rows or (0, t)
    qs = (_heads(q[:, r0:r1], h) * _scale_q(d, q.dtype)).float()
    kf, vf = _heads(k, h).float(), _heads(v, h)
    row = torch.arange(r0, r1, device=q.device)[:, None]
    m = torch.full((b, h, r1 - r0), -torch.inf, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(b, h, r1 - r0, d, device=q.device)
    for k0 in range(0, r1 if causal else t, key_tile):
        k1 = min(k0 + key_tile, t)
        s = torch.einsum("bqhd,bkhd->bhqk", qs, kf[:, k0:k1])
        key = torch.arange(k0, k1, device=q.device)[None, :]
        s = torch.where(key <= row if causal else key < t, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), vf[:, k0:k1].float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = (acc / l[..., None]).to(q.dtype).permute(0, 2, 1, 3).reshape(b, r1 - r0, hd)
    return out, m + torch.log(l)


def flash_dq_twin(q, k, v, out, lse, do, h: int, causal: bool = True, key_tile: int = TILE,
                  grad_dtype: torch.dtype | None = None):
    """Eager twin of the tensor-core dq kernel's tiling, for the tests (the
    port never calls it): delta = rowsum(dO ⊙ O) in float32 from the rows
    as staged; then, over key tiles of ``key_tile``, p = exp(s - lse)
    (masked to key <= query under ``causal``; keys past T never exist
    here), dS = p·(dP - delta) rounded to k's dtype, dQ += dS·K summed a
    tile at a time in float32; dq = dQ × the float32 ``D**-0.5`` in
    ``grad_dtype`` (q's dtype when None). Returns ``(dq (B, T, H·D),
    delta (B, H, T))``."""
    b, t, hd = q.shape
    d = hd // h
    qs = (_heads(q, h) * _scale_q(d, q.dtype)).float()
    do4 = _heads(do, h).float()
    delta = (do4 * _heads(out, h).float()).sum(-1).permute(0, 2, 1)
    kf, vf = _heads(k, h).float(), _heads(v, h).float()
    row = torch.arange(t, device=q.device)[:, None]
    acc = torch.zeros(b, h, t, d, device=q.device)
    for k0 in range(0, t, key_tile):
        k1 = min(k0 + key_tile, t)
        s = torch.einsum("bqhd,bkhd->bhqk", qs, kf[:, k0:k1])
        p = torch.exp(s - lse[..., None])
        if causal:
            p = torch.where(torch.arange(k0, k1, device=q.device)[None, :] <= row, p, 0.0)
        dp = torch.einsum("bqhd,bkhd->bhqk", do4, vf[:, k0:k1])
        ds = (p * (dp - delta[..., None])).to(k.dtype).float()
        acc = acc + torch.einsum("bhqk,bkhd->bhqd", ds, kf[:, k0:k1])
    dq = (acc * _scale(d)).to(grad_dtype or q.dtype)
    return dq.permute(0, 2, 1, 3).reshape(b, t, hd), delta


def flash_block_reference(q, k, v, h: int, causal: bool):
    """Plain version of the ring's block forward: attention of one chunk
    pair, causal (the diagonal pair) or not. ``(out, lse)`` as
    :func:`flash_attention_reference`."""
    return flash_attention_reference(q, k, v, h, causal)


def flash_block_backward_reference(q, k, v, out, lse, do, h: int, causal: bool):
    """Plain version of the ring's block backward from the ring's merged
    ``out`` and ``lse``: float32 ``(dq, dk, dv)``."""
    return flash_attention_backward_reference(q, k, v, out, lse, do, h, causal, torch.float32)


def _check(h: int, *xs: torch.Tensor) -> None:
    q = xs[0]
    if q.ndim != 3:
        raise ValueError(f"expected packed (B, T, H·D) tensors, got {tuple(q.shape)}")
    if q.shape[2] % h:
        raise ValueError(f"packed width {q.shape[2]} not divisible by {h} heads")
    for x in xs[1:]:
        if x.shape != q.shape:
            raise ValueError(f"shape {tuple(x.shape)} != {tuple(q.shape)}")


def _check_cuda(h: int, *xs: torch.Tensor) -> None:
    """What the kernels take: CUDA tensors on one device, contiguous,
    float32 or bfloat16 alike, a compiled head dim."""
    q = xs[0]
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if any(x.device != q.device for x in xs):
        raise ValueError("all inputs must be on one device")
    if any(not x.is_contiguous() for x in xs):
        raise ValueError("all inputs must be contiguous")
    if q.dtype not in _DTYPE_CODES or any(x.dtype != q.dtype for x in xs):
        raise ValueError(
            f"inputs must all be float32 or all bfloat16, got {[x.dtype for x in xs]}"
        )
    check_head_dim(q.shape[2] // h)


def check_head_dim(d: int) -> None:
    """Raise ``ValueError`` unless the kernels have an instance for head
    dim ``d``."""
    if d > KERNEL_HEAD_DIMS[-1]:
        raise ValueError(
            f"head_dim {d}: the flash kernels stop at {KERNEL_HEAD_DIMS[-1]}; head dims "
            "up to 512 (the JAX package's transpose-layout kernels) are still to port "
            "(ROADMAP.md §B)"
        )
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in the kernels' {KERNEL_HEAD_DIMS}")


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        from dtc_tpu_torch.ops import _build

        raise RuntimeError(f"flash attention {what} launch failed: {_build.error_string(lib, rc)}")


def _check_aligned(*xs: torch.Tensor) -> None:
    """TMA's tensor maps need 16-byte-aligned bases."""
    for x in xs:
        if x.data_ptr() % 16:
            raise ValueError("the tensor-core flash kernels need 16-byte-aligned tensors")


def _forward_kernel(q, k, v, h: int, causal: bool):
    """Launch the forward kernel of the plan's route on checked CUDA tensors."""
    _check_cuda(h, q, k, v)
    from dtc_tpu_torch.ops import _build

    b, t, hd = q.shape
    d = hd // h
    plan = flash_plan(q.dtype, d, causal)
    out = torch.empty_like(q)
    lse = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
    if plan.route == "tc":
        _check_aligned(q, k, v)
        lib = _build.load("flash_attention_tc")
        rc = lib.dtc_flash_tc_fwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(lse), b, t, h, d,
            _scale_q(d, q.dtype), int(causal), plan.swizzle, plan.boxes, plan.stages,
            _stream(q),
        )
    else:
        lib = _build.load("flash_attention")
        rc = lib.dtc_flash_fwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(lse), b, t, h, d,
            _scale_q(d, q.dtype), _DTYPE_CODES[q.dtype], int(causal), _stream(q),
        )
    _raise_on(lib, rc, "forward")
    fwd_route_launches[plan.route] += 1
    return out, lse


def _check_lse(lse, q, h: int) -> None:
    if tuple(lse.shape) != (q.shape[0], h, q.shape[1]):
        raise ValueError(f"lse must be (B, H, T), got {tuple(lse.shape)}")


def _stream(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _dq_kernel(q, k, v, out, lse, do, h: int, causal: bool, grad_dtype):
    """Launch the dq kernel of the plan's route on checked CUDA tensors:
    ``(dq in grad_dtype, delta)``, delta = rowsum(dO ⊙ O) (B, H, T) float32
    for the dk/dv kernel."""
    from dtc_tpu_torch.ops import _build

    b, t, hd = q.shape
    d = hd // h
    plan = flash_plan(q.dtype, d, causal)
    delta = torch.empty_like(lse)
    dq = torch.empty(q.shape, dtype=grad_dtype, device=q.device)
    args = (_ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(do), _ptr(lse), _ptr(delta), _ptr(dq),
            b, t, h, d, _scale_q(d, q.dtype), _scale(d))
    if plan.route == "tc":
        _check_aligned(q, k, v, out, do)
        lib = _build.load("flash_attention_tc")
        rc = lib.dtc_flash_tc_dq(
            *args, _DTYPE_CODES[grad_dtype], int(causal), plan.swizzle, plan.boxes,
            plan.stages, _stream(q),
        )
    else:
        lib = _build.load("flash_attention")
        rc = lib.dtc_flash_bwd_dq(
            *args, _DTYPE_CODES[q.dtype], _DTYPE_CODES[grad_dtype], int(causal), _stream(q),
        )
    _raise_on(lib, rc, "backward (dq)")
    dq_route_launches[plan.route] += 1
    return dq, delta


def _dkv_kernel(q, k, v, lse, delta, do, h: int, causal: bool, grad_dtype):
    """Launch the dk/dv kernel of the plan's route on checked CUDA tensors:
    ``(dk, dv)`` in ``grad_dtype``."""
    from dtc_tpu_torch.ops import _build

    b, t, hd = q.shape
    d = hd // h
    plan = flash_plan(q.dtype, d, causal)
    dk, dv = (torch.empty(q.shape, dtype=grad_dtype, device=q.device) for _ in range(2))
    gcode, scale_q = _DTYPE_CODES[grad_dtype], _scale_q(d, q.dtype)
    if plan.route == "tc":
        _check_aligned(q, k, v, do)
        lib = _build.load("flash_attention_tc")
        rc = lib.dtc_flash_tc_dkv(
            _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), _ptr(dk),
            _ptr(dv), b, t, h, d, scale_q, gcode, int(causal), plan.swizzle, plan.boxes,
            plan.stages, _stream(q),
        )
    else:
        lib = _build.load("flash_attention")
        rc = lib.dtc_flash_bwd_dkv(
            _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta), _ptr(dk),
            _ptr(dv), b, t, h, d, scale_q, _DTYPE_CODES[q.dtype], gcode, int(causal),
            _stream(q),
        )
    _raise_on(lib, rc, "backward (dk/dv)")
    dkv_route_launches[plan.route] += 1
    return dk, dv


def _backward_kernels(q, k, v, out, lse, do, h: int, causal: bool, grad_dtype):
    """Launch the dq kernel, then the dk/dv kernel, on checked CUDA tensors;
    the gradients in ``grad_dtype``."""
    _check_cuda(h, q, k, v, out, do)
    if lse.dtype != torch.float32 or lse.device != q.device or not lse.is_contiguous():
        raise ValueError("lse must be a contiguous float32 tensor on q's device")
    dq, delta = _dq_kernel(q, k, v, out, lse, do, h, causal, grad_dtype)
    dk, dv = _dkv_kernel(q, k, v, lse, delta, do, h, causal, grad_dtype)
    return dq, dk, dv


def flash_attention_forward(q, k, v, h: int):
    """``(out, lse)`` of causal attention on packed tensors: the plain
    version for CPU tensors, the forward kernel for CUDA tensors."""
    global fwd_launches
    _check(h, q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, h)
    out, lse = _forward_kernel(q, k, v, h, True)
    fwd_launches += 1
    return out, lse


def flash_attention_backward(q, k, v, out, lse, do, h: int):
    """``(dq, dk, dv)``: the plain version for CPU tensors, the dq and
    dk/dv kernels for CUDA tensors."""
    global bwd_launches
    _check(h, q, k, v, out, do)
    _check_lse(lse, q, h)
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, out, lse, do, h)
    grads = _backward_kernels(q, k, v, out, lse, do, h, True, q.dtype)
    bwd_launches += BWD_KERNELS
    return grads


def flash_block_forward(q, k, v, h: int, causal: bool):
    """The ring's block forward on one ``(B, tc, H·D)`` chunk pair:
    ``(out in q's dtype, lse (B, H, tc) float32)``, causal or not. The
    plain version for CPU tensors, the forward kernel for CUDA tensors."""
    global block_fwd_launches
    _check(h, q, k, v)
    if q.device.type == "cpu":
        return flash_block_reference(q, k, v, h, causal)
    out, lse = _forward_kernel(q, k, v, h, causal)
    block_fwd_launches += 1
    return out, lse


def flash_block_backward(q, k, v, out, lse, do, h: int, causal: bool):
    """The ring's block backward from the ring's merged ``out`` and
    ``lse``: float32 ``(dq, dk, dv)``. The plain version for CPU tensors,
    the dq and dk/dv kernels for CUDA tensors."""
    global block_bwd_launches
    _check(h, q, k, v, out, do)
    _check_lse(lse, q, h)
    if q.device.type == "cpu":
        return flash_block_backward_reference(q, k, v, out, lse, do, h, causal)
    grads = _backward_kernels(q, k, v, out, lse, do, h, causal, torch.float32)
    block_bwd_launches += BWD_KERNELS
    return grads


class _FlashAttention(torch.autograd.Function):
    """Forward saves ``q, k, v, out, lse`` (the JAX package's custom-VJP
    residuals, ``_packed_flash_fwd``); backward runs the backward wrapper."""

    @staticmethod
    def forward(ctx, q, k, v, h):
        out, lse = flash_attention_forward(q, k, v, h)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.h = h
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, do.contiguous(), ctx.h)
        return dq, dk, dv, None


def flash_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention over ``(B, T, H, D)`` tensors, differentiable, at
    any T. Replaces the JAX package's ``flash_causal_attention``."""
    b, t, h, d = q.shape
    out = _FlashAttention.apply(
        q.reshape(b, t, h * d), k.reshape(b, t, h * d), v.reshape(b, t, h * d), h
    )
    return out.reshape(b, t, h, d)
