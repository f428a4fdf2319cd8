"""Overlapped training collectives: FSDP's ring all-gather fused with the
matmul that consumes the weight, and the weight gradient's matmul fused with
a streamed ring reduce-scatter (the JAX package's
``ops/overlap_collectives.py``).

Under FSDP a dense layer's weight ``w`` (K, N) is cut along ``shard_axis``
into R chunks, one per rank of the data ring, and each rank holds the
token rows of its share of the batch. :func:`overlap_dense_matmul` computes
``x @ w`` without gathering ``w`` first:

- forward (all-gather-matmul): at ring step ``s`` rank ``idx`` multiplies
  by the chunk it holds, chunk ``(idx - s) % R``, while that chunk travels
  on to the right neighbour. ``shard_axis`` 0 (q/k/v/fc1: the contraction
  is sharded) multiplies the matching column block of x and adds the
  partial to a float32 accumulator; ``shard_axis`` 1 (out_proj/fc2: the
  output is sharded) writes the chunk's output column block.
- backward: dx by a second ring pass over the same chunks, transposed
  (``w_t``: ZeRO-3 keeps only the shard and re-gathers), and dw by the
  streamed matmul + reduce-scatter: at step ``s`` rank ``idx`` computes
  its rows' partial of gradient block ``(idx - s - 1) % R``, adds the
  accumulator that just arrived and sends it right; after R steps rank
  ``idx`` holds block ``idx``, summed over every rank's rows.

Partials accumulate in float32 and the result is rounded once to the
inputs' dtype (the caller adds the bias after, in that dtype, as flax's
Dense does). The two backward rings run as one schedule, so the weight
chunk and the accumulator travel together while dx's product runs.

One ring step is one launch of a hand-written Hopper kernel on a CUDA
tensor (``csrc/overlap_collectives.cu``): :func:`ag_step` (TPU kernel row
17, ``_overlap_ag_matmul_kernel``) and :func:`rs_step` (row 18,
``_overlap_rs_matmul_kernel``); on a CPU tensor their plain versions
:func:`ag_step_reference` / :func:`rs_step_reference`, per-step PyTorch
products with the JAX package's ``_decomposed_*`` schedules. There is no
fallback from the one to the other. :func:`step_plan` decides, before each
launch and from the operands' shapes, strides and alignment alone, how the
kernel runs the step: bfloat16 on the tensor cores with operands staged by
TMA (``"tma"``) or, for views TMA cannot take, by every thread of the block
(``"threads"``); float32 on CUDA cores (``"cuda_cores"``); the output tile
and the split of the contraction over the blocks of a cluster.
``ag_launches`` / ``rs_launches`` count kernel launches, ``route_launches``
the launches of both by route. The TPU kernels copy chunks between chips
from inside the kernel; here each exchange is a transport's point-to-point exchange,
started before the step's product and waited for after it (over NCCL the
transfer runs on NCCL's stream while the product runs on the compute
stream; see :class:`~dtc_tpu_torch.ops.ring_attention.Pending`).

Transports (``ring``): a :class:`~dtc_tpu_torch.ops.ring_attention.DistRing`
over the data ranks of this rank's model index (x and w are this rank's
rows and chunk; under Megatron tensor parallelism the chunk of its slice,
so every width here is the slice's: DP×FSDP×TP, the JAX package's manual
region over both axes with the ring on the local widths), or an
:class:`~dtc_tpu_torch.ops.ring_attention.InProcessRing` of R virtual ranks
on one device (x and w are the whole batch and weight, rank i's rows being
batch rows ``i·B/R`` on). The JAX package's applicability ladder is copied
as semantics: without a ring or with a ring of one, or where ``ring_dim %
R`` (the sharded dim of w) or ``batch % R`` is not 0, the op is the plain
product ``x @ w``. Its pallas -> decomposed step for shapes over the TPU's
VMEM budget does not apply: the kernels mask their ragged edges.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from dtc_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: The kernel's routes, by the code its entry points take.
_ROUTE_CODES = {"cuda_cores": 0, "tma": 1, "threads": 2}

#: Kernel launches since the last reset (the wrappers add one per launch,
#: nowhere else): row 17's all-gather-matmul steps, row 18's
#: matmul + reduce-scatter steps, and both by route.
ag_launches = 0
rs_launches = 0
route_launches = dict.fromkeys(_ROUTE_CODES, 0)


# ---------------------------------------------------------------------------
# a step's launch plan
# ---------------------------------------------------------------------------

#: The bfloat16 kernel's output tiles, largest first, and its contraction
#: splits (blocks of one thread-block cluster).
TC_TILES = ((64, 128), (64, 64), (64, 32))
TC_SPLITS = (1, 2, 4, 8)
_STAGE_K = 64          # contraction depth of one shared-memory stage
_SPLIT_MIN_K = 256     # shallower contractions are never split


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """How one ring step launches: ``route`` "tma" or "threads" (bfloat16
    on the tensor cores, operands staged by TMA or by every thread) or
    "cuda_cores" (float32); the output tile; ``split``, the contraction's
    split (the blocks of a cluster, or for float32 the thread groups of a
    block); whether A (M x K) and B (K x N) are staged MN-major (their M or
    N dim contiguous); ``blocks``, the blocks of the launch."""

    route: str
    tile_m: int
    tile_n: int
    split: int
    a_mn: bool
    b_mn: bool
    blocks: int


def _tiles(n: int, tile: int) -> int:
    return -(-n // tile)


def _tma_fits(mn_major: bool, s_mn: int, s_k: int, extent: int, aligned: bool) -> bool:
    """What TMA takes: a unit stride along the staged rows, a row stride
    that is a multiple of 16 bytes (8 bf16) and no smaller than a row
    (``extent`` elements), a 16-byte-aligned base."""
    unit, row = (s_mn, s_k) if mn_major else (s_k, s_mn)
    return unit == 1 and row % 8 == 0 and row >= extent and row < 2 ** 39 and aligned


@functools.lru_cache(maxsize=4096)
def step_plan(m: int, n: int, k: int, a_strides, b_strides, dtype, sms: int,
              aligned=(True, True)) -> StepPlan:
    """The plan of one step's product ``A (m, k) @ B (k, n)``, chosen
    before the launch from the shapes alone. ``a_strides``: A's strides
    along m and k, ``b_strides``: B's along k and n (elements);
    ``aligned``: whether each base is 16-byte aligned; ``sms``: the card's
    SM count.

    float32: CUDA-core tiles of 64 x 64, or 32 x 32 with the contraction
    split over four thread groups where 64 x 64 would give fewer blocks
    than SMs. bfloat16: the tensor cores, by TMA where both operands fit
    it, else by the per-thread loader; each operand staged MN-major where
    that dim, and not K, has the unit stride. The plan is the least split
    of the contraction, and with it the largest tile of :data:`TC_TILES`,
    that puts at least one block on every SM (at the flagship's steps a
    split of 8 costs more in its reduction than a smaller tile does); a
    contraction under 256 deep is never split (it is bound by the float32
    accumulator's bytes), a deeper one at most to one 64-deep stage a
    block; where nothing fills the card, the plan with the most blocks."""
    if min(m, n, k) < 1 or _tiles(m, 32) > 65535 or sms < 1:
        raise ValueError(f"step_plan: no plan for m {m}, n {n}, k {k} on {sms} SMs")
    if dtype == torch.float32:
        t, s = (32, 4) if _tiles(m, 64) * _tiles(n, 64) < sms else (64, 1)
        return StepPlan("cuda_cores", t, t, s, False, False, _tiles(m, t) * _tiles(n, t))
    if dtype != torch.bfloat16:
        raise ValueError(f"step_plan: unsupported dtype {dtype}")
    (sam, sak), (sbk, sbn) = a_strides, b_strides
    a_mn, b_mn = sak != 1 and sam == 1, sbk != 1 and sbn == 1
    tma = (_tma_fits(a_mn, sam, sak, m if a_mn else k, aligned[0])
           and _tma_fits(b_mn, sbn, sbk, n if b_mn else k, aligned[1]))
    route = "tma" if tma else "threads"
    max_split = 1 if k < _SPLIT_MIN_K else min(TC_SPLITS[-1], _tiles(k, _STAGE_K))
    splits = [s for s in TC_SPLITS if s <= max_split]
    for s in splits:
        for tm, tn in TC_TILES:
            t = _tiles(m, tm) * _tiles(n, tn)
            if t * s >= sms:
                return StepPlan(route, tm, tn, s, a_mn, b_mn, t * s)
    tm, tn = TC_TILES[-1]
    t = _tiles(m, tm) * _tiles(n, tn)
    return StepPlan(route, tm, tn, splits[-1], a_mn, b_mn, t * splits[-1])


# The kernel path reads a step's operands as a pointer and two strides, with
# no view made (a flagship FSDP step launches 3,456 ring steps, and a view
# costs microseconds of host time): the geometry functions below give what
# _ag_operands / _rs_operands would, and raise where a block does not fit.

def _ag_geometry(x, w, src: int, slice_x: bool, w_t: bool):
    """``(m, n, k, A, B)`` of the product ``x_s @ w_s`` (see
    :func:`_ag_operands`), each operand as ``(address, strides)``."""
    (k, n), sw = w.shape, w.stride()
    if w_t:
        k, n, sw = n, k, (sw[1], sw[0])
    (m, width), sx = x.shape, x.stride()
    fits = (src + 1) * k <= width if slice_x else width == k
    if not fits:
        raise ValueError(f"ag_step: x {tuple(x.shape)} has no block {src} of width {k}")
    xp = x.data_ptr() + (src * k * sx[1] * x.element_size() if slice_x else 0)
    return m, n, k, (xp, sx), (w.data_ptr(), sw)


def _rs_geometry(a, b, j: int, blk: int, slice_a: bool):
    """``(M, N, K, A, B)`` of the product ``a_jᵀ @ b_j`` (see
    :func:`_rs_operands`), each operand as ``(address, strides)``: A is
    ``a_jᵀ``, its strides swapped."""
    (t, wa), (t2, wb) = a.shape, b.shape
    if t != t2:
        raise ValueError(f"rs_step: {t} and {t2} token rows")
    if (j + 1) * blk > (wa if slice_a else wb):
        raise ValueError(f"rs_step: no block {j} of width {blk} in {wa if slice_a else wb}")
    (sa0, sa1), sb, es = a.stride(), b.stride(), a.element_size()
    ap, bp = a.data_ptr(), b.data_ptr()
    if slice_a:
        return blk, wb, t, (ap + j * blk * sa1 * es, (sa1, sa0)), (bp, sb)
    return wa, blk, t, (ap, (sa1, sa0)), (bp + j * blk * sb[1] * es, sb)


def _plan_of(m, n, k, a, b, dtype, sms: int) -> StepPlan:
    return step_plan(m, n, k, a[1], b[1], dtype, sms, (a[0] % 16 == 0, b[0] % 16 == 0))


def ag_plan(x, w, *, src: int, slice_x: bool, w_t: bool, sms: int) -> StepPlan:
    """The plan of the all-gather-matmul step :func:`ag_step` launches for
    these operands (``x_s @ w_s``) on a card of ``sms`` SMs."""
    return _plan_of(*_ag_geometry(x, w, src, slice_x, w_t), x.dtype, sms)


def rs_plan(a, b, *, j: int, blk: int, slice_a: bool, sms: int) -> StepPlan:
    """The plan of the matmul + reduce-scatter step :func:`rs_step`
    launches for these operands (``a_jᵀ @ b_j``) on a card of ``sms``
    SMs."""
    return _plan_of(*_rs_geometry(a, b, j, blk, slice_a), a.dtype, sms)


@functools.lru_cache(maxsize=4096)
def _launch_plan(m, n, k, a, b, dtype, device: int):
    """:func:`_plan_of` on card ``device`` as its route and the plan
    arguments of the C entry points, cached: one lookup a launch (the
    operands' addresses enter the key only as their 16-byte alignment)."""
    p = _plan_of(m, n, k, a, b, dtype,
                 torch.cuda.get_device_properties(device).multi_processor_count)
    return p.route, (_ROUTE_CODES[p.route], p.tile_m, p.tile_n, p.split, int(p.a_mn),
                     int(p.b_mn))


# ---------------------------------------------------------------------------
# one ring step: plain versions and kernels
# ---------------------------------------------------------------------------

def _cols(x: torch.Tensor, width: int, block: int) -> torch.Tensor:
    return x[:, block * width:(block + 1) * width]


def _ag_operands(x, w, src: int, slice_x: bool, w_t: bool):
    """``(x_s, w_s)`` of one all-gather-matmul step: the product is
    ``x_s @ w_s``."""
    ws = w.t() if w_t else w
    return (_cols(x, ws.shape[0], src) if slice_x else x), ws


def _rs_operands(a, b, j: int, blk: int, slice_a: bool):
    """``(a_j, b_j)`` of one reduce-scatter step: the product is
    ``a_jᵀ @ b_j``."""
    return (_cols(a, blk, j), b) if slice_a else (a, _cols(b, blk, j))


def ag_step_reference(x, w, out, *, src: int, slice_x: bool, slice_out: bool, w_t: bool,
                      accumulate: bool) -> None:
    """Plain version of one all-gather-matmul step, in place on the float32
    ``out``: ``part = x_s @ w_s``, where ``w_s`` is the chunk ``w`` (its
    transpose with ``w_t``) and ``x_s`` the ``src`` column block of x
    (``slice_x``) or x. The destination is the ``src`` output column block
    (``slice_out``) or ``out``; ``part`` is added to it (``accumulate``) or
    written to it."""
    xs, ws = _ag_operands(x, w, src, slice_x, w_t)
    part = xs.float().contiguous() @ ws.float().contiguous()
    dest = _cols(out, ws.shape[1], src) if slice_out else out
    dest.copy_(dest + part if accumulate else part)


def rs_step_reference(a, b, acc, *, j: int, blk: int, slice_a: bool) -> torch.Tensor:
    """Plain version of one matmul + reduce-scatter step: ``acc + a_jᵀ @
    b_j`` in float32 over the token rows, where ``a`` (``slice_a``) or else
    ``b`` is cut to its ``blk``-wide column block ``j``, and ``acc`` is the
    accumulator that arrived (None at the first step)."""
    a_j, b_j = _rs_operands(a, b, j, blk, slice_a)
    part = a_j.float().t().contiguous() @ b_j.float().contiguous()
    return part if acc is None else acc + part


# The checks below run on every ring step (3,456 a flagship FSDP step), so
# they compare device indices and sizes, not device objects.

def _check_pair(p: torch.Tensor, q: torch.Tensor, what: str) -> None:
    if p.ndim != 2 or q.ndim != 2:
        raise ValueError(f"{what}: expected 2-D operands, got {tuple(p.shape)}, {tuple(q.shape)}")
    if p.dtype not in _DTYPE_CODES or q.dtype != p.dtype:
        raise ValueError(f"{what}: operands must both be float32 or both bfloat16, got "
                         f"{p.dtype}, {q.dtype}")
    if p.get_device() != q.get_device() or p.is_cuda != q.is_cuda:
        raise ValueError(f"{what}: operands on {p.device} and {q.device}")


def _check_f32(t: torch.Tensor, shape, like: torch.Tensor, what: str) -> None:
    """``t`` is float32 of ``shape`` on ``like``'s device."""
    if (t.dtype != torch.float32 or t.shape != shape or t.get_device() != like.get_device()
            or t.is_cuda != like.is_cuda):
        raise ValueError(f"{what} must be float32 {tuple(shape)} on {like.device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _lib_and_stream(t: torch.Tensor):
    if not t.is_cuda:
        raise ValueError(f"unsupported device {t.device}")
    return _build.load("overlap_collectives"), torch.cuda.current_stream(
        t.get_device()).cuda_stream


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"overlap {what} launch failed: {_build.error_string(lib, rc)}")


def ag_step(x, w, out, *, src: int, slice_x: bool, slice_out: bool, w_t: bool,
            accumulate: bool) -> None:
    """One all-gather-matmul ring step (TPU kernel row 17), in place on the
    float32 ``out`` (see :func:`ag_step_reference`): the plain version for
    CPU tensors, the kernel for CUDA tensors. ``x`` and ``w`` may be any
    2-D views (strides are passed to the kernel); ``out`` is a row-major
    float32 matrix."""
    global ag_launches
    _check_pair(x, w, "ag_step")
    m, n, k, xa, wa = _ag_geometry(x, w, src, slice_x, w_t)
    fits = out.shape[1] >= (src + 1) * n if slice_out else out.shape[1] == n
    if out.ndim != 2 or out.shape[0] != m or not fits:
        raise ValueError(f"ag_step: x block ({m}, {k}), w chunk ({k}, {n}), out "
                         f"{tuple(out.shape)} do not fit")
    _check_f32(out, out.shape, x, "ag_step's out")
    if x.is_cpu:
        return ag_step_reference(x, w, out, src=src, slice_x=slice_x, slice_out=slice_out,
                                 w_t=w_t, accumulate=accumulate)
    if out.stride(1) != 1:
        raise ValueError("ag_step: out must be row-major")
    lib, stream = _lib_and_stream(x)
    route, plan = _launch_plan(m, n, k, (xa[0] % 16, xa[1]), (wa[0] % 16, wa[1]), x.dtype,
                               x.get_device())
    rc = lib.dtc_overlap_ag_step(
        xa[0], *xa[1], wa[0], *wa[1], out.data_ptr() + (src * n * 4 if slice_out else 0),
        out.stride(0), m, n, k, int(accumulate), _DTYPE_CODES[x.dtype], *plan, stream)
    _raise_on(lib, rc, "all-gather-matmul step")
    ag_launches += 1
    route_launches[route] += 1


def rs_step(a, b, acc, *, j: int, blk: int, slice_a: bool) -> torch.Tensor:
    """One matmul + reduce-scatter ring step (TPU kernel row 18): the new
    float32 stage buffer ``acc + a_jᵀ @ b_j`` (see
    :func:`rs_step_reference`). The plain version for CPU tensors, the
    kernel for CUDA tensors."""
    global rs_launches
    _check_pair(a, b, "rs_step")
    m, n, k, aa, ba = _rs_geometry(a, b, j, blk, slice_a)
    if acc is not None:
        _check_f32(acc, (m, n), a, "rs_step acc")
    if a.is_cpu:
        return rs_step_reference(a, b, acc, j=j, blk=blk, slice_a=slice_a)
    if acc is not None and not acc.is_contiguous():
        raise ValueError("rs_step: acc must be contiguous")
    lib, stream = _lib_and_stream(a)
    route, plan = _launch_plan(m, n, k, (aa[0] % 16, aa[1]), (ba[0] % 16, ba[1]), a.dtype,
                               a.get_device())
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    # the C entry takes a_j's own strides (token, column): A's swapped back
    rc = lib.dtc_overlap_rs_step(
        aa[0], aa[1][1], aa[1][0], ba[0], *ba[1], 0 if acc is None else acc.data_ptr(),
        out.data_ptr(), m, n, k, _DTYPE_CODES[a.dtype], *plan, stream)
    _raise_on(lib, rc, "matmul + reduce-scatter step")
    rs_launches += 1
    route_launches[route] += 1
    return out


# ---------------------------------------------------------------------------
# the ring schedules (one generator per rank; see ring_attention's transports)
# ---------------------------------------------------------------------------

def _right(ring: int) -> tuple[int, ...]:
    return tuple((i + 1) % ring for i in range(ring))


def _ag_program(idx: int, ring: int, x, w, *, slice_x: bool, slice_out: bool, w_t: bool,
                step=None):
    """One rank's all-gather-matmul: the float32 ``(m, N_out)`` product of
    its rows ``x`` with the gathered weight, its chunk ``w`` travelling
    right while each step multiplies."""
    step = step or ag_step
    ws = w.t() if w_t else w
    width = ws.shape[1] * (ring if slice_out else 1)
    out = torch.empty(x.shape[0], width, dtype=torch.float32, device=x.device)
    w_cur = w
    for s in range(ring):
        pending = (yield [(_right(ring), w_cur)]) if s < ring - 1 else None
        step(x, w_cur, out, src=(idx - s) % ring, slice_x=slice_x, slice_out=slice_out,
             w_t=w_t, accumulate=s > 0 and not slice_out)
        if pending is not None:
            (w_cur,) = pending.wait()
    return out


def _rs_program(idx: int, ring: int, a, b, *, slice_a: bool, step=None):
    """One rank's streamed matmul + reduce-scatter: its float32 block of
    ``aᵀ @ b`` summed over every rank's rows."""
    step = step or rs_step
    blk = (a if slice_a else b).shape[1] // ring
    acc = None
    for s in range(ring):
        stage = step(a, b, acc, j=(idx - s - 1) % ring, blk=blk, slice_a=slice_a)
        if s == ring - 1:
            return stage
        (acc,) = (yield [(_right(ring), stage)]).wait()


def _bwd_program(idx: int, ring: int, x, w, dy, *, contract: bool, flip: bool = False,
                 ag=None, rs=None):
    """One rank's backward of the forward ring: float32 ``(dx, dw)`` for
    its rows and chunk (``w.t()`` with ``flip``). The dx ring re-gathers
    the chunks transposed (out-block writes when the contraction is
    sharded, accumulation otherwise); dw is the streamed reduce-scatter of
    ``xᵀ @ dy`` over the sharded dim. Both travel in one exchange a step,
    and dx's product runs while it is in flight."""
    ag, rs = ag or ag_step, rs or rs_step
    logical = w.t() if flip else w
    blk = logical.shape[0] if contract else logical.shape[1]
    dx = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    w_cur, acc = w, None
    for s in range(ring):
        stage = rs(x, dy, acc, j=(idx - s - 1) % ring, blk=blk, slice_a=contract)
        pending = (yield [(_right(ring), w_cur), (_right(ring), stage)]
                   ) if s < ring - 1 else None
        ag(dy, w_cur, dx, src=(idx - s) % ring, slice_x=not contract, slice_out=contract,
           w_t=not flip, accumulate=s > 0 and not contract)
        if pending is not None:
            w_cur, acc = pending.wait()
    return dx, stage


def _split(ring, x, w, shard_axis: int):
    """Each held rank's rows of ``x`` (m, K) and chunk of ``w``, the chunk
    as ``(base, flip)``: the chunk is ``base.t()`` with ``flip``. A chunk
    whose transpose is contiguous (``Dense.weight``'s shard, viewed (K, N))
    travels as that contiguous base, with no copy."""
    n = len(ring.ranks)
    chunks = []
    for c in w.chunk(n, shard_axis):
        flip = not c.is_contiguous() and c.t().is_contiguous()
        chunks.append((c.t() if flip else c, flip))
    return x.chunk(n, 0), chunks


def ring_ag_matmul(x, w, ring, *, shard_axis: int, step=None) -> torch.Tensor:
    """The forward ring over ``ring``'s ranks: the float32 product of the
    token rows ``x`` (m, K) and the weight ``w`` (K, N) held as chunks
    along ``shard_axis``, rows of every held rank stacked. ``step``
    replaces :func:`ag_step` (a comparison or a planted fault)."""
    xs, ws = _split(ring, x, w, shard_axis)
    contract = shard_axis == 0
    outs = ring.run((_ag_program(i, ring.size, xi, base, slice_x=contract,
                                 slice_out=not contract, w_t=flip, step=step)
                     for i, xi, (base, flip) in zip(ring.ranks, xs, ws)), overlap=True)
    return torch.cat(outs, 0) if len(outs) > 1 else outs[0]


def ring_backward(x, w, dy, ring, *, shard_axis: int, ag=None, rs=None):
    """The backward rings: float32 ``(dx (m, K), dw)`` with ``dw`` held as
    ``w`` is (each held rank's chunk along ``shard_axis``)."""
    xs, ws = _split(ring, x, w, shard_axis)
    dys = dy.chunk(len(ring.ranks), 0)
    res = ring.run((_bwd_program(i, ring.size, xi, base, di, contract=shard_axis == 0,
                                 flip=flip, ag=ag, rs=rs)
                    for i, xi, (base, flip), di in zip(ring.ranks, xs, ws, dys)),
                   overlap=True)
    if len(res) == 1:
        return res[0]
    return torch.cat([r[0] for r in res], 0), torch.cat([r[1] for r in res], shard_axis)


class _RingMatmul(torch.autograd.Function):
    """``x @ w`` over the ring, rounded once to x's dtype. Saves the held
    rows and chunk only (ZeRO-3: the backward re-gathers)."""

    @staticmethod
    def forward(ctx, ring, shard_axis, x, w):
        ctx.ring, ctx.shard_axis = ring, shard_axis
        ctx.save_for_backward(x, w)
        return ring_ag_matmul(x, w, ring, shard_axis=shard_axis).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = ring_backward(x, w, dy.to(x.dtype), ctx.ring, shard_axis=ctx.shard_axis)
        return None, None, dx.to(x.dtype), dw.to(w.dtype)


def _held(ring, size: int) -> int:
    """The global size of a dim of which ``ring`` holds ``size``."""
    return size * ring.size // len(ring.ranks)


def overlap_dense_matmul(x: torch.Tensor, w: torch.Tensor, *, shard_axis: int,
                         ring=None) -> torch.Tensor:
    """``x @ w`` with FSDP's weight gather (and, in the backward, its
    gradient reduce-scatter) overlapped with the matmul over ``ring``.

    ``x``: (B, ..., K) activations in the compute dtype, the batch axis
    over the ring's ranks; ``w``: (K, N) in x's dtype, its ``shard_axis``
    (0: the contraction, q/k/v/fc1; 1: the output, out_proj/fc2) over the
    ring's ranks; under a ``DistRing`` both are this rank's share. Under
    tensor parallelism ``w`` is this rank's Megatron slice and the widths
    are the slice's (the JAX package's ``k_loc`` / ``n_loc``); the Megatron
    reductions stay outside: the caller's ``copy_to_model`` before a
    column-parallel site and ``reduce_from_model`` after a row-parallel
    one, so the ring's backward neither sums dx over the model group nor
    reduces the row-parallel output (either would count it twice). Returns
    (B, ..., N) in x's dtype. The plain ``x @ w`` where the JAX package's
    ladder says so (module docstring)."""
    if shard_axis not in (0, 1):
        raise ValueError(f"shard_axis must be 0 or 1, got {shard_axis}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"x and w must both be float32 or both bfloat16, got {x.dtype}, "
                         f"{w.dtype}")
    k = w.shape[0] if ring is None or shard_axis else _held(ring, w.shape[0])
    if w.ndim != 2 or x.shape[-1] != k:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not multiply")
    if ring is None or ring.size <= 1:
        return torch.matmul(x, w)
    r = ring.size
    if _held(ring, w.shape[shard_axis]) % r or _held(ring, x.shape[0]) % r:
        return torch.matmul(x, w)
    y = _RingMatmul.apply(ring, shard_axis, x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def reduce_scatter_matmul(a: torch.Tensor, b: torch.Tensor, *, shard_axis: int,
                          ring=None, step=None) -> torch.Tensor:
    """``aᵀ @ b`` summed over the ring's token shards, in float32, scattered
    blockwise over ``shard_axis`` of the product (0: a's columns, 1: b's):
    the backward's dw op alone. ``a`` (..., K) and ``b`` (..., N) hold the
    ranks' rows; under an ``InProcessRing`` the result is every rank's
    block, in order. A scatter dim that does not divide by the ring raises
    (as in the JAX package). ``step`` replaces :func:`rs_step`."""
    a2, b2 = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    _check_pair(a2, b2, "reduce_scatter_matmul")
    if ring is None or ring.size <= 1:
        return (step or rs_step)(a2, b2, None, j=0, blk=a2.shape[1], slice_a=True)
    dim = (a2 if shard_axis == 0 else b2).shape[1]
    if dim % ring.size:
        raise ValueError(f"reduce_scatter_matmul: scatter dim {dim} not divisible by ring "
                         f"{ring.size}")
    rows = a2.chunk(len(ring.ranks), 0), b2.chunk(len(ring.ranks), 0)
    outs = ring.run((_rs_program(i, ring.size, ai, bi, slice_a=shard_axis == 0, step=step)
                     for i, ai, bi in zip(ring.ranks, *rows)), overlap=True)
    return torch.cat(outs, shard_axis) if len(outs) > 1 else outs[0]
