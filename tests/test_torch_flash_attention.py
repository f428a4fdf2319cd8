"""The port's flash attention against the JAX package's, forward and all
three gradients, on the same numpy inputs.

JAX runs its Pallas kernels in interpret mode here (as
``tests/test_flash_attention.py`` does): ``block_q = block_kv = T`` takes the
single-tile kernels (TPU kernel rows 4 and 5), ``T/2`` the multi-tile ones
(rows 6 and 7). The port runs its plain versions, which are what its CUDA
kernels are held against on the card. With ``_PACKED_MAX_T`` lowered to 128,
T 256 takes JAX's packed split backward (rows 8 and 9, its route past T
4096). Head dims and head counts that 128-lane groups do not fit take JAX's
transpose-layout family (rows 10-14: ``_flash`` over (B, H, T, D), q
pre-scaled outside the kernels).

The bf16 kernels' launch plan (``flash_plan``: route, swizzle, boxes,
stages per head dim, for the forward, dq and dk/dv launches alike) is
checked here; the tensor-core forward's one-pass softmax is held through
its eager tiling twin (``flash_forward_twin``) against JAX's
interpret-mode multi-tile kernel at JAX's key tile (128) and against the
two-pass plain version at the kernel's own (64), before the card holds the
kernel against both (``tests/test_torch_gpu.py``). The tensor-core dq
kernel's tiling twin (``flash_dq_twin``: dS rounded and dQ summed a key
tile at a time) is held the same way against JAX's ``_dq_kernel_packed``
(row 8), ``_dq_kernel`` (row 13) and the dq of ``_block_bwd_kernel`` (row
16), and against the plain version at a ragged T.

Tolerances (``dtc_tpu_torch.parity``):
- float32: ``out`` and ``lse`` 1e-5 absolute, gradients 1e-5 × the tensor's
  largest |value| — the two packages sum in other orders, nothing more
  (measured: ~5e-7 absolute, ~1e-6 relative).
- bfloat16: ``out`` 4 bf16 ulps of each (row, head)'s largest |value|,
  gradients 4 ulps of each head's largest |value| over the tensor (one
  rounding of p or ds to bf16 may flip where the sum orders differ; the
  multi-tile kernels also round p against a running max); ``lse`` stays
  float32, 1e-5 absolute. Where the two differ in rounding points (JAX's
  split backward scales dq per tile in float32 where the port scales once;
  the transposed family's dq comes back through the VJP of ``q * scale``,
  rounded to q's dtype twice, with the scale itself rounded) the same
  limits hold.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dtc_tpu.ops import flash_attention as jfa
from dtc_tpu_torch.ops import flash_attention as tfa
from dtc_tpu_torch.parity import FP32_ATOL, attention_tolerance, grad_tolerance
from tests.test_torch_train import _one_thread  # noqa: F401  (autouse: one intra-op thread)


_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(b, t, h, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, h, d).astype(np.float32) for _ in range(4)]


def _jax(q, k, v, do, block, dtype):
    """JAX's out, lse (as (B, H, T)) and (dq, dk, dv), packed (B, T, H·D)."""
    b, t, h, d = q.shape
    jq, jk, jv, jdo = (jnp.asarray(x, _JDT[dtype]) for x in (q, k, v, do))
    out, vjp = jax.vjp(
        lambda q, k, v: jfa.flash_causal_attention(q, k, v, block_q=block, block_kv=block),
        jq, jk, jv,
    )
    grads = vjp(jdo)
    g = jfa._packed_group(d, h)
    _, lse = jfa._packed_fwd_call(
        jq.reshape(b, t, h * d), jk.reshape(b, t, h * d), jv.reshape(b, t, h * d),
        block, block, g, d, float(d ** -0.5),
    )
    lse = np.array(lse).transpose(0, 1, 3, 2).reshape(b, h, t)  # (B, H/g, T, g) -> (B, H, T)

    def packed(x):
        return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).reshape(b, t, h * d)

    return packed(out), torch.from_numpy(lse), [packed(x) for x in grads]


def _jax_transposed(q, k, v, do, block, dtype):
    """JAX's transpose-layout route, as ``flash_causal_attention`` takes it
    where ``_packed_group`` is None: q scaled by ``D**-0.5`` in its dtype,
    (B, H, T, D) tensors through ``_flash``; lse from ``_fwd_call`` on the
    same pre-scaled, transposed q. Returns what :func:`_jax` does."""
    b, t, h, d = q.shape
    assert jfa._packed_group(d, h) is None
    jq, jk, jv, jdo = (jnp.asarray(x, _JDT[dtype]) for x in (q, k, v, do))

    def tr(x):
        return x.transpose(0, 2, 1, 3)

    def fn(q, k, v):
        q = q * q.dtype.type(d ** -0.5)
        return tr(jfa._flash(tr(q), tr(k), tr(v), block, block))

    out, vjp = jax.vjp(fn, jq, jk, jv)
    grads = vjp(jdo)
    if jfa.supports(t, d, block, block):  # the public entry point takes this route
        pub = jfa.flash_causal_attention(jq, jk, jv, block_q=block, block_kv=block)
        assert np.array_equal(np.asarray(pub, np.float32), np.asarray(out, np.float32))
    _, lse = jfa._fwd_call(tr(jq * jq.dtype.type(d ** -0.5)), tr(jk), tr(jv), block, block)

    def packed(x):
        return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).reshape(b, t, h * d)

    return (packed(out), torch.from_numpy(np.array(lse).reshape(b, h, t)),
            [packed(x) for x in grads])


def _port(q, k, v, do, dtype):
    b, t, h, d = q.shape
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_(True) for x in (q, k, v))
    out = tfa.flash_causal_attention(tq, tk, tv)
    out.backward(torch.from_numpy(do).to(tdt))
    _, lse = tfa.flash_attention_reference(
        *(x.detach().reshape(b, t, h * d) for x in (tq, tk, tv)), h
    )
    return out.detach().reshape(b, t, h * d), lse, [x.grad.reshape(b, t, h * d) for x in (tq, tk, tv)]


def _assert_within(name, got, want, limit):
    err = (got.float() - want.float()).abs()
    worst = (err / limit).max().item()
    assert worst <= 1.0, f"{name}: max error {err.max().item():.3e} is {worst:.2f}x its limit"


def _compare(b, t, h, d, dtype, block, seed, reference=_jax):
    q, k, v, do = _inputs(b, t, h, d, seed)
    jout, jlse, jgrads = reference(q, k, v, do, block, dtype)
    tout, tlse, tgrads = _port(q, k, v, do, dtype)
    want_dt = getattr(torch, dtype)
    assert tout.dtype == want_dt and tlse.dtype == torch.float32
    _assert_within("out", tout, jout.to(want_dt), attention_tolerance(jout.to(want_dt), h))
    _assert_within("lse", tlse, jlse, torch.full(jlse.shape, FP32_ATOL))
    for name, got, want in zip(("dq", "dk", "dv"), tgrads, jgrads):
        assert got.dtype == want_dt
        _assert_within(name, got, want, grad_tolerance(want.to(want_dt), h))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h,d", [(2, 128, 4, 32), (1, 256, 8, 16)])
def test_matches_jax_single_tile_kernels(b, t, h, d, dtype):
    """TPU kernel rows 4 (``_fwd_kernel_packed``) and 5
    (``_bwd_kernel_packed``): the whole KV in one tile."""
    _compare(b, t, h, d, dtype, block=t, seed=t + d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_jax_multi_tile_kernels(dtype):
    """TPU kernel rows 6 (``_fwd_kernel_packed_multi``) and 7
    (``_bwd_kernel_packed_multi``): T 256 in blocks of 128, the online
    softmax and causal block skipping of the long-context path."""
    _compare(2, 256, 8, 32, dtype, block=128, seed=7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_jax_packed_split_backward(monkeypatch, dtype):
    """TPU kernel rows 8 (``_dq_kernel_packed``) and 9 (``_dkv_kernel_packed``):
    the split backward JAX takes past ``_PACKED_MAX_T`` (4096), lowered to
    128 here as ``tests/test_flash_attention.py`` does, at T 256 in blocks
    of 128; a spy proves JAX went through ``_packed_split_bwd_call``."""
    monkeypatch.setattr(jfa, "_PACKED_MAX_T", 128)
    calls = []
    real = jfa._packed_split_bwd_call

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(jfa, "_packed_split_bwd_call", spy)
    _compare(2, 256, 4, 32, dtype, block=128, seed=11)
    assert calls == [(2, 256, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tiles", ["single", "multi"])
@pytest.mark.parametrize("b,t,h,d", [(2, 128, 3, 32), (1, 256, 4, 16), (2, 256, 2, 48)])
def test_matches_jax_transpose_layout_kernels(b, t, h, d, tiles, dtype):
    """TPU kernel rows 10-14, the transpose-layout family: 3 heads of 32 and
    4 of 16 (a head count no 128-lane group divides), 2 heads of 48 (a head
    dim that does not divide 128). ``single`` takes ``_fwd_kernel_single``
    and ``_bwd_kernel_single`` (rows 10, 12); ``multi`` (two tiles) takes
    ``_fwd_kernel``, ``_dq_kernel`` and ``_dkv_kernel`` (rows 11, 13, 14)."""
    block = t if tiles == "single" else t // 2
    _compare(b, t, h, d, dtype, block=block, seed=t + h + d, reference=_jax_transposed)


def test_kernel_head_dims_cover_every_multiple_of_16_up_to_128():
    assert tfa.KERNEL_HEAD_DIMS == (16, 32, 48, 64, 80, 96, 112, 128)
    for d in tfa.KERNEL_HEAD_DIMS:
        tfa.check_head_dim(d)
    with pytest.raises(ValueError, match="ROADMAP"):  # the JAX package's D up to 512
        tfa.check_head_dim(256)
    with pytest.raises(ValueError, match="not in the kernels"):
        tfa.check_head_dim(40)


def test_ragged_length_matches_dense_attention():
    """T 100 (no tile divides it): the plain flash version against the
    port's dense attention, forward and gradients, float32."""
    from dtc_tpu_torch.ops.attention import dense_causal_attention

    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2, 100, 2, 32, seed=3))
    grads = []
    for fn in (tfa.flash_causal_attention, dense_causal_attention):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*xs)
        out.backward(do)
        grads.append([out.detach()] + [x.grad for x in xs])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=0)


def _route_counts():
    return [dict(c) for c in (tfa.fwd_route_launches, tfa.dq_route_launches,
                              tfa.dkv_route_launches)]


def test_cpu_tensors_take_the_plain_version_without_counting():
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.from_numpy(x).to(dtype) for x in _inputs(1, 64, 2, 16, seed=1))
        f0, b0, routes0 = tfa.fwd_launches, tfa.bwd_launches, _route_counts()
        xs = [x.requires_grad_(True) for x in (q, k, v)]
        tfa.flash_causal_attention(*xs).backward(do)
        assert (tfa.fwd_launches, tfa.bwd_launches) == (f0, b0)
        assert _route_counts() == routes0


def test_wrappers_reject_bad_inputs():
    x = torch.zeros(1, 8, 64)
    with pytest.raises(ValueError):  # width not divisible by the heads
        tfa.flash_attention_forward(x, x, x, 3)
    with pytest.raises(ValueError):  # mismatched shapes
        tfa.flash_attention_forward(x, x, torch.zeros(1, 9, 64), 2)
    with pytest.raises(ValueError):  # lse of the wrong shape
        tfa.flash_attention_backward(x, x, x, x, torch.zeros(1, 8, 2), x, 2)
    with pytest.raises(ValueError):  # not a CUDA tensor: no kernel for it
        tfa._check_cuda(2, x, x, x)


# --- the tensor-core kernels' plan and the forward's tiling twin ----------

#: The plan's swizzle (bytes a box row) and boxes a 64 x D tile, by head
#: dim: the widest of 64 (128B), 32 (64B) and 16 (32B) bf16 that divides D.
_TC_GEOMETRY = {16: (32, 1), 32: (64, 1), 48: (32, 3), 64: (128, 1), 80: (32, 5),
                96: (64, 3), 112: (32, 7), 128: (128, 2)}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", tfa.KERNEL_HEAD_DIMS)
def test_flash_plan_takes_bf16_to_the_tensor_cores(d, causal):
    """bfloat16 plans the tensor-core route with the box geometry above, a
    box no wider than its swizzle and 2-4 stages of at most 64 KB; float32
    the CUDA cores."""
    plan = tfa.flash_plan(torch.bfloat16, d, causal)
    swizzle, boxes = _TC_GEOMETRY[d]
    assert (plan.route, plan.tile, plan.swizzle, plan.boxes) == ("tc", 64, swizzle, boxes)
    assert boxes * swizzle == 2 * d
    tile_bytes = 64 * d * 2
    assert 2 <= plan.stages <= 4 and plan.stages * 2 * tile_bytes <= 65536
    assert plan.stages == 4 or (plan.stages + 1) * 2 * tile_bytes > 65536
    assert tfa.flash_plan(torch.float32, d, causal) == tfa.FlashPlan("fma", 64, 0, 0, 0)
    # The dq kernel stages Q, dO and O once and the plan's K/V stages: it
    # fits a block's 227 KB at every D, with more than the forward's bytes.
    smem = {kind: tfa.tc_smem_bytes(kind, d) for kind in ("fwd", "dkv", "dq")}
    assert smem["dq"] == smem["fwd"] + 2 * tile_bytes + 2 * 64 * 4 <= 232448


class _FakeLib:
    """Stands in for a kernel library: records each entry point's call."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def __getattr__(self, name):
        if name == "dtc_error_string":
            return lambda code: b"refused"
        return lambda *args: self.calls.append((name, args)) or self.rc


@pytest.fixture
def fake_libs(monkeypatch):
    """``_build.load`` returns fake libraries and no stream is asked for, so
    the launchers' routing runs on CPU tensors without a card."""
    from dtc_tpu_torch.ops import _build

    libs = {}
    monkeypatch.setattr(_build, "load", lambda name: libs.setdefault(name, _FakeLib()))
    monkeypatch.setattr(tfa, "_stream", lambda x: None)
    return libs


@pytest.mark.parametrize("dtype,grad_dtype", [(torch.bfloat16, torch.bfloat16),
                                              (torch.bfloat16, torch.float32),
                                              (torch.float32, torch.float32)])
def test_dq_launch_takes_its_plans_route(fake_libs, dtype, grad_dtype):
    """A dq launch takes the plan's route: bfloat16 the tensor-core entry
    point with the plan's swizzle, boxes and stages (bf16 or float32
    gradients), float32 the CUDA-core one; the route's counter adds one."""
    b, t, h, d = 1, 100, 2, 48
    q, k, v, out, do = (torch.zeros(b, t, h * d, dtype=dtype) for _ in range(5))
    lse = torch.zeros(b, h, t)
    before = dict(tfa.dq_route_launches)
    dq, delta = tfa._dq_kernel(q, k, v, out, lse, do, h, True, grad_dtype)
    plan = tfa.flash_plan(dtype, d, True)
    assert dq.dtype == grad_dtype and delta.shape == lse.shape
    assert {r: tfa.dq_route_launches[r] - before[r] for r in before} == {
        r: int(r == plan.route) for r in before}
    if plan.route == "tc":
        (name, args), = fake_libs["flash_attention_tc"].calls
        assert name == "dtc_flash_tc_dq" and "flash_attention" not in fake_libs
        assert args[8:12] == (b, t, h, d) and args[-5:-1] == (
            1, plan.swizzle, plan.boxes, plan.stages)
        assert args[-6] == int(grad_dtype == torch.bfloat16)
    else:
        (name, args), = fake_libs["flash_attention"].calls
        assert name == "dtc_flash_bwd_dq" and "flash_attention_tc" not in fake_libs


def test_dq_launch_raises_and_never_falls_back(fake_libs):
    """A bf16 dq launch the tensor-core kernel refuses raises: no other
    kernel and no plain version runs, and nothing is counted. A base off
    16-byte alignment (TMA's) is refused before any launch."""
    b, t, h, d = 1, 64, 2, 32
    q = torch.zeros(b, t, h * d, dtype=torch.bfloat16)
    lse = torch.zeros(b, h, t)
    before = dict(tfa.dq_route_launches)
    fake_libs["flash_attention_tc"] = _FakeLib(rc=1)
    with pytest.raises(RuntimeError, match="dq"):
        tfa._dq_kernel(q, q, q, q, lse, q, h, True, torch.bfloat16)
    assert "flash_attention" not in fake_libs and tfa.dq_route_launches == before
    off = torch.zeros(b * t * h * d + 1, dtype=torch.bfloat16)[1:].view(b, t, h * d)
    fake_libs["flash_attention_tc"] = _FakeLib()
    with pytest.raises(ValueError, match="aligned"):
        tfa._dq_kernel(q, q, q, off, lse, q, h, True, torch.bfloat16)
    assert fake_libs["flash_attention_tc"].calls == [] and tfa.dq_route_launches == before


def test_flash_plan_raises_on_what_no_kernel_takes():
    with pytest.raises(ValueError, match="not in the kernels"):
        tfa.flash_plan(torch.bfloat16, 40, True)
    with pytest.raises(ValueError, match="ROADMAP"):
        tfa.flash_plan(torch.bfloat16, 256, True)
    with pytest.raises(ValueError, match="dtype"):
        tfa.flash_plan(torch.float16, 32, True)


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_twin_is_jaxs_multi_tile_kernel(seed):
    """Step (a) of the two-step rule for the tensor-core forward: its eager
    tiling twin, at a key tile of 128 (JAX's ``supports`` wants
    ``block_kv % 128 == 0``), against JAX's interpret-mode
    ``_fwd_kernel_packed_multi`` (TPU kernel row 6) in blocks of 128: the
    same online softmax, so out within 1 bf16 ulp of each (row, head)'s
    largest value and at least 99.9% of it bit-equal (measured 99.97%;
    float32 sums in another order may flip a rounding of p), lse 1e-5."""
    from dtc_tpu_torch.parity import BF16_ULPS

    b, t, h, d = 1, 512, 8, 32
    q, k, v, _ = _inputs(b, t, h, d, seed)
    jq, jk, jv = (jnp.asarray(x.reshape(b, t, h * d), jnp.bfloat16) for x in (q, k, v))
    out, lse = jfa._packed_fwd_call(jq, jk, jv, 128, 128, jfa._packed_group(d, h), d,
                                    float(d ** -0.5))
    jout = torch.from_numpy(np.array(jnp.asarray(out, jnp.float32))).to(torch.bfloat16)
    jlse = torch.from_numpy(np.array(lse).transpose(0, 1, 3, 2).reshape(b, h, t))
    tq, tk, tv = (torch.from_numpy(x.reshape(b, t, h * d)).to(torch.bfloat16) for x in (q, k, v))
    tout, tlse = tfa.flash_forward_twin(tq, tk, tv, h, True, key_tile=128)
    _assert_within("out", tout, jout, attention_tolerance(jout, h) / BF16_ULPS)
    assert (tout.float() == jout.float()).float().mean().item() >= 0.999
    _assert_within("lse", tlse, jlse, torch.full(jlse.shape, FP32_ATOL))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,rows", [(1000, None), (4096, (3840, 4096))])
def test_forward_twin_one_pass_fits_the_plain_limit(t, rows, causal, seed):
    """The one-pass softmax at the kernel's own key tile (64) against the
    two-pass plain version that holds the kernel on the card, within the
    existing bf16 ``attention_tolerance`` (measured ≤ 0.28 of it): T 1000
    (ragged: the last tile masked past T) and the last 256 query rows of T
    4096 (64 key tiles of rescaling), causal and not, bfloat16."""
    h, d = 2, 32
    q, k, v = (torch.from_numpy(x.reshape(1, t, h * d)).to(torch.bfloat16)
               for x in _inputs(1, t, h, d, seed)[:3])
    r0, r1 = rows or (0, t)
    out, lse = tfa.flash_forward_twin(q, k, v, h, causal, key_tile=tfa.TILE, rows=rows)
    want_out, want_lse = tfa.flash_attention_reference(q, k, v, h, causal)
    want_out, want_lse = want_out[:, r0:r1], want_lse[..., r0:r1]
    _assert_within("out", out, want_out, attention_tolerance(want_out, h))
    _assert_within("lse", lse, want_lse, torch.full(want_lse.shape, FP32_ATOL))


# --- the tensor-core dq kernel's tiling twin -------------------------------


def _share_equal(got, want) -> float:
    return (got.float() == want.float()).float().mean().item()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dq_twin_is_jaxs_packed_split_dq_kernel(monkeypatch, dtype):
    """Row 8 (``_dq_kernel_packed``, JAX's split backward past
    ``_PACKED_MAX_T``, lowered to 128): the twin at JAX's key tile (128)
    on the inputs JAX's ``_packed_split_bwd_call`` got (its forward's out
    and lse) against the dq it returned, within ``grad_tolerance``. JAX
    scales each tile's dS·K by D^-0.5 before summing; the twin scales the
    sum, so a float32 rounding may flip a bf16 one: at least 99% of the bf16
    values bit-equal (measured 99.9%), float32 within its 1e-5 limit."""
    monkeypatch.setattr(jfa, "_PACKED_MAX_T", 128)
    seen = []
    real = jfa._packed_split_bwd_call

    def spy(*args):
        seen.append((args, real(*args)))
        return seen[-1][1]

    monkeypatch.setattr(jfa, "_packed_split_bwd_call", spy)
    b, t, h, d = 1, 256, 4, 32
    q, k, v, do = _inputs(b, t, h, d, seed=13)
    _jax(q, k, v, do, 128, dtype)
    (args, (jdq, _, _)), = seen
    jq, jk, jv, jdo, jout, jlse = args[:6]
    g = args[8]
    tq, tk, tv, tdo, tout = (torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))
                             .to(getattr(torch, dtype)) for x in (jq, jk, jv, jdo, jout))
    lse = torch.from_numpy(np.array(jlse)).permute(0, 1, 3, 2).reshape(b, h, t)
    assert g == 128 // d
    dq, _ = tfa.flash_dq_twin(tq, tk, tv, tout, lse, tdo, h, True, key_tile=128)
    want = torch.from_numpy(np.array(jnp.asarray(jdq, jnp.float32))).to(dq.dtype)
    _assert_within("dq", dq, want, grad_tolerance(want, h))
    if dtype == "bfloat16":
        assert _share_equal(dq, want) >= 0.99


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dq_twin_matches_jaxs_transposed_dq_kernel(dtype):
    """Row 13 (``_dq_kernel``, the transpose-layout family, 2 heads of 48
    at T 256 in two tiles): the twin on JAX's own out and lse against
    JAX's dq (through the VJP of ``q * scale``, rounded to q's dtype twice)
    within ``grad_tolerance``."""
    b, t, h, d = 1, 256, 2, 48
    q, k, v, do = _inputs(b, t, h, d, seed=17)
    jout, jlse, jgrads = _jax_transposed(q, k, v, do, t // 2, dtype)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(x.reshape(b, t, h * d)).to(tdt) for x in (q, k, v, do))
    dq, _ = tfa.flash_dq_twin(tq, tk, tv, jout.to(tdt), jlse, tdo, h, True)
    want = jgrads[0].to(tdt)
    _assert_within("dq", dq, want, grad_tolerance(want, h))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dq_twin_matches_jaxs_block_bwd_dq(dtype):
    """Row 16 (``_block_bwd_kernel``, the ring's block backward): no mask,
    float32 gradients from a given out and lse, tc 72 (a full key tile and
    a ragged one): the twin against JAX's float32 dq, within 4 bf16 ulps of
    each head's largest value for bf16 inputs (``grad_tolerance`` of the
    rounded gradient, the ring tests' limit), 1e-5 for float32."""
    b, tc, h, d = 2, 72, 4, 32
    g = jfa._packed_group(d, h)
    rng = np.random.RandomState(19)
    q, k, v, do = (rng.randn(b, tc, h * d).astype(np.float32) for _ in range(4))
    jq, jk, jv, jdo = (jnp.asarray(x, _JDT[dtype]) for x in (q, k, v, do))
    scale = float(d ** -0.5)
    jout, jlse = jfa._block_call(jq, jk, jv, scale, False, g, d)
    jlse = jlse + 0.5  # as if the ring had merged more mass
    jdq, _, _ = jfa._block_call(jq, jk, jv, scale, False, g, d, do=jdo, o=jout, lse=jlse)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt) for x in (q, k, v, do))
    tout = torch.from_numpy(np.array(jnp.asarray(jout, jnp.float32))).to(tdt)
    lse = torch.from_numpy(np.array(jlse)).permute(0, 1, 3, 2).reshape(b, h, tc)
    dq, _ = tfa.flash_dq_twin(tq, tk, tv, tout, lse, tdo, h, False, grad_dtype=torch.float32)
    want = torch.from_numpy(np.array(jdq))
    assert dq.dtype == torch.float32
    _assert_within("dq", dq, want, grad_tolerance(want.to(tdt), h))


@pytest.mark.parametrize("grad_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
def test_dq_twin_fits_the_plain_limit_at_a_ragged_t(causal, grad_dtype):
    """The twin's per-tile sums at the kernel's key tile (64) against the
    plain version's one sum, bfloat16 inputs, T 100 (two tiles, the last
    ragged), causal and not: dq within ``grad_tolerance`` (of the bf16
    rounding for float32 gradients), delta the plain rowsum(dO ⊙ O)."""
    b, t, h, d = 2, 100, 2, 32
    q, k, v, do = (torch.from_numpy(x.reshape(b, t, h * d)).to(torch.bfloat16)
                   for x in _inputs(b, t, h, d, seed=23))
    out, lse = tfa.flash_attention_reference(q, k, v, h, causal)
    dq, delta = tfa.flash_dq_twin(q, k, v, out, lse, do, h, causal, grad_dtype=grad_dtype)
    want = tfa.flash_attention_backward_reference(q, k, v, out, lse, do, h, causal,
                                                  grad_dtype)[0]
    assert dq.dtype == grad_dtype
    _assert_within("dq", dq, want, grad_tolerance(want.to(torch.bfloat16), h))
    want_delta = (do.float() * out.float()).view(b, t, h, d).sum(-1).permute(0, 2, 1)
    assert torch.equal(delta, want_delta)
