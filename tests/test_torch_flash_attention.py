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
stages per head dim) is checked here; the tensor-core forward's one-pass
softmax is held through its eager tiling twin (``flash_forward_twin``)
against JAX's interpret-mode multi-tile kernel at JAX's key tile (128) and
against the two-pass plain version at the kernel's own (64), before the
card holds the kernel against both (``tests/test_torch_gpu.py``).

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


def test_cpu_tensors_take_the_plain_version_without_counting():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 64, 2, 16, seed=1))
    f0, b0 = tfa.fwd_launches, tfa.bwd_launches
    xs = [x.requires_grad_(True) for x in (q, k, v)]
    tfa.flash_causal_attention(*xs).backward(do)
    assert (tfa.fwd_launches, tfa.bwd_launches) == (f0, b0)


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
