"""The port's zigzag ring attention against the JAX package's, on the same
numpy inputs.

- The ring's block kernels (TPU kernel rows 15-16, ``_block_call``): JAX
  runs them in interpret mode, the port their plain versions, which are
  what the CUDA kernels are held against on the card. tc 8 and 16, the
  smallest chunks that take the route (``block_supported``: tc % 8 == 0),
  at 4 heads of 32 (one 128-lane group).
- The ring over the port's in-process transport (R virtual ranks in one
  thread) against ``ring_causal_attention`` on R of JAX's 8 CPU devices
  (``model`` axis R), forward and the gradients of ``sum(out²)``: the
  zigzag schedule on the block kernels against JAX's kernel path
  (``DTC_RING_FLASH=1``), on plain blocks (a head dim the kernels do not
  take) against JAX's dense-block path, and the uniform schedule against
  JAX's.

Tolerances. Block kernels: float32 1e-5 (``out``, ``lse``) and 1e-5 × the
largest |value| (gradients); bfloat16 ``parity.attention_tolerance`` for
``out`` and, for the float32 gradients of bf16 inputs, 4 bf16 ulps of each
head's largest |value| (``grad_tolerance`` of the bf16-rounded gradient):
one rounding of p or ds to bf16 may flip where the sum orders differ. The
ring: JAX's own (``tests/test_ring_attention.py``): forward 2e-5 absolute,
gradients 2e-4 (plain blocks) and 2e-3 (kernel path).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dtc_tpu.config.schema import MeshConfig
from dtc_tpu.ops import flash_attention as jfa
from dtc_tpu.ops import ring_attention as jra
from dtc_tpu.parallel.mesh import mesh_from_config
from dtc_tpu_torch.ops import flash_attention as tfa
from dtc_tpu_torch.ops import ring_attention as tra
from dtc_tpu_torch.ops.attention import dense_causal_attention
from dtc_tpu_torch.parity import FP32_ATOL, attention_tolerance, grad_tolerance
from tests.test_torch_train import _one_thread  # noqa: F401  (autouse: one intra-op thread)


_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _lse_to_port(lse, h):
    """JAX's ``(B, H·D/128, tc, 128/D)`` block lse as the port's ``(B, H, tc)``."""
    b, hg, tc, g = lse.shape
    return np.asarray(lse).transpose(0, 1, 3, 2).reshape(b, h, tc)


def _lse_to_jax(lse, g):
    b, h, tc = lse.shape
    return jnp.asarray(lse.reshape(b, h // g, g, tc).transpose(0, 1, 3, 2))


def _within(got, want, limit, name):
    diff = (got.float() - want.float()).abs()
    ratio = float((diff / limit).max())
    assert ratio <= 1.0, f"{name}: {float(diff.max()):.3e} is {ratio:.3f} of its limit"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tc", [8, 16])
@pytest.mark.parametrize("causal", [True, False])
def test_block_plain_versions_match_jax_block_call(dtype, tc, causal):
    """Forward ``(out, lse)`` and the backward from a given lse and out
    (JAX's forward results, as the ring passes its merged ones)."""
    b, h, d = 2, 4, 32
    g = jfa._packed_group(d, h)
    rng = np.random.RandomState(tc + 2 * causal)
    q, k, v, do = (rng.randn(b, tc, h * d).astype(np.float32) for _ in range(4))
    jq, jk, jv, jdo = (jnp.asarray(x, _JDT[dtype]) for x in (q, k, v, do))
    scale = float(d ** -0.5)
    jout, jlse = jfa._block_call(jq, jk, jv, scale, causal, g, d)
    jdq, jdk, jdv = jfa._block_call(jq, jk, jv, scale, causal, g, d, do=jdo, o=jout, lse=jlse)

    tq, tk, tv, tdo = (torch.from_numpy(x).to(_TDT[dtype]) for x in (q, k, v, do))
    out, lse = tfa.flash_block_forward(tq, tk, tv, h, causal)
    want_out = torch.tensor(np.asarray(jout.astype(jnp.float32))).to(out.dtype)
    want_lse = torch.tensor(_lse_to_port(jlse, h))
    assert out.dtype == tq.dtype and lse.dtype == torch.float32
    _within(out, want_out, attention_tolerance(want_out, h), "out")
    _within(lse, want_lse, torch.full(lse.shape, FP32_ATOL), "lse")

    # The backward from JAX's own out and lse.
    grads = tfa.flash_block_backward(tq, tk, tv, want_out, want_lse, tdo, h, causal)
    for name, got, want in zip(("dq", "dk", "dv"), grads, (jdq, jdk, jdv)):
        assert got.dtype == torch.float32
        want = torch.tensor(np.asarray(want))
        limit = grad_tolerance(want.to(_TDT[dtype]), h)
        _within(got, want, limit, name)
    assert np.asarray(_lse_to_jax(want_lse.numpy(), g)).tobytes() == np.asarray(jlse).tobytes()


def _qkv(seed, b, t, h, d):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, h, d).astype(np.float32) for _ in range(3)]


def _jax_ring(q, k, v, ring, schedule="zigzag"):
    """JAX's out and the gradients of sum(out²) (the VJP of 2·out), one jit,
    on a mesh of ``ring`` of the 8 CPU devices (no data replicas)."""
    mesh = mesh_from_config("3d", MeshConfig(pipe=1, data=1, model=ring),
                            devices=jax.devices()[:ring])
    args = tuple(jnp.asarray(x) for x in (q, k, v))

    def fwd_bwd(q, k, v):
        out, vjp = jax.vjp(
            lambda q, k, v: jra.ring_causal_attention(q, k, v, schedule=schedule), q, k, v)
        return out, vjp(2.0 * out)

    with mesh:
        out, grads = jax.jit(fwd_bwd)(*args)
    return np.asarray(out), [np.asarray(x) for x in grads]


def _port_ring(q, k, v, ring, schedule="zigzag"):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = tra.ring_causal_attention(tq, tk, tv, tra.InProcessRing(ring), schedule=schedule)
    grads = torch.autograd.grad((out ** 2).sum(), (tq, tk, tv))
    return out.detach().numpy(), [x.numpy() for x in grads]


@pytest.mark.parametrize("ring", [2, 4])
def test_zigzag_ring_matches_jax_kernel_path(monkeypatch, ring):
    """The zigzag ring on the block kernels' plain versions against JAX's
    zigzag on its block kernels (interpret mode), tc 8: the launches a
    rank makes per call are 2R+1 block forwards and 2R+1 block backwards
    (counted here through the plain versions)."""
    monkeypatch.setenv("DTC_RING_FLASH", "1")
    q, k, v = _qkv(ring, 1, 16 * ring, 4, 32)
    assert jfa.block_supported(8, 4, 32)
    jout, jgrads = _jax_ring(q, k, v, ring)
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = tfa.flash_block_reference, tfa.flash_block_backward_reference

    def count_fwd(*a):
        calls["fwd"] += 1
        return real_fwd(*a)

    def count_bwd(*a):
        calls["bwd"] += 1
        return real_bwd(*a)

    monkeypatch.setattr(tfa, "flash_block_reference", count_fwd)
    monkeypatch.setattr(tfa, "flash_block_backward_reference", count_bwd)
    out, grads = _port_ring(q, k, v, ring)
    assert calls == {"fwd": ring * (2 * ring + 1), "bwd": ring * (2 * ring + 1)}
    np.testing.assert_allclose(out, jout, atol=2e-5, rtol=0)
    for name, got, want in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("ring", [2, 4])
def test_ring_on_plain_blocks_and_uniform_match_jax(ring):
    """A head dim the kernels do not take (24) runs the zigzag schedule on
    plain blocks, as JAX's dense-block path does for a head group 128
    lanes do not fit; the uniform schedule against JAX's; zigzag against
    uniform."""
    q, k, v = _qkv(10 + ring, 2, 16 * ring, 2, 24)
    assert not jfa.block_supported(8, 2, 24) and 24 not in tfa.KERNEL_HEAD_DIMS
    for schedule in ("zigzag", "uniform"):
        jout, jgrads = _jax_ring(q, k, v, ring, schedule)
        out, grads = _port_ring(q, k, v, ring, schedule)
        np.testing.assert_allclose(out, jout, atol=2e-5, rtol=0, err_msg=schedule)
        for name, got, want in zip("qkv", grads, jgrads):
            np.testing.assert_allclose(got, want, atol=2e-4, rtol=0,
                                       err_msg=f"{schedule} d{name}")
    zz, _ = _port_ring(q, k, v, ring, "zigzag")
    un, _ = _port_ring(q, k, v, ring, "uniform")
    np.testing.assert_allclose(zz, un, atol=2e-5, rtol=0)


def test_ring_errors_and_ring_of_one():
    """T not divisible by 2R raises as JAX's does; a ring of one is dense
    attention; an unknown schedule raises."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 1, 36, 2, 16))
    with pytest.raises(ValueError, match="not divisible"):
        tra.ring_causal_attention(q, k, v, tra.InProcessRing(4))
    with pytest.raises(ValueError, match="not divisible"):
        tra.ring_causal_attention(q[:, :34], k[:, :34], v[:, :34], tra.InProcessRing(4),
                                  schedule="uniform")
    with pytest.raises(ValueError, match="schedule"):
        tra.ring_causal_attention(q, k, v, tra.InProcessRing(2), schedule="striped")
    dense = dense_causal_attention(q, k, v)
    assert torch.equal(tra.ring_causal_attention(q, k, v, tra.InProcessRing(1)), dense)
    assert torch.equal(tra.ring_causal_attention(q, k, v), dense)      # no ring


def test_zigzag_layout_round_trips():
    """``to_zigzag`` puts chunks (C_i, C_{2R-1-i}) on rank i, as JAX's
    ``_zigzag_perms`` routes them, and ``from_zigzag`` brings them home."""
    ring, tc = 4, 2
    x = torch.arange(2 * ring * tc, dtype=torch.float32).reshape(1, -1)
    r = tra.InProcessRing(ring)
    shards = x.chunk(ring, dim=1)
    zz = r.run(tra.to_zigzag(i, ring, [s]) for i, s in enumerate(shards))
    for i, (z,) in enumerate(zz):
        chunks = [int(c[0, 0]) // tc for c in z.chunk(2, dim=1)]
        assert chunks == [i, 2 * ring - 1 - i]
    assert jra._zigzag_perms(ring) == tra._zigzag_perms(ring)
    back = r.run(tra.from_zigzag(i, ring, z) for i, z in enumerate(zz))
    assert torch.equal(torch.cat([b[0] for b in back], dim=1), x)


def test_model_under_an_in_process_ring_matches_dense():
    """The whole model with ``attention: ring`` over 4 virtual ranks: the
    loss and every gradient of the dense model (the ring sees the whole
    sequence, so positions start at 0)."""
    import dataclasses

    from dtc_tpu_torch.config import schema as ts
    from dtc_tpu_torch.models.gpt import GPT

    cfg = ts.ModelConfig(vocab_size=97, d_model=64, n_layers=2, n_heads=2, d_ff=128,
                         max_seq_len=32, compute_dtype="float32", dropout=0.0)
    dense = GPT(cfg, device="cpu")
    ring = GPT(dataclasses.replace(cfg, attention="ring"), device="cpu")
    ring.load_state_dict(dense.state_dict())
    rng = np.random.RandomState(4)
    x, y = (torch.from_numpy(rng.randint(0, 97, size=(2, 32))) for _ in range(2))
    want = dense(x, train=True, targets=y)
    with tra.use_ring(tra.InProcessRing(4)):
        got = ring(x, train=True, targets=y)
    want.backward()
    got.backward()
    assert abs(float(got.detach()) - float(want.detach())) <= 1e-5
    for (name, a), b in zip(dense.named_parameters(), ring.parameters()):
        # k_proj's bias gets a zero gradient up to rounding (softmax shifts)
        limit = 1e-5 * max(float(a.grad.abs().max()), 1.0)
        torch.testing.assert_close(b.grad, a.grad, atol=limit, rtol=0, msg=name)
