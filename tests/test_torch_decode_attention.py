"""The port's decode attention (plain version + wrapper on CPU tensors)
against the JAX package's ``fused_decode_attention``, which runs its
Pallas kernels in interpret mode on the CPU: the single-tile kernel at
S = 16 and the blocked kernel at S = 4608.

Tolerances (``parity.attention_tolerance``): float32 1e-5 (same
arithmetic, summation order differs); bfloat16 a few bf16 ulps of each
head's largest output (the output cast, plus p rounded to bf16 against
another running max in the blocked kernel); int8 caches dequantize to q's
dtype and take that dtype's tolerance.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from dtc_tpu.ops import decode_attention as jda
from dtc_tpu_torch.config.schema import ModelConfig
from dtc_tpu_torch.models.gpt import CausalSelfAttention
from dtc_tpu_torch.ops import decode_attention as tda
from dtc_tpu_torch.parity import attention_tolerance

H, D = 2, 8


def _inputs(seed, b, s, qdtype, kv):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, 1, H * D).astype(np.float32)
    k = rng.randn(b, s, H * D).astype(np.float32)
    v = rng.randn(b, s, H * D).astype(np.float32)
    jq = jnp.asarray(q).astype(qdtype)
    tq = torch.from_numpy(q).to(getattr(torch, qdtype))
    if kv == "int8":
        jk, jks = jda.quantize_kv(jnp.asarray(k), H)
        jv, jvs = jda.quantize_kv(jnp.asarray(v), H)
        jargs = (jq, jk, jv, dict(k_scale=jks, v_scale=jvs))
        tk, tv = (torch.from_numpy(np.array(x)) for x in (jk, jv))
        targs = (tq, tk, tv, dict(
            k_scale=torch.from_numpy(np.array(jks)),
            v_scale=torch.from_numpy(np.array(jvs)),
        ))
        return jargs, targs
    jargs = (jq, jnp.asarray(k).astype(qdtype), jnp.asarray(v).astype(qdtype), {})
    tdt = getattr(torch, qdtype)
    targs = (tq, torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt), {})
    return jargs, targs


def _compare(jargs, targs, start):
    jq, jk, jv, jkw = jargs
    tq, tk, tv, tkw = targs
    want = jda.fused_decode_attention(
        jq, jk, jv, jnp.asarray(start, jnp.int32), h=H, d=D, **jkw
    )
    got = tda.fused_decode_attention(
        tq, tk, tv, torch.tensor(start, dtype=torch.int32), h=H, d=D, **tkw
    )
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).to(got.dtype)
    limit = attention_tolerance(want, H)
    assert ((got.float() - want.float()).abs() <= limit).all()


CASES = [
    ("float32", "float"), ("bfloat16", "float"),
    ("float32", "int8"), ("bfloat16", "int8"),
]


@pytest.mark.parametrize("s", [16, 4608])
@pytest.mark.parametrize("qdtype,kv", CASES)
def test_scalar_frontier_matches_jax(s, qdtype, kv):
    """One frontier for the batch: the first column only, the last, and
    past the cache (an idle slot's frontier — every column visible)."""
    jargs, targs = _inputs(0, 2, s, qdtype, kv)
    for start in (0, s - 1, s + 5):
        _compare(jargs, targs, start)


@pytest.mark.parametrize("s", [16, 4608])
@pytest.mark.parametrize("qdtype,kv", CASES)
def test_per_row_frontier_matches_jax(s, qdtype, kv):
    jargs, targs = _inputs(1, 4, s, qdtype, kv)
    _compare(jargs, targs, [0, s // 3, s - 1, s + 7])


def test_quantize_kv_bit_equal_to_jax():
    rng = np.random.RandomState(2)
    x = (rng.randn(3, 5, H * D) * rng.uniform(0.01, 10, (3, 5, 1))).astype(np.float32)
    x[0, 0, :D] = 0.0  # an all-zero head round-trips exactly
    jq, js = jda.quantize_kv(jnp.asarray(x), H)
    tq, ts = tda.quantize_kv(torch.from_numpy(x), H)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for dt in ("float32", "bfloat16"):
        want = jda.dequantize_kv(jq, js, H, getattr(jnp, dt))
        got = tda.dequantize_kv(tq, ts, H, getattr(torch, dt))
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32))
        )


@pytest.mark.parametrize("s", [1, 512, 4096, 4097, 4608, 5000, 8192])
def test_single_token_decode_takes_the_kernel_at_every_cache_length(s, monkeypatch):
    """Under ``decode_attention: fused`` a single-token decode calls the
    kernel's wrapper whatever the cache length (the Hopper kernel has no
    512-block rule, so lengths such as 4097 and 5000, which the JAX package
    sends to its einsum path, take it too) and agrees with the plain
    attention path in float32."""
    calls = []
    wrapper = tda.fused_decode_attention
    monkeypatch.setattr(
        tda, "fused_decode_attention", lambda *a, **kw: calls.append(1) or wrapper(*a, **kw)
    )
    b, hd = 2, H * D
    g = torch.Generator().manual_seed(s)
    x = torch.randn(b, 1, hd, generator=g)
    cache = {n: torch.randn(1, b, s, hd, generator=g) for n in ("k", "v")}
    idx = torch.tensor([s // 2, s - 1], dtype=torch.int32)
    outs = {}
    for mode in ("fused", "xla"):
        cfg = ModelConfig(vocab_size=97, d_model=hd, n_layers=1, n_heads=H, d_ff=4 * hd,
                          max_seq_len=s, compute_dtype="float32", decode_attention=mode)
        attn = CausalSelfAttention(cfg, device="cpu")
        torch.manual_seed(0)
        for p in attn.parameters():
            torch.nn.init.normal_(p, std=0.3)
        outs[mode] = attn(x, {n: c.clone() for n, c in cache.items()}, 0, idx)
    assert len(calls) == 1
    torch.testing.assert_close(outs["fused"], outs["xla"], atol=1e-5, rtol=0)


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(2, 1, H * D)
    k = torch.zeros(2, 8, H * D)
    with pytest.raises(ValueError):
        tda.fused_decode_attention(q, k, k, 0, h=H, d=D + 1)
    with pytest.raises(ValueError):
        tda.fused_decode_attention(torch.zeros(2, 2, H * D), k, k, 0, h=H, d=D)
    with pytest.raises(ValueError):
        tda.fused_decode_attention(q, k.to(torch.int8), k.to(torch.int8), 0, h=H, d=D)
    with pytest.raises(ValueError):
        tda.fused_decode_attention(q, k, k, torch.tensor([1, 2, 3]), h=H, d=D)


def test_cpu_tensors_take_the_plain_version_without_counting():
    """A CPU call runs the plain version and is not a kernel launch."""
    jargs, targs = _inputs(3, 2, 16, "float32", "float")
    tq, tk, tv, _ = targs
    before = tda.launches
    got = tda.fused_decode_attention(tq, tk, tv, 5, h=H, d=D)
    want = tda.decode_attention_reference(tq, tk, tv, 5, h=H, d=D)
    assert torch.equal(got, want)
    assert tda.launches == before
