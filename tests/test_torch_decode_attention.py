"""The port's decode attention (plain version + wrapper on CPU tensors,
and the eager twin of the Hopper kernel's split schedule) against the JAX
package's ``fused_decode_attention``, which runs its Pallas kernels in
interpret mode on the CPU: the single-tile kernel at S = 16 and 600 and
the blocked kernel at S = 4608.

Tolerances (``parity.attention_tolerance``): float32 1e-5 (same
arithmetic, summation order differs); bfloat16 a few bf16 ulps of each
head's largest output (the output cast, plus p rounded to bf16 against
another max: a running max in JAX's blocked kernel, each split's max in
the twin); int8 caches dequantize to q's dtype and take that dtype's
tolerance.
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
from tests.test_torch_train import _one_thread  # noqa: F401  (autouse: one intra-op thread)

H, D = 2, 8


def _inputs(seed, b, s, qdtype, kv, h=H, d=D):
    """The same q, k, v (and int8 scales) for JAX and the port. Casts run on
    the host (numpy's bfloat16 rounds to nearest even, as torch's does) and
    an int8 cache is quantized once, by the port's ``quantize_kv``, which
    is bit-equal to JAX's (``test_quantize_kv_bit_equal_to_jax``): no JAX
    op is compiled for the inputs."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, 1, h * d).astype(np.float32)
    k = rng.randn(b, s, h * d).astype(np.float32)
    v = rng.randn(b, s, h * d).astype(np.float32)
    jdt, tdt = getattr(jnp, qdtype), getattr(torch, qdtype)
    jq = jnp.asarray(q.astype(jdt))
    tq = torch.from_numpy(q).to(tdt)
    if kv == "int8":
        tk, tks = tda.quantize_kv(torch.from_numpy(k), h)
        tv, tvs = tda.quantize_kv(torch.from_numpy(v), h)
        jk, jv, jks, jvs = (jnp.asarray(x.numpy()) for x in (tk, tv, tks, tvs))
        jargs = (jq, jk, jv, dict(k_scale=jks, v_scale=jvs))
        targs = (tq, tk, tv, dict(k_scale=tks, v_scale=tvs))
        return jargs, targs
    jargs = (jq, jnp.asarray(k.astype(jdt)), jnp.asarray(v.astype(jdt)), {})
    targs = (tq, torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt), {})
    return jargs, targs


def _compare(jargs, targs, start, h=H, d=D, ports=(tda.fused_decode_attention,), jstart=None):
    """The ports at ``start`` against JAX at ``jstart`` (default ``start``)."""
    jq, jk, jv, jkw = jargs
    tq, tk, tv, tkw = targs
    want = jda.fused_decode_attention(
        jq, jk, jv, jnp.asarray(start if jstart is None else jstart, jnp.int32), h=h, d=d,
        **jkw
    )
    want = torch.from_numpy(np.asarray(want).astype(np.float32)).to(tq.dtype)
    limit = attention_tolerance(want, h)
    for port in ports:
        got = port(tq, tk, tv, torch.tensor(start, dtype=torch.int32), h=h, d=d, **tkw)
        assert got.dtype == tq.dtype and got.shape == tq.shape
        assert ((got.float() - want.float()).abs() <= limit).all(), port.__name__


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


# --- the Hopper kernel's split schedule (decode_split_twin) ---------------


#: The caches the kernel takes, under the q dtype the model pairs them with
#: (float32 q over an int8 cache: the S 4608 case below and the D 8 cases).
CACHES = [("float32", "float"), ("bfloat16", "float"), ("bfloat16", "int8")]
#: Head dims the kernel gained at S 16 and 600; its earlier head dims at S
#: 600 (JAX's interpret-mode compiles, one a case, are tier-1's cost).
NEW_DIMS = [(d, s) for d in (48, 80, 96, 112) for s in (16, 600)]
EARLIER_DIMS = [(d, 600) for d in (16, 32, 64, 128)]


@pytest.mark.parametrize("qdtype,kv", CACHES)
@pytest.mark.parametrize("d,s", NEW_DIMS + EARLIER_DIMS)
def test_twin_and_plain_match_jax_at_the_kernel_head_dims(d, s, qdtype, kv):
    """At every head dim the kernel has (48, 80, 96 and 112, whose rows are
    not a power-of-two count of 16-byte chunks, among them), over float32,
    bfloat16 and int8 caches: the plain version and the split twin against
    JAX's single-tile kernel, per-row frontiers (the first column, a third,
    the last, past the cache) and scalar ones (the first column, the last,
    past the cache). A scalar frontier is the per-row one repeated, so JAX's
    per-row kernel is its oracle too and each case compiles JAX once (JAX's
    scalar path is held at D 8 above). At S 600 the twin cuts most rows into
    several splits, the last one ragged."""
    b = 4
    jargs, targs = _inputs(d, b, s, qdtype, kv, h=2, d=d)
    ports = (tda.decode_attention_reference, tda.decode_split_twin)
    _compare(jargs, targs, [0, s // 3, s - 1, s + 7], h=2, d=d, ports=ports)
    for start in (0, s - 1, s + 5):
        _compare(jargs, targs, start, h=2, d=d, ports=ports, jstart=[start] * b)


@pytest.mark.parametrize("qdtype,kv", [("bfloat16", "float"), ("float32", "int8")])
def test_twin_matches_jax_blocked_kernel_past_one_tile(qdtype, kv):
    """S 4608 takes JAX's blocked kernel (512-wide blocks, a running max);
    the twin's splits are another cut of the same columns: a ragged last
    split (3001 visible columns) and a frontier past the cache."""
    s, d = 4608, 32
    start = [0, 3000, 4607, 5000]
    sl = tda.split_len(d, torch.int8 if kv == "int8" else getattr(torch, qdtype))
    assert 3001 % sl and s // sl > 1
    jargs, targs = _inputs(5, 4, s, qdtype, kv, h=2, d=d)
    _compare(jargs, targs, start, h=2, d=d, ports=(tda.decode_split_twin,))


def test_split_len_mirrors_the_kernels_geometry():
    """One 16-byte chunk a thread, the chunk count of a head row rounded up
    to a power of two a position, 4 positions a group, 256 threads: the
    split lengths of ``csrc/decode_attention.cu``'s Geometry (chip_smoke
    checks them against the library's ``dtc_decode_split_len``)."""
    want = {
        torch.float32: (256, 128, 64, 64, 32, 32, 32, 32),
        torch.bfloat16: (512, 256, 128, 128, 64, 64, 64, 64),
        torch.int8: (1024, 512, 256, 256, 128, 128, 128, 128),
    }
    for dt, lens in want.items():
        assert tuple(tda.split_len(d, dt) for d in tda.KERNEL_HEAD_DIMS) == lens


def test_one_split_is_the_plain_version():
    """A row inside one split takes the plain version's one-pass arithmetic:
    in float32 the two differ by the sum order of the P·V product only."""
    h, d = 2, 32
    _, (q, k, v, _) = _inputs(8, 2, 100, "float32", "float", h=h, d=d)
    assert tda.split_len(d, torch.float32) >= 100
    one = tda.decode_split_twin(q, k, v, 99, h=h, d=d)
    ref = tda.decode_attention_reference(q, k, v, 99, h=h, d=d)
    torch.testing.assert_close(one, ref, atol=1e-6, rtol=0)


def test_split_faults_land_over_the_limit():
    """chip_smoke's planted faults in the twin (one split's partials
    dropped; the partials combined without their rescale) land over the
    limit the kernel is held to, at the flagship's head width."""
    import chip_smoke

    h, d, s = 2, 32, 600
    _, (q, k, v, kw) = _inputs(9, 4, s, "bfloat16", "float", h=h, d=d)
    start = torch.tensor([0, 37, 511, 600], dtype=torch.int32)
    want = tda.decode_attention_reference(q, k, v, start, h=h, d=d)
    limit = attention_tolerance(want, h)
    assert ((tda.decode_split_twin(q, k, v, start, h=h, d=d).float() - want.float()).abs()
            <= limit).all()
    faults = chip_smoke.decode_split_faults(q, k, v, start, h, d, kw)
    assert set(faults) == {"one split dropped", "partials not rescaled"}
    for name, bad in faults.items():
        assert ((bad.float() - want.float()).abs() > limit).any(), name


def test_megakernel_keeps_its_own_head_dims():
    """The decode-attention kernel and the megakernel both take the flash
    kernels' eight head dims; the megakernel's wrapper checks its own tuple
    (on a CUDA tensor it raises ValueError at any other head dim: the GPU
    tests hold that)."""
    from dtc_tpu_torch.ops import decode_fused

    assert tda.KERNEL_HEAD_DIMS == (16, 32, 48, 64, 80, 96, 112, 128)
    assert decode_fused.KERNEL_HEAD_DIMS == (16, 32, 48, 64, 80, 96, 112, 128)
