"""The port's layer-fused decode step (``decode_attention: fused_layers``)
against the JAX package's megakernel, on the CPU.

On the CPU the port's wrapper runs its plain version
(``decode_fused.fused_layers_reference``); the JAX package's Pallas
megakernel runs in interpret mode, as its own tests run it. Same flax
weights (``parity.from_flax``), the same numpy-made cache contents and
tokens go through both.

Tolerances. float32: 1e-5 of the largest |value| compared (summation order
only). bfloat16: 8 ulps of each row's largest |logit| (and of each
(position, head)'s largest |k| or |v|): both packages round every product,
the residual and the logits to bf16, but at different places inside fused
ops (GELU, LayerNorm), so a few ulps of drift build up over four layers
(measured: under 3).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dtc_tpu.config.schema import ModelConfig as JCfg
from dtc_tpu.generate import decode_step as jdecode_step
from dtc_tpu.generate import generate as jgenerate
from dtc_tpu.generate import init_cache as jinit_cache
from dtc_tpu.models.gpt import GPT as JGPT
from dtc_tpu.ops import decode_fused as jdecode_fused
from dtc_tpu_torch.config.schema import ModelConfig, ServeConfig
from dtc_tpu_torch.generate import decode_step, generate, init_cache
from dtc_tpu_torch.models.gpt import GPT
from dtc_tpu_torch.ops import decode_fused
from dtc_tpu_torch.parity import from_flax
from dtc_tpu_torch.serve import Request, RequestState, ServingEngine
from tests.test_torch_train import _one_thread  # noqa: F401  (autouse: one intra-op thread)


VOCAB = 97
BF16_ULPS = 8
TINY = dict(vocab_size=VOCAB, d_model=64, n_layers=4, n_heads=4, d_ff=128,
            max_seq_len=32, dropout=0.0, decode_attention="fused_layers")

_PAIRS = {}


def _pair(compute="float32", kv="auto", backend="fused_layers", dims=None):
    """The JAX and port models on the tiny config (``dims`` overriding its
    widths), same weights (cached)."""
    key = (compute, kv, backend, tuple(sorted((dims or {}).items())))
    if key not in _PAIRS:
        kw = dict(TINY, compute_dtype=compute, kv_cache_dtype=kv, decode_attention=backend,
                  **(dims or {}))
        jm = JGPT(JCfg(**kw))
        params = jm.init(
            {"params": jax.random.PRNGKey(0)}, jnp.ones((1, 1), jnp.int32), train=False
        )["params"]
        tm = GPT(ModelConfig(**kw), device="cpu")
        tm.load_state_dict(from_flax(jax.tree.map(np.asarray, params), tm.cfg))
        _PAIRS[key] = (jm, params, tm)
    return _PAIRS[key]


def _filled_caches(jm, tm, b, rng):
    """JAX and port caches of batch ``b`` holding the same random
    contents (K/V representable in the cache dtype; int8 payloads and
    positive scales)."""
    jc = jinit_cache(jm, b)
    tc = init_cache(tm, b)
    attn = jdecode_fused._block_subtree(jc)["attn"]
    filled = {}
    for name, leaf in attn.items():
        if leaf.dtype == jnp.int8:
            a = rng.randint(-127, 128, size=leaf.shape).astype(np.int8)
        elif name.endswith("scale"):
            a = rng.uniform(0.005, 0.02, size=leaf.shape).astype(np.float32)
        else:
            a = (rng.randn(*leaf.shape) * 0.5).astype(np.float32)
            a = np.asarray(jnp.asarray(a).astype(leaf.dtype).astype(jnp.float32))
        filled[name] = jnp.asarray(a).astype(leaf.dtype)
        tc[name] = torch.from_numpy(a.copy()).to(tc[name].dtype)
    jc = {"index": jc["index"], "stage": {"blocks": {"Block_0": {"attn": filled}}}}
    return jc, tc


def _row_limit(want: np.ndarray, ulps: int) -> np.ndarray:
    """``ulps`` bf16 ulps of the largest |value| along the last axis."""
    _, e = np.frexp(np.abs(want).max(axis=-1, keepdims=True))
    return ulps * np.exp2(e - 8.0)


def _assert_close(got, want, compute, heads=None):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if heads:  # per (position, head) rows of a packed H·D cache
        got = got.reshape(*got.shape[:-1], heads, -1)
        want = want.reshape(*want.shape[:-1], heads, -1)
    if compute == "float32":
        limit = 1e-5 * max(float(np.abs(want).max()), 1.0)
    else:
        limit = _row_limit(want, BF16_ULPS)
    assert (np.abs(got - want) <= limit).all(), float(np.abs(got - want).max())


def _jax_kv(jc, name):
    return np.asarray(jdecode_fused._block_subtree(jc)["attn"][name].astype(jnp.float32))


# (compute dtype, KV dtype, window t, frontier: "scalar" int or per-row list)
_STEP_CASES = [
    ("float32", "auto", 1, 0),
    ("float32", "auto", 1, [5, 31]),
    ("float32", "auto", 4, 28),
    ("float32", "int8", 1, [0, 17]),
    ("float32", "int8", 4, [28, 3]),
    ("bfloat16", "auto", 1, [5, 17]),
    ("bfloat16", "auto", 4, 0),
    ("bfloat16", "int8", 4, [0, 28]),
]


@pytest.mark.parametrize("compute,kv,t,start", _STEP_CASES)
def test_fused_step_matches_jax_megakernel(compute, kv, t, start):
    """One decode step (t = 1) or verify window (t = 4) at a scalar or
    per-row frontier, from start 0 up to S - t, over a cache of random
    contents: the logits, every K/V position and the int8 scales agree
    with JAX's ``fused_decode_step`` (interpret mode)."""
    jm, params, tm = _pair(compute, kv)
    b = 2
    rng = np.random.RandomState(t * 10 + len(str(start)))
    jc, tc = _filled_caches(jm, tm, b, rng)
    idx = np.asarray(start, np.int32)
    jc["index"] = jnp.asarray(idx)
    tc["index"] = torch.from_numpy(idx.copy())
    tok = rng.randint(0, VOCAB, size=(b, t)).astype(np.int32)
    assert decode_fused.use_fused_layers(tm.cfg, t, verify=t > 1)

    jc2, jl = jdecode_step(jm, params, jc, jnp.asarray(tok), spec_verify=t > 1)
    tc2, tl = decode_step(tm, tc, torch.from_numpy(tok), spec_verify=t > 1)

    jl = np.asarray(jl.astype(jnp.float32))
    tl = tl.float().numpy()
    assert tl.shape == jl.shape == (b, t, tm.cfg.padded_vocab_size)
    assert (tl[..., VOCAB:] < -1e8).all()
    _assert_close(tl[..., :VOCAB], jl[..., :VOCAB], compute)
    np.testing.assert_array_equal(tc2["index"].numpy(), np.asarray(jc2["index"]))
    h, d = tm.cfg.n_heads, tm.cfg.head_dim
    if kv == "int8":  # compared dequantized, as attention reads them
        for name in ("k", "v"):
            got = tc2[name].float() * tc2[f"{name}_scale"].repeat_interleave(d, dim=-1)
            want = _jax_kv(jc2, name) * np.repeat(_jax_kv(jc2, f"{name}_scale"), d, axis=-1)
            _assert_close(got.numpy(), want, compute, heads=h)
            _assert_close(tc2[f"{name}_scale"].numpy(), _jax_kv(jc2, f"{name}_scale"), compute)
    else:
        for name in ("k", "v"):
            _assert_close(tc2[name].float().numpy(), _jax_kv(jc2, name), compute, heads=h)


# (head dim, KV dtype, window t, frontier): bfloat16 compute over a bf16
# and an int8 cache, t 1 and t 4, at two head dims the kernel's position
# groups leave lanes idle at.
_HEAD_DIM_CASES = [
    (48, "int8", 1, [5, 31]),
    (48, "auto", 4, [28, 3]),
    (112, "auto", 1, [0, 17]),
    (112, "int8", 4, [9, 28]),
]


@pytest.mark.parametrize("d,kv,t,start", _HEAD_DIM_CASES)
def test_fused_step_matches_jax_megakernel_at_new_head_dims(d, kv, t, start):
    """Head dims 48 and 112, the smallest model that takes the megakernel
    there (2 heads, 2 layers, S 32), bfloat16: the plain version's logits
    and caches against JAX's ``fused_decode_step`` (interpret mode), as
    :func:`test_fused_step_matches_jax_megakernel`."""
    dims = dict(d_model=2 * d, n_heads=2, n_layers=2, d_ff=4 * d)
    jm, params, tm = _pair("bfloat16", kv, dims=dims)
    assert jdecode_fused.supports_fused_layers(jm.cfg, t)
    b = 2
    rng = np.random.RandomState(d + t)
    jc, tc = _filled_caches(jm, tm, b, rng)
    idx = np.asarray(start, np.int32)
    jc["index"] = jnp.asarray(idx)
    tc["index"] = torch.from_numpy(idx.copy())
    tok = rng.randint(0, VOCAB, size=(b, t)).astype(np.int32)
    jc2, jl = jdecode_step(jm, params, jc, jnp.asarray(tok), spec_verify=t > 1)
    tc2, tl = decode_step(tm, tc, torch.from_numpy(tok), spec_verify=t > 1)
    jl = np.asarray(jl.astype(jnp.float32))
    _assert_close(tl.float().numpy()[..., :VOCAB], jl[..., :VOCAB], "bfloat16")
    for name in ("k", "v"):
        if kv == "int8":
            got = tc2[name].float() * tc2[f"{name}_scale"].repeat_interleave(d, dim=-1)
            want = _jax_kv(jc2, name) * np.repeat(_jax_kv(jc2, f"{name}_scale"), d, axis=-1)
            _assert_close(got.numpy(), want, "bfloat16", heads=2)
        else:
            _assert_close(tc2[name].float().numpy(), _jax_kv(jc2, name), "bfloat16", heads=2)


@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_plain_version_matches_per_layer_path(t, kv):
    """float32: the megakernel's plain version against the port's own
    per-layer path (``decode_attention: fused`` for t = 1, the multi-token
    frontier append for t = 4), from the same caches at per-row
    frontiers: logits and every cache entry agree."""
    _, _, tm = _pair("float32", kv)
    ref = GPT(dataclasses.replace(tm.cfg, decode_attention="fused"), device="cpu")
    ref.load_state_dict(tm.state_dict())
    rng = np.random.RandomState(3)
    b = 3
    prompt = torch.from_numpy(rng.randint(0, VOCAB, size=(b, 9)).astype(np.int32))
    cache, _ = decode_step(tm, init_cache(tm, b), prompt)
    cache["index"] = torch.tensor([9, 4, 1], dtype=torch.int32)
    tok = torch.from_numpy(rng.randint(0, VOCAB, size=(b, t)).astype(np.int32))
    before = {k: v.clone() for k, v in cache.items()}
    c1, l1 = decode_fused.fused_decode_step(tm, cache, tok)
    got = {k: v.clone() for k, v in c1.items()}
    c2, l2 = decode_step(ref, dict(before), tok)
    _assert_close(l1[..., :VOCAB].numpy(), l2[..., :VOCAB].numpy(), "float32")
    np.testing.assert_array_equal(got["index"].numpy(), c2["index"].numpy())
    for name in before:
        if name != "index":
            _assert_close(got[name].float().numpy(), c2[name].float().numpy(), "float32")


def test_idle_row_past_the_cache_clamps_its_write():
    """An idle serving slot whose frontier ran past S (its output is
    discarded): its write clamps to S - t, it reads min(start, S) cached
    columns and stays finite, and the other rows are untouched by it,
    equal to the per-layer path's."""
    _, _, tm = _pair("float32", "auto")
    ref = GPT(dataclasses.replace(tm.cfg, decode_attention="fused"), device="cpu")
    ref.load_state_dict(tm.state_dict())
    s = tm.cfg.max_seq_len
    rng = np.random.RandomState(4)
    cache = init_cache(tm, 2)
    for name in ("k", "v"):
        cache[name].copy_(torch.from_numpy(rng.randn(*cache[name].shape).astype(np.float32)))
    idx = torch.tensor([s + 8, 6], dtype=torch.int32)
    tok = torch.tensor([[3], [5]], dtype=torch.int32)
    before = {k: v.clone() for k, v in cache.items()}
    want_cache = {k: v.clone() for k, v in before.items()}
    with torch.no_grad():
        # Positions past S have no embedding row: embed at a clamped
        # frontier, then run the layer stack at the real one.
        h = tm.embed(tok, pos_offset=idx.clamp_max(s - 1))
        got = decode_fused.fused_layers(h, tm.stage.blocks, cache, idx)
        want = ref.stage(h, cache=want_cache, idx=idx)
    assert torch.isfinite(got).all()
    _assert_close(got[1].numpy(), want[1].numpy(), "float32")
    for name in ("k", "v"):
        _assert_close(cache[name][:, 1].numpy(), want_cache[name][:, 1].numpy(), "float32")
        np.testing.assert_array_equal(cache[name][:, 0, : s - 1].numpy(),
                                      before[name][:, 0, : s - 1].numpy())
        # Layer 0's k/v come from the same input in both paths.
        _assert_close(cache[name][0, 0, s - 1].numpy(), want_cache[name][0, 0, s - 1].numpy(),
                      "float32")
        assert not torch.equal(cache[name][:, 0, s - 1], before[name][:, 0, s - 1])


def test_routing_rule_matches_jax():
    """``use_fused_layers``: the knob, a single token or a verify window of
    2..8, and no MoE; the tiny config fits JAX's VMEM gate, so the two
    rules agree on every case."""
    jm, _, tm = _pair("float32", "auto")
    for backend in ("fused_layers", "fused", "xla"):
        jcfg = dataclasses.replace(jm.cfg, decode_attention=backend)
        tcfg = dataclasses.replace(tm.cfg, decode_attention=backend)
        for t in range(1, 11):
            for verify in (False, True):
                assert decode_fused.use_fused_layers(tcfg, t, verify) == \
                    jdecode_fused.use_fused_layers(jcfg, t, verify), (backend, t, verify)
    assert decode_fused.SPEC_MAX_K == jdecode_fused._SPEC_MAX_K
    assert decode_fused.LN_EPS == jdecode_fused._LN_EPS
    assert not decode_fused.use_fused_layers(dataclasses.replace(tm.cfg, moe_experts=4), 1)


def test_prefill_keeps_the_per_layer_path():
    """A multi-token step without ``spec_verify`` is prefill: it runs the
    per-layer path, bit-equal to the ``xla`` backend's."""
    _, _, tm = _pair("float32", "auto")
    ref = GPT(dataclasses.replace(tm.cfg, decode_attention="xla"), device="cpu")
    ref.load_state_dict(tm.state_dict())
    prompt = torch.tensor([[1, 2, 3, 4, 5]], dtype=torch.int32)
    _, l1 = decode_step(tm, init_cache(tm, 1), prompt)
    _, l2 = decode_step(ref, init_cache(ref, 1), prompt)
    assert torch.equal(l1, l2)


def test_wrapper_counts_no_launch_on_the_cpu_and_checks_shapes():
    _, _, tm = _pair("float32", "auto")
    cache = init_cache(tm, 2)
    x = torch.zeros(2, 1, tm.cfg.d_model)
    before = decode_fused.launches
    decode_fused.fused_layers(x, tm.stage.blocks, cache, torch.tensor(0, dtype=torch.int32))
    assert decode_fused.launches == before
    with pytest.raises(ValueError, match="1..8"):
        decode_fused.fused_layers(torch.zeros(2, 9, tm.cfg.d_model), tm.stage.blocks, cache,
                                  torch.tensor(0, dtype=torch.int32))
    with pytest.raises(ValueError, match="cache"):
        decode_fused.fused_layers(torch.zeros(3, 1, tm.cfg.d_model), tm.stage.blocks, cache,
                                  torch.tensor(0, dtype=torch.int32))
    with pytest.raises(ValueError, match="device"):
        decode_fused.fused_layers(x.to("meta"), tm.stage.blocks, cache,
                                  torch.tensor(0, dtype=torch.int32))


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_generate_is_token_identical_to_jax(kv):
    """Greedy ``generate()`` under ``fused_layers`` (float32) emits JAX's
    ``generate()`` tokens under ``fused_layers``."""
    jm, params, tm = _pair("float32", kv)
    prompt = np.random.RandomState(5).randint(0, VOCAB, size=(2, 5)).astype(np.int32)
    want = np.asarray(jgenerate(jm, params, jnp.asarray(prompt), 10))
    got = generate(tm, prompt, 10)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_engine_is_token_identical_to_generate(kv):
    """The serving engine under ``fused_layers`` (per-slot frontiers,
    admissions mid-flight, a shared prefix) emits ``generate()``'s tokens
    for every request."""
    _, _, tm = _pair("float32", kv)
    rng = np.random.RandomState(6)
    prefix = rng.randint(0, VOCAB, size=6).tolist()
    prompts = [rng.randint(0, VOCAB, size=5).tolist(),
               prefix + rng.randint(0, VOCAB, size=3).tolist(),
               prefix + rng.randint(0, VOCAB, size=4).tolist(),
               rng.randint(0, VOCAB, size=8).tolist()]
    eng = ServingEngine(tm, ServeConfig(slots=2, page_size=4, queue_depth=8,
                                        max_new_tokens=6, prefill_bucket=8))
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=f"r{i}", prompt=p, max_new_tokens=6,
                           shared_prefix_len=6 if p[:6] == prefix else 0))
    res = eng.run(max_steps=300)
    for i, p in enumerate(prompts):
        assert res[f"r{i}"].state is RequestState.DONE
        assert res[f"r{i}"].tokens == generate(tm, [p], 6)[0].tolist(), f"r{i}"


# --- the LoRA sites ---------------------------------------------------------

from dtc_tpu.adapters import gather_slot_lora as jgather_slot_lora  # noqa: E402
from dtc_tpu.adapters import init_lora as jinit_lora  # noqa: E402
from dtc_tpu.adapters import init_lora_stack as jinit_lora_stack  # noqa: E402
from dtc_tpu.config.schema import AdapterConfig as JAdapterConfig  # noqa: E402
from dtc_tpu_torch.adapters import init_lora_stack  # noqa: E402
from dtc_tpu_torch.config.schema import AdapterConfig  # noqa: E402
from dtc_tpu_torch.parity import lora_from_flax  # noqa: E402

_LORA_PAIRS = {}


def _lora_pair(compute, kv, rank=6, alpha=16.0):
    """The JAX and port models with adapters (all six sites; 16 / 6 is a
    scale bf16 cannot hold) and a stack of three slots: 0 base, 1 and 2
    random tenants, in each layout (cached)."""
    key = (compute, kv, rank, alpha)
    if key not in _LORA_PAIRS:
        kw = dict(TINY, compute_dtype=compute, kv_cache_dtype=kv)
        jm = JGPT(JCfg(**kw, adapter=JAdapterConfig(rank=rank, alpha=alpha)))
        params = jm.init(
            {"params": jax.random.PRNGKey(0)}, jnp.ones((1, 1), jnp.int32), train=False
        )["params"]
        tm = GPT(ModelConfig(**kw, adapter=AdapterConfig(rank=rank, alpha=alpha)), device="cpu")
        tm.load_state_dict(from_flax(jax.tree.map(np.asarray, params), tm.cfg))
        leaves, td = jax.tree.flatten(jinit_lora(jm, 0))
        jstack = jinit_lora_stack(jm, 3)
        tstack = init_lora_stack(tm, 3)
        for slot in (1, 2):
            rng = np.random.RandomState(30 + slot)
            fac = jax.tree.unflatten(td, [
                (0.3 * rng.randn(*l.shape) / np.sqrt(l.shape[-2])).astype(np.float32)
                for l in leaves])
            jstack = jax.tree.map(lambda st, f: st.at[slot].set(f), jstack, fac)
            for k, v in lora_from_flax(fac).items():
                tstack[k][slot].copy_(v)
        _LORA_PAIRS[key] = (jm, params, tm, jstack, tstack)
    return _LORA_PAIRS[key]


# (compute dtype, KV dtype, window t, frontier, per-row slot ids)
_LORA_CASES = [
    ("float32", "auto", 1, [5, 31, 0], [2, 0, 1]),
    ("float32", "auto", 4, 20, [1, 1, 0]),
    ("float32", "int8", 4, [28, 3, 9], [0, 2, 1]),
    ("bfloat16", "auto", 1, [5, 17, 30], [2, 0, 1]),
    ("bfloat16", "auto", 4, [0, 12, 28], [1, 2, 0]),
    ("bfloat16", "int8", 1, 9, [2, 1, 0]),
]


@pytest.mark.parametrize("compute,kv,t,start,ids", _LORA_CASES)
def test_fused_step_with_lora_matches_jax_megakernel(compute, kv, t, start, ids):
    """The megakernel step with per-row adapter slots (base among them)
    against JAX's ``fused_decode_step(..., lora=gather_slot_lora(stack,
    ids))`` in interpret mode: logits and every cache entry, within the
    limits of the adapter-free cases."""
    jm, params, tm, jstack, tstack = _lora_pair(compute, kv)
    b = 3
    rng = np.random.RandomState(t * 7 + ids[0])
    jc, tc = _filled_caches(jm, tm, b, rng)
    idx = np.asarray(start, np.int32)
    jc["index"] = jnp.asarray(idx)
    tc["index"] = torch.from_numpy(idx.copy())
    tok = rng.randint(0, VOCAB, size=(b, t)).astype(np.int32)
    jids = jnp.asarray(ids, jnp.int32)
    jc2, jl = jdecode_step(jm, params, jc, jnp.asarray(tok), lora=jgather_slot_lora(jstack, jids),
                           spec_verify=t > 1)
    tc2, tl = decode_step(tm, tc, torch.from_numpy(tok), spec_verify=t > 1, lora=tstack,
                          lora_ids=torch.tensor(ids, dtype=torch.int32))
    jl = np.asarray(jl.astype(jnp.float32))
    tl = tl.float().numpy()
    _assert_close(tl[..., :VOCAB], jl[..., :VOCAB], compute)
    h, d = tm.cfg.n_heads, tm.cfg.head_dim
    for name in ("k", "v"):
        if kv == "int8":
            got = tc2[name].float() * tc2[f"{name}_scale"].repeat_interleave(d, dim=-1)
            want = _jax_kv(jc2, name) * np.repeat(_jax_kv(jc2, f"{name}_scale"), d, axis=-1)
            _assert_close(got.numpy(), want, compute, heads=h)
        else:
            _assert_close(tc2[name].float().numpy(), _jax_kv(jc2, name), compute, heads=h)
    # The adapters move the tenants' rows well past the limit.
    _, base = jdecode_step(jm, params, jc, jnp.asarray(tok), spec_verify=t > 1)
    moved = np.abs(np.asarray(base.astype(jnp.float32)) - jl).max(axis=(1, 2))
    for row, slot in enumerate(ids):
        assert (moved[row] > 0.05) == (slot != 0), (row, slot, moved)


@pytest.mark.parametrize("t", [1, 4])
def test_plain_version_with_lora_matches_per_layer_path(t):
    """float32: the megakernel's plain version with per-row slots against
    the port's per-layer path (``fused`` at t 1, the multi-token append at
    t 4) with the same stack and ids, and against a shared adapter."""
    _, _, tm, _, stack = _lora_pair("float32", "auto")
    ref = GPT(dataclasses.replace(tm.cfg, decode_attention="fused"), device="cpu")
    ref.load_state_dict(tm.state_dict())
    rng = np.random.RandomState(8)
    b = 3
    prompt = torch.from_numpy(rng.randint(0, VOCAB, size=(b, 9)).astype(np.int32))
    cache, _ = decode_step(tm, init_cache(tm, b), prompt)
    cache["index"] = torch.tensor([9, 4, 1], dtype=torch.int32)
    tok = torch.from_numpy(rng.randint(0, VOCAB, size=(b, t)).astype(np.int32))
    ids = torch.tensor([1, 0, 2], dtype=torch.int32)
    shared = {k: v[2] for k, v in stack.items()}
    for lora, lora_ids in ((stack, ids), (shared, None)):
        before = {k: v.clone() for k, v in cache.items()}
        _, l1 = decode_fused.fused_decode_step(tm, dict(before), tok, lora, lora_ids)
        _, l2 = decode_step(ref, dict(before), tok, lora=lora, lora_ids=lora_ids)
        _assert_close(l1[..., :VOCAB].numpy(), l2[..., :VOCAB].numpy(), "float32")


def test_wrapper_checks_lora_factors():
    _, _, tm, _, stack = _lora_pair("float32", "auto")
    cache = init_cache(tm, 2)
    x = torch.zeros(2, 1, tm.cfg.d_model)
    idx = torch.tensor(0, dtype=torch.int32)
    ids = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="lora_ids"):
        decode_fused.fused_layers(x, tm.stage.blocks, cache, idx, stack, ids[:1])
    with pytest.raises(ValueError, match="without lora"):
        decode_fused.fused_layers(x, tm.stage.blocks, cache, idx, None, ids)
    with pytest.raises(ValueError, match="q_proj_a"):
        decode_fused.fused_layers(x, tm.stage.blocks, cache, idx,
                                  dict(stack, q_proj_a=stack["q_proj_a"][..., :8]), ids)
    with pytest.raises(ValueError, match="pair"):
        decode_fused.fused_layers(x, tm.stage.blocks, cache, idx,
                                  {k: v for k, v in stack.items() if k != "fc2_b"}, ids)
    _, _, plain = _pair("float32", "auto")
    with pytest.raises(ValueError, match="rank == 0"):
        decode_fused.fused_layers(x, plain.stage.blocks, cache, idx, stack, ids)
