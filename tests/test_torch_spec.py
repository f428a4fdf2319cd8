"""The port's speculative decoding (``dtc_tpu_torch.spec``) and the serving
engine's speculative iteration, on the CPU, against the JAX package's
``dtc_tpu.spec`` and against the port's own plain greedy decode.

The tiny model is the JAX spec tests' (d 64, 4 layers, 4 heads, S 64,
vocab 97, ``fused_layers``), its flax weights carried across with
``parity.from_flax``. Greedy speculation must be token-identical to
plain greedy decode: the draft changes how many tokens a verify launch
yields, never which. The JAX engine's eviction test fails on the
reference itself, so the port's eviction under speculation is held
against the port's ``generate()`` instead.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dtc_tpu.config.schema import AdapterConfig as JAdapterConfig
from dtc_tpu.config.schema import ModelConfig as JCfg
from dtc_tpu.models.gpt import GPT as JGPT
from dtc_tpu.spec import draft_config as jdraft_config
from dtc_tpu.spec import extract_draft as jextract_draft
from dtc_tpu.spec import spec_generate as jspec_generate
from dtc_tpu_torch.config.schema import AdapterConfig, ModelConfig, ServeConfig, SpecConfig
from dtc_tpu_torch.generate import generate
from dtc_tpu_torch.models.gpt import GPT
from dtc_tpu_torch.parity import from_flax
from dtc_tpu_torch.serve import Request, RequestState, RequestTooLargeError, ServingEngine
from dtc_tpu_torch.spec import (
    check_spec_backend,
    draft_config,
    extract_draft,
    spec_generate,
    spec_round,
)
from dtc_tpu_torch.spec.core import _accept_sampled
from tests.test_torch_train import _one_thread  # noqa: F401  (autouse: one intra-op thread)

VOCAB = 97
TINY = dict(vocab_size=VOCAB, d_model=64, n_layers=4, n_heads=4, d_ff=128,
            max_seq_len=64, dropout=0.0, compute_dtype="float32",
            decode_attention="fused_layers")


@pytest.fixture(scope="module")
def spec_pair():
    """The JAX spec tests' tiny fused_layers GPT and its port."""
    jm = JGPT(JCfg(**TINY))
    params = jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.ones((1, 1), jnp.int32), train=False
    )["params"]
    tm = GPT(ModelConfig(**TINY), device="cpu")
    tm.load_state_dict(from_flax(jax.tree.map(np.asarray, params), tm.cfg))
    return jm, params, tm


def _prompts(seed, sizes):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, size=n).tolist() for n in sizes]


def _refs(model, prompts, n):
    return [generate(model, [p], n)[0].tolist() for p in prompts]


def _serve_cfg(**kw):
    kw.setdefault("slots", 2)
    kw.setdefault("page_size", 4)
    kw.setdefault("queue_depth", 8)
    kw.setdefault("max_new_tokens", 10)
    kw.setdefault("prefill_bucket", 8)
    kw.setdefault("spec", SpecConfig(spec_k=2, draft_layers=2))
    return ServeConfig(**kw)


# -- the draft ---------------------------------------------------------------

def test_draft_config_matches_jax_bounds_and_turns_adapters_off():
    cfg = ModelConfig(**dict(TINY, adapter=AdapterConfig(rank=4)))
    jcfg = JCfg(**dict(TINY, adapter=JAdapterConfig(rank=4)))
    for bad in (0, 4, 5, -1):
        with pytest.raises(ValueError, match="draft_layers"):
            draft_config(cfg, bad)
        with pytest.raises(ValueError, match="draft_layers"):
            jdraft_config(jcfg, bad)
    d, jd = draft_config(cfg, 2), jdraft_config(jcfg, 2)
    assert d.n_layers == jd.n_layers == 2 and d.adapter.rank == jd.adapter.rank == 0
    assert d.max_seq_len == cfg.max_seq_len and d.decode_attention == cfg.decode_attention


def test_extract_draft_is_zero_copy(spec_pair):
    """The draft's embed, head and first blocks ARE the target's modules:
    the same storage, nothing copied, no parameter drawn."""
    _, _, tm = spec_pair
    draft = extract_draft(tm, 2)
    assert draft.cfg.n_layers == 2 and len(draft.stage.blocks) == 2
    assert draft.embed is tm.embed and draft.head is tm.head
    for i in range(2):
        assert draft.stage.blocks[i] is tm.stage.blocks[i]
    target = {p.data_ptr() for p in tm.parameters()}
    assert all(p.data_ptr() in target for p in draft.parameters())
    n_block = sum(p.numel() for p in tm.stage.blocks[0].parameters())
    assert sum(p.numel() for p in draft.parameters()) == \
        sum(p.numel() for p in tm.parameters()) - 2 * n_block
    assert draft.device == tm.device


def test_extract_draft_refuses_moe_and_bad_depth(spec_pair):
    _, _, tm = spec_pair
    moe = SimpleNamespace(cfg=dataclasses.replace(tm.cfg, moe_experts=4, moe_top_k=2))
    with pytest.raises(ValueError, match="MoE"):
        extract_draft(moe, 1)
    for bad in (0, 4):
        with pytest.raises(ValueError, match="draft_layers"):
            extract_draft(tm, bad)


def test_draft_decodes_like_the_jax_draft(spec_pair):
    """The extracted rung is a plain GPT that generate() serves, emitting
    the JAX draft rung's tokens."""
    from dtc_tpu.generate import generate as jgenerate

    jm, params, tm = spec_pair
    jd, jdp = jextract_draft(jm, params, 2)
    prompt = np.asarray([[1, 2, 3]], np.int32)
    want = np.asarray(jgenerate(jd, jdp, jnp.asarray(prompt), 6))
    got = generate(extract_draft(tm, 2), prompt, 6)
    np.testing.assert_array_equal(got.numpy(), want)


# -- the backend gate ----------------------------------------------------------

def test_check_spec_backend_rejects_fused(spec_pair):
    _, _, tm = spec_pair
    check_spec_backend(tm.cfg)
    check_spec_backend(dataclasses.replace(tm.cfg, decode_attention="xla"))
    fused = dataclasses.replace(tm.cfg, decode_attention="fused")
    with pytest.raises(ValueError, match="token-identity"):
        check_spec_backend(fused)
    model = GPT(fused, device="cpu")
    with pytest.raises(ValueError, match="fused_layers"):
        spec_generate(model, extract_draft(model, 1), [[1, 2]], 4, spec_k=2)
    with pytest.raises(ValueError, match="fused_layers"):
        ServingEngine(model, _serve_cfg(slots=1))


# -- spec_generate ---------------------------------------------------------------

@pytest.mark.parametrize("spec_k", [2, 4])
def test_spec_generate_token_identical_to_generate_and_jax(spec_pair, spec_k):
    """Greedy speculation emits plain greedy decode's tokens, and JAX's
    ``spec_generate`` tokens on the same weights, with the same round
    count."""
    jm, params, tm = spec_pair
    draft = extract_draft(tm, 2)
    jd, jdp = jextract_draft(jm, params, 2)
    for p in _prompts(11, (5, 9)):
        ref = generate(tm, [p], 12)[0].tolist()
        out, stats = spec_generate(tm, draft, [p], 12, spec_k=spec_k, return_stats=True)
        assert out[0].tolist() == ref
        jout, jstats = jspec_generate(jm, params, jd, jdp, jnp.asarray([p], jnp.int32), 12,
                                      spec_k=spec_k, return_stats=True)
        assert np.asarray(jout)[0].tolist() == ref
        assert stats == jstats
        assert stats["proposed"] == stats["rounds"] * (spec_k - 1)


def test_spec_generate_batch_rows_accept_independently(spec_pair):
    _, _, tm = spec_pair
    batch = np.random.RandomState(5).randint(0, VOCAB, size=(3, 6)).astype(np.int32)
    out = spec_generate(tm, extract_draft(tm, 3), batch, 10, spec_k=3)
    np.testing.assert_array_equal(out.numpy(), generate(tm, batch, 10).numpy())


def test_spec_generate_deep_draft_accepts(spec_pair):
    _, _, tm = spec_pair
    _, stats = spec_generate(tm, extract_draft(tm, 3), [_prompts(2, (7,))[0]], 16,
                             spec_k=2, return_stats=True)
    assert stats["accepted"] > 0 and stats["rounds"] < 16


def test_spec_generate_validation(spec_pair):
    _, _, tm = spec_pair
    draft = extract_draft(tm, 2)
    p = [[1, 2, 3]]
    with pytest.raises(ValueError, match="spec_k"):
        spec_generate(tm, draft, p, 4, spec_k=1)
    with pytest.raises(ValueError, match="spec_k"):
        spec_generate(tm, draft, p, 4, spec_k=9)
    with pytest.raises(ValueError, match="max_seq_len"):
        spec_generate(tm, draft, p, 59, spec_k=4)  # 3 + 59 + 3 > 64
    spec_generate(tm, draft, p, 58, spec_k=4)
    with pytest.raises(ValueError, match="Generator"):
        spec_generate(tm, draft, p, 4, spec_k=2, temperature=0.7)


def test_spec_generate_sampled_runs_and_stays_in_vocab(spec_pair):
    _, _, tm = spec_pair
    gen = torch.Generator().manual_seed(3)
    out, stats = spec_generate(tm, extract_draft(tm, 2), [[4, 5, 6], [7, 8, 9]], 8,
                               gen, spec_k=3, temperature=0.8, return_stats=True)
    assert out.shape == (2, 8) and out.dtype == torch.int32
    assert ((out >= 0) & (out < VOCAB)).all()
    assert 0 <= stats["accepted"] <= stats["proposed"]
    again = spec_generate(tm, extract_draft(tm, 2), [[4, 5, 6], [7, 8, 9]], 8,
                          torch.Generator().manual_seed(3), spec_k=3, temperature=0.8)
    assert torch.equal(out, again)


# -- the Leviathan rule ------------------------------------------------------

def test_rejection_rule_recovers_target_distribution():
    """Proposals drawn from a wrong draft p, filtered against a target q,
    leave the first emitted token distributed as q (uniforms and
    proposals made with numpy, as in the JAX package's test)."""
    v, b = 5, 4096
    p = np.asarray([0.50, 0.20, 0.15, 0.10, 0.05])
    q = np.asarray([0.10, 0.10, 0.30, 0.25, 0.25])
    rng = np.random.RandomState(7)
    proposals = torch.from_numpy(rng.choice(v, size=(b, 1), p=p).astype(np.int32))
    p_probs = torch.from_numpy(np.broadcast_to(p, (b, 1, v)).astype(np.float32).copy())
    q_probs = torch.from_numpy(np.broadcast_to(q, (b, 2, v)).astype(np.float32).copy())
    u_acc = torch.from_numpy(rng.uniform(size=(b, 1)).astype(np.float32))
    u_res = torch.from_numpy(rng.uniform(size=(b,)).astype(np.float32))
    n_acc, t_extra = _accept_sampled(proposals, p_probs, q_probs, u_acc, u_res)
    first = torch.where(n_acc >= 1, proposals[:, 0], t_extra).numpy()
    emp = np.bincount(first, minlength=v) / b
    assert 0.5 * np.abs(emp - q).sum() < 0.03
    raw = np.bincount(proposals[:, 0].numpy(), minlength=v) / b
    assert 0.5 * np.abs(raw - q).sum() > 0.2


def test_rejection_rule_accepts_everything_when_draft_equals_target():
    v, b, km1 = 7, 2048, 3
    rng = np.random.RandomState(0)
    q = rng.dirichlet(np.ones(v))
    proposals = torch.from_numpy(rng.choice(v, size=(b, km1), p=q).astype(np.int32))
    p_probs = torch.from_numpy(np.broadcast_to(q, (b, km1, v)).astype(np.float32).copy())
    q_probs = torch.from_numpy(np.broadcast_to(q, (b, km1 + 1, v)).astype(np.float32).copy())
    u = torch.from_numpy(rng.uniform(size=(b, km1)).astype(np.float32))
    n_acc, _ = _accept_sampled(proposals, p_probs, q_probs, u,
                               torch.from_numpy(rng.uniform(size=(b,)).astype(np.float32)))
    assert int(n_acc.sum()) == b * km1


def test_residual_resample_inverts_the_cdf():
    """After a rejection the next token is the residual max(q - p, 0)'s
    inverse CDF at the uniform: u just above each cumulative step picks
    the next token."""
    q = torch.tensor([[[0.0, 0.5, 0.5], [0.2, 0.3, 0.5]]])
    p = torch.tensor([[[0.0, 1.0, 0.0]]])                 # residual = [0, 0, 1]
    proposals = torch.tensor([[1]], dtype=torch.int32)
    _, t = _accept_sampled(proposals, p, q, torch.tensor([[0.99]]), torch.tensor([0.3]))
    assert t.tolist() == [2]
    q_all = torch.tensor([[[0.0, 1.0, 0.0], [0.2, 0.3, 0.5]]])  # accepted: bonus from q[1]
    for u, want in ((0.9, 0), (0.7, 1), (0.1, 2)):
        n, t = _accept_sampled(proposals, p, q_all, torch.tensor([[0.5]]), torch.tensor([u]))
        assert n.tolist() == [1] and t.tolist() == [want]


# -- the round -----------------------------------------------------------------

def test_spec_round_rolls_back_with_a_new_index_and_repeats_bit_exactly(spec_pair):
    """The round's rollback is a new index tensor; the input caches'
    index is never edited, and a round re-run from them rewrites the same
    positions with the same values (the engine's retry)."""
    _, _, tm = spec_pair
    draft = extract_draft(tm, 2)
    from dtc_tpu_torch.generate import decode_step, init_cache

    prompt = torch.tensor([[5, 6, 7, 8]], dtype=torch.int32)
    tc, logits = decode_step(tm, init_cache(tm, 1), prompt)
    dc, _ = decode_step(draft, init_cache(draft, 1), prompt)
    vec = torch.tensor([4], dtype=torch.int32)
    tc["index"], dc = vec, dict(dc, index=vec.clone())
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    idx_t, idx_d = tc["index"], dc["index"]
    outs = []
    for _ in range(2):
        t2, d2, nxt, emit, n_emit, fin = spec_round(tm, draft, 4, tc, dc, tok,
                                                    torch.tensor([10]))
        assert tc["index"] is idx_t and dc["index"] is idx_d and int(idx_t) == 4
        assert t2["index"] is not idx_t and int(t2["index"]) == 4 + int(n_emit)
        outs.append((emit.clone(), n_emit.clone(), tc["k"].clone(), dc["k"].clone()))
        assert bool(fin.all())
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# -- the engine with speculation ---------------------------------------------------

def test_engine_spec_token_identity_and_counters(spec_pair):
    _, _, tm = spec_pair
    prompts = _prompts(4, (6, 8, 5, 7))
    refs = _refs(tm, prompts, 10)
    eng = ServingEngine(tm, _serve_cfg(spec=SpecConfig(spec_k=4, draft_layers=3)))
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=f"r{i}", prompt=p, max_new_tokens=10))
    res = eng.run(max_steps=400)
    for i in range(len(prompts)):
        assert res[f"r{i}"].state is RequestState.DONE
        assert res[f"r{i}"].tokens == refs[i], f"r{i}"
        assert res[f"r{i}"].n_spec_proposed > 0 and res[f"r{i}"].accept_rate is not None
    c = eng.counters
    assert c["serve_spec_rounds"] >= 1
    assert c["serve_spec_proposed"] == c["serve_spec_accepted"] + c["serve_spec_rejected"]
    assert c["serve_spec_proposed"] == sum(r.n_spec_proposed for r in res.values())
    assert eng.alloc.free_pages == eng.alloc.total_pages


def test_engine_spec_saves_decode_iterations(spec_pair):
    _, _, tm = spec_pair
    prompts = _prompts(9, (6, 7))

    def runs(spec):
        eng = ServingEngine(tm, _serve_cfg(max_new_tokens=12, spec=spec))
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=f"r{i}", prompt=p, max_new_tokens=12))
        res = eng.run(max_steps=400)
        assert all(r.state is RequestState.DONE for r in res.values())
        return eng.counters["serve_decode_steps"], res

    plain_steps, plain = runs(SpecConfig())
    spec_steps, spec = runs(SpecConfig(spec_k=2, draft_layers=3))
    for rid in plain:
        assert spec[rid].tokens == plain[rid].tokens
    assert spec_steps < plain_steps


def test_engine_spec_headroom_and_draft_surcharge_admission(spec_pair):
    _, _, tm = spec_pair
    eng = ServingEngine(tm, _serve_cfg(spec=SpecConfig(spec_k=4, draft_layers=2),
                                       max_new_tokens=12))
    with pytest.raises(RequestTooLargeError, match="spec"):
        eng.submit(Request(rid="big", prompt=[1] * 50, max_new_tokens=12))
    eng.submit(Request(rid="ok", prompt=[1] * 49, max_new_tokens=12))
    # 6 pages of 4 hold the target's 17 peak tokens (5 pages) but not the
    # draft's ceil(5 * 2 / 4) = 3 more.
    eng2 = ServingEngine(tm, _serve_cfg(slots=1, total_pages=6, max_new_tokens=10,
                                        spec=SpecConfig(spec_k=2, draft_layers=2)))
    with pytest.raises(RequestTooLargeError, match="draft"):
        eng2.submit(Request(rid="r", prompt=[1] * 6, max_new_tokens=10))


def test_engine_spec_eviction_matches_generate(spec_pair):
    """Pool pressure evicts requests between speculative rounds; each is
    re-admitted (both caches re-prefilled over prompt + generated tokens)
    and still emits the port's generate() tokens."""
    _, _, tm = spec_pair
    prompts = _prompts(1, (6, 8, 5, 7))
    refs = _refs(tm, prompts, 10)
    eng = ServingEngine(tm, _serve_cfg(slots=3, total_pages=14,
                                       spec=SpecConfig(spec_k=2, draft_layers=2)))
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=f"r{i}", prompt=p, max_new_tokens=10))
    res = eng.run(max_steps=500)
    assert sum(r.n_evictions for r in res.values()) > 0
    for i in range(4):
        assert res[f"r{i}"].state is RequestState.DONE
        assert res[f"r{i}"].tokens == refs[i], f"r{i}"
    assert eng.alloc.free_pages == eng.alloc.total_pages


def test_engine_spec_eos_mid_window_truncates(spec_pair):
    _, _, tm = spec_pair
    p = _prompts(6, (5,))[0]
    ref = _refs(tm, [p], 10)[0]
    eos = ref[3]
    eng = ServingEngine(tm, _serve_cfg(spec=SpecConfig(spec_k=4, draft_layers=3)))
    eng.submit(Request(rid="r", prompt=p, max_new_tokens=10, eos_id=eos))
    res = eng.run(max_steps=200)
    assert res["r"].state is RequestState.DONE
    assert res["r"].tokens == ref[: ref.index(eos) + 1]


def test_engine_spec_retried_round_is_bit_exact(spec_pair, monkeypatch):
    """A verify whose logits read non-finite is retried from the
    pre-round caches; the retry rewrites the same positions, and every
    request still emits generate()'s tokens."""
    from dtc_tpu_torch.serve import engine as engine_mod

    _, _, tm = spec_pair
    prompts = _prompts(8, (6, 9))
    refs = _refs(tm, prompts, 8)
    real = engine_mod.spec_round
    calls = {"n": 0}

    def flaky(*args, **kw):
        out = real(*args, **kw)
        calls["n"] += 1
        if calls["n"] == 3:  # poison the third round's first attempt
            fin = torch.zeros_like(out[5])
            return out[:5] + (fin,)
        return out

    monkeypatch.setattr(engine_mod, "spec_round", flaky)
    eng = ServingEngine(tm, _serve_cfg(max_new_tokens=8,
                                       spec=SpecConfig(spec_k=4, draft_layers=2)))
    eng.sleep = lambda s: None
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=f"r{i}", prompt=p, max_new_tokens=8))
    res = eng.run(max_steps=200)
    assert calls["n"] > 3
    assert eng.counters["serve_retries"] >= 1
    for i in range(2):
        assert res[f"r{i}"].state is RequestState.DONE
        assert res[f"r{i}"].tokens == refs[i], f"r{i}"


def test_engine_spec_poisoned_row_fails_alone(spec_pair, monkeypatch):
    """Retries exhausted on one slot's non-finite verify: that request
    fails; the other finishes with generate()'s tokens."""
    from dtc_tpu_torch.serve import engine as engine_mod

    _, _, tm = spec_pair
    prompts = _prompts(12, (6, 9))
    refs = _refs(tm, prompts, 8)
    real = engine_mod.spec_round
    state = {"n": 0}

    def poison_slot0(*args, **kw):
        out = real(*args, **kw)
        state["n"] += 1
        if state["n"] >= 2:
            fin = out[5].clone()
            fin[0] = False
            return out[:5] + (fin,)
        return out

    monkeypatch.setattr(engine_mod, "spec_round", poison_slot0)
    eng = ServingEngine(tm, _serve_cfg(max_new_tokens=8,
                                       spec=SpecConfig(spec_k=2, draft_layers=2)))
    eng.sleep = lambda s: None
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=f"r{i}", prompt=p, max_new_tokens=8))
    res = eng.run(max_steps=200)
    states = {rid: r.state for rid, r in res.items()}
    assert sorted(s.value for s in states.values()) == ["done", "failed"]
    done = [i for i in range(2) if res[f"r{i}"].state is RequestState.DONE]
    for i in done:
        assert res[f"r{i}"].tokens == refs[i]


def test_engine_spec_refuses_adapters(spec_pair):
    _, _, tm = spec_pair
    model = SimpleNamespace(cfg=dataclasses.replace(tm.cfg, adapter=AdapterConfig(rank=4)),
                            device=torch.device("cpu"))
    with pytest.raises(ValueError, match="adapter"):
        ServingEngine(model, _serve_cfg(slots=1))

