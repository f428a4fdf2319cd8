"""The port's serving engine with multi-tenant LoRA adapters on the CPU,
mirroring ``tests/test_adapters.py``'s serving leg.

The anchor invariant: a batch that mixes tenants (and base requests) is a
pure reordering of single-stream decode under each request's adapter, so
every completed request's tokens equal ``generate()`` with its tenant's
factors (float32), under ``fused`` and ``fused_layers``; and, with the
flax weights and factors carried across, the JAX engine's tokens.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dtc_tpu.adapters import init_lora as jinit_lora
from dtc_tpu.adapters import save_adapter as jsave_adapter
from dtc_tpu.config.schema import AdapterConfig as JAdapterConfig
from dtc_tpu.config.schema import ModelConfig as JCfg
from dtc_tpu.config.schema import ServeConfig as JServeConfig
from dtc_tpu.models.gpt import GPT as JGPT
from dtc_tpu.serve import Request as JRequest
from dtc_tpu.serve import ServingEngine as JServingEngine
from dtc_tpu_torch.adapters import load_adapter_file
from dtc_tpu_torch.config.schema import AdapterConfig, ModelConfig, ServeConfig, SpecConfig
from dtc_tpu_torch.generate import generate
from dtc_tpu_torch.models.gpt import GPT
from dtc_tpu_torch.parity import from_flax, lora_from_flax
from dtc_tpu_torch.serve import (
    AdapterStoreFullError,
    Request,
    RequestState,
    ServingEngine,
    UnknownAdapterError,
)
from tests.test_torch_train import _one_thread  # noqa: F401  (autouse: one intra-op thread)


VOCAB = 97
TINY = dict(vocab_size=VOCAB, d_model=64, n_layers=4, n_heads=4, d_ff=128, max_seq_len=32,
            dropout=0.0, param_dtype="float32", compute_dtype="float32", attention="dense")


@pytest.fixture(scope="module")
def setup():
    """JAX and port models with adapters (rank 6, alpha 16), the same base
    weights, and two random tenants in each layout."""
    jcfg = JCfg(**TINY, adapter=JAdapterConfig(rank=6, alpha=16.0))
    jm = JGPT(jcfg)
    params = jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.ones((1, 1), jnp.int32), train=False
    )["params"]
    leaves, td = jax.tree.flatten(jinit_lora(jm, 0))
    jl = []
    for seed in (11, 22):
        rng = np.random.RandomState(seed)
        jl.append(jax.tree.unflatten(td, [
            (0.3 * rng.randn(*l.shape) / np.sqrt(l.shape[-2])).astype(np.float32)
            for l in leaves]))
    models = {}
    for backend in ("fused", "fused_layers"):
        tm = GPT(ModelConfig(**TINY, decode_attention=backend,
                             adapter=AdapterConfig(rank=6, alpha=16.0)), device="cpu")
        tm.load_state_dict(from_flax(jax.tree.map(np.asarray, params), tm.cfg))
        models[backend] = tm
    return dict(jm=jm, params=params, jl=jl, models=models,
                lA=lora_from_flax(jl[0]), lB=lora_from_flax(jl[1]))


def _engine(model, **kw):
    cfg = dict(slots=3, page_size=4, queue_depth=8, max_new_tokens=6, prefill_bucket=8,
               max_adapters=4)
    cfg.update(kw)
    return ServingEngine(model, ServeConfig(**cfg))


def _prompts(seed, sizes):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, size=n).tolist() for n in sizes]


def _ref(model, prompt, n, lora):
    return generate(model, [prompt], n, lora=lora)[0].tolist()


@pytest.mark.parametrize("backend", ["fused", "fused_layers"])
def test_mixed_tenants_are_token_identical_to_generate(setup, backend):
    """Two tenants and base requests in one in-flight batch, more requests
    than slots: each finishes with generate()'s tokens under its adapter."""
    tm = setup["models"][backend]
    prompts = _prompts(4, (5, 7, 6, 4, 8))
    ads = ("tA", "tB", None, "tA", "tB")
    lora = {"tA": setup["lA"], "tB": setup["lB"], None: None}
    eng = _engine(tm)
    assert eng.load_adapter("tA", setup["lA"]) == 1
    assert eng.load_adapter("tB", setup["lB"]) == 2
    for i, (p, ad) in enumerate(zip(prompts, ads)):
        eng.submit(Request(rid=f"r{i}", prompt=p, max_new_tokens=6, adapter=ad))
    res = eng.run(max_steps=200)
    changed = 0
    for i, (p, ad) in enumerate(zip(prompts, ads)):
        assert res[f"r{i}"].state is RequestState.DONE
        assert res[f"r{i}"].adapter == ad
        assert res[f"r{i}"].tokens == _ref(tm, p, 6, lora[ad]), f"r{i}"
        changed += ad is not None and res[f"r{i}"].tokens != _ref(tm, p, 6, None)
    assert changed >= 2
    assert eng.counters["adapter_loads"] == 2
    assert eng.adapter_store.snapshot()["refcounts"] == {}
    assert eng.slot_adapter.tolist() == [0, 0, 0]


def test_engine_matches_the_jax_engine(setup):
    """float32, the same weights and factors: the port's engine emits the
    JAX engine's tokens for a mixed-tenant batch."""
    tm = setup["models"]["fused"]
    jcfg = dataclasses.replace(setup["jm"].cfg, decode_attention="xla")
    jm = JGPT(jcfg)
    scfg = dict(slots=2, page_size=4, queue_depth=8, max_new_tokens=5, prefill_bucket=8,
                max_adapters=3)
    jeng = JServingEngine(jm, setup["params"], JServeConfig(**scfg))
    teng = ServingEngine(tm, ServeConfig(**scfg))
    for name, jf, tf in (("tA", setup["jl"][0], setup["lA"]), ("tB", setup["jl"][1], setup["lB"])):
        jeng.load_adapter(name, jf)
        teng.load_adapter(name, tf)
    prompts = _prompts(5, (6, 4, 7))
    for i, (p, ad) in enumerate(zip(prompts, ("tB", None, "tA"))):
        jeng.submit(JRequest(rid=f"r{i}", prompt=p, max_new_tokens=5, adapter=ad))
        teng.submit(Request(rid=f"r{i}", prompt=p, max_new_tokens=5, adapter=ad))
    jres, tres = jeng.run(max_steps=100), teng.run(max_steps=100)
    for i in range(3):
        assert tres[f"r{i}"].tokens == jres[f"r{i}"].tokens, i


def test_unknown_adapter_and_full_store_are_typed(setup):
    tm = setup["models"]["fused_layers"]
    eng = _engine(tm, max_adapters=2)  # base + ONE tenant slot
    with pytest.raises(UnknownAdapterError):
        eng.submit(Request(rid="x", prompt=[1, 2], max_new_tokens=2, adapter="ghost"))
    assert eng.counters["serve_rejected"] == 1
    eng.load_adapter("tA", setup["lA"])
    eng.submit(Request(rid="a", prompt=[1, 2, 3], max_new_tokens=6, adapter="tA"))
    with pytest.raises(AdapterStoreFullError):
        eng.load_adapter("tB", setup["lB"])
    eng.run(max_steps=100)
    # Terminal => unpinned => the LRU tenant is evicted for the new one.
    assert eng.load_adapter("tB", setup["lB"]) == 1
    assert eng.adapter_store.slot_of("tA") is None
    assert eng.counters["adapter_evictions"] == 1
    with pytest.raises(ValueError, match="do not match"):
        eng.load_adapter("tC", {k: v for k, v in setup["lA"].items() if k != "q_proj_a"})
    plain = GPT(ModelConfig(**TINY), device="cpu")
    plain_eng = _engine(plain, slots=1)
    with pytest.raises(UnknownAdapterError, match="rank == 0"):
        plain_eng.submit(Request(rid="y", prompt=[1], max_new_tokens=2, adapter="tA"))
    with pytest.raises(ValueError, match="lora-free"):
        plain_eng.load_adapter("tA", setup["lA"])


def test_prefix_store_is_scoped_per_adapter(setup):
    """One shared prefix under two tenants builds two entries; each tenant's
    second request hits its own; the tokens stay per-tenant exact."""
    tm = setup["models"]["fused_layers"]
    rng = np.random.RandomState(9)
    prefix = rng.randint(0, VOCAB, size=6).tolist()
    tails = [rng.randint(0, VOCAB, size=3).tolist() for _ in range(4)]
    eng = _engine(tm, slots=2)
    eng.load_adapter("tA", setup["lA"])
    eng.load_adapter("tB", setup["lB"])
    ads = ("tA", "tA", "tB", "tB")
    for i, (tail, ad) in enumerate(zip(tails, ads)):
        eng.submit(Request(rid=f"r{i}", prompt=prefix + tail, max_new_tokens=4, adapter=ad,
                           shared_prefix_len=len(prefix)))
    res = eng.run(max_steps=300)
    assert eng.counters["serve_prefix_builds"] == 2
    assert eng.counters["serve_prefix_hits"] == 2
    lora = {"tA": setup["lA"], "tB": setup["lB"]}
    for i, (tail, ad) in enumerate(zip(tails, ads)):
        assert res[f"r{i}"].tokens == _ref(tm, prefix + tail, 4, lora[ad]), i


def test_reload_drops_stale_prefix_kv_and_hot_update_in_flight_is_refused(setup):
    tm = setup["models"]["fused"]
    rng = np.random.RandomState(13)
    prefix = rng.randint(0, VOCAB, size=6).tolist()
    tail = rng.randint(0, VOCAB, size=3).tolist()
    eng = _engine(tm, slots=2)
    eng.load_adapter("t", setup["lA"])
    eng.submit(Request(rid="r1", prompt=prefix + tail, max_new_tokens=4, adapter="t",
                       shared_prefix_len=len(prefix)))
    eng.run(max_steps=100)
    eng.load_adapter("t", setup["lB"])  # hot update lA -> lB
    eng.submit(Request(rid="r2", prompt=prefix + tail, max_new_tokens=4, adapter="t",
                       shared_prefix_len=len(prefix)))
    res = eng.run(max_steps=100)
    assert res["r2"].tokens == _ref(tm, prefix + tail, 4, setup["lB"])
    assert eng.counters["serve_prefix_builds"] == 2  # rebuilt after the reload
    eng.submit(Request(rid="r3", prompt=prefix + tail, max_new_tokens=6, adapter="t",
                       shared_prefix_len=len(prefix)))
    with pytest.raises(ValueError, match="in-flight"):
        eng.load_adapter("t", setup["lA"])
    eng.run(max_steps=100)
    # Store-LRU eviction of "t" drops its prefix entry and returns its pages.
    for name in ("u1", "u2", "u3"):
        eng.load_adapter(name, setup["lA"])
    assert eng.adapter_store.slot_of("t") is None
    assert not [k for k in eng._prefix_store if k[0] == "t"]
    assert eng.alloc.snapshot()["prefix_pages"] == 0


def test_eviction_and_reprefill_under_an_adapter_are_bit_exact(setup):
    """A binding page pool evicts mid-decode; the victim re-prefills prompt
    + generated under its own adapter and still ends with generate()'s
    tokens."""
    tm = setup["models"]["fused_layers"]
    prompts = _prompts(6, (9, 10, 8, 11))
    ads = ("tA", "tB", None, "tA")
    eng = _engine(tm, slots=2, total_pages=7, max_new_tokens=8)
    eng.load_adapter("tA", setup["lA"])
    eng.load_adapter("tB", setup["lB"])
    for i, (p, ad) in enumerate(zip(prompts, ads)):
        eng.submit(Request(rid=f"c{i}", prompt=p, max_new_tokens=8, adapter=ad,
                           priority=i % 2))
    res = eng.run(max_steps=400)
    assert eng.counters["serve_evictions"] > 0
    lora = {"tA": setup["lA"], "tB": setup["lB"], None: None}
    for i, (p, ad) in enumerate(zip(prompts, ads)):
        assert res[f"c{i}"].state is RequestState.DONE
        assert res[f"c{i}"].tokens == _ref(tm, p, 8, lora[ad]), i


def test_jax_artifact_serves_in_the_port(setup, tmp_path):
    """An adapter exported by the JAX package's ``save_adapter`` loads with
    the engine's stack as ``like`` and serves its tenant's tokens."""
    tm = setup["models"]["fused_layers"]
    path = str(tmp_path / "tA.npz")
    jsave_adapter(path, setup["jl"][0], {"rank": 6, "alpha": 16.0})
    eng = _engine(tm, slots=1)
    fac, meta = load_adapter_file(path, like=eng.lora_stack)
    assert meta["rank"] == 6
    eng.load_adapter("tA", fac)
    p = _prompts(7, (5,))[0]
    eng.submit(Request(rid="a", prompt=p, max_new_tokens=6, adapter="tA"))
    assert eng.run(max_steps=50)["a"].tokens == _ref(tm, p, 6, setup["lA"])


def test_speculation_with_adapters_is_refused(setup):
    tm = setup["models"]["fused_layers"]
    with pytest.raises(ValueError, match="adapters"):
        ServingEngine(tm, ServeConfig(slots=2, spec=SpecConfig(spec_k=4, draft_layers=2)))


def test_adapter_admission_changes_values_not_pointers(setup):
    """Loading tenants and admitting their requests writes the resident
    stack and the slots' ids in place: the tensors the decode step reads
    keep their shapes and addresses (a captured graph would stay valid)."""
    tm = setup["models"]["fused_layers"]
    eng = _engine(tm, slots=2)
    ptrs = {k: (v.data_ptr(), tuple(v.shape)) for k, v in eng.lora_stack.items()}
    ids_ptr = eng.slot_adapter.data_ptr()
    eng.load_adapter("tA", setup["lA"])
    eng.submit(Request(rid="a", prompt=[1, 2, 3], max_new_tokens=4, adapter="tA"))
    eng.step()
    assert eng.slot_adapter.tolist() == [1, 0]
    eng.load_adapter("tB", setup["lB"])
    eng.submit(Request(rid="b", prompt=[4, 5], max_new_tokens=4, adapter="tB"))
    eng.run(max_steps=50)
    assert {k: (v.data_ptr(), tuple(v.shape)) for k, v in eng.lora_stack.items()} == ptrs
    assert eng.slot_adapter.data_ptr() == ids_ptr
    assert torch.equal(eng.lora_stack["fc1_b"][2], setup["lB"]["fc1_b"])
    assert not eng.lora_stack["fc1_b"][0].any()
