"""The serving engine's telemetry, SLO degrade, chaos and graceful shutdown
in the port, mirroring the JAX engine's tests (``tests/test_serve.py``,
``tests/test_trace.py``, ``tests/test_spec.py``, ``tests/test_router.py``;
each test names the one it follows) on the CPU.

The anchor is the chaos acceptance run: preemption, a corrupted KV page,
poisoned logits and a doomed deadline in one multi-request serve give the
clean run's tokens, and the JAX engine's tokens, registry counters and
event list (times left out) on the same weights (``parity.from_flax``).
The JAX engine's run is shared through one fixture, once a session under
a file lock.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dtc_tpu.analysis.lowering import audit_model_cfg
from dtc_tpu.models.gpt import GPT as JGPT
from dtc_tpu_torch.config.schema import (
    ChaosConfig,
    ModelConfig,
    ServeConfig,
    SloConfig,
    SpecConfig,
    WatchdogConfig,
)
from dtc_tpu_torch.generate import generate
from dtc_tpu_torch.models.gpt import GPT
from dtc_tpu_torch.obs import MemorySink, load_flight_dump, read_jsonl, to_chrome_trace
from dtc_tpu_torch.obs.telemetry import Telemetry
from dtc_tpu_torch.parity import from_flax
from dtc_tpu_torch.serve import (
    DeadlineExceededError,
    EngineClosedError,
    Request,
    RequestState,
    ServingEngine,
)
from tests.test_torch_train import _one_thread  # noqa: F401  (autouse: one intra-op thread)

VOCAB = 97


def _audit_cfg() -> ModelConfig:
    jcfg = audit_model_cfg()
    return ModelConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__
                          if f != "adapter"})


@pytest.fixture(scope="module")
def served():
    """The audit model in the port, its own init (seed 0): the tests held
    against ``generate()`` and against themselves."""
    return GPT(_audit_cfg(), device="cpu", seed=0)


def _prompts(seed, sizes):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, size=n).tolist() for n in sizes]


def _refs(model, prompts, n):
    return [generate(model, [p], n)[0].tolist() for p in prompts]


# ---------------------------------------------------------------------------
# the acceptance run against the JAX engine
# ---------------------------------------------------------------------------

ACCEPT = dict(slots=2, page_size=4, queue_depth=8, max_new_tokens=10, prefill_bucket=8,
              verify_pages_every=1)
FAULTS = dict(enabled=True, serve_preempt_at_step=4, serve_corrupt_page_at_step=6,
              serve_poison_logits_at_step=8)
COUNTERS = ("chaos_injections", "serve_preemptions", "serve_corruptions", "serve_retries",
            "serve_evictions", "serve_rejected", "serve_degraded", "serve_expired",
            "serve_done", "serve_admissions", "serve_decode_steps", "recoveries")
ACCEPT_PROMPTS = _prompts(4, (6, 8, 5, 7))


def _drive(eng, req_cls):
    for i, p in enumerate(ACCEPT_PROMPTS):
        eng.submit(req_cls(rid=f"c{i}", prompt=p, max_new_tokens=10))
    eng.submit(req_cls(rid="doomed", prompt=[1, 2, 3], max_new_tokens=10, deadline_s=1e-9))
    return eng.run(max_steps=600)


def _event_list(events):
    """(etype, rid, kind | action | reason) of every event but the spans
    and the watchdog's flags, which ride the wall clock."""
    return [[e["etype"], e.get("rid"), e.get("kind") or e.get("action") or e.get("reason")]
            for e in events if e["etype"] not in ("span", "hung_step")]


@pytest.fixture(scope="session")
def jax_serve_chaos(tmp_path_factory):
    """The JAX engine's chaos acceptance run of ``tests/test_serve.py``
    (the audit model, flax init key 0): tokens, counters, event list, and
    the flax weights (numpy) for the port's engine."""
    from filelock import FileLock

    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    out = base / "jax_serve_chaos.json"
    weights = base / "jax_serve_chaos_params.pkl"
    with FileLock(str(out) + ".lock"):
        if not out.exists():
            from dtc_tpu.config.schema import ChaosConfig as JChaos
            from dtc_tpu.config.schema import ServeConfig as JServe
            from dtc_tpu.obs import MemorySink as JSink
            from dtc_tpu.serve import Request as JRequest
            from dtc_tpu.serve import ServingEngine as JEngine

            jcfg = audit_model_cfg()
            jm = JGPT(jcfg)
            params = jm.init({"params": jax.random.PRNGKey(0)}, jnp.ones((1, 1), jnp.int32),
                             train=False)["params"]
            eng = JEngine(jm, params, JServe(**ACCEPT, chaos=JChaos(**FAULTS)))
            sink = eng.reg.add_sink(JSink())
            res = _drive(eng, JRequest)
            snap = eng.reg.snapshot()
            weights.write_bytes(pickle.dumps(jax.tree.map(np.asarray, params)))
            out.write_text(json.dumps(dict(
                tokens={rid: r.tokens for rid, r in res.items()},
                states={rid: r.state.value for rid, r in res.items()},
                counters={k: snap.get(k, 0) for k in COUNTERS},
                events=_event_list(sink.events))))
    return json.loads(out.read_text()), pickle.loads(weights.read_bytes())


def test_chaos_acceptance_matches_clean_run_and_jax_engine(jax_serve_chaos):
    """``tests/test_serve.py::test_chaos_acceptance_faulted_run_matches_clean_run``:
    preemption at iteration 4, a corrupted page at 6, poisoned logits at 8
    and a doomed deadline. Every completed request's tokens equal the clean
    run's and the JAX engine's; the doomed one expires typed; the registry
    counters and the event list equal JAX's; one ``serve_request`` a rid."""
    want, params = jax_serve_chaos
    served = GPT(_audit_cfg(), device="cpu")
    served.load_state_dict(from_flax(params, served.cfg))
    clean = _drive(ServingEngine(served, ServeConfig(**ACCEPT)), Request)
    eng = ServingEngine(served, ServeConfig(**ACCEPT, chaos=ChaosConfig(**FAULTS)))
    sink = eng.reg.add_sink(MemorySink())
    res = _drive(eng, Request)
    for i in range(len(ACCEPT_PROMPTS)):
        rid = f"c{i}"
        assert res[rid].state is clean[rid].state is RequestState.DONE
        assert res[rid].tokens == clean[rid].tokens == want["tokens"][rid], rid
    assert res["doomed"].state is RequestState.EXPIRED
    assert isinstance(res["doomed"].error, DeadlineExceededError)
    assert {rid: r.state.value for rid, r in res.items()} == want["states"]
    snap = eng.reg.snapshot()
    assert {k: snap.get(k, 0) for k in COUNTERS} == want["counters"]
    assert (snap["chaos_injections"], snap["serve_preemptions"], snap["serve_corruptions"]) == (
        3, 1, 1) and snap["serve_retries"] >= 1
    assert _event_list(sink.events) == want["events"]
    terminal = [e for e in sink.events if e["etype"] == "serve_request"]
    assert sorted(e["rid"] for e in terminal) == sorted(res)
    assert all(e["error"] is not None or e["state"] == "done" for e in terminal)
    assert dict(eng.counters)["serve_corruptions"] == 1


# ---------------------------------------------------------------------------
# the chaos paths
# ---------------------------------------------------------------------------

def test_chaos_preempt_defers_until_actionable(served):
    """``tests/test_serve.py::test_chaos_preempt_defers_until_actionable``:
    idle iterations past the configured one do not spend the shot; it
    fires at the first iteration with an active request, which still
    finishes with ``generate()``'s tokens."""
    prompt = _prompts(5, (3,))[0]
    eng = ServingEngine(served, ServeConfig(
        slots=1, page_size=4, queue_depth=4, max_new_tokens=4, prefill_bucket=8,
        chaos=ChaosConfig(enabled=True, serve_preempt_at_step=1)))
    eng.step()
    eng.step()
    assert eng.counters["serve_preemptions"] == eng.counters["chaos_injections"] == 0
    eng.submit(Request(rid="r", prompt=prompt, max_new_tokens=4))
    res = eng.run(max_steps=100)
    assert eng.counters["serve_preemptions"] == eng.counters["chaos_injections"] == 1
    assert res["r"].state is RequestState.DONE and res["r"].n_evictions == 1
    assert res["r"].tokens == _refs(served, [prompt], 4)[0]


def test_fingerprint_detects_magnitude_preserving_corruption(served):
    """``tests/test_serve.py::test_fingerprint_detects_magnitude_preserving_corruption``:
    a sign flip and an intra-page swap of the K cache change the page's
    checksum."""
    eng = ServingEngine(served, ServeConfig(
        slots=1, page_size=4, queue_depth=4, max_new_tokens=6, prefill_bucket=8,
        verify_pages_every=1))
    eng.submit(Request(rid="r", prompt=[1, 2, 3, 4, 5], max_new_tokens=6))
    eng.step()
    kv = eng.cache["k"]
    fps0 = eng._page_fps().copy()
    assert float(kv[0, 0, 1, 0]) != 0.0
    kv[0, 0, 1, 0] = -kv[0, 0, 1, 0]
    eng._fps_memo = None
    fps1 = eng._page_fps().copy()
    assert fps1[0, 0] != fps0[0, 0], "sign flip went undetected"
    a, b = float(kv[0, 0, 0, 0]), float(kv[0, 0, 2, 0])
    assert a != b
    kv[0, 0, 0, 0], kv[0, 0, 2, 0] = b, a
    eng._fps_memo = None
    assert eng._page_fps()[0, 0] != fps1[0, 0], "intra-page swap went undetected"


def test_injected_corruption_lands_in_the_cache_and_is_caught(served):
    """The chaos corruption writes 123.25 over the first completed page of
    the oldest request in the cache itself (every layer of ``k``); the
    verifier, run in the same iteration, evicts it before a token from it
    is emitted, and the re-prefill lands on ``generate()``'s tokens."""
    prompt = _prompts(5, (9,))[0]
    eng = ServingEngine(served, ServeConfig(
        slots=1, page_size=4, queue_depth=4, max_new_tokens=8, prefill_bucket=8,
        verify_pages_every=1, chaos=ChaosConfig(enabled=True, serve_corrupt_page_at_step=2)))
    eng.submit(Request(rid="x", prompt=prompt, max_new_tokens=8))
    eng.step()
    ptr, tokens = eng.cache["k"].data_ptr(), list(eng.results["x"].tokens)
    seen = {}
    verify = eng._verify_pages

    def spy():
        seen["page"] = eng.cache["k"][:, 0, 0:4].clone()
        verify()
    eng._verify_pages = spy
    eng.step()
    assert torch.all(seen["page"] == 123.25) and eng.cache["k"].data_ptr() == ptr
    assert eng.counters["serve_corruptions"] == 1
    assert eng.results["x"].tokens == tokens, "no token emitted from the damaged page"
    res = eng.run(max_steps=100)
    assert res["x"].n_evictions == 1 and res["x"].tokens == _refs(served, [prompt], 8)[0]


def test_chaos_stall_flags_hung_step_and_dumps(served, tmp_path):
    """``tests/test_serve.py::test_chaos_stall_flags_hung_step`` and
    ``tests/test_trace.py::test_serve_watchdog_fire_dumps_flight``: a
    stall inside the timed iteration is flagged (``hung_step``, runtime
    ``serve``), and the flight dump's last ``decode_step`` span is the
    flagged iteration's."""
    tele = Telemetry.for_serving(str(tmp_path))
    eng = ServingEngine(served, ServeConfig(
        slots=1, page_size=4, queue_depth=4, max_new_tokens=10, prefill_bucket=8,
        watchdog=WatchdogConfig(enabled=True, factor=4.0, min_samples=3),
        chaos=ChaosConfig(enabled=True, serve_stall_at_step=8, stall_s=1.0)),
        telemetry=tele)
    sink = eng.reg.add_sink(MemorySink())
    eng.submit(Request(rid="w", prompt=_prompts(2, [6])[0], max_new_tokens=10))
    res = eng.run(max_steps=100)
    tele.flush()
    flags = [e for e in sink.events if e["etype"] == "hung_step"]
    assert all(f["runtime"] == "serve" for f in flags) and 8 in [f["step"] for f in flags]
    assert eng.counters["serve_hung_steps"] >= 1 and res["w"].state is RequestState.DONE
    dump = load_flight_dump(str(tmp_path / "obs" / "flight.r0.json"))
    assert dump["reason"] == "hung_step"
    dsteps = [e for e in dump["events"] if e["etype"] == "span" and e["name"] == "decode_step"]
    assert dsteps and dsteps[-1]["iteration"] == dump["iteration"]
    tele.close()


def test_chaos_dump_and_ordered_trace_read_by_jax(served, tmp_path):
    """``tests/test_trace.py::test_serve_chaos_acceptance_dump_and_ordered_trace``:
    preemption and poisoned logits under an impossible TTFT objective
    leave a chaos flight dump; the victim's chain queued → prefill → evict
    → queued → prefill → decode → done is in the shard in order; the
    Chrome trace of the run has monotonic times and the breach and chaos
    instants. The JAX package's readers (``read_jsonl``,
    ``reduce_shards``) take the port's serving shard."""
    from dtc_tpu.obs.aggregate import reduce_shards as jreduce
    from dtc_tpu.obs.registry import read_jsonl as jread

    tele = Telemetry.for_serving(str(tmp_path))
    eng = ServingEngine(served, ServeConfig(
        slots=1, page_size=4, queue_depth=8, max_new_tokens=6, prefill_bucket=8,
        chaos=ChaosConfig(enabled=True, serve_preempt_at_step=2, serve_poison_logits_at_step=4),
        slo=SloConfig(ttft_p99_s=1e-9, window=8, min_samples=1, check_every=1),
        watchdog=WatchdogConfig(enabled=False)), telemetry=tele)
    for i, p in enumerate(_prompts(1, [5, 6])):
        eng.submit(Request(rid=f"c{i}", prompt=p, max_new_tokens=6))
    res = eng.run(max_steps=300)
    assert all(r.state is RequestState.DONE for r in res.values())
    snap = eng.reg.snapshot()
    assert snap["serve_preemptions"] == 1 and snap["chaos_injections"] == 2
    assert snap["serve_retries"] >= 1 and snap["slo_breaches"] >= 1
    victim = next(rid for rid, r in res.items() if r.n_evictions == 1)
    tele.flush()
    dump = load_flight_dump(str(tmp_path / "obs" / "flight.r0.json"))
    assert dump["reason"].startswith("chaos:")
    assert any(e["etype"] == "chaos" for e in dump["events"])
    tele.close()
    path = str(tmp_path / "obs" / "events.r0.jsonl")
    events = read_jsonl(path)
    assert {"span", "chaos", "serve_evict", "slo_breach", "recovery"} <= {
        e["etype"] for e in events}
    mine = [e for e in events if e.get("rid") == victim
            and e["etype"] in ("span", "serve_evict")]
    mine.sort(key=lambda e: e.get("t0", e.get("ts")))
    names = [e.get("name", e["etype"]) for e in mine]
    assert names.count("req.queued") == 2 and names.count("req.prefill") == 2
    assert names.index("req.queued") < names.index("serve_evict")
    assert names[-1] == "req.done" and "req.decode" in names
    assert names.index("serve_evict") < len(names) - 1 - names[::-1].index("req.prefill")
    rows = [e for e in to_chrome_trace(events)["traceEvents"] if e["ph"] != "M"]
    assert [e["ts"] for e in rows] == sorted(e["ts"] for e in rows)
    assert {"slo_breach", "chaos", "req.queued", "req.prefill", "req.decode"} <= {
        e["name"] for e in rows}
    assert jread(path) == events
    assert jreduce(str(tmp_path / "obs")) is not None


def test_serve_slo_breach_activates_degrade(served):
    """``tests/test_trace.py::test_serve_slo_breach_activates_degrade``: a
    breaching TTFT objective caps the next admission at
    ``degrade_max_new_tokens`` with the queue watermark never crossed."""
    eng = ServingEngine(served, ServeConfig(
        slots=1, page_size=4, queue_depth=16, max_new_tokens=8, prefill_bucket=8,
        degrade_watermark=0.0, degrade_max_new_tokens=2,
        slo=SloConfig(ttft_p99_s=1e-9, window=8, min_samples=1, check_every=1)))
    p0, p1 = _prompts(3, [5, 6])
    eng.submit(Request(rid="a", prompt=p0, max_new_tokens=8))
    eng.run(max_steps=100)
    assert not eng.results["a"].degraded
    eng.submit(Request(rid="b", prompt=p1, max_new_tokens=8))
    res = eng.run(max_steps=100)
    assert res["b"].state is RequestState.DONE
    assert res["b"].degraded and res["b"].tokens == _refs(served, [p1], 2)[0]
    assert eng.counters["serve_degraded"] == 1 and eng.slo.degrade_active


def test_engine_spec_goodput_bills_rejected_draft_work():
    """``tests/test_spec.py::test_engine_spec_goodput_bills_rejected_draft_work``:
    under speculation the rejected draft work's seconds go to the
    ``spec_rejected_draft`` class, never productive decode, in the online
    window and as ``spec_reject`` spans; ``serve_accepted_per_launch`` and
    ``serve_accept_rate`` are filled."""
    from dtc_tpu_torch.obs.goodput import SPEC_REJECTED_DRAFT

    cfg = ModelConfig(vocab_size=VOCAB, d_model=64, n_layers=4, n_heads=4, d_ff=128,
                      max_seq_len=64, dropout=0.0, compute_dtype="float32",
                      decode_attention="fused_layers")
    eng = ServingEngine(GPT(cfg, device="cpu", seed=0), ServeConfig(
        slots=2, page_size=4, queue_depth=8, max_new_tokens=10, prefill_bucket=8,
        spec=SpecConfig(spec_k=4, draft_layers=1)))
    sink = eng.reg.add_sink(MemorySink())
    for i, p in enumerate(_prompts(10, (6, 8))):
        eng.submit(Request(rid=f"r{i}", prompt=p, max_new_tokens=10))
    eng.run(max_steps=300)
    secs = {}
    for k, s in eng.goodput._win:
        secs[k] = secs.get(k, 0.0) + s
    assert secs["productive_decode"] > 0 and secs[SPEC_REJECTED_DRAFT] > 0
    rejects = [e for e in sink.events if e["etype"] == "span" and e["name"] == "spec_reject"]
    assert rejects and all(e["rejected"] > 0 for e in rejects)
    snap = eng.reg.snapshot()
    launches = [e for e in sink.events if e["etype"] == "span" and e["name"] == "decode_step"]
    assert snap["serve_accepted_per_launch"]["count"] == sum(e["batch"] for e in launches)
    assert snap["serve_accept_rate"]["count"] == 2


# ---------------------------------------------------------------------------
# graceful shutdown
# ---------------------------------------------------------------------------

def test_engine_shutdown_drain_finishes_and_refuses(served):
    """``tests/test_router.py::test_engine_shutdown_drain_finishes_and_refuses``:
    ``shutdown("drain")`` finishes what is in flight with ``generate()``'s
    tokens; a later submit raises ``EngineClosedError`` with a
    ``serve_reject {closed}``; ``serve_shutdown`` is emitted once; a second
    shutdown changes nothing."""
    prompts = _prompts(12, (5, 6))
    eng = ServingEngine(served, ServeConfig(slots=2, page_size=4, queue_depth=4,
                                            max_new_tokens=6, prefill_bucket=8))
    sink = eng.reg.add_sink(MemorySink())
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=f"r{i}", prompt=p, max_new_tokens=6))
    res = eng.shutdown(mode="drain")
    refs = _refs(served, prompts, 6)
    for i in range(len(prompts)):
        assert res[f"r{i}"].state is RequestState.DONE and res[f"r{i}"].tokens == refs[i]
    with pytest.raises(EngineClosedError):
        eng.submit(Request(rid="late", prompt=[1, 2], max_new_tokens=2))
    assert [e["reason"] for e in sink.events if e["etype"] == "serve_reject"] == ["closed"]
    assert eng.counters["serve_rejected"] == 1
    assert len(eng.recorder.events) > 0
    assert eng.shutdown() is res
    assert sum(e["etype"] == "serve_shutdown" for e in sink.events) == 1
    with pytest.raises(ValueError, match="unknown shutdown mode"):
        ServingEngine(served, ServeConfig()).shutdown(mode="later")


def test_engine_shutdown_evict_is_typed_with_partial_tokens(served):
    """``tests/test_router.py::test_engine_shutdown_evict_is_typed_with_partial_tokens``:
    ``shutdown("evict")`` ends queued and mid-decode requests FAILED with
    ``EngineClosedError``, partial tokens kept, one ``serve_request`` each."""
    eng = ServingEngine(served, ServeConfig(slots=1, page_size=4, queue_depth=4,
                                            max_new_tokens=12, prefill_bucket=8))
    sink = eng.reg.add_sink(MemorySink())
    for i, p in enumerate(_prompts(13, (5, 6, 4))):
        eng.submit(Request(rid=f"r{i}", prompt=p, max_new_tokens=12))
    for _ in range(4):
        eng.step()
    res = eng.shutdown(mode="evict", reason="preemption notice")
    assert all(r.state is RequestState.FAILED for r in res.values())
    assert all(isinstance(r.error, EngineClosedError) for r in res.values())
    assert len(res["r0"].tokens) >= 1
    terminal = [e for e in sink.events if e["etype"] == "serve_request"]
    assert sorted(e["rid"] for e in terminal) == sorted(res)
    shut = [e for e in sink.events if e["etype"] == "serve_shutdown"]
    assert [(e["mode"], e["reason"]) for e in shut] == [("evict", "preemption notice")]
