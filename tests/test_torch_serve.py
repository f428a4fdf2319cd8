"""The port's serving engine on the CPU, mirroring tests/test_serve.py.

The anchor invariant is the same: the scheduler is a pure reordering of
single-stream greedy decode, so every completed request's tokens equal the
port's ``generate()`` on the same prompt — and, in float32 with the flax
weights carried across, the JAX ``ServingEngine``'s tokens.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dtc_tpu.analysis.lowering import audit_model_cfg
from dtc_tpu.config.schema import ServeConfig as JServeConfig
from dtc_tpu.models.gpt import GPT as JGPT
from dtc_tpu.serve import Request as JRequest
from dtc_tpu.serve import ServingEngine as JServingEngine
from dtc_tpu_torch.config.schema import ModelConfig, ServeConfig
from dtc_tpu_torch.generate import generate
from dtc_tpu_torch.models.gpt import GPT
from dtc_tpu_torch.parity import from_flax
from dtc_tpu_torch.resilience.retry import retry_call
from dtc_tpu_torch.serve import (
    DeadlineExceededError,
    PageAllocator,
    QueueFullError,
    Request,
    RequestState,
    RequestTooLargeError,
    ServingEngine,
    ShedError,
    pages_for,
)
from dtc_tpu_torch.serve import engine as engine_mod
from tests.test_torch_train import _one_thread  # noqa: F401  (autouse: one intra-op thread)


VOCAB = 97


@pytest.fixture(scope="module")
def models():
    """The JAX audit model and its port with the same weights."""
    jcfg = audit_model_cfg()
    jm = JGPT(jcfg)
    params = jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.ones((1, 1), jnp.int32), train=False
    )["params"]
    kw = {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__ if f != "adapter"}
    tcfg = ModelConfig(**kw)
    tm = GPT(tcfg, device="cpu")
    tm.load_state_dict(from_flax(jax.tree.map(np.asarray, params), tcfg))
    return jm, params, tm


def _prompts(seed, sizes):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, size=n).tolist() for n in sizes]


def _refs(model, prompts, n):
    return [generate(model, [p], n)[0].tolist() for p in prompts]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


SMOKE = dict(slots=2, page_size=4, queue_depth=8, max_new_tokens=6,
             prefill_bucket=8, verify_pages_every=1)


def test_serve_smoke_requests_match_jax_engine_and_generate(models):
    """The four requests of scripts/serve_smoke.py (two sharing a system
    prompt) through both engines: tokens identical to each other and to
    the port's generate(); the prefix store builds once and is hit once."""
    jm, params, tm = models
    rng = np.random.RandomState(7)
    prefix = rng.randint(0, VOCAB, size=6).tolist()
    prompts = [
        rng.randint(0, VOCAB, size=5).tolist(),
        prefix + rng.randint(0, VOCAB, size=3).tolist(),
        prefix + rng.randint(0, VOCAB, size=4).tolist(),
        rng.randint(0, VOCAB, size=8).tolist(),
    ]

    def reqs(cls):
        return [
            cls(rid=f"r{i}", prompt=p, max_new_tokens=6,
                shared_prefix_len=len(prefix) if p[:6] == prefix else 0)
            for i, p in enumerate(prompts)
        ]

    jeng = JServingEngine(jm, params, JServeConfig(**SMOKE))
    for r in reqs(JRequest):
        jeng.submit(r)
    jres = jeng.run(max_steps=300)
    eng = ServingEngine(tm, ServeConfig(**SMOKE))
    for r in reqs(Request):
        eng.submit(r)
    res = eng.run(max_steps=300)
    refs = _refs(tm, prompts, 6)
    for i in range(4):
        assert res[f"r{i}"].state is RequestState.DONE
        assert res[f"r{i}"].tokens == jres[f"r{i}"].tokens == refs[i]
    assert eng.counters["serve_prefix_builds"] == 1
    assert eng.counters["serve_prefix_hits"] == 1
    assert eng._it >= 3  # admissions happened mid-flight


def test_continuous_batching_parity_and_no_silent_drops(models):
    _, _, tm = models
    prompts = _prompts(0, (5, 9, 7, 6, 11))
    refs = _refs(tm, prompts, 8)
    eng = ServingEngine(tm, ServeConfig(
        slots=2, page_size=4, queue_depth=8, max_new_tokens=8, prefill_bucket=8,
    ))
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=f"r{i}", prompt=p, max_new_tokens=8))
    res = eng.run(max_steps=400)
    for i in range(len(prompts)):
        assert res[f"r{i}"].state is RequestState.DONE
        assert res[f"r{i}"].tokens == refs[i]
        assert res[f"r{i}"].error is None
    assert eng._it > 3
    assert eng.counters["serve_done"] == 5 and eng.counters["serve_submitted"] == 5
    assert set(eng.drain_results()) == {f"r{i}" for i in range(5)}
    assert eng.results == {}


def test_prefix_sharing_prefills_once(models):
    """A prefix whose length is neither page- nor bucket-aligned: the
    stored frontier pins to the valid length, later admissions hit it."""
    _, _, tm = models
    rng = np.random.RandomState(3)
    prefix = rng.randint(0, VOCAB, size=7).tolist()
    prompts = [prefix + rng.randint(0, VOCAB, size=k).tolist() for k in (3, 5, 4)]
    refs = _refs(tm, prompts, 6)
    eng = ServingEngine(tm, ServeConfig(
        slots=2, page_size=4, queue_depth=8, max_new_tokens=6, prefill_bucket=4,
    ))
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=f"s{i}", prompt=p, max_new_tokens=6,
                           shared_prefix_len=len(prefix)))
    res = eng.run(max_steps=300)
    for i in range(3):
        assert res[f"s{i}"].tokens == refs[i]
    assert eng.counters["serve_prefix_builds"] == 1
    assert eng.counters["serve_prefix_hits"] == 2


def test_eviction_under_page_pressure_is_bit_exact(models):
    _, _, tm = models
    prompts = _prompts(1, (6, 8, 5, 7))
    refs = _refs(tm, prompts, 10)
    eng = ServingEngine(tm, ServeConfig(
        slots=3, page_size=4, total_pages=9, queue_depth=8,
        max_new_tokens=10, prefill_bucket=8,
    ))
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=f"r{i}", prompt=p, max_new_tokens=10))
    res = eng.run(max_steps=500)
    assert sum(r.n_evictions for r in res.values()) > 0
    for i in range(4):
        assert res[f"r{i}"].state is RequestState.DONE
        assert res[f"r{i}"].tokens == refs[i]
    assert eng.alloc.free_pages == eng.alloc.total_pages


def test_admission_control_typed_rejection(models):
    _, _, tm = models
    eng = ServingEngine(tm, ServeConfig(
        slots=1, page_size=4, queue_depth=2, max_new_tokens=4, prefill_bucket=8,
    ))
    eng.submit(Request(rid="a", prompt=[1, 2], max_new_tokens=4))
    eng.submit(Request(rid="b", prompt=[3, 4], max_new_tokens=4))
    with pytest.raises(QueueFullError):
        eng.submit(Request(rid="c", prompt=[5, 6], max_new_tokens=4))
    with pytest.raises(RequestTooLargeError):
        eng.submit(Request(rid="d", prompt=[1] * 30, max_new_tokens=4))
    with pytest.raises(ValueError):
        eng.submit(Request(rid="a", prompt=[1, 2], max_new_tokens=4))
    assert eng.counters["serve_rejected"] == 2


def test_overload_sheds_lowest_priority(models):
    _, _, tm = models
    prompts = _prompts(2, (4, 4, 4, 4, 4, 4))
    eng = ServingEngine(tm, ServeConfig(
        slots=1, page_size=4, queue_depth=4, max_new_tokens=4,
        prefill_bucket=8, shed_watermark=0.5,
    ))
    for i, p in enumerate(prompts):
        try:
            eng.submit(Request(rid=f"r{i}", prompt=p, max_new_tokens=4,
                               priority=1 if i < 2 else 0))
        except QueueFullError:
            pass
    res = eng.run(max_steps=300)
    states = {rid: r.state for rid, r in res.items()}
    assert states["r0"] is RequestState.DONE
    assert states["r1"] is RequestState.DONE
    shed = [rid for rid, s in states.items() if s is RequestState.SHED]
    assert shed and all(isinstance(res[r].error, ShedError) for r in shed)
    assert all(s in (RequestState.DONE, RequestState.SHED) for s in states.values())
    refs = _refs(tm, [prompts[0], prompts[1]], 4)
    assert res["r0"].tokens == refs[0] and res["r1"].tokens == refs[1]


def test_deadline_expires_queued_and_mid_decode(models):
    _, _, tm = models
    clock = FakeClock()
    eng = ServingEngine(tm, ServeConfig(
        slots=1, page_size=4, queue_depth=8, max_new_tokens=12, prefill_bucket=8,
    ), clock=clock, sleep=lambda d: clock.advance(d))
    eng.submit(Request(rid="slow", prompt=[1, 2, 3], max_new_tokens=12,
                       deadline_s=5.0))
    eng.submit(Request(rid="waiting", prompt=[4, 5], max_new_tokens=4,
                       deadline_s=3.0))
    for _ in range(20):
        clock.advance(1.0)
        if not eng.step():
            break
    res = eng.results
    assert res["waiting"].state is RequestState.EXPIRED
    assert isinstance(res["waiting"].error, DeadlineExceededError)
    assert res["slow"].state is RequestState.EXPIRED
    assert isinstance(res["slow"].error, DeadlineExceededError)
    assert 0 < len(res["slow"].tokens) < 12
    assert eng.alloc.free_pages == eng.alloc.total_pages


def test_degradation_caps_new_tokens(models):
    _, _, tm = models
    eng = ServingEngine(tm, ServeConfig(
        slots=1, page_size=4, queue_depth=4, max_new_tokens=12,
        prefill_bucket=8, shed_watermark=0.0, degrade_watermark=0.25,
        degrade_max_new_tokens=3,
    ))
    for i in range(3):
        eng.submit(Request(rid=f"r{i}", prompt=[i + 1, i + 2], max_new_tokens=12))
    res = eng.run(max_steps=300)
    degraded = [r for r in res.values() if r.degraded]
    assert degraded and all(len(r.tokens) == 3 for r in degraded)
    assert eng.counters["serve_degraded"] == len(degraded)
    rid = degraded[0].rid
    eng.submit(Request(rid=rid, prompt=[9, 10], max_new_tokens=12))
    res2 = eng.run(max_steps=300)
    assert len(res2[rid].tokens) == 12 and not res2[rid].degraded


def test_nonfinite_decode_is_retried_from_the_pre_step_cache(models, monkeypatch):
    """The first decode attempt reads back NaN logits: the step is re-run
    from the same cache and the output stays generate()-identical."""
    _, _, tm = models
    prompts = _prompts(4, (5, 6))
    refs = _refs(tm, prompts, 6)
    real = engine_mod.decode_step
    calls = {"n": 0}

    def flaky(model, cache, tok):
        cache2, logits = real(model, cache, tok)
        calls["n"] += 1
        if tok.shape[1] == 1 and calls["n"] == 4:
            logits = torch.full_like(logits, float("nan"))
        return cache2, logits

    monkeypatch.setattr(engine_mod, "decode_step", flaky)
    eng = ServingEngine(tm, ServeConfig(
        slots=2, page_size=4, queue_depth=8, max_new_tokens=6, prefill_bucket=8,
    ), sleep=lambda d: None)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=f"r{i}", prompt=p, max_new_tokens=6))
    res = eng.run(max_steps=100)
    assert eng.counters["serve_retries"] == 1
    for i in range(2):
        assert res[f"r{i}"].tokens == refs[i]
    assert sum(r.n_retries for r in res.values()) >= 1


def test_corrupted_page_is_caught_and_re_prefilled(models):
    """Damage a completed KV page of an active request: the checksum
    verifier evicts it and the re-prefilled request still finishes with
    generate()'s tokens."""
    _, _, tm = models
    prompt = _prompts(5, (9,))[0]
    ref = _refs(tm, [prompt], 8)[0]
    eng = ServingEngine(tm, ServeConfig(
        slots=1, page_size=4, queue_depth=4, max_new_tokens=8,
        prefill_bucket=8, verify_pages_every=1,
    ))
    eng.submit(Request(rid="x", prompt=prompt, max_new_tokens=8))
    eng.step()
    assert eng.slots[0].page_fp  # pages 0 and 1 are complete
    eng.cache["k"][:, 0, 0:4] = 123.25
    eng._fps_memo = None
    res = eng.run(max_steps=100)
    assert eng.counters["serve_corruptions"] == 1
    assert res["x"].n_evictions == 1
    assert res["x"].state is RequestState.DONE and res["x"].tokens == ref


def test_grower_that_evicts_itself_returns_its_pages(models):
    """Pool pressure while a slot grows can pick the grower itself as the
    victim; its pages go back to the pool (none are charged to the empty
    slot), and every request still finishes with generate()'s tokens."""
    _, _, tm = models
    prompts = _prompts(1, (6, 8, 5, 7))
    refs = _refs(tm, prompts, 8)
    eng = ServingEngine(tm, ServeConfig(slots=3, page_size=4, queue_depth=8,
                                        max_new_tokens=8, prefill_bucket=8, total_pages=8))
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=f"r{i}", prompt=p, max_new_tokens=8))
    res = eng.run(max_steps=500)
    assert eng.counters["serve_evictions.cache_pressure"] > 0
    for i in range(4):
        assert res[f"r{i}"].state is RequestState.DONE
        assert res[f"r{i}"].tokens == refs[i], f"r{i}"
    assert eng.alloc.free_pages == eng.alloc.total_pages


# -- host-side units of the port's copies ---------------------------------

def test_pages_for_and_allocator():
    assert [pages_for(n, 4) for n in (0, 1, 4, 5)] == [0, 1, 1, 2]
    a = PageAllocator(total_pages=8, page_size=4)
    assert a.alloc("r1", 3) and a.held("r1") == 3 and a.free_pages == 5
    assert a.ensure("r1", 5) and a.held("r1") == 5
    assert a.ensure("r1", 2) and a.held("r1") == 5
    assert not a.alloc("r2", 4) and a.free_pages == 3
    assert a.free("r1") == 5 and a.free_pages == 8


def test_page_allocator_prefix_lru():
    a = PageAllocator(total_pages=6, page_size=4)
    assert a.pin_prefix(("a",), 2) and a.pin_prefix(("b",), 2)
    a.touch_prefix(("a",))
    assert not a.pin_prefix(("c",), 4)
    assert a.evict_prefix_lru() == ("b",)
    assert a.pin_prefix(("c",), 4) and a.free_pages == 0


def test_retry_call_max_elapsed_caps_episode():
    clock = FakeClock()
    calls = []

    def fn():
        calls.append(1)
        clock.advance(1.0)
        raise OSError("down")

    with pytest.raises(OSError):
        retry_call(fn, max_attempts=100, backoff_s=1.0, backoff_max_s=1.0,
                   jitter=0.0, max_elapsed_s=5.0, transient=(OSError,),
                   sleep=clock.advance, clock=clock)
    assert len(calls) == 3


class _IterationClock:
    """A clock under which every scheduler iteration lasts ``prefill_s``
    when it ran a prefill and ``decode_s`` otherwise: the iteration's
    first reading (the engine's ``t0``) is its start, later readings add
    the duration its work so far calls for. ``prefills`` reads the
    engine's prefill count; :meth:`begin` opens an iteration."""

    def __init__(self, prefill_s, decode_s):
        self.t, self.prefills = 0.0, None
        self.prefill_s, self.decode_s = prefill_s, decode_s
        self._open = self._started = False
        self._count = 0

    def begin(self):
        self._open, self._started, self._count = True, False, self.prefills()

    def _dt(self):
        return self.prefill_s if self.prefills() > self._count else self.decode_s

    def __call__(self):
        if not self._open:
            return self.t
        if not self._started:
            self._started = True
            return self.t
        return self.t + self._dt()

    def end(self):
        self.t += self._dt()
        self._open = False


def test_serve_watchdog_flags_the_iterations_the_reference_flags(models):
    """The serving watchdog's rule (a working iteration, admission prefill
    included, is flagged past ``factor`` x the trailing median of the
    iterations before it) in the port's engine against the JAX engine's,
    on the same iteration times: prefill iterations 40 ms, decode
    iterations 2 ms (the megakernel's decode median on the card). Both
    flag the same iterations, and every one holds a prefill: a mid-run
    admission measured against a decode median is what the rule counts."""
    jm, params, tm = models
    prompts = _prompts(11, [5, 7, 4, 6, 8, 3])
    cfg = dict(slots=2, page_size=4, queue_depth=8, max_new_tokens=12, prefill_bucket=8)
    flagged, prefill_its = {}, {}
    for name in ("port", "jax"):
        clock = _IterationClock(0.040, 0.002)
        if name == "port":
            eng = ServingEngine(tm, ServeConfig(**cfg), clock=clock)
            clock.prefills = lambda: eng.counters["serve_prefills"]
            reqs = [Request(rid=f"r{i}", prompt=p, max_new_tokens=12)
                    for i, p in enumerate(prompts)]
        else:
            eng = JServingEngine(jm, params, JServeConfig(**cfg), clock=clock)
            clock.prefills = lambda: eng.reg.counter("serve_prefills").value
            reqs = [JRequest(rid=f"r{i}", prompt=p, max_new_tokens=12)
                    for i, p in enumerate(prompts)]
        flags, held = [], []
        observe = eng.watchdog.observe

        def record(step, duration_s, observe=observe, flags=flags):
            flag = observe(step, duration_s)
            if flag is not None:
                flags.append(step)
            return flag

        eng.watchdog.observe = record
        for r in reqs:
            eng.submit(r)
        more = True
        while more:
            clock.begin()
            before = clock.prefills()
            more = eng.step()
            if clock.prefills() > before:
                held.append(eng._it)
            clock.end()
        flagged[name], prefill_its[name] = flags, held
    assert prefill_its["port"] == prefill_its["jax"]
    assert flagged["port"] == flagged["jax"]
    assert flagged["port"] and set(flagged["port"]) <= set(prefill_its["port"])
