"""The serving fleet in the port (``dtc_tpu_torch.serve.router``,
``serve/replica.py``, ``utils/arrivals.py``) held against the JAX
package's ``FleetRouter`` on the CPU, scenario by scenario as
``tests/test_router.py`` drives it (each test names the one it follows).

Both routers get the same weights (``parity.from_flax``), the same tenant
factors (``parity.lora_from_flax``), the same requests and faults, and fake
clocks, so no test reads the wall clock. For each scenario the port's
result is compared with JAX's: every request's terminal state, tokens,
hops and the replica it ended on; the ``router_*`` events with their
replica / src / dst / hop / state fields; and ``fleet_summary()``'s
counters. The JAX routers run once a session under a file lock, every
scenario in one fixture, with ``init_cache``'s shapes kept between calls
(``_shape_cached``); the scenarios share two serving shapes (slots 2, with
adapters or without) where JAX's tests vary them, so the JAX engine
compiles few programs.
"""

import dataclasses
import json
import os
import pickle
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dtc_tpu.config.schema as jschema
import dtc_tpu.serve as jserve
import dtc_tpu.serve.engine as jengine
from dtc_tpu.models.gpt import GPT as JGPT
from dtc_tpu.obs import MemorySink as JSink
import dtc_tpu_torch.config.schema as pschema
import dtc_tpu_torch.serve as pserve
from dtc_tpu_torch.generate import generate
from dtc_tpu_torch.models.gpt import GPT
from dtc_tpu_torch.obs import MemorySink
from dtc_tpu_torch.parity import from_flax, lora_from_flax
from dtc_tpu_torch.resilience.errors import ChaosTargetError
from tests.test_torch_train import _one_thread  # noqa: F401  (autouse: one intra-op thread)

VOCAB = 61
TINY = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=2, d_ff=64, max_seq_len=32,
            dropout=0.0, param_dtype="float32", compute_dtype="float32", attention="dense")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeClock:
    """Time moves only when told to (``advance``, the routers' sleep)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class TickClock(FakeClock):
    """Each read moves time by ``tick``: a step's duration counts the clock
    reads inside it, so a replica's watchdog sees a healthy median of a
    few ticks and an injected stall as an outlier, whatever the host."""

    def __init__(self, tick=1e-4):
        super().__init__()
        self.tick = tick

    def __call__(self):
        self.t += self.tick
        return self.t


def _prompts(seed, sizes):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, size=n).tolist() for n in sizes]


class Side:
    """One package's fleet: its config classes (``S``), serving module
    (``V``), memory sink, models and tenant factors, and constructors of
    routers and engines over them."""

    def __init__(self, schema, serve, sink, router, engine, factors):
        self.S, self.V, self.Sink = schema, serve, sink
        self._router, self._engine, self.factors = router, engine, factors

    def rcfg(self, n_replicas=3, serve=None, **kw):
        kw.setdefault("retry", self.S.StreamRetryConfig(
            max_attempts=2, backoff_s=0.0, backoff_max_s=0.0, jitter=0.0))
        return self.S.RouterConfig(
            n_replicas=n_replicas,
            serve=serve or self.S.ServeConfig(slots=2, page_size=4, queue_depth=4,
                                              max_new_tokens=8, prefill_bucket=8),
            **kw)

    def serve_cfg(self, **kw):
        return self.S.ServeConfig(**kw)

    def router(self, cfg, *, lora=False, clock=None, **kw):
        clock = clock or FakeClock()
        r = self._router(cfg, lora, clock=clock, sleep=clock.advance, **kw)
        r.test_sink = r.reg.add_sink(self.Sink())
        return r

    def engine(self, cfg, *, lora=False, clock=None):
        clock = clock or FakeClock()
        return self._engine(cfg, lora, clock=clock, sleep=clock.advance)

    def req(self, **kw):
        return self.V.Request(**kw)


def outcome(router, **extra):
    """The comparable record of a router's run: per rid (state, tokens,
    hops, the replica it ended on, the error's type), the ``router_*``
    events' fields and the chaos records' kinds and iterations, and the
    summary's counters."""
    ended = {}
    events = []
    for e in router.test_sink.events:
        if e["etype"] == "router_route":
            ended[e["rid"]] = e["replica"]
        elif e["etype"] == "router_failover":
            ended[e["rid"]] = e["dst"]
        if e["etype"].startswith("router_"):
            events.append([e["etype"]] + [e.get(k) for k in
                                          ("rid", "replica", "src", "dst", "hop", "state")])
        elif e["etype"] == "chaos":  # the fleet hooks fire at the same router iteration
            events.append(["chaos", e["kind"], e["iteration"]])
    summ = router.fleet_summary()
    out = dict(
        results={rid: [r.state.value, list(r.tokens), r.n_hops, ended.get(rid),
                       type(r.error).__name__ if r.error else None]
                 for rid, r in sorted(router.results.items())},
        events=events,
        summary={k: summ[k] for k in ("routed", "failovers", "replica_deaths", "rejected")},
    )
    out.update(extra)
    return out


# ---------------------------------------------------------------------------
# the scenarios: each drives one package's fleet and returns its outcome
# ---------------------------------------------------------------------------

def sc_tenant_affinity(side):
    """``test_tenant_affinity_routes_to_residency``."""
    router = side.router(side.rcfg(serve=side.serve_cfg(
        slots=2, page_size=4, queue_depth=8, max_new_tokens=4, prefill_bucket=8,
        max_adapters=4)), lora=True)
    router.register_adapter("t1", side.factors["t1"])
    prompts = _prompts(0, (4, 5, 6, 4, 5, 6))
    homes = []
    for i in range(3):
        router.submit(side.req(rid=f"a{i}", prompt=prompts[i], max_new_tokens=4,
                               adapter="t1"))
        homes.append(router.records[f"a{i}"].replica)
    base = []
    for i in range(3, 6):
        router.submit(side.req(rid=f"b{i}", prompt=prompts[i], max_new_tokens=4))
        base.append(router.records[f"b{i}"].replica)
    router.run(max_steps=300)
    return outcome(router, homes=homes, base_homes=base,
                   adapter_loads=router.reg.counter("router_adapter_loads").value)


def sc_prefix_affinity(side):
    """``test_prefix_affinity_routes_to_prefix_store``."""
    router = side.router(side.rcfg(serve=side.serve_cfg(
        slots=2, page_size=4, queue_depth=8, max_new_tokens=4, prefill_bucket=8)))
    rng = np.random.RandomState(3)
    prefix = rng.randint(0, VOCAB, size=6).tolist()
    p1 = prefix + rng.randint(0, VOCAB, size=3).tolist()
    p2 = prefix + rng.randint(0, VOCAB, size=4).tolist()
    router.submit(side.req(rid="p1", prompt=p1, max_new_tokens=4, shared_prefix_len=6))
    router.step()
    router.submit(side.req(rid="p2", prompt=p2, max_new_tokens=4, shared_prefix_len=6))
    router.run(max_steps=200)
    count = lambda name: sum(rep.engine.reg.counter(name).value  # noqa: E731
                             for rep in router.replicas)
    return outcome(router, builds=count("serve_prefix_builds"),
                   hits=count("serve_prefix_hits"))


def sc_round_robin(side):
    """``test_round_robin_placement``, after ``warmup`` (a request through
    every replica outside the router's records, histograms reset)."""
    router = side.router(side.rcfg(placement="round_robin"))
    router.warmup([1, 2, 3])
    warm = [rep.engine.reg.histogram("serve_ttft_s").count for rep in router.replicas]
    for i, p in enumerate(_prompts(1, (4, 4, 4))):
        router.submit(side.req(rid=f"r{i}", prompt=p, max_new_tokens=2))
    router.run(max_steps=200)
    return outcome(router, warm_hist=warm,
                   warm_admissions=[rep.engine.reg.counter("serve_admissions").value
                                    for rep in router.replicas])


def sc_backpressure(side):
    """``test_fleet_backpressure_is_typed_and_coordinated``."""
    router = side.router(side.rcfg(n_replicas=2, serve=side.serve_cfg(
        slots=2, page_size=4, queue_depth=2, max_new_tokens=4, prefill_bucket=8,
        shed_watermark=0.0)))
    accepted, rejected = [], []
    for i, p in enumerate(_prompts(2, tuple([4] * 8))):
        try:
            router.submit(side.req(rid=f"r{i}", prompt=p, max_new_tokens=4))
            accepted.append(f"r{i}")
        except side.V.FleetSaturatedError as e:
            rejected.append([f"r{i}", isinstance(e, side.V.QueueFullError)])
    router.run(max_steps=300)
    return outcome(router, accepted=accepted, rejected=rejected)


def sc_stall(side):
    """``test_stall_degrades_then_recovers``, on a ticking clock and with
    the engine's own watchdog off, so only the replica's judges."""
    router = side.router(side.rcfg(
        n_replicas=2, degraded_hold_iters=3,
        serve=side.serve_cfg(slots=2, page_size=4, queue_depth=8, max_new_tokens=24,
                             prefill_bucket=8,
                             watchdog=side.S.WatchdogConfig(enabled=False)),
        chaos=side.S.ChaosConfig(enabled=True, fleet_stall_replica_at_step=12,
                                 fleet_target_replica=0, stall_s=1.0)),
        clock=TickClock())
    p = _prompts(4, (4,))[0]
    router.submit(side.req(rid="warm", prompt=p, max_new_tokens=24))
    victim = router.replicas[0]
    seen = []
    for _ in range(20):
        router.step()
        seen.append(victim.state.value)
        if victim.state.value == "degraded":
            break
    hung = victim.hung_flags
    router.submit(side.req(rid="after", prompt=p, max_new_tokens=4))
    after_home = router.records["after"].replica
    for _ in range(40):
        router.step()
        seen.append(victim.state.value)
        if victim.state.value == "healthy":
            break
    router.run(max_steps=200)
    return outcome(router, states=seen, hung_flags=hung, after_home=after_home)


def sc_partition_short(side):
    """``test_partition_short_heals_in_place``."""
    router = side.router(side.rcfg(
        n_replicas=2, heartbeat_miss_limit=3,
        chaos=side.S.ChaosConfig(enabled=True, fleet_partition_at_step=2,
                                 fleet_partition_iters=2, fleet_target_replica=0)))
    for i, p in enumerate(_prompts(5, (4, 5))):
        router.submit(side.req(rid=f"r{i}", prompt=p, max_new_tokens=8))
    router.run(max_steps=300)
    return outcome(router, missed=router.reg.counter("router_missed_heartbeats").value,
                   victim=router.replicas[0].state.value)


def sc_partition_sustained(side):
    """``test_partition_sustained_escalates_to_failover``."""
    router = side.router(side.rcfg(
        n_replicas=2, heartbeat_miss_limit=2,
        serve=side.serve_cfg(slots=2, page_size=4, queue_depth=8, max_new_tokens=8,
                             prefill_bucket=8),
        chaos=side.S.ChaosConfig(enabled=True, fleet_partition_at_step=3,
                                 fleet_partition_iters=50, fleet_target_replica=0)))
    for i, p in enumerate(_prompts(6, (4, 5, 6, 4))):
        router.submit(side.req(rid=f"r{i}", prompt=p, max_new_tokens=8))
    router.run(max_steps=400)
    return outcome(router, dead_reason=router.replicas[0].dead_reason)


def sc_multi_hop(side):
    """``test_multi_hop_failover_restarts_queued_span_and_keeps_ttft``."""
    clock = FakeClock()
    router = side.router(side.rcfg(n_replicas=3, serve=side.serve_cfg(
        slots=2, page_size=4, queue_depth=4, max_new_tokens=10, prefill_bucket=8)),
        clock=clock)
    sinks = [rep.engine.reg.add_sink(side.Sink()) for rep in router.replicas]
    p = _prompts(7, (5,))[0]
    router.submit(side.req(rid="r0", prompt=p, max_new_tokens=10))
    first = router.records["r0"].replica
    clock.advance(100.0)
    router.kill_replica(first, reason="test")
    second = router.records["r0"].replica
    for _ in range(3):
        clock.advance(0.01)
        router.step()
    carried = len(router.records["r0"].tokens)
    clock.advance(5.0)
    router.kill_replica(second, reason="test")
    res = router.run(max_steps=200)["r0"]
    spans = [round(e["dur_s"], 6) for s in sinks for e in s.events
             if e["etype"] == "span" and e.get("name") == "req.queued" and e.get("rid") == "r0"]
    return outcome(router, submitted_t=res.submitted_t, ttft_s=round(res.ttft_s, 6),
                   queued_spans=sorted(spans), carried=carried)


def sc_hop_budget(side):
    """``test_failover_budget_exhaustion_is_typed``."""
    router = side.router(side.rcfg(n_replicas=2, failover_max_hops=1, serve=side.serve_cfg(
        slots=2, page_size=4, queue_depth=4, max_new_tokens=16, prefill_bucket=8)))
    router.submit(side.req(rid="r0", prompt=_prompts(8, (5,))[0], max_new_tokens=16))
    router.kill_replica(router.records["r0"].replica, reason="test")
    router.step()
    router.kill_replica(router.records["r0"].replica, reason="test")
    return outcome(router, message="failover budget" in str(router.results["r0"].error))


def sc_tenant_failover(side):
    """``test_tenant_failover_reloads_factors_on_survivor``."""
    router = side.router(side.rcfg(n_replicas=2, serve=side.serve_cfg(
        slots=2, page_size=4, queue_depth=4, max_new_tokens=8, prefill_bucket=8,
        max_adapters=4)), lora=True)
    router.register_adapter("t1", side.factors["t1"])
    router.submit(side.req(rid="r0", prompt=_prompts(9, (5,))[0], max_new_tokens=8,
                           adapter="t1"))
    home = router.records["r0"].replica
    router.step()
    router.kill_replica(home, reason="test")
    router.run(max_steps=200)
    return outcome(router, survivor_holds="t1" in router.replicas[1 - home].resident_adapters(),
                   adapter_loads=router.reg.counter("router_adapter_loads").value)


def sc_unregistered_tenant(side):
    """``test_unregistered_tenant_failover_fails_typed_never_base``."""
    router = side.router(side.rcfg(n_replicas=2, serve=side.serve_cfg(
        slots=2, page_size=4, queue_depth=4, max_new_tokens=8, prefill_bucket=8,
        max_adapters=4)), lora=True)
    router.replicas[0].engine.load_adapter("t2", side.factors["t2"])
    router.submit(side.req(rid="r0", prompt=_prompts(10, (5,))[0], max_new_tokens=8,
                           adapter="t2"))
    home = router.records["r0"].replica
    router.step()
    router.kill_replica(0, reason="test")
    res = router.results["r0"]
    terminal = [[e["rid"], e["error"]] for e in router.test_sink.events
                if e["etype"] == "serve_request"]
    return outcome(router, home=home, cause=type(res.error.__cause__).__name__,
                   terminal=terminal)


def sc_eviction_race(side):
    """``test_adapter_store_eviction_cannot_race_queued_request``: the
    engine alone."""
    prompts = _prompts(11, (5, 4))
    eng = side.engine(side.serve_cfg(slots=2, page_size=4, queue_depth=4, max_new_tokens=6,
                                     prefill_bucket=8, max_adapters=2), lora=True)
    eng.load_adapter("t1", side.factors["t1"])
    eng.submit(side.req(rid="q", prompt=prompts[0], max_new_tokens=6, adapter="t1"))
    raised = []
    try:
        eng.load_adapter("t2", side.factors["t2"])
    except side.V.AdapterStoreFullError as e:
        raised.append(type(e).__name__)
    res = eng.run(max_steps=100)
    q = [res["q"].state.value, list(res["q"].tokens)]
    eng.load_adapter("t2", side.factors["t2"])
    try:
        eng.submit(side.req(rid="q2", prompt=prompts[1], max_new_tokens=6, adapter="t1"))
    except side.V.UnknownAdapterError as e:
        raised.append(type(e).__name__)
    return dict(q=q, raised=raised)


def sc_sigterm(side):
    """``test_router_drain_on_sigterm``."""
    router = side.router(side.rcfg(n_replicas=2, serve=side.serve_cfg(
        slots=2, page_size=4, queue_depth=4, max_new_tokens=6, prefill_bucket=8)))
    router.install_sigterm()
    try:
        for i, p in enumerate(_prompts(14, (5, 6, 4))):
            router.submit(side.req(rid=f"r{i}", prompt=p, max_new_tokens=6))
        os.kill(os.getpid(), signal.SIGTERM)
        router.run(max_steps=300)
    finally:
        router.restore_sigterm()
    return outcome(router, replicas=[[r.state.value, r.dead_reason, r.engine.closed]
                                     for r in router.replicas])


ACCEPT_N = 10


def sc_acceptance(side, obs_dir):
    """``test_fleet_chaos_acceptance_kill_mid_decode``: seeded Poisson
    arrivals on a fake clock that moves 10 ms a router iteration, a kill of
    replica 0 at iteration 4; every replica's and the router's shard
    written to ``obs_dir``."""
    rng = np.random.RandomState(21)
    arrivals = np.cumsum(rng.exponential(0.02, size=ACCEPT_N))
    prompts = [rng.randint(0, VOCAB, size=4 + i % 4).tolist() for i in range(ACCEPT_N)]
    clock = FakeClock()
    router = side.router(side.rcfg(
        n_replicas=3, serve=side.serve_cfg(slots=2, page_size=4, queue_depth=16,
                                           max_new_tokens=8, prefill_bucket=8),
        chaos=side.S.ChaosConfig(enabled=True, fleet_kill_replica_at_step=4,
                                 fleet_target_replica=0)), clock=clock, obs_dir=obs_dir)
    sinks = [rep.engine.reg.add_sink(side.Sink()) for rep in router.replicas]
    submitted, i = [], 0
    for _ in range(500):
        while i < ACCEPT_N and arrivals[i] <= clock():
            router.submit(side.req(rid=f"r{i}", prompt=prompts[i], max_new_tokens=8))
            submitted.append(f"r{i}")
            i += 1
        busy = router.step()
        clock.advance(0.01)
        if i >= ACCEPT_N and not busy:
            break
    router.close()
    terminal = sorted(e["rid"] for s in sinks + [router.test_sink] for e in s.events
                      if e["etype"] == "serve_request")
    return outcome(router, submitted=submitted, terminal=terminal, prompts=prompts)


def sc_spawn_retire(side):
    """The pool's seam (JAX's router ``:437-551``, its pool tests): a spawn
    colliding with the router's shard raises; a spawned replica is routed
    to; begin / finish / cancel retire; a stale chaos target raises at fire
    time while a spawned one is legal (``test_chaos_stale_target_is_typed_error_at_fire_time``)."""
    raised = []
    router = side.router(side.rcfg(n_replicas=1))
    try:
        router.spawn_replica()
    except ValueError as e:
        raised.append(["collide", "collide" in str(e)])
    router = side.router(side.rcfg(n_replicas=2), router_proc=64)
    spawned = router.spawn_replica().replica_id
    prompts = _prompts(16, (4, 5, 6, 4, 5))
    for i in range(3):
        router.submit(side.req(rid=f"r{i}", prompt=prompts[i], max_new_tokens=6))
    router.begin_retire(0)
    router.submit(side.req(rid="r3", prompt=prompts[3], max_new_tokens=6))
    finished = [router.finish_retire(0)]
    while not finished[-1]:
        router.step()
        finished.append(router.finish_retire(0))
    router.begin_retire(1)
    router.cancel_retire(1)
    for fn in (lambda: router.cancel_retire(1), lambda: router.finish_retire(2)):
        try:
            fn()
        except ValueError as e:
            raised.append(["not draining", "not draining" in str(e)])
    router.submit(side.req(rid="r4", prompt=prompts[4], max_new_tokens=6))
    router.run(max_steps=300)
    retires = router.reg.counter("router_retires").value
    stale = side.router(side.rcfg(n_replicas=1, chaos=side.S.ChaosConfig(
        enabled=True, fleet_kill_replica_at_step=1, fleet_target_replica=5)))
    stale.submit(side.req(rid="s", prompt=[1, 2, 3], max_new_tokens=4))
    try:
        stale.step()
    except Exception as e:  # ChaosTargetError of either package
        raised.append([type(e).__name__, "fleet_target_replica 5" in str(e)])
    late = side.router(side.rcfg(n_replicas=1, chaos=side.S.ChaosConfig(
        enabled=True, fleet_kill_replica_at_step=1, fleet_target_replica=1)), router_proc=64)
    late.spawn_replica()
    late.submit(side.req(rid="b", prompt=[1, 2, 3], max_new_tokens=4))
    late.run()
    return outcome(router, spawned=spawned, finished=finished, raised=raised,
                   retires=retires, states=[r.state.value for r in router.replicas],
                   late=[late.replicas[1].state.value, late.results["b"].state.value])


def sc_resume(side):
    """``test_resume_submit_engine_level``: engine A's partial result
    resumes on engine B."""
    p = _prompts(15, (5,))[0]
    cfg = side.serve_cfg(slots=2, page_size=4, queue_depth=4, max_new_tokens=8,
                         prefill_bucket=8)
    clock = FakeClock()  # both engines on one timebase
    a = side.engine(cfg, clock=clock)
    a.submit(side.req(rid="r", prompt=p, max_new_tokens=8))
    for _ in range(4):
        clock.advance(1.0)
        a.step()
    partial = a.results["r"]
    b = side.engine(cfg, clock=clock)
    clock.advance(10.0)
    b.submit(side.req(rid="r", prompt=p, max_new_tokens=8), resume=partial)
    res = b.run(max_steps=100)["r"]
    b.drain_results()
    raised = []
    try:
        b.submit(side.req(rid="r2", prompt=p, max_new_tokens=2), resume=res)
    except ValueError as e:
        raised.append("resume" in str(e))
    return dict(partial=[partial.state.value, list(partial.tokens)],
                res=[res.state.value, list(res.tokens), res.n_hops, res.submitted_t,
                     res.first_token_t, res.ttft_s],
                raised=raised)


SCENARIOS = dict(
    tenant_affinity=sc_tenant_affinity, prefix_affinity=sc_prefix_affinity,
    round_robin=sc_round_robin, backpressure=sc_backpressure, stall=sc_stall,
    partition_short=sc_partition_short, partition_sustained=sc_partition_sustained,
    multi_hop=sc_multi_hop, hop_budget=sc_hop_budget, tenant_failover=sc_tenant_failover,
    unregistered_tenant=sc_unregistered_tenant, eviction_race=sc_eviction_race,
    sigterm=sc_sigterm, spawn_retire=sc_spawn_retire, resume=sc_resume,
)


# ---------------------------------------------------------------------------
# the two sides
# ---------------------------------------------------------------------------

def _jax_side():
    """The JAX fleet on the tiny model without adapters and with them
    (rank 4), on one flax init (key 0; the base weights are the same in
    both), two tenants with random nonzero factors. Returns the side and
    its weights and factors as numpy trees."""
    models = {lora: JGPT(jschema.ModelConfig(
        **TINY, adapter=jschema.AdapterConfig(rank=4 if lora else 0))) for lora in (False, True)}
    init = models[True].init({"params": jax.random.PRNGKey(0)}, jnp.ones((1, 1), jnp.int32),
                             train=False)
    params = {False: init["params"], True: init["params"]}
    leaves, td = jax.tree.flatten(init["lora"])
    factors = {}
    for name, seed in (("t1", 31), ("t2", 32)):
        rng = np.random.RandomState(seed)
        factors[name] = jax.tree.unflatten(td, [
            (0.5 * rng.randn(*x.shape) / np.sqrt(x.shape[-2])).astype(np.float32)
            for x in leaves])

    def router(cfg, lora, **kw):
        return jserve.FleetRouter(models[lora], params[lora], cfg, **kw)

    def engine(cfg, lora, **kw):
        return jserve.ServingEngine(models[lora], params[lora], cfg, **kw)

    side = Side(jschema, jserve, JSink, router, engine, factors)
    weights = dict(params={k: jax.tree.map(np.asarray, v) for k, v in params.items()},
                   factors={k: jax.tree.map(np.asarray, v) for k, v in factors.items()})
    return side, weights


def _port_side(weights):
    models = {}
    for lora in (False, True):
        m = GPT(pschema.ModelConfig(**TINY, adapter=pschema.AdapterConfig(
            rank=4 if lora else 0)), device="cpu")
        m.load_state_dict(from_flax(weights["params"][lora], m.cfg))
        models[lora] = m
    factors = {k: lora_from_flax(v) for k, v in weights["factors"].items()}

    def router(cfg, lora, **kw):
        return pserve.FleetRouter(models[lora], cfg, **kw)

    def engine(cfg, lora, **kw):
        return pserve.ServingEngine(models[lora], cfg, **kw)

    return Side(pschema, pserve, MemorySink, router, engine, factors), models


def _shape_cached(init_cache):
    """JAX's ``generate.init_cache`` with its shapes kept per (model, batch):
    the original traces the model (``jax.eval_shape``) for every engine and
    every admission, ~0.4 s each on the CPU; this returns the same fresh
    zeros without tracing again."""
    shapes = {}

    def cached(model, batch_size):
        key = (id(model), batch_size)
        if key not in shapes:
            shapes[key] = (model, jax.tree.map(
                lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                init_cache(model, batch_size)))
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes[key][1])

    return cached


@pytest.fixture(scope="session")
def jax_fleet(tmp_path_factory):
    """Every scenario on the JAX side, once a session under a file lock,
    with ``init_cache``'s shapes kept between calls: ``(outcomes,
    weights)``; the acceptance run's shards stay in the session's base
    directory."""
    from filelock import FileLock

    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    out = base / "jax_fleet.json"
    wpath = base / "jax_fleet_weights.pkl"
    with FileLock(str(out) + ".lock"):
        if not out.exists():
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jengine, "init_cache", _shape_cached(jengine.init_cache))
                side, weights = _jax_side()
                got = {name: fn(side) for name, fn in SCENARIOS.items()}
                got["acceptance"] = sc_acceptance(side, str(base / "jax_fleet_obs"))
            wpath.write_bytes(pickle.dumps(weights))
            out.write_text(json.dumps(got))
    return json.loads(out.read_text()), pickle.loads(wpath.read_bytes())


@pytest.fixture(scope="module")
def port(jax_fleet):
    return _port_side(jax_fleet[1])


def _jsonable(x):
    return json.loads(json.dumps(x))


def _run(port, jax_fleet, name):
    side, models = port
    got = _jsonable(SCENARIOS[name](side))
    assert got == jax_fleet[0][name]
    return got, models


def _refs(model, prompts, n, lora=None):
    return [generate(model, [p], n, lora=lora)[0].tolist() for p in prompts]


# ---------------------------------------------------------------------------
# config and arrivals
# ---------------------------------------------------------------------------

def test_router_config_loads_equal_to_jax():
    """``test_router_config_yaml_loads``: ``configs/router_config.yaml`` with
    its sibling model config loads into the port field for field as into
    JAX's ``load_router_config``."""
    from dtc_tpu.config.loader import load_router_config as jload
    from dtc_tpu_torch.config.loader import load_router_config

    path = os.path.join(ROOT, "configs", "router_config.yaml")
    rcfg, mcfg = load_router_config(path)
    jr, jm = jload(path, os.path.join(ROOT, "configs", "model_config.yaml"))
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(jr)
    assert dataclasses.asdict(mcfg) == dataclasses.asdict(jm)
    assert rcfg.n_replicas == 3 and rcfg.placement == "affinity"
    assert rcfg.serve.slots == 4 and rcfg.watchdog.enabled
    assert dataclasses.asdict(pschema.RouterConfig()) == dataclasses.asdict(jschema.RouterConfig())


@pytest.mark.parametrize("kw", [
    dict(n_replicas=0), dict(placement="coin_flip"), dict(heartbeat_miss_limit=0),
    dict(degraded_hold_iters=0), dict(failover_max_hops=-1), dict(drain_max_steps=0),
])
def test_router_config_validation_matches_jax(kw):
    """``test_router_config_validation``: each bad knob raises in both
    packages; a chaos victim past the construction-time fleet is legal
    (judged when it fires)."""
    with pytest.raises(ValueError):
        jschema.RouterConfig(**kw)
    with pytest.raises(ValueError):
        pschema.RouterConfig(**kw)
    for S in (jschema, pschema):
        S.RouterConfig(n_replicas=2, chaos=S.ChaosConfig(
            enabled=True, fleet_kill_replica_at_step=3, fleet_target_replica=5))


@pytest.mark.parametrize("seed", [0, 7, 21])
def test_arrival_schedule_equals_jax(seed):
    """``utils/arrivals.py``: the same arrivals and prompts as JAX's for the
    seed, open loop and closed, arrivals drawn first."""
    from dtc_tpu.utils.arrivals import arrival_schedule as jsched
    from dtc_tpu_torch.utils.arrivals import arrival_schedule

    for rps in (None, 5.0):
        a, p = arrival_schedule(seed, 6, 9, VOCAB, rps)
        ja, jp = jsched(seed, 6, 9, VOCAB, rps)
        assert np.array_equal(a, ja) and p == jp


# ---------------------------------------------------------------------------
# the scenarios against JAX's
# ---------------------------------------------------------------------------

def test_tenant_affinity_routes_to_residency(port, jax_fleet):
    """``test_tenant_affinity_routes_to_residency``: the tenant's three
    requests share the replica that loaded its factors once; base requests
    spread; tokens are ``generate()``'s under the adapter."""
    got, models = _run(port, jax_fleet, "tenant_affinity")
    assert len(set(got["homes"])) == 1 and got["adapter_loads"] == 1
    assert len(set(got["base_homes"])) > 1
    prompts = _prompts(0, (4, 5, 6, 4, 5, 6))
    refs = _refs(models[True], prompts[:3], 4, port[0].factors["t1"])
    assert [got["results"][f"a{i}"][1] for i in range(3)] == refs
    assert all(r[0] == "done" for r in got["results"].values())


def test_prefix_affinity_routes_to_prefix_store(port, jax_fleet):
    """``test_prefix_affinity_routes_to_prefix_store``: the second request
    follows the prefix to its builder; the prefix is built once."""
    got, _ = _run(port, jax_fleet, "prefix_affinity")
    assert got["results"]["p1"][3] == got["results"]["p2"][3]
    assert got["builds"] == 1 and got["hits"] >= 1


def test_round_robin_placement(port, jax_fleet):
    """``test_round_robin_placement``: three requests, three replicas; the
    warm-up's requests stay out of the results and its latencies out of
    the histograms."""
    got, _ = _run(port, jax_fleet, "round_robin")
    assert len({r[3] for r in got["results"].values()}) == 3
    assert sorted(got["results"]) == ["r0", "r1", "r2"] and got["warm_hist"] == [0, 0, 0]
    assert got["warm_admissions"] == [2, 2, 2]


def test_fleet_backpressure_is_typed_and_coordinated(port, jax_fleet):
    """``test_fleet_backpressure_is_typed_and_coordinated``: two replicas
    of queue 2 take four, spread over both; the rest raise
    ``FleetSaturatedError``, a ``QueueFullError``; every accepted request
    ends DONE."""
    got, _ = _run(port, jax_fleet, "backpressure")
    assert len(got["accepted"]) == 4 and all(q for _, q in got["rejected"])
    assert got["summary"]["rejected"] == len(got["rejected"]) > 0
    assert len({got["results"][r][3] for r in got["accepted"]}) == 2
    assert sorted(got["results"]) == sorted(got["accepted"])


def test_stall_degrades_then_recovers(port, jax_fleet):
    """``test_stall_degrades_then_recovers``: the stalled replica turns
    DEGRADED, new work goes to its peer, and it recovers after the hold."""
    got, _ = _run(port, jax_fleet, "stall")
    assert got["hung_flags"] >= 1 and got["after_home"] == 1
    assert "degraded" in got["states"] and got["states"][-1] == "healthy"
    states = [e[6] for e in got["events"] if e[0] == "router_replica_state"]
    assert states[:2] == ["degraded", "healthy"]


def test_partition_short_heals_in_place(port, jax_fleet):
    """``test_partition_short_heals_in_place``: two missed beats, no death,
    no hop, ``generate()``'s tokens."""
    got, models = _run(port, jax_fleet, "partition_short")
    assert got["missed"] == 2 and got["summary"]["replica_deaths"] == 0
    assert got["victim"] == "healthy"
    refs = _refs(models[False], _prompts(5, (4, 5)), 8)
    for i in range(2):
        assert got["results"][f"r{i}"][:3] == ["done", refs[i], 0]


def test_partition_sustained_escalates_to_failover(port, jax_fleet):
    """``test_partition_sustained_escalates_to_failover``: the partitioned
    replica is declared dead on heartbeats; its requests finish elsewhere
    with ``generate()``'s tokens."""
    got, models = _run(port, jax_fleet, "partition_sustained")
    assert "heartbeat" in got["dead_reason"] and got["summary"]["failovers"] >= 1
    refs = _refs(models[False], _prompts(6, (4, 5, 6, 4)), 8)
    for i in range(4):
        assert got["results"][f"r{i}"][:2] == ["done", refs[i]]


def test_multi_hop_failover_keeps_ttft_anchored(port, jax_fleet):
    """``test_multi_hop_failover_restarts_queued_span_and_keeps_ttft``: two
    hops, ``generate()``'s tokens, TTFT from the original submit (past the
    100 s before the first hop), one restarted ``req.queued`` span per
    admitted hop, each shorter than that."""
    got, models = _run(port, jax_fleet, "multi_hop")
    r0 = got["results"]["r0"]
    assert r0[:3] == ["done", _refs(models[False], _prompts(7, (5,)), 10)[0], 2]
    assert got["submitted_t"] == 0.0 and got["ttft_s"] >= 100.0 and got["carried"] >= 1
    assert len(got["queued_spans"]) == 2 and all(d < 100.0 for d in got["queued_spans"])


def test_failover_budget_exhaustion_is_typed(port, jax_fleet):
    """``test_failover_budget_exhaustion_is_typed``."""
    got, _ = _run(port, jax_fleet, "hop_budget")
    assert got["results"]["r0"][0] == "failed" and got["results"]["r0"][4] == "RequestFailedError"
    assert got["message"]


def test_tenant_failover_reloads_factors_on_survivor(port, jax_fleet):
    """``test_tenant_failover_reloads_factors_on_survivor``: the survivor
    loads the tenant's factors from the router and the tokens stay
    ``generate()``'s under the adapter (not the base's)."""
    got, models = _run(port, jax_fleet, "tenant_failover")
    p = _prompts(9, (5,))
    ref = _refs(models[True], p, 8, port[0].factors["t1"])[0]
    assert got["results"]["r0"][:3] == ["done", ref, 1]
    assert ref != _refs(models[True], p, 8)[0]
    assert got["survivor_holds"] and got["adapter_loads"] == 2


def test_unregistered_tenant_failover_fails_typed_never_base(port, jax_fleet):
    """``test_unregistered_tenant_failover_fails_typed_never_base``."""
    got, _ = _run(port, jax_fleet, "unregistered_tenant")
    assert got["home"] == 0 and got["results"]["r0"][0] == "failed"
    assert got["results"]["r0"][4] == "RequestFailedError"
    assert got["cause"] == "UnknownAdapterError"
    assert got["terminal"] == [["r0", "RequestFailedError"]]


def test_adapter_store_eviction_cannot_race_queued_request(port, jax_fleet):
    """``test_adapter_store_eviction_cannot_race_queued_request``."""
    got, models = _run(port, jax_fleet, "eviction_race")
    assert got["raised"] == ["AdapterStoreFullError", "UnknownAdapterError"]
    ref = _refs(models[True], _prompts(11, (5,)), 6, port[0].factors["t1"])[0]
    assert got["q"] == ["done", ref]


def test_router_drain_on_sigterm(port, jax_fleet):
    """``test_router_drain_on_sigterm``: every request finishes with
    ``generate()``'s tokens; every replica drained, DEAD, closed."""
    got, models = _run(port, jax_fleet, "sigterm")
    refs = _refs(models[False], _prompts(14, (5, 6, 4)), 6)
    for i in range(3):
        assert got["results"][f"r{i}"][:2] == ["done", refs[i]]
    assert got["replicas"] == [["dead", "drained", True]] * 2


def test_spawn_and_retire_stages(port, jax_fleet):
    """Spawn and the three retire stages, and chaos targets judged at fire
    time (``test_chaos_stale_target_is_typed_error_at_fire_time``)."""
    got, _ = _run(port, jax_fleet, "spawn_retire")
    assert got["spawned"] == 2 and got["finished"][-1] and not got["finished"][0]
    assert got["raised"][0] == ["collide", True]
    assert got["raised"][1:3] == [["not draining", True]] * 2
    assert got["raised"][3] == ["ChaosTargetError", True]
    assert got["retires"] == 1 and got["states"] == ["dead", "healthy", "healthy"]
    assert got["late"] == ["dead", "done"]
    assert all(r[0] == "done" for r in got["results"].values())
    assert ["router_replica_spawn", None, 2, None, None, None, None] in got["events"]


def test_stale_chaos_target_raises_the_ports_type(port):
    """The port raises its own ``ChaosTargetError``."""
    side, _ = port
    router = side.router(side.rcfg(n_replicas=1, chaos=side.S.ChaosConfig(
        enabled=True, fleet_kill_replica_at_step=1, fleet_target_replica=5)))
    router.submit(side.req(rid="s", prompt=[1, 2, 3], max_new_tokens=4))
    with pytest.raises(ChaosTargetError, match="fleet_target_replica 5"):
        router.step()


def test_resume_submit_engine_level(port, jax_fleet):
    """``test_resume_submit_engine_level``: a partial result on engine A
    resumes on B with ``generate()``'s tokens, one hop, ``submitted_t`` and
    ``first_token_t`` carried; a resume already complete raises."""
    got, models = _run(port, jax_fleet, "resume")
    ref = _refs(models[False], _prompts(15, (5,)), 8)[0]
    assert got["partial"][0] == "decode" and 0 < len(got["partial"][1]) < 8
    assert got["res"][:3] == ["done", ref, 1] and got["res"][3] == 0.0
    assert got["res"][4] == 1.0 and got["res"][5] == 1.0  # the first token on A
    assert got["raised"] == [True]


@pytest.fixture(scope="module")
def port_acceptance(port, tmp_path_factory):
    obs = str(tmp_path_factory.mktemp("fleet_obs"))
    return _jsonable(sc_acceptance(port[0], obs)), obs


def test_fleet_chaos_acceptance_kill_mid_decode(port, jax_fleet, port_acceptance):
    """``test_fleet_chaos_acceptance_kill_mid_decode``: seeded traffic, a
    kill mid-decode: the same outcome as JAX's; every submitted request
    terminal and typed, one ``serve_request`` each; completed ones
    ``generate()``'s tokens, a hopped one among them."""
    got, _ = port_acceptance
    assert got == jax_fleet[0]["acceptance"]
    models = port[1]
    refs = _refs(models[False], got["prompts"], 8)
    assert sorted(got["results"]) == sorted(got["submitted"]) == got["terminal"]
    assert got["summary"]["replica_deaths"] == 1 and got["summary"]["failovers"] >= 1
    for i, rid in enumerate(got["submitted"]):
        r = got["results"][rid]
        assert (r[4] is None) == (r[0] == "done")
        if r[0] == "done":
            assert r[1] == refs[int(rid[1:])], rid
    assert any(r[2] > 0 and r[0] == "done" for r in got["results"].values())


def test_jax_reducer_reads_the_port_fleets_shards(port_acceptance):
    """JAX's ``obs.aggregate.reduce_shards`` over the port fleet's
    per-replica shards and the router's gives the port reducer's fleet
    rows: requests, states, failover hops, percentiles, and each
    replica's serving row."""
    from dtc_tpu.obs.aggregate import reduce_shards as jreduce
    from dtc_tpu_torch.obs import reduce_shards

    _, obs = port_acceptance
    red, jred = reduce_shards(obs), jreduce(obs)
    assert red["serve"] == jred["serve"]
    assert red["serve"]["requests"] >= ACCEPT_N and red["serve"]["failover_hops"] >= 1
    assert red["serve"].get("ttft_p99_s") is not None
    keep = ("serve_requests", "ttft_p50_s", "ttft_p99_s", "ms_per_token_p99", "failover_hops")
    rows = {k: {f: h.get(f) for f in keep} for k, h in red["hosts"].items()}
    assert rows == {k: {f: h.get(f) for f in keep} for k, h in jred["hosts"].items()}
    assert sum(1 for k, h in rows.items() if int(k) < 3 and h["serve_requests"]) >= 2


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def test_fleet_cli_serves_dev_widths_on_the_cpu(capsys, tmp_path):
    """``python -m dtc_tpu_torch.serve.fleet --device cpu`` on the router
    config as written and the dev model: exit 0, every request done, the
    kill moved work, a shard for each replica and the router; without
    ``--device cpu`` and no card it refuses. The fleet runs on a tick
    clock, so the stall and the watchdog read no host time."""
    from dtc_tpu_torch.obs import find_shards
    from dtc_tpu_torch.serve.fleet import main

    args = ["--router_config_path", os.path.join(ROOT, "configs", "router_config.yaml"),
            "--model_config_path", os.path.join(ROOT, "configs", "model_config_dev.yaml"),
            "--requests", "6"]
    clk = TickClock()
    assert main(args + ["--device", "cpu", "--obs_dir", str(tmp_path)],
                clock=clk, sleep=clk.advance) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["done"] == 6 and out["failures"] == [] and out["hops_at"]
    assert out["summary"]["replica_deaths"] == 1 and out["routes"]["prefix_affinity"] >= 1
    assert sorted(find_shards(str(tmp_path))) == [0, 1, 2, 3]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(args)


def test_fleet_cli_open_loop_on_a_tick_clock(capsys, tmp_path):
    """``--rps``: the requests arrive on ``utils.arrivals``' Poisson
    schedule while the fleet steps, so they are routed over many router
    iterations, not at once; every accepted request ends DONE with its
    ``generate()`` tokens, the kill still moves work, and the record's
    percentiles are over the completed requests."""
    from dtc_tpu_torch.obs import read_jsonl, shard_path
    from dtc_tpu_torch.serve.fleet import main

    clk = TickClock()
    assert main(["--router_config_path", os.path.join(ROOT, "configs", "router_config.yaml"),
                 "--model_config_path", os.path.join(ROOT, "configs", "model_config_dev.yaml"),
                 "--requests", "8", "--rps", "2", "--max_new_tokens", "12", "--device", "cpu",
                 "--obs_dir", str(tmp_path)], clock=clk, sleep=clk.advance) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["failures"] == [] and out["done"] + len(out["rejected"]) == 8
    assert out["rps"] == 2 and out["max_new_tokens"] == 12 and out["n_timed"] == out["done"]
    assert out["summary"]["replica_deaths"] == 1 and out["hops_at"]
    assert 0 < out["ttft_p50_s"] <= out["ttft_p99_s"]
    routed_at = [e["iteration"] for e in read_jsonl(shard_path(str(tmp_path), 3))
                 if e["etype"] == "router_route"]
    assert len(set(routed_at)) >= 4, routed_at
