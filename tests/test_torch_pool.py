"""The resource pool in the port (``dtc_tpu_torch/pool/manager.py``,
``python -m dtc_tpu_torch.pool``, ``PoolConfig`` / ``load_pool_config``)
against the JAX package on the CPU, on fake clocks (no test reads the wall
clock for a decision):

- the typed state machine: the edge table and ``_advance``'s walk and
  refusals are JAX's;
- a GROW's restore: the next step's loss bit-equal to a fresh restart from
  the same snapshot, and no recompile (the eager port compiles nothing);
- ``tests/test_pool.py``'s combined chaos (a spike mid-grow, host 1 killed
  mid-shrink) on the same ``PoolConfig``, weights (``parity.from_flax``)
  and request: the same ``pool_transition`` sequence, leases, abort, kill
  and chaos events, and every request's terminal state and tokens as
  JAX's ``PoolManager`` (its run once a session under a file lock);
- cancel-retire, ``PoolConfig`` validation and ``load_pool_config`` against
  JAX's;
- the entry point: ``scripts/pool_smoke.py``'s config and model through
  ``python -m dtc_tpu_torch.pool`` exits as ``pool_smoke.py`` does, with
  JAX's transitions; ``configs/pool_config.yaml`` as written at the dev
  widths exits 0 (the trainer shrinks for the peak and grows after it),
  and with its documented chaos block exits 0 on a 40-step budget and 1 on
  the config's 12 (the chaos burst outlasts the budget, and no grow
  starts after it).
"""

import contextlib
import dataclasses
import io
import json
import os
import sys
import types

import numpy as np
import pytest

from dtc_tpu.config import schema as js
from dtc_tpu_torch.config import schema as ts
from tests.test_torch_router import FakeClock
from tests.test_torch_train import _one_thread  # noqa: F401  (autouse: one intra-op thread)

VOCAB = 61
TINY = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=2, d_ff=64, max_seq_len=32,
            dropout=0.0, param_dtype="float32", compute_dtype="float32", attention="dense")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POOL_ETYPES = ("pool_transition", "pool_grow_abort", "pool_host_killed", "pool_spike", "chaos")


def _pool_cfg(S, **kw):
    """``tests/test_pool.py``'s ``_pool_cfg`` in schema module ``S``."""
    kw.setdefault("router", S.RouterConfig(n_replicas=2, serve=S.ServeConfig(
        slots=2, page_size=8, queue_depth=8, max_new_tokens=4, prefill_bucket=8)))
    for k, v in dict(n_hosts=4, train_hosts=2, min_serve_hosts=0, min_train_hosts=1,
                     snapshot_every=1, grow_after_idle_ticks=1).items():
        kw.setdefault(k, v)
    return S.PoolConfig(**kw)


CHAOS = dict(enabled=True, pool_spike_mid_grow_at=1, pool_spike_requests=6,
             pool_kill_mid_shrink_at=1, elastic_target_host=1)


# ---------------------------------------------------------------------------
# the typed state machine
# ---------------------------------------------------------------------------

def test_transition_edge_table_is_jax():
    from dtc_tpu.pool.manager import _TRANSITION_EDGES as JEDGES
    from dtc_tpu_torch.pool.manager import _TRANSITION_EDGES

    assert _TRANSITION_EDGES == JEDGES
    assert not _TRANSITION_EDGES["steady"] and not _TRANSITION_EDGES["aborted"]


def _walk(manager, transition, registry):
    """Every edge walk of ``tests/test_pool.py``'s
    ``test_advance_walks_legal_edges_and_rejects_illegal_ones``: the states
    reached, the refusals, and the events emitted."""
    from dtc_tpu_torch.obs import MemorySink

    fake = types.SimpleNamespace(reg=registry(99), _tick=0)
    sink = fake.reg.add_sink(MemorySink())
    out = []

    def step(tr, state):
        try:
            manager._advance(fake, tr, state)
            out.append((tr.kind, tr.hosts, tr.state, tr.terminal))
        except RuntimeError as e:
            out.append(("refused", str(e)))

    tr = transition(kind="grow", hosts=[0], tick=0)
    for state in ("draining", "reassigned", "resized", "steady"):
        step(tr, state)
    step(transition(kind="shrink", hosts=[1], tick=0), "resized")
    step(tr, "aborted")
    for pre in ("requested", "draining", "reassigned", "resized"):
        step(transition(kind="grow", hosts=[2], tick=0, state=pre), "aborted")
    events = [{k: v for k, v in e.items() if k != "ts"} for e in sink.events]
    return out, events


def test_advance_walks_legal_edges_and_refuses_illegal_ones_as_jax():
    from dtc_tpu.obs.registry import MetricsRegistry as JRegistry
    from dtc_tpu.pool import PoolManager as JPool, PoolTransition as JTransition
    from dtc_tpu_torch.obs.registry import MetricsRegistry
    from dtc_tpu_torch.pool import PoolManager, PoolTransition

    got = _walk(PoolManager, PoolTransition, MetricsRegistry)
    want = _walk(JPool, JTransition, JRegistry)
    assert got == want
    assert sum(o[0] == "refused" for o in got[0]) == 3


# ---------------------------------------------------------------------------
# a GROW's restore
# ---------------------------------------------------------------------------

def test_grow_restore_is_bit_identical_to_a_fresh_restart():
    """``tests/test_pool.py::test_grow_restore_is_bit_identical_to_fresh_restart``:
    five steps on host 3, a grow onto hosts 2 and 3 (the step-5 snapshot,
    nothing to replay), and the next step's loss equals a fresh restart
    from the same snapshot (its own model, optimizer and generator) bit for
    bit; the tenant recompiled nothing. At dropout 0.1, so the snapshot's
    generator state counts."""
    from dtc_tpu_torch.obs.registry import MetricsRegistry
    from dtc_tpu_torch.pool.__main__ import fresh_restart_loss
    from dtc_tpu_torch.pool.manager import POOL_TRAIN_PROC, _TrainTenant
    from dtc_tpu_torch.resilience import VirtualHosts

    mcfg = ts.ModelConfig(**{**TINY, "dropout": 0.1})
    cfg = _pool_cfg(ts, train_hosts=1, train_steps=12)
    hosts = VirtualHosts(cfg.n_hosts)
    reg = MetricsRegistry(POOL_TRAIN_PROC)
    tenant = _TrainTenant(mcfg, cfg, hosts, {3}, reg, seed=0, device="cpu")
    try:
        for _ in range(5):
            tenant.step_once()
        info = tenant.resize({2, 3}, reason="pool_grow")
        assert info["to_step"] == 5 and tenant.mesh.shape["data"] == 4
        snap = tenant.last_restored
        pm = types.SimpleNamespace(trainer=tenant, model_cfg=mcfg, cfg=cfg, hosts=hosts)
        fresh = fresh_restart_loss(pm, snap)
        assert tenant.step_once() == fresh
        assert tenant.recompiles == 0
    finally:
        tenant.close()
        reg.close()


# ---------------------------------------------------------------------------
# combined chaos against JAX's PoolManager
# ---------------------------------------------------------------------------

def _pool_record(pm, results, events):
    return dict(
        events=[{k: v for k, v in e.items() if k != "ts"} for e in events
                if e["etype"] in POOL_ETYPES],
        serve_lease={str(k): v for k, v in sorted(pm.serve_lease.items())},
        train_lease=sorted(pm.train_lease), alive=sorted(pm.hosts.alive),
        transitions=[dict(kind=t.kind, hosts=t.hosts, state=t.state, to_step=t.to_step,
                          used_mirror=t.used_mirror, dead_hosts=t.dead_hosts,
                          abort_reason=t.abort_reason) for t in pm.transitions],
        results={rid: [r.state.value, list(r.tokens)] for rid, r in sorted(results.items())},
        train_steps=pm.trainer.cur_step, n_losses=len(pm.trainer.losses),
        recompiles=pm.trainer.recompiles)


def _drive(pm):
    ticks = 0
    while pm.tick() and ticks < 400:
        ticks += 1
    assert ticks < 400, "pool never drained"
    return pm.close()


@pytest.fixture(scope="session")
def jax_pool(tmp_path_factory):
    """JAX's ``PoolManager`` through ``tests/test_pool.py``'s combined chaos
    on a fake clock, once a session under a file lock: its record and the
    flax weights it served."""
    from filelock import FileLock

    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    out = base / "jax_pool_oracle"
    with FileLock(str(out) + ".lock"):
        if not (out / "done.json").exists():
            import jax
            import jax.numpy as jnp

            from dtc_tpu.models.gpt import GPT as JGPT
            from dtc_tpu.obs import read_jsonl
            from dtc_tpu.pool import PoolManager as JPool
            from dtc_tpu.serve import Request as JRequest
            from tests.test_torch_chaos import _flat

            out.mkdir(exist_ok=True)
            mcfg = js.ModelConfig(**TINY, adapter=js.AdapterConfig(rank=0))
            model = JGPT(mcfg)
            params = model.init({"params": jax.random.PRNGKey(0)},
                                jnp.ones((1, 1), jnp.int32), train=False)["params"]
            cfg = _pool_cfg(js, train_steps=12, chaos=js.ChaosConfig(**CHAOS))
            clock = FakeClock()
            pm = JPool(model, params, mcfg, cfg, obs_dir=str(out / "obs"), seed=0,
                       clock=clock, sleep=clock.advance)
            pm.submit(JRequest(rid="low0", prompt=[1, 2, 3], max_new_tokens=4))
            results = _drive(pm)
            events = [e for p in sorted((out / "obs").glob("events.r*.jsonl"))
                      for e in read_jsonl(str(p))]
            np.savez(out / "params.npz", **{"/".join(k): np.asarray(v)
                                            for k, v in _flat(params).items()})
            (out / "done.json").write_text(json.dumps(_pool_record(pm, results, events)))
    from tests.test_torch_chaos import _unflat

    return json.loads((out / "done.json").read_text()), _unflat(dict(np.load(out / "params.npz")))


def test_combined_chaos_equals_jax(tmp_path, jax_pool):
    """The spike lands in the first (pre-resize) grow, which aborts; host 1
    dies inside the shrink the spike's pressure asks for and is never
    leased again; every request (the burst's included) ends typed with
    JAX's tokens; the training budget completes. Transition by transition,
    lease by lease and event by event the port's pool is JAX's, and it
    recompiled nothing where JAX recompiled once a mesh change."""
    from dtc_tpu_torch.models.gpt import GPT
    from dtc_tpu_torch.obs import read_jsonl
    from dtc_tpu_torch.parity import from_flax
    from dtc_tpu_torch.pool import PoolManager
    from dtc_tpu_torch.serve import Request

    want, params = jax_pool
    mcfg = ts.ModelConfig(**TINY)
    model = GPT(mcfg, device="cpu")
    model.load_state_dict(from_flax(params, mcfg))
    cfg = _pool_cfg(ts, train_steps=12, chaos=ts.ChaosConfig(**CHAOS))
    clock = FakeClock()
    pm = PoolManager(model, mcfg, cfg, obs_dir=str(tmp_path), seed=0, clock=clock,
                     sleep=clock.advance)
    pm.submit(Request(rid="low0", prompt=[1, 2, 3], max_new_tokens=4))
    results = _drive(pm)
    events = [e for p in sorted(tmp_path.glob("events.r*.jsonl")) for e in read_jsonl(str(p))]
    got = json.loads(json.dumps(_pool_record(pm, results, events)))
    assert got["recompiles"] == 0 and want["recompiles"] == len(
        [t for t in want["transitions"] if t["to_step"] is not None])
    for key in ("transitions", "serve_lease", "train_lease", "alive", "results",
                "train_steps", "n_losses", "events"):
        assert got[key] == want[key], key
    kinds = [t["state"] for t in got["transitions"]]
    assert "aborted" in kinds and any(t["dead_hosts"] for t in got["transitions"])
    assert len(got["results"]) == 1 + CHAOS["pool_spike_requests"]


def test_cancel_retire_restores_healthy():
    """A grow's abort mid-drain walks DRAINING -> HEALTHY, and the replica
    serves again; cancelling a replica that is not draining raises."""
    from dtc_tpu_torch.models.gpt import GPT
    from dtc_tpu_torch.serve import FleetRouter, ReplicaState, Request

    model = GPT(ts.ModelConfig(**TINY), device="cpu")
    clock = FakeClock()
    router = FleetRouter(model, ts.RouterConfig(n_replicas=2, serve=ts.ServeConfig(
        slots=1, page_size=4, queue_depth=4, max_new_tokens=4, prefill_bucket=8)),
        clock=clock, sleep=clock.advance)
    try:
        rep = router.replicas[0]
        with pytest.raises(ValueError):
            router.cancel_retire(0)
        router.begin_retire(0, reason="pool_grow")
        assert rep.state is ReplicaState.DRAINING and not rep.accepting
        router.cancel_retire(0, reason="pool_grow_abort")
        assert rep.state is ReplicaState.HEALTHY and rep.accepting
        router.submit(Request(rid="a", prompt=[1, 2, 3], max_new_tokens=2))
        router.run()
        assert router.results["a"].state.value == "done"
    finally:
        router.close()


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(min_train_hosts=0), dict(min_serve_hosts=1, train_hosts=4), dict(min_serve_hosts=-1),
    dict(model_axis=0), dict(snapshot_keep=1), dict(grow_after_idle_ticks=0),
    dict(chaos=CHAOS | dict(elastic_target_host=4)), dict(min_serve_hosts=0), dict(),
])
def test_pool_config_validates_as_jax(kw):
    """The same settings raise the same ``ValueError`` in both packages;
    the rest (a zero serve floor included) load."""
    out = []
    for S in (ts, js):
        args = {k: (S.ChaosConfig(**v) if k == "chaos" else v) for k, v in kw.items()}
        try:
            out.append(("ok", dataclasses.asdict(_pool_cfg(S, **args))))
        except ValueError as e:
            out.append(("error", str(e)))
    assert out[0] == out[1]


def test_load_pool_config_equals_jax():
    from dtc_tpu.config.loader import load_pool_config as jload
    from dtc_tpu_torch.config.loader import load_pool_config

    path = os.path.join(ROOT, "configs", "pool_config.yaml")
    got, want = load_pool_config(path), jload(path)
    assert dataclasses.asdict(got[0]) == dataclasses.asdict(want[0])
    assert dataclasses.asdict(got[1]) == dataclasses.asdict(want[1])
    over = load_pool_config(path, pool_overrides={"train_steps": 40})[0]
    assert over.train_steps == 40 and over.router == got[0].router


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

SMOKE_POOL = """\
n_hosts: 4
train_hosts: 2
min_serve_hosts: 0
min_train_hosts: 1
global_batch: 8
train_steps: 30
snapshot_every: 1
snapshot_keep: 4
grow_after_idle_ticks: 1
spike_queue_depth: 3
router:
  n_replicas: 2
  serve:
    slots: 2
    page_size: 8
    queue_depth: 8
    max_new_tokens: 4
    prefill_bucket: 8
"""
SMOKE_MODEL = "".join(f"{k}: {v}\n" for k, v in TINY.items())


@pytest.fixture(scope="session")
def jax_pool_smoke(tmp_path_factory):
    """``scripts/pool_smoke.py``'s diurnal leg in this process (JAX's 8
    CPU devices), once a session under a file lock: its exit code and the
    transitions it printed."""
    from filelock import FileLock

    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    out = base / "jax_pool_smoke_oracle"
    with FileLock(str(out) + ".lock"):
        if not (out / "done.json").exists():
            sys.path.insert(0, os.path.join(ROOT, "scripts"))
            try:
                import pool_smoke
            finally:
                sys.path.remove(os.path.join(ROOT, "scripts"))
            buf = io.StringIO()
            argv = sys.argv
            sys.argv = ["pool_smoke.py"]
            try:
                with contextlib.redirect_stdout(buf):
                    try:
                        rc = pool_smoke.main()
                    except AssertionError:
                        rc = 1
            finally:
                sys.argv = argv
            line = next(x for x in buf.getvalue().splitlines() if "transitions OK" in x)
            out.mkdir(exist_ok=True)
            (out / "done.json").write_text(json.dumps(dict(
                rc=rc, transitions=line.split("(", 1)[1].rstrip(")"))))
    return json.loads((out / "done.json").read_text())


def _entry(tmp_path, pool_text, model_text, *extra):
    from dtc_tpu_torch.pool.__main__ import main

    (tmp_path / "pool.yaml").write_text(pool_text)
    (tmp_path / "model.yaml").write_text(model_text)
    clock = FakeClock()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["--pool_config_path", str(tmp_path / "pool.yaml"), "--model_config_path",
                   str(tmp_path / "model.yaml"), "--device", "cpu", *extra],
                  clock=clock, sleep=clock.advance)
    return rc, json.loads(buf.getvalue().splitlines()[-1])


def test_entry_point_exits_as_pool_smoke_does(tmp_path, jax_pool_smoke):
    """``scripts/pool_smoke.py``'s pool config and model through the entry
    point: the same exit code, the same walk of transitions (grow, shrink,
    shrink, grow), every check passed."""
    rc, rec = _entry(tmp_path, SMOKE_POOL, SMOKE_MODEL)
    assert rc == jax_pool_smoke["rc"] == 0, rec["failures"]
    got = str([t["kind"] + ":" + t["state"] for t in rec["transitions"]])
    assert got == jax_pool_smoke["transitions"]
    oracles = rec["day"]["grow_oracles"]
    assert oracles and all(o["loss"] == o["fresh"] for o in oracles)


def _dev_model_text():
    return open(os.path.join(ROOT, "configs", "model_config_dev.yaml")).read()


def test_entry_point_runs_pool_config_as_written(tmp_path):
    """``configs/pool_config.yaml`` as written at the dev widths: the pool
    cannot grow from its first lease (one serving host to spare, and 3
    hosts of 2 devices do not divide the batch of 8), so the peak comes
    first, the trainer shrinks for it and grows in the trough after; the
    losses equal the uninterrupted run's and the grow's first step a fresh
    restart's bit for bit."""
    pool = open(os.path.join(ROOT, "configs", "pool_config.yaml")).read()
    rc, rec = _entry(tmp_path, pool, _dev_model_text())
    assert rc == 0, rec["failures"]
    assert [(t["kind"], t["state"]) for t in rec["transitions"]] == [
        ("shrink", "steady"), ("grow", "steady")]
    assert rec["losses"] == rec["reference"] and len(rec["losses"]) == 12
    assert all(o["loss"] == o["fresh"] for o in rec["day"]["grow_oracles"])


@pytest.mark.parametrize("steps,rc_want", [(None, 1), (40, 0)])
def test_entry_point_chaos_day_needs_a_longer_budget(tmp_path, steps, rc_want):
    """``pool_config.yaml`` with its documented chaos block: host 1 dies
    inside the shrink, the spike aborts the first grow; over 40 steps a
    second grow reaches steady and every check passes, while the config's
    12 end before the spike's requests are served, and no grow may start
    after the budget, so the check of a steady grow fails (exit 1)."""
    pool = open(os.path.join(ROOT, "configs", "pool_config.yaml")).read()
    extra = ("--chaos",) + (() if steps is None else ("--train_steps", str(steps)))
    rc, rec = _entry(tmp_path, pool, _dev_model_text(), *extra)
    assert rc == rc_want, rec["failures"]
    states = [(t["kind"], t["state"]) for t in rec["transitions"]]
    assert states[0] == ("shrink", "steady") and rec["transitions"][0]["dead_hosts"] == [1]
    if rc_want == 0:
        assert states[1:] == [("grow", "aborted"), ("grow", "steady")]
    else:
        assert any("no steady grow" in f for f in rec["failures"])
    assert set(rec["states"].values()) == {"done"}
