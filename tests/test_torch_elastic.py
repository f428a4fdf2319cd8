"""Elastic training in the port (``dtc_tpu_torch/resilience/elastic.py``,
``resilience/snapshot.py``, the trainer's elastic path,
``Telemetry.on_elastic``) against the JAX package on the CPU.

- The pieces: ``VirtualHosts`` (split, kill, revive, ``ring_next``);
  ``HostMonitor`` on scripted beat schedules (loss, straggler, stall
  escalation, a kill before the first tick, hosts dead at start, admit and
  retire) giving JAX's event list; ``resize_mesh`` giving JAX's shapes,
  devices and ``ElasticAbort`` cases; the snapshot store on JAX's test
  state (an FSDP-sharded leaf and a replicated one over 8 devices in 2
  hosts): the primary/mirror layout and ``recovery_set`` JAX's, a restore
  through the mirror onto a smaller lease, commits after a kill incomplete
  and skipped, a flipped byte failing its hash, ``drop_primary`` forcing
  the mirror, the double-buffer skip.
- The trainer, as ``tests/test_elastic.py`` runs JAX's (``parallel:
  fsdp``, 2 hosts of 4 virtual devices, vocab 97, d_model 64, 4 layers,
  T 32, float32, dense): host 0 killed at step 6 against JAX's ``train()``
  on the same weights at dropout 0 (the prefix within 2e-4, the rest
  within JAX's own 1e-3, the same ``host_lost`` / ``elastic_resize`` /
  ``elastic_spill`` / incomplete ``snapshot`` events), and at dropout 0.1
  against the port's own clean run bit for bit (this process computes the
  global batch whole on any mesh; the dropout generator rides in the
  snapshot), with a shrunk restart from the spill replaying the
  post-resize losses bit for bit; the straggler; a lost snapshot with a
  torn spill; the NaN rollback from the hot tier; JAX's shard reducer and
  Perfetto exporter over the port's shard; the elastic ``ValueError``s;
  ``train_config_dev_chaos.yaml`` with elastic on through the command
  line.

JAX's run is shared by its tests through one fixture, run once a session
under a file lock.
"""

import dataclasses
import glob
import json
import os
import threading

import numpy as np
import pytest
import torch

from dtc_tpu.config import schema as js
from dtc_tpu_torch.config import schema as ts
from dtc_tpu_torch.config.loader import _build
from dtc_tpu_torch.resilience import (
    ElasticAbort,
    HostMonitor,
    RedundancyPlan,
    SnapshotIncompleteError,
    SnapshotStore,
    VirtualHosts,
    VirtualMesh,
    resize_mesh,
    shrink_mesh,
)
from dtc_tpu_torch.train import trainer as trainer_mod
from tests.test_torch_train import _one_thread  # noqa: F401  (autouse: one intra-op thread)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


# ---------------------------------------------------------------------------
# virtual hosts and the heartbeat monitor against JAX's
# ---------------------------------------------------------------------------

def _jax_hosts(n):
    from dtc_tpu.resilience.elastic import VirtualHosts as JHosts

    return JHosts(n)


def test_virtual_hosts_split_kill_revive_and_ring_equal_jax():
    port, ref = VirtualHosts(2), _jax_hosts(2)
    assert port.per_host == ref.per_host == 4
    assert [port.host_of(d) for d in port.devices] == [ref.host_of(d) for d in ref.devices]
    assert [port.ring_next(h) for h in range(2)] == [ref.ring_next(h) for h in range(2)]
    for hosts in (port, ref):
        hosts.kill(0)
    assert port.alive == ref.alive == {1}
    assert port.survivor_devices() == [d.id for d in ref.survivor_devices()]
    assert port.devices_of(1) == [d.id for d in ref.devices_of(1)]
    for hosts in (port, ref):
        hosts.revive(0)
        with pytest.raises(ValueError, match="outside pool"):
            hosts.revive(2)
    assert port.alive == ref.alive == {0, 1}
    with pytest.raises(ValueError, match="do not split"):
        VirtualHosts(3)
    with pytest.raises(ValueError, match=">= 2"):
        VirtualHosts(1)
    assert VirtualHosts(4, 16).per_host == 4


# Scripted schedules: (n_hosts, miss_limit, ops); an op is ("tick", step),
# ("poll", step, stalled), ("kill"|"revive"|"retire", host),
# ("slow", host, until_step) or ("admit", host, step).
SCHEDULES = {
    "loss_and_straggler": (2, 2, [
        ("tick", 1), ("poll", 1, False), ("slow", 1, 2), ("tick", 2), ("poll", 2, False),
        ("tick", 3), ("poll", 3, False), ("kill", 0), ("tick", 4), ("poll", 4, False),
        ("tick", 5), ("poll", 5, False), ("poll", 6, False)]),
    "stall_escalates": (2, 3, [
        ("tick", 1), ("kill", 1), ("tick", 2), ("poll", 2, True)]),
    "kill_before_first_tick": (2, 2, [
        ("kill", 0), ("tick", 1), ("tick", 2), ("poll", 2, False)]),
    "dead_at_start": (2, 1, [
        ("tick", 1), ("poll", 1, False), ("tick", 2), ("poll", 2, False)]),
    "regrow_then_kill": (4, 2, [
        ("retire", 3), ("tick", 1), ("poll", 1, False), ("tick", 2), ("poll", 2, False),
        ("admit", 3, 2), ("kill", 2), ("tick", 3), ("tick", 4), ("poll", 4, False),
        ("revive", 2), ("admit", 2, 5), ("kill", 3), ("tick", 5), ("tick", 6),
        ("poll", 6, False)]),
    "retire_is_not_death": (4, 2, [("tick", 1), ("retire", 0)] + [
        op for s in range(2, 8) for op in (("tick", s), ("poll", s, False))]),
}


def _run_schedule(hosts, monitor_cls, abort_cls, miss, ops, dead_at_start):
    for h in dead_at_start:
        hosts.kill(h)
    mon = monitor_cls(hosts, miss_limit=miss)
    out = []
    for op in ops:
        kind, *args = op
        if kind == "tick":
            mon.tick(args[0])
        elif kind == "poll":
            out.append(("poll", args[0], mon.poll(args[0], stalled=args[1])))
        elif kind == "slow":
            mon.mark_slow(*args)
        elif kind == "admit":
            try:
                mon.admit(args[0], step=args[1])
            except abort_cls as e:
                out.append(("abort", str(e)))
        else:
            getattr(hosts if kind in ("kill", "revive") else mon, kind)(args[0])
    return out + [("lost", sorted(mon.lost))]


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_host_monitor_gives_jax_events_on_a_schedule(case):
    """The same beat schedule through the port's monitor and JAX's: the
    same ``host_lost`` / ``host_slow`` dicts in the same order, the same
    refused admissions (a grow never resurrects a host declared lost),
    the same lost set."""
    from dtc_tpu.resilience.elastic import HostMonitor as JMonitor
    from dtc_tpu.resilience.errors import ElasticAbort as JAbort

    n, miss, ops = SCHEDULES[case]
    dead = (0,) if case == "dead_at_start" else ()
    got = _run_schedule(VirtualHosts(n), HostMonitor, ElasticAbort, miss, ops, dead)
    want = _run_schedule(_jax_hosts(n), JMonitor, JAbort, miss, ops, dead)
    assert got == want
    kinds = [e["kind"] for step in got if step[0] == "poll" for e in step[2]]
    if case in ("loss_and_straggler", "regrow_then_kill", "kill_before_first_tick",
                "stall_escalates"):
        assert "host_lost" in kinds
    if case in ("dead_at_start", "retire_is_not_death"):
        assert kinds == []


# ---------------------------------------------------------------------------
# resize_mesh against JAX's
# ---------------------------------------------------------------------------

def _resize_both(shape, kills, target):
    from dtc_tpu.parallel.mesh import build_mesh
    from dtc_tpu.resilience.elastic import resize_mesh as jresize
    from dtc_tpu.resilience.errors import ElasticAbort as JAbort

    out = []
    for hosts, mesh, resize, abort in (
            (VirtualHosts(2), VirtualMesh(shape, range(int(np.prod(shape)))), resize_mesh,
             ElasticAbort),
            (_jax_hosts(2), build_mesh(shape), jresize, JAbort)):
        for h in kills:
            hosts.kill(h)
        try:
            m = resize(mesh, hosts, target_hosts=target)
            out.append((dict(m.shape), [int(getattr(d, "id", d)) for d in np.ravel(
                np.asarray(m.devices, dtype=object))]))
        except abort as e:
            out.append(("abort", str(e)))
    return out


@pytest.mark.parametrize("shape,kills,target", [
    ((1, 4, 2), (1,), None),
    ((1, 8, 1), (0,), None),
    ((1, 8, 1), (), {1}),
    ((1, 4, 2), (), {0, 1}),
    ((1, 1, 8), (0,), None),
    ((2, 4, 1), (0,), None),
    ((1, 8, 1), (0, 1), None),
    ((1, 8, 1), (1,), {0, 1}),
])
def test_resize_mesh_equals_jax(shape, kills, target):
    """SHRINK over the survivors and GROW over an explicit lease: the same
    mesh shape over the same devices as JAX's, and the same
    ``ElasticAbort`` (a broken model axis, a pipeline, no survivor, a dead
    target)."""
    got, want = _resize_both(shape, kills, target)
    assert got == want
    hosts = VirtualHosts(2)
    hosts.kill(1)
    assert shrink_mesh(VirtualMesh((1, 4, 2), range(8)), hosts).shape == {
        "pipe": 1, "data": 2, "model": 2}


# ---------------------------------------------------------------------------
# the snapshot store on JAX's test state
# ---------------------------------------------------------------------------

def _state():
    return ({"w": torch.arange(32, dtype=torch.float32).reshape(8, 4),
             "b": torch.full((4,), 7.0)}, {"w": ("data", None)})


def _store(**kw):
    hosts = VirtualHosts(2)
    events = []
    store = SnapshotStore(hosts, keep=4, on_event=lambda et, **f: events.append((et, f)), **kw)
    return hosts, store, events, VirtualMesh((1, 8, 1), range(8))


def _jax_snapshot():
    """JAX's store on ``tests/test_elastic.py``'s ``_fsdp_state``."""
    from dtc_tpu.parallel.mesh import build_mesh
    from dtc_tpu.resilience import SnapshotStore as JStore
    from tests.test_elastic import _fsdp_state

    store = JStore(_jax_hosts(2), keep=4)
    try:
        assert store.begin(1, _fsdp_state(build_mesh((1, 8, 1))))
        store.drain()
        return store.latest()
    finally:
        store.close()


def _layout(tiers):
    return {h: {p: sorted(shards) for p, shards in store.items()} for h, store in tiers.items()}


def test_snapshot_layout_and_recovery_set_equal_jax():
    """The FSDP leaf's shards per host, the ring mirror, the redundancy
    kinds and the minimal surviving reads for every alive set: JAX's."""
    from dtc_tpu.resilience import RedundancyPlan as JPlan

    hosts, store, events, mesh = _store()
    try:
        state, specs = _state()
        assert store.begin(1, state, mesh, specs)
        store.drain()
        snap, ref = store.latest(), _jax_snapshot()
        assert snap.step == 1 and snap.complete and events[0][0] == "snapshot"
        assert events[0][1]["sha256"] == snap.sha256[:16]
        assert _layout(snap.primary) == _layout(ref.primary)
        assert _layout(snap.mirror) == _layout(ref.mirror)
        assert set(snap.shard_sha) == set(ref.shard_sha)
        plan, jplan = RedundancyPlan.from_snapshot(snap), JPlan.from_snapshot(ref)
        assert plan.kind == jplan.kind == {"w": "sharded", "b": "replicated"}
        for alive in ({0, 1}, {1}, {0}):
            assert plan.recovery_set(snap, alive) == jplan.recovery_set(ref, alive)
    finally:
        store.close()


def test_snapshot_restores_through_the_mirror_onto_a_smaller_lease():
    hosts, store, _, mesh = _store()
    try:
        state, specs = _state()
        store.begin(1, state, mesh, specs)
        store.drain()
        hosts.kill(0)
        small = shrink_mesh(mesh, hosts)
        restored, used_mirror = store.restore(store.latest(), hosts.alive)
        assert used_mirror, "host 0's shards come from the ring mirror"
        assert all(torch.equal(restored[k], state[k]) for k in state)
        assert small.shape["data"] == 4
    finally:
        store.close()


def test_snapshot_commits_after_a_kill_are_incomplete_and_skipped():
    hosts, store, events, mesh = _store()
    try:
        state, specs = _state()
        store.begin(1, state, mesh, specs)
        store.drain()
        hosts.kill(0)
        assert store.begin(2, state, mesh, specs)
        store.drain()
        assert store.latest().step == 1
        assert events[-1][1]["complete"] is False
    finally:
        store.close()


def test_snapshot_flipped_byte_fails_its_hash():
    """One flipped byte in host 0's copy of a shard: the restore rejects it
    and heals from the mirror; flipped in the mirror too, a typed error."""
    hosts, store, _, mesh = _store()
    try:
        state, specs = _state()
        store.begin(1, state, mesh, specs)
        store.drain()
        snap = store.latest()
        key = next(iter(snap.primary[0]["w"]))

        def flip(tier):
            bad = tier["w"][key].copy()
            bad.view(np.uint8)[0] ^= 1
            tier["w"][key] = bad

        flip(snap.primary[0])
        restored, used_mirror = store.restore(snap, {0, 1})
        assert used_mirror and torch.equal(restored["w"], state["w"])
        for h in snap.mirror:
            if key in snap.mirror[h].get("w", {}):
                flip(snap.mirror[h])
        with pytest.raises(SnapshotIncompleteError, match="integrity"):
            store.restore(snap, {0, 1})
    finally:
        store.close()


def test_snapshot_drop_primary_forces_the_mirror():
    hosts, store, _, mesh = _store()
    try:
        state, specs = _state()
        store.begin(1, state, mesh, specs)
        assert store.drop_primary(0)
        restored, used_mirror = store.restore(store.latest(), {0, 1})
        assert used_mirror and torch.equal(restored["w"], state["w"])
    finally:
        store.close()


def test_snapshot_double_buffer_skips_instead_of_queueing():
    hosts, store, _, mesh = _store()
    gate = threading.Event()
    orig = store._commit

    def slow_commit(*a, **k):
        gate.wait(timeout=10.0)
        orig(*a, **k)

    store._commit = slow_commit
    try:
        state, specs = _state()
        assert store.begin(1, state, mesh, specs)
        assert store.begin(2, state, mesh, specs)
        assert not store.begin(3, state, mesh, specs), "a third tick is skipped"
        assert store.skipped == 1
        gate.set()
        store.drain()
        assert store.latest().step == 2
        assert store.begin(4, state, mesh, specs)
        store.drain()
        assert store.latest().step == 4
    finally:
        gate.set()
        store.close()


def test_snapshot_holds_the_state_of_its_step_in_every_dtype():
    """The snapshot is the state at ``begin``: an in-place update after it
    (the optimizer's) does not reach it; bfloat16, an integer count and a
    generator state come back with their dtype and bits."""
    hosts, store, _, mesh = _store()
    try:
        gen = torch.Generator().manual_seed(3)
        torch.rand(5, generator=gen)
        state = {"p": torch.randn(8, 3).to(torch.bfloat16), "count": 7,
                 "rng": gen.get_state()}
        want = {k: torch.as_tensor(v).clone() for k, v in state.items()}
        store.begin(5, state, mesh, {"p": ("data", None)})
        state["p"].add_(1)
        store.drain()
        got, _ = store.restore(store.latest(), {0, 1})
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
    finally:
        store.close()


# ---------------------------------------------------------------------------
# the trainer against JAX's train()
# ---------------------------------------------------------------------------

TINY = dict(vocab_size=97, d_model=64, n_layers=4, n_heads=4, d_ff=128, max_seq_len=32,
            param_dtype="float32", compute_dtype="float32", attention="dense")
OPT = dict(lr=1e-3, weight_decay=0.1, grad_clip=1.0)
KILL = dict(enabled=True, kill_host_at_step=6, elastic_target_host=0)
ELASTIC_ETYPES = ("host_lost", "host_slow", "elastic_resize", "elastic_spill", "chaos")


def _cfg(out, *, chaos=None, elastic=None, resume=False, ckpt=None, **kw):
    """``tests/test_elastic.py``'s ``_elastic_cfg`` (a JAX TrainConfig)."""
    from tests.conftest import make_train_cfg

    el = elastic or js.ElasticConfig(enabled=True, snapshot_every=1, keep=4, n_virtual_hosts=2)
    defaults = dict(steps=8, warmup_steps=1, log_every=2, checkpoint_every=100,
                    output_dir=str(out), checkpoint_dir=ckpt or str(out) + "_ckpt")
    defaults.update(kw)
    cfg = make_train_cfg("fsdp", **defaults)
    return dataclasses.replace(cfg, resume=resume, resilience=js.ResilienceConfig(
        elastic=el, chaos=js.ChaosConfig(**(chaos or {}))))


def _events(output_dir):
    out = []
    for p in sorted(glob.glob(os.path.join(output_dir, "obs", "*.jsonl"))):
        with open(p) as f:
            out += [json.loads(line) for line in f if line.strip()]
    return out


def _trace(events):
    """The elastic events without their wall-clock stamps."""
    return [{k: v for k, v in e.items() if k not in ("ts", "t_detect", "t_restored")}
            for e in events if e["etype"] in ELASTIC_ETYPES]


@pytest.fixture(scope="session")
def jax_kill(tmp_path_factory):
    """JAX's ``train()`` with host 0 killed at step 6 (dropout 0), once a
    session under a file lock: its losses, its elastic events and snapshot
    completeness flags, and the flax init."""
    from filelock import FileLock

    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    out = base / "jax_elastic_oracle"
    with FileLock(str(out) + ".lock"):
        if not (out / "done.json").exists():
            from dtc_tpu.train.trainer import train as jtrain
            from tests.test_torch_chaos import _flat
            from tests.test_torch_train import _flax_params

            out.mkdir(exist_ok=True)
            mcfg = js.ModelConfig(**TINY, dropout=0.0)
            res = jtrain(_cfg(out / "kill", chaos=KILL), mcfg, js.OptimConfig(**OPT))
            np.savez(out / "init.npz", **{"/".join(k): v for k, v in _flat(
                _flax_params(mcfg)).items()})
            events = _events(str(out / "kill"))
            (out / "done.json").write_text(json.dumps(dict(
                losses=res.losses, trace=_trace(events), mesh=dict(res.mesh.shape),
                incomplete=[e["step"] for e in events
                            if e["etype"] == "snapshot" and e["complete"] is False])))
    from tests.test_torch_chaos import _unflat

    return json.loads((out / "done.json").read_text()), _unflat(dict(np.load(out / "init.npz")))


def _port(cls, cfg):
    return _build(cls, dataclasses.asdict(cfg), "test")


def _run(cfg, dropout=0.0, params=None):
    return trainer_mod.train(_port(ts.TrainConfig, cfg), ts.ModelConfig(**TINY, dropout=dropout),
                             ts.OptimConfig(**OPT), device="cpu", params=params)


def test_kill_host_shrinks_and_continues_as_jax_does(tmp_path, jax_kill):
    """``tests/test_elastic.py::test_kill_host_shrinks_and_continues_with_parity``
    in the port, at dropout 0 on JAX's weights: host 0 stops beating at
    step 6, is declared lost at 7 by heartbeats alone, the step-5 snapshot
    comes back through the ring mirror onto 4 devices and the run finishes
    its 8 steps; the losses are JAX's (the prefix within 2e-4, the rest
    within JAX's own 1e-3), and so are the elastic events, the snapshot
    taken after the kill incomplete. No kernel library is built and
    nothing recompiles (JAX records one recompile at step 6)."""
    want, init = jax_kill
    got = _run(_cfg(tmp_path / "kill", chaos=KILL), params=init)
    assert len(got.losses) == 8 and got.mesh.shape == want["mesh"] == {
        "pipe": 1, "data": 4, "model": 1}
    np.testing.assert_allclose(got.losses[:5], want["losses"][:5], rtol=2e-4)
    np.testing.assert_allclose(got.losses[5:], want["losses"][5:], rtol=1e-3, atol=1e-5)
    events = _events(str(tmp_path / "kill"))
    assert _trace(events) == want["trace"]
    rz = next(e for e in events if e["etype"] == "elastic_resize")
    assert (rz["to_step"], rz["tier"], rz["used_mirror"], rz["devices"]) == (5, "memory", True, 4)
    incomplete = [e["step"] for e in events if e["etype"] == "snapshot" and not e["complete"]]
    assert incomplete and set(incomplete) <= set(want["incomplete"]) | {6, 7}
    assert not any(e["etype"] == "recompile" for e in events)
    assert not any(e["etype"] == "aux_compile" and e["what"] == "elastic_resize"
                   for e in events)


def test_kill_host_replays_the_clean_run_bit_for_bit(tmp_path):
    """At dropout 0.1 the killed run's losses are the port's clean elastic
    run's bit for bit (the resize restores the parameters, the moments,
    the count and the dropout generator; the global batch is computed whole
    on either mesh), and a shrunk restart (``dead_hosts: [0]``, resume)
    from the resize's spill replays the post-resize losses bit for bit,
    with no host re-detected."""
    clean = _run(_cfg(tmp_path / "clean"), dropout=0.1)
    kill = _run(_cfg(tmp_path / "kill", chaos=KILL), dropout=0.1)
    assert kill.losses == clean.losses and len(clean.losses) == 8
    el = js.ElasticConfig(enabled=True, snapshot_every=1, keep=4, n_virtual_hosts=2,
                          dead_hosts=(0,))
    replay = _run(_cfg(tmp_path / "replay", elastic=el, resume=True,
                       ckpt=str(tmp_path / "kill_ckpt")), dropout=0.1)
    assert replay.losses == kill.losses[5:]
    assert replay.mesh.shape["data"] == 4
    assert not any(e["etype"] == "host_lost" for e in _events(str(tmp_path / "replay")))


def test_straggler_is_flagged_not_killed(tmp_path):
    clean = _run(_cfg(tmp_path / "clean"), dropout=0.1)
    got = _run(_cfg(tmp_path / "slow", chaos=dict(
        enabled=True, slow_host_at_step=4, slow_host_iters=1, elastic_target_host=1)),
        dropout=0.1)
    assert got.losses == clean.losses
    events = _events(str(tmp_path / "slow"))
    slow = [e for e in events if e["etype"] == "host_slow"]
    assert len(slow) == 1 and slow[0]["host"] == 1
    assert not any(e["etype"] in ("host_lost", "elastic_resize") for e in events)
    assert got.mesh.shape["data"] == 8


def test_lost_snapshot_and_torn_spill_fall_back_verified(tmp_path):
    """The victim's snapshot memory lost at the kill (the restore takes the
    ring mirror, hash-checked) and the spill torn mid-write (a later
    restore rejects it): the run still equals the clean one bit for bit."""
    from dtc_tpu_torch.utils.checkpoint import CheckpointManager

    clean = _run(_cfg(tmp_path / "clean"), dropout=0.1)
    cfg = _cfg(tmp_path / "torn", chaos=dict(
        enabled=True, kill_host_at_step=5, lose_snapshot_at_step=5,
        torn_cold_spill_at_step=4, elastic_target_host=0))
    got = _run(cfg, dropout=0.1)
    assert got.losses == clean.losses
    events = _events(cfg.output_dir)
    assert {e["kind"] for e in events if e["etype"] == "chaos"} == {
        "kill_host", "lose_snapshot", "torn_cold_spill"}
    rz = [e for e in events if e["etype"] == "elastic_resize"]
    assert len(rz) == 1 and rz[0]["tier"] == "memory" and rz[0]["used_mirror"]
    assert rz[0]["to_step"] == 4
    assert CheckpointManager(cfg.checkpoint_dir, verify=True).latest_step() != 4


def test_nan_rollback_restores_the_hot_tier_below_the_healthy_boundary(tmp_path):
    """NaN after step 5's update, windows of 2: the anomaly shows at the
    step-6 boundary, whose last healthy boundary is 4; the snapshot AT 4
    holds an update no loss has vouched for, so the rollback takes step
    3's from memory (no cold checkpoint exists), and the replay equals the
    clean run bit for bit."""
    clean = _run(_cfg(tmp_path / "clean"), dropout=0.1)
    got = _run(_cfg(tmp_path / "nan", chaos=dict(enabled=True, nan_at_step=5)), dropout=0.1)
    assert got.losses == clean.losses
    events = _events(str(tmp_path / "nan"))
    rb = next(e for e in events if e["etype"] == "recovery" and e["action"] == "rollback")
    assert rb["tier"] == "memory" and rb["to_step"] == 3
    assert not any(e["etype"] in ("host_lost", "elastic_resize") for e in events)


def test_the_port_shard_reads_in_jax_reducer_and_perfetto(tmp_path):
    from dtc_tpu.obs.aggregate import reduce_shards
    from dtc_tpu.obs.trace import to_chrome_trace

    cfg = _cfg(tmp_path / "obs", chaos=dict(enabled=True, kill_host_at_step=6,
                                            elastic_target_host=1))
    _run(cfg)
    reduced = reduce_shards(os.path.join(cfg.output_dir, "obs"))
    el = reduced["elastic"]
    assert el["snapshots"] >= 5 and [h["host"] for h in el["hosts_lost"]] == [1]
    assert len(el["resizes"]) == 1 and el["resizes"][0]["tier"] == "memory"
    assert el["spills"] == 1
    names = {e["name"] for e in to_chrome_trace(_events(cfg.output_dir))["traceEvents"]}
    assert {"snapshot", "host_lost", "elastic_resize"} <= names


@pytest.mark.parametrize("case", ["fineweb", "pipeline", "lora", "processes", "batch"])
def test_elastic_raises_jax_value_errors(case):
    """What JAX's trainer refuses under elastic, the port refuses with the
    same ``ValueError``: a dataset other than synthetic, a pipeline, a LoRA
    finetune, more than one process, a batch the data axis does not
    divide."""
    from tests.conftest import make_train_cfg

    el = js.ResilienceConfig(elastic=js.ElasticConfig(enabled=True))
    mcfg = ts.ModelConfig(**TINY, dropout=0.0)
    parallel, kw, match, world = {
        "fineweb": ("fsdp", dict(dataset="fineweb"), "dataset: synthetic", 1),
        "pipeline": ("pp", {}, "pipeline", 1),
        "lora": ("fsdp", {}, "LoRA", 1),
        "processes": ("dp", {}, "in-process", 2),
        "batch": ("dp", dict(batch=6), "must shard over the data axis", 1),
    }[case]
    cfg = _port(ts.TrainConfig, dataclasses.replace(
        make_train_cfg(parallel, steps=1, **kw), resilience=el))
    if case == "lora":
        mcfg = dataclasses.replace(mcfg, adapter=ts.AdapterConfig(rank=2))
    with pytest.raises(ValueError, match=match):
        trainer_mod.elastic_layout(cfg, mcfg, world)
    if case in ("fineweb", "pipeline"):
        with pytest.raises(ValueError, match=match):
            trainer_mod.train(cfg, mcfg, ts.OptimConfig(**OPT), device="cpu")
        jcfg = dataclasses.replace(make_train_cfg(parallel, steps=1, **kw), resilience=el)
        from dtc_tpu.train.trainer import train as jtrain

        with pytest.raises(ValueError, match=match):
            jtrain(jcfg, js.ModelConfig(**TINY, dropout=0.0), js.OptimConfig(**OPT))


def test_elastic_layout_takes_the_config_mesh_or_eight_devices():
    from tests.conftest import make_train_cfg

    el = js.ResilienceConfig(elastic=js.ElasticConfig(enabled=True, n_virtual_hosts=2))
    mcfg = ts.ModelConfig(**TINY, dropout=0.0)
    for mesh, want in ((js.MeshConfig(), (1, 8, 1)), (js.MeshConfig(data=2, model=2), (1, 2, 2)),
                       (js.MeshConfig(model=2), (1, 4, 2))):
        cfg = _port(ts.TrainConfig, dataclasses.replace(
            make_train_cfg("fsdp", steps=1, mesh=mesh), resilience=el))
        hosts, vmesh = trainer_mod.elastic_layout(cfg, mcfg, 1)
        assert vmesh.sizes == want and len(hosts.devices) == np.prod(want)


def test_dev_chaos_config_with_elastic_through_the_command_line(tmp_path):
    """``train_config_dev_chaos.yaml`` moved under a scratch directory, with
    ``elastic.enabled`` and a host killed at step 12, through ``python -m
    dtc_tpu_torch.main``: the host loss is detected and the run resizes
    from memory (under DP the survivor holds every leaf whole, so the
    newest snapshot, taken after the kill, is complete), rolls back the NaN
    of step 25 from the cold tier (the retained snapshots are past the
    healthy boundary) and finishes its 40 steps."""
    from dtc_tpu_torch.main import main

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    text = open(os.path.join(root, "configs", "train_config_dev_chaos.yaml")).read()
    out = tmp_path / "out"
    text = (text.replace("outputs/dev_chaos", str(out))
            .replace("    enabled: false\n    snapshot_every", "    enabled: true\n    snapshot_every")
            .replace("kill_host_at_step: 0", "kill_host_at_step: 12"))
    cfg = tmp_path / "train.yaml"
    cfg.write_text(text)
    argv = ["--train_config_path", str(cfg), "--model_config_path",
            os.path.join(root, "configs", "model_config_dev.yaml"), "--optim_config_path",
            os.path.join(root, "configs", "optim_config.yaml"), "--device", "cpu"]
    main(argv)
    events = _events(str(out))
    kinds = [e["etype"] for e in events]
    assert kinds.count("host_lost") == 1 and kinds.count("elastic_resize") == 1
    rz = next(e for e in events if e["etype"] == "elastic_resize")
    assert rz["tier"] == "memory" and rz["devices"] == 4
    assert any(e["etype"] == "recovery" and e["action"] == "rollback" for e in events)
    rows = [line.split(",") for line in open(out / "log.csv").read().split()[1:]]
    assert int(rows[-1][0]) == 40 and np.isfinite(float(rows[-1][2]))
