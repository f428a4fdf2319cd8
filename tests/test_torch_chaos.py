"""The chaos harness and the recovery bus in the port's trainer, against the
JAX package on the CPU:

- the pieces: ``ChaosInjector`` hook by hook against JAX's on the same
  config and call sequence (returns, fire-once, the bus's records), the
  bus's overflow record, ``_damage_dir``'s bytes and
  ``Telemetry.drain_recovery_bus``; the checkpoint manager's
  ``ckpt_fallback`` record;
- the trainer, as ``tests/test_resilience.py``'s chaos tests run JAX's: a
  transient stream fault on injected FineWeb documents, a corrupted
  checkpoint and a NaN in one run, against JAX's ``train()`` on the same
  inputs (the tiny model of ``tests/test_torch_checkpoint.py``, float32,
  dropout 0: the two packages draw dropout masks from different
  generators) and against the port's own clean run at dropout 0.1, bit
  for bit; a poisoned save skipped; the chaos SIGTERM; the flight dumps;
  ``configs/train_config_dev_chaos.yaml`` through the command line.

JAX's chaos run is shared by its tests through one fixture, run once a
session under a file lock. The records the prefetch thread posts (the
data fault and the stream's retry) surface at whichever boundary drains
the bus first, so their ``step`` stamp is not compared; every other
record's is.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from dtc_tpu.config import schema as js
from dtc_tpu_torch.config import schema as ts
from dtc_tpu_torch.config.loader import _build
from dtc_tpu_torch.resilience import ChaosInjectedError, ChaosInjector, RecoveryBus
from dtc_tpu_torch.train import trainer as trainer_mod
from dtc_tpu_torch.utils.checkpoint import CheckpointManager
from tests.test_torch_train import _one_thread  # noqa: F401  (autouse: one intra-op thread)


# ---------------------------------------------------------------------------
# the pieces against JAX's
# ---------------------------------------------------------------------------

def _both(**kw):
    """A port injector and JAX's on the same config, each on its own bus."""
    from dtc_tpu.resilience.chaos import ChaosInjector as JChaos
    from dtc_tpu.resilience.events import RecoveryBus as JBus

    kw.setdefault("enabled", True)
    return (ChaosInjector(ts.ChaosConfig(**kw), RecoveryBus()),
            JChaos(js.ChaosConfig(**kw), JBus()))


# (config, hook, the arguments of each call in order)
HOOKS = {
    "serve_stall": (dict(serve_stall_at_step=3, stall_s=0.25), "serve_stall", [1, 2, 3, 3, 4]),
    "serve_preempt": (dict(serve_preempt_at_step=2), "serve_preempt", [1, 3, 4, 2]),
    "serve_corrupt_page": (dict(serve_corrupt_page_at_step=4), "serve_corrupt_page",
                           [2, 3, 5, 6]),
    "serve_poison_logits": (dict(serve_poison_logits_at_step=1), "serve_poison_logits",
                            [1, 1, 2]),
    "sigterm": (dict(sigterm_at_step=3), "should_preempt", [1, 2, 3, 3, 4]),
    "fleet_kill_replica": (dict(fleet_kill_replica_at_step=2, fleet_target_replica=1),
                           "fleet_kill_replica", [1, 2, 3]),
    "fleet_stall_replica": (dict(fleet_stall_replica_at_step=2, stall_s=0.5,
                                 fleet_target_replica=1), "fleet_stall_replica", [1, 3, 4]),
    "fleet_partition": (dict(fleet_partition_at_step=2, fleet_partition_iters=3),
                        "fleet_partition", [1, 2, 2, 5]),
    "kill_host": (dict(kill_host_at_step=2, elastic_target_host=1), "kill_host", [1, 2, 2]),
    "slow_host": (dict(slow_host_at_step=2, slow_host_iters=2), "slow_host", [2, 3, 2]),
    "lose_snapshot": (dict(lose_snapshot_at_step=3, elastic_target_host=1), "lose_snapshot", [1, 3, 3]),
    "pool_spike_mid_grow": (dict(pool_spike_mid_grow_at=2, pool_spike_requests=5),
                            "pool_spike_mid_grow", [1, 4, 5]),
    "pool_kill_mid_shrink": (dict(pool_kill_mid_shrink_at=2, elastic_target_host=1),
                             "pool_kill_mid_shrink", [3, 3]),
    "pool_kill_draining_replica": (dict(pool_kill_draining_replica_at=2),
                                   "pool_kill_draining_replica", [1, 2, 2]),
    "disabled": (dict(enabled=False, serve_preempt_at_step=1), "serve_preempt", [1, 2]),
}


@pytest.mark.parametrize("case", sorted(HOOKS))
def test_injector_hook_equals_jax(case):
    """Call by call the same return; the fault fires once; both buses hold
    the same ``chaos`` records (kind and fields)."""
    kw, hook, calls = HOOKS[case]
    port, ref = _both(**kw)
    got = [getattr(port, hook)(a) for a in calls]
    want = [getattr(ref, hook)(a) for a in calls]
    assert got == want
    assert port.bus.drain() == ref.bus.drain()
    fired = [g for g in got if g not in (False, None, 0, 0.0)]
    assert len(fired) == (0 if case == "disabled" else 1)


@pytest.mark.parametrize("kind", ["data_error", "data_stall"])
def test_data_fault_hook_equals_jax(kind):
    """The raw-document hook: the fault lands before the configured 1-based
    document (a ``ConnectionError`` the stream's retry heals), the re-opened
    source runs clean, and the documents read and the records posted are
    JAX's."""
    from dtc_tpu.resilience.errors import ChaosInjectedError as JError

    kw = ({"data_error_at_doc": 3} if kind == "data_error"
          else {"data_stall_at_doc": 2, "stall_s": 0.0})
    docs = [[i, i + 1] for i in range(5)]
    outs = []
    for inj, err in zip(_both(**kw), (ChaosInjectedError, JError)):
        read = []
        try:
            read.extend(inj.wrap_raw_documents(iter(docs), 0))
        except err as e:
            assert isinstance(e, ConnectionError)
            read.append("fault")
            read.extend(inj.wrap_raw_documents(iter(docs[2:]), 2))
        outs.append((read, inj.bus.drain()))
    assert outs[0] == outs[1]
    assert ("fault" in outs[0][0]) == (kind == "data_error")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_poison_equals_jax(dtype):
    """``maybe_poison`` at its step, once: every parameter NaN in place
    (dtype and shape kept) and the loss NaN, as JAX's poisons
    ``state.params``; other steps and a second call leave both alone. The
    optimizer's float32 copies are not touched."""
    import jax.numpy as jnp

    class State:
        def __init__(self, params):
            self.params = params

        def replace(self, params):
            return State(params)

    port, ref = _both(nan_at_step=2)
    params = [torch.ones(3, 2, dtype=dtype), torch.arange(4, dtype=dtype)]
    master = params[0].float().clone()
    state = State({"w": jnp.ones((3, 2)), "b": jnp.arange(4.0)})
    for step, fires in ((1, False), (2, True), (2, False)):
        loss = port.maybe_poison(step, params, torch.tensor(1.5))
        state, jloss = ref.maybe_poison(step, state, jnp.asarray(1.5))
        assert np.isnan(float(loss)) == np.isnan(float(jloss)) == fires
    assert all(p.dtype == dtype and torch.isnan(p).all() for p in params)
    assert all(np.isnan(np.asarray(v)).all() for v in state.params.values())
    assert torch.equal(master, torch.ones(3, 2))
    assert port.bus.drain() == ref.bus.drain() == [("chaos", {"kind": "nan_loss", "step": 2})]


@pytest.mark.parametrize("mode", ["truncate", "flip", "torn"])
def test_damage_dir_bytes_equal_jax(tmp_path, mode):
    """``maybe_corrupt_checkpoint`` (``truncate`` / ``flip``) and
    ``maybe_tear_cold_spill`` on copies of the same step directory: the
    same file damaged to the same bytes, once, with the same records."""
    rng = np.random.RandomState(0)
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    for name, n in (("a.pt", 300), ("sub/b.pt", 1001), ("c.pt", 40)):
        (src / name).write_bytes(rng.randint(0, 256, n).astype(np.uint8).tobytes())
    kw = (dict(torn_cold_spill_at_step=4) if mode == "torn"
          else dict(corrupt_ckpt_at_step=4, corrupt_mode=mode))
    trees = []
    for name, inj in zip(("port", "jax"), _both(**kw)):
        d = tmp_path / name
        shutil.copytree(src, d)
        hook = inj.maybe_tear_cold_spill if mode == "torn" else inj.maybe_corrupt_checkpoint
        assert [hook(s, str(d)) for s in (2, 4, 4)] == [False, True, False]
        trees.append(({p: (d / p).read_bytes() for p in ("a.pt", "sub/b.pt", "c.pt")},
                      inj.bus.drain()))
    assert trees[0] == trees[1]
    assert trees[0][0]["sub/b.pt"] != (src / "sub/b.pt").read_bytes()
    assert len(trees[0][0]["sub/b.pt"]) == (500 if mode != "flip" else 1001)


def test_recovery_bus_overflow_equals_jax():
    """A full bus drops, counts the drops and reports them once, in a
    ``bus_overflow`` record at the end of the next drain, as JAX's does."""
    from dtc_tpu.resilience.events import RecoveryBus as JBus

    buses = (RecoveryBus(maxlen=3), JBus(maxlen=3))
    drains = []
    for bus in buses:
        for i in range(5):
            bus.post("recovery", action="stream_retry", index=i)
        first = bus.drain()
        bus.post("chaos", kind="x")
        drains.append((first, bus.drain(), bus.drain()))
    assert drains[0] == drains[1]
    assert drains[0][0][-1] == ("recovery", {"action": "bus_overflow", "dropped": 2})


def test_drain_recovery_bus_equals_jax():
    """``Telemetry.drain_recovery_bus``: the same events (a poster's own
    ``step`` kept, the boundary's stamped otherwise) and the same
    ``chaos_injections`` / ``recoveries`` counters as JAX's."""
    from dtc_tpu.obs import MemorySink as JSink
    from dtc_tpu.obs.telemetry import Telemetry as JTelemetry
    from dtc_tpu_torch.obs import MemorySink
    from dtc_tpu_torch.obs.telemetry import Telemetry

    records = [("chaos", dict(kind="ckpt_corrupt", step=4, mode="truncate")),
               ("chaos", dict(kind="data_error", doc=30)),
               ("recovery", dict(action="ckpt_fallback", rejected_step=4, reason="r")),
               ("recovery", dict(action="stream_retry", index=29, attempt=1))]
    seen = []
    for tele, sink, bus in ((Telemetry(), MemorySink(), RecoveryBus()),
                            (JTelemetry(), JSink(), RecoveryBus())):
        tele.registry.add_sink(sink)
        for etype, fields in records:
            bus.post(etype, **fields)
        tele.drain_recovery_bus(bus, 7)
        snap = tele.registry.snapshot()
        seen.append(([{k: v for k, v in e.items() if k != "ts"} for e in sink.events],
                     snap["chaos_injections"], snap["recoveries"]))
        tele.close()
    assert seen[0] == seen[1]
    assert [e["step"] for e in seen[0][0]] == [4, 7, 7, 7] and seen[0][1:] == (2, 2)


def test_checkpoint_fallback_posts_a_recovery_record(tmp_path):
    """The manager's newest step truncated after its manifest: the restore
    lands on the step before and posts, once, the record JAX's manager
    posts (``dtc_tpu/utils/checkpoint.py``'s ``_reject``): ``recovery``,
    ``ckpt_fallback`` with the rejected step and the reason. The trainer's
    run against JAX's below holds the record's place in the stream."""
    posted = []
    mgr = CheckpointManager(str(tmp_path), on_event=lambda *a, **k: posted.append((a, k)))
    for s in (2, 4):
        mgr.save(s, {"model": {"w": torch.full((8,), float(s))}})
    ChaosInjector._damage_dir(mgr.step_dir(4), "truncate")
    assert mgr.restore_latest()[1] == 2 and mgr.latest_step() == 2
    assert posted == [(("recovery",), dict(
        action="ckpt_fallback", rejected_step=4, reason="failed integrity verification"))]


# ---------------------------------------------------------------------------
# the trainer against JAX's train()
# ---------------------------------------------------------------------------

CHAOS = dict(data_error_at_doc=30, corrupt_ckpt_at_step=4, nan_at_step=5)
RUN = dict(steps=8, warmup_steps=2, log_every=1, dataset="fineweb", checkpoint_every=2)
SEQ = 33


def _jmodel(dropout=0.0):
    return js.ModelConfig(vocab_size=97, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                          max_seq_len=SEQ - 1, dropout=dropout, param_dtype="float32",
                          compute_dtype="float32", attention="dense")


def _docs():
    from tests.test_data import _docs

    return _docs(n=3000, tokens=50)


def _jax_cfg(out, chaos=True, **over):
    from tests.conftest import make_train_cfg

    res = js.ResilienceConfig(
        stream_retry=js.StreamRetryConfig(backoff_s=0.0, jitter=0.0),
        chaos=js.ChaosConfig(enabled=chaos, **CHAOS))
    kw = dict(RUN, output_dir=str(out), checkpoint_dir=str(out) + "_ckpt", resilience=res)
    kw.update(over)
    return make_train_cfg("dp", **kw)


def _events(output_dir, rank=0):
    from dtc_tpu_torch.obs import read_jsonl

    return read_jsonl(os.path.join(output_dir, "obs", f"events.r{rank}.jsonl"))


def _recovery_trace(events):
    """The ``chaos`` / ``recovery`` / ``anomaly`` events as (etype, kind or
    action, step, to_step or rejected_step): the prefetch thread's records
    (data fault, stream retry) without their step, and apart."""
    thread, rest = [], []
    for e in events:
        if e["etype"] not in ("chaos", "recovery", "anomaly"):
            continue
        what = e.get("kind") or e.get("action")
        if what in ("data_error", "stream_retry"):
            thread.append((e["etype"], what))
        else:
            rest.append((e["etype"], what, e.get("step"),
                         e.get("to_step", e.get("rejected_step"))))
    return sorted(thread), rest


@pytest.fixture(scope="session")
def jax_chaos(tmp_path_factory):
    """JAX's ``train()`` with the three faults of
    ``tests/test_resilience.py::test_chaos_end_to_end_recovery`` over the
    injected documents (dropout 0), once a session under a file lock: its
    losses, its recovery trace and the flax init."""
    from filelock import FileLock

    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    out = base / "jax_chaos_oracle"
    with FileLock(str(out) + ".lock"):
        if not (out / "done.json").exists():
            from dtc_tpu.data.fineweb import FinewebStream as JStream
            from dtc_tpu.train import trainer as jtrainer
            from tests.test_torch_train import _flax_params

            docs = _docs()

            def fake(train_cfg, model_cfg, skip_batches=0, seed_offset=0,
                     stream_position=None, history=64, chaos=None, on_recovery=None,
                     cancel=None):
                it = JStream(train_cfg.batch, SEQ, documents=docs, position=stream_position,
                             history=history, retry=train_cfg.resilience.stream_retry,
                             chaos=chaos, on_recovery=on_recovery, cancel=cancel)
                for _ in range(skip_batches):
                    next(it)
                return it

            out.mkdir(exist_ok=True)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jtrainer, "make_host_iterator", fake)
                res = jtrainer.train(_jax_cfg(out / "run"), _jmodel(),
                                     js.OptimConfig(lr=1e-3, weight_decay=0.1, grad_clip=1.0))
            np.savez(out / "init.npz", **{"/".join(k): v for k, v in _flat(
                _flax_params(_jmodel())).items()})
            (out / "done.json").write_text(json.dumps(dict(
                losses=res.losses, trace=_recovery_trace(_events(str(out / "run"))))))
    params = _unflat(dict(np.load(out / "init.npz")))
    return json.loads((out / "done.json").read_text()), params


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _fineweb(monkeypatch, docs):
    """The trainer's ``make_host_iterator`` over injected documents, the
    chaos injector and the bus's post passed through as the FineWeb stream
    takes them."""
    from dtc_tpu_torch.data.fineweb import FinewebStream

    def fake(train_cfg, model_cfg, skip_batches=0, seed_offset=0, stream_position=None,
             history=64, chaos=None, on_recovery=None, cancel=None):
        it = FinewebStream(train_cfg.batch, SEQ, documents=docs, position=stream_position,
                           history=history, retry=train_cfg.resilience.stream_retry,
                           chaos=chaos, on_recovery=on_recovery, cancel=cancel)
        for _ in range(skip_batches):
            next(it)
        return it
    monkeypatch.setattr(trainer_mod, "make_host_iterator", fake)


def _port(cls, cfg):
    return _build(cls, dataclasses.asdict(cfg), "test")


OPT = ts.OptimConfig(lr=1e-3, weight_decay=0.1, grad_clip=1.0)


def _run(cfg, dropout=0.0, params=None):
    return trainer_mod.train(_port(ts.TrainConfig, cfg), _port(ts.ModelConfig, _jmodel(dropout)),
                             OPT, device="cpu", params=params)


def test_chaos_run_equals_clean_run_and_jax(tmp_path, monkeypatch, jax_chaos):
    """``tests/test_resilience.py::test_chaos_end_to_end_recovery`` in the
    port: a transient stream fault before document 30, the step-4
    checkpoint truncated after its save, NaN after the update of step 5.
    The run heals the stream, rolls back past the corrupt step to step 2
    and finishes: at dropout 0 its losses are JAX's chaos run's within
    2e-4 and its chaos, recovery and anomaly events JAX's (one
    ``stream_retry``, one ``ckpt_fallback``, one rollback to step 2); at
    dropout 0.1 its losses equal its own clean run's bit for bit. The
    anomaly's flight dump holds the timeline."""
    from dtc_tpu_torch.obs import load_flight_dump

    want, init = jax_chaos
    _fineweb(monkeypatch, _docs())
    port = _run(_jax_cfg(tmp_path / "j"), params=init)
    np.testing.assert_allclose(port.losses, want["losses"], rtol=2e-4)
    thread, rest = _recovery_trace(_events(str(tmp_path / "j")))
    assert json.loads(json.dumps([thread, rest])) == want["trace"]
    assert thread == [("chaos", "data_error"), ("recovery", "stream_retry")]
    assert ("recovery", "ckpt_fallback", 5, 4) in rest
    assert ("recovery", "rollback", 5, 2) in rest
    dump = load_flight_dump(str(tmp_path / "j" / "obs" / "flight.r0.json"))
    assert dump["reason"] == "anomaly: non-finite loss @ step 5" and dump["step"] == 5

    clean = _run(_jax_cfg(tmp_path / "c", chaos=False), dropout=0.1)
    drill = _run(_jax_cfg(tmp_path / "d"), dropout=0.1)
    assert len(drill.losses) == 8 and np.isfinite(drill.losses[-1])
    assert drill.losses == clean.losses
    assert _recovery_trace(_events(str(tmp_path / "d"))) == (thread, rest)


def test_resume_over_a_truncated_checkpoint_posts_ckpt_fallback(tmp_path):
    """A resume whose newest checkpoint fails its manifest restores the
    step before, and the fallback (posted before the telemetry exists)
    lands in the stream at the first boundary as JAX's trainer drains it:
    ``recovery {ckpt_fallback, rejected_step 4}`` stamped with the first
    resumed step."""
    cfg = _jax_cfg(tmp_path / "r", chaos=False, dataset="synthetic", steps=4)
    first = _run(cfg)
    mgr = CheckpointManager(cfg.checkpoint_dir)
    ChaosInjector._damage_dir(mgr.step_dir(4), "truncate")
    resumed = _run(dataclasses.replace(cfg, steps=5))
    assert resumed.losses[:2] == first.losses[2:]
    falls = [e for e in _events(str(tmp_path / "r")) if e.get("action") == "ckpt_fallback"]
    assert [(e["step"], e["rejected_step"]) for e in falls] == [(3, 4)]


def test_poisoned_checkpoint_is_never_saved(tmp_path):
    """``tests/test_resilience.py::test_poisoned_checkpoint_is_never_saved``:
    a save every step and NaN after the update of step 2, seen at the step
    3 boundary: the saves of the poisoned steps are skipped, the rollback
    lands on step 1, and the losses equal the clean run's bit for bit."""
    kw = dict(chaos=False, dataset="synthetic", steps=6, log_every=3, checkpoint_every=1)
    clean = _run(_jax_cfg(tmp_path / "c", **kw), dropout=0.1)
    cfg = _jax_cfg(tmp_path / "d", **kw)
    cfg = dataclasses.replace(cfg, resilience=js.ResilienceConfig(
        chaos=js.ChaosConfig(enabled=True, nan_at_step=2)))
    drill = _run(cfg, dropout=0.1)
    assert drill.losses == clean.losses
    events = _events(str(tmp_path / "d"))
    actions = [e["action"] for e in events if e["etype"] == "recovery"]
    assert "skip_checkpoint" in actions
    assert [e["to_step"] for e in events if e["etype"] == "recovery" and e["action"] == "rollback"] == [1]


def test_chaos_sigterm_checkpoints_dumps_and_resumes_bit_exact(tmp_path, monkeypatch):
    """``tests/test_resilience.py::test_chaos_sigterm_checkpoints_sidecar_and_resumes_bit_exact``
    and ``tests/test_trace.py::test_trainer_chaos_sigterm_dumps_flight``:
    the chaos SIGTERM at step 3 goes through the trainer's handler, which
    checkpoints step 3 with its stream sidecar, flushes ``log.csv`` and
    dumps the flight recorder (``sigterm``, the chaos record in it); a
    resume without chaos continues the uninterrupted run bit for bit."""
    from dtc_tpu_torch.obs import load_flight_dump

    _fineweb(monkeypatch, _docs())
    kw = dict(chaos=False, steps=6, checkpoint_every=1000)
    full = _run(_jax_cfg(tmp_path / "full", **kw), dropout=0.1)
    cfg = dataclasses.replace(_jax_cfg(tmp_path / "pre", **kw), resilience=js.ResilienceConfig(
        chaos=js.ChaosConfig(enabled=True, sigterm_at_step=3)))
    pre = _run(cfg, dropout=0.1)
    assert len(pre.losses) == 3
    mgr = CheckpointManager(cfg.checkpoint_dir)
    assert mgr.latest_step() == 3 and mgr.load_stream(3, 0) is not None
    assert len((tmp_path / "pre" / "log.csv").read_text().splitlines()) == 4
    dump = load_flight_dump(str(tmp_path / "pre" / "obs" / "flight.r0.json"))
    assert dump["reason"] == "sigterm" and dump["step"] == 3
    assert any(e["etype"] == "chaos" and e.get("kind") == "sigterm" for e in dump["events"])
    resumed = _run(dataclasses.replace(cfg, output_dir=str(tmp_path / "res"),
                                       resilience=js.ResilienceConfig()), dropout=0.1)
    assert resumed.losses == full.losses[3:]


def test_chaos_nan_without_checkpoint_dumps_flight(tmp_path):
    """``tests/test_trace.py::test_trainer_chaos_nan_anomaly_dumps_flight``:
    with no checkpoint the guard only warns; the anomaly's dump ends at the
    failing step (its last step span), and the ``nan_loss`` record lands
    at the boundary."""
    from dtc_tpu_torch.obs import load_flight_dump

    cfg = dataclasses.replace(
        _jax_cfg(tmp_path / "n", chaos=False, dataset="synthetic", steps=2, log_every=2,
                 checkpoint_every=0),
        resilience=js.ResilienceConfig(chaos=js.ChaosConfig(enabled=True, nan_at_step=2)))
    _run(cfg)
    dump = load_flight_dump(str(tmp_path / "n" / "obs" / "flight.r0.json"))
    assert dump["reason"].startswith("anomaly: non-finite loss") and dump["step"] == 2
    spans = [e for e in dump["events"] if e["etype"] == "span" and e["name"] == "step"]
    assert spans and spans[-1]["step"] == 2
    assert [(e["kind"], e["step"]) for e in _events(str(tmp_path / "n"))
            if e["etype"] == "chaos"] == [("nan_loss", 2)]


def test_dev_chaos_config_through_the_command_line(tmp_path):
    """``configs/train_config_dev_chaos.yaml`` as written (its output and
    checkpoint directories moved) on the dev model through
    ``dtc_tpu_torch.main``: 40 ``log.csv`` rows, one ``chaos`` event for
    each injection (``nan_loss`` at 25, ``ckpt_corrupt`` at 30), one
    anomaly and a rollback to step 20; after the run step 30 fails its
    manifest."""
    from dtc_tpu_torch.main import main

    text = open("configs/train_config_dev_chaos.yaml").read()
    cfg_path = tmp_path / "train.yaml"
    cfg_path.write_text(text.replace("outputs/dev_chaos", str(tmp_path / "out")))
    res = main(["--train_config_path", str(cfg_path),
                "--model_config_path", "configs/model_config_dev.yaml",
                "--optim_config_path", "configs/optim_config.yaml", "--device", "cpu"])
    assert len(res.losses) == 40 and np.isfinite(res.losses[-1])
    rows = (tmp_path / "out" / "log.csv").read_text().splitlines()
    assert len(rows) == 41 and rows[-1].startswith("40,")
    events = _events(str(tmp_path / "out"))
    assert [(e["kind"], e["step"]) for e in events if e["etype"] == "chaos"] == [
        ("nan_loss", 25), ("ckpt_corrupt", 30)]
    assert [e["to_step"] for e in events if e["etype"] == "recovery" and e["action"] == "rollback"] == [20]
    assert sum(e["etype"] == "anomaly" for e in events) == 1
    mgr = CheckpointManager(str(tmp_path / "out" / "checkpoints"))
    assert not mgr.verify_step(30) and mgr.verify_step(40)
