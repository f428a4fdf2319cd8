"""The port's telemetry (``dtc_tpu_torch/obs/``) against the JAX package's on
the CPU:

- the copied modules against JAX's on the same seeded inputs: histogram
  percentiles and ``nearest_rank`` bit for bit, the SLO monitor's breach
  and recovery events, ``reduce_shards``' summary and straggler flags, the
  goodput ledger's per-class seconds, ``to_chrome_trace``'s JSON;
- the trainer's event stream against JAX's ``train()`` (dev widths, 2
  layers, obs on, 6 steps, ``log_every`` 2, eval and checkpoints every 3,
  dropout 0, the same weights): the event types in the same order (JAX's
  ``aux_compile`` events aside: the port builds no per-operation
  executable), the same keys, ``train_row`` and ``eval`` values within
  JAX's rtol 2e-4, every step's parts summing to its ``step_time_s``, and
  ``summary.json`` with JAX's keys. JAX's run is made once a session under
  a file lock;
- JAX's readers (``find_shards``, ``GoodputLedger``) over the port's run
  give the port's own ledger exactly;
- telemetry, a device-profile window included, moves no value;
- the trainer's behaviours of ``tests/test_obs.py`` and
  ``tests/test_trace.py``: an unwritable profiler directory and a second
  profiler session warn and disable; a watchdog flag arms a profile window
  and dumps the flight recorder; SIGTERM and an anomaly dump it; a tiny
  training SLO objective emits ``slo_breach`` and triggers a capture;
- the command line runs a committed config without ``--no-obs``.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dtc_tpu.config import schema as js
from dtc_tpu.obs import aggregate as jagg
from dtc_tpu.obs import goodput as jgood
from dtc_tpu.obs import registry as jreg
from dtc_tpu.obs import slo as jslo
from dtc_tpu.obs import trace as jtrace
from dtc_tpu.utils import percentile as jpct
from dtc_tpu_torch.config import schema as ts
from dtc_tpu_torch.config.loader import _build
from dtc_tpu_torch.obs import aggregate as tagg
from dtc_tpu_torch.obs import goodput as tgood
from dtc_tpu_torch.obs import registry as treg
from dtc_tpu_torch.obs import slo as tslo
from dtc_tpu_torch.obs import trace as ttrace
from dtc_tpu_torch.obs.profiling import StepWindowProfiler
from dtc_tpu_torch.obs.stepclock import CompileWatcher
from dtc_tpu_torch.obs.telemetry import Telemetry
from dtc_tpu_torch.train import trainer as trainer_mod
from dtc_tpu_torch.utils import percentile as tpct

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's runs here are tiny: one intra-op thread runs them as fast
    and keeps the test workers from contending for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the copied modules against JAX's
# ---------------------------------------------------------------------------

def _samples(case: str) -> np.ndarray:
    rng = np.random.RandomState(sum(map(ord, case)))
    return {
        "lognormal": rng.lognormal(-3.0, 1.0, 500),
        "uniform": rng.uniform(0.0, 2.0, 300),
        "with_zeros": np.concatenate([np.zeros(20), rng.exponential(0.01, 200)]),
        "spiky": np.concatenate([rng.normal(0.05, 0.002, 400), rng.uniform(5, 50, 7)]),
        "few": rng.uniform(1e-6, 1e-3, 3),
    }[case]


@pytest.mark.parametrize("case", ["lognormal", "uniform", "with_zeros", "spiky", "few"])
def test_histogram_and_nearest_rank_equal_jax(case):
    """The same samples through both histograms (whole, and as two halves
    merged): equal summaries and percentiles bit for bit; ``nearest_rank``
    equal at every quantile."""
    xs = [float(x) for x in _samples(case)]
    qs = (0.0, 0.01, 0.1, 0.5, 0.9, 0.99, 1.0)
    got, want = treg.Histogram("h"), jreg.Histogram("h")
    halves = [(treg.Histogram("a"), treg.Histogram("b")), (jreg.Histogram("a"),
                                                          jreg.Histogram("b"))]
    for i, x in enumerate(xs):
        got.observe(x)
        want.observe(x)
        for a, b in halves:
            (a if i % 2 else b).observe(x)
    assert got.summary() == want.summary()
    assert [got.percentile(q) for q in qs] == [want.percentile(q) for q in qs]
    merged = [a.merge(b) for a, b in halves]
    assert merged[0].summary() == merged[1].summary()
    assert [tpct.nearest_rank(xs, q) for q in qs] == [jpct.nearest_rank(xs, q) for q in qs]


def _slo_stream(case: str):
    """(objectives, [(metric, value) ...]) of one SLO case."""
    rng = np.random.RandomState(len(case))
    base = rng.uniform(0.04, 0.06, 96)
    if case == "breach_and_recover":
        base[30:50] = rng.uniform(0.2, 0.3, 20)
        obj = dict(step_time_p99_s=0.1)
        return obj, [("step_time_s", v) for v in base]
    if case == "data_wait":
        dw = rng.exponential(0.002, 96)
        dw[60:] += 0.05
        return dict(data_wait_p99_s=0.02), [("data_wait_s", v) for v in dw]
    pct = rng.uniform(95, 100, 96)
    pct[20:40] = rng.uniform(60, 80, 20)
    return (dict(goodput_min_pct=90.0, step_time_p99_s=0.055, window=16),
            [(m, v) for p, s in zip(pct, base) for m, v in (("goodput_pct", p),
                                                             ("step_time_s", s))])


@pytest.mark.parametrize("case", ["breach_and_recover", "data_wait", "goodput_floor"])
def test_slo_monitor_breaches_equal_jax(case):
    """The training objectives over the same observation stream, evaluated
    every 8 observations: the same breaches returned and the same
    ``slo_breach`` / ``slo_recovered`` events, in order."""
    obj, stream = _slo_stream(case)
    runs = []
    for sched, mod, reg_mod in ((ts, tslo, treg), (js, jslo, jreg)):
        reg = reg_mod.MetricsRegistry()
        reg.set_clock(lambda: 0.0)
        sink = reg.add_sink(reg_mod.MemorySink())
        mon = mod.SloMonitor.from_config(sched.SloConfig(**obj), reg, runtime="train")
        returned = []
        for i, (metric, v) in enumerate(stream, 1):
            mon.observe(metric, v)
            if i % 8 == 0:
                returned.append(mon.evaluate(step=i))
        runs.append((returned, sink.events, reg.snapshot()))
    assert runs[0] == runs[1]
    assert any(e["etype"] == "slo_breach" for e in runs[0][1])


def _events(rng, proc: int, n_steps: int, slow: float = 1.0, rollback=None):
    """A training shard's events: run_start, the startup compile, ``step``
    events with their spans (a rollback at ``rollback = (step, to_step)``
    replays from the target), windows, ``run_summary``."""
    t = 1000.0 + proc
    ev = [dict(etype="run_start", ts=t, proc=proc, strategy="dp", mesh={"data": 2},
               devices=2, processes=2, batch=8, seq_len=64, steps=n_steps, start_step=0,
               dataset="synthetic")]
    t += 0.3
    ev.append(dict(etype="compile", ts=t, proc=proc, step=0, compile_time_s=0.25, count=3))
    step, rolled = 0, False
    while step < n_steps:
        step += 1
        dur = float(rng.uniform(0.05, 0.08)) * slow
        dw = float(rng.uniform(0.0, 0.01))
        ev.append(dict(etype="span", ts=t + dur, proc=proc, name="step", cat="train",
                       tid="train", ph="X", t0=t, dur_s=dur, step=step))
        t += dur
        ev.append(dict(etype="step", ts=t, proc=proc, step=step, elapsed_s=t - 1000.0,
                       synced=True, data_wait_s=dw, dispatch_s=dur - dw, block_s=0.0,
                       other_s=0.0, step_time_s=dur))
        if step % 4 == 0:
            ev.append(dict(etype="window", ts=t, proc=proc, step=step, avg_step_s=dur,
                           tokens_per_sec=512 / dur, mfu=None))
        if rollback and step == rollback[0] and not rolled:
            rolled = True
            ev.append(dict(etype="anomaly", ts=t, proc=proc, step=step,
                           reason="non-finite loss", action="rollback"))
            ev.append(dict(etype="recovery", ts=t + 0.2, proc=proc, step=step,
                           action="rollback", to_step=rollback[1], reason="nan", tier="cold",
                           rollbacks=1, t_detect=t, t_restored=t + 0.2))
            t += 0.2
            step = rollback[1]
    ev.append(dict(etype="run_summary", ts=t, proc=proc, steps=n_steps))
    return ev


LEDGER_CASES = {
    "clean": [dict(n_steps=12)],
    "rollback": [dict(n_steps=12, rollback=(8, 4))],
    "straggler": [dict(n_steps=10), dict(n_steps=10), dict(n_steps=10, slow=3.0)],
    "two_rollbacks": [dict(n_steps=9, rollback=(6, 2)), dict(n_steps=9, rollback=(6, 2))],
}


def _write_shards(obs_dir: Path, case: str) -> None:
    rng = np.random.RandomState(len(case))
    obs_dir.mkdir(parents=True, exist_ok=True)
    for proc, kw in enumerate(LEDGER_CASES[case]):
        with open(tagg.shard_path(str(obs_dir), proc), "w") as f:
            for e in _events(rng, proc, **kw):
                f.write(json.dumps(e) + "\n")


@pytest.mark.parametrize("case", sorted(LEDGER_CASES))
def test_reduce_shards_and_goodput_ledger_equal_jax(tmp_path, case):
    """The same shard files: ``reduce_shards`` gives JAX's summary and
    straggler flags, and the goodput ledger JAX's per-class seconds,
    incidents and token accounting."""
    _write_shards(tmp_path / "obs", case)
    obs = str(tmp_path / "obs")
    assert tagg.find_shards(obs) == jagg.find_shards(obs)
    got, want = tagg.reduce_shards(obs, 1.5), jagg.reduce_shards(obs, 1.5)
    assert got == want
    assert got["stragglers"] == ([2] if case == "straggler" else [])
    ledger = tgood.GoodputLedger.from_dir(obs).summary()
    assert ledger == jgood.GoodputLedger.from_dir(obs).summary()
    assert tgood.CLASSES == jgood.CLASSES
    if "rollback" in case:
        assert ledger["fleet"]["seconds"]["rollback_replay"] > 0


@pytest.mark.parametrize("case", ["train_spans", "with_instants_and_counters"])
def test_chrome_trace_equal_jax(case):
    """Spans, instants and goodput counters emitted through each package's
    tracer on the same fake clock: ``to_chrome_trace`` gives the same
    JSON."""
    outs = []
    for reg_mod, tr_mod in ((treg, ttrace), (jreg, jtrace)):
        clock = iter(np.arange(0.0, 100.0, 0.013).tolist())
        reg = reg_mod.MetricsRegistry(process_index=1)
        reg.set_clock(lambda: 5.0)
        sink = reg.add_sink(reg_mod.MemorySink())
        tracer = tr_mod.Tracer(reg, enabled=True, clock=lambda: next(clock), tid="train")
        for step in range(1, 5):
            with tracer.span("step", cat="train", step=step):
                with tracer.span("dispatch", cat="train", tid="train.phase", step=step):
                    pass
            tracer.emit_span("data_wait", 0.5 * step, 0.5 * step + 0.01, cat="train",
                             tid="train.phase", step=step)
            if case != "train_spans":
                tracer.instant("mark", cat="train", step=step)
                reg.emit("counter", name="goodput_pct", value=90.0 + step, step=step)
                reg.emit("anomaly", step=step, reason="x", action="warn")
        outs.append(json.dumps(tr_mod.to_chrome_trace(sink.events), sort_keys=True))
    assert outs[0] == outs[1]


def test_compile_watcher_reads_the_build_listener(monkeypatch):
    """The watcher hears ``_build``'s listener while active: a
    ``build_all`` that built libraries reports its seconds and count, one
    that built nothing (every library on disk) reports nothing, and a
    deactivated watcher hears nothing."""
    from dtc_tpu_torch.ops import _build

    w = CompileWatcher().activate()
    try:
        _build._notify(1.5, 2)
        assert w.drain() == (1.5, 2)
        monkeypatch.setattr(_build, "_start", lambda name: (None, None))
        _build.build_all(["flash_attention"])
        assert w.drain() == (0.0, 0)
    finally:
        w.deactivate()
    _build._notify(3.0, 1)
    assert w.drain() == (0.0, 0)


def test_startup_compile_event_carries_the_build(tmp_path):
    """``record_startup_compile`` emits the step-0 ``compile`` event with
    the build seconds heard so far, 0 with nothing built; a library first
    built inside a later step is an ``aux_compile``, never a
    ``recompile``."""
    from dtc_tpu_torch.ops import _build

    for built in (False, True):
        tele = Telemetry(output_dir=str(tmp_path / str(built)))
        sink = tele.registry.add_sink(treg.MemorySink())
        try:
            if built:
                _build._notify(2.0, 3)
            tele.record_startup_compile()
            for step in (1, 2):
                tele.on_step_start(step)
                if built and step == 2:
                    _build._notify(0.5, 1)
                tele.on_step_end(step, elapsed_s=0.1 * step, synced=True)
        finally:
            tele.close()
        compile_ev = [e for e in sink.events if e["etype"] == "compile"]
        assert [(e["compile_time_s"], e["count"]) for e in compile_ev] == (
            [(2.0, 3)] if built else [(0.0, 0)])
        aux = [e for e in sink.events if e["etype"] == "aux_compile"]
        assert [(e["step"], e["what"]) for e in aux] == ([(2, "first_use")] if built else [])
        assert not [e for e in sink.events if e["etype"] == "recompile"]
        assert tele.registry.gauge("compile_time_s").value == (2.5 if built else 0.0)


# ---------------------------------------------------------------------------
# the trainer's event stream against JAX's train()
# ---------------------------------------------------------------------------

STREAM_RUN = dict(steps=6, warmup_steps=2, log_every=2, eval_every=3, checkpoint_every=3,
                  eval_batches=2)


def _dev_model():
    return js.ModelConfig(vocab_size=97, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                          max_seq_len=64, dropout=0.0, param_dtype="float32",
                          compute_dtype="float32", attention="dense")


JAX_OPT = js.OptimConfig(lr=1e-3, weight_decay=0.1, grad_clip=1.0)


@pytest.fixture(scope="session")
def jax_obs_run(tmp_path_factory):
    """JAX's ``train()`` with telemetry on, once a session (the first xdist
    worker to ask, under a file lock): its shard's events, its
    ``summary.json`` and the flax init the port starts from."""
    import pickle

    from filelock import FileLock

    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    out = base / "jax_obs_oracle"
    with FileLock(str(out) + ".lock"):
        if not (out / "done").exists():
            from dtc_tpu.train.trainer import train as jtrain
            from tests.conftest import make_train_cfg
            from tests.test_torch_train import _flax_params

            out.mkdir(exist_ok=True)
            cfg = make_train_cfg("dp", output_dir=str(out / "run"),
                                 checkpoint_dir=str(out / "ckpt"), **STREAM_RUN)
            jtrain(cfg, _dev_model(), JAX_OPT)
            with open(out / "init.pkl", "wb") as f:
                pickle.dump(_flax_params(_dev_model()), f)
            (out / "done").write_text("")
    with open(out / "init.pkl", "rb") as f:
        init = pickle.load(f)
    events = treg.read_jsonl(str(out / "run" / "obs" / "events.r0.jsonl"))
    summary = json.loads((out / "run" / "obs" / "summary.json").read_text())
    return events, summary, init


def _port_cfg(out: Path, **over):
    from tests.conftest import make_train_cfg

    kw = dict(STREAM_RUN, output_dir=str(out), checkpoint_dir=str(out / "ckpt"))
    kw.update(over)
    return _build(ts.TrainConfig, dataclasses.asdict(make_train_cfg("dp", **kw)), "train")


def _port(cls, cfg):
    return _build(cls, dataclasses.asdict(cfg), "test")


@pytest.fixture(scope="module")
def port_obs_run(tmp_path_factory, jax_obs_run):
    """The port's run of the same config from the same weights: its output
    directory and result."""
    out = tmp_path_factory.mktemp("port_obs_run")
    res = trainer_mod.train(_port_cfg(out), _port(ts.ModelConfig, _dev_model()),
                            _port(ts.OptimConfig, JAX_OPT), device="cpu",
                            params=jax_obs_run[2])
    return out, res


def test_event_stream_matches_jax_train(jax_obs_run, port_obs_run):
    """The same event types in the same order (JAX's ``aux_compile`` aside),
    the same keys, ``train_row`` and ``eval`` values within 2e-4, every
    step's parts summing to its ``step_time_s`` within 1e-9, ``summary.json``
    with JAX's keys, ``log.csv`` and ``eval_log.csv`` with the port's rows."""
    jax_events, jax_summary, _ = jax_obs_run
    out, res = port_obs_run
    events = treg.read_jsonl(str(out / "obs" / "events.r0.jsonl"))
    want = [e for e in jax_events if e["etype"] != "aux_compile"]
    assert not [e for e in events if e["etype"] in ("aux_compile", "recompile")]
    assert [(e["etype"], e.get("name")) for e in events] == [
        (e["etype"], e.get("name")) for e in want]
    for got, ref in zip(events, want):
        assert set(got) == set(ref), (got["etype"], set(got) ^ set(ref))
        if got["etype"] in ("train_row", "eval"):
            assert got["step"] == ref["step"]
            np.testing.assert_allclose(got["loss"], ref["loss"], rtol=2e-4)
        if got["etype"] == "step":
            parts = got["data_wait_s"] + got["dispatch_s"] + got["block_s"] + got["other_s"]
            assert abs(parts - got["step_time_s"]) <= 1e-9
    summary = json.loads((out / "obs" / "summary.json").read_text())
    assert set(summary) == set(jax_summary) == {"summary", "hosts"}
    assert set(summary["summary"]) == set(jax_summary["summary"])
    assert set(summary["hosts"]) == set(jax_summary["hosts"])
    rows = (out / "log.csv").read_text().splitlines()
    assert rows[0] == "step,elapsed_time,loss" and len(rows) == 7
    assert [float(r.split(",")[2]) for r in rows[1:]] == res.losses
    assert (out / "eval_log.csv").read_text().splitlines()[1:] == [
        f"{s},{v}" for s, v in res.eval_losses]


def test_jax_readers_read_the_port_run(port_obs_run):
    """JAX's ``find_shards`` and ``GoodputLedger`` over the port's ``obs/``
    directory give the port's own shards and ledger exactly, and JAX's
    reducer the port's ``hosts`` record."""
    out, _ = port_obs_run
    obs = str(out / "obs")
    assert jagg.find_shards(obs) == tagg.find_shards(obs) == {
        0: str(out / "obs" / "events.r0.jsonl")}
    mine = tgood.GoodputLedger.from_dir(obs).summary()
    assert jgood.GoodputLedger.from_dir(obs).summary() == mine
    assert mine["fleet"]["seconds"]["productive_train"] > 0
    hosts = [e for e in treg.read_jsonl(tagg.shard_path(obs, 0)) if e["etype"] == "hosts"]
    want = {k: v for k, v in hosts[0].items() if k not in ("etype", "ts", "proc")}
    got = jagg.reduce_shards(obs, 1.5)
    # The port's record was reduced before its own hosts event was written.
    assert got["hosts"] == want["hosts"] and got["stragglers"] == want["stragglers"]


# ---------------------------------------------------------------------------
# the trainer's behaviours
# ---------------------------------------------------------------------------

TINY = ts.ModelConfig(vocab_size=97, d_model=32, n_layers=2, n_heads=2, d_ff=64,
                      max_seq_len=32, dropout=0.1, compute_dtype="float32")
TINY_OPT = ts.OptimConfig(lr=1e-3, weight_decay=0.1, grad_clip=1.0)


def _tiny_cfg(out: Path, **over):
    cfg = ts.TrainConfig(seed=0, parallel="dp", batch=4, steps=6, log_every=2,
                         output_dir=str(out), dataset="synthetic", warmup_steps=1, prefetch=2)
    return dataclasses.replace(cfg, **over)


def _shard(out: Path):
    return treg.read_jsonl(str(out / "obs" / "events.r0.jsonl"))


def _losses(out: Path):
    return [r.split(",")[2] for r in (out / "log.csv").read_text().splitlines()[1:]]


def test_telemetry_moves_no_value(tmp_path):
    """At dropout 0.1 the losses of ``log.csv`` with telemetry on, a
    device-profile window over steps 4-5 included, equal those with it off,
    bit for bit (as written and as returned)."""
    on = trainer_mod.train(
        _tiny_cfg(tmp_path / "on", obs=ts.ObsConfig(devprof_every=4)), TINY, TINY_OPT,
        device="cpu")
    off = trainer_mod.train(
        _tiny_cfg(tmp_path / "off", obs=ts.ObsConfig(enabled=False)), TINY, TINY_OPT,
        device="cpu")
    assert on.losses == off.losses
    assert _losses(tmp_path / "on") == _losses(tmp_path / "off")
    assert [e["etype"] for e in _shard(tmp_path / "on")].count("devprof") == 1
    assert not (tmp_path / "off" / "obs").exists()


def test_unwritable_profiler_dir_warns_and_the_run_goes_on(tmp_path, capsys):
    """``profile_start``/``profile_stop`` whose ``profile/`` directory
    cannot be made (a file stands there): the window warns and disables at
    its stop, the run ends with every row; a later window in the process
    still captures."""
    out = tmp_path / "run"
    out.mkdir()
    (out / "profile").write_text("a file where the directory would go")
    res = trainer_mod.train(_tiny_cfg(out, profile_start=2, profile_stop=3), TINY, TINY_OPT,
                            device="cpu")
    assert len(res.losses) == 6 and len(_losses(out)) == 6
    assert "disabling trace capture" in capsys.readouterr().out
    p = StepWindowProfiler(1, 2, str(tmp_path / "ok"))
    p.step(1)
    p.step(2)
    assert p.enabled and p.failed is None and (tmp_path / "ok" / "profile.trace.json.gz").exists()


def test_second_profiler_session_disables(tmp_path, capsys):
    """A profiler session already open in the process: the window refuses
    to take it over (torch would), warns and disables; the outer session
    keeps its events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as outer:
        p = StepWindowProfiler(1, 2, str(tmp_path / "inner"))
        p.step(1)
        assert not p.enabled and p.failed is not None
        torch.ones(3).sum()
    assert "disabling trace capture" in capsys.readouterr().out
    assert any(e.name == "aten::sum" for e in outer.events())


def test_watchdog_flag_arms_a_profile_window_and_dumps_the_flight_recorder(
        tmp_path, monkeypatch):
    """A step 20x the trailing median under the watchdog with
    ``profile_on_flag``: a ``hung_step`` event, the flight recorder dumped
    with reason ``hung_step``, and a profile window over the next 2 steps
    written to ``profile/``."""
    import time

    real = trainer_mod.train_step
    calls = {"n": 0}

    def slow_step(*a, **k):
        calls["n"] += 1
        if calls["n"] == 7:  # loop step 6 (1 warmup step)
            time.sleep(0.5)
        return real(*a, **k)

    monkeypatch.setattr(trainer_mod, "train_step", slow_step)
    wd = ts.WatchdogConfig(enabled=True, factor=5.0, min_samples=3, profile_on_flag=True)
    cfg = _tiny_cfg(tmp_path, steps=9, resilience=ts.ResilienceConfig(watchdog=wd))
    trainer_mod.train(cfg, TINY, TINY_OPT, device="cpu")
    events = _shard(tmp_path)
    hung = [e for e in events if e["etype"] == "hung_step"]
    assert [e["step"] for e in hung] == [6]
    dump = ttrace.load_flight_dump(str(tmp_path / "obs" / "flight.r0.json"))
    assert dump["reason"] == "hung_step" and dump["step"] == 6
    assert (tmp_path / "profile" / "profile.trace.json.gz").exists()


def test_sigterm_and_anomaly_dump_the_flight_recorder(tmp_path, monkeypatch):
    """A NaN loss at step 2 (no checkpoint: the guard warns) dumps the
    flight recorder with the anomaly; a SIGTERM at step 3 dumps it again
    with reason ``sigterm`` before the graceful stop."""
    real = trainer_mod.train_step
    calls = {"n": 0, "nan": 3, "term": None}  # counted with the 1 warmup step

    def step(*a, **k):
        calls["n"] += 1
        loss = real(*a, **k)
        if calls["n"] == calls["nan"]:
            return loss * float("nan")
        if calls["n"] == calls["term"]:
            os.kill(os.getpid(), signal.SIGTERM)
        return loss

    monkeypatch.setattr(trainer_mod, "train_step", step)
    trainer_mod.train(_tiny_cfg(tmp_path / "nan", steps=2), TINY, TINY_OPT, device="cpu")
    dump = ttrace.load_flight_dump(str(tmp_path / "nan" / "obs" / "flight.r0.json"))
    assert dump["reason"].startswith("anomaly: non-finite loss") and dump["step"] == 2
    assert [e["step"] for e in dump["events"] if e["etype"] == "anomaly"] == [2]
    spans = [e for e in dump["events"] if e["etype"] == "span" and e["name"] == "step"]
    assert spans[-1]["step"] == 2

    calls.update(n=0, nan=None, term=4)
    res = trainer_mod.train(_tiny_cfg(tmp_path / "term"), TINY, TINY_OPT, device="cpu")
    assert len(res.losses) == 3
    dump = ttrace.load_flight_dump(str(tmp_path / "term" / "obs" / "flight.r0.json"))
    assert dump["reason"] == "sigterm" and dump["step"] == 3


def test_tiny_training_slo_objective_breaches_and_triggers_a_capture(tmp_path):
    """``step_time_p99_s`` 1e-9 (checked every step from the first
    sample): an ``slo_breach`` during the run, the step spans' durations
    equal to the step events', and the breach's device-profile capture
    (``devprof_on_trigger``) landed."""
    from dtc_tpu_torch.obs import find_captures

    slo = ts.SloConfig(step_time_p99_s=1e-9, window=8, min_samples=1, check_every=1)
    trainer_mod.train(_tiny_cfg(tmp_path, steps=4, slo=slo), TINY, TINY_OPT, device="cpu")
    events = _shard(tmp_path)
    breaches = [e for e in events if e["etype"] == "slo_breach"]
    assert breaches and breaches[0]["objective"] == "step_time_p99_s"
    steps = {e["step"]: e for e in events if e["etype"] == "step"}
    spans = [e for e in events if e["etype"] == "span" and e["name"] == "step"]
    assert [e["step"] for e in spans] == [1, 2, 3, 4]
    for e in spans:
        assert e["dur_s"] == pytest.approx(steps[e["step"]]["step_time_s"], abs=2e-6)
    caps = find_captures(str(tmp_path / "obs" / "devprof"))
    assert len(caps) == 1 and "slo_breach" in caps[0]


def test_cli_runs_a_committed_config_without_no_obs(tmp_path):
    """``python -m dtc_tpu_torch.main`` on ``train_config_dp.yaml`` with the
    dev model, telemetry as the config leaves it (on), on the CPU: exit 0,
    the shard, ``summary.json`` and ``log.csv``."""
    out = subprocess.run(
        [sys.executable, "-m", "dtc_tpu_torch.main", "--train_config_path",
         str(ROOT / "configs" / "train_config_dp.yaml"), "--model_config_path",
         str(ROOT / "configs" / "model_config_dev.yaml"), "--dataset", "synthetic",
         "--steps", "3", "--output_dir", str(tmp_path), "--device", "cpu"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    events = _shard(tmp_path)
    assert [e["step"] for e in events if e["etype"] == "step"] == [1, 2, 3]
    assert json.loads((tmp_path / "obs" / "summary.json").read_text())["summary"]["steps"] == 3
    assert len((tmp_path / "log.csv").read_text().splitlines()) == 4


def test_memory_samples_are_null_on_the_cpu():
    from dtc_tpu_torch.obs import hbm_watermark, sample_memory

    assert sample_memory("cpu") is None
    assert hbm_watermark("cpu") == {"peak_hbm_bytes": None, "hbm_bytes_in_use": None}
