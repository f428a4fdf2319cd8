"""Telemetry facade: the hook surface the trainer (and, through
:meth:`Telemetry.for_serving`, the serving engine) emits through.

One object owns the registry, sinks, step clock, compile watcher, memory
sampler and profilers; the trainer talks to it through a small hook
interface::

    tele.on_run_start(...)
    tele.on_step_start(step)
    with tele.clock.phase("data_wait"): ...
    tele.on_step_end(step, elapsed_s=..., synced=...)
    tele.on_eval(step, loss, duration_s)
    tele.on_run_end(...); tele.close()

Event stream schema (JSONL, one shard per process, the JAX package's, so
its readers — ``find_shards``, the goodput ledger,
``scripts/goodput_report.py`` — take a port run):

- ``run_start``    — config fingerprint: strategy, mesh, batch, devices;
- ``compile``      — the startup compile, labeled step 0: in the port the
                     CUDA kernel libraries' build and first load (0 on the
                     CPU, where nothing is built);
- ``step``         — per-step breakdown: ``data_wait_s``, ``dispatch_s``,
                     ``block_s``, ``other_s``, ``step_time_s``,
                     cumulative ``elapsed_s``;
- ``train_row``    — the CSV-schema row (step, elapsed_time, loss), also
                     bridged to ``log.csv`` by the CSV sink;
- ``window``       — log-boundary throughput: avg step time, tokens/s, MFU;
- ``eval``         — held-out eval loss (bridged to ``eval_log.csv``);
- ``memory``       — the card's memory sample (``null`` stats on the CPU);
- ``hosts``        — cross-process reduction + straggler flags (lead only);
- ``anomaly``      — the guard detected an unhealthy loss window
                     (``reason``, chosen ``action``);
- ``recovery``     — a recovery action executed (``action``: rollback,
                     rollback_failed, skip_checkpoint, abort, and from the
                     recovery bus stream_retry, ckpt_fallback);
- ``chaos``        — a fault the chaos harness injected (``kind``), from
                     the recovery bus (:meth:`Telemetry.drain_recovery_bus`);
- ``hung_step``    — watchdog flag: a step exceeded the configured multiple
                     of the trailing median step time;
- ``host_lost`` / ``host_slow`` / ``elastic_resize`` / ``elastic_spill`` —
                     elastic training (:meth:`Telemetry.on_elastic`); the
                     hot tier's ``snapshot`` commits arrive on the bus;
- ``aux_compile``  — a kernel library built and loaded at its first use
                     after the startup (an eval, a boundary);
- ``devprof``      — a device-profile capture landed (its directory);
- ``slo_breach`` / ``slo_recovered`` — a training objective's edges;
- ``span``         — host phases (step, data_wait, dispatch, block, eval,
                     checkpoint) for the Chrome-trace export;
- ``run_summary``  — totals: tokens/s, MFU, peak memory, compile seconds,
                     est. comm bytes per step;
- ``counter``      — online goodput gauge sample (``name``: goodput_pct,
                     ``value``); the offline truth is the goodput ledger
                     (:mod:`dtc_tpu_torch.obs.goodput`) over this stream.

The eager port compiles nothing per step, so it never emits
``recompile``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable

from dtc_tpu_torch.obs.aggregate import reduce_shards, shard_path
from dtc_tpu_torch.obs.device import peak_hbm_bytes, sample_memory
from dtc_tpu_torch.obs.devprof import DeviceProfiler
from dtc_tpu_torch.obs.goodput import OnlineGoodput
from dtc_tpu_torch.obs.profiling import StepWindowProfiler
from dtc_tpu_torch.obs.registry import CsvSink, JsonlSink, MetricsRegistry
from dtc_tpu_torch.obs.slo import SloMonitor
from dtc_tpu_torch.obs.stepclock import CompileWatcher, StepClock
from dtc_tpu_torch.obs.trace import FlightRecorder, Tracer


def drain_bus(bus: Any, registry: MetricsRegistry, key: str, at: int,
              on_chaos: Callable[[dict], None] | None = None) -> None:
    """Emit ``bus``'s pending records into ``registry``'s event stream,
    counting ``chaos_injections`` and ``recoveries``; a record without its
    own ``key`` (``step`` or ``iteration``) is stamped ``at``.
    ``on_chaos(fields)`` runs for each chaos record before it is emitted."""
    for etype, fields in bus.drain():
        if etype == "chaos":
            registry.counter("chaos_injections").inc()
            if on_chaos is not None:
                on_chaos(fields)
        elif etype == "recovery":
            registry.counter("recoveries").inc()
        fields.setdefault(key, at)
        registry.emit(etype, **fields)


class Telemetry:
    def __init__(
        self,
        obs_cfg: Any = None,
        *,
        output_dir: str = "",
        lead: bool = True,
        process_index: int = 0,
        profiler: StepWindowProfiler | None = None,
        append: bool = False,
        slo_cfg: Any = None,
        device=None,
    ):
        from dtc_tpu_torch.config.schema import ObsConfig

        self.cfg = obs_cfg if obs_cfg is not None else ObsConfig()
        self.output_dir = output_dir
        self.lead = lead
        self.device = device
        self.registry = MetricsRegistry(process_index=process_index)
        self.clock = StepClock()
        self.compiles = CompileWatcher()
        self.profiler = profiler or StepWindowProfiler(0, 0, "")
        self.obs_dir = ""
        # False until the first timed step completes: build seconds
        # observed before then are startup cost.
        self._steady = False
        self._jsonl: JsonlSink | None = None
        self._closed = False
        # Even with JSONL off, anomaly dumps need a destination.
        self._dump_dir = (
            self.cfg.dir or (os.path.join(output_dir, "obs") if output_dir else "")
        )
        if self.cfg.enabled and self.cfg.jsonl and output_dir:
            self.obs_dir = self.cfg.dir or os.path.join(output_dir, "obs")
            try:
                self._jsonl = self.registry.add_sink(
                    JsonlSink(
                        shard_path(self.obs_dir, process_index), append=append,
                        max_bytes=int(self.cfg.rotate_mb * 1e6),
                    )
                )
            except OSError as e:  # unwritable dir: observe-or-ignore, never crash
                print(f"[dtc_tpu_torch] WARNING: telemetry JSONL disabled ({e})")
                self.obs_dir = ""
        # Spans + flight recorder. Span events ride the same sinks; the
        # recorder is a bounded in-memory ring dumped only at anomaly
        # time, so "always on" costs one deque append per event.
        self.tracer = Tracer(
            self.registry, enabled=self.cfg.enabled and self.cfg.trace,
            clock=time.time, tid="train",
        )
        self.recorder: FlightRecorder | None = None
        if self.cfg.enabled and self.cfg.flight_recorder > 0:
            self.recorder = self.registry.add_sink(
                FlightRecorder(self.cfg.flight_recorder)
            )
        # Online SLO monitor (training objectives); None with all off.
        self.slo = SloMonitor.from_config(slo_cfg, self.registry, runtime="train")
        self._slo_check_every = getattr(slo_cfg, "check_every", 8) or 8
        # Online goodput gauge: fed per-class seconds from the step
        # breakdown — timestamps already taken, never a new sync.
        self.goodput: OnlineGoodput | None = None
        if self.cfg.enabled and getattr(self.cfg, "goodput", True):
            self.goodput = OnlineGoodput(
                self.registry,
                counter_every=getattr(self.cfg, "goodput_counter_every", 8),
            )
        # Device-time observatory: torch.profiler capture windows on
        # cadence (obs.devprof_every), on demand (request_device_profile())
        # and on the SLO-breach / hung-step triggers below when
        # obs.devprof_on_trigger. Artifacts land under <obs dir>/devprof/
        # with meta sidecars; devprof.analyze_capture reads them. Built
        # whenever obs is on (inert until a cadence, trigger or request
        # fires), so the on-demand path works with devprof_every 0.
        self.devprof: DeviceProfiler | None = None
        if self.cfg.enabled and self._dump_dir:
            self.devprof = DeviceProfiler(
                os.path.join(self._dump_dir, "devprof"),
                registry=self.registry,
                every=self.cfg.devprof_every,
                n_steps=self.cfg.devprof_steps,
                device=device,
            )
        self.compiles.activate()

    # -- construction -----------------------------------------------------
    @classmethod
    def for_training(
        cls, train_cfg, *, lead: bool, process_index: int, resumed: bool = False,
        device=None,
    ) -> "Telemetry":
        """Build the trainer's telemetry from its config block.

        The profiler window comes from ``ObsConfig`` when set there,
        falling back to the top-level ``profile_start/profile_stop``
        fields. ``resumed`` runs APPEND to the existing JSONL shard —
        truncating would destroy the preempted run's events. ``device``:
        the card whose memory the samples read.
        """
        obs = train_cfg.obs
        start, stop = obs.profile_start, obs.profile_stop
        if stop <= start:
            start, stop = train_cfg.profile_start, train_cfg.profile_stop
        profiler = StepWindowProfiler(
            start, stop, os.path.join(train_cfg.output_dir, "profile")
        )
        return cls(
            obs,
            output_dir=train_cfg.output_dir,
            lead=lead,
            process_index=process_index,
            profiler=profiler,
            append=resumed,
            slo_cfg=getattr(train_cfg, "slo", None),
            device=device,
        )

    @classmethod
    def for_serving(
        cls, output_dir: str, *, obs_cfg: Any = None, process_index: int = 0
    ) -> "Telemetry":
        """Telemetry for a :class:`dtc_tpu_torch.serve.engine.ServingEngine`:
        the engine emits its SLO instruments and ``serve_*`` events through
        ``.registry`` into the trainer's shard layout
        (``<output_dir>/obs/events.r<k>.jsonl``), so the cross-process
        reducer and the JAX package's readers take a serving run."""
        return cls(
            obs_cfg, output_dir=output_dir, lead=process_index == 0,
            process_index=process_index,
        )

    def add_csv(self, path: str, fieldnames: tuple[str, ...], etype: str,
                append: bool = False) -> CsvSink:
        """Attach a CSV bridge (log.csv / eval_log.csv); ``append`` keeps
        the rows a resumed run's file already holds. CSV output is NOT
        gated on ``obs.enabled`` — the committed artifacts depend on it."""
        return self.registry.add_sink(CsvSink(path, fieldnames, etype, append=append))

    # -- hooks ------------------------------------------------------------
    def on_run_start(self, **meta: Any) -> None:
        self.registry.emit("run_start", **meta)

    def on_step_start(self, step: int) -> None:
        self.profiler.step(step)
        if self.devprof is not None:
            # One profiler session per process: defer devprof windows
            # while the configured window is mid-capture.
            self.devprof.on_step(step, busy=self.profiler._active)
        self.clock.begin(step)

    def on_step_end(self, step: int, *, elapsed_s: float, synced: bool) -> dict:
        """Close the step's clock, fold in any build the step triggered,
        emit the ``step`` event, and sample memory on cadence."""
        breakdown = self.clock.end()
        self.registry.histogram("step_time_s").observe(breakdown["step_time_s"])
        self.registry.histogram("data_wait_s").observe(breakdown["data_wait_s"])
        compile_s, n = self.compiles.drain()
        extra: dict[str, Any] = {}
        if n:
            # A library built (or first loaded) inside the step: on the
            # first timed step that is still startup cost (a warmup-less
            # run); later, a kernel's first use. Never a recompile.
            extra["compile_s"] = round(compile_s, 4)
            self._add_compile_seconds(compile_s)
            if self._steady:
                self._note_aux_compile(step, "first_use", compile_s, n)
        self._steady = True
        self.registry.emit(
            "step",
            step=step,
            elapsed_s=round(elapsed_s, 6),
            synced=synced,
            **breakdown,
            **extra,
        )
        # Step/phase spans, synthesized from the breakdown the clock
        # ALREADY measured (no extra syncs, one wall-clock read). The
        # phases run in loop order data_wait -> dispatch -> block, so
        # laying them end to end from the step start is exact up to the
        # interleaved host overhead other_s accounts for.
        if self.tracer.enabled:
            t1 = time.time()
            t0 = t1 - breakdown["step_time_s"]
            self.tracer.emit_span(
                "step", t0, t1, cat="train", tid="train", step=step
            )
            cursor = t0
            for ph in ("data_wait", "dispatch", "block"):
                d = breakdown[f"{ph}_s"]
                if d > 0:
                    self.tracer.emit_span(
                        ph, cursor, cursor + d, cat="train",
                        tid="train.phase", step=step,
                    )
                    cursor += d
        if self.goodput is not None:
            # Per-class attribution from numbers the clock already
            # measured: build and data-wait seconds are badput, the
            # remainder of the step is productive training.
            dw = breakdown["data_wait_s"]
            cs = float(extra.get("compile_s", 0.0) or 0.0)
            self.goodput.note("data_wait", dw)
            self.goodput.note("compile", cs)
            self.goodput.note(
                "productive_train",
                max(breakdown["step_time_s"] - dw - cs, 0.0),
            )
            pct = self.goodput.update(step=step)
            if self.slo is not None:
                self.slo.observe("goodput_pct", pct)
        if self.slo is not None:
            self.slo.observe("step_time_s", breakdown["step_time_s"])
            self.slo.observe("data_wait_s", breakdown["data_wait_s"])
            if step % self._slo_check_every == 0:
                # evaluate() RETURNS every currently-breaching objective
                # (level); only objectives newly entering the active set
                # (edge) arm a capture — a persistently-breaching run must
                # not re-capture every check until max_captures burns out.
                prev_active = set(self.slo.active)
                breaches = self.slo.evaluate(step=step)
                fresh = [
                    b for b in breaches if b["objective"] not in prev_active
                ]
                if fresh and self.devprof is not None and self.cfg.devprof_on_trigger:
                    self.devprof.request(f"slo_breach:{fresh[0]['objective']}")
        every = self.cfg.memory_sample_every
        if self.cfg.enabled and every > 0 and step % every == 0:
            self.sample_memory(step)
        return breakdown

    def record_aux_compile(self, step: int, what: str) -> None:
        """Drain build seconds of a kernel library first used by an
        auxiliary computation (the eval, a checkpoint's reads) into an
        ``aux_compile`` event, so they are not billed to the next step."""
        compile_s, n = self.compiles.drain()
        self.registry.counter("aux_compiles")  # 0 when nothing was built
        if n:
            self._add_compile_seconds(compile_s)
            self._note_aux_compile(step, what, compile_s, n)

    def _note_aux_compile(self, step: int, what: str, compile_s: float, n: int) -> None:
        self.registry.counter("aux_compiles").inc(n)
        self.registry.emit(
            "aux_compile", step=step, what=what,
            compile_s=round(compile_s, 4), count=n,
        )

    def record_startup_compile(self) -> None:
        """Attribute every build and load so far (the kernel libraries the
        model, warmup and a resume touched) to 'step 0': the ``compile``
        event, with 0 seconds and count 0 when nothing was built (the
        CPU)."""
        compile_s, n = self.compiles.drain()
        self._add_compile_seconds(compile_s)
        self.registry.emit(
            "compile", step=0, compile_time_s=round(compile_s, 4), count=n
        )
        if self.tracer.enabled:
            # Timeline placement is approximate (the seconds accumulated
            # over init/warmup, ending no later than now) — the span's
            # value is its DURATION on the startup track.
            t1 = time.time()
            self.tracer.emit_span(
                "compile", t1 - compile_s, t1, cat="train",
                tid="train.compile", step=0, count=n,
            )

    def _add_compile_seconds(self, compile_s: float) -> None:
        g = self.registry.gauge("compile_time_s")
        g.set(round((g.value or 0.0) + compile_s, 4))

    def on_window(self, step: int, *, avg_step_s: float, tokens_per_sec: float,
                  mfu: float | None) -> None:
        self.registry.gauge("tokens_per_sec").set(tokens_per_sec)
        self.registry.gauge("mfu").set(mfu)
        self.registry.emit(
            "window",
            step=step,
            avg_step_s=round(avg_step_s, 6),
            tokens_per_sec=round(tokens_per_sec, 1),
            mfu=None if mfu is None else round(mfu, 4),
        )

    def emit_train_row(self, step: int, elapsed_time: float, loss: float) -> None:
        self.registry.emit(
            "train_row", step=step, elapsed_time=elapsed_time, loss=loss
        )

    def on_eval(self, step: int, loss: float, duration_s: float | None = None) -> None:
        self.registry.emit(
            "eval",
            step=step,
            loss=loss,
            **({} if duration_s is None else {"duration_s": round(duration_s, 4)}),
        )
        if duration_s is not None and self.tracer.enabled:
            t1 = time.time()
            self.tracer.emit_span(
                "eval", t1 - duration_s, t1, cat="train", tid="eval",
                step=step, loss=round(loss, 4),
            )

    def span(self, name: str, **attrs: Any):
        """Bracket a trainer phase (checkpoint save, rollback) as a span —
        a no-op context manager when tracing is off."""
        return self.tracer.span(name, cat="train", **attrs)

    # -- flight recorder ---------------------------------------------------
    def dump_flight(self, reason: str, **meta: Any) -> str | None:
        """Dump the flight-recorder ring to ``<obs dir>/flight.r<k>.json``
        (atomic; last dump wins the filename, every dump records its
        reason). None when the recorder is off or there is nowhere to
        write."""
        if self.recorder is None or not self._dump_dir:
            return None
        path = os.path.join(
            self._dump_dir, f"flight.r{self.registry.process_index}.json"
        )
        if self.devprof is not None and self.devprof.last_artifact:
            # The newest device-profile capture rides every post-mortem.
            meta.setdefault("devprof_artifact", self.devprof.last_artifact)
        try:
            return self.recorder.dump(path, reason=reason, **meta)
        except OSError as e:  # post-mortem aid must never kill the run
            print(f"[dtc_tpu_torch] WARNING: flight-recorder dump failed ({e})")
            return None

    # -- resilience hooks --------------------------------------------------
    def on_anomaly(self, step: int, *, reason: str, action: str) -> None:
        self.registry.counter("anomalies").inc()
        self.registry.emit("anomaly", step=step, reason=reason, action=action)
        self.dump_flight(f"anomaly: {reason}", step=step, action=action)

    def on_recovery(self, step: int, *, action: str, **fields: Any) -> None:
        self.registry.counter("recoveries").inc()
        self.registry.emit("recovery", step=step, action=action, **fields)
        self._note_restore_badput(
            "rollback_replay" if action == "rollback" else "degraded", fields, step)

    def on_elastic(self, step: int, kind: str, **fields: Any) -> None:
        """Elastic training's events (``host_lost``, ``host_slow``,
        ``elastic_resize``, ``elastic_spill``) into the stream, each with
        its counter; a resize's detect-to-restored gap is noted as
        ``elastic_resize`` badput, and a host loss dumps the flight
        recorder."""
        name = kind if kind.startswith("elastic_") else f"elastic_{kind}"
        self.registry.counter(name).inc()
        self.registry.emit(kind, step=step, **fields)
        if kind == "elastic_resize":
            self._note_restore_badput("elastic_resize", fields, step)
        if kind == "host_lost":
            self.dump_flight("host_lost", step=step)

    def _note_restore_badput(self, klass: str, fields: dict[str, Any], step: int) -> None:
        """Feed the online gauge the detect-to-restored gap when the event
        carries the timestamps (the offline ledger also bills the steps
        discarded)."""
        if self.goodput is None:
            return
        td, tr = fields.get("t_detect"), fields.get("t_restored")
        if isinstance(td, (int, float)) and isinstance(tr, (int, float)):
            self.goodput.note(klass, max(float(tr) - float(td), 0.0))
            pct = self.goodput.update(step=step)
            if self.slo is not None:
                self.slo.observe("goodput_pct", pct)

    def on_hung_step(self, step: int, **fields: Any) -> None:
        self.registry.counter("hung_steps").inc()
        self.registry.emit("hung_step", step=step, **fields)
        if self.devprof is not None and self.cfg.devprof_on_trigger:
            self.devprof.request("hung_step")
        self.dump_flight("hung_step", step=step)

    def drain_recovery_bus(self, bus: Any, step: int) -> None:
        """Move the pending chaos and recovery records of ``bus`` (posted
        from threads and layers with no telemetry handle: the stream's
        retry, the checkpoint fallback, the chaos hooks) into the event
        stream, stamped with the step they surfaced at unless the poster
        recorded its own."""
        drain_bus(bus, self.registry, "step", step)

    def arm_profile_window(self, start_step: int, n_steps: int = 2) -> bool:
        """Point the profiler at ``[start_step, start_step + n_steps)`` —
        used by the watchdog to capture a trace after a hung-step flag.
        No-op (False) when a window is already configured/active or the
        profiler previously failed."""
        p = self.profiler
        if p.enabled or p.failed or not p.log_dir:
            return False
        p.start, p.stop = start_step, start_step + n_steps
        p.enabled = True
        return True

    def request_device_profile(self, reason: str = "on_demand") -> bool:
        """Arm an on-demand devprof capture window at the next step. False
        when the observatory is off, disabled, or already
        capturing/pending."""
        if self.devprof is None:
            return False
        return self.devprof.request(reason)

    def set_device_profile_context(
        self,
        *,
        step_flops: float | None = None,
        peak_flops: float | None = None,
        comm_estimate: dict[str, float] | None = None,
    ) -> None:
        """Attach run context to future capture metas so the offline leg
        can derive device-time MFU and run the collective-census
        cross-check without rebuilding the model."""
        if self.devprof is None:
            return
        self.devprof.step_flops = step_flops
        self.devprof.peak_flops = peak_flops
        self.devprof.comm_estimate = comm_estimate

    def sample_memory(self, step: int) -> None:
        samples = sample_memory(self.device)
        peak = peak_hbm_bytes(samples)
        if peak is not None:
            g = self.registry.gauge("peak_hbm_bytes")
            g.set(peak if g.value is None else max(g.value, peak))
        self.registry.emit("memory", step=step, devices=samples)

    def on_run_end(self, **summary: Any) -> dict[str, Any]:
        """Emit the run summary (+ cross-process reduction on the lead)
        and write ``summary.json`` next to the shards."""
        self.sample_memory(step=-1)
        # Force the key into the summary even when the backend never
        # reported stats: an explicit null (CPU) reads differently from a
        # missing field (telemetry broken).
        self.registry.gauge("peak_hbm_bytes")
        body = dict(self.registry.snapshot())
        body.update(summary)
        self.registry.emit("run_summary", **body)
        self.registry.flush()
        self._barrier()
        hosts = None
        if self.lead and self.obs_dir:
            hosts = reduce_shards(self.obs_dir, self.cfg.straggler_threshold)
            if hosts is not None:
                self.registry.emit("hosts", **hosts)
                if hosts["stragglers"]:
                    print(
                        f"[dtc_tpu_torch] WARNING: straggler process(es) "
                        f"{hosts['stragglers']} (mean step time > "
                        f"{self.cfg.straggler_threshold}x cross-process median)"
                    )
            try:
                with open(os.path.join(self.obs_dir, "summary.json"), "w") as f:
                    json.dump({"summary": body, "hosts": hosts}, f, indent=2)
            except OSError as e:
                print(f"[dtc_tpu_torch] WARNING: could not write summary.json ({e})")
        return {"summary": body, "hosts": hosts}

    def _barrier(self) -> None:
        """Cross-process sync between shard flush and reduction: without
        it the lead reduces while slower ranks' shard tails — exactly the
        straggler evidence — are still unflushed. Nothing in one
        process."""
        import torch.distributed as dist

        if not dist.is_initialized() or dist.get_world_size() < 2:
            return
        try:
            dist.barrier()
        except Exception as e:
            print(f"[dtc_tpu_torch] WARNING: obs pre-reduce barrier failed ({e})")

    # -- lifecycle --------------------------------------------------------
    def flush(self) -> None:
        self.registry.flush()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.profiler.close()
        if self.devprof is not None:
            self.devprof.close()  # finalize a window the run ended inside
        self.compiles.deactivate()
        self.registry.close()
