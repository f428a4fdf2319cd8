"""Spans + flight recorder: the end-to-end tracing substrate.

The registry's event stream answers *what happened*; spans answer *where
the time went* — per training step (data_wait/dispatch/block/compile/
eval/checkpoint, reusing the stepclock's already-measured boundaries, so
tracing adds ZERO device syncs) and per serving request (queued →
prefill → decode iterations → terminal, with chaos/recovery/evict events
attached to the owning request's track). Everything here is host-side
pure Python — no device imports, no device work.

Three pieces:

- :class:`Tracer` — backend-free span API. ``span(name)`` is the context
  manager for code the caller brackets; ``start()``/``end()`` cover
  cross-thread / cross-iteration lifetimes (a serving request lives
  across many scheduler iterations); ``emit_span()`` records a span from
  timestamps the runtime already took (the trainer's step breakdown, the
  engine's request timings) — the zero-overhead path. Completed spans
  are ordinary registry events (``etype: "span"``), so they fan out to
  the same JSONL shards, flight recorder, and tests as every other
  event, and the multi-host story (one shard per process, merged
  offline) is inherited rather than reinvented.

- :class:`FlightRecorder` — an always-on bounded ring of the last N
  events (spans included; it is just another registry sink). ``dump()``
  writes the ring atomically (tmp + ``os.replace``, the checkpoint
  sidecars' discipline) so an anomaly-guard trip, watchdog fire, SIGTERM, or
  unhandled crash leaves a loadable timeline instead of a truncated CSV.

- :func:`to_chrome_trace` — export any event list as Chrome-trace /
  Perfetto JSON (``ph: "X"`` duration events for spans, ``ph: "i"``
  instants for everything else, thread-name metadata so tracks read as
  request ids / trainer phases, timestamps normalized to the run start
  and sorted monotonic). ``scripts/trace_report.py`` is the CLI over it.

Timebase: a tracer stamps spans with ITS clock (default ``time.time``).
The serving engine points both its tracer and its registry at the one
scheduler clock, so span timestamps, event ``ts`` stamps, and the SLO
timings on :class:`~dtc_tpu_torch.serve.request.ServeResult` are directly
comparable — the acceptance tests derive TTFT from span edges and match
the registry histograms exactly.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any, Callable

from dtc_tpu_torch.obs.registry import MetricsRegistry


class SpanHandle:
    """An open span returned by :meth:`Tracer.start` — carry it across
    threads/iterations and hand it back to :meth:`Tracer.end`."""

    __slots__ = ("name", "cat", "tid", "t0", "attrs", "closed")

    def __init__(self, name: str, cat: str, tid: str, t0: float,
                 attrs: dict[str, Any]):
        self.name = name
        self.cat = cat
        self.tid = tid
        self.t0 = t0
        self.attrs = attrs
        self.closed = False


class _SpanCtx:
    __slots__ = ("_tracer", "_handle")

    def __init__(self, tracer: "Tracer", handle: SpanHandle | None):
        self._tracer = tracer
        self._handle = handle

    def __enter__(self) -> "_SpanCtx":
        return self

    def set(self, **attrs: Any) -> None:
        """Attach attributes discovered mid-span (e.g. tokens emitted)."""
        if self._handle is not None:
            self._handle.attrs.update(attrs)

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._handle is not None:
            if exc_type is not None:
                self._handle.attrs.setdefault("error", exc_type.__name__)
            self._tracer.end(self._handle)


class Tracer:
    """Host-side span emitter over a :class:`MetricsRegistry`.

    Disabled tracers (``enabled=False``) no-op every call — call sites
    never branch. Span events carry ``name``, ``cat`` (subsystem),
    ``tid`` (track: "train", a request id, "sched"), ``t0`` (start, this
    tracer's clock), ``dur_s``, ``ph`` ("X" span / "i" instant), plus
    arbitrary JSON-safe attributes.
    """

    def __init__(
        self,
        registry: MetricsRegistry,
        *,
        enabled: bool = True,
        clock: Callable[[], float] = time.time,
        tid: str = "main",
    ):
        self.registry = registry
        self.enabled = enabled
        self.clock = clock
        self.default_tid = tid

    # -- bracketed spans ---------------------------------------------------
    def span(self, name: str, *, cat: str = "", tid: str | None = None,
             **attrs: Any) -> _SpanCtx:
        if not self.enabled:
            return _SpanCtx(self, None)
        return _SpanCtx(self, self.start(name, cat=cat, tid=tid, **attrs))

    # -- explicit lifetimes (cross-thread / cross-iteration) ---------------
    def start(self, name: str, *, cat: str = "", tid: str | None = None,
              **attrs: Any) -> SpanHandle | None:
        if not self.enabled:
            return None
        return SpanHandle(
            name, cat, tid or self.default_tid, self.clock(), dict(attrs)
        )

    def end(self, handle: SpanHandle | None, **attrs: Any) -> None:
        if handle is None or not self.enabled or handle.closed:
            return
        handle.closed = True
        handle.attrs.update(attrs)
        self.emit_span(
            handle.name, handle.t0, self.clock(), cat=handle.cat,
            tid=handle.tid, **handle.attrs,
        )

    # -- pre-timed spans (the zero-overhead path) --------------------------
    def emit_span(self, name: str, t0: float, t1: float, *, cat: str = "",
                  tid: str | None = None, **attrs: Any) -> None:
        """Record a span from timestamps the runtime already measured —
        no extra clock reads, no extra syncs."""
        if not self.enabled:
            return
        self.registry.emit(
            "span", name=name, cat=cat, tid=tid or self.default_tid,
            ph="X", t0=round(float(t0), 6),
            dur_s=round(max(float(t1) - float(t0), 0.0), 6), **attrs,
        )

    def instant(self, name: str, *, cat: str = "", tid: str | None = None,
                t: float | None = None, **attrs: Any) -> None:
        """A zero-duration mark on a track (terminal states, breaches)."""
        if not self.enabled:
            return
        t = self.clock() if t is None else float(t)
        self.registry.emit(
            "span", name=name, cat=cat, tid=tid or self.default_tid,
            ph="i", t0=round(t, 6), dur_s=0.0, **attrs,
        )


class FlightRecorder:
    """Bounded ring of the last ``capacity`` events — a registry sink.

    Always on and always cheap (one deque append per event); ``dump()``
    is the only I/O and only runs at anomaly time. The dump is a single
    JSON document written atomically, so a post-mortem never reads a
    torn file.
    """

    def __init__(self, capacity: int = 256):
        self.capacity = int(capacity)
        self.events: deque[dict[str, Any]] = deque(maxlen=self.capacity)
        self.dumps: list[str] = []  # paths written this run, oldest first

    # registry sink interface
    def write(self, event: dict[str, Any]) -> None:
        self.events.append(event)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    def dump(self, path: str, *, reason: str, **meta: Any) -> str:
        """Write the ring (oldest→newest) + the trigger reason atomically."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        body = {
            "reason": reason,
            "dumped_ts": time.time(),
            "n_events": len(self.events),
            "capacity": self.capacity,
            **meta,
            "events": list(self.events),
        }
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(body, f, indent=1, default=str)
        os.replace(tmp, path)
        self.dumps.append(path)
        return path


def load_flight_dump(path: str) -> dict[str, Any]:
    """Read a flight-recorder dump (the dump is atomic, so this either
    sees the whole document or raises FileNotFoundError)."""
    with open(path) as f:
        return json.load(f)


# --------------------------------------------------------------------------
# Chrome-trace / Perfetto export


def _event_time(e: dict[str, Any]) -> float | None:
    """One timebase per event: spans carry their own ``t0`` (the
    runtime's clock); other events fall back to the registry ``ts``
    stamp (the same clock wherever the runtime pointed the registry at
    it — the serving engine does exactly that)."""
    t = e.get("t0", e.get("ts"))
    return float(t) if isinstance(t, (int, float)) else None


#: Non-span event types worth a mark on the timeline (attached to the
#: owning request's track via their ``rid`` field when present).
_INSTANT_ETYPES = frozenset({
    "chaos", "anomaly", "recovery", "hung_step", "slo_breach",
    "slo_recovered", "recompile", "serve_admit", "serve_evict",
    "serve_reject", "serve_corruption", "serve_request", "serve_shutdown",
    # Fleet-router events: failover/route marks land on the
    # owning rid's track; replica state changes on their own track.
    "router_route", "router_failover", "router_replica_state",
    "router_reject", "router_heartbeat_missed", "router_adapter_load",
    "router_drained",
    # Elastic-training events: hot-tier snapshot commits and
    # the host-loss -> resize -> cold-spill recovery chain, so a
    # trace_report waterfall shows recovery where it happened.
    "snapshot", "host_lost", "host_slow", "elastic_resize",
    "elastic_spill",
    # Goodput ledger: recovery-path compile drains — the
    # recompile cost an incident bill attributes — get a mark where they
    # happened instead of vanishing from the timeline.
    "aux_compile",
    # Resource pool: every lease transition edge, spike,
    # parked/unparked request, grow abort, and chaos host-kill gets an
    # instant, so a merged trace shows the arbitration next to the
    # tenant activity it displaced.
    "pool_transition", "pool_grow_abort", "pool_spike",
    "pool_request_parked", "pool_request_unparked", "pool_host_killed",
    "pool_closed",
})


def to_chrome_trace(events: list[dict[str, Any]]) -> dict[str, Any]:
    """Export events as a Chrome-trace JSON object Perfetto loads.

    Spans (``etype: "span"``, ``ph: "X"``) become duration events;
    span instants and the notable non-span etypes become ``ph: "i"``
    instant marks. ``pid`` is the emitting process index, ``tid`` a
    stable small integer per track name (with ``thread_name`` metadata
    so the UI shows request ids / phase names). Timestamps are
    normalized to the earliest event and emitted in microseconds,
    sorted monotonic — the schema the export tests pin.
    """
    rows: list[tuple[float, dict[str, Any]]] = []
    tids: dict[tuple[int, str], int] = {}

    def tid_for(pid: int, track: str) -> int:
        key = (pid, track)
        if key not in tids:
            tids[key] = len(tids) + 1
        return tids[key]

    base: float | None = None
    for e in events:
        t = _event_time(e)
        if t is None:
            continue
        etype = e.get("etype")
        if etype == "span" or etype == "counter" or etype in _INSTANT_ETYPES:
            if base is None or t < base:
                base = t
    if base is None:
        base = 0.0

    for e in events:
        t = _event_time(e)
        if t is None:
            continue
        etype = e.get("etype")
        pid = int(e.get("proc", 0) or 0)
        if etype == "span":
            track = str(e.get("tid", "main"))
            name = str(e.get("name", "span"))
            ph = "X" if e.get("ph", "X") == "X" else "i"
            dur = float(e.get("dur_s", 0.0) or 0.0)
        elif etype == "counter":
            # Perfetto counter track: the online goodput
            # gauge's periodic samples render as a value-over-time
            # track next to the span timeline.
            name = str(e.get("name", "counter"))
            v = e.get("value")
            rows.append((round((t - base) * 1e6, 1), {
                "name": name, "ph": "C",
                "ts": round((t - base) * 1e6, 1), "dur": 0.0,
                "pid": pid, "tid": tid_for(pid, name), "cat": "counter",
                "args": {name: float(v) if isinstance(v, (int, float)) else 0.0},
            }))
            continue
        elif etype in _INSTANT_ETYPES:
            # Attach to the owning request's track when the event names
            # one — evictions/chaos/corruption land on the request row.
            track = str(e.get("rid") or etype)
            name = str(etype)
            if etype == "serve_request":
                name = f"serve_request:{e.get('state', '?')}"
            ph = "i"
            dur = 0.0
        else:
            continue
        args = {
            k: v for k, v in e.items()
            if k not in ("etype", "ts", "t0", "dur_s", "ph", "name", "tid")
            and isinstance(v, (str, int, float, bool, type(None)))
        }
        row: dict[str, Any] = {
            "name": name,
            "ph": ph,
            "ts": round((t - base) * 1e6, 1),
            "dur": round(dur * 1e6, 1),
            "pid": pid,
            "tid": tid_for(pid, track),
            "cat": str(e.get("cat") or etype),
            "args": args,
        }
        if ph == "i":
            row["s"] = "t"  # thread-scoped instant
        rows.append((row["ts"], row))

    rows.sort(key=lambda r: r[0])
    trace_events = [r for _, r in rows]
    # Thread-name metadata so Perfetto labels tracks with the request id
    # / phase name instead of a bare integer.
    for (pid, track), tid in sorted(tids.items(), key=lambda kv: kv[1]):
        trace_events.append({
            "name": "thread_name", "ph": "M", "ts": 0.0, "dur": 0.0,
            "pid": pid, "tid": tid, "cat": "__metadata",
            "args": {"name": track},
        })
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}
