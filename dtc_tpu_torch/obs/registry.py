"""Metrics registry: typed instruments + event sinks.

The repo's original instruments were a 3-column CSV writer and an inline
MFU print buried in the trainer. This registry is the one funnel every
runtime (trainer, bench, future pipeline/generate runtimes) emits through:

- **instruments** — named counters, gauges, timers, and histograms whose
  current values land in the run summary (``snapshot()``);
- **events** — structured records (``emit(etype, **fields)``) fanned out
  to sinks: a JSONL shard per process (the telemetry stream the
  multi-host reducer consumes, see :mod:`dtc_tpu_torch.obs.aggregate`) and a
  back-compat CSV sink that keeps ``log.csv`` byte-compatible with the
  reference schema so ``plot.py`` and the committed ``outputs/``
  artifacts keep working.

Everything here is host-side pure Python — no device imports — so it can be
unit-tested without a backend and never adds device work to the step.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import IO, Any, Callable

from dtc_tpu_torch.utils.logging import CSVLogger


class Counter:
    """Monotonic count (events seen, batches fed, recompiles)."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-written value (tokens/s, peak HBM). ``None`` = never set /
    unknown — serialized as JSON null, matching the MFU convention."""

    def __init__(self, name: str):
        self.name = name
        self.value: float | None = None

    def set(self, v: float | None) -> None:
        self.value = v if v is None else float(v)


#: Default log-bucket growth factor for Histogram quantiles: each bucket
#: spans ~10% relative width, so any reported pNN is within one 10%
#: bucket of the exact nearest-rank value (the parity tests pin this
#: bound).
HIST_BUCKET_GROWTH = 1.1
_LOG_GROWTH = math.log(HIST_BUCKET_GROWTH)


class HistogramLayoutError(ValueError):
    """Two histograms with different bucket layouts were merged.

    Bucket indices are only comparable under the SAME growth factor — a
    cross-layout merge would sum counts of buckets covering different
    value ranges and silently corrupt every percentile downstream (the
    cross-shard reducer pools dozens of per-replica histograms; one
    mismatched shard must fail loudly, not skew the fleet's p99)."""


class Histogram:
    """Streaming summary with fixed log-bucketed quantiles.

    Originally count/sum/min/max only — which could not answer the
    p50/p99 questions the serving SLOs are phrased in, forcing bench.py
    to hold private per-request sample lists. Observations now also land
    in log-spaced buckets (relative width ``HIST_BUCKET_GROWTH``-1 ≈ 10%,
    O(hundreds) of buckets over the microsecond..hour range, O(1) per
    observe), so ``percentile(q)`` answers within one bucket width of the
    exact nearest-rank value without retaining samples for a 5000-step
    (or million-request) run. ``summary()`` keeps the original keys
    byte-compatible and adds ``p50/p90/p99``.
    """

    def __init__(self, name: str, *, bucket_growth: float = HIST_BUCKET_GROWTH):
        if bucket_growth <= 1.0:
            raise ValueError(
                f"histogram {name}: bucket_growth must be > 1.0 "
                f"(got {bucket_growth})"
            )
        self.name = name
        self.bucket_growth = float(bucket_growth)
        self._log_growth = math.log(self.bucket_growth)
        self.reset()

    def reset(self) -> None:
        """Forget every observation (bench uses this to drop warmup
        samples measured through the same engine/registry)."""
        self.count = 0
        self.total = 0.0
        self.min: float | None = None
        self.max: float | None = None
        # bucket index -> count; non-positive values (durations clamp at
        # 0.0) share one underflow bucket keyed None.
        self._buckets: dict[int | None, int] = {}

    def observe(self, v: float) -> None:
        v = float(v)
        if not math.isfinite(v):
            return
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        idx = None if v <= 0.0 else math.floor(math.log(v) / self._log_growth)
        self._buckets[idx] = self._buckets.get(idx, 0) + 1

    @property
    def mean(self) -> float | None:
        return self.total / self.count if self.count else None

    def percentile(self, q: float) -> float | None:
        """Nearest-rank quantile over the bucketed counts: the returned
        value is the geometric midpoint of the bucket holding the
        nearest-rank sample (clamped to the observed [min, max]), so it
        is within one bucket width of the exact sample value."""
        if not self.count:
            return None
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        rank = max(1, math.ceil(q * self.count))
        seen = 0
        # The None (<= 0) bucket holds the smallest values — walk it first.
        for idx in sorted(self._buckets, key=lambda i: (i is not None, i)):
            seen += self._buckets[idx]
            if seen >= rank:
                if idx is None:
                    return max(0.0, self.min if self.min is not None else 0.0)
                mid = math.exp((idx + 0.5) * self._log_growth)
                return min(max(mid, self.min), self.max)
        return self.max  # unreachable: counts always cover rank

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other``'s observations into this histogram, in place.

        Bucket counts sum — legal ONLY when both sides share the same
        log-bucket layout (a merged histogram's ``percentile`` then
        equals a single histogram fed the concatenated samples —
        exactly, not within a bucket; the unit tests pin this, along
        with merge-order invariance). A layout mismatch raises
        :class:`HistogramLayoutError` instead of silently summing
        incomparable bucket indices. This is how the cross-shard reducer
        pools per-replica latency distributions without re-deriving them
        from raw ``serve_request`` samples."""
        if other.bucket_growth != self.bucket_growth:
            raise HistogramLayoutError(
                f"cannot merge histogram {other.name!r} "
                f"(bucket_growth={other.bucket_growth}) into "
                f"{self.name!r} (bucket_growth={self.bucket_growth}): "
                "bucket indices are not comparable across layouts"
            )
        self.count += other.count
        self.total += other.total
        if other.min is not None:
            self.min = other.min if self.min is None else min(self.min, other.min)
        if other.max is not None:
            self.max = other.max if self.max is None else max(self.max, other.max)
        for idx, n in other._buckets.items():
            self._buckets[idx] = self._buckets.get(idx, 0) + n
        return self

    def summary(self) -> dict[str, float | int | None]:
        return {
            "count": self.count,
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
            "total": self.total,
            "p50": self.percentile(0.50),
            "p90": self.percentile(0.90),
            "p99": self.percentile(0.99),
        }


class Timer:
    """A histogram observed via context manager — wall-clock phases."""

    def __init__(self, name: str):
        self.name = name
        self.hist = Histogram(name)
        self.last: float | None = None

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.last = time.perf_counter() - self._t0
        self.hist.observe(self.last)


# --------------------------------------------------------------------------
# sinks


class JsonlSink:
    """One JSON object per line, one file per process.

    The shard name encodes the process index (``events.r<k>.jsonl``) so the
    process-0 reducer can discover sibling shards on a shared filesystem
    and still degrade to single-shard mode when there is only its own.

    ``max_bytes > 0`` enables size-based rotation: once the live file
    crosses the threshold it is renamed to the next numbered segment
    (``events.r0.jsonl.1``, ``.2``, … — chronological order, newest
    segment highest) and a fresh live file opened, so a long serving run
    does not grow one unbounded file per process. Readers
    (:func:`read_jsonl`, :func:`dtc_tpu_torch.obs.aggregate.find_shards`)
    discover the rotated segments transparently.
    """

    def __init__(self, path: str, append: bool = False, max_bytes: int = 0):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.max_bytes = int(max_bytes)
        # append=True on resumed runs: truncating would wipe the preempted
        # run's events — the prefix the crash-survival contract preserved.
        self._fh: IO | None = open(path, "a" if append else "w")
        self._size = os.path.getsize(path) if append else 0

    def write(self, event: dict[str, Any]) -> None:
        if self._fh is None:
            return
        line = json.dumps(event, sort_keys=False) + "\n"
        self._fh.write(line)
        self._size += len(line)
        if self.max_bytes > 0 and self._size >= self.max_bytes:
            self._rotate()

    def _rotate(self) -> None:
        """Seal the live file as the next numbered segment. Rotation never
        renames existing segments (a crash mid-rotation loses nothing);
        a rename failure (exotic filesystems) degrades to no rotation
        rather than losing the stream."""
        assert self._fh is not None
        self._fh.close()
        n = 1
        while os.path.exists(f"{self.path}.{n}"):
            n += 1
        try:
            os.replace(self.path, f"{self.path}.{n}")
        except OSError as e:
            print(f"[dtc_tpu_torch] WARNING: JSONL rotation failed ({e})")
            self._fh = open(self.path, "a")
            self.max_bytes = 0  # don't retry every write
            return
        self._fh = open(self.path, "w")
        self._size = 0

    def flush(self) -> None:
        if self._fh:
            self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


class CsvSink:
    """Back-compat bridge: events of one type become CSV rows.

    Keeps the reference's ``log.csv`` schema (``step, elapsed_time, loss``)
    alive while everything else moves to structured events — ``plot.py``,
    ``tests/test_artifacts.py``, and the reference's own tooling read this
    file unchanged. ``append`` continues a resumed run's file.
    """

    def __init__(self, path: str, fieldnames: tuple[str, ...], etype: str,
                 append: bool = False):
        self.etype = etype
        self._fieldnames = fieldnames
        self._csv = CSVLogger(path, fieldnames, append=append)

    def write(self, event: dict[str, Any]) -> None:
        if event.get("etype") != self.etype:
            return
        self._csv.log(**{k: event[k] for k in self._fieldnames if k in event})

    def flush(self) -> None:
        self._csv.flush()

    def close(self) -> None:
        self._csv.close()


class MemorySink:
    """Collect events in a list — bench.py and tests read results back
    without touching the filesystem."""

    def __init__(self):
        self.events: list[dict[str, Any]] = []

    def write(self, event: dict[str, Any]) -> None:
        self.events.append(event)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


# --------------------------------------------------------------------------
# registry


class MetricsRegistry:
    """Instrument factory + event bus.

    ``emit`` stamps each event with its type, a wall-clock timestamp, and
    the emitting process index, then fans it out to every sink. Instrument
    getters are idempotent: ``counter("recompiles")`` returns the same
    object every call, so call sites never coordinate.
    """

    def __init__(self, process_index: int = 0):
        self.process_index = process_index
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._timers: dict[str, Timer] = {}
        self._hists: dict[str, Histogram] = {}
        self._sinks: list[Any] = []
        self._clock: Callable[[], float] = time.time

    def add_sink(self, sink: Any) -> Any:
        self._sinks.append(sink)
        return sink

    def set_clock(self, clock: Callable[[], float]) -> None:
        """Repoint the ``ts`` stamp at a runtime's own clock. The serving
        engine does this so event ``ts``, span ``t0``, and the SLO
        timings on its results all share ONE timebase (tests inject fake
        clocks; the trace exporter orders by these stamps)."""
        self._clock = clock

    # -- instruments ------------------------------------------------------
    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge(name))

    def timer(self, name: str) -> Timer:
        return self._timers.setdefault(name, Timer(name))

    def histogram(self, name: str) -> Histogram:
        return self._hists.setdefault(name, Histogram(name))

    def drop_histogram(self, name: str) -> None:
        """Forget one histogram (no-op when absent). For DYNAMICALLY named
        instruments (the serving engine's per-tenant histograms): a
        long-lived process must prune the instrument when its subject is
        retired, or registry memory grows with every name ever seen."""
        self._hists.pop(name, None)

    # -- events -----------------------------------------------------------
    def emit(self, etype: str, **fields: Any) -> dict[str, Any]:
        event: dict[str, Any] = {
            "etype": etype,
            "ts": self._clock(),
            "proc": self.process_index,
        }
        event.update(fields)
        for sink in self._sinks:
            sink.write(event)
        return event

    def snapshot(self) -> dict[str, Any]:
        """Current instrument values, JSON-ready — the run summary body."""
        out: dict[str, Any] = {}
        for n, c in self._counters.items():
            out[n] = c.value
        for n, g in self._gauges.items():
            out[n] = g.value
        for n, h in self._hists.items():
            out[n] = h.summary()
        for n, t in self._timers.items():
            out[n] = t.hist.summary()
        return out

    def flush(self) -> None:
        for sink in self._sinks:
            sink.flush()

    def close(self) -> None:
        for sink in self._sinks:
            sink.close()
        self._sinks = []


def rotated_segments(path: str) -> list[str]:
    """Every on-disk file of one logical shard, chronologically: rotated
    segments ``path.1``, ``path.2``, … (numeric order) then the live
    ``path`` itself — only files that exist."""
    import glob as _glob
    import re as _re

    segs = []
    for p in _glob.glob(f"{path}.*"):
        m = _re.fullmatch(_re.escape(path) + r"\.(\d+)", p)
        if m:
            segs.append((int(m.group(1)), p))
    out = [p for _, p in sorted(segs)]
    if os.path.exists(path):
        out.append(path)
    return out


def read_jsonl(path: str) -> list[dict[str, Any]]:
    """Parse one logical JSONL shard — rotated segments included, in
    chronological order — skipping any torn final line per file (a
    crashed or still-running writer leaves one; the stream's whole point
    is surviving that)."""
    events = []
    for seg in rotated_segments(path) or [path]:
        with open(seg) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    return events
