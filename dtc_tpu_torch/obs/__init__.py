"""Telemetry of training: the port's counterpart of the JAX package's
``obs/``.

Structured metrics (counters/gauges/timers/histograms — histograms carry
log-bucketed p50/p90/p99), a JSONL event stream with size-based rotation
and a CSV bridge (``log.csv``, ``eval_log.csv``), the step-time breakdown
with the kernel libraries' build seconds as the startup compile,
host-side spans with a crash-surviving flight recorder and
Chrome-trace/Perfetto export, an online SLO monitor, the card's memory
sampling, a hardened ``torch.profiler`` window, device-time attribution of
the profiler's trace (:mod:`dtc_tpu_torch.obs.devprof`), and
cross-process shard reduction with straggler detection. The event schema
and shard layout are the JAX package's, so its readers take a port run.
"""

from dtc_tpu_torch.obs.aggregate import find_shards, reduce_shards, shard_path
from dtc_tpu_torch.obs.device import (
    hbm_watermark,
    max_stat,
    peak_hbm_bytes,
    sample_memory,
)
from dtc_tpu_torch.obs.devprof import (
    Attribution,
    CaptureWindow,
    DeviceProfiler,
    OpRow,
    analyze_capture,
    attribute,
    device_op_rows,
    device_rows_to_events,
    find_captures,
)
from dtc_tpu_torch.obs.profiling import StepWindowProfiler
from dtc_tpu_torch.obs.registry import (
    CsvSink,
    Histogram,
    HistogramLayoutError,
    JsonlSink,
    MemorySink,
    MetricsRegistry,
    read_jsonl,
    rotated_segments,
)
from dtc_tpu_torch.obs.slo import Objective, SloMonitor
from dtc_tpu_torch.obs.stepclock import CompileWatcher, StepClock
from dtc_tpu_torch.obs.telemetry import Telemetry
from dtc_tpu_torch.obs.trace import (
    FlightRecorder,
    Tracer,
    load_flight_dump,
    to_chrome_trace,
)

__all__ = [
    "Attribution",
    "CaptureWindow",
    "CompileWatcher",
    "CsvSink",
    "DeviceProfiler",
    "FlightRecorder",
    "Histogram",
    "HistogramLayoutError",
    "JsonlSink",
    "MemorySink",
    "MetricsRegistry",
    "Objective",
    "OpRow",
    "SloMonitor",
    "StepClock",
    "StepWindowProfiler",
    "Telemetry",
    "Tracer",
    "analyze_capture",
    "attribute",
    "device_op_rows",
    "device_rows_to_events",
    "find_captures",
    "find_shards",
    "hbm_watermark",
    "load_flight_dump",
    "max_stat",
    "peak_hbm_bytes",
    "read_jsonl",
    "reduce_shards",
    "rotated_segments",
    "sample_memory",
    "shard_path",
    "to_chrome_trace",
]
