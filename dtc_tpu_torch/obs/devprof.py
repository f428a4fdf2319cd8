"""Device-time observatory: where DEVICE time goes, per model component.

The port's counterpart of the JAX package's ``obs/devprof.py``, over
``torch.profiler``'s Chrome trace instead of the XLA profiler's. Three
layers:

- **Parser** — reads the trace into typed :class:`OpRow` records:
  duration, trace-local start, scope path, collective-or-compute kind.
  On a card the rows are the device events (``cat`` ``kernel``,
  ``gpu_memcpy``, ``gpu_memset``); with no device event (a CPU run) the
  host ops (``cpu_op``) stand in for them, nested ops made additive by
  :func:`self_times`. A kernel's scope is that of the host call that
  launched it: ``args.correlation`` links the kernel to its
  ``cudaLaunchKernel`` (or ``cuLaunchKernelEx``) event, and the ``record_function``
  ranges enclosing that call on its thread are the path. Autograd
  launches backward kernels from its own device thread, outside every
  forward range: the backward node enclosing the launch
  (``autograd::engine::evaluate_function: ...``) carries the ``Sequence
  number`` of the forward op that recorded it, so the kernel takes that
  op's scope behind the backward marker :data:`BWD_SCOPE`.

- **Attribution** — rolls op durations up to model components (embed /
  attn_qkv / attn_kernel / attn_proj / mlp / ln / head / optimizer) and
  phases (fwd / bwd / optimizer) with the JAX package's token tables
  (:func:`classify_scope`): the model and the train step name their
  ``record_function`` ranges with those tokens (:func:`scope`). The pass
  also derives device-time MFU, the comm/compute overlap ratio
  (collective intervals intersected with the union of concurrent compute
  intervals) and the unattributed share the structural gate bounds.

- **Capture** — programmatic trace windows reusing the hardened
  :class:`~dtc_tpu_torch.obs.profiling.StepWindowProfiler`
  (warn-and-disable: telemetry must never kill the run).
  :class:`DeviceProfiler` fires on cadence (``obs.devprof_every``), on
  demand (``request()``) and from the trigger points (SLO breach,
  hung-step watchdog — wired in :mod:`dtc_tpu_torch.obs.telemetry`); each
  window lands in its own artifact dir with a ``devprof_meta.json``
  sidecar carrying the wall-clock anchors, the memory watermark sampled at
  window close, the step's model FLOPs, the card's peak, the collective
  census and, on a card, the profiler's own device-time total
  (``key_averages()``) to hold the parser against.

Clock alignment for the merged view: host spans are stamped with
``time.time()``; trace events use the profiler's microsecond timebase.
The capture records ``t_wall_start`` immediately before the session
starts, and the trace's session event (``cat`` ``Trace``) marks that
moment (:func:`trace_wall_anchor`).
"""

from __future__ import annotations

import bisect
import contextlib
import glob
import gzip
import json
import os
import re
import time
from dataclasses import dataclass, field
from typing import Any

from torch.profiler import record_function

from dtc_tpu_torch.obs.profiling import StepWindowProfiler, profiler_active

#: The backward marker: the train step runs ``loss.backward()`` inside a
#: range of this name, and a kernel linked to a forward op through its
#: autograd node takes it as the first segment of its scope. The JAX
#: package's backward ops sit under an autodiff ``transpose(...)`` scope,
#: which :func:`classify_scope` reads as phase ``bwd``.
BWD_SCOPE = "transpose(backward)"


def scope(name: str):
    """A ``record_function`` range named ``name`` while a profiler session
    records, else a no-op: off a capture window the model's ranges cost
    one flag read each."""
    if profiler_active():
        return record_function(name)
    return contextlib.nullcontext()


# ---------------------------------------------------------------------------
# typed op rows


@dataclass(frozen=True)
class OpRow:
    """One device-side op execution from the trace (a host op in a CPU
    run)."""

    name: str            # trace event name (the kernel's, or the host op's)
    op: str              # the host op that launched it (innermost cpu_op)
    scope: str           # record_function path ("" when unknown)
    t0_s: float          # start, trace-local seconds
    dur_s: float         # duration, seconds
    pid: int
    tid: int
    kind: str            # "collective" | "compute"


TRACE_GLOB = "*.trace.json.gz"


def find_trace_file(trace_dir: str) -> str | None:
    """Newest ``*.trace.json.gz`` under ``trace_dir``, or None."""
    paths = glob.glob(os.path.join(trace_dir, "**", TRACE_GLOB), recursive=True)
    return max(paths, key=os.path.getmtime) if paths else None


def load_trace(path: str) -> dict[str, Any]:
    """Load one Chrome-trace JSON (gzipped or plain)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


#: name tokens of the overlapped-collectives ring kernels
#: (``csrc/overlap_collectives.cu``): each is an FSDP ring step whose
#: transfer rides inside the matmul launch, so there is no separate
#: collective interval to measure. They are attributed as compute and
#: totalled apart (``Attribution.fused_collective_s``).
FUSED_COLLECTIVE_TOKENS = ("overlap_ag_step", "overlap_rs_step", "overlap_tc_step",
                           "dtc_overlap")

#: device event categories (the CPU fallback reads ``cpu_op`` instead).
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: host events that launch device work, linked to it by ``correlation``.
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: host events that nest: ops and ``record_function`` ranges.
HOST_CATS = ("cpu_op", "user_annotation")

_BWD_NODE = "autograd::engine::evaluate_function: "


def _is_fused_collective(name: str, op: str, scope: str) -> bool:
    hay = f"{name} {op} {scope}".lower()
    return any(tok in hay for tok in FUSED_COLLECTIVE_TOKENS)


def _is_collective(name: str, op: str) -> bool:
    """NCCL's kernels on a card; the process group's ops on the host (a
    CPU run, where gloo's collectives put no row on the device)."""
    return name.startswith("nccl") or op.startswith(("c10d::", "nccl:", "gloo:"))


class _Line:
    """The nested host events of one (pid, tid) thread, sorted by start,
    each with its parent: the innermost event enclosing a moment is found
    by a bisection and a walk up the parents."""

    def __init__(self, events: list[dict[str, Any]]):
        events.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
        self.events = events
        self.starts = [e["ts"] for e in events]
        self.ends = [e["ts"] + e.get("dur", 0.0) for e in events]
        self.parent: list[int] = []
        stack: list[int] = []
        for i in range(len(events)):
            while stack and self.ends[stack[-1]] <= self.starts[i]:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def chain(self, ts: float, end: float) -> list[dict[str, Any]]:
        """The events enclosing ``[ts, end]``, innermost first."""
        i = bisect.bisect_right(self.starts, ts) - 1
        out = []
        while i >= 0:
            if self.ends[i] >= end:
                out.append(self.events[i])
            i = self.parent[i]
        return out


class _HostIndex:
    """The trace's host side: each thread's nesting, and the forward ops
    by autograd sequence number."""

    def __init__(self, events: list[dict[str, Any]]):
        lines: dict[tuple[int, int], list[dict[str, Any]]] = {}
        self.forward: dict[int, list[dict[str, Any]]] = {}
        self.by_external: dict[int, dict[str, Any]] = {}
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in HOST_CATS:
                continue
            lines.setdefault((e.get("pid"), e.get("tid")), []).append(e)
            args = e.get("args") or {}
            if e.get("cat") == "cpu_op":
                if "External id" in args:
                    self.by_external[args["External id"]] = e
                seq = args.get("Sequence number")
                if seq is not None and not _bwd_node(e):
                    self.forward.setdefault(seq, []).append(e)
        self.lines = {k: _Line(v) for k, v in lines.items()}
        for ops in self.forward.values():
            ops.sort(key=lambda e: e["ts"])
        self._memo: dict[int, str] = {}

    def chain(self, e: dict[str, Any]) -> list[dict[str, Any]]:
        line = self.lines.get((e.get("pid"), e.get("tid")))
        if line is None:
            return []
        return line.chain(e["ts"], e["ts"] + e.get("dur", 0.0))

    def forward_op(self, node: dict[str, Any]) -> dict[str, Any] | None:
        """The forward op that recorded backward ``node``: the latest one of
        its sequence number that started before it."""
        seq = (node.get("args") or {}).get("Sequence number")
        best = None
        for op in self.forward.get(seq, ()):
            if op["ts"] > node["ts"]:
                break
            best = op
        return best

    def scope_of(self, e: dict[str, Any]) -> tuple[str, str]:
        """``(scope path, innermost host op)`` of the moment host event
        ``e`` occupies: the ``record_function`` ranges enclosing it, and
        inside a backward node :data:`BWD_SCOPE` plus the scope of the
        forward op the node was recorded for."""
        inner: list[str] = []
        op = ""
        for ev in self.chain(e):
            if ev.get("cat") == "cpu_op" and not op:
                op = str(ev.get("name", ""))
            if ev.get("cat") == "user_annotation":
                inner.append(str(ev.get("name", "")))
            elif _bwd_node(ev):
                fwd = self.forward_op(ev)
                base = self._fwd_scope(fwd) if fwd is not None else ""
                if base.startswith(BWD_SCOPE):  # a recompute's op: one marker
                    base = base[len(BWD_SCOPE):].lstrip("/")
                parts = [BWD_SCOPE] + ([base] if base else []) + inner[::-1]
                return "/".join(parts), op
        return "/".join(inner[::-1]), op

    def _fwd_scope(self, fwd: dict[str, Any]) -> str:
        key = id(fwd)
        if key not in self._memo:
            self._memo[key] = self.scope_of(fwd)[0]
        return self._memo[key]


def _bwd_node(e: dict[str, Any]) -> bool:
    """An autograd node's evaluation (the backward of a recorded op)."""
    if e.get("cat") != "cpu_op":
        return False
    args = e.get("args") or {}
    return str(e.get("name", "")).startswith(_BWD_NODE) or (
        "Sequence number" in args and (args.get("Fwd thread id") or 0) > 0
    )


def device_op_rows(trace: dict[str, Any]) -> list[OpRow]:
    """Typed device-op rows from one loaded trace, each with the scope of
    the host call that launched it.

    Selection: complete (``ph: X``) events of the device categories. When
    the trace has NONE (a CPU run), the host ops stand in for them — every
    ``cpu_op``, each with the scope of its own place — so CPU captures
    attribute by the same rules.
    """
    events = trace.get("traceEvents", [])
    host = _HostIndex(events)
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    rows: list[OpRow] = []
    if dev:
        launches = {}
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = e
        for e in dev:
            args = e.get("args") or {}
            origin = launches.get(args.get("correlation"))
            if origin is None:  # no launch event: the op that issued it
                origin = host.by_external.get(args.get("External id"))
            scope_path, op = host.scope_of(origin) if origin is not None else ("", "")
            rows.append(_row(e, op, scope_path))
    else:
        for e in events:
            if e.get("ph") == "X" and e.get("cat") == "cpu_op":
                scope_path, _ = host.scope_of(e)
                rows.append(_row(e, str(e.get("name", "")), scope_path))
    return rows


def _row(e: dict[str, Any], op: str, scope_path: str) -> OpRow:
    name = str(e.get("name", ""))
    return OpRow(
        name=name,
        op=op,
        scope=scope_path,
        t0_s=float(e.get("ts", 0.0)) / 1e6,
        dur_s=float(e.get("dur", 0.0)) / 1e6,
        pid=e.get("pid", 0) if isinstance(e.get("pid"), int) else 0,
        tid=e.get("tid", 0) if isinstance(e.get("tid"), int) else 0,
        kind="collective" if _is_collective(name, op) else "compute",
    )


# ---------------------------------------------------------------------------
# component / phase classification

#: model components the named ranges establish, plus the module names that
#: imply them. Matched right-to-left along the scope path so the innermost
#: component wins (ln inside head -> ln).
_COMPONENT_TOKENS: dict[str, str] = {
    "embed": "embed", "wte": "embed", "wpe": "embed",
    "attn_qkv": "attn_qkv", "q_proj": "attn_qkv", "k_proj": "attn_qkv",
    "v_proj": "attn_qkv",
    "attn_kernel": "attn_kernel",
    "attn_proj": "attn_proj", "out_proj": "attn_proj",
    "moe": "moe", "router": "moe",
    "mlp": "mlp", "fc1": "mlp", "fc2": "mlp",
    "ln": "ln", "ln_1": "ln", "ln_2": "ln", "ln_f": "ln",
    "head": "head", "lm_head": "head",
    "optimizer": "optimizer",
    "prefill": "prefill", "decode": "decode",
}

#: prefix-matched fallbacks for model glue no specific component claims:
#: the residual adds live at block level, dropout is its own module.
_COMPONENT_PREFIXES: tuple[tuple[str, str], ...] = (
    ("Dropout", "dropout"),
    ("Block", "residual"),
    ("blocks", "residual"),
)

#: host ops that are pure data movement — copies, casts, layout views,
#: allocation and fills — attributed to an explicit ``data_movement``
#: component when no range claims them.
_DATA_MOVEMENT_OPS = frozenset((
    "aten::copy_", "aten::to", "aten::_to_copy", "aten::contiguous", "aten::clone",
    "aten::cat", "aten::stack", "aten::view", "aten::reshape", "aten::_reshape_alias",
    "aten::t", "aten::transpose", "aten::permute", "aten::expand", "aten::as_strided",
    "aten::slice", "aten::select", "aten::unsqueeze", "aten::squeeze", "aten::flatten",
    "aten::narrow", "aten::split", "aten::split_with_sizes", "aten::chunk", "aten::unbind",
    "aten::empty", "aten::empty_like", "aten::empty_strided", "aten::new_empty",
    "aten::zeros", "aten::zeros_like", "aten::ones_like", "aten::new_zeros", "aten::fill_",
    "aten::zero_", "aten::detach", "detach", "aten::alias", "aten::lift_fresh",
    "aten::resolve_conj", "aten::resolve_neg", "aten::item", "aten::_local_scalar_dense",
    "aten::view_as", "aten::index_select", "aten::_foreach_copy_",
))
#: name tokens of device events that only move bytes.
_DATA_MOVEMENT_KERNELS = ("memcpy", "memset", "copy", "fill")

#: kernel and op names of matrix products: they must always recover a
#: model component (the structural gate's evidence).
_MATMUL_TOKENS = ("gemm", "nvjet", "cutlass", "xmma", "aten::mm", "aten::addmm",
                  "aten::bmm", "aten::baddbmm", "aten::matmul", "aten::linear",
                  "aten::einsum", "mmbackward", "addmmbackward", "bmmbackward")

#: components expected of every dense GPT train-step attribution — the
#: structural completeness set the gate checks against.
MODEL_COMPONENTS = (
    "embed", "attn_qkv", "attn_kernel", "attn_proj", "mlp", "moe", "ln",
    "head", "optimizer",
)


def _data_movement(row: OpRow) -> bool:
    if row.name == row.op:  # a host op (a CPU run)
        return row.op in _DATA_MOVEMENT_OPS
    low = row.name.lower()
    return row.op in _DATA_MOVEMENT_OPS or any(tok in low for tok in _DATA_MOVEMENT_KERNELS)


def _is_matmul(row: OpRow) -> bool:
    hay = f"{row.name} {row.op}".lower()
    return any(tok in hay for tok in _MATMUL_TOKENS)


def classify_scope(scope: str) -> tuple[str, str]:
    """``(component, phase)`` of one scope path; either may be ''.

    Phase: ``bwd`` when the path crosses an autodiff ``transpose(...)``
    wrapper, ``optimizer`` under the train step's optimizer scope, ``fwd``
    for the primal model pass (a ``jvp(...)`` wrapper or the explicit
    ``fwd`` scope), '' otherwise (input pipeline, glue).
    """
    if not scope:
        return "", ""
    segs = scope.split("/")
    component = ""
    for seg in reversed(segs):
        hit = _COMPONENT_TOKENS.get(seg)
        if hit:
            component = hit
            break
    if not component:
        for seg in reversed(segs):
            for prefix, comp in _COMPONENT_PREFIXES:
                if seg.startswith(prefix):
                    component = comp
                    break
            if component:
                break
    if not component and ("while" in segs or "body" in segs or "cond" in segs):
        component = "scan"
    if any(s.startswith("transpose(") for s in segs):
        phase = "bwd"
    elif "optimizer" in segs:
        phase = "optimizer"
    elif "fwd" in segs or any(s.startswith("jvp(") for s in segs):
        phase = "fwd"
    else:
        phase = ""
    # optimizer component implies optimizer phase even without the wrapper.
    if component == "optimizer" and not phase:
        phase = "optimizer"
    return component, phase


# ---------------------------------------------------------------------------
# attribution


def _interval_union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    if not intervals:
        return []
    intervals = sorted(intervals)
    out = [intervals[0]]
    for lo, hi in intervals[1:]:
        if lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _overlap_s(
    collectives: list[tuple[float, float]], compute: list[tuple[float, float]]
) -> float:
    """Seconds of collective time overlapped by ANY compute interval."""
    total = 0.0
    union = _interval_union(compute)
    for lo, hi in collectives:
        for ulo, uhi in union:
            if uhi <= lo:
                continue
            if ulo >= hi:
                break
            total += min(hi, uhi) - max(lo, ulo)
    return total


@dataclass
class Attribution:
    """Rolled-up device-time attribution for one capture.

    All ``*_s`` totals are summed over the whole captured window; divide
    by the window's step count (the meta sidecar's ``steps``) for
    per-step numbers. ``unattributed_s`` is the device time whose scope
    recovered no known component — the share the structural gate bounds.
    """

    components: dict[str, float] = field(default_factory=dict)
    phases: dict[str, float] = field(default_factory=dict)
    total_s: float = 0.0
    compute_s: float = 0.0
    collective_s: float = 0.0
    overlap_s: float = 0.0
    #: device time inside the fused ring kernels (comm+compute in ONE
    #: launch — counted in ``compute_s`` too; their comm share is hidden
    #: by construction, not measurable as interval overlap).
    fused_collective_s: float = 0.0
    unattributed_s: float = 0.0
    n_ops: int = 0
    #: matrix-product kernels (or ops) that recovered NO component — the
    #: "every matmul attributed" structural gate's evidence list.
    unattributed_dot_fusions: list[str] = field(default_factory=list)
    #: busiest single device line's busy seconds (the device-time MFU
    #: denominator on one card).
    busy_s: float = 0.0

    @property
    def attributed_share(self) -> float:
        """Fraction of device time attributed to a known component."""
        if self.total_s <= 0:
            return 0.0
        return 1.0 - self.unattributed_s / self.total_s

    @property
    def overlap_ratio(self) -> float:
        """Fraction of collective time hidden under concurrent compute
        (0.0 when the capture has no collectives)."""
        return self.overlap_s / self.collective_s if self.collective_s > 0 else 0.0

    def component_table(self, steps: int = 1) -> list[dict[str, Any]]:
        """Per-component rows (seconds + share), largest first, with the
        unattributed remainder as an explicit final row."""
        steps = max(int(steps), 1)
        rows = [
            {
                "component": c,
                "s_per_step": round(s / steps, 6),
                "share": round(s / self.total_s, 4) if self.total_s else 0.0,
            }
            for c, s in sorted(self.components.items(), key=lambda kv: -kv[1])
        ]
        if self.unattributed_s > 0 or not rows:
            rows.append({
                "component": "(unattributed)",
                "s_per_step": round(self.unattributed_s / steps, 6),
                "share": (
                    round(self.unattributed_s / self.total_s, 4)
                    if self.total_s else 0.0
                ),
            })
        return rows

    def device_mfu(
        self, step_flops: float | None, peak_flops: float | None,
        steps: int = 1,
    ) -> float | None:
        """Device-time MFU: model FLOPs per step over the busiest device
        line's busy time — utilization of the time the card was actually
        executing. None when FLOPs/peak are unknown (CPU)."""
        if not step_flops or not peak_flops or self.busy_s <= 0:
            return None
        return step_flops / (self.busy_s / max(int(steps), 1)) / peak_flops


_HALF_NS = 0.5e-9


def self_times(rows: list[OpRow]) -> list[float]:
    """Per-row SELF duration: each op's wall time minus the ops nested
    inside it on the same (pid, tid) line.

    Host ops nest (``aten::linear`` wraps ``aten::addmm``), so attribution
    needs ADDITIVE numbers: each event's immediate children are subtracted
    from it. Kernels on one stream do not nest and keep their durations: an
    event that starts within half a nanosecond (the trace's resolution is
    one) of another's end follows it, whatever the float sum of the
    other's start and duration rounds to."""
    order = sorted(range(len(rows)), key=lambda i: (
        rows[i].pid, rows[i].tid, rows[i].t0_s, -rows[i].dur_s
    ))
    self_s = [r.dur_s for r in rows]
    stack: list[int] = []  # indices of open ancestors on the current line
    line: tuple[int, int] | None = None
    for i in order:
        r = rows[i]
        if (r.pid, r.tid) != line:
            line = (r.pid, r.tid)
            stack = []
        while stack and (
            rows[stack[-1]].t0_s + rows[stack[-1]].dur_s <= r.t0_s + _HALF_NS
        ):
            stack.pop()
        if stack:
            self_s[stack[-1]] -= r.dur_s
        stack.append(i)
    return [max(s, 0.0) for s in self_s]


def attribute(rows: list[OpRow]) -> Attribution:
    """Roll device-op SELF durations up to components/phases + ratios."""
    att = Attribution()
    per_line: dict[tuple[int, int], float] = {}
    coll_iv: list[tuple[float, float]] = []
    comp_iv: list[tuple[float, float]] = []
    selfs = self_times(rows)
    for r, dur in zip(rows, selfs):
        att.n_ops += 1
        att.total_s += dur
        per_line[(r.pid, r.tid)] = per_line.get((r.pid, r.tid), 0.0) + dur
        # Overlap detection uses the raw WALL intervals (a collective is
        # hidden when compute runs anywhere during it, children included).
        iv = (r.t0_s, r.t0_s + r.dur_s)
        if r.kind == "collective":
            att.collective_s += dur
            coll_iv.append(iv)
        else:
            att.compute_s += dur
            comp_iv.append(iv)
            if _is_fused_collective(r.name, r.op, r.scope):
                att.fused_collective_s += dur
        component, phase = classify_scope(r.scope)
        if not component:
            if r.kind == "collective":
                # A collective outside any named scope is still a known
                # bucket — the census cross-check reads this row.
                component = "collectives"
            elif _data_movement(r):
                component = "data_movement"
        if component:
            att.components[component] = att.components.get(component, 0.0) + dur
        else:
            att.unattributed_s += dur
            if _is_matmul(r):
                att.unattributed_dot_fusions.append(r.name)
        if phase:
            att.phases[phase] = att.phases.get(phase, 0.0) + dur
    att.overlap_s = _overlap_s(coll_iv, comp_iv)
    att.busy_s = max(per_line.values(), default=0.0)
    return att


def structural_gates(
    att: Attribution, *, max_unattributed_share: float = 0.10
) -> dict[str, Any]:
    """Structural checks that hold on any backend — every matrix product
    attributed to a component and the unattributed share bounded — rather
    than raw CPU timings. Returns the verdicts plus the evidence."""
    return {
        "all_dot_fusions_attributed": not att.unattributed_dot_fusions,
        "unattributed_dot_fusions": sorted(set(att.unattributed_dot_fusions))[:8],
        "unattributed_share": round(1.0 - att.attributed_share, 4),
        "unattributed_share_ok": (
            att.total_s > 0
            and (1.0 - att.attributed_share) <= max_unattributed_share
        ),
    }


def census_crosscheck(
    att: Attribution, comm_estimate: dict[str, float] | None
) -> list[str]:
    """Warn-band cross-check against the static collective census
    (``utils/metrics.comm_bytes_per_step``): a program the census says
    moves no bytes should not spend meaningful device time in collectives,
    and a comm-heavy program should show SOME collective time. Warnings,
    never failures — the census estimates bytes, the trace measures
    seconds, and only gross disagreement is signal."""
    warnings: list[str] = []
    est = float((comm_estimate or {}).get("total", 0.0) or 0.0)
    coll_share = att.collective_s / att.total_s if att.total_s else 0.0
    if est == 0.0 and coll_share > 0.05:
        warnings.append(
            f"census expects no collective traffic but {coll_share:.1%} of "
            "device time is collectives"
        )
    if est > 0.0 and att.total_s > 0 and att.collective_s == 0.0:
        warnings.append(
            f"census expects ~{est / 1e6:.1f} MB/step of collective traffic "
            "but the capture measured no collective device time"
        )
    return warnings


# ---------------------------------------------------------------------------
# merged host+device export


def trace_wall_anchor(
    trace: dict[str, Any], t_wall_start: float | None
) -> tuple[float, float]:
    """``(trace_t0_s, wall_t0_s)``: the trace-local timestamp that
    corresponds to the wall clock ``t_wall_start`` the capture recorded
    immediately before the session started.

    The trace's session event (``cat`` ``Trace``) begins at that moment.
    Falls back to the earliest event when it is absent (foreign traces),
    and to a zero anchor when no wall clock was recorded (the merged view
    is then trace-local, still monotonic)."""
    events = trace.get("traceEvents", [])
    marker = None
    earliest = None
    for e in events:
        if e.get("ph") != "X":
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)):
            continue
        if earliest is None or ts < earliest:
            earliest = ts
        if marker is None and e.get("cat") == "Trace":
            marker = ts
    t0 = (marker if marker is not None else earliest or 0.0) / 1e6
    return t0, (t_wall_start if t_wall_start is not None else 0.0)


def device_rows_to_events(
    rows: list[OpRow],
    *,
    anchor: tuple[float, float] = (0.0, 0.0),
    proc: int = 0,
) -> list[dict[str, Any]]:
    """Device op rows as registry-style span events, wall-aligned via
    ``anchor`` — feed them to :func:`dtc_tpu_torch.obs.trace.to_chrome_trace`
    together with the run's host events for the single merged Perfetto
    file (host spans and device ops on one clock)."""
    trace_t0, wall_t0 = anchor
    out = []
    for r in rows:
        component, phase = classify_scope(r.scope)
        track = f"device.{r.pid}.{r.tid}"
        out.append({
            "etype": "span",
            "name": r.name,
            "cat": "device",
            "tid": track,
            "ph": "X",
            "t0": round(wall_t0 + (r.t0_s - trace_t0), 6),
            "dur_s": round(r.dur_s, 9),
            "proc": proc,
            "component": component or None,
            "phase": phase or None,
            "kind": r.kind,
        })
    return out


# ---------------------------------------------------------------------------
# capture windows

META_NAME = "devprof_meta.json"


def _write_meta(trace_dir: str, meta: dict[str, Any]) -> str:
    """Atomic meta sidecar next to the trace (tmp + replace)."""
    path = os.path.join(trace_dir, META_NAME)
    tmp = f"{path}.tmp.{os.getpid()}"
    os.makedirs(trace_dir, exist_ok=True)
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1)
    os.replace(tmp, path)
    return path


def load_meta(trace_dir: str) -> dict[str, Any] | None:
    try:
        with open(os.path.join(trace_dir, META_NAME)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def find_captures(base_dir: str) -> list[str]:
    """Capture artifact dirs under a run's ``obs/devprof/``, oldest first
    (a dir counts once it has a meta sidecar — half-written windows from
    a crashed run are skipped)."""
    if not os.path.isdir(base_dir):
        return []
    return [
        d for d in sorted(glob.glob(os.path.join(base_dir, "*")))
        if os.path.isfile(os.path.join(d, META_NAME))
    ]


def profiler_device_s(prof) -> float | None:
    """The device time ``torch.profiler`` itself totals over a stopped
    session, in seconds, by the rule of its own table's footer: the self
    device time of ``key_averages()``'s device events, ``record_function``
    ranges' device spans left out. None without a card."""
    import torch
    from torch.autograd import DeviceType

    if prof is None or not torch.cuda.is_available():
        return None
    total = 0.0
    for e in prof.key_averages():
        legacy = e.device_type == DeviceType.CPU and getattr(e, "is_legacy", False)
        device = (e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))
        if legacy or device:
            total += float(getattr(e, "self_device_time_total", None)
                           if hasattr(e, "self_device_time_total")
                           else e.self_cuda_time_total)
    return total / 1e6


def _window_meta(prof, t_wall_start: float, device, **fields: Any) -> dict[str, Any]:
    """The meta sidecar of a stopped window ``prof``: ``fields``, the wall
    anchors, the profiler's own device total (and the seconds it took to
    read), the seconds the session took to start and to stop and write its
    trace, and the memory watermark."""
    from dtc_tpu_torch.obs.device import hbm_watermark

    t_wall_stop = time.time()
    t0 = time.perf_counter()
    device_s = profiler_device_s(prof.last_profile)
    return {
        **fields,
        "t_wall_start": round(t_wall_start, 6),
        "t_wall_stop": round(t_wall_stop, 6),
        "profiler_device_s": device_s,
        "profiler_device_read_s": round(time.perf_counter() - t0, 6),
        "start_s": prof.last_start_s,
        "stop_and_write_s": prof.last_stop_s,
        **hbm_watermark(device),
    }


class CaptureWindow:
    """Context manager for one programmatic capture around code the
    caller drives: brackets a profiler session with wall anchors, samples
    the memory watermark at close, writes the meta sidecar.
    Warn-and-disable on profiler failure — ``self.ok`` says whether a
    trace was captured."""

    def __init__(self, trace_dir: str, *, steps: int = 1, reason: str = "manual",
                 step_flops: float | None = None,
                 peak_flops: float | None = None,
                 comm_estimate: dict[str, float] | None = None,
                 device=None):
        self.trace_dir = trace_dir
        self.steps = max(int(steps), 1)
        self.reason = reason
        self.step_flops = step_flops
        self.peak_flops = peak_flops
        self.comm_estimate = comm_estimate
        self.device = device
        self.meta: dict[str, Any] | None = None
        self.ok = False

    def __enter__(self) -> "CaptureWindow":
        self._prof = StepWindowProfiler(0, 1, self.trace_dir)
        self.t_wall_start = time.time()
        self._prof.step(0)  # start (warn-and-disable on failure)
        self.ok = self._prof.failed is None
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._prof.close()  # stop + write the trace; warn-and-disable
        self.ok = self.ok and self._prof.failed is None
        if not self.ok:
            return
        self.meta = _window_meta(
            self._prof, self.t_wall_start, self.device, reason=self.reason,
            steps=self.steps, step_flops=self.step_flops, peak_flops=self.peak_flops,
            comm_estimate=self.comm_estimate)
        try:
            _write_meta(self.trace_dir, self.meta)
        except OSError as e:
            print(f"[dtc_tpu_torch] WARNING: devprof meta write failed ({e})")


def _safe_label(reason: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", reason)[:40] or "capture"


class DeviceProfiler:
    """Step-driven programmatic capture windows for the training runtime.

    Owned by :class:`~dtc_tpu_torch.obs.telemetry.Telemetry`; the trainer
    never sees it directly. ``on_step`` is called once per step from
    ``Telemetry.on_step_start``; windows open on cadence (``every > 0``,
    every N steps) or on a pending ``request()`` (on demand, SLO breach,
    hung-step flag) and span ``n_steps`` steps. One window at a time;
    requests during a window (or while the configured
    ``StepWindowProfiler`` window is active — ``busy``) defer to the next
    eligible step. A failed start/stop warns and disables future windows
    for the run.

    ``max_captures`` bounds windows per run: a capture makes its own step
    slow (writing the trace takes a while), which can itself trip the
    hung-step watchdog whose trigger would request the NEXT capture —
    without a cap a watchdog-armed run could alternate capture and flag
    forever.
    """

    def __init__(
        self,
        base_dir: str,
        *,
        registry: Any = None,
        every: int = 0,
        n_steps: int = 2,
        step_flops: float | None = None,
        peak_flops: float | None = None,
        comm_estimate: dict[str, float] | None = None,
        max_captures: int = 8,
        device=None,
    ):
        self.base_dir = base_dir
        self.registry = registry
        self.every = max(int(every), 0)
        self.n_steps = max(int(n_steps), 1)
        self.max_captures = max(int(max_captures), 1)
        # Optional run context for the meta sidecar (the trainer sets
        # these once; offline tools derive device-time MFU from them).
        self.step_flops = step_flops
        self.peak_flops = peak_flops
        self.comm_estimate = comm_estimate
        self.device = device
        self._prof: Any = None
        self._stop_step = 0
        self._start_step = 0
        self._reason = ""
        self._dir = ""
        self._t_wall_start = 0.0
        self._pending: str | None = None
        self.disabled = False
        self.captures = 0
        self.last_artifact: str | None = None

    # -- triggers ----------------------------------------------------------
    def request(self, reason: str) -> bool:
        """Arm a capture window at the next step (on-demand / SLO breach /
        hung-step). No-op while disabled or already pending/active."""
        if (
            self.disabled
            or self.captures >= self.max_captures
            or self._pending is not None
            or self._prof is not None
        ):
            return False
        self._pending = reason
        return True

    # -- step hook ---------------------------------------------------------
    def on_step(self, step: int, *, busy: bool = False) -> None:
        if self._prof is not None:
            self._prof.step(step)  # stops the session at the window's stop step
            if self._prof.failed:
                self._finalize(step, failed=True)
            elif step >= self._stop_step:
                self._finalize(step)
            return
        if self.disabled or busy or self.captures >= self.max_captures:
            return
        reason = self._pending
        if reason is None and self.every and step % self.every == 0:
            reason = "cadence"
        if reason is None:
            return
        self._pending = None
        self._start(step, reason)

    def _start(self, step: int, reason: str) -> None:
        d = os.path.join(self.base_dir, f"step{step:06d}_{_safe_label(reason)}")
        prof = StepWindowProfiler(step, step + self.n_steps, d)
        self._t_wall_start = time.time()
        prof.step(step)  # start; warn-and-disable inside on failure
        if prof.failed:
            self.disabled = True
            return
        self._prof = prof
        self._start_step = step
        self._stop_step = step + self.n_steps
        self._reason = reason
        self._dir = d

    def _finalize(self, step: int, failed: bool = False) -> None:
        prof, self._prof = self._prof, None
        if failed or prof.failed:
            self.disabled = True
            return
        meta = _window_meta(
            prof, self._t_wall_start, self.device, reason=self._reason,
            step_start=self._start_step, step_stop=step, steps=step - self._start_step,
            step_flops=self.step_flops, peak_flops=self.peak_flops,
            comm_estimate=self.comm_estimate)
        try:
            _write_meta(self._dir, meta)
        except OSError as e:
            print(f"[dtc_tpu_torch] WARNING: devprof meta write failed ({e})")
        self.captures += 1
        self.last_artifact = self._dir
        if self.registry is not None:
            # Rides the JSONL shards AND the flight-recorder ring, so a
            # post-mortem dump names the capture artifact that covers it.
            self.registry.emit(
                "devprof", step=step, reason=self._reason, dir=self._dir,
                steps=meta["steps"], peak_hbm_bytes=meta.get("peak_hbm_bytes"),
            )

    def close(self) -> None:
        """End-of-run: close a window still open (run ended mid-window)."""
        if self._prof is None:
            return
        self._prof.close()
        self._reason += ":truncated"
        self._finalize(self._stop_step)


# ---------------------------------------------------------------------------
# one-call report


def analyze_capture(trace_dir: str) -> dict[str, Any] | None:
    """Parse + attribute one capture dir: returns ``{rows, attribution,
    meta, anchor, trace_path}`` or None when the dir holds no trace (a
    capture that warn-disabled)."""
    path = find_trace_file(trace_dir)
    if path is None:
        return None
    trace = load_trace(path)
    meta = load_meta(trace_dir) or {}
    rows = device_op_rows(trace)
    att = attribute(rows)
    anchor = trace_wall_anchor(trace, meta.get("t_wall_start"))
    return {
        "trace_path": path,
        "rows": rows,
        "attribution": att,
        "meta": meta,
        "anchor": anchor,
    }
