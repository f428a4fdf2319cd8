"""Goodput ledger: wall-clock & token accounting for every runtime path.

The paper compares parallelism modes on loss parity and wall-clock; this
repo additionally spends wall-clock on things the paper never had —
snapshots, rollbacks, elastic resizes, failover re-prefills, sheds,
recompiles — and before this module no layer could say what fraction of
a run was *useful*. Fleet practice (MegaScale's per-incident accounting;
Google's ML Goodput methodology) treats goodput — effective work ÷
wall-clock — as the first-class SLI. This module makes it one here.

Two halves:

- :class:`GoodputLedger` — the OFFLINE truth. Classifies every
  wall-clock second per host/replica into a closed taxonomy (the
  ``CLASSES`` tuple below), derived purely from the event+span streams
  the runtimes already emit (PRs 1/7/14/15): ``step`` breakdowns,
  ``compile``/``recompile``/``aux_compile`` windows, recovery/resize
  events, ``decode_step``/``req.prefill`` spans, evict/failover records.
  Zero new device syncs — the ledger never touches a runtime, it reads
  shards. On top of intervals it computes token-weighted goodput
  (effective train tokens = steps that survived into final state;
  effective serve tokens = tokens delivered in COMPLETED requests) and
  per-incident cost bills (detection + restore + replay + recompile,
  wall AND tokens).

- :class:`OnlineGoodput` — the cheap streaming gauge. Runtimes feed it
  per-class seconds from timestamps they ALREADY take (the trainer's
  step breakdown, the engine's iteration clock); it maintains a
  sliding-window ``goodput_pct`` gauge, emits periodic ``counter``
  events (rendered as Perfetto ``ph: "C"`` counter tracks), and feeds
  the SLO monitor's ``goodput_min_pct`` floor objective.

Interval semantics (what the acceptance tests pin):

- Raw intervals are laid on each host's timeline and swept
  earliest-first: a later-starting interval is clipped to the end of the
  one before it (overlap is attributed to the earlier claimant), so no
  second is double-counted by construction.
- Gaps ≤ ``gap_epsilon_s`` are absorbed into the preceding interval
  (timer jitter). Larger gaps become ``shed_or_idle`` on serving hosts
  (``degraded`` while an SLO breach window is open) and
  ``unattributed`` on training hosts — every badput interval carries a
  typed ``cause``.
- A step execution discarded by a rollback/resize (its step number is
  above the restore target and it ran before the recovery event) is
  re-classed ``rollback_replay``/``elastic_resize`` wholesale and billed
  to the incident; the re-execution after restore is ordinary
  productive work. Effective train steps are a SET of surviving step
  numbers, so a step replayed N times still counts once — double
  billing is impossible by construction.
- A ``req.prefill`` span whose rid has a prior evict/failover incident
  is a recompute, classed ``failover_replay`` and billed to that
  incident; a rid's first prefill is ordinary ``prefill``.

Host-side pure Python — no device imports, unit-testable without a backend.
"""

from __future__ import annotations

import glob
import os
import re
from dataclasses import dataclass, field
from typing import Any

# --------------------------------------------------------------------------
# taxonomy

PRODUCTIVE_TRAIN = "productive_train"
PRODUCTIVE_DECODE = "productive_decode"
PREFILL = "prefill"
DATA_WAIT = "data_wait"
COMPILE = "compile"
SNAPSHOT_COMMIT = "snapshot_commit"
ROLLBACK_REPLAY = "rollback_replay"
ELASTIC_RESIZE = "elastic_resize"
FAILOVER_REPLAY = "failover_replay"
SHED_OR_IDLE = "shed_or_idle"
DEGRADED = "degraded"
#: verify work spent on draft proposals the target REJECTED —
#: speculation's structural price. Typed badput, never productive:
#: a speculative engine's goodput % cannot be inflated by proposing
#: wildly and accepting little (the acceptance rate shows up HERE).
SPEC_REJECTED_DRAFT = "spec_rejected_draft"
UNATTRIBUTED = "unattributed"

#: The closed taxonomy — every classified second belongs to exactly one.
CLASSES = (
    PRODUCTIVE_TRAIN, PRODUCTIVE_DECODE, PREFILL, DATA_WAIT, COMPILE,
    SNAPSHOT_COMMIT, ROLLBACK_REPLAY, ELASTIC_RESIZE, FAILOVER_REPLAY,
    SHED_OR_IDLE, DEGRADED, SPEC_REJECTED_DRAFT, UNATTRIBUTED,
)

#: Classes that count toward goodput %. Prefill is productive: those
#: tokens reach the user (a RE-prefill does not land here — it is
#: ``failover_replay``).
PRODUCTIVE = frozenset({PRODUCTIVE_TRAIN, PRODUCTIVE_DECODE, PREFILL})

#: Badput classes that must carry a typed cause (everything non-
#: productive except the explicit residual bucket).
TYPED_BADPUT = frozenset(CLASSES) - PRODUCTIVE - {UNATTRIBUTED}


@dataclass
class Interval:
    """One attributed slice of a host's wall-clock."""

    t0: float
    t1: float
    klass: str
    cause: str = ""
    step: int | None = None
    rid: str | None = None
    incident: int | None = None  # index into GoodputLedger.incidents

    @property
    def dur(self) -> float:
        return max(self.t1 - self.t0, 0.0)


@dataclass
class Incident:
    """One recovery event's cost bill: wall (detection-to-restore gap +
    discarded/replayed execution + recompile) and tokens thrown away."""

    kind: str                     # rollback | elastic_resize | failover | evict
    proc: int
    reason: str = ""
    step: int | None = None
    rid: str | None = None
    t_detect: float | None = None
    t_restored: float | None = None
    restore_s: float = 0.0        # detection -> state restored
    replay_s: float = 0.0         # discarded executions / re-prefill wall
    recompile_s: float = 0.0      # compile attributable to the recovery
    tokens_badput: int = 0        # tokens discarded or recomputed
    matched: bool = field(default=False, repr=False)  # re-prefill claimed

    @property
    def wall_s(self) -> float:
        return self.restore_s + self.replay_s + self.recompile_s

    def to_dict(self) -> dict[str, Any]:
        return {
            "kind": self.kind, "proc": self.proc, "reason": self.reason,
            "step": self.step, "rid": self.rid,
            "t_detect": _r6(self.t_detect), "t_restored": _r6(self.t_restored),
            "restore_s": round(self.restore_s, 6),
            "replay_s": round(self.replay_s, 6),
            "recompile_s": round(self.recompile_s, 6),
            "wall_s": round(self.wall_s, 6),
            "tokens_badput": self.tokens_badput,
        }


def _r6(v: float | None) -> float | None:
    return None if v is None else round(float(v), 6)


@dataclass
class HostLedger:
    """One host/replica's fully-attributed timeline."""

    proc: int
    kind: str                     # "train" | "serve"
    intervals: list[Interval]

    @property
    def wall_s(self) -> float:
        if not self.intervals:
            return 0.0
        return self.intervals[-1].t1 - self.intervals[0].t0

    def seconds(self) -> dict[str, float]:
        out = {k: 0.0 for k in CLASSES}
        for iv in self.intervals:
            out[iv.klass] += iv.dur
        return {k: v for k, v in out.items() if v > 0.0}

    @property
    def attributed_s(self) -> float:
        return sum(iv.dur for iv in self.intervals)

    @property
    def goodput_pct(self) -> float | None:
        wall = self.attributed_s
        if wall <= 0.0:
            return None
        prod = sum(iv.dur for iv in self.intervals if iv.klass in PRODUCTIVE)
        return 100.0 * prod / wall

    @property
    def unattributed_pct(self) -> float:
        wall = self.attributed_s
        if wall <= 0.0:
            return 0.0
        un = sum(iv.dur for iv in self.intervals if iv.klass == UNATTRIBUTED)
        return 100.0 * un / wall

    def reconcile(self) -> dict[str, float]:
        """Attributed seconds vs the timeline extent. By construction
        (overlap sweep + gap fill) these match up to rounding; the
        acceptance gate pins the fraction within 1%."""
        wall = self.wall_s
        att = self.attributed_s
        return {
            "wall_s": round(wall, 6),
            "attributed_s": round(att, 6),
            "fraction": 1.0 if wall <= 0 else round(att / wall, 6),
        }

    def summary(self) -> dict[str, Any]:
        gp = self.goodput_pct
        return {
            "kind": self.kind,
            "wall_s": round(self.wall_s, 6),
            "goodput_pct": None if gp is None else round(gp, 2),
            "unattributed_pct": round(self.unattributed_pct, 2),
            "seconds": {k: round(v, 6) for k, v in self.seconds().items()},
        }


# --------------------------------------------------------------------------
# offline ledger

#: Span names consumed as intervals. Step/phase/compile spans are
#: SKIPPED — the ``step``/``compile`` events carry the same seconds and
#: exist even with tracing off; consuming both would double-count.
_SERVE_SPANS = ("decode_step", "req.prefill", "spec_reject")
#: ``snapshot_dispatch`` is the synchronous half of an async
#: in-memory snapshot: device copies dispatched on the hot loop before
#: the commit thread takes over — snapshot wall, same class.
_COMMIT_SPANS = ("checkpoint", "elastic_spill", "snapshot_dispatch")

_SERVE_MARKERS = frozenset({
    "serve_request", "serve_admit", "serve_evict", "serve_reject",
    "serve_corruption", "router_route", "router_failover",
})

_SHARD_RE = re.compile(r"events\.r(\d+)\.jsonl$")


class GoodputLedger:
    """Offline interval + token ledger over per-process event shards.

    ``events_by_proc`` maps process index -> that shard's events in
    emission order (what :func:`dtc_tpu_torch.obs.registry.read_jsonl`
    returns). ``tokens_per_step`` overrides the ``batch × seq_len``
    derived from the ``run_start`` event when given.
    """

    def __init__(
        self,
        events_by_proc: dict[int, list[dict[str, Any]]],
        *,
        tokens_per_step: int | None = None,
        gap_epsilon_s: float = 0.005,
    ):
        self.gap_epsilon_s = float(gap_epsilon_s)
        self.incidents: list[Incident] = []
        self.hosts: dict[int, HostLedger] = {}
        self._tps = tokens_per_step
        self._surviving_steps: set[int] = set()
        self._discarded = 0          # lead-shard discarded step executions
        self._done_by_rid: dict[str, int] = {}
        self._rid_incidents: dict[str, list[int]] = {}
        self._build(events_by_proc)

    @classmethod
    def from_dir(cls, obs_dir: str, **kw: Any) -> "GoodputLedger":
        """Build from an obs directory's ``events.r<k>.jsonl`` shards
        (rotation-aware)."""
        from dtc_tpu_torch.obs.registry import read_jsonl

        by_proc: dict[int, list[dict[str, Any]]] = {}
        for p in glob.glob(os.path.join(obs_dir, "events.r*.jsonl")):
            m = _SHARD_RE.search(p)
            if m:
                by_proc[int(m.group(1))] = read_jsonl(p)
        return cls(by_proc, **kw)

    # -- construction ------------------------------------------------------
    def _build(self, by_proc: dict[int, list[dict[str, Any]]]) -> None:
        # Pass A (global): token terminals, per-rid incidents, and
        # tokens_per_step — re-prefill classification and rid dedupe need
        # cross-shard knowledge (a request evicted on replica A re-prefills
        # on replica B's shard).
        for proc in sorted(by_proc):
            for e in by_proc[proc]:
                et = e.get("etype")
                if et == "run_start" and self._tps is None:
                    b, s = e.get("batch"), e.get("seq_len")
                    if isinstance(b, int) and isinstance(s, int):
                        self._tps = b * s
                elif et == "serve_request":
                    rid = e.get("rid")
                    if (e.get("state") == "done" and isinstance(rid, str)
                            and isinstance(e.get("n_tokens"), int)):
                        # Keyed by rid: engine AND router both emit a
                        # terminal for the same request — one bill each rid.
                        self._done_by_rid[rid] = e["n_tokens"]
                elif et == "serve_evict":
                    rid = str(e.get("rid"))
                    inc = Incident(
                        kind="evict", proc=proc, rid=rid,
                        reason=str(e.get("reason", "")),
                        t_detect=e.get("ts"),
                        tokens_badput=int(e.get("generated", 0) or 0),
                    )
                    self._add_rid_incident(rid, inc)
                elif et == "router_failover":
                    rid = str(e.get("rid"))
                    inc = Incident(
                        kind="failover", proc=proc, rid=rid,
                        reason=f"{e.get('src')}->{e.get('dst')}",
                        t_detect=e.get("t_detect", e.get("ts")),
                        t_restored=e.get("t_restored"),
                        tokens_badput=int(e.get("tokens_carried", 0) or 0),
                    )
                    if inc.t_detect is not None and inc.t_restored is not None:
                        inc.restore_s = max(inc.t_restored - inc.t_detect, 0.0)
                    self._add_rid_incident(rid, inc)

        # Pass B (per shard): lay the timeline.
        lead_train: int | None = None
        for proc in sorted(by_proc):
            host = self._classify_shard(proc, by_proc[proc])
            if host is not None:
                self.hosts[proc] = host
                if host.kind == "train" and lead_train is None:
                    lead_train = proc
        self._lead_train = lead_train

    def _add_rid_incident(self, rid: str, inc: Incident) -> None:
        self.incidents.append(inc)
        self._rid_incidents.setdefault(rid, []).append(
            len(self.incidents) - 1
        )

    # -- shard classification ---------------------------------------------
    def _classify_shard(
        self, proc: int, events: list[dict[str, Any]]
    ) -> HostLedger | None:
        raw: list[Interval] = []
        # step execution instances, in order; discarded retroactively
        # when a rollback/resize event names a restore target below them.
        steps: list[dict[str, Any]] = []
        breach_open: dict[str, float] = {}
        breach_windows: list[tuple[float, float, str]] = []
        serveish = False
        # (incident idx, to_step, detect_step): recompiles during the
        # replay window bill to the incident; closes when the step
        # counter passes the detection step again.
        replay_win: tuple[int, int, int] | None = None

        def recovery_incident(e: dict[str, Any], kind: str,
                              klass: str) -> None:
            nonlocal replay_win
            to_step = e.get("to_step")
            if not isinstance(to_step, int):
                return
            inc = Incident(
                kind=kind, proc=proc, reason=str(e.get("reason", kind)),
                step=e.get("step"),
            )
            self.incidents.append(inc)
            idx = len(self.incidents) - 1
            t_detect = e.get("t_detect")
            t_restored = e.get("t_restored", e.get("ts"))
            live = [s for s in steps if not s["discarded"]]
            if t_detect is None:
                # Satellite-2 enrichment missing (older stream): infer
                # detection as the end of the last live step execution.
                t_detect = live[-1]["t1"] if live else e.get("ts")
            for s in steps:
                if not s["discarded"] and s["step"] > to_step:
                    s["discarded"] = True
                    s["klass"] = klass
                    s["incident"] = idx
                    inc.replay_s += s["t1"] - s["t0"]
            if isinstance(t_detect, (int, float)) and isinstance(
                    t_restored, (int, float)):
                inc.t_detect = float(t_detect)
                inc.t_restored = float(t_restored)
                inc.restore_s = max(inc.t_restored - inc.t_detect, 0.0)
                if inc.restore_s > 0:
                    raw.append(Interval(
                        inc.t_detect, inc.t_restored, klass,
                        cause="restore", incident=idx,
                    ))
            detect_step = e.get("step")
            if isinstance(detect_step, int):
                replay_win = (idx, to_step, detect_step)

        for e in events:
            et = e.get("etype")
            ts = e.get("ts")
            if et == "step":
                st, dur = e.get("step"), e.get("step_time_s")
                if not isinstance(st, int) or not isinstance(
                        dur, (int, float)) or not isinstance(ts, (int, float)):
                    continue
                if replay_win is not None and st > replay_win[2]:
                    replay_win = None
                steps.append({
                    "step": st, "t0": ts - dur, "t1": ts,
                    "data_wait_s": float(e.get("data_wait_s", 0.0) or 0.0),
                    "compile_s": float(e.get("compile_s", 0.0) or 0.0),
                    "discarded": False, "klass": None, "incident": None,
                })
            elif et == "compile":
                c = e.get("compile_time_s")
                if isinstance(c, (int, float)) and c > 0 and isinstance(
                        ts, (int, float)):
                    raw.append(Interval(ts - c, ts, COMPILE, cause="startup"))
            elif et == "recompile":
                # The owning step event carries the same seconds
                # (``compile_s``) — no interval here, only the incident
                # replay-window attribution.
                c = e.get("compile_s")
                if (replay_win is not None and isinstance(c, (int, float))
                        and isinstance(e.get("step"), int)
                        and replay_win[1] < e["step"] <= replay_win[2]):
                    self.incidents[replay_win[0]].recompile_s += float(c)
            elif et == "aux_compile":
                c = e.get("compile_s")
                what = str(e.get("what", ""))
                if isinstance(c, (int, float)) and c > 0 and isinstance(
                        ts, (int, float)):
                    iv = Interval(ts - c, ts, COMPILE, cause=what or "aux")
                    if what in ("rollback", "elastic_resize"):
                        for i in range(len(self.incidents) - 1, -1, -1):
                            if (self.incidents[i].kind == what
                                    and self.incidents[i].proc == proc):
                                self.incidents[i].recompile_s += float(c)
                                iv.incident = i
                                break
                    raw.append(iv)
            elif et == "recovery" and e.get("action") == "rollback":
                recovery_incident(e, "rollback", ROLLBACK_REPLAY)
            elif et == "elastic_resize":
                recovery_incident(e, "elastic_resize", ELASTIC_RESIZE)
            elif et == "eval":
                d = e.get("duration_s")
                if isinstance(d, (int, float)) and d > 0 and isinstance(
                        ts, (int, float)):
                    raw.append(Interval(
                        ts - d, ts, PRODUCTIVE_TRAIN, cause="eval",
                    ))
            elif et == "span" and e.get("ph", "X") == "X":
                name = str(e.get("name", ""))
                t0, d = e.get("t0"), e.get("dur_s")
                if not isinstance(t0, (int, float)) or not isinstance(
                        d, (int, float)) or d <= 0:
                    continue
                if name == "decode_step":
                    serveish = True
                    raw.append(Interval(
                        t0, t0 + d, PRODUCTIVE_DECODE, cause="decode",
                    ))
                elif name == "req.prefill":
                    serveish = True
                    raw.append(self._prefill_interval(
                        str(e.get("rid") or e.get("tid")), t0, t0 + d,
                    ))
                elif name == "spec_reject":
                    # the rejected-proposal share of a
                    # speculative round — the engine splits each round's
                    # wall by accepted fraction and emits the remainder
                    # here. Typed badput by construction.
                    serveish = True
                    raw.append(Interval(
                        t0, t0 + d, SPEC_REJECTED_DRAFT, cause="spec_reject",
                    ))
                elif name in _COMMIT_SPANS:
                    raw.append(Interval(
                        t0, t0 + d, SNAPSHOT_COMMIT, cause=name,
                    ))
                elif name == "pool.timeshare":
                    # Pool co-tenancy: the train tenant yielded
                    # its CPU slice to the serving fleet for this window
                    # (one process time-slices every pool "host"). A
                    # typed yield, not an unattributed hole — but NOT
                    # ``serveish``: the shard is still a trainer and its
                    # other gaps must stay unattributed.
                    raw.append(Interval(
                        t0, t0 + d, SHED_OR_IDLE, cause="timeshare",
                    ))
            elif et == "slo_breach":
                obj = str(e.get("objective", "slo"))
                if isinstance(ts, (int, float)):
                    breach_open.setdefault(obj, ts)
            elif et == "slo_recovered":
                obj = str(e.get("objective", "slo"))
                t0 = breach_open.pop(obj, None)
                if t0 is not None and isinstance(ts, (int, float)):
                    breach_windows.append((t0, ts, obj))
            elif et in _SERVE_MARKERS:
                serveish = True

        for obj, t0 in breach_open.items():  # breach never recovered
            breach_windows.append((t0, float("inf"), obj))

        # Expand step instances: surviving steps split data_wait /
        # compile / productive (compile at the tail, matching the
        # tracer's placement); discarded ones bill wholesale.
        for s in steps:
            if s["discarded"]:
                raw.append(Interval(
                    s["t0"], s["t1"], s["klass"], cause="discarded_step",
                    step=s["step"], incident=s["incident"],
                ))
                continue
            dur = s["t1"] - s["t0"]
            dw = min(s["data_wait_s"], dur)
            c = min(s["compile_s"], dur - dw)
            if dw > 0:
                raw.append(Interval(
                    s["t0"], s["t0"] + dw, DATA_WAIT, cause="input_pipeline",
                    step=s["step"],
                ))
            if dur - dw - c > 0:
                raw.append(Interval(
                    s["t0"] + dw, s["t1"] - c, PRODUCTIVE_TRAIN,
                    cause="step", step=s["step"],
                ))
            if c > 0:
                raw.append(Interval(
                    s["t1"] - c, s["t1"], COMPILE, cause="recompile",
                    step=s["step"],
                ))

        if not raw:
            return None
        intervals = self._sweep(raw, serveish, breach_windows)
        host = HostLedger(
            proc=proc, kind="serve" if serveish else "train",
            intervals=intervals,
        )
        # Token accounting: the LEAD train shard only (every host emits
        # the same global step numbers — counting each shard would
        # multiply the fleet's token totals by n_hosts).
        if not serveish and steps and all(
                h.kind != "train" for h in self.hosts.values()):
            for s in steps:
                if s["discarded"]:
                    self._discarded += 1
                    if s["incident"] is not None and self._tps:
                        self.incidents[s["incident"]].tokens_badput += (
                            self._tps
                        )
                else:
                    self._surviving_steps.add(s["step"])
        return host

    def _prefill_interval(self, rid: str, t0: float, t1: float) -> Interval:
        """A rid's first prefill is productive; one following an
        evict/failover is the incident's recompute."""
        idxs = [
            i for i in self._rid_incidents.get(rid, [])
            if self.incidents[i].t_detect is None
            or self.incidents[i].t_detect <= t0 + 1e-9
        ]
        if not idxs:
            return Interval(t0, t1, PREFILL, cause="prefill", rid=rid)
        unmatched = [i for i in idxs if not self.incidents[i].matched]
        i = unmatched[0] if unmatched else idxs[-1]
        inc = self.incidents[i]
        inc.matched = True
        inc.replay_s += t1 - t0
        if inc.t_restored is None:
            inc.t_restored = t1
        return Interval(
            t0, t1, FAILOVER_REPLAY, cause=inc.kind, rid=rid, incident=i,
        )

    def _sweep(
        self,
        raw: list[Interval],
        serveish: bool,
        breach_windows: list[tuple[float, float, str]],
    ) -> list[Interval]:
        """Sort, clip overlaps earliest-first, fill gaps with typed
        residuals — the no-double-counting construction."""
        raw = [iv for iv in raw if iv.t1 > iv.t0]
        raw.sort(key=lambda iv: (iv.t0, iv.t1))
        out: list[Interval] = []
        for iv in raw:
            if out:
                prev_end = out[-1].t1
                if iv.t1 <= prev_end + 1e-9:
                    continue  # fully covered by earlier claimants
                if iv.t0 < prev_end:
                    iv.t0 = prev_end
                gap = iv.t0 - prev_end
                if 0 < gap <= self.gap_epsilon_s:
                    out[-1].t1 = iv.t0  # absorb jitter
                elif gap > 0:
                    out.extend(self._fill_gap(
                        prev_end, iv.t0, serveish, breach_windows,
                    ))
            out.append(iv)
        return out

    def _fill_gap(
        self,
        t0: float,
        t1: float,
        serveish: bool,
        breach_windows: list[tuple[float, float, str]],
    ) -> list[Interval]:
        if not serveish:
            return [Interval(t0, t1, UNATTRIBUTED, cause="host_gap")]
        # Serving: idle between scheduler activity; degraded while an
        # SLO breach window is open (split at the window edges).
        pieces: list[Interval] = []
        cur = t0
        for w0, w1, obj in sorted(breach_windows):
            lo, hi = max(cur, w0), min(t1, w1)
            if hi <= lo:
                continue
            if lo > cur:
                pieces.append(Interval(cur, lo, SHED_OR_IDLE, cause="idle"))
            pieces.append(Interval(lo, hi, DEGRADED, cause=f"slo:{obj}"))
            cur = hi
        if cur < t1:
            pieces.append(Interval(cur, t1, SHED_OR_IDLE, cause="idle"))
        return pieces

    # -- token accounting --------------------------------------------------
    @property
    def tokens_per_step(self) -> int | None:
        return self._tps

    @property
    def effective_train_tokens(self) -> int:
        return len(self._surviving_steps) * (self._tps or 0)

    @property
    def badput_train_tokens(self) -> int:
        return self._discarded * (self._tps or 0)

    @property
    def effective_serve_tokens(self) -> int:
        return sum(self._done_by_rid.values())

    @property
    def badput_serve_tokens(self) -> int:
        return sum(
            i.tokens_badput for i in self.incidents
            if i.kind in ("evict", "failover")
        )

    # -- output ------------------------------------------------------------
    def badput_waterfall(self) -> list[dict[str, Any]]:
        """Badput seconds by (class, cause), largest first."""
        agg: dict[tuple[str, str], float] = {}
        for host in self.hosts.values():
            for iv in host.intervals:
                if iv.klass in PRODUCTIVE:
                    continue
                key = (iv.klass, iv.cause or iv.klass)
                agg[key] = agg.get(key, 0.0) + iv.dur
        rows = [
            {"class": k, "cause": c, "seconds": round(s, 6)}
            for (k, c), s in agg.items()
        ]
        rows.sort(key=lambda r: -r["seconds"])
        return rows

    def _rate(self, kind: str, tokens: int) -> float | None:
        hosts = [h for h in self.hosts.values() if h.kind == kind]
        if not hosts or not tokens:
            return None
        lo = min(h.intervals[0].t0 for h in hosts)
        hi = max(h.intervals[-1].t1 for h in hosts)
        return round(tokens / (hi - lo), 2) if hi > lo else None

    def summary(self) -> dict[str, Any] | None:
        """The ``goodput`` section of the reduced cross-host view (and
        the report's input): per-host tables, fleet pool, token ledger,
        incident bills, badput waterfall."""
        if not self.hosts:
            return None
        hosts = {str(p): h.summary() for p, h in sorted(self.hosts.items())}
        fleet_sec: dict[str, float] = {}
        for h in self.hosts.values():
            for k, v in h.seconds().items():
                fleet_sec[k] = fleet_sec.get(k, 0.0) + v
        wall = sum(fleet_sec.values())
        prod = sum(fleet_sec.get(k, 0.0) for k in PRODUCTIVE)
        tokens: dict[str, Any] = {
            "tokens_per_step": self._tps,
            "effective_train_tokens": self.effective_train_tokens,
            "badput_train_tokens": self.badput_train_tokens,
            "effective_serve_tokens": self.effective_serve_tokens,
            "badput_serve_tokens": self.badput_serve_tokens,
        }
        r_train = self._rate("train", self.effective_train_tokens)
        r_serve = self._rate("serve", self.effective_serve_tokens)
        if r_train is not None:
            tokens["effective_train_tokens_per_sec"] = r_train
        if r_serve is not None:
            tokens["effective_serve_tokens_per_sec"] = r_serve
        incidents = sorted(
            (i for i in self.incidents),
            key=lambda i: (i.t_detect is None, i.t_detect or 0.0),
        )
        return {
            "hosts": hosts,
            "fleet": {
                "wall_s": round(wall, 6),
                "goodput_pct": (
                    None if wall <= 0 else round(100.0 * prod / wall, 2)
                ),
                "seconds": {k: round(v, 6) for k, v in fleet_sec.items()},
            },
            "tokens": tokens,
            "incidents": [i.to_dict() for i in incidents],
            "badput_waterfall": self.badput_waterfall(),
        }


# --------------------------------------------------------------------------
# online gauge


class OnlineGoodput:
    """Sliding-window goodput gauge fed from timestamps the runtimes
    already take — the trainer's step breakdown, the serving scheduler's
    iteration clock. Maintains the ``goodput_pct`` gauge, emits periodic
    ``counter`` events (Perfetto ``ph: "C"`` tracks), and is the sample
    source for the ``goodput_min_pct`` SLO floor. Never reads a clock
    and never syncs a device."""

    def __init__(
        self,
        registry: Any,
        *,
        counter_every: int = 8,
        window: int = 512,
    ):
        from collections import deque

        self.registry = registry
        self.counter_every = max(int(counter_every), 0)
        self._win: Any = deque(maxlen=max(int(window), 2))
        self._updates = 0

    def note(self, klass: str, seconds: float) -> None:
        """Attribute ``seconds`` of wall-clock to one taxonomy class."""
        if seconds > 0.0:
            self._win.append((klass, float(seconds)))

    def pct(self) -> float | None:
        total = sum(s for _, s in self._win)
        if total <= 0.0:
            return None
        prod = sum(s for k, s in self._win if k in PRODUCTIVE)
        return 100.0 * prod / total

    def update(self, **where: Any) -> float | None:
        """Refresh the gauge; every ``counter_every``-th call also emits
        a ``counter`` event (0 = gauge only). Returns the current pct so
        callers can feed their SLO monitor without recomputing."""
        p = self.pct()
        if p is None:
            return None
        p = round(p, 2)
        self.registry.gauge("goodput_pct").set(p)
        self._updates += 1
        if self.counter_every and self._updates % self.counter_every == 0:
            self.registry.emit("counter", name="goodput_pct", value=p, **where)
        return p
