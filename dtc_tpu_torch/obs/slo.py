"""Online SLO monitor: objectives evaluated DURING the run.

Before this module the repo's SLO story was post-hoc: bench.py computed
p99s after the run ended, so an operator found out a latency objective
was blown "at bench time". The monitor moves that to "at iteration k":
configurable objectives (TTFT p99, ms/token p99, queue-wait p99, shed
rate for serving; step-time / data-wait p99 for training) are evaluated
over sliding sample windows at the runtime's own cadence and breaches
are emitted as typed ``slo_breach`` events — edge-triggered, with a
matching ``slo_recovered`` on the way back — that the serving
scheduler's existing degrade policy reacts to (``degrade_active``: a
breaching latency objective caps new admissions' ``max_new_tokens``
exactly like crossing the degrade watermark does).

Host-side pure Python, no device code; quantiles are exact nearest-rank over the
window (the windows are small — no bucketing needed here), shared with
bench via :func:`dtc_tpu_torch.utils.percentile.nearest_rank`.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any

from dtc_tpu_torch.utils.percentile import nearest_rank


@dataclass(frozen=True)
class Objective:
    """One SLO: ``kind`` "quantile" (nearest-rank ``q`` of the sampled
    ``metric`` must stay <= ``threshold``), "rate" (fraction of True
    outcomes in the window must stay <= ``threshold``), or "floor"
    (window mean of the metric must stay >= ``threshold`` — the goodput
    objective, where LOW is the failure direction)."""

    name: str          # e.g. "ttft_p99_s" — the knob/event label
    metric: str        # sample stream key, e.g. "serve_ttft_s"
    threshold: float
    kind: str = "quantile"
    q: float = 0.99


#: Objective templates per runtime, keyed by the SloConfig field name.
_SERVE_OBJECTIVES = {
    "ttft_p99_s": ("serve_ttft_s", "quantile"),
    "ms_per_token_p99": ("serve_ms_per_token", "quantile"),
    "queue_wait_p99_s": ("serve_queue_wait_s", "quantile"),
    "shed_rate": ("serve_outcome_shed", "rate"),
    "goodput_min_pct": ("goodput_pct", "floor"),
    # floor on ACCEPTED-token throughput — the speculative
    # engine samples its sliding accepted-tokens/s here every SLO check,
    # so shed/degrade honesty keys off tokens that landed, not proposals.
    "accepted_tokens_per_s_min": ("serve_accepted_tokens_per_s", "floor"),
}
_TRAIN_OBJECTIVES = {
    "step_time_p99_s": ("step_time_s", "quantile"),
    "data_wait_p99_s": ("data_wait_s", "quantile"),
    "goodput_min_pct": ("goodput_pct", "floor"),
}


class SloMonitor:
    """Sliding-window evaluator for a set of :class:`Objective`.

    ``observe(metric, value)`` feeds quantile objectives,
    ``observe_outcome(metric, flag)`` feeds rate objectives (one bool per
    terminal event). ``evaluate()`` — called by the runtime at its own
    cadence (``check_every`` scheduler iterations / train steps) —
    recomputes every objective, emits edge-triggered ``slo_breach`` /
    ``slo_recovered`` events through the registry, bumps the
    ``slo_breaches`` counter, and returns the breaches found this pass.
    """

    def __init__(
        self,
        objectives: list[Objective],
        registry: Any = None,
        *,
        window: int = 64,
        min_samples: int = 4,
    ):
        self.objectives = list(objectives)
        self.registry = registry
        self.min_samples = max(int(min_samples), 1)
        self._samples: dict[str, deque] = {
            o.metric: deque(maxlen=max(int(window), 2))
            for o in self.objectives
        }
        self.active: dict[str, dict[str, Any]] = {}  # name -> last breach

    # -- construction ------------------------------------------------------
    @classmethod
    def from_config(cls, cfg: Any, registry: Any = None, *,
                    runtime: str = "serve") -> "SloMonitor | None":
        """Build from a ``SloConfig`` block; None when disabled or no
        objective has a positive threshold (zero = objective off)."""
        if cfg is None or not getattr(cfg, "enabled", True):
            return None
        table = _SERVE_OBJECTIVES if runtime == "serve" else _TRAIN_OBJECTIVES
        objs = []
        for field, (metric, kind) in table.items():
            threshold = float(getattr(cfg, field, 0.0) or 0.0)
            if threshold > 0.0:
                objs.append(Objective(field, metric, threshold, kind))
        if not objs:
            return None
        return cls(objs, registry, window=cfg.window,
                   min_samples=cfg.min_samples)

    # -- sampling ----------------------------------------------------------
    def observe(self, metric: str, value: float | None) -> None:
        if value is None:
            return
        dq = self._samples.get(metric)
        if dq is not None:
            dq.append(float(value))

    def observe_outcome(self, metric: str, flag: bool) -> None:
        dq = self._samples.get(metric)
        if dq is not None:
            dq.append(1.0 if flag else 0.0)

    # -- evaluation --------------------------------------------------------
    def current(self, obj: Objective) -> float | None:
        vals = self._samples[obj.metric]
        if len(vals) < self.min_samples:
            return None
        if obj.kind in ("rate", "floor"):
            return sum(vals) / len(vals)
        return nearest_rank(vals, obj.q)

    def evaluate(self, **where: Any) -> list[dict[str, Any]]:
        """One monitoring pass; ``where`` (step=/iteration=) stamps the
        emitted events with the runtime's position."""
        breaches = []
        for obj in self.objectives:
            cur = self.current(obj)
            if obj.kind == "floor":
                breaching = cur is not None and cur < obj.threshold
            else:
                breaching = cur is not None and cur > obj.threshold
            record = {
                "objective": obj.name, "metric": obj.metric,
                "kind": obj.kind, "value": None if cur is None else round(cur, 6),
                "threshold": obj.threshold,
                "window_n": len(self._samples[obj.metric]), **where,
            }
            if breaching:
                breaches.append(record)
                if obj.name not in self.active and self.registry is not None:
                    self.registry.counter("slo_breaches").inc()
                    self.registry.emit("slo_breach", **record)
                self.active[obj.name] = record
            elif obj.name in self.active:
                del self.active[obj.name]
                if self.registry is not None:
                    self.registry.emit("slo_recovered", **record)
        return breaches

    @property
    def degrade_active(self) -> bool:
        """True while any latency (quantile) objective — or the
        accepted-token throughput floor — is breaching: the
        hook the serving scheduler's graceful-degradation policy
        consults at admission. A speculative engine whose accepted
        throughput collapses degrades new admissions exactly like a
        latency breach, so speculation cannot hide behind launch counts."""
        return any(
            rec["kind"] == "quantile"
            or rec["objective"] == "accepted_tokens_per_s_min"
            for rec in self.active.values()
        )
