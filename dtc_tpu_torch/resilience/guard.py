"""Anomaly guard: loss-health checks at log boundaries.

Checks run on the window of losses the trainer already fetched for
logging, so they add no device sync. Two anomaly classes: any non-finite
loss in the window, and (``spike_factor > 0``) a window mean above
``spike_factor`` x the trailing median of healthy window means. The JAX
package's policy ladder goes on to roll back to a verified checkpoint and
finally abort; the port has no checkpoints yet, and with nothing to roll
back to the JAX guard only reports (``warn``), which is what this one does.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Any


@dataclass
class GuardDecision:
    action: str          # "ok" | "warn"
    reason: str = ""

    @property
    def anomalous(self) -> bool:
        return self.action != "ok"


class AnomalyGuard:
    def __init__(self, cfg: Any):
        self.cfg = cfg
        # Window means of healthy windows only: an anomaly must not drag
        # the median toward itself.
        self._means: deque[float] = deque(maxlen=max(int(cfg.spike_window), 2))

    def _trailing_median(self) -> float | None:
        if len(self._means) < min(4, self._means.maxlen):
            return None
        return sorted(self._means)[len(self._means) // 2]

    def _classify(self, losses: list[float]) -> str | None:
        if any(not math.isfinite(v) for v in losses):
            return "non-finite loss"
        if self.cfg.spike_factor > 0:
            med = self._trailing_median()
            mean = sum(losses) / len(losses)
            if med is not None and mean > self.cfg.spike_factor * med:
                return (
                    f"loss spike: window mean {mean:.4g} > "
                    f"{self.cfg.spike_factor}x trailing median {med:.4g}"
                )
        return None

    def check_window(self, step: int, losses: list[float]) -> GuardDecision:
        """Judge one log window of fetched losses."""
        if not losses:
            return GuardDecision("ok")
        reason = self._classify(losses)
        if reason is None:
            self._means.append(sum(losses) / len(losses))
            return GuardDecision("ok")
        return GuardDecision(
            "warn", f"{reason} @ step {step}; no checkpoint to roll back to"
        )
