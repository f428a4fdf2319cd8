"""Anomaly guard: loss-health checks at log boundaries with a recovery
ladder, the port's copy of the JAX package's ``resilience/guard.py``.

Checks run on the window of losses the trainer already fetched for
logging, so they add no device sync. Two anomaly classes: any non-finite
loss in the window, and (``spike_factor > 0``) a window mean above
``spike_factor`` x the trailing median of healthy window means.

The ladder, cheapest rung first:

1. **tolerate**: with ``skip_nonfinite_updates`` the optimizer already
   dropped the non-finite updates on the device, so up to
   ``max_consecutive_skips`` consecutive non-finite windows are tolerated;
2. **rollback**: the trainer restores the newest verified checkpoint and
   re-seeks the data stream, at most ``max_rollbacks`` times a run, or an
   incident when ``clean_steps_to_forgive`` is set (that many consecutive
   healthy windows reset the count);
3. **abort**: the trainer raises
   :class:`~dtc_tpu_torch.resilience.errors.AnomalyAbort`.

Without a checkpoint to roll back to (``can_rollback`` false) the guard
only reports (``warn``).
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Any


@dataclass
class GuardDecision:
    action: str          # "ok" | "warn" | "tolerate" | "rollback" | "abort"
    reason: str = ""

    @property
    def anomalous(self) -> bool:
        return self.action != "ok"


class AnomalyGuard:
    def __init__(self, cfg: Any, *, can_rollback: bool = False):
        self.cfg = cfg
        self.can_rollback = can_rollback
        self.rollbacks_done = 0
        self._consecutive_bad = 0
        # Consecutive healthy windows since the last anomaly (forgiveness).
        self._clean_windows = 0
        # Window means of healthy windows only: an anomaly must not drag
        # the median toward itself.
        self._means: deque[float] = deque(maxlen=max(int(cfg.spike_window), 2))

    # -- detection ---------------------------------------------------------
    def _trailing_median(self) -> float | None:
        # At least 4 windows (or the deque's length, if shorter) of history.
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

    def healthy_loss(self, value: float) -> bool:
        """One loss judged as a window is (the trainer's checkpoint gate): a
        verified but diverged checkpoint would become the rollback target."""
        if not self.cfg.enabled:
            return True
        return self._classify([value]) is None

    # -- ladder ------------------------------------------------------------
    def check_window(self, step: int, losses: list[float]) -> GuardDecision:
        """Judge one log window; the trainer carries out the action."""
        if not self.cfg.enabled or not losses:
            return GuardDecision("ok")
        reason = self._classify(losses)
        if reason is None:
            self._consecutive_bad = 0
            self._means.append(sum(losses) / len(losses))
            self._clean_windows += 1
            forgive = int(self.cfg.clean_steps_to_forgive)
            if forgive > 0 and self.rollbacks_done > 0 and self._clean_windows >= forgive:
                self.rollbacks_done = 0
                self._clean_windows = 0
            return GuardDecision("ok")
        self._clean_windows = 0
        self._consecutive_bad += 1
        if (self.cfg.skip_nonfinite_updates and reason == "non-finite loss"
                and self._consecutive_bad <= self.cfg.max_consecutive_skips):
            return GuardDecision(
                "tolerate",
                f"{reason} @ step {step}; updates skipped device-side "
                f"({self._consecutive_bad}/{self.cfg.max_consecutive_skips} "
                "windows tolerated)",
            )
        if not self.can_rollback:
            return GuardDecision("warn", f"{reason} @ step {step}; no checkpoint to roll "
                                 "back to")
        if self.rollbacks_done >= self.cfg.max_rollbacks:
            return GuardDecision(
                "abort",
                f"{reason} @ step {step} after {self.rollbacks_done} rollbacks — policy "
                "ladder exhausted",
            )
        return GuardDecision("rollback", f"{reason} @ step {step}")

    def note_rollback(self) -> None:
        """The trainer completed a rollback this guard ordered."""
        self.rollbacks_done += 1
        self._consecutive_bad = 0

    def note_rollback_failed(self) -> None:
        """The trainer could not carry out an ordered rollback (no intact
        checkpoint). It burns a rung all the same, so a run whose
        checkpoints are all gone still reaches the abort rung."""
        self.rollbacks_done += 1
