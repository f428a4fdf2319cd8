"""Hung-step watchdog.

Two layers, both off the hot path:

- **flagging** (host-side, post-step): each completed step's duration is
  compared against ``factor`` x the trailing median; the caller records
  the outliers :meth:`StepWatchdog.observe` returns (the serving engine
  counts them as ``serve_hung_steps``).
- **hard timeout** (background thread, opt-in via ``hard_timeout_s > 0``):
  a step that never completes — a wedged kernel, a deadlocked host —
  cannot be observed post-hoc. The monitor thread dumps every thread's
  stack and interrupts the main thread, escalating to SIGABRT when the
  main thread is stuck in native code.
"""

from __future__ import annotations

import faulthandler
import os
import threading
import time
from collections import deque
from typing import Any, Callable


class StepWatchdog:
    def __init__(
        self,
        cfg: Any,
        *,
        interrupt: Callable[[], None] | None = None,
        escalate: Callable[[], None] | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.cfg = cfg
        self._durations: deque[float] = deque(maxlen=64)
        self._clock = clock
        self.timed_out = False
        self.flags = 0
        # hard-timeout monitor state
        self._armed_at: float | None = None
        self._armed_step: int | None = None
        self._armed_budget: float = cfg.hard_timeout_s
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if interrupt is None:
            import _thread

            interrupt = _thread.interrupt_main
        self._interrupt = interrupt
        if escalate is None:
            def escalate() -> None:
                import signal as _signal

                os.kill(os.getpid(), _signal.SIGABRT)
        self._escalate = escalate

    # -- flagging ----------------------------------------------------------
    def trailing_median(self) -> float | None:
        if len(self._durations) < max(int(self.cfg.min_samples), 1):
            return None
        vals = sorted(self._durations)
        return vals[len(vals) // 2]

    def observe(self, step: int, duration_s: float) -> dict | None:
        """Record a completed step; return flag details when it was a
        ``factor``-x outlier vs the trailing median (else None). The outlier
        itself is NOT added to the history — one hang must not license the
        next."""
        self.disarm()
        med = self.trailing_median()
        if (
            med is not None
            and med > 0
            and duration_s > self.cfg.factor * med
        ):
            self.flags += 1
            return {
                "step": step,
                "duration_s": round(duration_s, 4),
                "median_s": round(med, 4),
                "factor": round(duration_s / med, 2),
            }
        self._durations.append(duration_s)
        return None

    # -- hard timeout ------------------------------------------------------
    def start(self) -> None:
        if self.cfg.hard_timeout_s <= 0 or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._monitor, name="dtc-torch-step-watchdog", daemon=True
        )
        self._thread.start()

    def arm(self, step: int, budget_s: float | None = None) -> None:
        """Start the hard-timeout clock for one unit of blocking work.
        ``budget_s`` overrides ``hard_timeout_s`` for work whose healthy
        duration is not step-scale (the trainer's log-boundary fetch waits
        out the whole dispatched window under async dispatch)."""
        if self._thread is None:
            return
        with self._lock:
            self._armed_at = self._clock()
            self._armed_step = step
            self._armed_budget = (
                budget_s if budget_s is not None else self.cfg.hard_timeout_s
            )

    def disarm(self) -> None:
        if self._thread is None:
            return
        with self._lock:
            self._armed_at = None
            self._armed_step = None

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _monitor(self) -> None:
        # Poll at a fraction of the timeout: cheap, and the abort path is
        # seconds-scale anyway.
        poll = max(self.cfg.hard_timeout_s / 10.0, 0.05)
        while not self._stop.wait(poll):
            with self._lock:
                armed_at, step = self._armed_at, self._armed_step
                budget = self._armed_budget
            if armed_at is None:
                continue
            waited = self._clock() - armed_at
            if waited <= budget:
                continue
            self.timed_out = True
            print(
                f"[dtc_tpu_torch] WATCHDOG: step {step} exceeded hard timeout "
                f"({waited:.1f}s > {budget}s); dumping "
                "stacks and aborting"
            )
            try:
                faulthandler.dump_traceback(all_threads=True)
            except Exception:
                pass
            self._interrupt()
            # interrupt_main only lands between Python bytecodes: a main
            # thread wedged INSIDE a C call (a hung collective — the very
            # case this watchdog exists for) never sees it. Give the clean
            # abort a grace window, then escalate to a process kill; the
            # flushed JSONL/CSV prefixes are the crash-survival contract.
            grace = min(30.0, max(self.cfg.hard_timeout_s / 4.0, 1.0))
            if not self._stop.wait(grace):
                with self._lock:
                    still_armed = self._armed_at is not None
                if still_armed:
                    print(
                        "[dtc_tpu_torch] WATCHDOG: clean abort did not land within "
                        f"{grace:.0f}s (main thread wedged in native code); "
                        "escalating to SIGABRT"
                    )
                    self._escalate()
            return
