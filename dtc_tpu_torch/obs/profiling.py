"""Profiler trace capture around a training-step window (hardened).

A window is one ``torch.profiler.profile`` session (host activity, and
the card's through CUPTI when CUDA is available) started at step
``start`` and stopped at step ``stop``; its Chrome trace is written to
``<log_dir>/profile.trace.json.gz``. Two failure modes warn and disable
instead of killing the run:

- a profiler session already active in the process (an outer harness, a
  device-profile window): torch would silently take the session over and
  leave the outer one empty, so the window refuses to start;
- an unwritable ``log_dir``: the failure surfaces when the trace is
  written at the window's stop.

Telemetry must never take down the training it observes.
"""

from __future__ import annotations

import os
import time

import torch

TRACE_NAME = "profile.trace.json.gz"


def profiler_active() -> bool:
    """Is a profiler session recording in this process?"""
    return bool(torch._C._autograd._profiler_enabled())


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


class StepWindowProfiler:
    def __init__(self, start_step: int, stop_step: int, log_dir: str):
        self.start = start_step
        self.stop = stop_step
        self.log_dir = log_dir
        self._active = False
        self._prof = None
        self.enabled = stop_step > start_step
        self.failed: str | None = None
        #: the stopped ``torch.profiler.profile`` of the last window (its
        #: ``key_averages()`` for the caller), None before one completes,
        #: and the seconds its start, and its stop and trace write, took.
        self.last_profile = None
        self.last_start_s: float | None = None
        self.last_stop_s: float | None = None

    def _disable(self, what: str, e: Exception) -> None:
        self.failed = f"{type(e).__name__}: {e}"
        self.enabled = False
        self._active = False
        print(
            f"[dtc_tpu_torch] WARNING: profiler {what} failed ({self.failed}); "
            "disabling trace capture for this run"
        )

    def _start(self) -> None:
        if profiler_active():
            raise RuntimeError("a profiler session is already active in this process")
        from torch.profiler import profile

        t0 = time.perf_counter()
        prof = profile(activities=_activities())
        prof.start()
        self._prof = prof
        self._active = True
        self.last_start_s = round(time.perf_counter() - t0, 6)

    def _stop(self) -> None:
        prof, self._prof = self._prof, None
        self._active = False
        t0 = time.perf_counter()
        prof.stop()  # waits for the card, so the window's kernels are in
        os.makedirs(self.log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.log_dir, TRACE_NAME))
        self.last_profile = prof
        self.last_stop_s = round(time.perf_counter() - t0, 6)

    def step(self, step: int) -> None:
        if not self.enabled:
            return
        if step == self.start and not self._active:
            try:
                self._start()
            except Exception as e:  # already active / profiler unavailable
                self._disable("start_trace", e)
        elif step == self.stop and self._active:
            try:
                self._stop()
            except Exception as e:  # unwritable log_dir
                self._disable("stop_trace", e)

    def close(self) -> None:
        if self._active:
            try:
                self._stop()
            except Exception as e:
                self._disable("stop_trace", e)
