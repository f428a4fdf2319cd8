"""Step-time breakdown and compile tracking.

Answers *where does a step's wall-clock go?* Four host-side phases are
timed around the existing train step (no device instrumentation, no step
overhead beyond four ``perf_counter`` calls):

- ``data_wait_s``   — blocked on ``next(data_it)``: host batch assembly
                      that prefetch failed to hide, plus the host->device
                      copy for synchronous feeding;
- ``dispatch_s``    — the train step call itself returning: the eager
                      forward, backward and optimizer launches (the card
                      runs behind the host, so this is host launch time);
- ``block_s``       — blocked on the device finishing (only when the
                      trainer syncs per step, else 0.0);
- ``step_time_s``   — whole-step wall-clock, begin->end.

Compile time: the eager port traces and compiles nothing per step. Its one
compile is the CUDA kernel libraries' ``nvcc`` build and load at first use
(:mod:`dtc_tpu_torch.ops._build`), whose seconds reach the active
:class:`CompileWatcher` through the build listener. On the CPU nothing is
built and the watcher reads 0.
"""

from __future__ import annotations

import time


class CompileWatcher:
    """Accumulates kernel-library build and load seconds while active.

    ``drain()`` returns and resets the window — callers attribute the
    drained seconds to whatever phase just ran (init, warmup, step N).
    """

    def __init__(self):
        self._seconds = 0.0
        self._count = 0

    def _on_build(self, seconds: float, count: int) -> None:
        self._seconds += seconds
        self._count += count

    def activate(self) -> "CompileWatcher":
        from dtc_tpu_torch.ops import _build

        _build.add_listener(self._on_build)
        return self

    def deactivate(self) -> None:
        from dtc_tpu_torch.ops import _build

        _build.remove_listener(self._on_build)

    def drain(self) -> tuple[float, int]:
        s, c = self._seconds, self._count
        self._seconds, self._count = 0.0, 0
        return s, c


class StepClock:
    """Phase timer for one training step.

    Usage in the trainer loop::

        clock.begin(step)
        with clock.phase("data_wait"): x, y = next(data_it)
        with clock.phase("dispatch"):  loss = train_step(...)
        with clock.phase("block"):     torch.cuda.synchronize()
        breakdown = clock.end()        # dict of *_s floats
    """

    PHASES = ("data_wait", "dispatch", "block")

    def __init__(self):
        self._t0: float | None = None
        self._acc: dict[str, float] = {}
        self.step: int | None = None

    def begin(self, step: int) -> None:
        self.step = step
        self._acc = {p: 0.0 for p in self.PHASES}
        self._t0 = time.perf_counter()

    def phase(self, name: str) -> "_Phase":
        return _Phase(self._acc, name)

    def end(self) -> dict[str, float]:
        """The step's seconds by phase, unrounded, so that ``data_wait_s +
        dispatch_s + block_s + other_s`` is ``step_time_s`` to float
        precision."""
        total = time.perf_counter() - (self._t0 or time.perf_counter())
        out = {f"{p}_s": v for p, v in self._acc.items()}
        out["step_time_s"] = total
        # Whatever the three phases don't cover is host-side loop overhead
        # (logging, checkpoint bookkeeping) — worth seeing when it grows.
        out["other_s"] = max(0.0, total - sum(self._acc.values()))
        return out


class _Phase:
    __slots__ = ("_acc", "_name", "_t0")

    def __init__(self, acc: dict[str, float], name: str):
        self._acc = acc
        self._name = name

    def __enter__(self) -> "_Phase":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._acc[self._name] = self._acc.get(self._name, 0.0) + (
            time.perf_counter() - self._t0
        )
