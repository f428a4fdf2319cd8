"""Retry with exponential backoff for one-shot operations.

The serving engine's transient-fault wrapper: a decode or prefill step
whose logits read back non-finite is re-run from the pre-step cache.
``sleep``, ``clock`` and ``rng`` are injectable so tests run instantly.
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable


def backoff_schedule(
    attempt: int, base_s: float, max_s: float, jitter: float,
    rng: random.Random | None = None,
) -> float:
    """Delay before retry ``attempt`` (1-based): ``base * 2**(attempt-1)``
    capped at ``max_s``, +/- ``jitter`` fraction of itself."""
    delay = min(base_s * (2.0 ** (attempt - 1)), max_s)
    if jitter > 0:
        r = rng if rng is not None else random
        delay *= 1.0 + jitter * (2.0 * r.random() - 1.0)
    return max(delay, 0.0)


def retry_call(
    fn: Callable[[], Any],
    *,
    max_attempts: int = 3,
    backoff_s: float = 0.05,
    backoff_max_s: float = 1.0,
    jitter: float = 0.0,
    max_elapsed_s: float = 0.0,
    transient: tuple[type[BaseException], ...] = (Exception,),
    on_event: Callable[..., None] | None = None,
    sleep: Callable[[float], None] = time.sleep,
    rng: random.Random | None = None,
    clock: Callable[[], float] = time.monotonic,
) -> Any:
    """Call ``fn`` until it succeeds. After ``max_attempts`` consecutive
    failures — or when the episode would outlive ``max_elapsed_s`` (> 0)
    — re-raise the LAST exception unchanged, so callers keep their typed
    errors. ``fn`` must be safe to re-invoke from the start. ``on_event``
    receives one ``("recovery", action="call_retry", ...)`` record per
    re-attempt."""
    start = clock()
    attempt = 0
    while True:
        try:
            return fn()
        except transient as e:
            attempt += 1
            delay = backoff_schedule(attempt, backoff_s, backoff_max_s, jitter, rng)
            exhausted = attempt >= max_attempts or (
                max_elapsed_s > 0 and (clock() - start) + delay > max_elapsed_s
            )
            if exhausted:
                raise
            if on_event is not None:
                on_event(
                    "recovery", action="call_retry", attempt=attempt,
                    backoff_s=round(delay, 3), error=f"{type(e).__name__}: {e}",
                )
            sleep(delay)
