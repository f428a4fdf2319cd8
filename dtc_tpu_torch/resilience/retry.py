"""Retry with exponential backoff: :func:`resilient_iterator` for
re-openable streams and :func:`retry_call` for one-shot operations.

A document stream that dies on a transient fault cannot be resumed in
place, but it can be re-opened at an index. :func:`resilient_iterator`
tracks the absolute index of the next item and on a failure re-opens
``factory(index)`` there, so the consumer sees one exactly-once sequence
across any number of re-opens (the JAX package's ``resilience/retry.py``).
:func:`retry_call` is the serving engine's transient-fault wrapper: a
decode or prefill step whose logits read back non-finite is re-run from
the pre-step cache. ``sleep``, ``clock`` and ``rng`` are injectable so
tests run instantly.
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable, Iterator

from dtc_tpu_torch.resilience.errors import DataStreamError


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


def resilient_iterator(
    factory: Callable[[int], Iterator[Any]],
    *,
    start_index: int = 0,
    max_attempts: int = 5,
    backoff_s: float = 1.0,
    backoff_max_s: float = 30.0,
    jitter: float = 0.1,
    max_elapsed_s: float = 0.0,
    transient: tuple[type[BaseException], ...] = (Exception,),
    on_event: Callable[..., None] | None = None,
    sleep: Callable[[float], None] = time.sleep,
    rng: random.Random | None = None,
    cancel: Any = None,
    clock: Callable[[], float] = time.monotonic,
) -> Iterator[Any]:
    """Yield ``factory(start_index)``'s items, re-opening at the failing
    index on a transient fault. ``factory(index)`` returns an iterator
    whose first item is the stream's absolute item ``index``. The failure
    count resets after every item, so ``max_attempts`` bounds the attempts
    per fault; once they are spent (or a fault episode would outlive
    ``max_elapsed_s`` > 0) it raises :class:`DataStreamError` with the last
    fault as ``__cause__``. ``StopIteration`` from the source ends the
    stream and is never retried. ``cancel`` (a ``threading.Event``) ends
    the stream at once instead of sleeping out a backoff, for a consumer
    tearing its pipeline down. ``on_event`` receives one
    ``("recovery", action="stream_retry", ...)`` record per re-open."""
    index = start_index
    attempts = 0
    episode_start: float | None = None
    it = None
    while True:
        try:
            if it is None:
                it = factory(index)
            item = next(it)
        except StopIteration:
            return
        except transient as e:
            attempts += 1
            now = clock()
            if episode_start is None:
                episode_start = now
            if attempts >= max_attempts:
                raise DataStreamError(
                    f"data stream failed {attempts} consecutive attempts at "
                    f"item {index}; giving up ({type(e).__name__}: {e})"
                ) from e
            if cancel is not None and cancel.is_set():
                return
            delay = backoff_schedule(attempts, backoff_s, backoff_max_s, jitter, rng)
            if max_elapsed_s > 0 and (now - episode_start) + delay > max_elapsed_s:
                raise DataStreamError(
                    f"data stream fault episode exceeded max_elapsed_s="
                    f"{max_elapsed_s} at item {index} (attempt {attempts}, "
                    f"{now - episode_start:.3f}s elapsed + {delay:.3f}s "
                    f"backoff pending); giving up ({type(e).__name__}: {e})"
                ) from e
            if on_event is not None:
                on_event(
                    "recovery", action="stream_retry", index=index,
                    attempt=attempts, backoff_s=round(delay, 3),
                    error=f"{type(e).__name__}: {e}",
                )
            if cancel is not None:
                if cancel.wait(delay):
                    return
            else:
                sleep(delay)
            it = None  # re-open at the failing index
            continue
        attempts = 0
        episode_start = None
        index += 1
        yield item


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
