"""Thread-safe recovery event bus: the port's copy of the JAX package's
``resilience/events.py``.

Recovery actions happen where there is no telemetry handle: the stream's
retry fires on the prefetch worker thread, the checkpoint fallback inside
``CheckpointManager`` before the trainer's ``Telemetry`` exists, the
chaos hooks deep in the data plane. They post here; the trainer (at step
and log boundaries) and the serving engine (each iteration) drain the bus
into the event stream (``chaos`` / ``recovery`` kinds), so every recovery
action lands in the JSONL shard with a step attribution and nothing in
the data plane imports the obs code.
"""

from __future__ import annotations

import threading
from typing import Any


class RecoveryBus:
    """Bounded, thread-safe list of pending ``(etype, fields)`` records."""

    def __init__(self, maxlen: int = 1024):
        self._lock = threading.Lock()
        self._events: list[tuple[str, dict[str, Any]]] = []
        self._dropped = 0
        self._maxlen = maxlen

    def post(self, etype: str, **fields: Any) -> None:
        with self._lock:
            if len(self._events) >= self._maxlen:
                # A runaway retry loop must not turn the bus into a memory
                # leak; drops are counted and surfaced on the next drain.
                self._dropped += 1
                return
            self._events.append((etype, dict(fields)))

    def drain(self) -> list[tuple[str, dict[str, Any]]]:
        with self._lock:
            out, self._events = self._events, []
            if self._dropped:
                out.append(("recovery", {
                    "action": "bus_overflow", "dropped": self._dropped,
                }))
                self._dropped = 0
            return out
