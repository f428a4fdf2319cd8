"""One fleet member: a :class:`ServingEngine` behind a replica handle (the
port's copy of the JAX package's ``serve/replica.py``).

The router talks only to ``submit()``, ``step()`` and the health and load
introspection here, never to the engine's internals, so a transport to
another process would change this file and not the router. What the
in-process handle models:

- **heartbeat**: a completed ``step()`` is the beat (it resets
  ``missed_beats``); a partitioned replica (chaos ``fleet_partition``)
  raises :class:`~dtc_tpu_torch.serve.request.ReplicaUnreachableError`
  instead, and the router counts the miss toward the death verdict
  (``heartbeat_miss_limit``);
- **hung-step health**: a :class:`~dtc_tpu_torch.resilience.watchdog.StepWatchdog`
  over the replica's whole step durations, one level above the engine's
  own watchdog: an injected fleet stall lands outside the engine's timed
  iteration, so only this one sees it; its flag is a DEGRADED signal;
- **state machine** ``healthy → degraded → draining → dead``: degraded
  replicas serve but stop attracting new placements (and recover after a
  clean hold window); draining ones finish what they hold; dead ones are
  failover sources, never targets.

Replicas in one process share its device: on one card they step one
after another on one stream, so a fleet's wall time is a time-sliced
card's, not a multi-replica throughput.
"""

from __future__ import annotations

import enum
import time
from typing import Any, Callable

from dtc_tpu_torch.resilience.watchdog import StepWatchdog
from dtc_tpu_torch.serve.engine import ServingEngine
from dtc_tpu_torch.serve.request import (
    ReplicaUnreachableError,
    Request,
    ServeResult,
)


class ReplicaState(enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"    # serving, but routed around for new work
    DRAINING = "draining"    # finishing in-flight; admits nothing new
    DEAD = "dead"            # failover source; never stepped again


class EngineReplica:
    """See the module docstring. ``replica_id`` is also the replica's obs
    process index: its registry, shard and trace track carry it."""

    def __init__(
        self,
        replica_id: int,
        engine: ServingEngine,
        *,
        watchdog_cfg: Any = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.replica_id = replica_id
        self.engine = engine
        self.clock = clock
        self.state = ReplicaState.HEALTHY
        self.missed_beats = 0
        self.dead_reason: str | None = None
        self.watchdog = (
            StepWatchdog(watchdog_cfg, clock=clock)
            if watchdog_cfg is not None and watchdog_cfg.enabled else None
        )
        self.hung_flags = 0
        self._stall_s = 0.0        # chaos: the next step sleeps this long
        self._partition_left = 0   # chaos: steps of unreachability left

    # -- chaos / transport-fault injection points ------------------------
    def stall(self, seconds: float) -> None:
        self._stall_s = max(self._stall_s, float(seconds))

    def partition(self, iters: int) -> None:
        self._partition_left = max(self._partition_left, int(iters))

    @property
    def partitioned(self) -> bool:
        return self._partition_left > 0

    # -- load / residency introspection (placement inputs) ---------------
    @property
    def accepting(self) -> bool:
        """May receive new placements: healthy or degraded."""
        return self.state in (ReplicaState.HEALTHY, ReplicaState.DEGRADED)

    @property
    def queue_room(self) -> int:
        return self.engine.queue_room

    @property
    def load(self) -> int:
        return self.engine.load

    def resident_adapters(self) -> frozenset[str]:
        store = self.engine.adapter_store
        return frozenset(store.snapshot()["resident"]) if store else frozenset()

    def has_prefix(self, req: Request) -> bool:
        return self.engine.has_prefix(req)

    # -- the transport surface -------------------------------------------
    def submit(self, req: Request, *, resume: ServeResult | None = None) -> str:
        if self.state is ReplicaState.DEAD:
            raise ReplicaUnreachableError(
                f"replica {self.replica_id} is dead ({self.dead_reason})"
            )
        if self.partitioned:
            raise ReplicaUnreachableError(
                f"replica {self.replica_id} unreachable (partition, "
                f"{self._partition_left} step(s) left)"
            )
        return self.engine.submit(req, resume=resume)

    def step(self) -> bool:
        """One scheduler iteration on this replica. Raises
        :class:`ReplicaUnreachableError` while partitioned (the router
        counts the missed beat); otherwise beats and feeds the replica's
        watchdog. Returns the engine's busy flag."""
        if self.state is ReplicaState.DEAD:
            return False
        if self.partitioned:
            self._partition_left -= 1
            raise ReplicaUnreachableError(
                f"replica {self.replica_id} missed heartbeat (partition)"
            )
        t0 = self.clock()
        stalled = self._stall_s > 0
        if stalled:
            # The injected fleet stall, outside the engine's iteration, as
            # a wedged transport would be.
            self.engine.sleep(self._stall_s)
            self._stall_s = 0.0
        busy = self.engine.step()
        dur = self.clock() - t0
        self.missed_beats = 0  # a completed step is the heartbeat
        # Working iterations feed the trailing median (idle spins would
        # collapse it), and a stalled step is always observed: it is the
        # outlier this watchdog exists for.
        if self.watchdog is not None and (self.engine._worked or stalled):
            flag = self.watchdog.observe(self.engine._it, dur)
            if flag is not None:
                self.hung_flags += 1
                self.engine.reg.emit(
                    "hung_step", runtime="fleet",
                    replica=self.replica_id, **flag,
                )
        return busy

    def miss_beat(self) -> int:
        """The router's accounting of a step that never answered."""
        self.missed_beats += 1
        return self.missed_beats

    # -- lifecycle --------------------------------------------------------
    def mark(self, state: ReplicaState, *, reason: str = "") -> None:
        if state is ReplicaState.DEAD:
            self.dead_reason = reason or "killed"
        self.state = state

    def drain(self, *, max_steps: int = 512) -> dict[str, ServeResult]:
        """Graceful retirement: the engine's shutdown (finish or typed
        eviction, bus drained, flight dumped), then DEAD ("drained")."""
        self.mark(ReplicaState.DRAINING)
        out = self.engine.shutdown(
            mode="drain", max_steps=max_steps,
            reason=f"replica {self.replica_id} drain",
        )
        self.mark(ReplicaState.DEAD, reason="drained")
        return out
