"""Deterministic fault injection (the chaos harness): the port's copy of
the JAX package's ``resilience/chaos.py``.

A ``resilience.chaos`` (or ``serve.chaos``) block makes every recovery
path run on purpose: at a chosen step (or raw-document index) the injector
raises a transient data-stream error, stalls the stream, damages the
checkpoint just written, poisons the parameters and the loss with NaN, or
delivers a real SIGTERM. Each fault fires EXACTLY once per injector, so a
healed run does not injure itself again after a rollback, and every
injection posts one ``chaos`` record on the recovery bus.

The injector sits on the production paths, never beside them: the data
fault is raised underneath the retry wrapper that heals real network
errors, the checkpoint damage hits the files on disk after their manifest
was written, and the preemption goes through the process's signal
handler.

The serving engine (:mod:`dtc_tpu_torch.serve.engine`) consults the
``serve_*`` hooks at its iteration boundaries: preemption and KV page
corruption drive the evict → re-prefill path, the stall the serving
watchdog, poisoned logits the finite check's retry from the pre-step
cache. The fleet router (:mod:`dtc_tpu_torch.serve.router`) consults
the ``fleet_*`` hooks at its own iteration boundaries: a replica kill
drives failover onto the survivors, a replica stall the replica-level
watchdog and degraded routing, a partition the retries, missed heartbeats
and the death verdict. The elastic trainer (``train/trainer.py``) consults
the ``kill_host`` / ``slow_host`` / ``lose_snapshot`` hooks before each
step's heartbeat tick and ``maybe_tear_cold_spill`` after a cold-tier
write; the resource pool (:mod:`dtc_tpu_torch.pool.manager`) the
``pool_*`` hooks while a transition is in flight.
"""

from __future__ import annotations

import os
import time
from typing import Any, Iterable, Iterator

from dtc_tpu_torch.resilience.errors import ChaosInjectedError
from dtc_tpu_torch.resilience.events import RecoveryBus


class ChaosInjector:
    """Config-driven, fire-once fault hooks. Built once per run from a
    ``ChaosConfig``; with ``cfg.enabled`` false every hook is inert."""

    def __init__(self, cfg: Any, bus: RecoveryBus | None = None):
        self.cfg = cfg
        self.bus = bus
        self._fired: set[str] = set()

    def _fire(self, key: str, **fields: Any) -> bool:
        """True exactly once per fault key; posts a ``chaos`` record."""
        if not self.cfg.enabled or key in self._fired:
            return False
        self._fired.add(key)
        if self.bus is not None:
            self.bus.post("chaos", kind=key, **fields)
        print(f"[dtc_tpu_torch] CHAOS: injecting {key} ({fields})")
        return True

    # ---- data plane (runs on the stream's prefetch thread) ---------------
    def wrap_raw_documents(self, it: Iterator[Any], start_index: int) -> Iterator[Any]:
        """Wrap a raw document iterator whose first item has absolute index
        ``start_index``. Raises a transient :class:`ChaosInjectedError` (or
        sleeps ``stall_s``) just BEFORE the configured 1-based document
        index, after ``N-1`` documents were read: where a mid-stream
        network fault lands."""
        index = start_index
        for item in it:
            if index + 1 == self.cfg.data_stall_at_doc and self._fire(
                "data_stall", doc=index + 1, stall_s=self.cfg.stall_s
            ):
                time.sleep(self.cfg.stall_s)
            if index + 1 == self.cfg.data_error_at_doc and self._fire(
                "data_error", doc=index + 1
            ):
                raise ChaosInjectedError(
                    f"chaos: injected transient stream fault before raw "
                    f"document {index + 1}"
                )
            index += 1
            yield item

    # ---- trainer plane ---------------------------------------------------
    def maybe_poison(self, step: int, params: Iterable[Any], loss: Any):
        """After the update of ``step``: multiply every trainable parameter
        (``params``) by NaN in place and return the loss times NaN, a
        diverged update the anomaly guard must detect and roll back. The
        product keeps shapes, dtypes and devices; optimizer state (moments,
        ``bf16_mixed``'s float32 masters) is not touched. Returns ``loss``
        unchanged when the fault does not fire."""
        if step != self.cfg.nan_at_step or not self._fire("nan_loss", step=step):
            return loss
        import torch

        with torch.no_grad():
            for p in params:
                p.mul_(float("nan"))
        return loss * float("nan")

    def should_preempt(self, step: int) -> bool:
        """Simulated preemption: the trainer delivers a real SIGTERM to its
        own process, so the graceful-stop handler runs end to end."""
        return step == self.cfg.sigterm_at_step and self._fire("sigterm", step=step)

    # ---- serving plane (1-based scheduler iterations) --------------------
    def serve_stall(self, it: int) -> float:
        """Seconds the scheduler must stall at iteration ``it`` (0 = no
        fault). The engine sleeps INSIDE its timed iteration, so the
        serving watchdog sees a real outlier."""
        if it == self.cfg.serve_stall_at_step and self._fire(
            "serve_stall", iteration=it, stall_s=self.cfg.stall_s
        ):
            return self.cfg.stall_s
        return 0.0

    def serve_preempt(self, it: int) -> bool:
        """Mid-request preemption: the engine evicts its newest active
        request, which re-prefill must recover bit for bit. Fires once at
        the FIRST iteration at or past the configured one where the engine
        asks; it asks only with an active request, so the shot is never
        spent (nor a chaos record posted) with nothing to act on."""
        return (
            0 < self.cfg.serve_preempt_at_step <= it
            and self._fire("serve_preempt", iteration=it)
        )

    def serve_corrupt_page(self, it: int) -> bool:
        """KV page corruption: the engine damages a COMPLETED page of its
        oldest active request on the device, which the page-checksum
        verifier must catch before a token computed from it is emitted.
        Deferred like :meth:`serve_preempt` (asked only when a completed
        page exists)."""
        return (
            0 < self.cfg.serve_corrupt_page_at_step <= it
            and self._fire("serve_corrupt_page", iteration=it)
        )

    def serve_poison_logits(self, it: int) -> bool:
        """Poisoned decode logits: the step's finite check reads false, as
        if the device had returned NaN, so the engine's retry from the
        pre-step cache runs and must land on the same tokens. Deferred
        like :meth:`serve_preempt` (asked inside a decode attempt)."""
        return (
            0 < self.cfg.serve_poison_logits_at_step <= it
            and self._fire("serve_poison_logits", iteration=it)
        )

    # ---- fleet plane (1-based router iterations) -------------------------
    def fleet_kill_replica(self, it: int) -> bool:
        """Kill ``fleet_target_replica`` mid-traffic: its queued and
        in-flight requests fail over to the survivors. Deferred like
        :meth:`serve_preempt` (asked only while traffic is in flight)."""
        return (
            0 < self.cfg.fleet_kill_replica_at_step <= it
            and self._fire(
                "fleet_kill_replica", iteration=it,
                replica=self.cfg.fleet_target_replica,
            )
        )

    def fleet_stall_replica(self, it: int) -> float:
        """Seconds ``fleet_target_replica``'s next step stalls (0 = no
        fault), OUTSIDE the engine's timed iteration: a wedged transport
        the replica-level watchdog must flag."""
        if 0 < self.cfg.fleet_stall_replica_at_step <= it and self._fire(
            "fleet_stall_replica", iteration=it,
            replica=self.cfg.fleet_target_replica, stall_s=self.cfg.stall_s,
        ):
            return self.cfg.stall_s
        return 0.0

    def fleet_partition(self, it: int) -> int:
        """Router iterations ``fleet_target_replica`` is unreachable for
        (0 = no fault): short partitions heal, one past the heartbeat miss
        limit escalates to the kill path."""
        if 0 < self.cfg.fleet_partition_at_step <= it and self._fire(
            "fleet_partition", iteration=it,
            replica=self.cfg.fleet_target_replica,
            iters=self.cfg.fleet_partition_iters,
        ):
            return self.cfg.fleet_partition_iters
        return 0

    # ---- elastic plane (trainer loop steps) ------------------------------
    def kill_host(self, step: int) -> int | None:
        """The virtual host that stops heartbeating at ``step`` (None = no
        fault)."""
        if step == self.cfg.kill_host_at_step and self._fire(
            "kill_host", step=step, host=self.cfg.elastic_target_host
        ):
            return self.cfg.elastic_target_host
        return None

    def slow_host(self, step: int) -> tuple[int, int] | None:
        """``(host, straggle_iters)`` when the victim's heartbeats start
        arriving late at ``step``: a straggler, not a loss."""
        if step == self.cfg.slow_host_at_step and self._fire(
            "slow_host", step=step, host=self.cfg.elastic_target_host,
            iters=self.cfg.slow_host_iters,
        ):
            return self.cfg.elastic_target_host, self.cfg.slow_host_iters
        return None

    def lose_snapshot(self, step: int) -> int | None:
        """The host whose primary in-memory snapshot copy vanishes at
        ``step`` (None = no fault)."""
        if step == self.cfg.lose_snapshot_at_step and self._fire(
            "lose_snapshot", step=step, host=self.cfg.elastic_target_host
        ):
            return self.cfg.elastic_target_host
        return None

    def maybe_tear_cold_spill(self, step: int, step_dir: str) -> bool:
        """A torn cold-tier spill: truncate the largest file of the
        checkpoint just written at ``step``."""
        if step != self.cfg.torn_cold_spill_at_step or not self._fire(
            "torn_cold_spill", step=step
        ):
            return False
        return self._damage_dir(step_dir, "truncate")

    def maybe_corrupt_checkpoint(self, step: int, step_dir: str) -> bool:
        """After the checkpoint of ``step`` was fully written (manifest
        included): damage the largest file under ``step_dir``
        (``truncate`` halves it, ``flip`` inverts a byte window mid-file),
        so verification must catch it on a later restore."""
        if step != self.cfg.corrupt_ckpt_at_step or not self._fire(
            "ckpt_corrupt", step=step, mode=self.cfg.corrupt_mode
        ):
            return False
        return self._damage_dir(step_dir, self.cfg.corrupt_mode)

    # ---- pool plane (pool ticks) -----------------------------------------
    def pool_spike_mid_grow(self, it: int) -> int:
        """A request burst (its size, 0 = no fault) while a trainer grow
        is in flight. Deferred: asked only mid-grow."""
        if 0 < self.cfg.pool_spike_mid_grow_at <= it and self._fire(
            "pool_spike_mid_grow", iteration=it,
            requests=self.cfg.pool_spike_requests,
        ):
            return self.cfg.pool_spike_requests
        return 0

    def pool_kill_mid_shrink(self, it: int) -> int | None:
        """The host (None = no fault) that dies while the trainer
        surrenders devices. Deferred: asked only mid-shrink."""
        if 0 < self.cfg.pool_kill_mid_shrink_at <= it and self._fire(
            "pool_kill_mid_shrink", iteration=it,
            host=self.cfg.elastic_target_host,
        ):
            return self.cfg.elastic_target_host
        return None

    def pool_kill_draining_replica(self, it: int) -> bool:
        """Kill the replica being retired mid-drain. Deferred: asked only
        while a retirement drain is in flight."""
        return (
            0 < self.cfg.pool_kill_draining_replica_at <= it
            and self._fire("pool_kill_draining_replica", iteration=it)
        )

    @staticmethod
    def _damage_dir(step_dir: str, mode: str) -> bool:
        """Damage the largest file under ``step_dir``: ``truncate`` chops
        it to half its size, ``flip`` inverts up to 64 bytes from its
        middle. False when the directory holds no file."""
        target, size = None, -1
        for root, _, files in os.walk(step_dir):
            for name in files:
                p = os.path.join(root, name)
                s = os.path.getsize(p)
                if s > size:
                    target, size = p, s
        if target is None:
            return False
        if mode == "truncate":
            with open(target, "r+b") as f:
                f.truncate(size // 2)
        else:  # flip
            with open(target, "r+b") as f:
                f.seek(size // 2)
                chunk = f.read(min(64, max(size - size // 2, 1)))
                f.seek(size // 2)
                f.write(bytes(b ^ 0xFF for b in chunk))
        return True
