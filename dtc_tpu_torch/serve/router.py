"""Tenant-aware front-end router over N serving-engine replicas: the port's
copy of the JAX package's ``serve/router.py``.

The engine's guarantees (every request ends with a typed
:class:`ServeResult`, eviction and re-prefill as the recovery path,
shed/degrade backpressure) lifted from one engine to a fleet:

- **placement**: a tenant's request goes to the replica whose
  AdapterStore already holds its factors (adapter residency as cache
  affinity), a shared system prompt to the replica whose prefix store
  holds its KV, everything else to the least loaded; degraded and
  about-to-shed replicas come last. A replica's own admission bound is
  respected: when every live queue is full, ``submit()`` raises
  :class:`~dtc_tpu_torch.serve.request.FleetSaturatedError`.
- **health**: heartbeats, the replica-level hung-step watchdog and each
  engine's SLO monitor drive ``healthy → degraded → draining → dead``
  (:mod:`dtc_tpu_torch.serve.replica`).
- **failover**: the router copies every request's generated tokens into
  its own record after each replica step, so a dead replica's queued and
  in-flight requests are resubmitted to survivors as prompt +
  generated-so-far through the engine's re-prefill path
  (``submit(resume=...)``); what cannot be placed ends typed. Zero silent
  drops.
- **transient faults**: an unreachable replica (chaos ``fleet_partition``)
  is retried with backoff (``resilience.retry.retry_call``), then routed
  around; past the heartbeat-miss budget it is declared dead and failed
  over.
- **observability**: each replica's registry carries its replica id as
  the obs process index (one JSONL shard each); the router's own shard is
  one past them, with the ``router_ttft_s`` / ``router_ms_per_token``
  histograms and the ``router_*`` events (route, failover,
  replica_state, reject), which ``obs.aggregate.reduce_shards`` rolls
  into one fleet view.

Every replica serves the caller's one model: one copy of the weights on
the device, and each replica its own paged cache, LoRA stack and prefix
store. In one process the replicas step one after another, so on one card
a fleet's times are a time-sliced card's, not a multi-replica throughput.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable

from dtc_tpu_torch.obs.aggregate import shard_path
from dtc_tpu_torch.obs.registry import JsonlSink, MetricsRegistry
from dtc_tpu_torch.obs.trace import FlightRecorder
from dtc_tpu_torch.resilience.chaos import ChaosInjector
from dtc_tpu_torch.resilience.errors import ChaosTargetError
from dtc_tpu_torch.resilience.events import RecoveryBus
from dtc_tpu_torch.resilience.retry import retry_call
from dtc_tpu_torch.serve.engine import ServingEngine
from dtc_tpu_torch.serve.replica import EngineReplica, ReplicaState
from dtc_tpu_torch.serve.request import (
    TERMINAL_STATES,
    FleetSaturatedError,
    QueueFullError,
    ReplicaUnreachableError,
    Request,
    RequestFailedError,
    RequestState,
    ServeError,
    ServeResult,
    UnknownAdapterError,
)
from dtc_tpu_torch.utils.percentile import round_opt


@dataclasses.dataclass
class FleetRecord:
    """The router's own copy of one in-flight request's progress, the
    source of truth of a failover: pulled after every replica step, so it
    is exact at every iteration boundary (where kills land)."""

    req: Request
    replica: int
    hops: int = 0
    tokens: list = dataclasses.field(default_factory=list)
    submitted_t: float | None = None
    first_token_t: float | None = None
    n_evictions: int = 0
    n_retries: int = 0
    degraded: bool = False
    n_spec_proposed: int = 0
    n_spec_accepted: int = 0

    def resume_result(self) -> ServeResult:
        """The partial result a survivor resumes from (the engine's
        ``submit(resume=...)``)."""
        return ServeResult(
            rid=self.req.rid, state=RequestState.EVICTED,
            tokens=list(self.tokens), submitted_t=self.submitted_t,
            first_token_t=self.first_token_t, n_evictions=self.n_evictions,
            n_retries=self.n_retries, degraded=self.degraded,
            n_hops=self.hops, adapter=self.req.adapter,
            n_spec_proposed=self.n_spec_proposed,
            n_spec_accepted=self.n_spec_accepted,
        )


class FleetRouter:
    """See the module docstring. Construct once per (model, config);
    ``submit()`` requests, then drive ``step()`` (or ``run()``) as with a
    single engine: the router is the fleet's scheduler loop."""

    def __init__(
        self,
        model,
        cfg,
        *,
        obs_dir: str = "",
        router_proc: int | None = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.cfg = cfg
        self.clock = clock
        self.sleep = sleep
        self.model = model  # kept for spawn: every replica serves it
        self._obs_dir = obs_dir
        # The router's shard is one past the replicas by default; a caller
        # that spawns replicas later passes a router_proc above every
        # replica id it will mint.
        self._proc = cfg.n_replicas if router_proc is None else router_proc
        self.reg = MetricsRegistry(process_index=self._proc)
        if obs_dir:
            self.reg.add_sink(JsonlSink(shard_path(obs_dir, self._proc)))
        self.recorder = self.reg.add_sink(FlightRecorder(256))
        self.bus = RecoveryBus()
        self.chaos = (
            ChaosInjector(cfg.chaos, self.bus) if cfg.chaos.enabled else None
        )

        self.records: dict[str, FleetRecord] = {}   # in flight, fleet-wide
        self.results: dict[str, ServeResult] = {}   # fleet-terminal
        self._adapter_factors: dict[str, dict] = {}
        self._bad_it: dict[int, int] = {}   # replica -> last degraded signal
        self._hung_seen: dict[int, int] = {}
        self._rr = 0                        # round-robin cursor
        self._it = 0
        self._sigterm = False
        self._prev_sigterm_handler: Any = None

        # Append-only: a retired or dead replica keeps its slot (DEAD), so
        # replica_id == list index across spawn and retire.
        self.replicas: list[EngineReplica] = []
        for _ in range(cfg.n_replicas):
            self.spawn_replica(quiet=True)

    # ------------------------------------------------------------------
    # tenants
    # ------------------------------------------------------------------
    def register_adapter(self, name: str, factors: dict) -> None:
        """Make tenant ``name``'s factors available to the fleet. Loading
        is lazy: the first request routed for the tenant loads them on its
        replica and later ones follow the residency. Failover re-loads
        them on a survivor from here when the tenant's home dies."""
        self._adapter_factors[name] = factors

    def _can_serve_adapter(self, rep: EngineReplica, name: str) -> bool:
        return name in rep.resident_adapters() or name in self._adapter_factors

    def _ensure_adapter(self, rep: EngineReplica, req: Request) -> None:
        if req.adapter is None or req.adapter in rep.resident_adapters():
            return
        # May raise AdapterStoreFullError (typed): the caller routes on.
        rep.engine.load_adapter(
            req.adapter, self._adapter_factors[req.adapter]
        )
        self.reg.counter("router_adapter_loads").inc()
        self.reg.emit(
            "router_adapter_load", adapter=req.adapter,
            replica=rep.replica_id, iteration=self._it,
        )

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------
    def _place(
        self, req: Request, exclude: set[int]
    ) -> tuple[EngineReplica | None, str]:
        """Pick a replica for ``req`` (None and a reason when none can take
        it). Only replicas that would accept it (accepting state, queue
        room, able to serve its tenant) are candidates."""
        live = [
            r for r in self.replicas
            if r.accepting and r.replica_id not in exclude
        ]
        roomy = [r for r in live if r.queue_room > 0]
        if not roomy:
            return None, "saturated"
        if req.adapter is not None:
            cands = [r for r in roomy if self._can_serve_adapter(r, req.adapter)]
            if not cands:
                return None, "unknown_adapter"
        else:
            cands = roomy

        def cost(r: EngineReplica):
            # Healthy before degraded, headroom before about-to-shed, then
            # least loaded; the replica id breaks ties.
            return (
                r.state is ReplicaState.DEGRADED,
                r.engine.over_shed_watermark,
                r.load,
                r.replica_id,
            )

        if self.cfg.placement == "round_robin":
            self._rr += 1
            return cands[self._rr % len(cands)], "round_robin"
        if self.cfg.placement == "affinity":
            if req.adapter is not None:
                hold = [r for r in cands
                        if req.adapter in r.resident_adapters()]
                if hold:
                    return min(hold, key=cost), "adapter_affinity"
            if req.shared_prefix_len > 0:
                hit = [r for r in cands if r.has_prefix(req)]
                if hit:
                    return min(hit, key=cost), "prefix_affinity"
        return min(cands, key=cost), "least_loaded"

    def _try_submit(
        self, rep: EngineReplica, req: Request, resume: ServeResult | None
    ) -> None:
        """One replica's submit under the transient-fault retry: a
        momentarily unreachable replica gets ``retry.max_attempts`` with
        backoff before the router tries the next candidate."""
        r = self.cfg.retry
        retry_call(
            lambda: rep.submit(req, resume=resume),
            transient=(ReplicaUnreachableError,),
            max_attempts=r.max_attempts, backoff_s=r.backoff_s,
            backoff_max_s=r.backoff_max_s, jitter=r.jitter,
            max_elapsed_s=r.max_elapsed_s, on_event=self._on_retry_event,
            sleep=self.sleep, clock=self.clock,
        )

    def _route(
        self, req: Request, *, resume: ServeResult | None = None,
        exclude: set[int] | None = None,
    ) -> tuple[EngineReplica, str]:
        """Place and submit, routing around a candidate that turns out
        unreachable (past retries) or full; when none is left the last
        typed error (or fleet saturation) is raised."""
        tried: set[int] = set(exclude or ())
        last_err: Exception | None = None
        while True:
            rep, reason = self._place(req, exclude=tried)
            if rep is None:
                if last_err is not None:
                    raise last_err
                if reason == "unknown_adapter":
                    raise UnknownAdapterError(
                        f"request {req.rid}: adapter {req.adapter!r} is "
                        "resident on no live replica and no factors were "
                        "registered with the router "
                        "(FleetRouter.register_adapter)"
                    )
                raise FleetSaturatedError(
                    f"request {req.rid}: every live replica's queue is full "
                    f"({len([r for r in self.replicas if r.accepting])} "
                    "accepting)"
                )
            try:
                self._ensure_adapter(rep, req)
                self._try_submit(rep, req, resume)
                return rep, reason
            except (ReplicaUnreachableError, QueueFullError) as e:
                last_err = e
                tried.add(rep.replica_id)
            except ServeError as e:
                # AdapterStoreFullError and kin: typed and replica-local,
                # so route on.
                last_err = e
                tried.add(rep.replica_id)

    # ------------------------------------------------------------------
    # the public surface (mirrors ServingEngine)
    # ------------------------------------------------------------------
    def submit(self, req: Request) -> str:
        """Route one request into the fleet. Raises the engine's typed
        errors (and :class:`FleetSaturatedError`, a ``QueueFullError``);
        an accepted rid is guaranteed a terminal fleet result."""
        if req.rid in self.records:
            raise ValueError(
                f"request {req.rid}: rid already in flight on replica "
                f"{self.records[req.rid].replica}"
            )
        try:
            rep, reason = self._route(req)
        except Exception as e:
            self.reg.counter("router_rejected").inc()
            self.reg.emit(
                "router_reject", rid=req.rid, iteration=self._it,
                error=type(e).__name__,
            )
            raise
        res = rep.engine.results[req.rid]
        self.records[req.rid] = FleetRecord(
            req=req, replica=rep.replica_id, submitted_t=res.submitted_t,
        )
        self.reg.counter("router_routed").inc()
        self.reg.emit(
            "router_route", rid=req.rid, replica=rep.replica_id,
            reason=reason, iteration=self._it, adapter=req.adapter,
        )
        return req.rid

    def step(self) -> bool:
        """One fleet iteration: chaos at the boundary, then one scheduler
        iteration per live replica with the progress pull, heartbeat
        accounting and the health state machine. Returns True while any
        request is in flight."""
        self._it += 1
        if self.chaos is not None:
            # Victims resolve at fire time (the replica set changes under
            # spawn and retire); a stale target raises ChaosTargetError.
            stall = self.chaos.fleet_stall_replica(self._it)
            if stall > 0:
                self._chaos_target("fleet_stall_replica").stall(stall)
            part = self.chaos.fleet_partition(self._it)
            if part > 0:
                self._chaos_target("fleet_partition").partition(part)
            # The kill is asked for only with traffic in flight: killing an
            # idle fleet would spend the shot on nothing.
            if self.records and self.chaos.fleet_kill_replica(self._it):
                self.kill_replica(
                    self._chaos_target("fleet_kill_replica").replica_id,
                    reason="chaos",
                )
        for rep in self.replicas:
            if rep.state is ReplicaState.DEAD:
                continue
            try:
                rep.step()
            except ReplicaUnreachableError:
                n = rep.miss_beat()
                self.reg.counter("router_missed_heartbeats").inc()
                self.reg.emit(
                    "router_heartbeat_missed", replica=rep.replica_id,
                    missed=n, iteration=self._it,
                )
                if n >= self.cfg.heartbeat_miss_limit:
                    self.kill_replica(
                        rep.replica_id,
                        reason=f"missed {n} heartbeats (partition)",
                    )
                continue
            self._pull(rep)
            self._update_health(rep)
        self._drain_bus()
        return bool(self.records)

    def run(self, *, max_steps: int = 100_000) -> dict[str, ServeResult]:
        """Drive ``step()`` until the fleet is idle or ``max_steps`` run
        out; a pending SIGTERM (``install_sigterm``) drains instead."""
        for _ in range(max_steps):
            if self._sigterm:
                self.drain()
                break
            if not self.step():
                break
        return self.results

    # ------------------------------------------------------------------
    # progress streaming + terminal accounting
    # ------------------------------------------------------------------
    def _pull(self, rep: EngineReplica) -> None:
        eng = rep.engine
        for rid, rec in self.records.items():
            if rec.replica != rep.replica_id:
                continue
            res = eng.results.get(rid)
            if res is None or res.state in TERMINAL_STATES:
                continue
            rec.tokens = list(res.tokens)
            rec.first_token_t = res.first_token_t
            rec.n_evictions = res.n_evictions
            rec.n_retries = res.n_retries
            rec.degraded = res.degraded
            rec.n_spec_proposed = res.n_spec_proposed
            rec.n_spec_accepted = res.n_spec_accepted
        for rid, res in eng.drain_results().items():
            rec = self.records.pop(rid, None)
            if rec is None:
                continue  # not the router's (warmup, direct submits)
            self.results[rid] = res
            self._observe_terminal(res)

    def _observe_terminal(self, res: ServeResult) -> None:
        self.reg.counter(f"router_{res.state.value}").inc()
        if res.ttft_s is not None:
            self.reg.histogram("router_ttft_s").observe(res.ttft_s)
        if res.state is RequestState.DONE:
            self.reg.counter("router_tokens_out").inc(len(res.tokens))
            if res.ms_per_token is not None:
                self.reg.histogram("router_ms_per_token").observe(
                    res.ms_per_token
                )
        if res.n_hops > 0:
            self.reg.counter("router_failover_terminals").inc()

    # ------------------------------------------------------------------
    # spawn / retire (the pool's seam)
    # ------------------------------------------------------------------
    def spawn_replica(self, *, quiet: bool = False) -> EngineReplica:
        """Bring up one more replica of the router's model. It shares the
        model's weights and the kernel libraries already loaded, so a spawn
        allocates a cache and builds nothing. The new id is the next list
        slot."""
        rid = len(self.replicas)
        if rid == self._proc:
            raise ValueError(
                f"replica id {rid} would collide with the router's own "
                f"obs shard (process index {self._proc}); construct the "
                "router with an explicit router_proc above every replica "
                "id it may mint"
            )
        eng = ServingEngine(
            self.model, self.cfg.serve, clock=self.clock, sleep=self.sleep,
        )
        # The replica id is the shard index.
        eng.reg.process_index = rid
        if self._obs_dir:
            eng.reg.add_sink(JsonlSink(shard_path(self._obs_dir, rid)))
        rep = EngineReplica(
            rid, eng, watchdog_cfg=self.cfg.watchdog, clock=self.clock,
        )
        self.replicas.append(rep)
        if not quiet:  # construction-time spawns are not events
            self.reg.counter("router_spawns").inc()
            self.reg.emit(
                "router_replica_spawn", replica=rid, iteration=self._it,
            )
        return rep

    def begin_retire(self, replica_id: int, *, reason: str = "retire") -> None:
        """Retirement, stage 1: stop routing new work to the replica
        (DRAINING is not ``accepting``) while its requests keep decoding
        through ``step()``, so a death mid-drain takes the failover path."""
        rep = self.replicas[replica_id]
        if rep.state in (ReplicaState.DEAD, ReplicaState.DRAINING):
            return
        self._transition(rep, ReplicaState.DRAINING, reason)

    def finish_retire(
        self, replica_id: int, *, reason: str = "retired"
    ) -> bool:
        """Stage 2: once the draining replica is empty, shut its engine
        down and park it DEAD. False while it still holds work: the caller
        keeps stepping and asks again."""
        rep = self.replicas[replica_id]
        if rep.state is ReplicaState.DEAD:
            return True
        if rep.state is not ReplicaState.DRAINING:
            raise ValueError(
                f"replica {replica_id} is {rep.state.value}, not draining "
                "(call begin_retire first)"
            )
        if rep.load > 0:
            return False
        rep.engine.shutdown(
            mode="drain", max_steps=self.cfg.drain_max_steps,
            reason=f"{reason} (replica {replica_id})",
        )
        self._pull(rep)
        self._transition(rep, ReplicaState.DEAD, reason)
        self.reg.counter("router_retires").inc()
        return True

    def cancel_retire(
        self, replica_id: int, *, reason: str = "retire_cancelled"
    ) -> None:
        """Undo stage 1: a DRAINING replica accepts again. Anything but
        DRAINING raises: there is nothing to cancel."""
        rep = self.replicas[replica_id]
        if rep.state is not ReplicaState.DRAINING:
            raise ValueError(
                f"replica {replica_id} is {rep.state.value}, not draining "
                "(nothing to cancel)"
            )
        self._transition(rep, ReplicaState.HEALTHY, reason)

    @property
    def live_replicas(self) -> list[EngineReplica]:
        return [r for r in self.replicas if r.state is not ReplicaState.DEAD]

    def _chaos_target(self, fault: str) -> EngineReplica:
        """``fleet_target_replica`` resolved at fire time; a victim that
        does not exist or is dead raises :class:`ChaosTargetError`."""
        tid = self.cfg.chaos.fleet_target_replica
        rep = self.replicas[tid] if 0 <= tid < len(self.replicas) else None
        if rep is None or rep.state is ReplicaState.DEAD:
            raise ChaosTargetError(
                f"chaos {fault}: fleet_target_replica {tid} is not a live "
                f"replica at fire time (fleet size {len(self.replicas)}, "
                f"live {[r.replica_id for r in self.live_replicas]})"
            )
        return rep

    # ------------------------------------------------------------------
    # health + failover
    # ------------------------------------------------------------------
    def _update_health(self, rep: EngineReplica) -> None:
        rid = rep.replica_id
        hung = rep.hung_flags + rep.engine.reg.counter("serve_hung_steps").value
        bad = hung > self._hung_seen.get(rid, 0) or (
            rep.engine.slo is not None and rep.engine.slo.degrade_active
        )
        self._hung_seen[rid] = hung
        if bad:
            self._bad_it[rid] = self._it
            if rep.state is ReplicaState.HEALTHY:
                self._transition(rep, ReplicaState.DEGRADED, "health_signal")
        elif (
            rep.state is ReplicaState.DEGRADED
            and self._it - self._bad_it.get(rid, 0)
            >= self.cfg.degraded_hold_iters
        ):
            self._transition(rep, ReplicaState.HEALTHY, "recovered")

    def _transition(
        self, rep: EngineReplica, state: ReplicaState, reason: str
    ) -> None:
        prev = rep.state
        rep.mark(state, reason=reason)
        self.reg.counter("router_state_transitions").inc()
        self.reg.emit(
            "router_replica_state", replica=rep.replica_id,
            prev=prev.value, state=state.value, reason=reason,
            iteration=self._it,
        )

    def kill_replica(self, replica_id: int, *, reason: str = "killed") -> None:
        """Declare one replica dead and fail its work over to survivors:
        the chaos ``fleet_kill_replica`` entry point, and what sustained
        heartbeat loss escalates to."""
        rep = self.replicas[replica_id]
        if rep.state is ReplicaState.DEAD:
            return
        t_detect = self.clock()  # the incident's window opens here
        self.reg.counter("router_replica_deaths").inc()
        self._transition(rep, ReplicaState.DEAD, reason)
        self._failover(rep, t_detect=t_detect)

    def _failover(self, dead: EngineReplica, t_detect: float) -> None:
        orphans = [
            (rid, rec) for rid, rec in self.records.items()
            if rec.replica == dead.replica_id
        ]
        for rid, rec in orphans:
            if rec.hops + 1 > self.cfg.failover_max_hops:
                self._terminate(
                    rid, rec, RequestFailedError(
                        f"request {rid}: failover budget exhausted "
                        f"({rec.hops} hops)"
                    ),
                )
                continue
            try:
                rep, _reason = self._route(
                    rec.req, resume=rec.resume_result(),
                    exclude={dead.replica_id},
                )
            except ServeError as e:
                err = RequestFailedError(
                    f"request {rid}: no survivor could absorb the failover"
                )
                err.__cause__ = e
                self._terminate(rid, rec, err)
                continue
            prev = rec.replica
            rec.replica = rep.replica_id
            rec.hops += 1
            self.reg.counter("router_failovers").inc()
            # t_restored: the orphan is re-homed and resubmitted; the
            # survivor's re-prefill (billed from its own span) follows.
            self.reg.emit(
                "router_failover", rid=rid, src=prev,
                dst=rep.replica_id, tokens_carried=len(rec.tokens),
                hop=rec.hops, iteration=self._it,
                t_detect=round(t_detect, 6),
                t_restored=round(self.clock(), 6),
            )

    def _terminate(
        self, rid: str, rec: FleetRecord, error: Exception
    ) -> None:
        """The router's typed terminal for a request no engine owns any
        more (failover exhausted, no capacity, tenant unservable): its
        ``serve_request`` event lands in the router's own shard."""
        now = self.clock()
        res = ServeResult(
            rid=rid, state=RequestState.FAILED, tokens=list(rec.tokens),
            error=error, submitted_t=rec.submitted_t,
            first_token_t=rec.first_token_t, finished_t=now,
            n_evictions=rec.n_evictions, n_retries=rec.n_retries,
            n_hops=rec.hops, degraded=rec.degraded, adapter=rec.req.adapter,
            n_spec_proposed=rec.n_spec_proposed,
            n_spec_accepted=rec.n_spec_accepted,
        )
        del self.records[rid]
        self.results[rid] = res
        self._observe_terminal(res)
        self.reg.emit("serve_request", iteration=self._it, **res.summary())
        self.recorder_dump(f"router_terminate: {rid}")

    def recorder_dump(self, reason: str) -> None:
        """The router's flight ring stays in memory; a deployment with a
        telemetry directory overrides this hook to write it out."""

    # ------------------------------------------------------------------
    # drain / shutdown
    # ------------------------------------------------------------------
    def drain(self, *, max_steps: int | None = None) -> dict[str, ServeResult]:
        """Graceful drain of the whole fleet: every live replica takes the
        engine's shutdown (stop admitting, finish or typed eviction, bus
        drained, flight dumped), its terminals are pulled, and it retires
        DEAD ("drained"). What is still in flight after that ends typed."""
        ms = self.cfg.drain_max_steps if max_steps is None else max_steps
        for rep in self.replicas:
            if rep.state is ReplicaState.DEAD:
                continue
            self._transition(rep, ReplicaState.DRAINING, "drain")
            rep.engine.shutdown(
                mode="drain", max_steps=ms,
                reason=f"router drain (replica {rep.replica_id})",
            )
            self._pull(rep)
            self._transition(rep, ReplicaState.DEAD, "drained")
        for rid in list(self.records):
            self._terminate(
                rid, self.records[rid],
                RequestFailedError(f"request {rid}: fleet drained"),
            )
        self._drain_bus()
        self.reg.emit("router_drained", iteration=self._it)
        self.reg.flush()
        return self.results

    def install_sigterm(self) -> None:
        """SIGTERM = drain. The handler only sets a flag; ``run()`` drains
        at the next iteration boundary, so no engine state is touched from
        the signal's context."""
        def _handler(signum, frame):
            print("[dtc_tpu_torch] SIGTERM: draining serving fleet")
            self._sigterm = True

        self._prev_sigterm_handler = signal.signal(signal.SIGTERM, _handler)

    def restore_sigterm(self) -> None:
        if self._prev_sigterm_handler is not None:
            signal.signal(signal.SIGTERM, self._prev_sigterm_handler)
            self._prev_sigterm_handler = None

    # ------------------------------------------------------------------
    # warm-up and the summary
    # ------------------------------------------------------------------
    def warmup(self, prompt, *, max_new_tokens: int = 2) -> None:
        """One small request through every live replica (outside the
        router's records), then the latency histograms reset, so no
        replica pays its first calls inside a measured window."""
        for rep in self.replicas:
            if rep.state is ReplicaState.DEAD:
                continue
            rep.engine.submit(Request(
                rid=f"_warm_r{rep.replica_id}", prompt=list(prompt),
                max_new_tokens=max_new_tokens,
            ))
        for _ in range(64):
            busy = False
            for rep in self.replicas:
                if rep.state is not ReplicaState.DEAD:
                    busy |= rep.step()
            if not busy:
                break
        for rep in self.replicas:
            rep.engine.drain_results()
            for name in ("serve_ttft_s", "serve_ms_per_token",
                         "serve_queue_wait_s"):
                rep.engine.reg.histogram(name).reset()
        for name in ("router_ttft_s", "router_ms_per_token"):
            self.reg.histogram(name).reset()

    def fleet_summary(self) -> dict[str, Any]:
        """The fleet's counters and percentiles over every terminal, and
        each replica's from its engine's own histograms."""
        def q(h, p):
            return round_opt(h.percentile(p))

        per = {}
        for rep in self.replicas:
            reg = rep.engine.reg
            per[str(rep.replica_id)] = {
                "state": rep.state.value,
                "dead_reason": rep.dead_reason,
                "done": reg.counter("serve_done").value,
                "evictions": reg.counter("serve_evictions").value,
                "hung_flags": rep.hung_flags,
                "ttft_p50_s": q(reg.histogram("serve_ttft_s"), 0.50),
                "ttft_p99_s": q(reg.histogram("serve_ttft_s"), 0.99),
                "ms_per_token_p99": q(reg.histogram("serve_ms_per_token"), 0.99),
            }
        reg = self.reg
        return {
            "n_replicas": len(self.replicas),
            "replicas": per,
            "routed": reg.counter("router_routed").value,
            "rejected": reg.counter("router_rejected").value,
            "failovers": reg.counter("router_failovers").value,
            "replica_deaths": reg.counter("router_replica_deaths").value,
            "tokens_out": reg.counter("router_tokens_out").value,
            "ttft_p50_s": q(reg.histogram("router_ttft_s"), 0.50),
            "ttft_p99_s": q(reg.histogram("router_ttft_s"), 0.99),
            "ms_per_token_p50": q(reg.histogram("router_ms_per_token"), 0.50),
            "ms_per_token_p99": q(reg.histogram("router_ms_per_token"), 0.99),
        }

    # ------------------------------------------------------------------
    # plumbing
    # ------------------------------------------------------------------
    def _on_retry_event(self, etype: str, **fields: Any) -> None:
        self.reg.counter("router_retries").inc()
        self.bus.post(etype, **fields)

    def _drain_bus(self) -> None:
        for etype, fields in self.bus.drain():
            if etype == "chaos":
                self.reg.counter("chaos_injections").inc()
            fields.setdefault("iteration", self._it)
            self.reg.emit(etype, **fields)

    def close(self) -> None:
        """Release the file sinks (the replicas' shards and the router's)
        and give back the SIGTERM handler if ``install_sigterm`` took it."""
        self.restore_sigterm()
        for rep in self.replicas:
            rep.engine.reg.flush()
            rep.engine.reg.close()
        self.reg.flush()
        self.reg.close()
