"""PoolManager: one fixed set of virtual hosts arbitrated between the
serving fleet and the elastic trainer (the port's copy of the JAX
package's ``pool/manager.py``).

**Leases.** Each of the pool's ``n_hosts`` virtual hosts is leased to
exactly one tenant at a time: a serving host runs one engine replica
(:class:`~dtc_tpu_torch.serve.router.FleetRouter`), a training host adds
its virtual devices to the train mesh. The pool owns the lease table; the
tenants own their machinery.

**Transitions** are a typed state machine; every lease move walks

    requested -> draining -> reassigned -> resized -> steady

one state a pool tick, so every stage is observable and chaos can land in
any of them; a GROW interrupted by a load spike before its mesh is rebuilt
takes the one extra edge ``-> aborted`` and rolls back. For a GROW (serve
-> train): ``draining`` retires the victim replicas (no new work,
in-flight requests finish, or fail over if chaos kills the replica
mid-drain), ``reassigned`` admits the freed hosts to the trainer's monitor,
``resized`` rebuilds the larger mesh and restores the newest complete
snapshot (the global batch kept, the row stream re-seeked by rows
consumed), ``steady`` lands after the first step on the new mesh. For a
SHRINK (train -> serve): ``draining`` lands every queued snapshot commit,
``reassigned`` retires the surrendered hosts from the monitor (surrender,
not death), ``resized`` rebuilds the smaller mesh (a host chaos kills
mid-surrender is safe: the ring mirror on a survivor sources the restore)
and spawns a replica on each freed host, which builds and loads no kernel
library.

**Zero silent drops.** ``submit()`` parks the requests the fleet cannot
admit (the zero-replica phase of a full grow included) and re-submits
them as capacity returns; ``close()`` ends every parked leftover in a
typed FAILED terminal.

**The tenants' models.** The fleet serves the module it is given, whose
weights are its state; the train tenant builds its own ``GPT`` from its
seed (the JAX tenant's ``init_state``) and trains it in place, so training
never changes the served weights.

**One process.** The pool's hosts time-slice this process and its card:
a transition's seconds are an emulation's, not a cluster's. What is real:
detection and recovery read only surviving state, a GROW's restore is
bit-checked against a fresh restart from the same snapshot, and every
kernel-library build is heard and billed (the eager port compiles
nothing when a mesh changes).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from dtc_tpu_torch.obs.aggregate import shard_path
from dtc_tpu_torch.obs.registry import JsonlSink, MetricsRegistry
from dtc_tpu_torch.resilience.chaos import ChaosInjector
from dtc_tpu_torch.resilience.elastic import HostMonitor, VirtualHosts, VirtualMesh, resize_mesh
from dtc_tpu_torch.resilience.errors import ElasticAbort
from dtc_tpu_torch.resilience.events import RecoveryBus
from dtc_tpu_torch.resilience.snapshot import SnapshotStore, load_train_state, train_state
from dtc_tpu_torch.serve.replica import ReplicaState
from dtc_tpu_torch.serve.request import (
    FleetSaturatedError,
    QueueFullError,
    Request,
    RequestFailedError,
    RequestState,
    ServeResult,
)
from dtc_tpu_torch.serve.router import FleetRouter
from dtc_tpu_torch.utils.arrivals import seeded_prompts

#: Obs shard (process index) of the router's own registry under the pool,
#: above any replica id spawn and retire will mint.
POOL_ROUTER_PROC = 64
#: Obs shard of the train tenant's registry.
POOL_TRAIN_PROC = 65

#: The typed transition machine: every edge a lease move may take, one a
#: pool tick; any other edge is a bug, and ``_advance`` raises on it.
_TRANSITION_EDGES: dict[str, frozenset[str]] = {
    "requested": frozenset({"draining", "aborted"}),
    "draining": frozenset({"reassigned", "aborted"}),
    "reassigned": frozenset({"resized", "aborted"}),
    "resized": frozenset({"steady"}),
    "steady": frozenset(),
    "aborted": frozenset(),
}


@dataclasses.dataclass
class PoolTransition:
    """One lease move through the typed state machine."""

    kind: str                    # "grow" | "shrink"
    hosts: list[int]             # hosts changing tenant
    tick: int                    # pool tick the transition was requested
    state: str = "requested"
    replicas: list[int] = dataclasses.field(default_factory=list)
    t_requested: float = 0.0
    t_detect: float | None = None    # mesh-rebuild start (the stall window)
    t_restored: float | None = None  # restore done
    to_step: int | None = None       # snapshot step the resize restored
    used_mirror: bool = False
    dead_hosts: list[int] = dataclasses.field(default_factory=list)
    abort_reason: str | None = None
    stage_s: dict[str, float] = dataclasses.field(default_factory=dict)  # host seconds a stage

    @property
    def terminal(self) -> bool:
        return self.state in ("steady", "aborted")


def tenant_parts(model_cfg, train_steps: int, device=None, seed: int = 0):
    """The train tenant's own ``(model, optimizer, dropout generator)``:
    ``GPT(seed)``, AdamW at lr 1e-2 without weight decay, clipped at 1 (the
    JAX tenant's), and a generator seeded ``seed``. The entry point's
    uninterrupted reference and fresh-restart oracle build theirs here too."""
    from dtc_tpu_torch.config.schema import OptimConfig
    from dtc_tpu_torch.models.gpt import GPT
    from dtc_tpu_torch.train.optimizer import create_optimizer

    model = GPT(model_cfg, device=device, seed=seed)
    opt = create_optimizer(list(model.parameters()),
                           OptimConfig(lr=1e-2, weight_decay=0.0, grad_clip=1.0),
                           total_steps=train_steps)
    return model, opt, torch.Generator(device=model.device).manual_seed(seed)


def tenant_batches(model_cfg, cfg, seed: int = 0, start_step: int = 0):
    """The train tenant's batches from step ``start_step`` on: the flat row
    stream (``seed·1000``) re-seeked by rows, ``global_batch`` a step."""
    from dtc_tpu_torch.data.synthetic import synthetic_row_batches

    return synthetic_row_batches(cfg.global_batch, model_cfg.max_seq_len + 1,
                                 model_cfg.vocab_size, seed=seed * 1000,
                                 start_row=start_step * cfg.global_batch)


class _TrainTenant:
    """The pool's training tenant: a step-driven loop over the trainer's
    own pieces (the model, ``train_step``, the row stream, the snapshot
    store) that emits the JAX tenant's event schema (``run_start``, a
    ``step`` event a step, the startup ``compile``, ``elastic_resize`` on
    a resize) for the goodput ledger and the trace readers. A kernel
    library first built after the first step is an ``aux_compile``; the
    eager port has no step executable to recompile, so ``recompiles``
    stays 0."""

    def __init__(self, model_cfg, cfg, hosts: VirtualHosts, lease: set[int],
                 reg: MetricsRegistry, *, seed: int = 0, device=None):
        from dtc_tpu_torch.obs.stepclock import CompileWatcher
        from dtc_tpu_torch.parallel.sharding import DEFAULT_RULES

        self.model_cfg = model_cfg
        self.cfg = cfg
        self.hosts = hosts
        self.lease = set(lease)
        self.reg = reg
        self.seed = seed
        self.rules = DEFAULT_RULES

        # The monitor watches the train lease: built over the alive roster,
        # then the serving hosts retired (another tenant's, not missed beats).
        self.monitor = HostMonitor(hosts, miss_limit=cfg.heartbeat_miss_limit)
        for h in sorted(hosts.alive - self.lease):
            self.monitor.retire(h)

        # Build seconds from here on are the train tenant's (the fleet warms
        # up before the tenant is built).
        self.compiles = CompileWatcher().activate()
        self.model, self.opt, self.gen = tenant_parts(model_cfg, cfg.train_steps, device, seed)
        self.device = self.model.device
        devices = [d for h in sorted(self.lease) for d in hosts.devices_of(h)]
        self.mesh = VirtualMesh((1, len(devices) // cfg.model_axis, cfg.model_axis), devices)
        self.snapshots = SnapshotStore(
            hosts, keep=cfg.snapshot_keep,
            on_event=lambda etype, **f: self.reg.emit(etype, **f))
        if self.device.type == "cuda":
            self.snapshots.reserve(self.state()[0])
        self.cur_step = 0
        self.losses: list[float] = []
        self.recompiles = 0
        self.replayed = 0          # steps a resize sent back, summed
        self.restore_s: list[float] = []
        self.last_restored = None  # the snapshot the newest resize restored
        self._steady = False
        self.data = tenant_batches(model_cfg, cfg, seed)

        init_s, init_n = self.compiles.drain()
        self.reg.emit("run_start", step=0, batch=cfg.global_batch,
                      seq_len=model_cfg.max_seq_len, devices=len(devices),
                      hosts=sorted(self.lease), pool=True)
        if init_s > 0:
            self.reg.emit("compile", step=0, compile_time_s=round(init_s, 6), count=init_n)

    def state(self) -> tuple[dict[str, Any], dict[str, tuple]]:
        """What a snapshot holds (:func:`~dtc_tpu_torch.resilience.snapshot.train_state`)."""
        return train_state(self.model, self.opt, self.gen, self.rules)

    @property
    def finished(self) -> bool:
        return self.cur_step >= self.cfg.train_steps

    @property
    def per_device_batch(self) -> float:
        n = len(self.lease) * self.hosts.per_host
        return self.cfg.global_batch / max(n // self.cfg.model_axis, 1)

    def step_once(self) -> float:
        """One training step on the current mesh: data, step, the monitor's
        beat, the snapshot cadence, the step event. The global batch is the
        same on every mesh; this process computes it whole."""
        from dtc_tpu_torch.data.prefetch import split_to_device
        from dtc_tpu_torch.train.train_step import train_step

        self.cur_step += 1
        t0 = time.perf_counter()
        x, y = split_to_device(next(self.data), self.device)
        loss = float(train_step(self.model, self.opt, x, y, self.gen, average=False))
        dur = time.perf_counter() - t0
        comp_s, comp_n = self.compiles.drain()
        fields: dict[str, Any] = {"step": self.cur_step, "step_time_s": round(dur, 6),
                                  "loss": round(loss, 6)}
        if comp_n:
            if self._steady:
                # A library first used after the first step: attributed,
                # never a recompile (the eager port has no step executable).
                self.reg.emit("aux_compile", step=self.cur_step, what="first_use",
                              compile_s=round(comp_s, 6), count=comp_n)
            else:
                self.reg.emit("compile", step=0, compile_time_s=round(comp_s, 6), count=comp_n)
        self._steady = True
        self.reg.emit("step", **fields)
        self.losses.append(loss)
        self.monitor.tick(self.cur_step)
        for ev in self.monitor.poll(self.cur_step):
            self.reg.emit(ev.pop("kind"), **ev)
        if self.cur_step % self.cfg.snapshot_every == 0:
            t_snap0 = self.reg._clock()
            state, specs = self.state()
            self.snapshots.begin(self.cur_step, state, self.mesh, specs)
            snap_s, snap_n = self.compiles.drain()
            if snap_n:
                self.reg.emit("aux_compile", step=self.cur_step, what="snapshot_dispatch",
                              compile_s=round(snap_s, 6), count=snap_n)
            t_snap1 = self.reg._clock()
            # The snapshot's synchronous half (the device clones and the
            # copy's dispatch) is snapshot time, not a gap between steps.
            disp = t_snap1 - t_snap0 - snap_s
            if disp > 0.002:
                self.reg.emit("span", name="snapshot_dispatch", cat="pool", ph="X", tid="pool",
                              t0=round(t_snap0, 6), dur_s=round(disp, 6), step=self.cur_step)
        return loss

    def resize(self, new_lease: set[int], *, reason: str) -> dict[str, Any]:
        """Rebuild the mesh over ``new_lease`` (GROW or SHRINK) and restore
        the newest complete snapshot onto it: shrink-and-continue, both
        ways. Restoring copies the snapshot into the tenant's own model,
        optimizer and generator; nothing is rebuilt or recompiled, and a
        library first built here is an ``aux_compile``."""
        t_detect = self.reg._clock()
        self.snapshots.drain()
        snap = self.snapshots.latest()
        if snap is None:
            raise ElasticAbort("pool resize: no complete snapshot to restore from")
        new_mesh = resize_mesh(self.mesh, self.hosts, target_hosts=new_lease)
        t0 = time.perf_counter()
        restored, used_mirror = self.snapshots.restore(snap, self.hosts.alive)
        load_train_state(self.model, self.opt, self.gen, restored)
        self.last_restored = snap
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.restore_s.append(time.perf_counter() - t0)
        self.mesh = new_mesh
        # The flat row stream re-seeks by rows consumed: step x global batch.
        replayed = self.cur_step - snap.step
        self.replayed += replayed
        self.cur_step = snap.step
        del self.losses[snap.step:]
        self.data = tenant_batches(self.model_cfg, self.cfg, self.seed, snap.step)
        self.lease = set(new_lease)
        comp_s, comp_n = self.compiles.drain()
        t_restored = self.reg._clock()
        n_dev = len(new_lease) * self.hosts.per_host
        self.reg.emit("elastic_resize", step=snap.step, to_step=snap.step, tier="memory",
                      used_mirror=used_mirror, reason=reason, devices=n_dev,
                      hosts=sorted(new_lease), per_device_batch=self.per_device_batch,
                      replayed_steps=replayed, t_detect=round(t_detect, 6),
                      t_restored=round(t_restored, 6))
        if comp_n:
            self.reg.emit("aux_compile", step=snap.step, what="elastic_resize",
                          compile_s=round(comp_s, 6), count=comp_n)
        return {"to_step": snap.step, "used_mirror": used_mirror,
                "t_detect": t_detect, "t_restored": t_restored}

    def close(self) -> None:
        self.snapshots.close()
        self.compiles.deactivate()


class PoolManager:
    """See the module docstring. Construct once per (served model, pool
    config); drive ``tick()`` (or ``run()``): one tick is one unit of
    time-sliced pool work (chaos, parked retries, one fleet iteration, one
    transition edge, one training step, then arbitration). ``model`` is the
    served module (the train tenant builds its own on its device)."""

    def __init__(self, model, model_cfg, cfg, *, obs_dir: str = "", seed: int = 0,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.hosts = VirtualHosts(cfg.n_hosts)
        if self.hosts.per_host * cfg.min_train_hosts < cfg.model_axis:
            raise ElasticAbort(
                f"model_axis={cfg.model_axis} cannot fit the minimum train lease "
                f"({cfg.min_train_hosts} hosts x {self.hosts.per_host} devices)")

        all_hosts = list(range(cfg.n_hosts))
        # The trainer leases the HIGH host ids, serving the low ones; LIFO
        # surrender keeps the baseline lease across a grow/shrink cycle.
        self.train_lease: set[int] = set(all_hosts[-cfg.train_hosts:])
        self._acquired: list[int] = []   # grow-acquired hosts, LIFO
        serve0 = [h for h in all_hosts if h not in self.train_lease]

        rcfg = dataclasses.replace(cfg.router, n_replicas=len(serve0))
        self.router = FleetRouter(model, rcfg, obs_dir=obs_dir, router_proc=POOL_ROUTER_PROC,
                                  clock=clock, sleep=sleep)
        self.serve_lease: dict[int, int] = {
            h: rep.replica_id for h, rep in zip(serve0, self.router.replicas)}
        # The fleet's first calls (kernel libraries loaded) before the train
        # tenant's build watcher starts: serving warm-up is not train time.
        self.router.warmup([1, 2, 3])

        self.reg = MetricsRegistry(process_index=POOL_TRAIN_PROC)
        if obs_dir:
            self.reg.add_sink(JsonlSink(shard_path(obs_dir, POOL_TRAIN_PROC)))
        self.trainer = _TrainTenant(model_cfg, cfg, self.hosts, self.train_lease, self.reg,
                                    seed=seed, device=model.device)

        self.bus = RecoveryBus()
        self.chaos = ChaosInjector(cfg.chaos, self.bus) if cfg.chaos.enabled else None
        self.transition: PoolTransition | None = None
        self.transitions: list[PoolTransition] = []
        self.requests: dict[str, Request] = {}  # every request submitted, by rid
        self._parked: list[Request] = []
        self._parked_results: dict[str, ServeResult] = {}
        self._grow_abort = False
        self._idle_ticks = 0
        self._spike_seq = 0
        self._tick = 0

    # ------------------------------------------------------------------
    # the request plane (zero silent drops)
    # ------------------------------------------------------------------
    def submit(self, req: Request) -> str:
        """Route into the fleet; a request it cannot admit now (saturated,
        or no replica mid-grow) PARKS in the pool, which retries it."""
        self.requests[req.rid] = req
        try:
            return self.router.submit(req)
        except (FleetSaturatedError, QueueFullError) as e:
            self._parked.append(req)
            self.reg.emit("pool_request_parked", rid=req.rid, tick=self._tick,
                          error=type(e).__name__, parked=len(self._parked))
            return req.rid

    def _unpark(self) -> None:
        while self._parked:
            req = self._parked[0]
            try:
                self.router.submit(req)
            except (FleetSaturatedError, QueueFullError):
                return
            self._parked.pop(0)
            self.reg.emit("pool_request_unparked", rid=req.rid, tick=self._tick,
                          parked=len(self._parked))

    def results(self) -> dict[str, ServeResult]:
        """The fleet's terminals and the pool backstop's."""
        out = dict(self.router.results)
        out.update(self._parked_results)
        return out

    def _emit_timeshare(self, t0: float, t1: float) -> None:
        if t1 - t0 > 0.002:
            self.reg.emit("span", name="pool.timeshare", cat="pool", ph="X", tid="pool",
                          t0=round(t0, 6), dur_s=round(t1 - t0, 6))

    # ------------------------------------------------------------------
    # the tick loop
    # ------------------------------------------------------------------
    def tick(self) -> bool:
        """One pool iteration. True while anything is in flight: training
        unfinished, requests live anywhere, or a transition mid-walk."""
        self._tick += 1
        t_serve0 = self.reg._clock()
        self._consult_chaos()
        self._unpark()
        if self.router.live_replicas:
            self.router.step()
        t_serve1 = self.reg._clock()
        # The train tenant's slice yielded to the serving fleet this tick
        # (one process time-slices every host): typed spans on the train
        # shard's timeline, so the goodput ledger bills them
        # (shed_or_idle, cause timeshare) instead of leaving holes.
        self._emit_timeshare(t_serve0, t_serve1)
        tr = self.transition
        pre_resized = tr is not None and tr.state == "resized"
        self._advance_transition()
        t_adv = self.reg._clock()
        tr = self.transition
        if (tr is not None and tr.state == "resized" and not pre_resized
                and tr.t_detect is not None and tr.t_restored is not None):
            # The resize's [t_detect, t_restored] window is the incident's
            # (elastic_resize, cause restore): timeshare only around it.
            self._emit_timeshare(t_serve1, tr.t_detect)
            self._emit_timeshare(tr.t_restored, t_adv)
        else:
            self._emit_timeshare(t_serve1, t_adv)
        tr = self.transition
        can_step = not self.trainer.finished and (
            tr is None or tr.state in ("requested", "draining", "resized"))
        if can_step:
            self.trainer.step_once()
            if tr is not None and tr.state == "resized":
                # The first step on the new mesh ran: the transition is steady.
                self._advance(tr, "steady")
                self.transition = None
        elif tr is not None and tr.state == "resized" and self.trainer.finished:
            # The resize landed on the budget's end: no step will follow.
            self._advance(tr, "steady")
            self.transition = None
        if self.transition is None:
            self._arbitrate()
        self._drain_bus()
        return (not self.trainer.finished or bool(self.router.records)
                or bool(self._parked) or self.transition is not None)

    def run(self, *, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if not self.tick():
                return

    # ------------------------------------------------------------------
    # chaos (asked only while the named transition is in flight, so the
    # shot lands on a production path)
    # ------------------------------------------------------------------
    def _consult_chaos(self) -> None:
        tr = self.transition
        if self.chaos is None or tr is None or tr.terminal:
            return
        if tr.kind == "grow":
            burst = self.chaos.pool_spike_mid_grow(self._tick)
            if burst:
                self._inject_spike(burst)
                if tr.state in ("requested", "draining", "reassigned"):
                    # The mesh is not rebuilt yet: abort. Past that point
                    # the grow completes and the pressure shrinks it back.
                    self._grow_abort = True
            if tr.state == "draining" and self.chaos.pool_kill_draining_replica(self._tick):
                for rid in tr.replicas:
                    rep = self.router.replicas[rid]
                    if rep.state is ReplicaState.DRAINING and rep.load > 0:
                        self.router.kill_replica(rid, reason="chaos pool_kill_draining_replica")
                        break
        if tr.kind == "shrink" and tr.state in ("requested", "draining"):
            victim = self.chaos.pool_kill_mid_shrink(self._tick)
            if victim is not None:
                self._kill_host(victim, why="pool_kill_mid_shrink")

    def _inject_spike(self, burst: int) -> None:
        rng = np.random.RandomState(7_000 + self._tick)
        prompts = seeded_prompts(rng, burst, 8, self.model_cfg.vocab_size)
        mnt = min(8, self.cfg.router.serve.max_new_tokens)
        self.reg.emit("pool_spike", requests=burst, tick=self._tick)
        for p in prompts:
            self._spike_seq += 1
            self.submit(Request(rid=f"spike{self._spike_seq}", prompt=p, max_new_tokens=mnt))

    def _kill_host(self, victim: int, *, why: str) -> None:
        """A host dies: it leaves the alive set and its snapshot memory
        (primary and the mirrors it held) goes; a serve-leased victim takes
        its replica down (the router fails its requests over) and is never
        leased again."""
        self.hosts.kill(victim)
        self.trainer.snapshots.drop_primary(victim)
        rid = self.serve_lease.pop(victim, None)
        if rid is not None:
            self.router.kill_replica(rid, reason=f"chaos {why}")
        tr = self.transition
        if tr is not None and not tr.terminal:
            # A death while a transition is in flight is on its bill.
            tr.dead_hosts.append(victim)
        self.reg.emit("pool_host_killed", host=victim, why=why, tick=self._tick, replica=rid)

    # ------------------------------------------------------------------
    # the typed state machine
    # ------------------------------------------------------------------
    def _advance(self, tr: PoolTransition, state: str, **fields: Any) -> None:
        if state not in _TRANSITION_EDGES[tr.state]:
            raise RuntimeError(
                f"illegal pool transition edge {tr.state} -> {state} ({tr.kind} {tr.hosts})")
        prev, tr.state = tr.state, state
        self.reg.emit("pool_transition", kind=tr.kind, hosts=list(tr.hosts), prev=prev,
                      state=state, tick=self._tick, requested_tick=tr.tick, **fields)

    def _request(self, kind: str, hosts: list[int], replicas: list[int]) -> None:
        tr = PoolTransition(kind=kind, hosts=list(hosts), tick=self._tick,
                            replicas=list(replicas), t_requested=self.reg._clock())
        self.transition = tr
        self.transitions.append(tr)
        self._grow_abort = False
        self.reg.emit("pool_transition", kind=kind, hosts=list(hosts), prev=None,
                      state="requested", tick=self._tick, requested_tick=self._tick,
                      replicas=list(replicas))

    def _advance_transition(self) -> None:
        tr = self.transition
        if tr is None or tr.terminal:
            return
        stage, t0 = tr.state, time.perf_counter()
        if tr.kind == "grow":
            self._advance_grow(tr)
        else:
            self._advance_shrink(tr)
        tr.stage_s[stage] = tr.stage_s.get(stage, 0.0) + time.perf_counter() - t0
        if tr.terminal and tr.state == "aborted":
            self.transition = None

    # -- grow: serve -> train ------------------------------------------
    def _advance_grow(self, tr: PoolTransition) -> None:
        if self._grow_abort and tr.state in ("requested", "draining", "reassigned"):
            self._abort_grow(tr, reason="load_spike")
            return
        if tr.state == "requested":
            for rid in tr.replicas:
                self.router.begin_retire(rid, reason="pool_grow")
            self._advance(tr, "draining")
        elif tr.state == "draining":
            done = True
            for rid in tr.replicas:
                rep = self.router.replicas[rid]
                if rep.state is ReplicaState.DEAD:
                    continue  # chaos-killed mid-drain: failover ran, host free
                if not self.router.finish_retire(rid, reason="pool_grow"):
                    done = False
            if done:
                self._advance(tr, "reassigned")
        elif tr.state == "reassigned":
            # The hosts leave the serve lease and join the monitor's roster;
            # admit() refuses a host the monitor believes dead.
            try:
                for h in tr.hosts:
                    if h not in self.hosts.alive:
                        raise ElasticAbort(f"grow target host {h} is dead")
                    self.trainer.monitor.admit(h, step=self.trainer.cur_step)
            except ElasticAbort as e:
                self._abort_grow(tr, reason=str(e))
                return
            for h in tr.hosts:
                self.serve_lease.pop(h, None)
            self.train_lease |= set(tr.hosts)
            self._acquired.extend(tr.hosts)
            info = self.trainer.resize(set(self.train_lease), reason="pool_grow")
            tr.to_step = info["to_step"]
            tr.used_mirror = info["used_mirror"]
            tr.t_detect, tr.t_restored = info["t_detect"], info["t_restored"]
            self._advance(tr, "resized", to_step=tr.to_step, used_mirror=tr.used_mirror,
                          devices=len(self.train_lease) * self.hosts.per_host)

    def _abort_grow(self, tr: PoolTransition, *, reason: str) -> None:
        """Roll a grow back before its resize: draining replicas accept
        again, retired ones respawn, monitor admissions are retired again.
        The trainer's mesh was never touched."""
        for h, rid in zip(tr.hosts, tr.replicas):
            self.trainer.monitor.retire(h)
            rep = self.router.replicas[rid]
            if rep.state is ReplicaState.DRAINING:
                self.router.cancel_retire(rid, reason="pool_grow_abort")
                self.serve_lease[h] = rid
            elif rep.state is ReplicaState.DEAD and h in self.hosts.alive:
                new = self.router.spawn_replica()
                self.serve_lease[h] = new.replica_id
            self.train_lease.discard(h)
            if h in self._acquired:
                self._acquired.remove(h)
        tr.abort_reason = reason
        self._grow_abort = False
        self.reg.emit("pool_grow_abort", hosts=list(tr.hosts), reason=reason, tick=self._tick)
        self._advance(tr, "aborted", reason=reason)

    # -- shrink: train -> serve ----------------------------------------
    def _advance_shrink(self, tr: PoolTransition) -> None:
        if tr.state == "requested":
            # Every queued commit lands now, so a complete ring-mirrored
            # snapshot covers the current step before the surrender.
            self.trainer.snapshots.drain()
            self._advance(tr, "draining")
        elif tr.state == "draining":
            for h in tr.hosts:
                # Surrender, not death: a later admit() of the host is legal.
                self.trainer.monitor.retire(h)
                self.train_lease.discard(h)
                if h in self._acquired:
                    self._acquired.remove(h)
            self._advance(tr, "reassigned")
        elif tr.state == "reassigned":
            info = self.trainer.resize(set(self.train_lease), reason="pool_shrink")
            tr.to_step = info["to_step"]
            tr.used_mirror = info["used_mirror"]
            tr.t_detect, tr.t_restored = info["t_detect"], info["t_restored"]
            spawned = []
            for h in tr.hosts:
                if h not in self.hosts.alive:
                    continue  # died mid-surrender: nothing to serve on
                rep = self.router.spawn_replica()
                self.serve_lease[h] = rep.replica_id
                spawned.append(rep.replica_id)
            tr.replicas = spawned
            self._advance(tr, "resized", to_step=tr.to_step, used_mirror=tr.used_mirror,
                          spawned=spawned, dead_hosts=list(tr.dead_hosts),
                          devices=len(self.train_lease) * self.hosts.per_host)

    # ------------------------------------------------------------------
    # arbitration
    # ------------------------------------------------------------------
    def _arbitrate(self) -> None:
        accepting = [r for r in self.router.replicas if r.accepting]
        backlog = len(self._parked) + sum(r.load for r in accepting)
        spike = ((not accepting and bool(self._parked))
                 or (bool(accepting)
                     and backlog / len(accepting) >= self.cfg.spike_queue_depth))
        if spike:
            self._idle_ticks = 0
            victims = self._shrink_victims()
            if victims:
                self._request("shrink", victims, [])
            return
        if backlog == 0 and not self.router.records:
            self._idle_ticks += 1
        else:
            self._idle_ticks = 0
        if self._idle_ticks >= self.cfg.grow_after_idle_ticks and not self.trainer.finished:
            hosts, reps = self._grow_candidates()
            if hosts:
                self._idle_ticks = 0
                self._request("grow", hosts, reps)

    def _shrink_victims(self) -> list[int]:
        """LIFO: grow-acquired hosts surrender first; under sustained
        pressure the baseline shrinks one host at a time down to
        min_train_hosts."""
        if not self.trainer.finished and len(self.train_lease) <= self.cfg.min_train_hosts:
            return []
        if self._acquired:
            return list(reversed(self._acquired))
        if len(self.train_lease) > self.cfg.min_train_hosts:
            return [max(self.train_lease)]
        return []

    def _grow_candidates(self) -> tuple[list[int], list[int]]:
        """Serve hosts with an idle replica above the serve floor: the
        LARGEST prefix that still gives a valid mesh and batch split (a
        dead host may leave the whole idle set indivisible)."""
        idle = [(h, rid) for h, rid in sorted(self.serve_lease.items())
                if h in self.hosts.alive
                and self.router.replicas[rid].accepting
                and self.router.replicas[rid].load == 0]
        n_take = len(self.serve_lease) - self.cfg.min_serve_hosts
        for k in range(min(len(idle), max(n_take, 0)), 0, -1):
            take = idle[:k]
            new_lease = self.train_lease | {h for h, _ in take}
            n_dev = len(new_lease) * self.hosts.per_host
            if (n_dev % self.cfg.model_axis == 0
                    and self.cfg.global_batch % (n_dev // self.cfg.model_axis) == 0):
                return [h for h, _ in take], [rid for _, rid in take]
        return [], []

    # ------------------------------------------------------------------
    # plumbing
    # ------------------------------------------------------------------
    def _drain_bus(self) -> None:
        for etype, fields in self.bus.drain():
            fields.setdefault("tick", self._tick)
            self.reg.emit(etype, **fields)

    def summary(self) -> dict[str, Any]:
        return {
            "ticks": self._tick,
            "train_steps": self.trainer.cur_step,
            "train_hosts": sorted(self.train_lease),
            "serve_hosts": sorted(self.serve_lease),
            "recompiles": self.trainer.recompiles,
            "transitions": [
                {"kind": t.kind, "hosts": t.hosts, "state": t.state, "to_step": t.to_step,
                 "used_mirror": t.used_mirror, "dead_hosts": t.dead_hosts,
                 "abort_reason": t.abort_reason}
                for t in self.transitions
            ],
            "parked_unserved": len(self._parked),
            "fleet": self.router.fleet_summary(),
        }

    def close(self, *, drain: bool = True) -> dict[str, ServeResult]:
        """Drain the fleet, end every still-parked request in a typed
        FAILED terminal (the zero-silent-drop backstop), release the
        tenants, and return every terminal."""
        if drain and self.router.live_replicas:
            self.router.drain()
        for req in self._parked:
            res = ServeResult(
                rid=req.rid, state=RequestState.FAILED, tokens=[],
                error=RequestFailedError(
                    f"request {req.rid}: pool closed before any replica could admit it"),
                finished_t=self.router.clock())
            self._parked_results[req.rid] = res
            self.router.reg.emit("serve_request", iteration=self._tick, **res.summary())
        self._parked.clear()
        self.reg.emit("pool_closed", tick=self._tick)
        self.reg.flush()
        self.reg.close()
        self.router.close()
        self.trainer.close()
        return self.results()
