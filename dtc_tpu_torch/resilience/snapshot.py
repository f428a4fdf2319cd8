"""Async in-memory snapshots with peer-redundant shard stores (the port's
copy of the JAX package's ``resilience/snapshot.py``).

The hot tier of elastic training: on a step cadence the training state
(parameters, optimizer moments and count, ``bf16_mixed``'s masters, the
dropout generator's state) is copied off the card WITHOUT blocking the
training loop, cut into the shards the virtual hosts own, hashed, and
filed per host (:mod:`dtc_tpu_torch.resilience.elastic`). A poisoned
update or a lost host then costs the steps since the newest complete
snapshot, not a rollback to the slower disk tier.

No host sync on the training loop: :meth:`SnapshotStore.begin` clones
every tensor on the device (the optimizer updates the live tensors in
place, so the clone is what the transfer reads), records a CUDA event on
the training stream, and on a copy stream of its own copies the clones
into pinned host buffers (``non_blocking``) behind that event. The commit
thread, not the loop, waits for the copy's event, cuts the shards, hashes
them and files them. ``begin`` is double-buffered: one commit landing and
one queued behind it; a further cadence tick is SKIPPED (counted, and
reported in the ``snapshot`` event), so a slow commit never queues
unbounded copies. The pinned buffers are two sets, reused.

The shard layout comes from the virtual mesh and each tensor's spec (the
mesh axis each dim is cut over, ``parallel/sharding.param_spec`` for a
parameter and its moments; ``()`` for whole tensors), as the JAX package
reads it from each leaf's ``NamedSharding``:

- **replicated leaves** — every host's store holds a full copy; any one
  survivor reconstructs them;
- **sharded leaves** (FSDP) — each host holds its own shards, and its
  whole shard set is MIRRORED at its ring neighbour ``(h+1) % n_hosts``.
  Losing host ``h`` is recoverable while its neighbour survives;
  :meth:`RedundancyPlan.recovery_set` names the surviving reads that
  reconstruct the full state, or raises
  :class:`~dtc_tpu_torch.resilience.errors.SnapshotIncompleteError` (the
  caller falls back to the cold tier).

Every host store holds its own copy of its shards (host memory), and
every read at restore is re-hashed against the commit-time sha256.
"""

from __future__ import annotations

import functools
import hashlib
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from dtc_tpu_torch.resilience.errors import SnapshotIncompleteError

#: Per-dimension ``(start, stop)`` tuple naming one shard of a leaf.
ShardKey = tuple


def _sha(arr: np.ndarray) -> str:
    h = hashlib.sha256(f"{arr.dtype.str}{arr.shape}".encode())
    h.update(np.ascontiguousarray(arr))
    return h.hexdigest()


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's bytes as a numpy array (bfloat16, which numpy lacks,
    as int16; the leaf's dtype says what they are)."""
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _to_torch(arr: np.ndarray, dtype) -> torch.Tensor:
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t


@dataclass
class LeafMeta:
    """One state leaf: its shape and dtype and the mesh axis each dim is
    cut over (None: whole)."""

    path: str
    shape: tuple
    dtype: Any
    spec: tuple


@dataclass
class InMemorySnapshot:
    """One committed hot-tier snapshot.

    ``primary[host][path][key]`` holds host ``host``'s own shards (numpy
    arrays, each host its own copy; bfloat16 as int16); ``mirror[host]`` the full shard set of its ring-previous
    host. ``shard_sha`` is the commit-time hash of every distinct
    ``(path, key)``; a restore re-hashes the copy it reads. ``complete``
    is False when some leaf's filed shards do not tile it (a commit taken
    after a host died): such a snapshot is never a recovery target."""

    step: int
    n_hosts: int
    leaves: list[LeafMeta] = field(default_factory=list)
    primary: dict[int, dict[str, dict[ShardKey, np.ndarray]]] = field(default_factory=dict)
    mirror: dict[int, dict[str, dict[ShardKey, np.ndarray]]] = field(default_factory=dict)
    shard_sha: dict[tuple[str, ShardKey], str] = field(default_factory=dict)
    sha256: str = ""
    complete: bool = True

    def nbytes(self) -> int:
        """Bytes of the primary copies, every host's counted."""
        return sum(a.nbytes for store in self.primary.values()
                   for shards in store.values() for a in shards.values())


@dataclass
class RedundancyPlan:
    """Which hosts can reconstruct which leaves of a snapshot: ``kind[path]``
    is ``"replicated"`` (every host holds a full copy) or ``"sharded"``
    (disjoint shards, protected by the ring mirror)."""

    n_hosts: int
    kind: dict[str, str]

    @classmethod
    def from_snapshot(cls, snap: InMemorySnapshot) -> "RedundancyPlan":
        kind: dict[str, str] = {}
        for leaf in snap.leaves:
            full = tuple((0, d) for d in leaf.shape)
            replicated = all(
                full in snap.primary.get(h, {}).get(leaf.path, {})
                for h in range(snap.n_hosts) if snap.primary.get(h)
            ) and any(snap.primary.get(h) for h in range(snap.n_hosts))
            kind[leaf.path] = "replicated" if replicated else "sharded"
        return cls(n_hosts=snap.n_hosts, kind=kind)

    def recovery_set(self, snap: InMemorySnapshot,
                     alive: set[int]) -> dict[str, list[tuple[int, str, ShardKey]]]:
        """Per leaf, the ``(host, tier, key)`` reads (tier ``"primary"`` or
        ``"mirror"``) that reconstruct its full extent from ``alive``
        hosts. Raises :class:`SnapshotIncompleteError` when a shard
        survives nowhere (primary and mirror both gone)."""
        out: dict[str, list[tuple[int, str, ShardKey]]] = {}
        needed: dict[str, set] = {leaf.path: set() for leaf in snap.leaves}
        for path, key in snap.shard_sha:
            needed[path].add(key)
        for leaf in snap.leaves:
            picks: list[tuple[int, str, ShardKey]] = []
            if self.kind.get(leaf.path) == "replicated":
                full = tuple((0, d) for d in leaf.shape)
                src = self._find(snap, leaf.path, full, alive)
                if src is None:
                    raise SnapshotIncompleteError(
                        f"snapshot step {snap.step}: replicated leaf "
                        f"{leaf.path} survives on no alive host {sorted(alive)}")
                picks.append((src[0], src[1], full))
            else:
                for key in sorted(needed[leaf.path]):
                    src = self._find(snap, leaf.path, key, alive)
                    if src is None:
                        raise SnapshotIncompleteError(
                            f"snapshot step {snap.step}: shard {key} of "
                            f"{leaf.path} survives on no alive host "
                            f"{sorted(alive)} (primary owner and ring "
                            "mirror both lost)")
                    picks.append((src[0], src[1], key))
            out[leaf.path] = picks
        return out

    @staticmethod
    def _find(snap: InMemorySnapshot, path: str, key: ShardKey,
              alive: set[int]) -> tuple[int, str] | None:
        for h in sorted(alive):
            if key in snap.primary.get(h, {}).get(path, {}):
                return (h, "primary")
        for h in sorted(alive):
            if key in snap.mirror.get(h, {}).get(path, {}):
                return (h, "mirror")
        return None


@functools.lru_cache(maxsize=4096)
def device_keys(shape: tuple, spec: tuple, mesh) -> dict[int, ShardKey]:
    """Each virtual device's shard of a leaf of ``shape`` cut by ``spec``
    (per dim: None, a mesh axis name or a tuple of names) over ``mesh``
    (:class:`~dtc_tpu_torch.resilience.elastic.VirtualMesh`). Cached: do
    not change the dict returned."""
    sizes = mesh.shape
    out = {}
    for dev, at in mesh.coords().items():
        key = []
        for dim, axes in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
            names = () if axes is None else (axes,) if isinstance(axes, str) else tuple(axes)
            n, k = 1, 0
            for a in names:
                n, k = n * sizes[a], k * sizes[a] + at[a]
            chunk = -(-dim // n)
            key.append((min(k * chunk, dim), min((k + 1) * chunk, dim)))
        out[dev] = tuple(key)
    return out


class _Transfer:
    """One snapshot's tensors on their way to host memory: ``wait()`` (on
    the commit thread) returns them as CPU tensors once the copy landed;
    ``release()`` hands the pinned buffers back."""

    def __init__(self, host: list[torch.Tensor], done=None, keep=(), release=None):
        self.host, self.done, self._keep, self._release = host, done, keep, release

    def wait(self) -> list[torch.Tensor]:
        if self.done is not None:
            self.done.synchronize()
        self._keep = ()  # the device clones: the copy has read them
        return self.host

    def release(self) -> None:
        if self._release is not None:
            self._release()
            self._release = None


class SnapshotStore:
    """Double-buffered async snapshotter over a set of virtual hosts.

    ``hosts`` is a :class:`~dtc_tpu_torch.resilience.elastic.VirtualHosts`.
    ``on_event`` (a recovery-bus post, or a registry's emit) receives one
    ``snapshot`` record per commit, from the commit thread."""

    def __init__(self, hosts: Any, *, keep: int = 4,
                 on_event: Callable[..., None] | None = None):
        self.hosts = hosts
        self.on_event = on_event
        self._committed: deque[InMemorySnapshot] = deque(maxlen=max(keep, 1))
        self._queue: queue.Queue = queue.Queue()
        self._pending = 0
        self._lock = threading.Lock()
        self.skipped = 0          # cadence ticks dropped (two commits in flight)
        self.commit_s: list[float] = []  # each commit's seconds on the commit thread
        self._slots: list[tuple[tuple, list[torch.Tensor]]] = []  # free pinned sets
        self._stream = None       # the copy stream
        self._closed = False
        self._thread = threading.Thread(target=self._worker, name="dtc-snapshot-commit",
                                        daemon=True)
        self._thread.start()

    # ---- training-loop side (no host sync) -------------------------------
    def reserve(self, state: dict[str, Any]) -> None:
        """Allocate both pinned buffer sets for ``state``'s card tensors now,
        outside the timed loop (a first ``begin`` would pay it)."""
        sig = self._signature(list(state.values()))
        if sig:
            with self._lock:
                have = sum(1 for s, _ in self._slots if s == sig)
            for _ in range(2 - have):
                self._give_slot(sig, [torch.empty(shape, dtype=dtype, pin_memory=True)
                                      for shape, dtype in sig])

    @staticmethod
    def _signature(leaves: list) -> tuple:
        return tuple((tuple(t.shape), t.dtype) for t in leaves
                     if isinstance(t, torch.Tensor) and t.is_cuda)

    def _give_slot(self, sig: tuple, bufs: list[torch.Tensor]) -> None:
        with self._lock:
            self._slots.append((sig, bufs))

    def _take_slot(self, sig: tuple) -> list[torch.Tensor]:
        with self._lock:
            for i, (s, bufs) in enumerate(self._slots):
                if s == sig:
                    del self._slots[i]
                    return bufs
        return [torch.empty(shape, dtype=dtype, pin_memory=True) for shape, dtype in sig]

    def begin(self, step: int, state: dict[str, Any], mesh,
              specs: dict[str, tuple] | None = None) -> bool:
        """Dispatch an async snapshot of ``state`` (path -> tensor or int)
        tagged ``step``, its shards laid out over ``mesh`` by ``specs``
        (path -> per-dim mesh axes; missing: whole). Returns False (and
        counts a skip) while two commits are in flight."""
        with self._lock:
            if self._pending >= 2:
                self.skipped += 1
                return False
            self._pending += 1
        try:
            paths = list(state)
            job = self._dispatch([state[p] for p in paths])
        except BaseException:
            with self._lock:
                self._pending -= 1
            raise
        leaf_specs = [tuple((specs or {}).get(p, ())) for p in paths]
        # The alive set frozen now, on the loop's thread: a dead host stores
        # nothing, judged by the roster as of the snapshot's step.
        alive = set(self.hosts.alive)
        self._queue.put((step, paths, leaf_specs, mesh, job, alive))
        return True

    def _dispatch(self, leaves: list) -> _Transfer:
        tensors = [v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(v)
                   for v in leaves]
        clones = [t.clone() for t in tensors]
        on_card = [i for i, t in enumerate(clones) if t.is_cuda]
        if not on_card:
            return _Transfer(clones)
        dev = clones[on_card[0]].device
        sig = self._signature(clones)
        bufs = self._take_slot(sig)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(dev))
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(ready)
            for i, buf in zip(on_card, bufs):
                buf.copy_(clones[i], non_blocking=True)
                clones[i].record_stream(self._stream)
            done = torch.cuda.Event()
            done.record(self._stream)
        host = list(clones)
        for i, buf in zip(on_card, bufs):
            host[i] = buf
        return _Transfer(host, done, keep=[clones[i] for i in on_card],
                         release=lambda: self._give_slot(sig, bufs))

    # ---- commit thread ---------------------------------------------------
    def _worker(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                self._queue.task_done()
                return
            try:
                self._commit(*job)
            except Exception as e:  # a failed commit must not kill training
                if self.on_event is not None:
                    self.on_event("recovery", action="snapshot_commit_failed", step=job[0],
                                  reason=f"{type(e).__name__}: {e}")
            finally:
                job[4].release()
                with self._lock:
                    self._pending -= 1
                self._queue.task_done()

    def _commit(self, step, paths, specs, mesh, job, alive) -> None:
        tensors = job.wait()
        t0 = time.perf_counter()
        n = self.hosts.n_hosts
        snap = InMemorySnapshot(step=step, n_hosts=n, primary={h: {} for h in range(n)})
        for path, spec, t in zip(paths, specs, tensors):
            shape = tuple(t.shape)
            snap.leaves.append(LeafMeta(path=path, shape=shape, dtype=t.dtype, spec=spec))
            arr = _to_numpy(t)
            for dev, key in device_keys(shape, spec, mesh).items():
                host = self.hosts.host_of(dev)
                if host not in alive:
                    # A dead host stores nothing: a shard held only there
                    # leaves this snapshot incomplete (never a target).
                    continue
                store = snap.primary[host].setdefault(path, {})
                if key in store:
                    continue  # one copy a host
                data = np.array(arr[tuple(slice(a, b) for a, b in key)], order="C")
                store[key] = data
                if (path, key) not in snap.shard_sha:
                    snap.shard_sha[(path, key)] = _sha(data)
        job.release()
        # Complete when every leaf's distinct shards tile it (the shards of
        # one layout are disjoint, so a volume count is exact).
        covered: dict[str, int] = {}
        for path, key in snap.shard_sha:
            vol = 1
            for a, b in key:
                vol *= b - a
            covered[path] = covered.get(path, 0) + (vol if key else 1)
        for leaf in snap.leaves:
            full = 1
            for d in leaf.shape:
                full *= d
            if covered.get(leaf.path, 0) < max(full, 1):
                snap.complete = False
                break
        snap.sha256 = hashlib.sha256("".join(
            f"{path}{key!r}{h}" for (path, key), h in sorted(snap.shard_sha.items())
        ).encode()).hexdigest()
        # The ring mirror: host h's shard set also lives at the next ALIVE
        # host after it (references: shards are written once, never changed).
        live = sorted(h for h in range(n) if snap.primary.get(h))
        for h in live:
            for off in range(1, n):
                peer = (h + off) % n
                if peer in alive:
                    if peer != h:
                        dst = snap.mirror.setdefault(peer, {})
                        for path, shards in snap.primary[h].items():
                            dst.setdefault(path, {}).update(shards)
                    break
        if snap.complete:
            # An incomplete commit is reported, never kept: it would push
            # the complete ones a recovery needs out of the keep ring.
            self._committed.append(snap)
        self.commit_s.append(time.perf_counter() - t0)
        if self.on_event is not None:
            self.on_event("snapshot", step=step, sha256=snap.sha256[:16], bytes=snap.nbytes(),
                          skipped=self.skipped, tier="memory", complete=snap.complete,
                          commit_s=round(self.commit_s[-1], 6))

    # ---- consumer side ---------------------------------------------------
    def drain(self) -> None:
        """Block until every queued commit has landed (recovery paths,
        outside the loop, before they choose a target)."""
        self._queue.join()

    def latest(self, max_step: int | None = None) -> InMemorySnapshot | None:
        """Newest COMPLETE snapshot, at or below ``max_step`` when given."""
        for snap in reversed(self._committed):
            if not snap.complete:
                continue
            if max_step is None or snap.step <= max_step:
                return snap
        return None

    def host_bytes(self) -> int:
        """Host memory the retained snapshots hold (every host's primary
        copies; mirrors are references to them)."""
        return sum(s.nbytes() for s in self._committed)

    def drop_primary(self, host: int) -> bool:
        """Chaos ``lose_snapshot_at_step``: ``host``'s snapshot memory is
        lost, its primary store AND the mirror shards it held, in every
        retained snapshot (dropping the primary alone would let a drill
        recover from bytes the fault claims are gone). Pending commits land
        first, so the drop covers the snapshot a recovery would pick."""
        self.drain()
        dropped = False
        for snap in self._committed:
            if snap.primary.get(host) or snap.mirror.get(host):
                snap.primary[host] = {}
                snap.mirror[host] = {}
                dropped = True
        return dropped

    def restore(self, snap: InMemorySnapshot, alive: set[int],
                device=None) -> tuple[dict[str, torch.Tensor], bool]:
        """The full state (path -> tensor, on ``device`` when given) from
        the copies that survive on ``alive`` hosts, and whether a mirror was
        read. Every shard read is re-hashed; a mismatch falls back to
        another copy, and with none intact raises
        :class:`SnapshotIncompleteError`. The tensors returned may be the
        store's own: copy from them, never write into them."""
        plan = RedundancyPlan.from_snapshot(snap)
        sources = plan.recovery_set(snap, alive)
        used_mirror = False
        out_state: dict[str, torch.Tensor] = {}
        for leaf in snap.leaves:
            full = tuple((0, d) for d in leaf.shape)
            out: np.ndarray | None = None
            for host, tier, key in sources[leaf.path]:
                store = snap.primary if tier == "primary" else snap.mirror
                data = store[host][leaf.path][key]
                if _sha(data) != snap.shard_sha[(leaf.path, key)]:
                    alt = self._intact_copy(snap, leaf.path, key, alive)
                    if alt is None:
                        raise SnapshotIncompleteError(
                            f"snapshot step {snap.step}: every surviving "
                            f"copy of {leaf.path} shard {key} fails its "
                            "integrity hash")
                    host, tier, data = alt
                if tier == "mirror":
                    used_mirror = True
                if key == full:
                    out = data
                    break
                if out is None:
                    out = np.empty(leaf.shape, dtype=data.dtype)
                out[tuple(slice(a, b) for a, b in key)] = data
            t = _to_torch(out, leaf.dtype)
            out_state[leaf.path] = t if device is None else t.to(device)
        return out_state, used_mirror

    @staticmethod
    def _intact_copy(snap, path, key, alive):
        for h in sorted(alive):
            for tier, store in (("primary", snap.primary), ("mirror", snap.mirror)):
                data = store.get(h, {}).get(path, {}).get(key)
                if data is not None and _sha(data) == snap.shard_sha[(path, key)]:
                    return h, tier, data
        return None

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._queue.put(None)
        self._thread.join(timeout=5.0)
        with self._lock:
            self._slots.clear()


@functools.lru_cache(maxsize=16)
def _leaf_specs(names: tuple[str, ...], groups: tuple[str, ...], rules) -> dict[str, tuple]:
    from dtc_tpu_torch.parallel.sharding import param_spec

    return {f"{g}/{n}": param_spec(n, rules) for g in groups for n in names}


def train_state(model, opt, gen: torch.Generator, rules) -> tuple[dict[str, Any], dict[str, tuple]]:
    """What a snapshot of training holds, and each leaf's spec under
    ``rules``: the parameters, the optimizer's moments (under bf16_mixed
    its float32 masters too) cut as their parameter is, and whole the
    optimizer's count and skip counters and the dropout generator's state
    (the port draws dropout from a generator where the JAX package folds a
    key by step: without it a replay at dropout > 0 is not bit-equal). The
    specs are cached: do not change the dict returned."""
    names = {id(p): n for n, p in model.named_parameters()}
    state: dict[str, Any] = {}
    groups = [("params", opt.params), ("mu", opt.mu), ("nu", opt.nu)]
    if opt.masters is not None:
        groups.append(("master", opt.masters))
    for group, tensors in groups:
        for p, t in zip(opt.params, tensors):
            state[f"{group}/{names[id(p)]}"] = t
    specs = _leaf_specs(tuple(names[id(p)] for p in opt.params),
                        tuple(g for g, _ in groups), tuple(rules))
    state["opt/count"] = opt.count
    if opt.skip_nonfinite:
        state["opt/notfinite_count"] = opt.notfinite_count
        state["opt/total_notfinite"] = opt.total_notfinite
    state["rng"] = gen.get_state()
    return state, specs


@torch.no_grad()
def load_train_state(model, opt, gen: torch.Generator, state: dict[str, torch.Tensor]) -> None:
    """Copy a :func:`train_state` snapshot back into the model, the
    optimizer and the generator, in place."""
    names = {id(p): n for n, p in model.named_parameters()}
    groups = [("params", opt.params), ("mu", opt.mu), ("nu", opt.nu)]
    if opt.masters is not None:
        groups.append(("master", opt.masters))
    for group, tensors in groups:
        for p, t in zip(opt.params, tensors):
            t.copy_(state[f"{group}/{names[id(p)]}"])
    if isinstance(opt.count, torch.Tensor):
        dev = opt.count.device
        opt.count = state["opt/count"].to(dev, copy=True)
        opt.notfinite_count = state["opt/notfinite_count"].to(dev, copy=True)
        opt.total_notfinite = state["opt/total_notfinite"].to(dev, copy=True)
    else:
        opt.count = int(state["opt/count"])
    gen.set_state(state["rng"].cpu())
