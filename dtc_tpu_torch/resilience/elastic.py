"""Elastic training: virtual hosts, failure detection, resize planning (the
port's copy of the JAX package's ``resilience/elastic.py``).

The trainer composes these pieces into shrink-and-continue:

- :class:`VirtualHosts` — the in-process emulation of pod hosts: ``N``
  virtual devices split into ``n_hosts`` contiguous groups, each "host"
  owning its group plus an in-memory snapshot store
  (:mod:`dtc_tpu_torch.resilience.snapshot`). One torch process on one
  card has no device list to split, so a device here is an index
  ``0 .. N-1`` and ``N`` is an argument: the data × model product of the
  config's mesh when it fixes one, else 8 (the count the JAX package's
  tests and smokes split). The process computes the whole global batch
  either way; the virtual devices decide the snapshot's shard layout,
  which hosts hold what, and what a host loss takes away.

  What is real: detection runs on heartbeats alone (never by peeking at
  the kill flag), recovery reads ONLY surviving hosts' stores, and the
  restored trajectory is bit-checked against a fresh restart from the
  same state.

- :class:`HostMonitor` — heartbeat failure detection: every live host
  beats each step; ``miss_limit`` consecutive missed beats declare it
  lost (``host_lost``). A hung-step flag from the step watchdog counts as
  a collective stall and escalates (one missed beat suffices). A host
  whose beats arrive late (chaos ``slow_host_at_step``) is flagged
  ``host_slow`` once and is not declared lost.

- :func:`resize_mesh` — a :class:`VirtualMesh` over a target host set,
  SHRINK or GROW: the pipe and model axes keep their sizes (a resize
  moves whole data-parallel groups), the data axis absorbs the targets.
  Raises :class:`ElasticAbort` when no valid mesh exists (targets that do
  not split into the model axis, a pipeline, dead targets).
  :func:`shrink_mesh` is the survivors-only case.
"""

from __future__ import annotations

from dataclasses import dataclass

from dtc_tpu_torch.parallel.mesh import AXIS_NAMES
from dtc_tpu_torch.resilience.errors import ElasticAbort

#: The virtual device count when the config fixes no mesh.
DEFAULT_VIRTUAL_DEVICES = 8


@dataclass(frozen=True)
class VirtualMesh:
    """A ``(pipe, data, model)`` mesh over virtual device indices, laid out
    row-major as the JAX package's ``build_mesh`` lays out its devices."""

    sizes: tuple[int, int, int]
    devices: tuple[int, ...]

    def __post_init__(self) -> None:
        object.__setattr__(self, "sizes", tuple(int(s) for s in self.sizes))
        object.__setattr__(self, "devices", tuple(int(d) for d in self.devices))
        p, d, m = self.sizes
        if p * d * m != len(self.devices):
            raise ValueError(f"mesh {self.sizes} does not cover {len(self.devices)} devices")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(AXIS_NAMES, self.sizes))

    def coords(self) -> dict[int, dict[str, int]]:
        """Each device's index along every axis."""
        _, d, m = self.sizes
        return {dev: {"pipe": i // (d * m), "data": i // m % d, "model": i % m}
                for i, dev in enumerate(self.devices)}


class VirtualHosts:
    """``n_hosts`` contiguous groups over ``n_devices`` virtual devices."""

    def __init__(self, n_hosts: int, n_devices: int = DEFAULT_VIRTUAL_DEVICES):
        if n_hosts < 2:
            raise ValueError(f"n_virtual_hosts must be >= 2, got {n_hosts}")
        if n_devices % n_hosts != 0:
            raise ValueError(
                f"{n_devices} devices do not split into {n_hosts} equal virtual hosts")
        self.n_hosts = n_hosts
        self.devices = list(range(n_devices))
        self.per_host = n_devices // n_hosts
        self.alive: set[int] = set(range(n_hosts))

    def host_of(self, device: int) -> int:
        return int(device) // self.per_host

    def devices_of(self, host: int) -> list[int]:
        return self.devices[host * self.per_host:(host + 1) * self.per_host]

    def survivor_devices(self) -> list[int]:
        return [d for d in self.devices if self.host_of(d) in self.alive]

    def kill(self, host: int) -> None:
        self.alive.discard(host)

    def revive(self, host: int) -> None:
        """Return ``host`` to the alive set (a pool GROW hands back a host
        the serving tenant released). Monitor admission is the caller's:
        ``alive`` is capacity, not health history."""
        if not 0 <= host < self.n_hosts:
            raise ValueError(f"host {host} outside pool of {self.n_hosts}")
        self.alive.add(host)

    def ring_next(self, host: int) -> int:
        return (host + 1) % self.n_hosts


class HostMonitor:
    """Heartbeat and collective-stall failure detection over virtual hosts.

    ``tick(step)`` records a beat for every host that is alive (and not
    straggling); ``poll(step)`` judges by the beat history alone, never by
    the emulation's kill flag, so it is the code a real heartbeat
    transport would drive."""

    def __init__(self, hosts: VirtualHosts, *, miss_limit: int = 2):
        self.hosts = hosts
        self.miss_limit = max(int(miss_limit), 1)
        # The roster is frozen at construction (after elastic.dead_hosts,
        # before any chaos): a shrunk restart does not "detect" its gone
        # hosts, and a host killed before the first tick is still watched.
        self._roster = sorted(hosts.alive)
        self._last_beat: dict[int, int] = {}
        self._slow_until: dict[int, int] = {}
        self._lost: set[int] = set()
        self._slow_flagged: set[int] = set()
        self._started_at: int | None = None

    def mark_slow(self, host: int, until_step: int) -> None:
        """Chaos ``slow_host_at_step``: ``host`` sends no beat through
        ``until_step``."""
        self._slow_until[host] = max(self._slow_until.get(host, 0), until_step)

    def tick(self, step: int) -> None:
        if self._started_at is None:
            # Seed the construction-time roster, not the alive set: a host
            # killed before the first tick must enter the table to be missed.
            self._started_at = step - 1
            for h in self._roster:
                self._last_beat[h] = step - 1
        for h in self.hosts.alive:
            if h not in self._roster:
                continue  # another tenant's host (the pool): not ours to beat
            if self._slow_until.get(h, 0) >= step:
                continue  # straggling: this step's beat does not arrive
            self._last_beat[h] = step

    def poll(self, step: int, *, stalled: bool = False) -> list[dict]:
        """This step's detection events. ``stalled`` (the step watchdog
        flagged the step as hung) escalates: a host missing one beat is
        lost at once. Each host is reported lost (or slow) once."""
        events: list[dict] = []
        if self._started_at is None:
            return events
        limit = 1 if stalled else self.miss_limit
        for h in sorted(self._last_beat):
            if h in self._lost:
                continue
            missed = step - self._last_beat[h]
            if missed >= limit:
                self._lost.add(h)
                events.append({
                    "kind": "host_lost", "host": h, "missed": missed,
                    "last_beat": self._last_beat[h], "detected_at": step,
                    "escalated": bool(stalled),
                })
            elif missed >= 1 and h not in self._slow_flagged:
                self._slow_flagged.add(h)
                events.append({
                    "kind": "host_slow", "host": h, "missed": missed,
                    "last_beat": self._last_beat[h], "detected_at": step,
                })
        return events

    @property
    def lost(self) -> set[int]:
        return set(self._lost)

    def admit(self, host: int, *, step: int) -> None:
        """Add ``host`` to the roster (a pool GROW). A host this monitor
        declared lost is refused: a grow must not resurrect a dead host."""
        if host in self._lost:
            raise ElasticAbort(
                f"cannot admit host {host}: declared lost at beat "
                f"{self._last_beat.get(host, '?')} — a grow must not "
                "resurrect a dead host"
            )
        if host not in self._roster:
            self._roster = sorted(set(self._roster) | {host})
        # Healthy at admission: the miss count starts from now.
        self._last_beat[host] = step
        self._slow_flagged.discard(host)

    def retire(self, host: int) -> None:
        """Remove ``host`` from the roster (a pool SHRINK surrenders it).
        Surrender is not death: ``poll`` never declares it lost, and a
        later ``admit`` of it is legal."""
        self._roster = sorted(set(self._roster) - {host})
        self._last_beat.pop(host, None)
        self._slow_until.pop(host, None)
        self._slow_flagged.discard(host)


def resize_mesh(mesh: VirtualMesh, hosts: VirtualHosts,
                target_hosts: set[int] | None = None) -> VirtualMesh:
    """The mesh over ``target_hosts``' devices, SHRINK or GROW.
    ``target_hosts=None`` means every alive host (shrink-and-continue);
    an explicit set is the pool's resize. Only the data axis changes: a
    target set that breaks the model groups leaves no valid mesh."""
    if target_hosts is None:
        devices = hosts.survivor_devices()
    else:
        bad = set(target_hosts) - hosts.alive
        if bad:
            raise ElasticAbort(
                f"resize targets dead/unknown hosts {sorted(bad)} "
                f"(alive: {sorted(hosts.alive)})"
            )
        devices = [d for h in sorted(target_hosts) for d in hosts.devices_of(h)]
    if not devices:
        raise ElasticAbort("no surviving target hosts to rebuild a mesh from")
    pipe, _, model = mesh.sizes
    if pipe > 1:
        raise ElasticAbort(
            "elastic resize is not supported under pipeline parallelism "
            "(stage-chunked params cannot re-shard onto a different "
            "stage count); use a mesh with pipe == 1"
        )
    if len(devices) % model != 0:
        raise ElasticAbort(
            f"{len(devices)} target devices do not preserve the "
            f"model={model} (TP) axis; no valid resized mesh exists"
        )
    return VirtualMesh((1, len(devices) // model, model), devices)


def shrink_mesh(mesh: VirtualMesh, hosts: VirtualHosts) -> VirtualMesh:
    """The mesh over the surviving hosts' devices: :func:`resize_mesh`
    with the survivors as the target set."""
    return resize_mesh(mesh, hosts, target_hosts=None)
