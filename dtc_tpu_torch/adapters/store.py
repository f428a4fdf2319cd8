"""Host-side adapter registry for the serving engine: the fixed
``(n_adapters, ...)`` stacked-factor slots resident on the device.

Pure bookkeeping (the engine writes the factors into the stack), with the
JAX package's semantics: slot 0 is the pinned base adapter (all-zero
factors: the un-adapted model); tenants occupy slots 1..capacity-1.
Registering a new tenant when every slot is taken evicts the
least-recently-used tenant with no in-flight requests (refcount 0); when
none is evictable the registration fails with the typed
:class:`~dtc_tpu_torch.serve.request.AdapterStoreFullError`, never by
overwriting a live tenant's factors.
"""

from __future__ import annotations

#: Reserved slot of the un-adapted base model.
BASE_SLOT = 0


def _store_full_error(msg: str) -> Exception:
    # Imported at raise time: the serve package imports the engine, which
    # imports this module.
    from dtc_tpu_torch.serve.request import AdapterStoreFullError

    return AdapterStoreFullError(msg)


class AdapterStore:
    """LRU + refcounted name -> slot registry over ``capacity`` stack slots
    (slot 0 pinned to base)."""

    def __init__(self, capacity: int):
        if capacity < 2:
            raise ValueError(
                f"adapter store capacity must be >= 2 (slot 0 is the pinned "
                f"base), got {capacity}"
            )
        self.capacity = capacity
        self._slots: dict[str, int] = {}   # tenant name -> stack slot
        self._refs: dict[str, int] = {}    # in-flight request count
        self._stamps: dict[str, int] = {}  # LRU clock
        self._stamp = 0

    def __contains__(self, name: str) -> bool:
        return name in self._slots

    def slot_of(self, name: str | None) -> int | None:
        """Stack slot of ``name``: ``None`` (a base request) maps to
        ``BASE_SLOT``, a resident tenant to its slot, anything else to
        ``None``."""
        if name is None:
            return BASE_SLOT
        return self._slots.get(name)

    def touch(self, name: str) -> None:
        self._stamp += 1
        self._stamps[name] = self._stamp

    def register(self, name: str) -> tuple[int, str | None]:
        """Claim a slot for ``name``; returns ``(slot, evicted_name)``.

        Re-registering a resident name refreshes its LRU stamp and reuses
        its slot (the caller overwrites the factors in place: a hot
        update), but only while it has no in-flight requests, whose decode
        would otherwise fork from the KV already computed (ValueError).
        Raises :class:`AdapterStoreFullError` when every tenant slot is
        held by an adapter with in-flight requests."""
        if not name or name == "base":
            raise ValueError(
                f"invalid adapter name {name!r} ('base'/empty are reserved)"
            )
        if name in self._slots:
            if self._refs.get(name, 0) > 0:
                raise ValueError(
                    f"adapter {name!r} has {self._refs[name]} in-flight "
                    "request(s); drain them before hot-updating its factors"
                )
            self.touch(name)
            return self._slots[name], None
        free = set(range(1, self.capacity)) - set(self._slots.values())
        evicted = None
        if free:
            slot = min(free)
        else:
            idle = [n for n in self._slots if self._refs.get(n, 0) == 0]
            if not idle:
                raise _store_full_error(
                    f"adapter store full: all {self.capacity - 1} tenant "
                    "slot(s) hold adapters with in-flight requests"
                )
            evicted = min(idle, key=lambda n: self._stamps.get(n, 0))
            slot = self._slots.pop(evicted)
            self._refs.pop(evicted, None)
            self._stamps.pop(evicted, None)
        self._slots[name] = slot
        self._refs.setdefault(name, 0)
        self.touch(name)
        return slot, evicted

    def acquire(self, name: str) -> None:
        """Pin ``name`` for one in-flight request (submit -> terminal)."""
        if name not in self._slots:
            raise KeyError(f"adapter {name!r} not resident")
        self._refs[name] = self._refs.get(name, 0) + 1
        self.touch(name)

    def release(self, name: str) -> None:
        if self._refs.get(name, 0) > 0:
            self._refs[name] -= 1

    def refcount(self, name: str) -> int:
        return self._refs.get(name, 0)

    def snapshot(self) -> dict:
        return {
            "capacity": self.capacity,
            "resident": dict(self._slots),
            "refcounts": {n: r for n, r in self._refs.items() if r},
        }
