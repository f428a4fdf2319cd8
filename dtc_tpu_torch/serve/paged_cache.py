"""Paged KV-cache accounting: a block allocator over the packed cache.

The physical decode cache stays model-native — per slot, one contiguous
packed ``(max_seq_len, H·D)`` row the fused kernel reads directly
(ops/decode_attention.py). What is *paged* is the budget: resident tokens
are accounted in fixed ``page_size`` blocks against one ``total_pages``
pool shared by every in-flight request AND the shared-prefix store, so the
runtime can model (and enforce) a cache smaller than
``slots × max_seq_len`` — the steady state of a loaded server. When the
pool runs out, the engine *evicts*: a victim request's pages are freed and
the request re-queues for bit-exact re-prefill (a verified recovery path,
not a failure).

Pages are also the integrity unit: the engine fingerprints each COMPLETED
page (all ``page_size`` positions written) and re-verifies on a cadence,
so cache-block corruption is caught and healed by the same
evict→re-prefill path.

Honesty note on prefix sharing: with the dense per-slot layout, a shared
system prompt saves *prefill compute* (computed once, copied device-side
into each slot) and holds ONE pooled copy in the prefix store; the
per-slot copies still occupy their slots' pages and are accounted as
such. True page-level physical sharing needs a gather-capable decode
kernel (future work — the allocator's interface already speaks pages so
that kernel slots in underneath).
"""

from __future__ import annotations

import math
from typing import Iterable


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages covering ``n_tokens`` resident cache positions."""
    return math.ceil(n_tokens / page_size) if n_tokens > 0 else 0


def kv_token_bytes(model_cfg) -> int:
    """KV payload bytes ONE resident token occupies across all layers —
    the dtype-aware unit the byte-budget pool sizing
    (``ServeConfig.pool_hbm_bytes``) divides by: K + V, packed ``H·D``
    wide, per layer, at ``kv_cache_dtype``. int8 is exactly half bf16
    and a quarter fp32, which is the "quantization doubles page
    capacity" arithmetic the acceptance test pins.

    Honesty note: the int8 scale sidecars (fp32 per position per head,
    ``1/(2·D)`` of the bf16 payload — ~3% at head_dim 32) are metadata
    OUTSIDE this unit, exactly as vLLM-style allocators account block
    storage but not block tables. The decode roofline
    (utils/metrics.decode_step_bytes) counts them, because there they
    are real bandwidth."""
    from dtc_tpu_torch.config.schema import DTYPE_BYTES

    hd = model_cfg.n_heads * model_cfg.head_dim
    return 2 * model_cfg.n_layers * hd * DTYPE_BYTES.get(
        model_cfg.kv_store_dtype, 4
    )


class PageAllocator:
    """Bookkeeping for one page pool: per-owner page counts, free count,
    and LRU-stamped prefix-store pins. Pure host-side accounting — device
    copies are the engine's job — so it unit-tests without a backend."""

    def __init__(self, total_pages: int, page_size: int):
        if total_pages < 1 or page_size < 1:
            raise ValueError("total_pages and page_size must be >= 1")
        self.total_pages = total_pages
        self.page_size = page_size
        self._held: dict[str, int] = {}       # request id -> pages
        self._prefix: dict[tuple, dict] = {}  # prefix key -> {pages, stamp}
        self._stamp = 0                        # LRU clock for prefix entries

    # -- core pool ---------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return self.total_pages - sum(self._held.values()) - sum(
            e["pages"] for e in self._prefix.values()
        )

    def held(self, rid: str) -> int:
        return self._held.get(rid, 0)

    def can_fit(self, n_pages: int) -> bool:
        return n_pages <= self.free_pages

    def alloc(self, rid: str, n_pages: int) -> bool:
        """Grant ``rid`` ``n_pages`` more pages; False (nothing changes)
        when the pool cannot cover them."""
        if n_pages < 0:
            raise ValueError("n_pages must be >= 0")
        if n_pages > self.free_pages:
            return False
        self._held[rid] = self._held.get(rid, 0) + n_pages
        return True

    def ensure(self, rid: str, n_pages_total: int) -> bool:
        """Grow ``rid``'s holding to ``n_pages_total`` (no-op if already
        there); False when the pool cannot cover the growth."""
        need = n_pages_total - self.held(rid)
        return True if need <= 0 else self.alloc(rid, need)

    def free(self, rid: str) -> int:
        """Release all of ``rid``'s pages; returns how many."""
        return self._held.pop(rid, 0)

    # -- prefix store accounting ------------------------------------------
    def pin_prefix(self, key: tuple, n_pages: int) -> bool:
        """Account a NEW prefix-store entry (one pooled copy of a shared
        system prompt's KV). False when it cannot fit."""
        if key in self._prefix:
            self.touch_prefix(key)
            return True
        if n_pages > self.free_pages:
            return False
        self._stamp += 1
        self._prefix[key] = {"pages": n_pages, "stamp": self._stamp}
        return True

    def touch_prefix(self, key: tuple) -> None:
        """LRU touch on admission reuse."""
        self._stamp += 1
        self._prefix[key]["stamp"] = self._stamp

    def prefix_pages(self, key: tuple) -> int:
        return self._prefix[key]["pages"] if key in self._prefix else 0

    def has_prefix(self, key: tuple) -> bool:
        return key in self._prefix

    def drop_prefix(self, key: tuple) -> int:
        """Un-account one prefix entry by key (a failed build that never
        reached the store); returns its pages (0 if absent)."""
        e = self._prefix.pop(key, None)
        return e["pages"] if e else 0

    def evict_prefix_lru(self) -> tuple | None:
        """Drop the least-recently-used prefix entry, returning its key
        (None when the store is empty). Any entry is droppable — admitted
        requests hold private copies, the store only saves future prefill
        compute — so LRU just picks the least useful."""
        if not self._prefix:
            return None
        key = min(self._prefix, key=lambda k: self._prefix[k]["stamp"])
        del self._prefix[key]
        return key

    def prefix_keys(self) -> Iterable[tuple]:
        return tuple(self._prefix)

    # -- introspection -----------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "total_pages": self.total_pages,
            "free_pages": self.free_pages,
            "held": dict(self._held),
            "prefix_entries": len(self._prefix),
            "prefix_pages": sum(e["pages"] for e in self._prefix.values()),
        }
