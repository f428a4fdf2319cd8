"""Device telemetry: card memory sampling.

The caching allocator's own accounting (``torch.cuda.memory_stats``)
reports the bytes its tensors hold and their high-water mark, and
``torch.cuda.mem_get_info`` the card's capacity; both are host-side reads
with no device sync, so the trainer can poll them on a cadence without
skewing the comparison it is instrumenting. The keys are the JAX
package's (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``), so
the same readers take either run. On the CPU the stats are ``None``.
"""

from __future__ import annotations

from typing import Any

import torch


def _stats(device: torch.device) -> dict[str, int]:
    s = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {
        "bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(total),
    }


def sample_memory(device=None) -> list[dict[str, Any]] | None:
    """Memory stats of this process's card (``device``, the current CUDA
    device when None).

    Returns ``None`` when there is no card accounting (a CPU run) — the
    JSON stream then carries an explicit null, distinguishing "backend
    can't say" from "zero bytes".
    """
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    try:
        stats = _stats(dev)
    except Exception:  # an allocator that cannot say
        return None
    return [{"device": dev.index, "stats": stats}]


def max_stat(samples: list[dict[str, Any]] | None, key: str) -> int | None:
    """Max of one stat ``key`` across a ``sample_memory()`` result, or
    ``None`` when the backend reported nothing."""
    if not samples:
        return None
    vals = [
        s["stats"][key]
        for s in samples
        if s.get("stats") and s["stats"].get(key) is not None
    ]
    return max(vals) if vals else None


def peak_hbm_bytes(samples: list[dict[str, Any]] | None) -> int | None:
    """Max ``peak_bytes_in_use`` across one ``sample_memory()`` result."""
    return max_stat(samples, "peak_bytes_in_use")


def hbm_watermark(device=None) -> dict[str, int | None]:
    """One-shot memory high-water snapshot for profile artifacts: each
    devprof capture window records this at close, so the trace's timing
    rows travel with the memory peak of the window they were measured in.
    Explicit nulls on the CPU — "backend can't say", not "zero bytes"."""
    samples = sample_memory(device)
    return {
        "peak_hbm_bytes": peak_hbm_bytes(samples),
        "hbm_bytes_in_use": max_stat(samples, "bytes_in_use"),
    }
