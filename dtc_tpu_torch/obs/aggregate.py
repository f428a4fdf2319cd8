"""Multi-host telemetry reduction.

Each process writes its own JSONL shard (``events.r<k>.jsonl``); on a pod
with a shared output filesystem, process 0 reduces them post-run into one
cross-host view: per-host mean step time, min/max/mean across hosts, and
a **straggler flag** for any host whose mean step time exceeds the
cross-host median by a configurable factor — the "one slow host gates the
whole pod" failure MegaScale-style fleet telemetry exists to catch.

Degrades gracefully: with one shard (single process, or per-host local
disks) the reduction is a trivial self-summary, never an error.
"""

from __future__ import annotations

import glob
import os
import re
import statistics
from typing import Any

from dtc_tpu_torch.obs.registry import Histogram, read_jsonl

_SHARD_RE = re.compile(r"events\.r(\d+)\.jsonl$")


def shard_path(obs_dir: str, process_index: int) -> str:
    return os.path.join(obs_dir, f"events.r{process_index}.jsonl")


def find_shards(obs_dir: str) -> dict[int, str]:
    """Process index -> LOGICAL shard path for every shard in ``obs_dir``.

    The returned path is the live file; size-rotated segments
    (``events.r<k>.jsonl.1``, …) are part of the same logical shard and
    are expanded — in chronological order — by
    :func:`dtc_tpu_torch.obs.registry.read_jsonl`, so every consumer of this
    mapping reads rotated history transparently."""
    shards = {}
    for p in glob.glob(os.path.join(obs_dir, "events.r*.jsonl")):
        m = _SHARD_RE.search(p)
        if m:
            shards[int(m.group(1))] = p
    return shards


def _step_times(events: list[dict[str, Any]]) -> dict[int, float]:
    return {
        e["step"]: e["step_time_s"]
        for e in events
        if e.get("etype") == "step"
        and isinstance(e.get("step"), int)
        and isinstance(e.get("step_time_s"), (int, float))
    }


#: Serving event types whose presence marks a shard as a serving run
#: (and whose ``iteration`` stamps bound the scheduler's progress).
_SERVE_ETYPES = ("serve_request", "serve_admit", "serve_evict",
                 "serve_reject", "serve_corruption")

#: Per-shard SLO fields copied onto the per-host rows of the reduced
#: view (the fleet's per-replica p50/p99 table).
_SERVE_HOST_KEYS = ("ttft_p50_s", "ttft_p99_s", "ms_per_token_p50",
                    "ms_per_token_p99", "tokens_per_sec", "failover_hops")


def _serve_stats(events: list[dict[str, Any]]) -> dict[str, Any] | None:
    """Per-shard serving reduction: terminal request counts by state, the
    highest scheduler iteration observed, and — the fleet leg
    — p50/p99 TTFT + ms/token and a tokens/s estimate derived from the
    ``serve_request`` terminals themselves, so a router deployment's
    per-replica shards reduce to exactly the per-replica SLO rows the
    fleet view needs (a replica that absorbed a failover shows it in its
    own p99). ``None`` when the shard holds no serving events at all."""
    from dtc_tpu_torch.utils.percentile import nearest_rank, round_opt as r4

    iterations = 0
    requests = 0
    by_state: dict[str, int] = {}
    ttft: list[float] = []
    mspt: list[float] = []
    tokens_done = 0
    hops = 0
    ts_lo: float | None = None
    ts_hi: float | None = None
    seen = False
    for e in events:
        et = e.get("etype")
        if et not in _SERVE_ETYPES:
            continue
        seen = True
        it = e.get("iteration")
        if isinstance(it, (int, float)):
            iterations = max(iterations, int(it))
        ts = e.get("ts")
        if isinstance(ts, (int, float)):
            ts_lo = ts if ts_lo is None else min(ts_lo, ts)
            ts_hi = ts if ts_hi is None else max(ts_hi, ts)
        if et == "serve_request":
            requests += 1
            state = str(e.get("state", "?"))
            by_state[state] = by_state.get(state, 0) + 1
            if isinstance(e.get("ttft_s"), (int, float)):
                ttft.append(float(e["ttft_s"]))
            if isinstance(e.get("ms_per_token"), (int, float)):
                mspt.append(float(e["ms_per_token"]))
            if state == "done" and isinstance(e.get("n_tokens"), int):
                tokens_done += e["n_tokens"]
            if isinstance(e.get("n_hops"), int):
                hops += e["n_hops"]
    if not seen:
        return None
    out: dict[str, Any] = {
        "requests": requests, "iterations": iterations,
        "by_state": by_state,
    }
    # Per-HOST percentiles stay exact nearest-rank over the shard's own
    # samples; the CROSS-shard pool (below, in reduce_shards) merges
    # log-bucketed histograms instead of re-deriving from raw samples
    # — pooled values are within one ~10% bucket of
    # the exact nearest-rank answer (the Histogram contract).
    if ttft:
        out["ttft_p50_s"] = r4(nearest_rank(ttft, 0.50))
        out["ttft_p99_s"] = r4(nearest_rank(ttft, 0.99))
    if mspt:
        out["ms_per_token_p50"] = r4(nearest_rank(mspt, 0.50))
        out["ms_per_token_p99"] = r4(nearest_rank(mspt, 0.99))
    if hops:
        out["failover_hops"] = hops
    wall = (ts_hi - ts_lo) if ts_lo is not None else 0.0
    if tokens_done and wall > 0:
        out["tokens_per_sec"] = round(tokens_done / wall, 2)
    th = Histogram("_ttft")
    mh = Histogram("_mspt")
    for v in ttft:
        th.observe(v)
    for v in mspt:
        mh.observe(v)
    out["_ttft_hist"] = th  # cross-shard merge inputs (stripped below)
    out["_mspt_hist"] = mh
    out["_tokens_done"] = tokens_done
    out["_ts"] = (ts_lo, ts_hi)
    return out


#: Elastic-training event types reduced into the ``elastic`` section
#: — recovery must show up in fleet summaries, not only in
#: the raw shard.
_ELASTIC_ETYPES = ("snapshot", "host_lost", "host_slow", "elastic_resize",
                   "elastic_spill")


def _elastic_stats(events: list[dict[str, Any]]) -> dict[str, Any] | None:
    """Per-shard elastic reduction: hot-tier snapshot commit count (and
    cadence skips), hosts declared lost/slow, and every resize with its
    restore tier + surviving mesh. ``None`` when the shard holds no
    elastic events (the common, non-elastic run)."""
    snapshots = 0
    skipped = 0
    last_snapshot_step = None
    incomplete = 0
    lost: list[dict[str, Any]] = []
    slow: list[dict[str, Any]] = []
    resizes: list[dict[str, Any]] = []
    spills = 0
    for e in events:
        et = e.get("etype")
        if et not in _ELASTIC_ETYPES:
            continue
        if et == "snapshot":
            snapshots += 1
            if e.get("complete") is False:
                incomplete += 1
            else:
                last_snapshot_step = e.get("step")
            sk = e.get("skipped")
            if isinstance(sk, (int, float)):
                skipped = max(skipped, int(sk))
        elif et == "host_lost":
            lost.append({
                "host": e.get("host"), "detected_at": e.get("detected_at"),
                "escalated": bool(e.get("escalated")),
            })
        elif et == "host_slow":
            slow.append({
                "host": e.get("host"), "detected_at": e.get("detected_at"),
            })
        elif et == "elastic_resize":
            resizes.append({
                "step": e.get("step"), "to_step": e.get("to_step"),
                "tier": e.get("tier"),
                "used_mirror": bool(e.get("used_mirror")),
                "devices": e.get("devices"),
                "hosts_lost": e.get("hosts_lost"),
            })
        elif et == "elastic_spill":
            spills += 1
    if not (snapshots or lost or slow or resizes or spills):
        return None
    out: dict[str, Any] = {"snapshots": snapshots}
    if skipped:
        out["snapshot_skips"] = skipped
    if incomplete:
        out["snapshots_incomplete"] = incomplete
    if last_snapshot_step is not None:
        out["last_snapshot_step"] = last_snapshot_step
    if lost:
        out["hosts_lost"] = lost
    if slow:
        out["hosts_slow"] = slow
    if resizes:
        out["resizes"] = resizes
    if spills:
        out["spills"] = spills
    return out


def reduce_shards(
    obs_dir: str, straggler_threshold: float = 1.5
) -> dict[str, Any] | None:
    """Cross-host reduction of every shard under ``obs_dir``.

    Returns ``None`` only when no shard holds training step events OR
    serving events (e.g. a run that died before its first step).
    Training shards reduce to the per-host step-time table below;
    serving shards additionally (or, for serving-only runs, instead)
    contribute a typed ``"serve"`` summary — a serving-only run used to
    reduce to ``None`` silently, indistinguishable from a run that did
    nothing. Mixed fleets (some hosts training, some serving) get both
    sections. Training shape::

        {
          "hosts": {proc: {"steps": N, "mean_step_time_s": ..,
                           "min_step_time_s": .., "max_step_time_s": ..,
                           "straggler": bool}},
          "step_time_s": {"mean": .., "min": .., "max": ..},  # across hosts
          "stragglers": [proc, ...],
          "straggler_threshold": ..,
          "n_hosts": N,
          # when serving events exist anywhere:
          "serve": {"requests": R, "iterations": I, "by_state": {...}},
        }

    Serving-only shape: ``hosts`` entries carry ``steps: 0`` +
    ``serve_requests``, ``training_steps: 0`` states it explicitly, and
    ``stragglers`` stays empty (straggler detection is defined on step
    times).
    """
    shards = find_shards(obs_dir)
    per_host: dict[int, dict[int, float]] = {}
    serve_host: dict[int, dict[str, Any]] = {}
    elastic_host: dict[int, dict[str, Any]] = {}
    events_by_proc: dict[int, list[dict[str, Any]]] = {}
    for proc, path in sorted(shards.items()):
        events = read_jsonl(path)
        events_by_proc[proc] = events
        times = _step_times(events)
        if times:
            per_host[proc] = times
        serve = _serve_stats(events)
        if serve is not None:
            serve_host[proc] = serve
        elastic = _elastic_stats(events)
        if elastic is not None:
            elastic_host[proc] = elastic
    # Goodput ledger: re-classify every host's wall-clock
    # from the same shard events — per-host tables, fleet pool, token
    # ledger, incident bills. None when no shard yields intervals.
    goodput_total: dict[str, Any] | None = None
    try:
        from dtc_tpu_torch.obs.goodput import GoodputLedger

        goodput_total = GoodputLedger(events_by_proc).summary()
    except Exception as e:  # reduction must never kill the run's summary
        print(f"[dtc_tpu_torch] WARNING: goodput reduction failed ({e})")
    elastic_total: dict[str, Any] | None = None
    if elastic_host:
        # Cross-shard merge: counters sum, event lists concatenate (each
        # record already names its host), last_snapshot_step takes the max.
        elastic_total = {"snapshots": 0}
        for s in elastic_host.values():
            elastic_total["snapshots"] += s.get("snapshots", 0)
            for k in ("snapshot_skips", "snapshots_incomplete", "spills"):
                if k in s:
                    elastic_total[k] = elastic_total.get(k, 0) + s[k]
            if "last_snapshot_step" in s:
                elastic_total["last_snapshot_step"] = max(
                    elastic_total.get("last_snapshot_step", -1),
                    s["last_snapshot_step"],
                )
            for k in ("hosts_lost", "hosts_slow", "resizes"):
                if k in s:
                    elastic_total.setdefault(k, []).extend(s[k])
    serve_total = None
    if serve_host:
        from dtc_tpu_torch.utils.percentile import round_opt as r4

        by_state: dict[str, int] = {}
        pool_ttft = Histogram("_pool_ttft")
        pool_mspt = Histogram("_pool_mspt")
        tokens_done = 0
        ts_lo: float | None = None
        ts_hi: float | None = None
        for s in serve_host.values():
            for k, v in s["by_state"].items():
                by_state[k] = by_state.get(k, 0) + v
            pool_ttft.merge(s.pop("_ttft_hist"))
            pool_mspt.merge(s.pop("_mspt_hist"))
            tokens_done += s.pop("_tokens_done")
            lo, hi = s.pop("_ts")
            if lo is not None:
                ts_lo = lo if ts_lo is None else min(ts_lo, lo)
                ts_hi = hi if ts_hi is None else max(ts_hi, hi)
        serve_total = {
            "requests": sum(s["requests"] for s in serve_host.values()),
            "iterations": max(s["iterations"] for s in serve_host.values()),
            "by_state": by_state,
        }
        # Fleet-level SLO surface: percentiles over the POOLED terminals
        # (not a mean of per-replica percentiles — that would hide the
        # failover tail inside the averaging) + a tokens/s estimate over
        # the fleet's event-time span. Pooling merges the per-shard
        # log-bucketed histograms (bucket counts
        # sum), so the pool never re-walks raw samples and the
        # answer is within one ~10% bucket of exact nearest-rank.
        if pool_ttft.count:
            serve_total["ttft_p50_s"] = r4(pool_ttft.percentile(0.50))
            serve_total["ttft_p99_s"] = r4(pool_ttft.percentile(0.99))
        if pool_mspt.count:
            serve_total["ms_per_token_p50"] = r4(pool_mspt.percentile(0.50))
            serve_total["ms_per_token_p99"] = r4(pool_mspt.percentile(0.99))
        wall = (ts_hi - ts_lo) if ts_lo is not None else 0.0
        if tokens_done and wall > 0:
            serve_total["tokens_per_sec"] = round(tokens_done / wall, 2)
        hop_total = sum(s.get("failover_hops", 0) for s in serve_host.values())
        if hop_total:
            serve_total["failover_hops"] = hop_total
    if not per_host:
        if serve_total is None:
            return None
        # Serving-only run: the explicit "no training steps, K serve
        # iterations" summary. Per-host rows carry
        # the per-replica SLO percentiles (a fleet's replica
        # shards ARE its per-replica p99 table; the failover shows up in
        # the absorbing replica's row).
        hosts = {
            str(proc): {
                "steps": 0,
                "serve_requests": s["requests"],
                "straggler": False,
                **{k: s[k] for k in _SERVE_HOST_KEYS if k in s},
            }
            for proc, s in serve_host.items()
        }
        out = {
            "hosts": hosts,
            "stragglers": [],
            "straggler_threshold": straggler_threshold,
            "n_hosts": len(serve_host),
            "training_steps": 0,
            "serve": serve_total,
        }
        if elastic_total is not None:
            out["elastic"] = elastic_total
        if goodput_total is not None:
            out["goodput"] = goodput_total
        return out

    host_means = {
        proc: sum(t.values()) / len(t) for proc, t in per_host.items()
    }
    median = statistics.median(host_means.values())
    hosts: dict[str, Any] = {}
    stragglers: list[int] = []
    for proc, times in per_host.items():
        mean = host_means[proc]
        # A host is a straggler when its mean step time exceeds the
        # cross-host median by the threshold factor. With <2 hosts there
        # is no peer to lag behind, so the flag stays False.
        lagging = len(per_host) > 1 and median > 0 and mean > straggler_threshold * median
        if lagging:
            stragglers.append(proc)
        hosts[str(proc)] = {
            "steps": len(times),
            "mean_step_time_s": round(mean, 6),
            "min_step_time_s": round(min(times.values()), 6),
            "max_step_time_s": round(max(times.values()), 6),
            "straggler": lagging,
        }
    # Mixed fleet: serving-only hosts still appear in the table, with
    # their per-replica SLO percentiles.
    for proc, s in serve_host.items():
        entry = hosts.setdefault(
            str(proc), {"steps": 0, "straggler": False}
        )
        entry["serve_requests"] = s["requests"]
        entry.update({k: s[k] for k in _SERVE_HOST_KEYS if k in s})
    means = list(host_means.values())
    out = {
        "hosts": hosts,
        "step_time_s": {
            "mean": round(sum(means) / len(means), 6),
            "min": round(min(means), 6),
            "max": round(max(means), 6),
            "median": round(median, 6),
        },
        "stragglers": sorted(stragglers),
        "straggler_threshold": straggler_threshold,
        "n_hosts": len(set(per_host) | set(serve_host)),
    }
    if serve_total is not None:
        out["serve"] = serve_total
    if elastic_total is not None:
        out["elastic"] = elastic_total
    if goodput_total is not None:
        out["goodput"] = goodput_total
    return out
