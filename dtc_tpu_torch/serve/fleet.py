"""Serve a fleet of engine replicas behind the router, with a replica kill
mid-traffic, and check what came out.

    python -m dtc_tpu_torch.serve.fleet --router_config_path configs/router_config.yaml \\
        [--model_config_path configs/model_config.yaml] [--device cpu] \\
        [--requests 12] [--rps R] [--max_new_tokens N] [--obs_dir DIR]

The router config's replicas, placement, heartbeats, retries, watchdog and
per-replica engine config are used as written; its ``chaos`` block too
when it is enabled, and otherwise the example block the committed
``configs/router_config.yaml`` documents (:data:`EXAMPLE_CHAOS`: a
partition at router iteration 3, a stall at 6, a kill at 9, all of
replica 0). Random weights from seed 0; the traffic is
``utils.arrivals``' seeded prompts, every third request opening with one
shared prefix, submitted at once after the first (closed loop), or with
``--rps`` open loop on ``utils.arrivals``' Poisson schedule from the
first request's arrival, a submit the fleet refuses with its typed
backpressure counted as rejected; when the model config has
``adapter.rank > 0`` the requests spread over two tenants with random
factors and base requests, tenant ``t1`` first (so replica 0 is its home).

Checks, each a non-zero exit when it fails: every accepted request ends
with a terminal result and a typed error unless DONE (zero silent drops);
the kill landed and moved work (one death, one failover at least); every
completed request's tokens equal ``generate()`` on its prompt (with its
tenant's factors) in full in float32, and in bfloat16 up to its first
failover hop (a survivor's re-prefill computes the carried K/V in bf16
through the prefill path, which may round otherwise than the decode steps
that first wrote it, so the tokens after a hop may part from an
uninterrupted run). Runs on the card unless ``--device cpu``. The last
line of its output is a JSON record: the checks' verdicts, the fleet's
counters, and the wall, tokens and exact nearest-rank TTFT and ms-a-token
percentiles over the completed requests, with their count.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time

#: The fleet faults ``configs/router_config.yaml`` documents in its
#: commented example block.
EXAMPLE_CHAOS = dict(
    enabled=True, fleet_target_replica=0, fleet_partition_at_step=3,
    fleet_partition_iters=2, fleet_stall_replica_at_step=6, stall_s=0.5,
    fleet_kill_replica_at_step=9,
)

#: Tenants of the requests, in turn, when the model has adapters.
TENANT_SPREAD = ("t1", "t2", None)


def random_factors(cfg, device, seed: int, n: int) -> list[dict]:
    """``n`` tenants' LoRA factors for ``cfg`` on ``device``, random and
    nonzero from ``seed``: A and B normal with variance 1 / fan-in (the
    factors' last axis), so each tenant's tokens part from the base's."""
    import torch

    from dtc_tpu_torch.adapters.lora import lora_shapes

    g = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(n):
        fac = {}
        for k, shape in lora_shapes(cfg).items():
            fac[k] = torch.randn(shape, device=device, generator=g) / shape[-1] ** 0.5
        out.append(fac)
    return out


def fleet_requests(mcfg, n: int, seed: int, max_new: int, tenants: bool,
                   rps: float | None = None):
    """``n`` requests of ``utils.arrivals`` seeded prompts of
    ``min(32, max_seq_len // 4)`` tokens, and their arrival offsets at
    ``rps`` (all 0 when ``None``: the closed loop); every third opens with
    the first half of the first prompt, declared as a shared prefix;
    tenants by :data:`TENANT_SPREAD` when ``tenants``."""
    from dtc_tpu_torch.serve import Request
    from dtc_tpu_torch.utils.arrivals import arrival_schedule

    plen = min(32, mcfg.max_seq_len // 4)
    arrivals, prompts = arrival_schedule(seed, n, plen, mcfg.vocab_size, rps)
    prefix = prompts[0][: plen // 2]
    reqs = []
    for i, p in enumerate(prompts):
        shared = i % 3 == 0
        reqs.append(Request(
            rid=f"f{i}", prompt=(prefix + p[len(prefix):]) if shared else p,
            max_new_tokens=max_new, shared_prefix_len=len(prefix) if shared else 0,
            adapter=TENANT_SPREAD[i % len(TENANT_SPREAD)] if tenants else None,
        ))
    return reqs, arrivals.tolist()


def check_fleet(router, reqs, refs: dict, events: list[dict], exact: bool) -> dict:
    """The fleet's verdicts from its results and the router's ``events``:
    silent drops (a request refused with a ``router_reject`` event is not
    one), untyped terminals, the kill's effect, and each completed
    request's tokens against ``refs``, in full when ``exact``, else up to
    the tokens it carried at its first failover hop. Returns the record;
    ``failures`` lists what failed."""
    res = router.results
    summ = router.fleet_summary()
    hops_at: dict[str, int] = {}
    routes: dict[str, int] = {}
    for e in events:
        if e["etype"] == "router_failover":
            hops_at.setdefault(e["rid"], e["tokens_carried"])
        elif e["etype"] == "router_route":
            routes[e["reason"]] = routes.get(e["reason"], 0) + 1
    rejected = {e["rid"] for e in events if e["etype"] == "router_reject"}
    failures = []
    dropped = sorted(r.rid for r in reqs if r.rid not in res and r.rid not in rejected)
    untyped = sorted(rid for rid, r in res.items()
                     if (r.error is None) != (r.state.value == "done"))
    if dropped:
        failures.append(f"silent drops: {dropped}")
    if untyped:
        failures.append(f"terminals without a typed error, or DONE with one: {untyped}")
    if summ["replica_deaths"] != 1 or summ["failovers"] < 1:
        failures.append(f"{summ['replica_deaths']} replica deaths and {summ['failovers']} "
                        "failovers (want 1 and at least 1)")
    agree, short = {}, []
    for r in reqs:
        got = res[r.rid].tokens if r.rid in res else []
        want = refs[r.rid]
        agree[r.rid] = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                            min(len(got), len(want)))
        if r.rid in res and res[r.rid].state.value == "done":
            must = len(want) if exact else hops_at.get(r.rid, len(want))
            if agree[r.rid] < must or (exact and got != want):
                short.append(r.rid)
    if short:
        failures.append(f"tokens part from generate() too early for {short} "
                        f"(leading tokens equal {agree}, first hop at {hops_at})")
    return dict(
        failures=failures, summary=summ, tokens_equal=agree, hops_at=hops_at,
        routes=routes, states={rid: r.state.value for rid, r in res.items()},
        done=sum(r.state.value == "done" for r in res.values()), rejected=sorted(rejected),
    )


def nearest_rank(xs: list[float], q: float) -> float | None:
    """The exact nearest-rank ``q`` quantile of ``xs`` (None when empty)."""
    xs = sorted(xs)
    return xs[max(1, math.ceil(q * len(xs))) - 1] if xs else None


def reference_tokens(model, reqs, factors: dict) -> dict[str, list[int]]:
    """Each request's ``generate()`` tokens on its own (greedy), under its
    tenant's factors (``factors`` by name)."""
    import torch

    from dtc_tpu_torch.generate import generate

    with torch.no_grad():
        return {r.rid: generate(model, [list(r.prompt)], r.max_new_tokens,
                                lora=factors.get(r.adapter))[0].tolist() for r in reqs}


def serve_fleet(rcfg, model, reqs, factors: dict, *, obs_dir: str = "",
                arrivals: list[float] | None = None, clock=time.monotonic,
                sleep=time.sleep):
    """Serve ``reqs`` on a :class:`FleetRouter` of ``rcfg`` over ``model``
    (on ``clock`` and ``sleep``), the tenants' ``factors`` registered: the
    first request is admitted (building the shared prefix) before the
    others arrive, so they can route by prefix affinity. Without
    ``arrivals`` the others arrive at once and the fleet runs until idle;
    with them (one offset a request, in seconds) each arrives its offset
    after the first's, the fleet stepping meanwhile, and a submit refused
    with a ``QueueFullError`` is left to its ``router_reject`` event.
    Returns the router and its events."""
    from dtc_tpu_torch.obs import MemorySink
    from dtc_tpu_torch.serve import FleetRouter, QueueFullError

    router = FleetRouter(model, rcfg, obs_dir=obs_dir, clock=clock, sleep=sleep)
    sink = router.reg.add_sink(MemorySink())
    for name, f in factors.items():
        router.register_adapter(name, f)
    router.submit(reqs[0])
    t0 = clock()
    router.step()
    if arrivals is None:
        for r in reqs[1:]:
            router.submit(r)
        router.run()
        return router, sink.events
    i = 1
    while True:
        while i < len(reqs) and arrivals[i] - arrivals[0] <= clock() - t0:
            try:
                router.submit(reqs[i])
            except QueueFullError:
                pass
            i += 1
        if router.step():
            continue
        if i == len(reqs):
            return router, sink.events
        sleep(max(0.0, min(arrivals[i] - arrivals[0] - (clock() - t0), 0.01)))


def main(argv: list[str] | None = None, *, clock=time.monotonic, sleep=time.sleep) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--router_config_path", default="configs/router_config.yaml")
    p.add_argument("--model_config_path", default=None,
                   help="default: model_config.yaml beside the router config")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--requests", type=int, default=12)
    p.add_argument("--rps", type=float, default=None,
                   help="open-loop arrivals a second (default: all at once)")
    p.add_argument("--max_new_tokens", type=int, default=None,
                   help="default: the router config's, at most max_seq_len // 2")
    p.add_argument("--obs_dir", default="",
                   help="write each replica's and the router's event shard here")
    args = p.parse_args(argv)

    import torch

    from dtc_tpu_torch.config.loader import load_router_config
    from dtc_tpu_torch.config.schema import ChaosConfig
    from dtc_tpu_torch.models.gpt import GPT

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (pass --device cpu to serve on the CPU)")
    rcfg, mcfg = load_router_config(args.router_config_path, args.model_config_path)
    if not rcfg.chaos.enabled:
        rcfg = dataclasses.replace(rcfg, chaos=ChaosConfig(**EXAMPLE_CHAOS))
    model = GPT(mcfg, device=args.device, seed=0)
    factors = {}
    if mcfg.adapter.rank > 0:
        factors = dict(zip(("t1", "t2"), random_factors(mcfg, model.device, 1, 2)))
    max_new = args.max_new_tokens or min(rcfg.serve.max_new_tokens, mcfg.max_seq_len // 2)
    reqs, arrivals = fleet_requests(mcfg, args.requests, 0, max_new, bool(factors), args.rps)
    refs = reference_tokens(model, reqs, factors)
    if args.device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    router, events = serve_fleet(rcfg, model, reqs, factors, obs_dir=args.obs_dir,
                                 arrivals=None if args.rps is None else arrivals,
                                 clock=clock, sleep=sleep)
    if args.device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    router.close()
    rec = check_fleet(router, reqs, refs, events, exact=mcfg.compute_dtype == "float32")
    for r in reqs:
        res = router.results.get(r.rid)
        print(f"[fleet] {r.rid}: {res.state.value if res else 'SILENT DROP'} "
              f"adapter={r.adapter} hops={res.n_hops if res else '-'} tokens equal to "
              f"generate(): {rec['tokens_equal'][r.rid]} of {len(refs[r.rid])}")
    done = [router.results[r.rid] for r in reqs
            if r.rid in router.results and router.results[r.rid].state.value == "done"]
    ttft = [r.ttft_s for r in done if r.ttft_s is not None]
    mspt = [r.ms_per_token for r in done if r.ms_per_token is not None]
    n_tok = sum(len(r.tokens) for r in done)
    out = {k: rec[k] for k in ("summary", "done", "rejected", "hops_at", "routes", "failures")}
    out.update(
        requests=len(reqs), rps=args.rps, max_new_tokens=max_new, wall_s=wall,
        tokens=n_tok, tokens_per_s=n_tok / wall, n_timed=len(done),
        ttft_p50_s=nearest_rank(ttft, 0.5), ttft_p99_s=nearest_rank(ttft, 0.99),
        ms_per_token_p50=nearest_rank(mspt, 0.5), ms_per_token_p99=nearest_rank(mspt, 0.99),
    )
    print(json.dumps(out))
    for f in rec["failures"]:
        print(f"[fleet] FAIL: {f}", file=sys.stderr)
    return 1 if rec["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
