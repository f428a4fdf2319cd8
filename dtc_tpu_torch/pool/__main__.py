"""Drive the resource pool through a day of traffic and check what came
out: the counterpart of the JAX package's ``scripts/pool_smoke.py``.

    python -m dtc_tpu_torch.pool --pool_config_path configs/pool_config.yaml \\
        [--model_config_path configs/model_config.yaml] [--device cpu] [--chaos] \\
        [--obs_dir DIR]

The pool config is used as written: hosts, leases and floors, the train
budget and batch, the snapshot cadence, the arbitration thresholds and the
fleet's router and engine configs; with ``--chaos`` its documented chaos
block too (a request spike while the first grow is in flight, host 1
killed while the first shrink is in flight; ``--chaos`` with the config's
own ``chaos`` block enabled uses that block). Random weights from seed 0
for the served model; the train tenant builds its own from the same seed.

The day: ``LOW_TRAFFIC`` requests at once (the trough), then a burst of
``SPIKE_BURST`` (the peak) when the first grow reaches ``steady``, or,
when the pool cannot grow from its first lease (``pool_config.yaml``: two
training hosts and one serving host to spare, and 3 hosts x 2 devices do
not divide the batch of 8), as soon as the fleet is idle with no
transition in flight; the pool then shrinks the trainer for the peak and
grows it again in the trough after it. Prompts of 6 tokens from
``utils.arrivals`` (seed 11), ``NEW_TOKENS`` new tokens a request.

Checks, in ``scripts/pool_smoke.py``'s order, each a non-zero exit when it
fails:

1. a grow and a shrink reached ``steady`` (with ``--chaos``: the first
   grow aborted, a shrink carries the killed host, which no tenant leases
   again);
2. zero silent drops: every request submitted, the chaos burst's included,
   ends in a typed terminal;
3. the train losses equal an uninterrupted run's of the same budget bit for
   bit (this process computes the global batch whole on every mesh, so a
   resize moves no number; the JAX package holds the prefix before the
   first resize bit for bit and the rest to 1e-3), and the first step after
   each grow equals a fresh restart from the grow's snapshot bit for bit;
4. no kernel library was built or first loaded by a resize and nothing
   recompiled (the JAX package asserts one recompile a mesh change; the
   eager port compiles nothing), at least two resizes;
5. the goodput ledger bills every resize as an ``elastic_resize`` incident
   and leaves at most 5% of the train shard's wall unattributed;

and every completed request's tokens equal ``generate()`` on its prompt,
in full in float32 and in bfloat16 up to its first failover hop. Runs on
the card unless ``--device cpu``. The last line of its output is a JSON
record: the verdicts, the transitions with each stage's host seconds, the
snapshot stores' host memory, the pool's train and serve shares of the
wall (``pool.timeshare``), the losses.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time

LOW_TRAFFIC = 2
SPIKE_BURST = 8
NEW_TOKENS = 4
PROMPT_LEN = 6
#: The documented chaos block of ``configs/pool_config.yaml``.
EXAMPLE_CHAOS = dict(enabled=True, pool_spike_mid_grow_at=1, pool_spike_requests=6,
                     pool_kill_mid_shrink_at=1, elastic_target_host=1)
#: The tick budget of a day.
MAX_TICKS = 600


def reference_losses(model_cfg, cfg, device, seed: int = 0) -> list[float]:
    """The train tenant's budget run uninterrupted on one lease: the
    parity oracle."""
    from dtc_tpu_torch.data.prefetch import split_to_device
    from dtc_tpu_torch.pool.manager import tenant_batches, tenant_parts
    from dtc_tpu_torch.train.train_step import train_step

    model, opt, gen = tenant_parts(model_cfg, cfg.train_steps, device, seed)
    data = tenant_batches(model_cfg, cfg, seed)
    out = []
    for _ in range(cfg.train_steps):
        x, y = split_to_device(next(data), model.device)
        out.append(float(train_step(model, opt, x, y, gen, average=False)))
    return out


def fresh_restart_loss(pm, snap, seed: int = 0) -> float:
    """The loss of the step after snapshot ``snap``'s, run from it on a
    model, optimizer and generator built apart from the tenant's (the
    fresh restart a grow's restore must equal)."""
    from dtc_tpu_torch.data.prefetch import split_to_device
    from dtc_tpu_torch.pool.manager import tenant_batches, tenant_parts
    from dtc_tpu_torch.resilience.snapshot import load_train_state
    from dtc_tpu_torch.train.train_step import train_step

    tenant = pm.trainer
    model, opt, gen = tenant_parts(pm.model_cfg, pm.cfg.train_steps, tenant.device, seed + 1)
    state, _ = tenant.snapshots.restore(snap, pm.hosts.alive)
    load_train_state(model, opt, gen, state)
    x, y = split_to_device(next(tenant_batches(pm.model_cfg, pm.cfg, seed, snap.step)),
                           model.device)
    loss = float(train_step(model, opt, x, y, gen, average=False))
    del model, opt
    return loss


def run_day(pm, prompts: list[list[int]], new_tokens: int) -> dict:
    """Drive ``pm`` through the day (see the module docstring). Returns the
    day's record; ``grow_oracles`` holds, for each grow that reached
    ``steady`` with a step run, the step it restored, that step's loss and
    the snapshot (:func:`fresh_restart_loss` takes it after the day, off
    the pool's clock)."""
    from dtc_tpu_torch.serve.request import Request

    for i in range(LOW_TRAFFIC):
        pm.submit(Request(rid=f"low{i}", prompt=prompts[i], max_new_tokens=new_tokens))
    burst_tick, ticks, alive, oracles = None, 0, True, []
    seen_steady: set[int] = set()
    t0 = time.perf_counter()
    while alive and ticks < MAX_TICKS:
        alive = pm.tick()
        ticks += 1
        for i, tr in enumerate(pm.transitions):
            if (tr.kind == "grow" and tr.state == "steady" and i not in seen_steady
                    and len(pm.trainer.losses) > tr.to_step):
                seen_steady.add(i)
                oracles.append((tr.to_step, pm.trainer.losses[tr.to_step],
                                pm.trainer.last_restored))
        if burst_tick is None:
            grown = any(t.kind == "grow" and t.state == "steady" for t in pm.transitions)
            stuck = (pm.transition is None and not pm.router.records and not pm._parked
                     and not pm._grow_candidates()[0])
            if grown or stuck:
                for i in range(SPIKE_BURST):
                    pm.submit(Request(rid=f"burst{i}", prompt=prompts[LOW_TRAFFIC + i],
                                      max_new_tokens=new_tokens))
                burst_tick = ticks
    return dict(ticks=ticks, wall_s=time.perf_counter() - t0, burst_tick=burst_tick,
                drained=not alive, grow_oracles=oracles)


def read_events(obs_dir: str) -> list[dict]:
    from dtc_tpu_torch.obs import find_shards, read_jsonl

    return [e for path in find_shards(obs_dir).values() for e in read_jsonl(path)]


def timeshare(events: list[dict], proc: int) -> dict:
    """The train shard's wall split: seconds in ``step`` events (training),
    in ``pool.timeshare`` spans (serving's slices), in the snapshot
    dispatch spans, and the resizes' detect-to-restored windows."""
    out = dict(train_s=0.0, serve_s=0.0, snapshot_dispatch_s=0.0, resize_s=0.0)
    for e in events:
        if e.get("proc") != proc:
            continue
        if e["etype"] == "step":
            out["train_s"] += e["step_time_s"]
        elif e["etype"] == "span" and e.get("name") == "pool.timeshare":
            out["serve_s"] += e["dur_s"]
        elif e["etype"] == "span" and e.get("name") == "snapshot_dispatch":
            out["snapshot_dispatch_s"] += e["dur_s"]
        elif e["etype"] == "elastic_resize":
            out["resize_s"] += e["t_restored"] - e["t_detect"]
    total = sum(out.values())
    out.update(train_share=out["train_s"] / total if total else None,
               serve_share=out["serve_s"] / total if total else None)
    return out


def check_pool(pm, day: dict, results: dict, events: list[dict], ref: list[float],
               refs: dict[str, list[int]], obs_dir: str, chaos: bool, exact: bool) -> dict:
    """The checks of the module docstring; ``failures`` lists what failed."""
    from dtc_tpu_torch.obs.goodput import GoodputLedger
    from dtc_tpu_torch.pool import POOL_TRAIN_PROC

    failures = []
    cfg = pm.cfg
    # 1. the typed state machine walked both ways
    kinds = {t.kind for t in pm.transitions if t.state == "steady"}
    if not {"grow", "shrink"} <= kinds:
        failures.append(f"no steady grow and shrink: {pm.summary()['transitions']}")
    if chaos:
        aborted = [t for t in pm.transitions if t.state == "aborted"]
        if not (aborted and aborted[0].kind == "grow"
                and pm.transitions.index(aborted[0]) == min(
                    i for i, t in enumerate(pm.transitions) if t.kind == "grow")):
            failures.append("pool_spike_mid_grow did not abort the first grow")
        killed = [t for t in pm.transitions if t.dead_hosts]
        target = cfg.chaos.elastic_target_host
        if not (killed and killed[0].kind == "shrink"):
            failures.append("pool_kill_mid_shrink did not land inside a shrink")
        if target in pm.serve_lease or target in pm.train_lease or target in pm.hosts.alive:
            failures.append(f"the killed host {target} is leased or alive again")
    # 2. zero silent drops
    untyped = sorted(rid for rid, r in results.items()
                     if r.state.value not in ("done", "shed", "expired", "failed")
                     or (r.error is None) != (r.state.value == "done"))
    dropped = sorted(set(pm.requests) - set(results))
    if dropped or untyped or not day["drained"]:
        failures.append(f"silent drops {dropped}, untyped terminals {untyped}, drained "
                        f"{day['drained']} after {day['ticks']} ticks")
    # 3. the losses
    losses = pm.trainer.losses
    if losses != ref:
        first = next((i for i, (a, b) in enumerate(zip(losses, ref)) if a != b),
                     min(len(losses), len(ref)))
        failures.append(f"train losses part from the uninterrupted run at step {first + 1} "
                        f"({len(losses)} of {len(ref)} steps)")
    bad = [o for o in day["grow_oracles"] if o["loss"] != o["fresh"]]
    if bad or not day["grow_oracles"]:
        failures.append(f"a grow's first step against a fresh restart: {day['grow_oracles']}")
    # 4. builds and recompiles
    resizes = [e for e in events if e["etype"] == "elastic_resize"]
    built = [e for e in events if e["etype"] == "recompile"
             or (e["etype"] == "aux_compile" and e.get("what") == "elastic_resize")]
    if len(resizes) < 2 or built or pm.trainer.recompiles:
        failures.append(f"{len(resizes)} resizes (want >= 2); builds or recompiles at a "
                        f"resize: {built}, recompiles {pm.trainer.recompiles}")
    # 5. the goodput ledger
    s = GoodputLedger.from_dir(obs_dir).summary()
    unattr = None
    if s is None:
        failures.append("the goodput ledger found no classifiable events")
    else:
        inc = [i for i in s["incidents"] if i["kind"] == "elastic_resize"]
        shard = s["hosts"].get(POOL_TRAIN_PROC, s["hosts"].get(str(POOL_TRAIN_PROC)))
        unattr = (shard or {}).get("unattributed_pct") or 0.0
        if len(inc) != len(resizes) or shard is None or unattr > 5.0:
            failures.append(f"{len(resizes)} resizes but {len(inc)} elastic_resize incidents; "
                            f"train shard unattributed {unattr}% (limit 5%)")
    # the served tokens
    hops_at: dict[str, int] = {}
    for e in events:
        if e["etype"] == "router_failover":
            hops_at.setdefault(e["rid"], e["tokens_carried"])
    agree, short = {}, []
    for rid, want in refs.items():
        r = results.get(rid)
        got = r.tokens if r is not None else []
        agree[rid] = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                          min(len(got), len(want)))
        if r is not None and r.state.value == "done":
            must = len(want) if exact else hops_at.get(rid, len(want))
            if agree[rid] < must or (exact and got != want):
                short.append(rid)
    if short:
        failures.append(f"tokens part from generate() too early for {short} (leading tokens "
                        f"equal {agree}, first hop at {hops_at})")
    return dict(failures=failures, resizes=len(resizes), unattributed_pct=unattr,
                goodput=None if s is None else s["fleet"].get("goodput_pct"),
                tokens_equal=agree, hops_at=hops_at,
                states={rid: r.state.value for rid, r in results.items()})


def run_pool(pool_cfg, model_cfg, *, device: str = "cuda", chaos: bool = False,
             obs_dir: str = "", seed: int = 0, clock=time.monotonic, sleep=time.sleep,
             around_day=None) -> dict:
    """One day of ``pool_cfg`` over ``GPT(model_cfg, seed)`` (the served
    model) with the checks; the record's ``failures`` lists what failed,
    ``pool`` is the closed :class:`~dtc_tpu_torch.pool.PoolManager`.
    ``around_day`` (a context manager) is entered just before the day's
    first tick and left just after its last."""
    import contextlib

    import torch

    from dtc_tpu_torch.config.schema import ChaosConfig
    from dtc_tpu_torch.models.gpt import GPT
    from dtc_tpu_torch.pool import POOL_TRAIN_PROC, PoolManager
    from dtc_tpu_torch.serve.fleet import reference_tokens
    from dtc_tpu_torch.utils.arrivals import arrival_schedule

    if chaos and not pool_cfg.chaos.enabled:
        pool_cfg = dataclasses.replace(pool_cfg, chaos=ChaosConfig(**EXAMPLE_CHAOS))
    elif not chaos:
        pool_cfg = dataclasses.replace(pool_cfg, chaos=ChaosConfig())
    new_tokens = min(NEW_TOKENS, pool_cfg.router.serve.max_new_tokens)
    cuda = device != "cpu"
    ref = reference_losses(model_cfg, pool_cfg, device, seed)
    model = GPT(model_cfg, device=device, seed=seed)
    _, prompts = arrival_schedule(11, LOW_TRAFFIC + SPIKE_BURST, PROMPT_LEN,
                                  model_cfg.vocab_size, None)
    with tempfile.TemporaryDirectory(prefix="dtc_pool_") as tmp:
        obs = obs_dir or tmp
        pm = PoolManager(model, model_cfg, pool_cfg, obs_dir=obs, seed=seed, clock=clock,
                         sleep=sleep)
        if cuda:
            torch.cuda.synchronize()

        def attempts() -> dict[int, int]:
            return {rep.replica_id: rep.engine.counters["serve_decode_steps"]
                    + rep.engine.counters["serve_retries"] for rep in pm.router.replicas}

        before = attempts()  # the fleet's warm-up decoded already
        with around_day or contextlib.nullcontext():
            day = run_day(pm, prompts, new_tokens)
            if cuda:
                torch.cuda.synchronize()
        day["decode_attempts"] = {rid: n - before.get(rid, 0) for rid, n in attempts().items()}
        day["grow_oracles"] = [dict(to_step=step, loss=loss,
                                    fresh=fresh_restart_loss(pm, snap, seed))
                               for step, loss, snap in day["grow_oracles"]]
        snapshot_bytes = pm.trainer.snapshots.host_bytes()
        commit_s = list(pm.trainer.snapshots.commit_s)
        skipped = pm.trainer.snapshots.skipped
        results = pm.close()
        events = read_events(obs)
        refs = reference_tokens(model, list(pm.requests.values()), {})
        rec = check_pool(pm, day, results, events, ref, refs, obs, chaos,
                         exact=model_cfg.compute_dtype == "float32")
        rec.update(
            day=day,
            transitions=[dict(kind=t.kind, hosts=t.hosts, state=t.state, to_step=t.to_step,
                              used_mirror=t.used_mirror, dead_hosts=t.dead_hosts,
                              abort_reason=t.abort_reason, stage_s=t.stage_s,
                              restore_s=(None if t.t_detect is None
                                         else t.t_restored - t.t_detect))
                         for t in pm.transitions],
            summary=pm.summary(), losses=pm.trainer.losses, reference=ref,
            snapshot_host_bytes=snapshot_bytes, snapshot_commit_s=commit_s,
            snapshots_skipped=skipped, replayed_steps=pm.trainer.replayed,
            restore_s=pm.trainer.restore_s,
            timeshare=timeshare(events, POOL_TRAIN_PROC), requests=len(pm.requests),
            steps_run=sum(e["etype"] == "step" and e.get("proc") == POOL_TRAIN_PROC
                          for e in events),
            pool=pm,
        )
    return rec


def main(argv: list[str] | None = None, *, clock=time.monotonic, sleep=time.sleep) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pool_config_path", default="configs/pool_config.yaml")
    p.add_argument("--model_config_path", default=None,
                   help="default: model_config.yaml beside the pool config")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--chaos", action="store_true",
                   help="the config's documented chaos block: a spike mid-grow and a kill "
                        "of host 1 mid-shrink")
    p.add_argument("--train_steps", type=int, default=None,
                   help="the train budget (default: the config's); a chaos day on "
                        "pool_config.yaml needs about 40 (see the module docstring)")
    p.add_argument("--obs_dir", default="", help="write the pool's event shards here")
    args = p.parse_args(argv)

    import torch

    from dtc_tpu_torch.config.loader import load_pool_config

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (pass --device cpu to run on the CPU)")
    pool_cfg, model_cfg = load_pool_config(
        args.pool_config_path, args.model_config_path,
        pool_overrides=None if args.train_steps is None else {"train_steps": args.train_steps})
    rec = run_pool(pool_cfg, model_cfg, device=args.device, chaos=args.chaos,
                   obs_dir=args.obs_dir, clock=clock, sleep=sleep)
    rec.pop("pool")
    leg = "combined-chaos" if args.chaos else "diurnal"
    for t in rec["transitions"]:
        print(f"[pool] {t['kind']} {t['hosts']}: {t['state']} (to step {t['to_step']}, mirror "
              f"{t['used_mirror']}, dead {t['dead_hosts']}, abort {t['abort_reason']})")
    print(f"[pool] {leg}: {rec['day']['ticks']} ticks, {len(rec['losses'])} train steps, "
          f"{rec['requests']} requests, states {sorted(set(rec['states'].values()))}")
    print(json.dumps(rec, default=str))
    for f in rec["failures"]:
        print(f"[pool] FAIL: {f}", file=sys.stderr)
    return 1 if rec["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
