#!/usr/bin/env python3
"""The flagship serve of ``chip_smoke.py`` phases 4 and 10 against another
checkout's engine (the parent commit), and with the engine's telemetry on
and off, in turns on one card: parent, this, this+obs, this+obs, this,
parent.

    git archive <parent> | tar -x -C build/parent
    python3 tools/serve_turns.py --parent build/parent [--out FILE]

Each turn is a process of its own that imports the port from its checkout
and serves phase 4's six requests (``configs/serve_config.yaml`` on
``model_config.yaml``, bf16, 64 new tokens each) under ``decode_attention:
fused`` and then ``fused_layers``, each after a warm-up request, with no
telemetry (the engine keeps its own registry, tracer and flight recorder)
or, in the "+obs" turns, a ``Telemetry.for_serving`` into a temporary
directory. A turn reports each backend's mean ms per token, tokens/s, wall
seconds, decode iterations and the watchdog's flags. Then one process
serves ``fused_layers`` under ``cProfile``, bare and with telemetry, and
reports the seconds spent in ``dtc_tpu_torch/obs/`` code entered from
outside it (the engine's spans, events, histograms, goodput, SLO and
flight dumps), by function, beside the profiled wall. The other
checkout's build directory is pointed at this one's, so kernels whose
sources are the same build once. Prints every number beside the card's
name and power limit and writes them to ``--out`` (default
``chiprun_out/serve_turns.json``). Needs one CUDA card; exits non-zero
without one. ``--device cpu --model_config configs/model_config_dev.yaml
--max_seq_len 256`` rehearses it on the CPU (the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MAX_NEW = 64
BACKENDS = ("fused", "fused_layers")


def requests(vocab: int, seed: int):
    """``chip_smoke.flagship_requests``: six prompts of 8-100 tokens, two
    sharing a 16-token system prompt."""
    import numpy as np

    from dtc_tpu_torch.serve import Request

    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, vocab, size=16).tolist()
    reqs = []
    for i, n in enumerate([8, 40, 64, 100, 31, 77]):
        shared = i in (1, 2)
        body = rng.randint(0, vocab, size=n - (16 if shared else 0)).tolist()
        reqs.append(Request(rid=f"r{i}", prompt=(prefix + body) if shared else body,
                            max_new_tokens=MAX_NEW, shared_prefix_len=16 if shared else 0))
    return reqs


def serve_once(root: str, backend: str, device: str, model_config: str, max_seq_len: int,
               obs: bool, profile: bool = False) -> dict:
    """One timed serve of the six requests on a fresh model (seed 0) after
    a warm-up request, with the port of checkout ``root``."""
    import dataclasses
    import tempfile
    import time

    import torch

    from dtc_tpu_torch.config.loader import load_serve_config
    from dtc_tpu_torch.models.gpt import GPT
    from dtc_tpu_torch.serve import Request, ServingEngine

    scfg, mcfg = load_serve_config(Path(root) / "configs" / "serve_config.yaml",
                                   Path(root) / model_config)
    mcfg = dataclasses.replace(mcfg, decode_attention=backend,
                               max_seq_len=max_seq_len or mcfg.max_seq_len)
    model = GPT(mcfg, device=device, seed=0)
    reqs = requests(mcfg.vocab_size, 0)
    warm = ServingEngine(model, scfg)
    warm.submit(Request(rid="warm", prompt=list(reqs[0].prompt), max_new_tokens=4))
    warm.run()
    with tempfile.TemporaryDirectory() as tmp:
        tele = None
        if obs:
            from dtc_tpu_torch.obs import Telemetry

            tele = Telemetry.for_serving(tmp)
        eng = ServingEngine(model, scfg, **({"telemetry": tele} if obs else {}))
        for r in reqs:
            eng.submit(r)
        prof = None
        if profile:
            import cProfile

            prof = cProfile.Profile()
            prof.enable()
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.run()
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if prof is not None:
            prof.disable()
        dumps = len(tele.recorder.dumps) if tele is not None else 0
        counters = dict(eng.counters)
        costs = call_costs(eng) if profile else None
        if tele is not None:
            tele.close()
    n_tok = sum(len(res[r.rid].tokens) for r in reqs)
    rec = dict(backend=backend, obs=obs, wall_s=wall, tokens=n_tok, tokens_per_s=n_tok / wall,
               ms_per_token_mean=sum(res[r.rid].ms_per_token for r in reqs) / len(reqs),
               iterations=counters.get("serve_decode_steps", 0),
               hung_steps=counters.get("serve_hung_steps", 0), flight_dumps=dumps,
               tokens_by_rid={r.rid: list(res[r.rid].tokens) for r in reqs})
    if prof is not None:
        rec["obs_profile"] = dict(obs_seconds(prof), call_us=costs)
    return rec


def call_costs(eng, n: int = 2000) -> dict:
    """Microseconds a call, unprofiled, of the telemetry calls the engine
    makes every iteration, on its own registry, tracer and goodput gauge
    (with telemetry, its JSONL shard written)."""
    import timeit

    gp = eng.goodput
    calls = {
        "decode_step span": lambda: eng.tracer.emit_span(
            "decode_step", 1.0, 2.0, cat="serve", tid="sched", iteration=1, batch=4),
        "counter inc": lambda: eng.reg.counter("serve_decode_steps").inc(),
        "occupancy histogram": lambda: eng.reg.histogram("serve_batch_occupancy").observe(4),
        "bus drain (empty)": eng._drain_bus,
    }
    if gp is not None:
        calls["goodput note"] = lambda: gp.note("productive_decode", 0.002)
        calls["goodput update (every check_every iterations)"] = lambda: gp.update(iteration=8)
    return {k: timeit.timeit(f, number=n) / n * 1e6 for k, f in calls.items()}


def obs_seconds(prof) -> dict:
    """Seconds (under the profiler) spent in ``dtc_tpu_torch/obs/`` code
    called from the engine (``serve/engine.py``), summed over those call
    edges, and the largest entries by function."""
    import pstats

    stats = pstats.Stats(prof).stats
    mark = os.sep + os.path.join("dtc_tpu_torch", "obs") + os.sep
    engine = os.path.join("dtc_tpu_torch", "serve", "engine.py")
    by_fn: dict[str, float] = {}
    calls: dict[str, int] = {}
    for (path, _line, fn), (_cc, _nc, _tt, _ct, callers) in stats.items():
        if mark not in path:
            continue
        for (cpath, _cl, _cfn), edge in callers.items():
            if not cpath.endswith(engine):
                continue
            key = f"{Path(path).name}:{fn}"
            by_fn[key] = by_fn.get(key, 0.0) + edge[3]
            calls[key] = calls.get(key, 0) + edge[1]
    total = sum(by_fn.values())
    top = sorted(by_fn.items(), key=lambda kv: -kv[1])[:12]
    return dict(obs_s=total, top=[dict(fn=k, s=v, calls=calls[k]) for k, v in top])


def run_turn(root: str, obs: bool, profile: bool, args) -> dict:
    sys.path.insert(0, root)
    import torch

    out = dict(serves=[serve_once(root, b, args.device, args.model_config, args.max_seq_len,
                                  obs, profile)
                        for b in (("fused_layers",) if profile else BACKENDS)])
    out["device"] = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", default="", help="another checkout (the parent commit)")
    p.add_argument("--out", default=str(ROOT / "chiprun_out" / "serve_turns.json"))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--model_config", default="configs/model_config.yaml")
    p.add_argument("--max_seq_len", type=int, default=0, help="0: the model config's")
    p.add_argument("--turn", nargs=3, metavar=("ROOT", "OBS", "PROFILE"), help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.turn:
        rec = run_turn(args.turn[0], args.turn[1] == "1", args.turn[2] == "1", args)
        print(json.dumps(rec))
        return 0
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("serve_turns: no CUDA device is available", file=sys.stderr)
            return 2
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip()
        sys.path.insert(0, str(ROOT))
        from dtc_tpu_torch.ops import _build

        # both checkouts' kernels from one build when their sources agree
        _build.build_all(["decode_attention", "decode_fused_bf16_bf16"])
    else:
        smi = "cpu"
    this = str(ROOT)
    parent = str(Path(args.parent).resolve()) if args.parent else None
    if parent and args.device == "cuda":
        theirs = Path(parent) / "build" / "dtc_tpu_torch"
        if not theirs.exists():
            theirs.parent.mkdir(parents=True, exist_ok=True)
            theirs.symlink_to(ROOT / "build" / "dtc_tpu_torch", target_is_directory=True)
    order = ([("parent", parent, False, False)] if parent else []) + [
        ("this", this, False, False), ("this+obs", this, True, False),
        ("this+obs", this, True, False), ("this", this, False, False)] + (
        [("parent", parent, False, False)] if parent else []) + [
        ("this profiled", this, False, True), ("this+obs profiled", this, True, True)]
    turns = []
    for name, root, obs, profile in order:
        cmd = [sys.executable, __file__, "--device", args.device, "--model_config",
               args.model_config, "--max_seq_len", str(args.max_seq_len), "--turn", root, "1" if obs else "0", "1" if profile else "0"]
        out = subprocess.run(cmd, capture_output=True, text=True, cwd=root)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        rec = dict(turn=name, **json.loads(out.stdout.strip().splitlines()[-1]))
        turns.append(rec)
        for s in rec["serves"]:
            line = (f"{name} {s['backend']}: ms/token {s['ms_per_token_mean']:.6f}, tokens/s "
                    f"{s['tokens_per_s']:.3f}, wall {s['wall_s']:.6f} s, {s['iterations']} "
                    f"iterations, hung {s['hung_steps']}, flight dumps {s['flight_dumps']}")
            if "obs_profile" in s:
                op = s["obs_profile"]
                line += (f"; under cProfile the engine's obs calls {op['obs_s']:.6f} s of the "
                         f"wall, {op['obs_s'] / s['iterations'] * 1e6:.1f} us an iteration; top "
                         + ", ".join(f"{t['fn']} {t['s']:.6f} s x{t['calls']}"
                                     for t in op["top"][:6])
                         + "; unprofiled us a call: "
                         + ", ".join(f"{k} {v:.2f}" for k, v in op["call_us"].items()))
            print(f"{line} [{smi}]", flush=True)
    first = {s["backend"]: s["tokens_by_rid"] for s in turns[0]["serves"]}
    same = all(s["tokens_by_rid"] == first[s["backend"]] for t in turns for s in t["serves"])
    print(f"tokens equal across the turns, backend by backend: {same}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(dict(card=smi, turns=turns), indent=1))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
