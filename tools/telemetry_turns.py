#!/usr/bin/env python3
"""The flagship's training step with telemetry on and off, and against
another checkout's trainer (the parent commit), in turns on one card:
parent, this (off), this (on), this (on), this (off), parent.

    git archive <parent> | tar -x -C build/parent
    python3 tools/telemetry_turns.py --parent build/parent [--out FILE]

Each turn is a process of its own that imports the port from its checkout
and trains the flagship as ``chip_smoke.py`` phase 26 does
(``configs/train_config_dp.yaml`` + ``model_config.yaml``, synthetic data,
bf16 compute, the config's warmup, 40 timed steps, ``log.csv`` in a
temporary directory); the "on" turns leave the config's telemetry on (its
JSONL shard, spans, flight recorder, goodput gauge; no device-profile
window), the others turn it off. Prints each turn's median step time (the
synced timed steps) and, for the "on" turns, the step clock's median split
(data_wait, dispatch, block, other), and writes every number to ``--out``
(default ``chiprun_out/telemetry_turns.json``) beside the card's name and
power limit. Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STEPS = 40


def run_turn(root: str, obs: bool) -> dict:
    """One turn, in this process, with the port of checkout ``root``."""
    import dataclasses
    import tempfile
    import time

    sys.path.insert(0, root)
    import torch

    from dtc_tpu_torch.config.loader import load_config
    from dtc_tpu_torch.train.trainer import train

    tcfg, mcfg, ocfg = load_config(Path(root) / "configs" / "train_config_dp.yaml")
    with tempfile.TemporaryDirectory() as tmp:
        over = dict(dataset="synthetic", steps=STEPS, output_dir=tmp)
        if not obs:
            over["obs"] = dataclasses.replace(tcfg.obs, enabled=False)
        t0 = time.perf_counter()
        res = train(dataclasses.replace(tcfg, **over), mcfg, ocfg)
        wall = time.perf_counter() - t0
        split = None
        if obs:
            from dtc_tpu_torch.obs import read_jsonl, shard_path

            steps = [e for e in read_jsonl(shard_path(str(Path(tmp) / "obs"), 0))
                     if e["etype"] == "step"]
            split = {k: sorted(e[k] for e in steps)[len(steps) // 2] for k in
                     ("data_wait_s", "dispatch_s", "block_s", "other_s", "step_time_s")}
    el = res.elapsed_times
    steps = sorted(b - a for a, b in zip([0.0] + el[:-1], el))
    return dict(step_ms_median=steps[len(steps) // 2] * 1e3, step_ms_min=steps[0] * 1e3,
                wall_s=wall, losses=res.losses, split_s=split,
                device=torch.cuda.get_device_name(0))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", default="", help="another checkout (the parent commit)")
    p.add_argument("--out", default=str(ROOT / "chiprun_out" / "telemetry_turns.json"))
    p.add_argument("--turn", nargs=2, metavar=("ROOT", "OBS"), help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.turn:
        print(json.dumps(run_turn(args.turn[0], args.turn[1] == "1")))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("telemetry_turns: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    parent = str(Path(args.parent).resolve()) if args.parent else None
    this = str(ROOT)
    order = ([("parent", parent, False)] if parent else []) + [
        ("this", this, False), ("this+obs", this, True), ("this+obs", this, True),
        ("this", this, False)] + ([("parent", parent, False)] if parent else [])
    turns = []
    for name, root, obs in order:
        out = subprocess.run([sys.executable, __file__, "--turn", root, "1" if obs else "0"],
                             capture_output=True, text=True, cwd=root)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        rec = dict(turn=name, **json.loads(out.stdout.strip().splitlines()[-1]))
        turns.append(rec)
        split = ""
        if rec["split_s"]:
            split = ", split (median s) " + ", ".join(
                f"{k[:-2]} {v:.6f}" for k, v in rec["split_s"].items())
        print(f"{name}: step_ms median {rec['step_ms_median']:.6f} (min "
              f"{rec['step_ms_min']:.6f}), wall {rec['wall_s']:.3f} s{split} [{smi}]",
              flush=True)
    losses = {json.dumps(t["losses"]) for t in turns}
    print(f"losses equal across the turns: {len(losses) == 1}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(dict(card=smi, turns=turns), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
