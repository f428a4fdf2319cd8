#!/usr/bin/env python3
"""The flagship's training step with and without checkpoints and held-out
eval, and against another checkout's trainer (the parent commit), in
turns on one card: parent, this, this with checkpoints and eval, the same
again, this, parent.

    git archive <parent> | tar -x -C build/parent
    python3 tools/checkpoint_turns.py --parent build/parent [--out FILE]

Each turn is a process of its own that imports the port from its checkout
and trains the flagship as ``chip_smoke.py`` phase 7 does
(``configs/train_config_dp.yaml`` + ``model_config.yaml``, synthetic data,
bf16 compute, 5 warmup and 20 timed steps, ``log_every`` 5, ``log.csv`` in
a temporary directory); the turns with checkpoints save and eval every 10
steps (2 eval batches). Prints each turn's median step time (the synced
timed steps; saves and eval lie outside them) and writes every number to
``--out`` (default ``chiprun_out/checkpoint_turns.json``) beside the
card's name and power limit. Needs one CUDA card; exits non-zero without
one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_turn(root: str, checkpoints: bool) -> dict:
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
        over = dict(dataset="synthetic", obs=dataclasses.replace(tcfg.obs, enabled=False),
                    steps=20, warmup_steps=5, log_every=5, output_dir=tmp)
        if checkpoints:
            over.update(checkpoint_every=10, eval_every=10, eval_batches=2,
                        checkpoint_dir=str(Path(tmp) / "ckpt"))
        t0 = time.perf_counter()
        res = train(dataclasses.replace(tcfg, **over), mcfg, ocfg)
        wall = time.perf_counter() - t0
    el = res.elapsed_times
    steps = sorted(b - a for a, b in zip([0.0] + el[:-1], el))
    return dict(step_ms_median=steps[len(steps) // 2] * 1e3, step_ms_min=steps[0] * 1e3,
                wall_s=wall, losses=res.losses, device=torch.cuda.get_device_name(0))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", default="", help="another checkout (the parent commit)")
    p.add_argument("--out", default=str(ROOT / "chiprun_out" / "checkpoint_turns.json"))
    p.add_argument("--turn", nargs=2, metavar=("ROOT", "CHECKPOINTS"), help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.turn:
        print(json.dumps(run_turn(args.turn[0], args.turn[1] == "1")))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("checkpoint_turns: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    parent = str(Path(args.parent).resolve()) if args.parent else None
    this = str(ROOT)
    order = ([("parent", parent, False)] if parent else []) + [
        ("this", this, False), ("this+ckpt+eval", this, True), ("this+ckpt+eval", this, True),
        ("this", this, False)] + ([("parent", parent, False)] if parent else [])
    turns = []
    for name, root, ckpt in order:
        out = subprocess.run([sys.executable, __file__, "--turn", root, "1" if ckpt else "0"],
                             capture_output=True, text=True, cwd=root)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        rec = dict(turn=name, **json.loads(out.stdout.strip().splitlines()[-1]))
        turns.append(rec)
        print(f"{name}: step_ms median {rec['step_ms_median']:.6f} (min "
              f"{rec['step_ms_min']:.6f}), wall {rec['wall_s']:.3f} s [{smi}]", flush=True)
    losses = {json.dumps(t["losses"]) for t in turns}
    print(f"losses equal across the turns: {len(losses) == 1}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(dict(card=smi, turns=turns), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
