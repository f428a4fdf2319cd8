#!/usr/bin/env python3
"""The flagship's training step with elastic training's in-memory snapshots
every step and with none, in turns on one card: none, every step, every
step, none.

    python3 tools/snapshot_turns.py [--steps 30] [--out FILE]

Each turn trains the flagship in this process as ``chip_smoke.py`` phase 7
does (``configs/train_config_dp.yaml`` + ``model_config.yaml``, synthetic
data, bf16 compute, 5 warmup steps, ``log_every`` 5, ``log.csv`` and the
telemetry shard in a temporary directory) with ``resilience.elastic`` on
over 2 virtual hosts: ``snapshot_every`` 1, or one past the run (no
snapshot). Prints each turn's median step time (the synced timed steps)
and the step clock's median ``dispatch_s`` and ``block_s`` (host time
issuing the step against time waiting for the card), the snapshots
committed and skipped, and writes every number to ``--out`` (default
``chiprun_out/snapshot_turns.json``) beside the card's name and power
limit. Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_turn(snapshots: bool, steps: int) -> dict:
    """One turn in this process: ``steps`` timed steps, snapshots every step
    or none."""
    from dtc_tpu_torch.config.loader import load_config
    from dtc_tpu_torch.config.schema import ElasticConfig, ResilienceConfig
    from dtc_tpu_torch.obs import read_jsonl, shard_path
    from dtc_tpu_torch.train.trainer import train

    tcfg, mcfg, ocfg = load_config(ROOT / "configs" / "train_config_dp.yaml")
    el = ElasticConfig(enabled=True, n_virtual_hosts=2, keep=4,
                       snapshot_every=1 if snapshots else steps + 1)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = dataclasses.replace(tcfg, dataset="synthetic", steps=steps, warmup_steps=5,
                                  log_every=5, output_dir=tmp,
                                  resilience=ResilienceConfig(elastic=el))
        t0 = time.perf_counter()
        res = train(cfg, mcfg, ocfg)
        wall = time.perf_counter() - t0
        events = read_jsonl(shard_path(str(Path(tmp) / "obs"), 0))
    step_events = [e for e in events if e["etype"] == "step"]
    snaps = [e for e in events if e["etype"] == "snapshot"]
    return dict(
        snapshots=snapshots, wall_s=wall, losses=res.losses,
        step_ms_median=1e3 * statistics.median(e["step_time_s"] for e in step_events),
        dispatch_ms_median=1e3 * statistics.median(e["dispatch_s"] for e in step_events),
        block_ms_median=1e3 * statistics.median(e["block_s"] for e in step_events),
        commits=len(snaps), skipped=max((e["skipped"] for e in snaps), default=0),
        commit_s=[e["commit_s"] for e in snaps])


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--out", default=str(ROOT / "chiprun_out" / "snapshot_turns.json"))
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("snapshot_turns: no CUDA device is available", file=sys.stderr)
        return 2
    from dtc_tpu_torch.ops import _build

    _build.build_all(["flash_attention_tc"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    turns = []
    for snapshots in (False, True, True, False):
        with contextlib.redirect_stdout(io.StringIO()):
            rec = run_turn(snapshots, args.steps)
        turns.append(rec)
        print(f"snapshot_turns: snapshots {'every step' if snapshots else 'none'}: step "
              f"median {rec['step_ms_median']:.3f} ms (dispatch {rec['dispatch_ms_median']:.3f}, "
              f"block {rec['block_ms_median']:.3f}), {rec['commits']} commits, "
              f"{rec['skipped']} ticks skipped, commit s "
              f"{[round(c, 4) for c in rec['commit_s']]} [{smi}]", flush=True)
    same = all(t["losses"] == turns[0]["losses"] for t in turns)
    print(f"snapshot_turns: losses equal across the turns: {same} [{smi}]")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(dict(card=smi, steps=args.steps, turns=turns,
                                              losses_equal=same), indent=1))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
