"""Command-line entry point of the port's trainer, flag-compatible with the
JAX package's ``main.py``:

    python -m dtc_tpu_torch.main --train_config_path configs/train_config_dp.yaml \\
        --dataset synthetic --no-obs [--steps N] [--output_dir DIR] [--device cpu]

Over several processes, under ``torchrun`` (NCCL on cards, one per rank;
gloo with ``--device cpu``)::

    torchrun --nproc_per_node N -m dtc_tpu_torch.main --train_config_path ... \
        --dataset synthetic --no-obs --output_dir DIR

``--backend gloo --device cuda:0`` runs every rank on one card (NCCL refuses
two ranks on one device); the mesh (``parallel``, ``mesh``) picks data,
tensor or pipeline parallelism as in the JAX package.

The model and optim configs default to the train config's siblings. Runs on
``cuda`` unless ``--device`` names another device. ``--output_dir``
overrides the config's: the trainer refuses to overwrite an existing
``log.csv`` (such as the JAX runs' committed ``outputs/dp/log.csv``).
"""

from __future__ import annotations

import argparse
import os
from dataclasses import replace

from dtc_tpu_torch.config.loader import load_config
from dtc_tpu_torch.train.trainer import train


def main(argv: list[str] | None = None):
    """Parse ``argv`` (the command line by default), train, and return the
    trainer's ``TrainResult``."""
    p = argparse.ArgumentParser(description="Train a GPT with the PyTorch port.")
    p.add_argument("--train_config_path", default="configs/train_config_dp.yaml")
    p.add_argument("--model_config_path", default=None)
    p.add_argument("--optim_config_path", default=None)
    p.add_argument("--steps", type=int, default=None, help="override train steps (smoke runs)")
    p.add_argument("--dataset", default=None, choices=["fineweb", "synthetic"],
                   help="override dataset")
    p.add_argument("--obs", dest="obs", action="store_true", default=None,
                   help="force the telemetry subsystem on (not ported: refused)")
    p.add_argument("--no-obs", dest="obs", action="store_false",
                   help="force the telemetry subsystem off")
    p.add_argument("--output_dir", default=None, help="override output_dir (log.csv)")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="process-group backend under torchrun (default: nccl on cards, "
                        "gloo on the CPU; gloo runs several ranks on one card)")
    args = p.parse_args(argv)

    train_cfg, model_cfg, opt_cfg = load_config(
        args.train_config_path, args.model_config_path, args.optim_config_path
    )
    if args.steps is not None:
        train_cfg = replace(train_cfg, steps=args.steps)
    if args.output_dir is not None:
        train_cfg = replace(train_cfg, output_dir=args.output_dir)
    if args.dataset is not None:
        train_cfg = replace(train_cfg, dataset=args.dataset)
    if args.obs is not None:
        train_cfg = replace(train_cfg, obs=replace(train_cfg.obs, enabled=args.obs))
    if os.environ.get("RANK", "0") == "0":
        print(f"Running `{train_cfg.parallel}` on {args.device or 'cuda'}.")
    return train(train_cfg, model_cfg, opt_cfg, device=args.device, backend=args.backend)


if __name__ == "__main__":
    main()
