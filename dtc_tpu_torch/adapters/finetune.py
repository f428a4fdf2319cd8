"""The finetune -> eval gate -> export leg of the adapter loop (the JAX
package's ``dtc_tpu/adapters/finetune.py`` and its CLI,
``scripts/finetune_adapter.py``).

:func:`finetune_adapter` drives a LoRA finetune through the port's trainer
(``dtc_tpu_torch.train.trainer.train``): with ``adapter.rank > 0`` the
trainer's state is the adapter's factors, so checkpoints, resume, the
stream sidecars, the guard's rollback and SIGTERM act on the adapter
alone. The eval-loss gate then decides whether the adapter may ship: one
that made the held-out loss worse than the first eval point's must not
reach the serving engine.

    python -m dtc_tpu_torch.adapters.finetune \\
        --finetune_config configs/finetune_lora.yaml --no-obs --out adapter.npz \\
        [--gate-ratio R] [--no-gate] [--device D] [--output_dir DIR] [--steps N]

``--no-obs`` as in ``python -m dtc_tpu_torch.main``: the config leaves the
telemetry subsystem on, which the port does not have yet (the trainer
refuses it).

Exit status, as the JAX package's CLI: 0 trained, gated and exported; 1
the gate failed (nothing exported unless ``--no-gate``); 2 a config error
(``adapter.rank`` 0, or ``eval_every`` 0 without ``--no-gate``). The
artifact is the JAX package's ``.npz``
(:func:`~dtc_tpu_torch.adapters.lora.save_adapter`), served against the
same base (model config + seed) with ``ServingEngine.load_adapter``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from dtc_tpu_torch.config.schema import ModelConfig, OptimConfig, TrainConfig


@dataclasses.dataclass
class FinetuneOutcome:
    """The trained factors, the frozen base they were trained on (its
    ``state_dict``), the first and last eval losses, the gate's verdict
    and the training losses."""

    adapter: dict[str, torch.Tensor]
    base_params: dict[str, torch.Tensor]
    eval_first: float | None
    eval_final: float | None
    gate_passed: bool
    losses: list

    def meta(self, model_cfg: ModelConfig, train_cfg: TrainConfig) -> dict:
        """The artifact's JSON record, with the JAX package's keys."""
        a = model_cfg.adapter
        return {
            "rank": a.rank,
            "alpha": a.alpha,
            "dropout": a.dropout,
            "target_modules": list(a.target_modules),
            "d_model": model_cfg.d_model,
            "n_layers": model_cfg.n_layers,
            "d_ff": model_cfg.d_ff,
            "steps": train_cfg.steps,
            "seed": train_cfg.seed,
            "eval_first": self.eval_first,
            "eval_final": self.eval_final,
            "gate_passed": self.gate_passed,
        }


def finetune_adapter(train_cfg: TrainConfig, model_cfg: ModelConfig, opt_cfg: OptimConfig,
                     *, gate_ratio: float = 1.0, device=None, params=None,
                     lora=None) -> FinetuneOutcome:
    """Finetune the adapter and judge it by held-out eval loss: the gate
    passes when ``eval_final <= gate_ratio * eval_first + 1e-9``, where
    ``eval_first`` is the first eval point (``eval_every`` steps in, not a
    step-0 eval: B starts at zero, so the adapter starts at the base);
    without eval points (``eval_every`` 0) it does not pass. ``device``,
    ``params`` and ``lora`` go to :func:`~dtc_tpu_torch.train.trainer.train`
    (the base's and the factors' starting values, as flax trees)."""
    if model_cfg.adapter.rank <= 0:
        raise ValueError(
            "finetune_adapter needs an adapter-enabled model "
            "(ModelConfig.adapter.rank > 0)"
        )
    from dtc_tpu_torch.train.trainer import train

    result = train(train_cfg, model_cfg, opt_cfg, device=device, params=params, lora=lora)
    evals = sorted(result.eval_losses)
    first = evals[0][1] if evals else None
    final = evals[-1][1] if evals else None
    passed = bool(evals and final <= gate_ratio * first + 1e-9)
    return FinetuneOutcome(
        adapter={k: v.detach() for k, v in result.adapter.items()},
        base_params=result.base_params, eval_first=first, eval_final=final,
        gate_passed=passed, losses=list(result.losses),
    )


def main(argv: list[str] | None = None) -> int:
    """The CLI; returns the exit status."""
    p = argparse.ArgumentParser(
        description="LoRA finetune: train an adapter on a frozen base, gate it on "
                    "held-out eval loss, export the artifact the serving engine loads.")
    p.add_argument("--finetune_config", default="configs/finetune_lora.yaml",
                   help="TrainConfig YAML with the extra adapter: block")
    p.add_argument("--model_config", default="",
                   help="model config (default: sibling model_config.yaml)")
    p.add_argument("--optim_config", default="",
                   help="optimizer config (default: sibling optim_config.yaml)")
    p.add_argument("--out", default="adapter.npz",
                   help="adapter artifact path (.npz: factors + JSON meta)")
    p.add_argument("--gate-ratio", type=float, default=1.0,
                   help="export only if final eval loss <= ratio * first eval loss")
    p.add_argument("--no-gate", action="store_true",
                   help="export even when the eval gate fails or eval is disabled")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    p.add_argument("--output_dir", default=None,
                   help="override output_dir (log.csv, eval_log.csv, checkpoints)")
    p.add_argument("--steps", type=int, default=None, help="override train steps")
    p.add_argument("--no-obs", action="store_true",
                   help="turn the telemetry subsystem off (not ported: the trainer refuses it)")
    args = p.parse_args(argv)

    from dtc_tpu_torch.adapters.lora import save_adapter
    from dtc_tpu_torch.config.loader import load_finetune_config

    try:
        train_cfg, model_cfg, opt_cfg = load_finetune_config(
            args.finetune_config, args.model_config or None, args.optim_config or None)
    except (ValueError, TypeError, OSError) as e:
        print(f"[finetune] config error: {e}", file=sys.stderr)
        return 2
    if args.output_dir is not None:
        train_cfg = dataclasses.replace(train_cfg, output_dir=args.output_dir)
    if args.steps is not None:
        train_cfg = dataclasses.replace(train_cfg, steps=args.steps)
    if args.no_obs:
        train_cfg = dataclasses.replace(
            train_cfg, obs=dataclasses.replace(train_cfg.obs, enabled=False))
    if model_cfg.adapter.rank <= 0:
        print("[finetune] config error: adapter.rank must be > 0 "
              f"(got {model_cfg.adapter.rank})", file=sys.stderr)
        return 2
    if train_cfg.eval_every <= 0 and not args.no_gate:
        print("[finetune] config error: the eval gate needs eval_every > 0 "
              "(or pass --no-gate to export ungated)", file=sys.stderr)
        return 2

    outcome = finetune_adapter(train_cfg, model_cfg, opt_cfg, gate_ratio=args.gate_ratio,
                               device=args.device)
    print(f"[finetune] eval gate: first={outcome.eval_first} final={outcome.eval_final} "
          f"ratio={args.gate_ratio} -> {'PASS' if outcome.gate_passed else 'FAIL'}")
    if not outcome.gate_passed and not args.no_gate:
        print("[finetune] gate failed — adapter NOT exported (the finetune made "
              "held-out loss worse; tune lr/steps/rank, or --no-gate to export anyway)",
              file=sys.stderr)
        return 1
    save_adapter(args.out, outcome.adapter, outcome.meta(model_cfg, train_cfg))
    print(f"[finetune] adapter exported: {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
