"""One eager training step on one device, and the cross-entropy of the
evaluation (logits) path."""

from __future__ import annotations

import torch

from dtc_tpu_torch.ops.fused_ce import _stats_loss


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy in float32: the same computation as
    the fused head + CE's forward (:func:`~dtc_tpu_torch.ops.fused_ce._stats_loss`)."""
    return _stats_loss(logits, targets)[0]


def train_step(model, opt, x: torch.Tensor, y: torch.Tensor,
               gen: torch.Generator | None) -> torch.Tensor:
    """Forward with targets (dropout masks from ``gen``), backward, clip,
    AdamW. Returns the loss as a device tensor (no host sync)."""
    opt.zero_grad()
    loss = model(x, train=True, targets=y, generator=gen)
    loss.backward()
    opt.step()
    return loss.detach()
