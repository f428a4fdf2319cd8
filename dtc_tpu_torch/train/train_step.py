"""One eager training step, the gradient average over the ranks of a
process group, and the cross-entropy of the evaluation (logits) path."""

from __future__ import annotations

import torch

from dtc_tpu_torch.ops.fused_ce import _stats_loss


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy in float32: the same computation as
    the fused head + CE's forward (:func:`~dtc_tpu_torch.ops.fused_ce._stats_loss`)."""
    return _stats_loss(logits, targets)[0]


def average_over_ranks(params, loss: torch.Tensor) -> torch.Tensor:
    """Average every parameter's ``.grad`` and ``loss`` over the world's
    ranks in place: one all-reduce per dtype of a flat buffer. Every rank holds the whole model and a loss that is a mean
    over an equal share of the global batch, so the averages are the
    gradient and the loss of the global mean. Returns the averaged loss."""
    import torch.distributed as dist

    n = dist.get_world_size()
    grads = [p.grad for p in params]
    loss = loss.detach().reshape(1)
    for dtype in {g.dtype for g in grads} | {loss.dtype}:
        mine = [g for g in grads if g.dtype == dtype]
        sizes = [g.numel() for g in mine]
        flat = torch.cat([g.reshape(-1) for g in mine]
                         + ([loss] if loss.dtype == dtype else []))
        dist.all_reduce(flat)
        flat /= n
        parts = torch.split(flat, sizes + [flat.numel() - sum(sizes)])
        if mine:
            torch._foreach_copy_(mine, [p.view_as(g) for p, g in zip(parts, mine)])
        if loss.dtype == dtype:
            # A copy: a view would keep the whole flat buffer alive while
            # the trainer holds the step's loss.
            loss = parts[-1].clone()
    return loss[0]


def train_step(model, opt, x: torch.Tensor, y: torch.Tensor,
               gen: torch.Generator | None) -> torch.Tensor:
    """Forward with targets (dropout masks from ``gen``), backward, clip,
    AdamW. Inside a process group the gradients and the loss are averaged
    over the world's ranks before the clip (:func:`average_over_ranks`), so
    the clip sees the global norm. Returns the loss as a device tensor (no
    host sync)."""
    opt.zero_grad()
    loss = model(x, train=True, targets=y, generator=gen)
    loss.backward()
    if torch.distributed.is_initialized():
        loss = average_over_ranks(opt.params, loss)
    opt.step()
    return loss.detach()
