"""One eager training step, the gradient average over the ranks of a
process group, the routing of ``collectives``, and the cross-entropy of
the evaluation (logits) path."""

from __future__ import annotations

import torch

from dtc_tpu_torch.ops.fused_ce import _stats_loss


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy in float32: the same computation as
    the fused head + CE's forward (:func:`~dtc_tpu_torch.ops.fused_ce._stats_loss`)."""
    return _stats_loss(logits, targets)[0]


def average_over_ranks(params, loss: torch.Tensor, group=None) -> torch.Tensor:
    """Average every parameter's ``.grad`` and ``loss`` over the ranks of
    ``group`` (the world when None) in place: one all-reduce per dtype of a
    flat buffer. Every rank holds the whole model and a loss that is a mean
    over an equal share of the global batch, so the averages are the
    gradient and the loss of the global mean. Returns the averaged loss."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    grads = [p.grad for p in params]
    loss = loss.detach().reshape(1)
    for dtype in {g.dtype for g in grads} | {loss.dtype}:
        mine = [g for g in grads if g.dtype == dtype]
        sizes = [g.numel() for g in mine]
        flat = torch.cat([g.reshape(-1) for g in mine]
                         + ([loss] if loss.dtype == dtype else []))
        dist.all_reduce(flat, group=group)
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
               gen: torch.Generator | None, fsdp=None) -> torch.Tensor:
    """Forward with targets (dropout masks from ``gen``), backward, clip,
    AdamW. Inside a process group the gradients and the loss are averaged
    over the world's ranks before the clip (:func:`average_over_ranks`), so
    the clip sees the global norm. Under ``fsdp`` (a
    :class:`~dtc_tpu_torch.parallel.fsdp.FSDP` state) the model computes
    with it in scope and, over a ``DistRing``, the state reduces the
    gradients (sharded ones scaled by 1/R once, whole ones averaged).
    Returns the loss as a device tensor (no host sync)."""
    from dtc_tpu_torch.parallel.fsdp import use_fsdp

    opt.zero_grad()
    with use_fsdp(fsdp):
        loss = model(x, train=True, targets=y, generator=gen)
        loss.backward()
    if fsdp is not None and fsdp.distributed:
        loss = fsdp.reduce_gradients(opt.params, loss)
    elif torch.distributed.is_initialized():
        loss = average_over_ranks(opt.params, loss)
    opt.step()
    return loss.detach()


def resolve_collectives(train_cfg, model_cfg):
    """``TrainConfig.collectives`` routed onto the model config (the JAX
    package's ``resolve_collectives``): ``overlapped`` when either config
    says so, and a ValueError for ``overlapped`` under pipeline
    parallelism. The model config comes back unchanged when it already has
    the mode."""
    import dataclasses

    mode = ("overlapped" if "overlapped" in (train_cfg.collectives, model_cfg.collectives)
            else "xla")
    pipe = max(train_cfg.mesh.pipe, 1) * train_cfg.mesh.dcn_pipe
    if mode == "overlapped" and (train_cfg.parallel == "pp" or pipe > 1):
        raise ValueError(
            "collectives: overlapped is not supported under pipeline "
            "parallelism (the FSDP ring's shard_map cannot nest inside "
            "the pipeline's manual region); use a mesh with pipe == 1 — "
            "overlapped composes with DP/FSDP/TP"
        )
    if mode == model_cfg.collectives:
        return model_cfg
    return dataclasses.replace(model_cfg, collectives=mode)
