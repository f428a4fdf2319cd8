"""One eager training step (and the pipeline's), the gradient average over
the ranks of a process group, the routing of ``collectives``, the check
that tensor parallelism's replicated parameters stay equal, the
cross-entropy of the evaluation (logits) path, the held-out eval loss and
the routing of ``precision`` onto the model config.

Under Megatron tensor parallelism a rank's gradients of its slices are
its own, and those of the replicated parameters (LayerNorms, embeddings,
the row-parallel biases) are the same on every rank of the model group
(each forms them from the same replicated activations and reduced
gradients), so nothing is reduced over the model group: the gradients and
the loss are averaged over the data group alone. :func:`replicas_equal`
holds the replicated parameters bit-equal across the model group."""

from __future__ import annotations

import torch

from dtc_tpu_torch.obs.devprof import BWD_SCOPE, scope
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
    # One order on every rank: a set of dtypes iterates by hash, which
    # differs between processes, and the all-reduces must pair up.
    for dtype in sorted({g.dtype for g in grads} | {loss.dtype}, key=str):
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


@torch.no_grad()
def eval_loss(model, x: torch.Tensor, y: torch.Tensor, group=None,
              lora: dict | None = None) -> torch.Tensor:
    """The held-out loss of one batch (the JAX package's
    ``create_eval_step``): the forward with targets, no dropout, no
    update, through the same ``GPT`` (with ``lora`` an adapter's factors:
    base + adapter), so on a card its attention is the flash forward.
    Inside a process group each rank holds an equal share of the batch
    (its rows, or its sequence shard under ring attention) and the losses
    are averaged over ``group`` (the world when None). Returns a device
    tensor (no host sync)."""
    loss = model(x, train=False, targets=y, lora=lora)
    if torch.distributed.is_initialized():
        import torch.distributed as dist

        loss = loss.reshape(1)
        dist.all_reduce(loss, group=group)
        loss = loss[0] / dist.get_world_size(group)
    return loss


def train_step(model, opt, x: torch.Tensor, y: torch.Tensor,
               gen: torch.Generator | None, fsdp=None, group=None,
               average: bool = True, lora: dict | None = None) -> torch.Tensor:
    """Forward with targets (dropout masks from ``gen``), backward, clip,
    AdamW. Inside a process group the gradients and the loss are averaged
    over the ranks of ``group`` (the world when None; nothing when
    ``average`` is false) before the clip (:func:`average_over_ranks`), so
    the clip sees the global norm. Under ``fsdp`` (a
    :class:`~dtc_tpu_torch.parallel.fsdp.FSDP` state) the model computes
    with it in scope and, over a ``DistRing``, the state reduces the
    gradients (sharded ones scaled by 1/R once, whole ones averaged).
    With ``lora`` (an adapter's factors, the optimizer's parameters) the
    model is the frozen base plus the adapter, and only the factors get
    gradients. Returns the loss as a device tensor (no host sync).

    Under a profiler session the forward, the backward and the update run
    in the ranges ``fwd``, :data:`~dtc_tpu_torch.obs.devprof.BWD_SCOPE` and
    ``optimizer`` that the device-time attribution reads."""
    from dtc_tpu_torch.parallel.fsdp import use_fsdp

    with scope("optimizer"):
        opt.zero_grad()
    with use_fsdp(fsdp):
        with scope("fwd"):
            loss = model(x, train=True, targets=y, generator=gen, lora=lora)
        with scope(BWD_SCOPE):
            loss.backward()
    if fsdp is not None and fsdp.distributed:
        loss = fsdp.reduce_gradients(opt.params, loss)
    elif average and torch.distributed.is_initialized():
        loss = average_over_ranks(opt.params, loss, group)
    with scope("optimizer"):
        opt.step()
    return loss.detach()


def pipeline_step(model, opt, x: torch.Tensor, y: torch.Tensor,
                  gen: torch.Generator | None, mesh, rows, group=None,
                  average: bool = True) -> torch.Tensor:
    """:func:`train_step` for a pipeline stage: ``x`` / ``y`` this rank's
    rows, cut into the table's microbatches; the stage's forwards and
    backwards run by :func:`~dtc_tpu_torch.parallel.pipeline.run_schedule`
    under ``rows``; the gradients (and the last stage's loss) averaged over
    ``group`` as :func:`train_step` does; the loss broadcast from the last
    stage over the pipe group, so every rank returns it."""
    import torch.distributed as dist

    from dtc_tpu_torch.parallel.pipeline import run_schedule

    m = 1 + max(j for frow, _ in rows for j, _ in frow)
    opt.zero_grad()
    loss = run_schedule(model, rows, x.chunk(m), y.chunk(m), gen, mesh)
    if average:
        loss = average_over_ranks(opt.params, loss, group)
    loss = loss.reshape(1).clone()
    dist.broadcast(loss, mesh.pipe_ranks[-1], group=mesh.pipe_group)
    opt.step()
    return loss[0]


def replicas_equal(model, tp) -> bool:
    """Do the parameters that tensor parallelism replicates hold the same
    bits on every rank of the model group ``tp``? One broadcast from the
    group's first rank of all of them flattened, compared here, and the
    verdict agreed over the group."""
    import torch.distributed as dist

    from dtc_tpu_torch.parallel.sharding import tp_shard_dim

    mine = [p.detach().reshape(-1) for n, p in model.named_parameters()
            if tp_shard_dim(n) is None]
    flat = torch.cat(mine)
    first = flat.clone()
    dist.broadcast(first, tp.ranks[0], group=tp.group)
    same = torch.tensor([float(torch.equal(first, flat))], device=flat.device)
    dist.all_reduce(same, op=dist.ReduceOp.MIN, group=tp.group)
    return bool(same.item())


def resolve_precision(opt_cfg, model_cfg):
    """``OptimConfig.precision`` routed onto the model config (the JAX
    package's ``resolve_precision``): ``fp32`` passes the model config
    through untouched; ``bf16_mixed`` lifts ``param_dtype`` and
    ``compute_dtype`` to ``bfloat16`` (the LayerNorms, the softmax
    statistics and the loss stay float32 in the model), the float32 masters
    and moments living in the optimizer. A float16 model config raises
    ValueError: float16 would need loss scaling, which neither package
    has."""
    import dataclasses

    if opt_cfg.precision != "bf16_mixed":
        return model_cfg
    if "float16" in (model_cfg.param_dtype, model_cfg.compute_dtype):
        raise ValueError(
            "precision: bf16_mixed cannot combine with a float16 model "
            "config (fp16 would need loss scaling); use bfloat16/float32 "
            "model dtypes and let the policy lift them"
        )
    if model_cfg.param_dtype == model_cfg.compute_dtype == "bfloat16":
        return model_cfg
    return dataclasses.replace(model_cfg, param_dtype="bfloat16", compute_dtype="bfloat16")


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
