"""The training loop: the port's counterpart of the JAX package's
``train/trainer.py`` for a data-parallel, tensor-parallel, pipelined or
FSDP run, on one device or over the processes ``torchrun`` starts
(:mod:`dtc_tpu_torch.utils.dist`), with ``attention: ring`` sequence
parallelism over the mesh's ``model`` axis.

On a ``(pipe, data, model)`` mesh without FSDP: a ``model`` axis without
ring attention is Megatron tensor parallelism (each rank holds its slice
of the heads, the MLP and the vocab, :mod:`dtc_tpu_torch.parallel.tensor`);
a ``pipe`` axis is pipeline parallelism (each rank holds its stage's
chunks, :mod:`dtc_tpu_torch.parallel.pipeline`), stepped by the table of
``pp_schedule`` over ``pp_microbatches`` (GPipe, or 1F1B with
``pp_virtual_stages`` chunks a stage); with ``pipe`` 1 the step is the
plain one, as in the JAX package. Every rank starts from the one-process
model's weights, sliced. The gradients and the loss are averaged over the
data group only; the clip's norm is the whole model's
(:class:`~dtc_tpu_torch.train.optimizer.NormGroups`); after the last step
the parameters tensor parallelism replicates must be bit-equal across the
model group (:func:`~dtc_tpu_torch.train.train_step.replicas_equal`).

Under ``parallel: fsdp`` in a process group each rank keeps its shard of
every parameter FSDP shards (cut from the full ``GPT(seed)`` init or from
``params``, so the start equals the unsharded run) and trains with the
:class:`~dtc_tpu_torch.parallel.fsdp.FSDP` state over the data group of
its model index (``pipe`` 1). A ``model`` axis is Megatron tensor
parallelism (DP×FSDP×TP, the JAX package's "3d" mode: the shards are cut
from the rank's Megatron slices) or, under ``attention: ring``, the ring's
sequence shards (the gradients and the loss averaged over it as well, the
dense sites on the serialized path as the ring's rules say);
``collectives`` (either config; ``train_step.resolve_collectives``) picks
the gathered path or the overlapped ring. ``TrainResult.model`` then holds
the gathered weights (under TP this rank's slice). Under ``overlapped``
without a usable FSDP ring the JAX package's inert warning is printed and
every matmul keeps its plain product.

Under DP every rank holds the whole model. Each draws the
global batch of the JAX package's process 0 (``synthetic_batch_iterator``
from seed ``seed·1000``) and takes its rows (its ``data`` coordinate) and,
under ring attention, its sequence shard (its ``model`` coordinate); the
gradients and the loss are averaged over all ranks after the backward, so
the clip sees the global norm. Rank 0 alone prints and writes ``log.csv``;
tokens/s and MFU count the global batch over every rank's card. Dropout
masks come from a generator seeded ``seed`` plus the rank's index over the
``(pipe, data)`` axes, the same on every rank of a model group (the
activations dropout acts on are replicated there), or plus the rank under
ring attention (whose model axis holds sequence shards). Under a pipeline
rank ``d`` of the data axis takes a ``1/data`` slice of each of the global
batch's ``pp_microbatches`` microbatches (the JAX package's
``(microbatch, batch)`` split); the first stage reads the inputs and the
last the targets.

Measurement protocol as in the JAX package (and its reference):
``warmup_steps`` untimed steps that are real updates on the first batches,
then the timed loop, whose step 1 consumes the next batch. Losses are
fetched at log boundaries only (one stacked transfer per window), where the
anomaly guard judges them, ``log.csv`` gets the window's rows
(``step, elapsed_time, loss``, ``elapsed_time`` cumulative from the start
of the timed loop) and tokens/s and MFU are printed. ``sync_every_step:
None`` syncs the device after every step whenever a ``log.csv`` is written,
so each row's time is a completed step.

What the port has not ported raises ``NotImplementedError`` naming the
slice it waits for (:func:`refuse_unported`).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field

import torch

from dtc_tpu_torch.config.schema import ModelConfig, OptimConfig, TrainConfig
from dtc_tpu_torch.data.prefetch import PrefetchIterator
from dtc_tpu_torch.data.synthetic import synthetic_batch_iterator
from dtc_tpu_torch.models.gpt import GPT, resolve_device
from dtc_tpu_torch.ops.ring_attention import DistRing, use_ring
from dtc_tpu_torch.parallel import sharding
from dtc_tpu_torch.parallel.fsdp import FSDP
from dtc_tpu_torch.parallel.mesh import AXIS_NAMES, Mesh, check_fsdp, resolve_mesh_shape
from dtc_tpu_torch.parallel.pipeline import StageLayout, schedule_rows
from dtc_tpu_torch.parallel.tensor import TensorParallel
from dtc_tpu_torch.resilience.guard import AnomalyGuard
from dtc_tpu_torch.resilience.watchdog import StepWatchdog
from dtc_tpu_torch.train.optimizer import NormGroups, create_optimizer
from dtc_tpu_torch.train.train_step import (
    pipeline_step, replicas_equal, resolve_collectives, train_step,
)
from dtc_tpu_torch.utils import dist as dist_utils
from dtc_tpu_torch.utils.logging import CSVLogger
from dtc_tpu_torch.utils.metrics import mfu, peak_flops


@dataclass
class TrainResult:
    """``model``: the trained model, whole (under FSDP the shards
    gathered; under tensor or pipeline parallelism this rank's slice,
    which ``parity.gather_tp`` / ``gather_stages`` put together);
    ``optimizer``: its optimizer (under FSDP over this rank's shards)."""

    model: GPT
    optimizer: object
    losses: list[float] = field(default_factory=list)
    elapsed_times: list[float] = field(default_factory=list)
    total_time_s: float = 0.0


def refuse_unported(train_cfg: TrainConfig, model_cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for every setting that asks for a part
    of the JAX trainer the port does not have yet, naming where it waits;
    ``ValueError`` for ring attention under pipeline parallelism, which the
    JAX trainer refuses too."""
    m = train_cfg.mesh
    ring = model_cfg.attention == "ring"
    if ring and (m.pipe > 1 or train_cfg.parallel == "pp"):
        raise ValueError(
            "attention='ring' (sequence parallelism) cannot run under "
            "pipeline parallelism; use a mesh with pipe=1 (ring "
            "composes with the data axis) or attention='ulysses'"
        )
    refusals = [
        (train_cfg.parallel == "none", "parallel: none"),
        ((m.dcn_pipe, m.dcn_data, m.dcn_model) != (1, 1, 1),
         "dcn mesh factors (multi-host)"),
        (train_cfg.dataset == "fineweb",
         "dataset: fineweb (waits for a dataset in the repository; use "
         "--dataset synthetic)"),
        (train_cfg.checkpoint_every > 0, "checkpoint_every > 0 (checkpoints)"),
        (train_cfg.eval_every > 0, "eval_every > 0 (held-out eval, with checkpoints)"),
        (train_cfg.obs.enabled,
         "obs.enabled (telemetry, obs/); pass --no-obs or obs: {enabled: false}"),
        (train_cfg.profile_start or train_cfg.profile_stop,
         "profile_start/profile_stop (profiler windows, with obs/)"),
        (train_cfg.slo.any_objective, "SLO objectives (with obs/)"),
        (train_cfg.resilience.chaos.enabled, "resilience.chaos (fault injection)"),
        (train_cfg.resilience.elastic.enabled,
         "resilience.elastic (elastic training)"),
        (train_cfg.resilience.guard.skip_nonfinite_updates,
         "resilience.guard.skip_nonfinite_updates (with checkpoints)"),
        (train_cfg.multihost, "multihost (one host's torchrun processes only)"),
        (train_cfg.debug_nans, "debug_nans"),
    ]
    for refused, what in refusals:
        if refused:
            raise NotImplementedError(f"the PyTorch port does not train with {what} yet")
    if train_cfg.parallel == "fsdp":
        check_fsdp((max(m.pipe, 1), 1, max(m.model, 1)))


def train(
    train_cfg: TrainConfig,
    model_cfg: ModelConfig,
    opt_cfg: OptimConfig,
    *,
    device=None,
    params=None,
    backend: str | None = None,
) -> TrainResult:
    """Train ``model_cfg`` on ``device`` (``cuda`` unless named; raises
    without a card). The weights come from ``GPT(model_cfg,
    seed=train_cfg.seed)``, or from ``params``, a flax parameter tree of
    numpy arrays carried across by :func:`dtc_tpu_torch.parity.from_flax`
    (each rank keeps its slice). Dropout masks come from a generator seeded
    with ``train_cfg.seed`` plus the rank's ``(pipe, data)`` index (see the
    module docstring); the synthetic stream from seed ``seed·1000`` (the
    JAX trainer's seed for process 0). Under torchrun's environment the
    process group is joined first, over ``backend`` (NCCL on cards and gloo
    on the CPU unless named; gloo runs several ranks on one card), and left
    at the end if this call joined it; the mesh spans its ranks."""
    model_cfg = resolve_collectives(train_cfg, model_cfg)
    refuse_unported(train_cfg, model_cfg)
    joined = dist_utils.launched() and not torch.distributed.is_initialized()
    dev = dist_utils.initialize(device, backend) or resolve_device(device)
    try:
        return _train(train_cfg, model_cfg, opt_cfg, resolve_device(dev), params)
    finally:
        if joined:
            dist_utils.teardown()


def _shard(batches, rows, cols: slice):
    """This rank's rows (a slice or an index list) and sequence columns of
    each ``(B, T+1)`` batch; ``cols`` covers its tokens and the next one,
    the last target."""
    for batch in batches:
        yield batch[rows, cols]


def _rows(batch: int, n_data: int, data_idx: int, microbatches: int):
    """This data rank's rows of the global batch: a contiguous ``1/data``
    of it, or under a pipeline that slice of each microbatch (microbatch
    ``j`` being the global rows ``[j·B/M, (j+1)·B/M)``), in microbatch
    order."""
    per = batch // (n_data * microbatches)
    if microbatches == 1:
        return slice(data_idx * per, (data_idx + 1) * per)
    mb = batch // microbatches
    return [j * mb + data_idx * per + i for j in range(microbatches) for i in range(per)]


def _train(train_cfg, model_cfg, opt_cfg, dev, params) -> TrainResult:
    cuda = dev.type == "cuda"
    world, rank = dist_utils.world_size(), dist_utils.rank()
    shape = resolve_mesh_shape(train_cfg.parallel, world, train_cfg.mesh,
                               n_layers=model_cfg.n_layers)
    if train_cfg.parallel == "fsdp":
        check_fsdp(shape)
    mesh = Mesh(shape, rank) if world > 1 else None
    n_pipe, n_data, n_model = shape
    seq = model_cfg.max_seq_len
    ring_attn = model_cfg.attention == "ring"
    micro = train_cfg.pp_microbatches if n_pipe > 1 else 1
    if train_cfg.batch % (n_data * micro) or ring_attn and seq % n_model:
        raise ValueError(
            f"global batch {train_cfg.batch} must divide by the data axis {n_data} x "
            f"{micro} microbatches, and under ring attention seq len {seq} by the model "
            f"axis {n_model}"
        )
    lead = dist_utils.is_lead_process()
    tp = (TensorParallel(mesh.model_ranks, mesh.model_group)
          if n_model > 1 and not ring_attn else None)
    layout = (StageLayout(mesh.pipe_idx, n_pipe, train_cfg.pp_virtual_stages)
              if n_pipe > 1 else None)
    model = GPT(model_cfg, device=dev, seed=train_cfg.seed, tp=tp, stage=layout)
    if params is not None:
        from dtc_tpu_torch.parity import from_flax

        model.load_state_dict(model.local_state(from_flax(params, model_cfg)))
    fsdp = None
    if (train_cfg.parallel == "fsdp" and torch.distributed.is_initialized()
            and (mesh is None or n_data > 1)):
        # The FSDP ring: the data group of this rank's model index (the
        # world of one process without a mesh).
        ring = (DistRing(range(world)) if mesh is None
                else DistRing(mesh.data_ranks, mesh.data_group))
        seq_group = mesh.model_group if ring_attn and n_model > 1 else None
        fsdp = FSDP(ring, seq_group).shard_(model)
    norm_groups = None
    if model.sharded:
        norm_groups = NormGroups(
            [tp is not None and sharding.tp_shard_dim(n) is not None
             for n, p in model.named_parameters() if p.requires_grad],
            model=None if tp is None else tp.group, pipe=mesh.pipe_group)
    opt = create_optimizer(model.parameters(), opt_cfg, total_steps=train_cfg.steps,
                           fsdp=fsdp, norm_groups=norm_groups)
    seed_idx = rank if mesh is None or ring_attn else mesh.pipe_idx * n_data + mesh.data_idx
    gen = torch.Generator(device=dev).manual_seed(train_cfg.seed + seed_idx)
    # The gradient average: over the world for DP and ring attention (whose
    # model axis shards the sequence), over the data group once a model or
    # pipe axis holds slices of the model, and none with one data rank.
    group, average = None, True
    if model.sharded:
        group, average = mesh.data_group, n_data > 1
    if layout is not None:
        rows_table = schedule_rows(train_cfg.pp_schedule, micro, n_pipe,
                                   train_cfg.pp_virtual_stages)

        def step_fn(x, y):
            return pipeline_step(model, opt, x, y, gen, mesh, rows_table, group, average)
    else:
        def step_fn(x, y):
            return train_step(model, opt, x, y, gen, fsdp, group, average)

    log_path = os.path.join(train_cfg.output_dir, "log.csv")
    if (lead and train_cfg.output_dir and not train_cfg.overwrite
            and os.path.exists(log_path)):
        raise ValueError(
            f"refusing to overwrite existing {log_path} on a fresh run; pass "
            "overwrite: true or pick another output_dir"
        )
    host_it = synthetic_batch_iterator(
        train_cfg.batch, seq + 1, model_cfg.vocab_size, seed=train_cfg.seed * 1000
    )
    ring = contextlib.nullcontext()
    if mesh is not None:
        t_local = seq // n_model if ring_attn else seq
        t_idx = mesh.model_idx if ring_attn else 0
        host_it = _shard(host_it, _rows(train_cfg.batch, n_data, mesh.data_idx, micro),
                         slice(t_idx * t_local, (t_idx + 1) * t_local + 1))
        if n_model > 1 and ring_attn:
            ring = use_ring(DistRing(mesh.model_ranks, mesh.model_group))
    data_it = PrefetchIterator(host_it, dev, depth=train_cfg.prefetch)
    csv = CSVLogger(log_path) if train_cfg.output_dir and lead else None
    res_cfg = train_cfg.resilience
    guard = AnomalyGuard(res_cfg.guard) if res_cfg.guard.enabled else None
    wd = StepWatchdog(res_cfg.watchdog) if res_cfg.watchdog.enabled else None
    sync_every_step = train_cfg.sync_every_step
    if sync_every_step is None:
        sync_every_step = bool(train_cfg.output_dir)
    peak = peak_flops(dev)
    peak = peak * world if peak is not None else None
    tokens_per_step = train_cfg.batch * seq
    result = TrainResult(model=model, optimizer=opt)
    say = print if lead else (lambda *a, **k: None)

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize(dev)

    say(f"[dtc_tpu_torch] strategy={train_cfg.parallel} device={dev}"
        + (f" ({torch.cuda.get_device_name(dev)})" if cuda else "")
        + (f" mesh={dict(zip(AXIS_NAMES, shape))} processes={world}"
           if torch.distributed.is_initialized() else ""))
    rules = sharding.FSDP_RULES if train_cfg.parallel == "fsdp" else sharding.DEFAULT_RULES
    if model_cfg.attention == "ring":
        rules = sharding.ring_rules_from(rules)
    if (model_cfg.collectives == "overlapped"
            and sharding.fsdp_axis(rules, dict(zip(AXIS_NAMES, shape))) is None):
        say("[dtc_tpu_torch] WARNING: collectives: overlapped is inert on this run — "
            "no usable FSDP ring in scope (the active rules don't shard 'embed_p', its "
            "mesh axis is size 1, or sequence-parallel rules own the activations); every "
            "matmul keeps its plain product")
    try:
        with ring:
            if train_cfg.warmup_steps:
                say("Warmup")
            for _ in range(train_cfg.warmup_steps):
                x, y = next(data_it)
                loss = step_fn(x, y)
            if train_cfg.warmup_steps:
                float(loss)  # wait for the warmup updates

            if wd is not None and threading.current_thread() is threading.main_thread():
                wd.start()
            say("Start measuring")
            device_losses: list[torch.Tensor] = []
            pending: list[tuple[int, float]] = []
            start = window_start = prev = time.perf_counter()
            window_steps = 0
            for step in range(1, train_cfg.steps + 1):
                if wd is not None:
                    wd.arm(step)
                x, y = next(data_it)
                device_losses.append(step_fn(x, y))
                if sync_every_step:
                    sync()
                now = time.perf_counter()
                result.elapsed_times.append(now - start)
                pending.append((step, now - start))
                if wd is not None:
                    flag = wd.observe(step, now - prev)
                    if flag is not None:
                        say(f"[dtc_tpu_torch] hung step: {flag}")
                prev = now
                window_steps += 1
                if step % train_cfg.log_every and step != train_cfg.steps:
                    continue
                losses = torch.stack(device_losses).tolist()  # the window's one sync
                now = time.perf_counter()
                if not sync_every_step:
                    # Rows were stamped at dispatch: re-stamp the window's last
                    # one now that its work is done.
                    pending[-1] = (pending[-1][0], now - start)
                    result.elapsed_times[-1] = now - start
                if guard is not None:
                    decision = guard.check_window(step, losses)
                    if decision.anomalous:
                        say(f"[dtc_tpu_torch] ANOMALY: {decision.reason} -> {decision.action}")
                result.losses.extend(losses)
                if csv is not None:
                    for (s, el), lo in zip(pending, losses):
                        csv.log(step=s, elapsed_time=el, loss=lo)
                    csv.flush()
                avg = (now - window_start) / max(window_steps, 1)
                msg = (f"Step: {step} | Avg loss: {sum(losses) / len(losses):.4f} | "
                       f"Average step time: {avg:.4f} | tokens/s: {tokens_per_step / avg:,.0f}")
                u = mfu(model_cfg, train_cfg.batch, seq, avg, peak)
                if u is not None:
                    msg += f" | MFU: {u * 100:.1f}%"
                say(msg)
                device_losses, pending = [], []
                window_start, window_steps = time.perf_counter(), 0
    finally:
        if wd is not None:
            wd.stop()
        data_it.close()
        if csv is not None:
            csv.close()
    result.total_time_s = time.perf_counter() - start
    if fsdp is not None:
        result.model = fsdp.gathered(model)
    if tp is not None and not replicas_equal(model, tp):
        raise RuntimeError(
            "the parameters tensor parallelism replicates drifted apart across the model "
            f"group {tp.ranks}")
    say(f"Total time: {result.total_time_s}")
    say("End")
    return result
