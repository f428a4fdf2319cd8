"""The training loop: the port's counterpart of the JAX package's
``train/trainer.py`` for a data-parallel or FSDP run, on one device or over
the processes ``torchrun`` starts (:mod:`dtc_tpu_torch.utils.dist`), with
``attention: ring`` sequence parallelism over the mesh's ``model`` axis.

Under ``parallel: fsdp`` in a process group each rank keeps its shard of
every parameter FSDP shards (cut from the full ``GPT(seed)`` init or from
``params``, so the start equals the unsharded run) and trains with the
:class:`~dtc_tpu_torch.parallel.fsdp.FSDP` state over every rank (FSDP
runs with ``model`` and ``pipe`` 1, so the data axis is the world);
``collectives`` (either config; ``train_step.resolve_collectives``) picks
the gathered path or the overlapped ring. ``TrainResult.model`` then holds
the gathered weights. Under ``overlapped`` without a usable FSDP ring the
JAX package's inert warning is printed and every matmul keeps its plain
product.

Under DP every rank holds the whole model. Each draws the
global batch of the JAX package's process 0 (``synthetic_batch_iterator``
from seed ``seed·1000``) and takes its rows (its ``data`` coordinate) and,
under ring attention, its sequence shard (its ``model`` coordinate); the
gradients and the loss are averaged over all ranks after the backward, so
the clip sees the global norm. Rank 0 alone prints and writes ``log.csv``;
tokens/s and MFU count the global batch over every rank's card. Dropout
masks come from a generator seeded ``seed + rank``.

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
from dtc_tpu_torch.resilience.guard import AnomalyGuard
from dtc_tpu_torch.resilience.watchdog import StepWatchdog
from dtc_tpu_torch.train.optimizer import create_optimizer
from dtc_tpu_torch.train.train_step import resolve_collectives, train_step
from dtc_tpu_torch.utils import dist as dist_utils
from dtc_tpu_torch.utils.logging import CSVLogger
from dtc_tpu_torch.utils.metrics import mfu, peak_flops


@dataclass
class TrainResult:
    """``model``: the trained model, whole (under FSDP the shards
    gathered); ``optimizer``: its optimizer (under FSDP over this rank's
    shards)."""

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
        (train_cfg.parallel in ("pp", "none"),
         f"parallel: {train_cfg.parallel} (tensor and pipeline parallelism come after "
         "DP, ring attention and FSDP)"),
        (m.pipe > 1 or train_cfg.pp_microbatches > 1,
         "a pipe axis or pp_microbatches > 1 (pipeline parallelism)"),
        (not ring and (train_cfg.parallel == "tp" or m.model > 1),
         "a model axis without attention: ring (Megatron tensor parallelism)"),
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


def train(
    train_cfg: TrainConfig,
    model_cfg: ModelConfig,
    opt_cfg: OptimConfig,
    *,
    device=None,
    params=None,
) -> TrainResult:
    """Train ``model_cfg`` on ``device`` (``cuda`` unless named; raises
    without a card). The weights come from ``GPT(model_cfg,
    seed=train_cfg.seed)``, or from ``params``, a flax parameter tree of
    numpy arrays carried across by :func:`dtc_tpu_torch.parity.from_flax`.
    Dropout masks come from a generator seeded with ``train_cfg.seed`` plus
    the rank; the synthetic stream from seed ``seed·1000`` (the JAX
    trainer's seed for process 0). Under torchrun's environment the
    process group is joined first (and left at the end, if this call
    joined it) and the mesh spans its ranks."""
    model_cfg = resolve_collectives(train_cfg, model_cfg)
    refuse_unported(train_cfg, model_cfg)
    joined = dist_utils.launched() and not torch.distributed.is_initialized()
    dev = dist_utils.initialize(device) or resolve_device(device)
    try:
        return _train(train_cfg, model_cfg, opt_cfg, resolve_device(dev), params)
    finally:
        if joined:
            dist_utils.teardown()


def _shard(batches, rows: slice, cols: slice):
    """This rank's rows and sequence columns of each ``(B, T+1)`` batch;
    ``cols`` covers its tokens and the next one, the last target."""
    for batch in batches:
        yield batch[rows, cols]


def _train(train_cfg, model_cfg, opt_cfg, dev, params) -> TrainResult:
    cuda = dev.type == "cuda"
    world, rank = dist_utils.world_size(), dist_utils.rank()
    shape = resolve_mesh_shape(train_cfg.parallel, world, train_cfg.mesh,
                               n_layers=model_cfg.n_layers)
    if train_cfg.parallel == "fsdp":
        check_fsdp(shape, model_cfg.attention)
    mesh = Mesh(shape, rank) if world > 1 else None
    _, n_data, n_model = shape
    seq = model_cfg.max_seq_len
    if train_cfg.batch % n_data or seq % n_model:
        raise ValueError(
            f"global batch {train_cfg.batch} and seq len {seq} must divide by the data "
            f"axis {n_data} and the model axis {n_model}"
        )
    lead = dist_utils.is_lead_process()
    model = GPT(model_cfg, device=dev, seed=train_cfg.seed)
    if params is not None:
        from dtc_tpu_torch.parity import from_flax

        model.load_state_dict(from_flax(params, model_cfg))
    fsdp = None
    if train_cfg.parallel == "fsdp" and torch.distributed.is_initialized():
        fsdp = FSDP(DistRing(range(world))).shard_(model)
    opt = create_optimizer(model.parameters(), opt_cfg, total_steps=train_cfg.steps,
                           fsdp=fsdp)
    gen = torch.Generator(device=dev).manual_seed(train_cfg.seed + rank)

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
        rows, t_local = train_cfg.batch // n_data, seq // n_model
        host_it = _shard(host_it, slice(mesh.data_idx * rows, (mesh.data_idx + 1) * rows),
                         slice(mesh.model_idx * t_local, (mesh.model_idx + 1) * t_local + 1))
        if n_model > 1:
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
                loss = train_step(model, opt, x, y, gen, fsdp)
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
                device_losses.append(train_step(model, opt, x, y, gen, fsdp))
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
    say(f"Total time: {result.total_time_s}")
    say("End")
    return result
