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

Checkpoints (``checkpoint_every``), resume, held-out eval
(``eval_every``), the guard's rollback and SIGTERM run in one process,
under DP and under DP with ring attention, where every rank holds the
whole model and its optimizer state (under tensor or pipeline parallelism
and FSDP they raise ``NotImplementedError``, :func:`refuse_sharded_state`).
A checkpoint is labelled with the loop step and holds the parameters, the
optimizer's moments and count (the warmup updates included) and skip
counters (written by rank 0) and every rank's dropout-generator state
(each rank its own): the generator's state is what lets a resumed or
rolled-back run draw the masks the uninterrupted run draws, where the JAX
package derives its keys from the step. A resume restores the newest
intact step and skips warmup; the stream is positioned after the
``warmup_steps + step`` batches the run consumed (the synthetic stream by
seeking, FineWeb by its checkpointed position). The guard's rollback is a
resume without the restart: the newest verified step is restored, the
stream re-seeked, and the window's healthy prefix committed, so the losses
equal the clean run's. A save whose loss is unhealthy is skipped.
Held-out eval runs ``eval_batches`` batches of the synthetic stream at
``seed_offset=500`` (FineWeb: every ``eval_holdout_every``-th batch of the
stream's head, withheld from training) at ``eval_every`` and the last
step into ``eval_log.csv``, its time kept out of ``elapsed_time``. SIGTERM
on the main thread checkpoints at the step it lands in, flushes the CSV
and returns. ``host_iterator`` (a caller's batches) cannot be re-seeked,
so it disables the rollback.

Measurement protocol as in the JAX package (and its reference):
``warmup_steps`` untimed steps that are real updates on the first batches,
then the timed loop, whose step 1 consumes the next batch. Losses are
fetched at log boundaries only (one stacked transfer per window), where the
anomaly guard judges them, ``log.csv`` gets the window's rows
(``step, elapsed_time, loss``, ``elapsed_time`` cumulative from the start
of the timed loop) and tokens/s and MFU are printed. ``sync_every_step:
None`` syncs the device after every step whenever a ``log.csv`` is written,
so each row's time is a completed step.

``precision: bf16_mixed`` (the optim config's) lifts the model's
parameter and compute dtypes to bfloat16 through
:func:`~dtc_tpu_torch.train.train_step.resolve_precision` before the model
is built; the optimizer keeps float32 masters, which ride in the
checkpoint. A LoRA finetune (``adapter.rank > 0``, the JAX package's
``init_adapter_state``) trains the adapter's factors alone: the base is
built from ``seed`` (or ``params``) and frozen (no ``.grad``, no optimizer
slot, never written to disk, built again on resume), the optimizer runs
over the factors, a checkpoint holds the factors, their optimizer state
and every rank's generator, eval runs base + adapter, and
``TrainResult.base_params`` / ``adapter`` hand the pair on to the export
(:mod:`dtc_tpu_torch.adapters.finetune`).

Telemetry (:class:`~dtc_tpu_torch.obs.telemetry.Telemetry`, built after
the clobber guard and before warmup, obs on or off) is the JAX trainer's:
``log.csv`` and ``eval_log.csv`` are its CSV sinks; with ``obs`` on each
rank writes its event shard (the step clock's ``data_wait`` / ``dispatch``
/ ``block`` split of every timed step, windows, eval, memory, spans, SLO
breaches, anomalies, recoveries, hung steps) and rank 0 the cross-process
``summary.json``; the flight recorder dumps on an anomaly, a hung step,
SIGTERM and a crash; profiler windows (``profile_start``/``profile_stop``,
the watchdog's ``profile_on_flag``) and device-profile captures
(``obs.devprof_every``, an SLO breach, a hung step) run
``torch.profiler``. It adds no device sync.

Recovery actions that fire where there is no telemetry handle (the
FineWeb stream's retry on the prefetch thread, a checkpoint fallback)
post to a :class:`~dtc_tpu_torch.resilience.events.RecoveryBus`, drained
into the event stream at the rollback, the log boundaries, a SIGTERM, an
abort and the run's end. ``resilience.chaos`` builds a
:class:`~dtc_tpu_torch.resilience.chaos.ChaosInjector` on that bus and
consults it on the production paths: its data faults inside the FineWeb
stream's retry wrapper, the NaN poison of the trainable parameters and
the loss after the update of ``nan_at_step``, a real SIGTERM at
``sigterm_at_step``, and the damage of the checkpoint written at
``corrupt_ckpt_at_step`` (by the lead, after its manifest). Under DP every
rank holds an injector and poisons at the same step.

``resilience.elastic`` (one process, synthetic data, pipe 1, no LoRA;
:func:`elastic_layout`) splits virtual devices into virtual hosts
(:mod:`dtc_tpu_torch.resilience.elastic`): every live host beats each step
(chaos may kill one, slow one, or drop its snapshot memory first), the
hot tier snapshots the parameters, the optimizer state and the dropout
generator on ``snapshot_every``'s cadence without a host sync
(:mod:`dtc_tpu_torch.resilience.snapshot`), and a host declared lost
shrinks the virtual mesh: the newest complete snapshot is restored through
the ring mirror (the cold tier when none survives), the row stream
re-seeked, the window's healthy prefix committed, the restored state
spilled to disk, and the loop replays. This process computes the whole
global batch on any mesh, so the replay's losses are the uninterrupted
run's bit for bit. The guard's rollback takes the hot tier below the last
healthy boundary first; ``elastic.cold_every`` slows the disk cadence.

What the port has not ported raises ``NotImplementedError`` naming the
slice it waits for (:func:`refuse_unported`, :func:`refuse_sharded_state`).
"""

from __future__ import annotations

import contextlib
import os
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np
import torch

from dtc_tpu_torch.config.schema import ModelConfig, OptimConfig, TrainConfig
from dtc_tpu_torch.data.holdout import divert_holdout, diverted_indices, stream_index_for
from dtc_tpu_torch.data.prefetch import PrefetchIterator, split_to_device
from dtc_tpu_torch.data.synthetic import synthetic_batch_iterator, synthetic_row_batches
from dtc_tpu_torch.models.gpt import GPT, resolve_device
from dtc_tpu_torch.obs.telemetry import Telemetry
from dtc_tpu_torch.ops.ring_attention import DistRing, use_ring
from dtc_tpu_torch.parallel import sharding
from dtc_tpu_torch.parallel.fsdp import FSDP
from dtc_tpu_torch.parallel.mesh import AXIS_NAMES, Mesh, check_fsdp, resolve_mesh_shape
from dtc_tpu_torch.parallel.pipeline import StageLayout, schedule_rows
from dtc_tpu_torch.parallel.tensor import TensorParallel
from dtc_tpu_torch.resilience.chaos import ChaosInjector
from dtc_tpu_torch.resilience.elastic import (
    DEFAULT_VIRTUAL_DEVICES, HostMonitor, VirtualHosts, VirtualMesh, resize_mesh,
)
from dtc_tpu_torch.resilience.errors import AnomalyAbort, ElasticAbort, SnapshotIncompleteError
from dtc_tpu_torch.resilience.events import RecoveryBus
from dtc_tpu_torch.resilience.guard import AnomalyGuard
from dtc_tpu_torch.resilience.snapshot import SnapshotStore, load_train_state, train_state
from dtc_tpu_torch.resilience.watchdog import StepWatchdog
from dtc_tpu_torch.train.optimizer import NormGroups, create_optimizer
from dtc_tpu_torch.train.train_step import (
    eval_loss, pipeline_step, replicas_equal, resolve_collectives, resolve_precision,
    train_step,
)
from dtc_tpu_torch.utils import dist as dist_utils
from dtc_tpu_torch.utils.checkpoint import CheckpointManager
from dtc_tpu_torch.utils.logging import FIELDS
from dtc_tpu_torch.utils.metrics import comm_bytes_per_step, gpt_step_flops, mfu, peak_flops


@dataclass
class TrainResult:
    """``model``: the trained model, whole (under FSDP the shards
    gathered; under tensor or pipeline parallelism this rank's slice,
    which ``parity.gather_tp`` / ``gather_stages`` put together);
    ``optimizer``: its optimizer (under FSDP over this rank's shards);
    ``mesh``: under elastic training the virtual mesh the run ended on;
    ``losses`` from the step after the resumed one (the first step on a
    fresh run); ``eval_losses``: ``(step, held-out loss)``. A LoRA
    finetune: ``adapter`` the trained factors (the optimizer's
    parameters), ``base_params`` the frozen base's ``state_dict`` they were
    trained against (None for full training)."""

    model: GPT
    optimizer: object
    losses: list[float] = field(default_factory=list)
    elapsed_times: list[float] = field(default_factory=list)
    eval_losses: list[tuple[int, float]] = field(default_factory=list)
    total_time_s: float = 0.0
    adapter: dict[str, torch.Tensor] | None = None
    mesh: VirtualMesh | None = None

    @property
    def base_params(self) -> dict[str, torch.Tensor] | None:
        """A finetune's frozen base (the model's ``state_dict``); None for
        full training."""
        return None if self.adapter is None else self.model.state_dict()


def refuse_unported(train_cfg: TrainConfig, model_cfg: ModelConfig,
                    opt_cfg: OptimConfig | None = None) -> None:
    """Raise ``NotImplementedError`` for every setting that asks for a part
    of the JAX trainer the port does not have yet, naming where it waits;
    ``ValueError`` for ring attention and LoRA training under pipeline
    parallelism, which the JAX trainer refuses too."""
    m = train_cfg.mesh
    ring = model_cfg.attention == "ring"
    piped = m.pipe > 1 or train_cfg.parallel == "pp"
    if ring and piped:
        raise ValueError(
            "attention='ring' (sequence parallelism) cannot run under "
            "pipeline parallelism; use a mesh with pipe=1 (ring "
            "composes with the data axis) or attention='ulysses'"
        )
    lora = model_cfg.adapter.rank > 0
    if lora and piped:
        raise ValueError(
            "LoRA adapter training is not supported under pipeline "
            "parallelism (pipe > 1); adapters compose with DP/TP/FSDP"
        )
    # Megatron slices: a model axis that is not ring attention's.
    tp = not ring and (m.model > 1 or train_cfg.parallel in ("tp", "3d"))
    fsdp = train_cfg.parallel == "fsdp"
    bf16 = opt_cfg is not None and opt_cfg.precision == "bf16_mixed"
    for asked, feature, where in ((bf16, "precision: bf16_mixed", (tp, piped, fsdp)),
                                  (lora, "LoRA adapter training", (tp, False, fsdp))):
        for on, what in zip(where, ("tensor parallelism", "pipeline parallelism", "FSDP")):
            if asked and on:
                raise NotImplementedError(
                    f"the PyTorch port does not train with {feature} under {what} yet "
                    "(ROADMAP.md §A2: the sharded optimizer state, masters and "
                    "adapters with checkpoints under TP, PP and FSDP)")
    refusals = [
        (train_cfg.parallel == "none", "parallel: none"),
        ((m.dcn_pipe, m.dcn_data, m.dcn_model) != (1, 1, 1),
         "dcn mesh factors (multi-host)"),
        (train_cfg.multihost, "multihost (one host's torchrun processes only)"),
        (train_cfg.debug_nans, "debug_nans"),
    ]
    for refused, what in refusals:
        if refused:
            raise NotImplementedError(f"the PyTorch port does not train with {what} yet")
    if train_cfg.parallel == "fsdp":
        check_fsdp((max(m.pipe, 1), 1, max(m.model, 1)))


def refuse_sharded_state(train_cfg: TrainConfig, shape: tuple[int, int, int],
                         ring_attn: bool, fsdp: bool) -> None:
    """``NotImplementedError`` for checkpoints and held-out eval where a
    rank holds a slice of the model (``shape`` the resolved ``(pipe, data,
    model)`` mesh; ``fsdp`` whether FSDP shards it): a checkpoint there
    waits for the one-process layout gathered from the ranks' slices."""
    n_pipe, _, n_model = shape
    slicing = [(fsdp, "FSDP"), (n_model > 1 and not ring_attn, "tensor parallelism"),
               (n_pipe > 1, "pipeline parallelism")]
    for on, what in slicing:
        for asked, feature in ((train_cfg.checkpoint_every > 0, "checkpoints"),
                               (train_cfg.eval_every > 0, "held-out eval")):
            if on and asked:
                raise NotImplementedError(
                    f"the PyTorch port does not train with {feature} under {what} yet "
                    "(ROADMAP.md §A2: checkpoints under TP, PP and FSDP, in the "
                    "one-process layout gathered from the ranks' slices)")


def elastic_layout(train_cfg: TrainConfig, model_cfg: ModelConfig, world: int,
                   host_iterator=None) -> tuple[VirtualHosts, VirtualMesh]:
    """The virtual hosts and mesh of an elastic run, raising the JAX
    trainer's ``ValueError`` for what it does not support. The virtual
    devices are the config mesh's pipe × data × model when it fixes the
    data axis, else :data:`DEFAULT_VIRTUAL_DEVICES`; the mesh over them is
    the one the JAX trainer builds over that many devices, shrunk at once
    over ``elastic.dead_hosts`` (a restart on the survivors)."""
    el_cfg = train_cfg.resilience.elastic
    if world > 1:
        raise ValueError(
            "resilience.elastic emulates hosts in-process; real multi-process runs "
            "(torchrun) are not supported yet (the virtual-host seam is where a "
            "cross-host transport would slot in)")
    if train_cfg.dataset != "synthetic" or host_iterator is not None:
        raise ValueError(
            "resilience.elastic requires dataset: synthetic (the batch-shape-independent "
            "row stream is the re-seek contract); fineweb and caller-provided iterators "
            "cannot be re-positioned across a mesh resize")
    m = train_cfg.mesh
    n_dev = (max(m.pipe, 1) * m.data * max(m.model, 1) if m.data > 0
             else DEFAULT_VIRTUAL_DEVICES)
    shape = resolve_mesh_shape(train_cfg.parallel, n_dev, m, n_layers=model_cfg.n_layers)
    if shape[0] > 1:
        raise ValueError(
            "resilience.elastic does not support pipeline parallelism (stage-chunked "
            "params cannot re-shard onto fewer stages); use a mesh with pipe == 1")
    if model_cfg.adapter.rank > 0:
        raise ValueError(
            "resilience.elastic does not support LoRA finetunes: the frozen base params "
            "are outside the snapshotted training state")
    hosts = VirtualHosts(el_cfg.n_virtual_hosts, n_dev)
    mesh = VirtualMesh(shape, hosts.devices)
    for h in el_cfg.dead_hosts:
        hosts.kill(h)
    if el_cfg.dead_hosts:
        mesh = resize_mesh(mesh, hosts)
    if train_cfg.batch % mesh.sizes[1] != 0:
        raise ValueError(
            f"global batch {train_cfg.batch} must shard over the data axis "
            f"{mesh.sizes[1]} (elastic preserves the global batch and rescales the "
            "per-device batch)")
    return hosts, mesh


def make_host_iterator(train_cfg: TrainConfig, model_cfg: ModelConfig,
                       skip_batches: int = 0, seed_offset: int = 0,
                       stream_position: dict | None = None, history: int = 64,
                       chaos=None, on_recovery=None, cancel=None,
                       row_stream: bool = False) -> Iterator[np.ndarray]:
    """``(batch, seq_len+1)`` token batches of the global batch (the JAX
    package's process 0's stream; a rank takes its share). The synthetic
    stream from seed ``seed·1000 + seed_offset`` seeks by ``skip_batches``
    (with ``row_stream``, elastic training's, the flat row stream from row
    ``skip_batches·batch``);
    FineWeb seeks by ``stream_position`` (a checkpointed position) and
    drains ``skip_batches`` (for checkpoints without one). FineWeb heals
    transient faults per ``resilience.stream_retry``; ``chaos`` threads the
    fault injector into its document source and ``on_recovery`` (a
    recovery-bus post) receives the retry records. ``cancel`` ends the
    stream's retry backoff when the trainer drops it."""
    seq = model_cfg.max_seq_len + 1
    if train_cfg.dataset == "synthetic":
        if row_stream:
            return synthetic_row_batches(train_cfg.batch, seq, model_cfg.vocab_size,
                                         seed=train_cfg.seed * 1000 + seed_offset,
                                         start_row=skip_batches * train_cfg.batch)
        return synthetic_batch_iterator(train_cfg.batch, seq, model_cfg.vocab_size,
                                        seed=train_cfg.seed * 1000 + seed_offset,
                                        start=skip_batches)
    from dtc_tpu_torch.data.fineweb import FinewebStream

    it = FinewebStream(train_cfg.batch, seq, position=stream_position, history=history,
                       retry=train_cfg.resilience.stream_retry, chaos=chaos,
                       on_recovery=on_recovery, cancel=cancel)
    for _ in range(skip_batches):
        next(it)
    return it


def make_eval_iterator(train_cfg: TrainConfig, model_cfg: ModelConfig) -> Iterator[np.ndarray]:
    """The synthetic eval batches: a stream disjoint from training's
    (``seed_offset=500``). FineWeb's come from the held-out split."""
    return make_host_iterator(train_cfg, model_cfg, seed_offset=500)


def _drop_yields(it: Iterator[np.ndarray], drops: set[int]) -> Iterator[np.ndarray]:
    """Skip the 0-based yield indices in ``drops``: the held-out batches a
    resumed stream has not passed yet."""
    last = max(drops)
    for i, batch in enumerate(it):
        if i in drops:
            if i == last:
                break
            continue
        yield batch
    yield from it


class _Stream:
    """The run's host batch stream positioned as of a checkpoint step, and
    the position of the batch training consumed for a step (the JAX
    trainer's ``build_data`` and ``stream_position_sidecar``): shared by
    the resume and the rollback, which is a resume without the restart."""

    def __init__(self, train_cfg, model_cfg, ckpt, host_iterator, rank: int,
                 chaos=None, on_recovery=None, row_stream: bool = False):
        self.cfg, self.model_cfg, self.ckpt = train_cfg, model_cfg, ckpt
        self.row_stream = row_stream
        self.chaos, self.on_recovery = chaos, on_recovery
        self.host_iterator = host_iterator
        self.rank = rank
        self.fineweb = train_cfg.dataset == "fineweb" and host_iterator is None
        self.holdout_n = (train_cfg.eval_batches
                          if self.fineweb and train_cfg.eval_every > 0 else 0)
        self.every = train_cfg.eval_holdout_every
        # The history must reach past prefetch's look-ahead and the
        # holdout's eager read of the stream's head.
        span = (self.holdout_n - 1) * self.every + 1 if self.holdout_n else 0
        self.history = span + 64
        self.eval_batches: list[np.ndarray] | None = None  # FineWeb's held-out set
        self.cancel = threading.Event()
        self.obj = None          # the FinewebStream, for its positions
        self.delivered = 0       # batches handed to warmup and training so far
        self.drops: set[int] = set()  # this stream's withheld 0-based yields
        self.base = 0            # absolute index where this stream starts
        self.start_step = 0      # the loop step the stream is positioned at

    def build(self, resume_from: int) -> Iterator[np.ndarray]:
        """The stream as of checkpoint step ``resume_from`` (0: its head)."""
        cfg, ckpt = self.cfg, self.ckpt
        self.cancel = threading.Event()
        self.start_step, self.delivered, self.drops, self.base = resume_from, 0, set(), 0
        self.obj = None
        skip = cfg.warmup_steps + resume_from if resume_from > 0 else 0
        if self.host_iterator is not None:
            for _ in range(skip):
                next(self.host_iterator)
            return self.host_iterator
        if not self.fineweb:
            return make_host_iterator(cfg, self.model_cfg, skip_batches=skip,
                                      row_stream=self.row_stream)
        sidecar = ckpt.load_stream(resume_from, self.rank) if ckpt and resume_from > 0 else None
        if sidecar is not None:
            self.obj = it = make_host_iterator(cfg, self.model_cfg,
                                               stream_position=sidecar["position"],
                                               history=self.history, chaos=self.chaos,
                                               on_recovery=self.on_recovery,
                                               cancel=self.cancel)
            self.base = sidecar["stream_index"]
            if self.holdout_n:
                # The held-out batches were taken from the stream's head:
                # those past the resume point are still withheld.
                self.drops = {d - self.base for d in diverted_indices(self.every, self.holdout_n)
                              if d + 1 > self.base}
                if self.drops:
                    it = _drop_yields(it, self.drops)
                if self.eval_batches is None:
                    self.eval_batches = ckpt.load_eval_set(self.rank)
                if self.eval_batches is None:
                    head = make_host_iterator(cfg, self.model_cfg)
                    _, self.eval_batches = divert_holdout(head, self.every, self.holdout_n)
            return it
        self.obj = it = make_host_iterator(cfg, self.model_cfg, history=self.history,
                                           chaos=self.chaos, on_recovery=self.on_recovery,
                                           cancel=self.cancel)
        if self.holdout_n:
            self.drops = diverted_indices(self.every, self.holdout_n)
            it, diverted = divert_holdout(it, self.every, self.holdout_n)
            if self.eval_batches is None:
                self.eval_batches = diverted
                if ckpt:
                    ckpt.save_eval_set(diverted, self.rank)
        for _ in range(skip):  # a checkpoint without a position: drain
            next(it)
        self.delivered = skip
        return it

    def sidecar(self, step: int) -> dict | None:
        """The resume point of the batch training consumed for ``step``,
        read from the stream's position history (prefetch may be ahead)."""
        if self.obj is None:
            return None
        idx = stream_index_for(self.delivered + step - self.start_step, self.drops)
        return {"position": self.obj.position_after(idx), "stream_index": self.base + idx}


def train(
    train_cfg: TrainConfig,
    model_cfg: ModelConfig,
    opt_cfg: OptimConfig,
    *,
    device=None,
    params=None,
    backend: str | None = None,
    host_iterator: Iterator[np.ndarray] | None = None,
    lora=None,
) -> TrainResult:
    """Train ``model_cfg`` on ``device`` (``cuda`` unless named; raises
    without a card). The weights come from ``GPT(model_cfg,
    seed=train_cfg.seed)``, or from ``params``, a flax parameter tree of
    numpy arrays carried across by :func:`dtc_tpu_torch.parity.from_flax`
    (each rank keeps its slice), or from the newest intact checkpoint when
    one exists and ``resume`` is set. Dropout masks come from a generator
    seeded with ``train_cfg.seed`` plus the rank's ``(pipe, data)`` index
    (see the module docstring); the synthetic stream from seed
    ``seed·1000`` (the JAX trainer's seed for process 0), or the batches
    come from ``host_iterator`` (global ``(batch, seq_len+1)`` arrays).
    Under torchrun's environment the process group is joined first, over
    ``backend`` (NCCL on cards and gloo on the CPU unless named; gloo runs
    several ranks on one card), and left at the end if this call joined
    it; the mesh spans its ranks. With ``adapter.rank > 0`` the run is a
    LoRA finetune of the base (see the module docstring), its factors
    drawn by :func:`~dtc_tpu_torch.adapters.lora.init_lora` from ``seed``,
    or taken from ``lora``, a flax ``"lora"`` collection of numpy arrays
    (:func:`dtc_tpu_torch.parity.lora_from_flax`)."""
    model_cfg = resolve_precision(opt_cfg, resolve_collectives(train_cfg, model_cfg))
    refuse_unported(train_cfg, model_cfg, opt_cfg)
    if lora is not None and model_cfg.adapter.rank <= 0:
        raise ValueError("initial adapter factors need an adapter-enabled model "
                         "(ModelConfig.adapter.rank > 0)")
    joined = dist_utils.launched() and not torch.distributed.is_initialized()
    dev = dist_utils.initialize(device, backend) or resolve_device(device)
    try:
        return _train(train_cfg, model_cfg, opt_cfg, resolve_device(dev), params,
                      host_iterator, lora)
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


def _adapter_state(factors: dict[str, torch.Tensor], saved: dict) -> None:
    """Copy a checkpoint's adapter factors into ``factors`` in place;
    ValueError unless it holds the same sites at the same shapes (a
    checkpoint of another rank, targets or model, or of full training)."""
    if not isinstance(saved, dict) or set(saved) != set(factors) or any(
            tuple(saved[k].shape) != tuple(v.shape) for k, v in factors.items()):
        got = ({k: tuple(v.shape) for k, v in saved.items()} if isinstance(saved, dict)
               else type(saved).__name__)
        raise ValueError(
            f"the checkpoint's adapter factors {got} do not match this finetune's "
            f"{ {k: tuple(v.shape) for k, v in factors.items()} }")
    with torch.no_grad():
        for k, v in factors.items():
            v.copy_(saved[k])


def _train(train_cfg, model_cfg, opt_cfg, dev, params, host_iterator, lora) -> TrainResult:
    cuda = dev.type == "cuda"
    world, rank = dist_utils.world_size(), dist_utils.rank()
    el_cfg = train_cfg.resilience.elastic
    hosts = vmesh = None
    if el_cfg.enabled:
        # Elastic training: virtual hosts over virtual devices in this one
        # process (dtc_tpu_torch/resilience/elastic.py); a host named dead
        # at startup shrinks the mesh before anything runs.
        hosts, vmesh = elastic_layout(train_cfg, model_cfg, world, host_iterator)
    shape = resolve_mesh_shape(train_cfg.parallel, world, train_cfg.mesh,
                               n_layers=model_cfg.n_layers)
    if train_cfg.parallel == "fsdp":
        check_fsdp(shape)
    mesh = Mesh(shape, rank) if world > 1 else None
    n_pipe, n_data, n_model = shape
    seq = model_cfg.max_seq_len
    ring_attn = model_cfg.attention == "ring"
    fsdp_on = (train_cfg.parallel == "fsdp" and torch.distributed.is_initialized()
               and (mesh is None or n_data > 1))
    refuse_sharded_state(train_cfg, shape, ring_attn, fsdp_on)
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
    factors = None
    if model_cfg.adapter.rank > 0:
        # The finetune: the base frozen, the factors the trainable state.
        from dtc_tpu_torch.adapters.lora import init_lora

        model.requires_grad_(False)
        factors = init_lora(model, train_cfg.seed)
        if lora is not None:
            from dtc_tpu_torch.parity import lora_from_flax

            _adapter_state(factors, lora_from_flax(lora))
        for f in factors.values():
            f.requires_grad_(True)
    fsdp = None
    if fsdp_on:
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
    res_cfg = train_cfg.resilience
    guard_cfg = res_cfg.guard
    # The bus first: recovery actions fire where there is no telemetry
    # handle (the stream's retry on the prefetch thread, the checkpoint
    # fallback inside the manager, the chaos hooks); the loop drains it
    # into the event stream at its boundaries.
    bus = RecoveryBus()
    chaos = ChaosInjector(res_cfg.chaos, bus) if res_cfg.chaos.enabled else None
    # What the optimizer updates, and what a chaos NaN poisons.
    trainable_params = list(model.parameters() if factors is None else factors.values())
    opt = create_optimizer(trainable_params, opt_cfg, total_steps=train_cfg.steps,
                           fsdp=fsdp, norm_groups=norm_groups,
                           skip_nonfinite=guard_cfg.skip_nonfinite_updates,
                           max_consecutive_skips=guard_cfg.max_consecutive_skips)
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
            return train_step(model, opt, x, y, gen, fsdp, group, average, factors)

    say = print if lead else (lambda *a, **k: None)
    if chaos is not None and (res_cfg.chaos.data_error_at_doc or res_cfg.chaos.data_stall_at_doc) \
            and not (train_cfg.dataset == "fineweb" and host_iterator is None):
        # The data hooks live in the FineWeb document source: elsewhere
        # they would never fire, and a drill that injects nothing reads as
        # a pass.
        say("[dtc_tpu_torch] WARNING: chaos data faults (data_error_at_doc/"
            "data_stall_at_doc) only fire on dataset: fineweb; this run will not "
            "inject them")

    # ------ checkpoints and resume ------
    ckpt = None
    start_step = 0

    def restore_latest() -> int | None:
        """Load the newest intact checkpoint into the model, the optimizer
        and this rank's generator and return its step; None when no step is
        intact. Rank 0 picks the step (verifying it) and every rank loads
        it."""
        found, step = None, -1
        if lead:
            try:
                found, step = ckpt.restore_latest(process_index=rank, map_location=dev)
            except FileNotFoundError:
                step = -1
        step = dist_utils.broadcast_int(step, dev)
        if step < 0:
            return None
        if found is None:
            found = ckpt.restore(step, process_index=rank, map_location=dev)
        if factors is None:
            model.load_state_dict(found["model"])
        else:
            _adapter_state(factors, found.get("adapter"))
        opt.load_state_dict(found["optimizer"])
        gen.set_state(found["rng"].cpu())
        return step

    # With elastic on, the disk checkpoint is the cold tier: the in-memory
    # snapshots are the hot one, and elastic.cold_every (when set) slows the
    # disk cadence.
    checkpoint_every = train_cfg.checkpoint_every
    if hosts is not None and el_cfg.cold_every > 0 and checkpoint_every > 0:
        checkpoint_every = el_cfg.cold_every
    if train_cfg.checkpoint_every > 0:
        ckpt_dir = train_cfg.checkpoint_dir or os.path.join(train_cfg.output_dir,
                                                             "checkpoints")
        ckpt = CheckpointManager(ckpt_dir, verify=res_cfg.verify_checkpoints,
                                 keep_n=res_cfg.checkpoint_keep_n, on_event=bus.post)
        if train_cfg.resume and ckpt.all_steps():
            # Labels are loop steps: the optimizer's count also holds the
            # warmup updates.
            start_step = restore_latest()
            if start_step is None:
                raise RuntimeError(
                    "resume requested but no checkpoint could be restored from "
                    f"{ckpt_dir}. Causes range from real corruption to a "
                    "model/optimizer config that no longer matches the saved state. "
                    "Inspect the checkpoint dir, revert config changes, or set resume: "
                    "false (plus overwrite: true if output_dir holds a previous "
                    "log.csv) to deliberately start fresh")
            say(f"[dtc_tpu_torch] resumed from checkpoint step {start_step}")

    def save_checkpoint(step: int) -> None:
        """Rank 0 writes the model (a finetune: the adapter's factors) and
        the optimizer, every rank its own generator state and stream
        position; the step is committed when every rank's files have
        landed. The chaos damage of a checkpoint is the caller's."""
        if lead:
            ckpt.begin(step)
        dist_utils.barrier()
        if lead:
            weights = ({"model": model.state_dict()} if factors is None
                       else {"adapter": {k: v.detach() for k, v in factors.items()}})
            ckpt.write(step, {**weights, "optimizer": opt.state_dict()})
        ckpt.write(step, {"rng": gen.get_state()}, process_index=rank)
        dist_utils.barrier()
        if lead:
            ckpt.commit(step)
        position = stream.sidecar(step)
        if position is not None:
            ckpt.save_stream(step, position, rank)
        dist_utils.barrier()

    log_path = os.path.join(train_cfg.output_dir, "log.csv")
    if (lead and train_cfg.output_dir and start_step == 0 and not train_cfg.overwrite
            and os.path.exists(log_path)):
        raise ValueError(
            f"refusing to overwrite existing {log_path} on a fresh run; pass "
            "overwrite: true, pick another output_dir, or enable checkpointing so the "
            "run resumes instead"
        )
    # Rollback needs a checkpoint and a stream the trainer can rebuild.
    guard = (AnomalyGuard(guard_cfg, can_rollback=ckpt is not None and host_iterator is None)
             if guard_cfg.enabled else None)
    rows = cols = None
    ring = contextlib.nullcontext()
    if mesh is not None:
        t_local = seq // n_model if ring_attn else seq
        t_idx = mesh.model_idx if ring_attn else 0
        rows = _rows(train_cfg.batch, n_data, mesh.data_idx, micro)
        cols = slice(t_idx * t_local, (t_idx + 1) * t_local + 1)
        if n_model > 1 and ring_attn:
            ring = use_ring(DistRing(mesh.model_ranks, mesh.model_group))

    def shard(batches):
        """This rank's share of each global batch."""
        return batches if rows is None else _shard(batches, rows, cols)

    stream = _Stream(train_cfg, model_cfg, ckpt, host_iterator, rank, chaos, bus.post,
                     row_stream=hosts is not None)

    def feed(resume_from: int) -> PrefetchIterator:
        return PrefetchIterator(shard(stream.build(resume_from)), dev,
                                depth=train_cfg.prefetch)

    data_it = feed(start_step)
    eval_set = None
    if train_cfg.eval_every > 0:
        if stream.eval_batches is not None:
            say(f"[dtc_tpu_torch] fineweb eval: {len(stream.eval_batches)} held-out batches "
                f"(every {stream.every}th from the stream head), excluded from training")
            host_eval = stream.eval_batches
        else:
            it = make_eval_iterator(train_cfg, model_cfg)
            host_eval = [next(it) for _ in range(train_cfg.eval_batches)]
        eval_set = [split_to_device(b, dev) for b in shard(host_eval)]
    resumed = start_step > 0
    # Telemetry after the clobber guard (a refused run writes nothing) and
    # before warmup, so the compile watcher sees the kernel libraries'
    # build. log.csv and eval_log.csv are its CSV sinks, obs on or off.
    tele = Telemetry.for_training(train_cfg, lead=lead, process_index=rank,
                                  resumed=resumed, device=dev)
    mesh_shape = dict(zip(AXIS_NAMES, shape))
    comm = comm_bytes_per_step(model_cfg, train_cfg.batch, seq, mesh_shape,
                               train_cfg.parallel, train_cfg.pp_microbatches)
    tele.set_device_profile_context(
        step_flops=gpt_step_flops(model_cfg, train_cfg.batch, seq),
        peak_flops=peak_flops(dev), comm_estimate=comm)
    try:
        if train_cfg.output_dir and lead:
            tele.add_csv(log_path, FIELDS, "train_row", append=resumed)
            if eval_set is not None:
                tele.add_csv(os.path.join(train_cfg.output_dir, "eval_log.csv"),
                             ("step", "loss"), "eval", append=resumed)
    except BaseException:
        tele.close()
        raise
    tele.on_run_start(strategy=train_cfg.parallel, mesh=mesh_shape, devices=world,
                      processes=world, batch=train_cfg.batch, seq_len=seq,
                      steps=train_cfg.steps, start_step=start_step,
                      dataset=train_cfg.dataset)
    wd = StepWatchdog(res_cfg.watchdog) if res_cfg.watchdog.enabled else None
    sync_every_step = train_cfg.sync_every_step
    if sync_every_step is None:
        sync_every_step = bool(train_cfg.output_dir)
    peak = peak_flops(dev)
    peak = peak * world if peak is not None else None
    tokens_per_step = train_cfg.batch * seq
    result = TrainResult(model=model, optimizer=opt, adapter=factors, mesh=vmesh)
    # The step the result's lists start after; a rollback below the resume
    # point moves it down.
    result_base = start_step

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize(dev)

    def commit_and_truncate(target: int, window_rows, window_losses) -> None:
        """Commit the detection window's steps at or before the restored
        step (they are not replayed), then drop what follows it from the
        result; the replay appends it again."""
        nonlocal result_base
        for (s, el), lo in zip(window_rows, window_losses):
            if s <= target:
                result.losses.append(lo)
                tele.emit_train_row(s, el, lo)
        keep = max(target - result_base, 0)
        del result.losses[keep:]
        del result.elapsed_times[keep:]
        result.eval_losses[:] = [e for e in result.eval_losses if e[0] <= target]
        result_base = min(result_base, target)

    def restore_from_tiers(cur_step: int, max_step: int | None) -> tuple[int | None, str, bool]:
        """Load the newest complete in-memory snapshot at or below
        ``max_step`` (elastic training's hot tier) into the model, the
        optimizer and the generator, else the newest verified checkpoint;
        shared by the rollback and the elastic resize. Returns ``(step,
        tier, used_mirror)``, the step None when no source exists."""
        if snaps is not None:
            snaps.drain()
            snap = snaps.latest(max_step=max_step)
            if snap is not None:
                try:
                    restored, used_mirror = snaps.restore(snap, hosts.alive)
                    load_train_state(model, opt, gen, restored)
                    return snap.step, "memory", used_mirror
                except SnapshotIncompleteError as e:
                    tele.on_recovery(cur_step, action="snapshot_incomplete", reason=str(e))
        if ckpt is None:
            return None, "cold", False
        return restore_latest(), "cold", False

    def rollback(cur_step: int, reason: str, window_losses, window_rows) -> int | None:
        """The guard's rollback: restore the newest complete snapshot below
        the window's last healthy boundary, else the newest verified
        checkpoint, re-seek the stream there and return its step (None when
        nothing is intact: the guard then only burns a rung). A step's loss
        is computed on the parameters going into it, so the healthy losses
        through the boundary vouch for snapshots through boundary-1 only."""
        nonlocal data_it
        t_detect = time.time()
        boundary = cur_step - len(window_losses)
        target, tier, _ = restore_from_tiers(cur_step, boundary - 1)
        if target is None:
            return None
        stream.cancel.set()  # ends a retry backoff of the dropped stream
        data_it.close()
        data_it = feed(target)
        guard.note_rollback()
        commit_and_truncate(target, window_rows, window_losses)
        tele.on_recovery(cur_step, action="rollback", to_step=target, reason=reason,
                         tier=tier, rollbacks=guard.rollbacks_done,
                         t_detect=round(t_detect, 6), t_restored=round(time.time(), 6))
        tele.drain_recovery_bus(bus, cur_step)  # the restore's fallbacks
        tele.record_aux_compile(cur_step, "rollback")
        tele.flush()
        restored = "checkpoint" if tier == "cold" else "memory snapshot"
        say(f"[dtc_tpu_torch] ROLLBACK: {reason} — restored {restored} step {target}, "
            f"stream re-seeked ({guard.rollbacks_done}/{guard_cfg.max_rollbacks})")
        return target

    def elastic_resize(cur_step: int, lost: list[int], window_losses, window_rows) -> int:
        """Shrink-and-continue: the mesh over the surviving hosts, the newest
        complete snapshot restored (the cold tier when the survivors cannot
        put it together), the row stream re-seeked, the restored state
        spilled to the cold tier; returns the restored step, from which the
        loop replays. The global batch is kept; this process computes it
        whole on any mesh, so the replay's numbers are the uninterrupted
        run's. Runs off the hot path (a host just died)."""
        nonlocal data_it, vmesh
        t_detect = time.time()
        new_mesh = resize_mesh(vmesh, hosts)
        new_data = new_mesh.sizes[1]
        if train_cfg.batch % new_data != 0:
            raise ElasticAbort(
                f"global batch {train_cfg.batch} does not shard over the shrunk data axis "
                f"{new_data}; no valid elastic continuation exists")
        target, tier, used_mirror = restore_from_tiers(cur_step, None)
        if target is None:
            raise ElasticAbort(
                f"no complete in-memory snapshot survives hosts {sorted(lost)} being lost "
                "and no intact cold-tier checkpoint; elastic recovery is impossible — "
                "restart from a reprovisioned slice")
        fetched = torch.stack(window_losses).tolist() if window_losses else []
        commit_and_truncate(target, window_rows, fetched)
        vmesh = result.mesh = new_mesh
        stream.cancel.set()
        data_it.close()
        data_it = feed(target)
        tele.on_elastic(cur_step, "elastic_resize", to_step=target, tier=tier,
                        used_mirror=used_mirror, hosts_lost=sorted(lost),
                        devices=len(hosts.survivor_devices()), mesh=new_mesh.shape,
                        per_device_batch=train_cfg.batch // new_data,
                        t_detect=round(t_detect, 6), t_restored=round(time.time(), 6))
        tele.drain_recovery_bus(bus, cur_step)
        if ckpt is not None and el_cfg.spill_on_resize:
            # The restored state goes to the cold tier at once: a second
            # failure before the next save would be unrecoverable, and a
            # shrunk restart (elastic.dead_hosts) resumes from this step.
            with tele.span("elastic_spill", step=target):
                save_checkpoint(target)
            if chaos is not None and lead:
                # A torn spill (a preemption mid-write): a restore must reject it.
                chaos.maybe_tear_cold_spill(target, ckpt.step_dir(target))
            tele.on_elastic(target, "elastic_spill", detected_at=cur_step)
        tele.record_aux_compile(cur_step, "elastic_resize")
        tele.flush()
        say(f"[dtc_tpu_torch] ELASTIC RESIZE: hosts {sorted(lost)} lost — restored {tier} "
            f"step {target}{' (ring mirror)' if used_mirror else ''}, mesh -> "
            f"{new_mesh.shape}, per-device batch {train_cfg.batch // new_data}, continuing")
        return target

    def run_eval(step: int) -> float:
        """Held-out eval at ``step``; returns its wall-clock seconds, which
        the caller keeps out of the training ``elapsed_time``."""
        sync()  # the pending training work's time stays training time
        t0 = time.perf_counter()
        vals = [float(eval_loss(model, x, y, lora=factors)) for x, y in eval_set]
        el = float(np.mean(vals))
        result.eval_losses.append((step, el))
        say(f"Eval @ step {step}: loss {el:.4f}")
        dt = time.perf_counter() - t0
        tele.on_eval(step, el, duration_s=dt)
        tele.flush()
        return dt

    say(f"[dtc_tpu_torch] strategy={train_cfg.parallel} device={dev}"
        + (f" ({torch.cuda.get_device_name(dev)})" if cuda else "")
        + (f" mesh={mesh_shape} processes={world}"
           if torch.distributed.is_initialized() else ""))
    rules = sharding.FSDP_RULES if train_cfg.parallel == "fsdp" else sharding.DEFAULT_RULES
    if model_cfg.attention == "ring":
        rules = sharding.ring_rules_from(rules)
    if (model_cfg.collectives == "overlapped"
            and sharding.fsdp_axis(rules, mesh_shape) is None):
        say("[dtc_tpu_torch] WARNING: collectives: overlapped is inert on this run — "
            "no usable FSDP ring in scope (the active rules don't shard 'embed_p', its "
            "mesh axis is size 1, or sequence-parallel rules own the activations); every "
            "matmul keeps its plain product")
    monitor = snaps = None
    if hosts is not None:
        # The roster is frozen here, after the startup's dead hosts.
        monitor = HostMonitor(hosts, miss_limit=el_cfg.heartbeat_miss_limit)
        # Commits land on a thread: their records ride the bus.
        snaps = SnapshotStore(hosts, keep=el_cfg.keep, on_event=bus.post)
        if cuda:
            snaps.reserve(train_state(model, opt, gen, rules)[0])

    # SIGTERM (a preemption) asks for a graceful stop: the loop finishes the
    # step, checkpoints it, flushes the CSV and returns.
    stop_requested = [False]
    in_main_thread = threading.current_thread() is threading.main_thread()
    prev_handler = None
    if in_main_thread:
        def on_sigterm(signum, frame):
            stop_requested[0] = True
            say("[dtc_tpu_torch] SIGTERM received — will checkpoint and stop")
        prev_handler = signal.signal(signal.SIGTERM, on_sigterm)
    try:
        with ring:
            warmup_steps = 0 if resumed else train_cfg.warmup_steps
            if warmup_steps:
                say("Warmup")
            for _ in range(warmup_steps):
                x, y = next(data_it)
                loss = step_fn(x, y)
            stream.delivered += warmup_steps
            if warmup_steps:
                float(loss)  # wait for the warmup updates
            # Every library built and loaded so far is the run's startup
            # compile: the step-0 ``compile`` event.
            tele.record_startup_compile()

            if wd is not None and in_main_thread:
                wd.start()
            say("Start measuring")
            device_losses: list[torch.Tensor] = []
            pending: list[tuple[int, float]] = []
            snap_cold = True  # the first snapshot's library loads, if any
            start = window_start = time.perf_counter()
            window_steps = 0
            # while, not for: a rollback moves the step back to the
            # restored checkpoint and the loop replays from there.
            step = start_step
            while step < train_cfg.steps:
                step += 1
                tele.on_step_start(step)  # profiler windows + step clock
                if wd is not None:
                    wd.arm(step)
                with tele.clock.phase("data_wait"):
                    x, y = next(data_it)
                with tele.clock.phase("dispatch"):
                    loss = step_fn(x, y)
                if chaos is not None:
                    loss = chaos.maybe_poison(step, trainable_params, loss)
                device_losses.append(loss)
                if sync_every_step:
                    with tele.clock.phase("block"):
                        sync()
                now = time.perf_counter()
                result.elapsed_times.append(now - start)
                pending.append((step, now - start))
                breakdown = tele.on_step_end(step, elapsed_s=now - start,
                                             synced=bool(sync_every_step))
                stalled = False
                if wd is not None:
                    flag = wd.observe(step, breakdown["step_time_s"])
                    if flag is not None:
                        say(f"[dtc_tpu_torch] hung step: {flag}")
                        tele.on_hung_step(**flag)
                        # A hung step is the collective-stall signal: the
                        # heartbeat poll below escalates.
                        stalled = True
                        if res_cfg.watchdog.profile_on_flag:
                            tele.arm_profile_window(step + 1)
                window_steps += 1
                if hosts is not None:
                    # The emulation's chaos lands before the heartbeat tick
                    # and the snapshot: a host killed at step k beats and
                    # stores nothing from k on.
                    if chaos is not None:
                        victim = chaos.kill_host(step)
                        if victim is not None:
                            hosts.kill(victim)
                        slow = chaos.slow_host(step)
                        if slow is not None:
                            monitor.mark_slow(slow[0], step + slow[1] - 1)
                        gone = chaos.lose_snapshot(step)
                        if gone is not None:
                            snaps.drop_primary(gone)
                    monitor.tick(step)
                    if step % el_cfg.snapshot_every == 0:
                        # Clones and a copy stream dispatched; hashing and
                        # filing on the commit thread. No host sync here.
                        state, specs = train_state(model, opt, gen, rules)
                        if snaps.begin(step, state, vmesh, specs) and snap_cold:
                            snap_cold = False
                            tele.record_aux_compile(step, "snapshot_dispatch")
                    lost_now = []
                    for ev in monitor.poll(step, stalled=stalled):
                        kind = ev.pop("kind")
                        tele.on_elastic(step, kind, **ev)
                        if kind == "host_lost":
                            lost_now.append(ev["host"])
                    if lost_now:
                        # Replay from the restored step on the survivors' mesh;
                        # the detection window's suffix was dropped.
                        step = elastic_resize(step, lost_now, device_losses, pending)
                        device_losses, pending = [], []
                        window_start, window_steps = time.perf_counter(), 0
                        if wd is not None:
                            wd.disarm()
                        continue
                if chaos is not None and chaos.should_preempt(step):
                    if in_main_thread:
                        # A real signal through the real handler (delivered
                        # before os.kill returns).
                        os.kill(os.getpid(), signal.SIGTERM)
                    else:
                        # Off the main thread no handler was installed and a
                        # raw SIGTERM would kill the process: do what the
                        # handler does.
                        stop_requested[0] = True
                stopping = stop_requested[0]
                if stopping:
                    # The preemption's post-mortem, before the checkpoint
                    # and flush work the preemptor may not leave time for;
                    # the bus first, so the records that led to the stop
                    # are in the dumped timeline.
                    tele.drain_recovery_bus(bus, step)
                    tele.dump_flight("sigterm", step=step)
                    say(f"[dtc_tpu_torch] stopping at step {step} (SIGTERM)")
                if step % train_cfg.log_every == 0 or step == train_cfg.steps or stopping:
                    losses = torch.stack(device_losses).tolist()  # the window's one sync
                    now = time.perf_counter()
                    if guard is not None:
                        decision = guard.check_window(step, losses)
                        if decision.anomalous:
                            tele.on_anomaly(step, reason=decision.reason,
                                            action=decision.action)
                            say(f"[dtc_tpu_torch] ANOMALY: {decision.reason} -> "
                                f"{decision.action}")
                        if decision.action == "abort":
                            tele.on_recovery(step, action="abort", reason=decision.reason)
                            tele.drain_recovery_bus(bus, step)
                            raise AnomalyAbort(decision.reason)
                        if decision.action == "rollback":
                            target = rollback(step, decision.reason, losses, pending)
                            if target is not None:
                                # The poisoned window is dropped whole: no rows,
                                # no eval, no checkpoint; replay from the target.
                                step = target
                                device_losses, pending = [], []
                                window_start, window_steps = time.perf_counter(), 0
                                continue
                            # Nothing intact to restore: a rung is burnt all the
                            # same, so a persistent anomaly reaches the abort.
                            guard.note_rollback_failed()
                            tele.on_recovery(step, action="rollback_failed",
                                             reason=decision.reason)
                    if not sync_every_step:
                        # Rows were stamped at dispatch: re-stamp the window's last
                        # one now that its work is done.
                        pending[-1] = (pending[-1][0], now - start)
                        result.elapsed_times[-1] = now - start
                    result.losses.extend(losses)
                    # train_row events: every rank's shard, and log.csv on rank 0.
                    for (s, el), lo in zip(pending, losses):
                        tele.emit_train_row(s, el, lo)
                    avg = (now - window_start) / max(window_steps, 1)
                    u = mfu(model_cfg, train_cfg.batch, seq, avg, peak)
                    tele.on_window(step, avg_step_s=avg,
                                   tokens_per_sec=tokens_per_step / avg, mfu=u)
                    # Recovery records posted from other threads (the
                    # stream's retries, checkpoint fallbacks) surface here.
                    tele.drain_recovery_bus(bus, step)
                    tele.flush()
                    msg = (f"Step: {step} | Avg loss: {sum(losses) / len(losses):.4f} | "
                           f"Average step time: {avg:.4f} | "
                           f"tokens/s: {tokens_per_step / avg:,.0f}")
                    if u is not None:
                        msg += f" | MFU: {u * 100:.1f}%"
                    say(msg)
                    device_losses, pending = [], []
                    tele.record_aux_compile(step, "log_boundary")
                    window_start, window_steps = time.perf_counter(), 0
                if eval_set is not None and (step % train_cfg.eval_every == 0
                                             or step == train_cfg.steps):
                    start += run_eval(step)
                    tele.record_aux_compile(step, "eval")
                    window_start, window_steps = time.perf_counter(), 0
                if ckpt is not None and (step % checkpoint_every == 0 or stopping):
                    # The state may already be poisoned before the next log
                    # boundary sees it; a bit-intact NaN checkpoint would become
                    # the rollback target. One scalar fetch a save.
                    if guard is not None and not guard.healthy_loss(float(loss)):
                        tele.on_recovery(step, action="skip_checkpoint",
                                         reason="unhealthy loss at save point")
                        say(f"[dtc_tpu_torch] skipping checkpoint at step {step}: "
                            "unhealthy loss at save point")
                    else:
                        tele.registry.counter("checkpoints").inc()
                        with tele.span("checkpoint", step=step):
                            save_checkpoint(step)
                        if chaos is not None and lead:
                            # Damage after the verified write: a later restore
                            # must detect it and fall back.
                            chaos.maybe_corrupt_checkpoint(step, ckpt.step_dir(step))
                            chaos.maybe_tear_cold_spill(step, ckpt.step_dir(step))
                    tele.record_aux_compile(step, "checkpoint")
                if stopping:
                    break
    except KeyboardInterrupt:
        # The watchdog's hard timeout interrupts the main thread.
        tele.dump_flight("watchdog_timeout" if wd is not None and wd.timed_out
                         else "interrupt")
        tele.close()
        raise
    except BaseException as e:
        # A crashed run keeps its flushed JSONL prefix, plus the flight
        # recorder's timeline.
        tele.dump_flight(f"crash: {type(e).__name__}")
        tele.close()
        raise
    finally:
        if wd is not None:
            wd.stop()
        if snaps is not None:
            snaps.close()
        stream.cancel.set()
        data_it.close()
        if in_main_thread:
            signal.signal(signal.SIGTERM, prev_handler)
    result.total_time_s = total = time.perf_counter() - start
    timed = len(result.elapsed_times)
    tele.drain_recovery_bus(bus, step)  # tail records (a retry, a fallback)
    tele.on_run_end(
        total_time_s=round(total, 4),
        steps=timed,
        tokens_per_sec=round(tokens_per_step * timed / total, 1) if total > 0 else None,
        mfu=mfu(model_cfg, train_cfg.batch, seq, total / timed, peak) if timed else None,
        est_comm_bytes_per_step=comm,
    )
    tele.close()
    if fsdp is not None:
        result.model = fsdp.gathered(model)
    if tp is not None and not replicas_equal(model, tp):
        raise RuntimeError(
            "the parameters tensor parallelism replicates drifted apart across the model "
            f"group {tp.ranks}")
    say(f"Total time: {result.total_time_s}")
    say("End")
    return result
