#!/usr/bin/env python3
"""Chip smoke for the PyTorch port: proves on one NVIDIA GPU that the port
builds its kernels from this checkout, that each kernel agrees with its
plain PyTorch version, and that the serving and training main paths run
through them.

    python3 chip_smoke.py [--out results.json] [--seed 0] [--profile]

Phases (each prints its own lines; any failure exits non-zero):

1. Device: ``nvidia-smi`` name and power limit, ``torch.cuda`` device.
2. Build: every kernel library with ``nvcc`` (one process per source, all
   started together), with the compiler's register / shared-memory report.
   The six decode-megakernel libraries take minutes: phases 3, 5, 6, 8, 15
   and 18 (kernel cases timed on the device between CUDA events, and
   correctness) run while they compile, and the host-timed phases 4 and 7
   run after the build has finished; the script logs each phase's wall
   seconds at the end;
   the FSDP ring library's tensor-core instances' dynamic shared memory,
   and its ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load) SASS counts
   (``cuobjdump -sass``): a zero fails; the same for every tensor-core
   flash instance (forward, dq, dk/dv), whose shared memory must be the
   plan's (``flash_attention.tc_smem_bytes``).
3. Decode kernel vs plain, at the flagship decode shape (B 4, S 512, H 16,
   D 32) plus S 8192, S 4096, 8 heads of 128 and 8 heads of 48: the error
   against the plain version and against the split twin within its limit
   (float32 1e-5; bfloat16 a few ulps of each head's largest output,
   ``dtc_tpu_torch.parity.attention_tolerance``), planted faults in the
   plain version and in the twin (one split's partials dropped; partials
   combined without their rescale) landing over that limit, each case's
   instance with its registers, shared memory and spills, split length
   (the library's against the twin's) and grid, and device times of the
   kernel, the plain version and the library yardstick (each from many
   calls replayed as one CUDA graph between CUDA events) beside the
   byte/operation bound; the wrapper's time per Python call besides.
4. Serve the flagship as configured (``configs/serve_config.yaml`` +
   ``configs/model_config.yaml``, random weights from ``--seed``): six
   requests, two sharing a 16-token prefix, 64 new tokens each. Every
   request must finish with 64 tokens, and the decode-attention kernel
   must have launched exactly n_layers times per decode iteration.
5. Serve the flagship in float32 compute: every request's tokens equal the
   port's ``generate()`` on the same prompt. TF32 stays off from here on.
6. Flash-attention kernels vs plain, at the flagship training shape (B 8,
   T 512, H 16, D 32) in bfloat16 and float32, at a ragged T (B 2,
   T 1000), at the long-context training calls of phases 13-14 (B 4,
   T 4096 and B 2, T 8192, H 16, D 32, bfloat16; at T 8192 the JAX package
   takes its split backward, TPU kernel rows 8-9; the plain versions run
   one batch row at a time, their float32 (B, H, T, T) tensors being 1.1
   and 4.3 GB a row) and at shapes where the JAX package takes its
   transpose-layout kernels (rows 10-14: B 4, T 1024, 8 heads of 48, the
   call phase 8 trains with; B 2, T 1000, 3 heads of 32; bfloat16 and
   float32) and at the calls of phases 21-22 (a TP 2 rank's: B 8, 8 heads
   of 32; a PP 2 microbatch: B 4, 16 heads of 32; bfloat16): out,
   lse, dq, dk, dv within limits that scale with the values
   (``attention_tolerance`` / ``grad_tolerance``), planted faults (a causal
   mask one column off; delta dropped from the backward; delta read from
   the next row in dq) over them; the dq kernel's planted faults on
   crafted inputs (``dq_fault_cases``: dS not rounded to bf16 on a
   cancelling row, q's scale unrounded, keys past a ragged T unmasked
   without the causal mask) over the limit while the kernel stays within
   it; and device times of the kernels (dq and dk/dv apart, dq beside its
   own bound), the plain versions and the yardstick
   ``scaled_dot_product_attention(is_causal=True)`` (forward, backward
   alone, forward + backward) beside the bound.
7. Train the flagship as ``python -m dtc_tpu_torch.main`` would
   (``configs/train_config_dp.yaml`` + ``model_config.yaml`` +
   ``optim_config.yaml``, ``--dataset synthetic --no-obs``): 5 warmup and
   30 timed steps; finite losses that fall, ``log.csv`` with one row per
   timed step, and the flash kernels launched 12 x steps (forward) and
   12 x steps x 2 (backward) times. Step time, tokens/s, MFU, peak memory.
   ``--profile`` adds a torch.profiler window over steady training steps
   (device busy share, time by kernel).
8. Path agreement: two small float32 configs (8 heads of 32 at T 256; 8
   heads of 48 at T 1024, a head dim the JAX package runs through its
   transpose-layout kernels, at phase 6's shape for them; batch 4)
   trained a few steps once with ``attention: flash`` (the kernels) and
   once with ``attention: dense`` from the same weights and batches; the
   losses agree within 1e-4.
9. Decode megakernel vs plain (``csrc/decode_fused.cu``) at the flagship
   widths and depth (B 4, S 512, per-row frontiers from 2 to past S;
   bfloat16 and float32 compute; bfloat16, int8 and float32 KV; t 1 and a
   t 4 verify window), random biases included, and at head dims 48, 80,
   96 and 112 (8 heads of D, d_ff 4 d_model, the flagship's depth and
   cache): over one layer and over
   all 12 within ``MK_*`` limits; at one layer two planted faults in the
   plain version (the cache mask one column short; with bf16 compute over
   a bf16 cache, the bias added before the product is rounded) land over
   them. Then the LoRA sites: rank 8 on all six sites, slots [0, 1, 2, 1]
   of a resident stack (slot 0 the base), scale 2 and 8/3 (which bf16
   cannot hold), over one layer and all 12 within the same limits; three
   planted faults in the plain version (the delta z·B added to the dense
   output in float32 before it is rounded, the scale left unrounded, the
   rows' slot ids permuted) land over them. Device times of the kernel (with and without adapters),
   the plain version and the per-layer ``fused`` yardstick (CUDA graph
   replay) beside the bound, at the flagship and at the ladder configs
   (``model_ladder_350m.yaml``, ``model_ladder_1b.yaml``; B 4, t 1);
   launch geometry (grid, threads, shared memory) and each
   instance's bulk-copy (``UBLKCP``), ``UTMALDG`` and mbarrier (``SYNCS``)
   counts in the SASS: an instance without a bulk copy fails.
10. Serve the flagship under ``decode_attention: fused_layers`` with phase
    4's requests: one megakernel launch per decode iteration and no
    decode-attention launch; TTFT, ms/token, tokens/s (``--profile``:
    kernels per iteration, busy share); then float32 under
    ``fused_layers``: every request's tokens equal ``generate()``'s.
11. Speculative serving on the megakernel (``spec_k`` 4, ``draft_layers``
    4, bfloat16): every request token-identical to phase 10; accept rate,
    tokens per verify launch, ms/token.
12. Multi-tenant adapter serving: the flagship with the adapter block of
    ``configs/finetune_lora.yaml`` (rank 8, alpha 16, all six sites), three
    tenants with random factors from ``--seed`` and phase 4's six requests
    spread over base and the tenants (the two sharing a prefix under two
    tenants), bfloat16 under ``fused_layers`` (one megakernel launch per
    decode iteration; every request's tokens equal its solo run) and under
    ``fused`` (n_layers decode-kernel launches per iteration); ms/token
    and tokens/s beside phase 10's adapter-free run; then float32 under
    both backends: every request's tokens equal ``generate()`` with its
    tenant's factors.
13. Long-context training: (a) T 4096 as ``python -m dtc_tpu_torch.main
    --train_config_path configs/train_config_longctx.yaml
    --model_config_path configs/model_config_longctx.yaml --dataset
    synthetic --no-obs --steps 30 --output_dir build/...`` runs it (B 4,
    ``remat: block_save_flash``, dropout 0.1, bfloat16 compute), and (b)
    T 8192, B 2: the same configs after ``dataclasses.replace`` as
    ``bench.py``'s ``long_context_t8192_b2``; 5 warmup and 30 timed steps
    each: finite losses that fall, ``log.csv`` with one row per timed step,
    the flash kernels launched 12 (forward) and 24 (backward) times a step.
    Step time, tokens/s, MFU, peak memory beside ``train_memory_bytes``.
    ``--profile`` adds a torch.profiler window over (b).
14. Remat modes: T 4096, B 4, dropout 0.1, bfloat16, ``none``, ``block``,
    ``block_save_flash`` and ``mlp``, 2 warmup and 4 timed steps each from
    one seed: the losses of the four are equal bit for bit, the flash
    forward launches 12 / 24 / 12 / 12 times a step, and peak memory orders
    ``block`` < ``block_save_flash`` < ``none`` and ``mlp`` < ``none``; each
    peak beside ``train_memory_bytes``. Then each mode's peak with the head +
    CE on all 16,384 rows at once (as before it was chunked) beside its
    peak now (it must drop), and an allocation trace of one ``none`` step
    each way (``torch.cuda.memory`` history): the step's peak and the
    blocks of 256 MiB or more live at it, by the port's source line.
15. The zigzag ring's block kernels (TPU kernel rows 15-16, the flash
    kernels without the causal mask and with float32 gradients) against
    their plain versions: the chunk of T 8192 over a ring of 4 (B 2, tc
    1024, H 16, D 32) in bfloat16 and float32, of T 4096 (B 4, tc 512),
    ragged chunks (tc 8, 40 and 1000) and head dims 16, 64 and 128; forward
    causal and not, the backward from a given lse and out; the gradients
    float32 (values bfloat16 cannot hold); planted faults (the diagonal
    still masked without the causal mask; the zero-filled keys past a
    ragged tc unmasked; the gradients rounded to bfloat16) over the
    limits; device times beside the bounds, the plain versions' and
    SDPA's (forward; backward alone).
16. The zigzag ring on one card: the per-rank schedules over 4 and 2
    virtual ranks (the in-process transport) at (B 2, T 8192, H 16, D 32),
    bfloat16 and float32, forward and gradients, against the same
    schedules on the plain block versions and against the single-card
    flash kernels on the whole sequence; block launches 2R+1 forward and
    2R+1 backward calls a rank; ring ms beside flash ms (one card
    emulating R ranks, not a multi-card time). Then one training step of
    the long-context flagship at T 8192 (float32 compute) with
    ``attention: ring`` over 4 virtual ranks against the flash kernels'
    step (losses within 1e-4, 12 x 4 x 9 block forward calls).
17. The trainer over NCCL at world size 1: ``torchrun --nproc_per_node 1
    -m dtc_tpu_torch.main`` on ``train_config_dp.yaml`` (torchrun's
    environment set in this process), 5 + 20 steps of the flagship, against
    the same command in one process: the losses equal bit for bit, one
    gradient all-reduce a step, the flash kernels' launches, ``log.csv``
    from rank 0. It proves the process group, the reduction and rank-0
    logging on the card, not several cards.

18. The FSDP ring's kernels (TPU kernel rows 17-18, the all-gather-matmul
    step and the matmul + reduce-scatter step) against their plain versions
    over 4 virtual ranks (the in-process transport) at the flagship's
    dense sites (x (4096, 512 or 2048) bf16 and float32; q/k/v and fc1 with
    the contraction sharded, out_proj and fc2 with the output sharded), at
    the DP×FSDP×TP sites of ``train_config_3d.yaml`` (a model rank's
    Megatron widths: x (8192, K), w q/k/v (512, 256), fc1 (512, 1024),
    out_proj (256, 512), fc2 (1024, 512)) and
    ragged shapes (m 100, blocks of 50 and 75): the forward ring and both
    backward rings in float32 within 1e-5 of each row's largest value (bf16
    products are exact in float32), the op's outputs rounded to the compute
    dtype within ``parity.row_tolerance``; 2R² and R² launches a call;
    planted faults (the chunk order one ring step off, ``w_t`` ignored, the
    arriving accumulator not added, partials rounded to bf16 before they
    accumulate) over the limit; every launch on the route its plan names
    (bf16: the tensor cores by TMA at the four sites, the per-thread loader
    among the ragged launches; float32: CUDA cores), each bf16 step's plan
    (route, tile, cluster split, operand layouts, blocks) in the record;
    device times of the forward and dw rings at the four bf16 sites, the
    plain versions' and one ``torch.matmul``'s, beside the bounds. The
    kernels line gives each row at the site where it is slowest against
    its bound, and every site's ms.
19. FSDP over 4 virtual ranks on one card: the flagship
    (``train_config_fsdp.yaml``, dropout 0) under ``collectives:
    overlapped``, every dense site through the ring's kernels: float32
    losses within 1e-4 of the unsharded run over 4 steps; bf16 35 steps,
    finite and falling, 576 all-gather-matmul and 288 reduce-scatter
    launches a rank a step, every one on the TMA route; step ms beside the
    unsharded step (one card emulating 4 ranks, not a multi-card time);
    peak memory beside
    ``train_memory_bytes(parallel="fsdp")``. ``--profile`` adds a
    torch.profiler window over 3 of its steps (device time by kernel, the
    step kernels' time a step).
20. The FSDP trainer over NCCL at world size 1: ``torchrun
    --nproc_per_node 1 -m dtc_tpu_torch.main --train_config_path
    configs/train_config_fsdp.yaml`` (torchrun's environment set in this
    process), 5 + 10 steps: ``collectives: xla`` bit-equal to one process;
    ``overlapped`` (a copy of the config adding it) inert: JAX's warning,
    no ring launch, the xla losses; ``log.csv`` from rank 0 in a fresh
    ``--output_dir``.
21. Megatron tensor parallelism over 2 gloo ranks sharing the card
    (``spawn_ranks``: ``chip_smoke.py --rank-worker DIR`` per rank with
    torchrun's environment; NCCL refuses two ranks on one device): a
    float32 dropout-0 run of 4 steps on ``train_config_tp.yaml`` within
    1e-4 of one process (:func:`one_process_fp32`), then ``python -m
    dtc_tpu_torch.main --train_config_path configs/train_config_tp.yaml
    --dataset synthetic --no-obs --steps 15 --backend gloo --device cuda:0``
    (8 heads of 32 a rank at B 8, 5 warmup steps; 15 timed steps keep the
    script inside its time limit): finite, falling bf16
    losses, ``log.csv`` from rank 0, 12 forward and 24 backward flash
    launches a rank a step, all "tc", the replicated parameters bit-equal
    across the two ranks; step ms and peak memory a rank beside
    ``train_memory_bytes(model 2)``, and the time of one float32
    all-reduce of the activations over gloo.
22. Pipeline parallelism over 2 gloo ranks sharing the card on
    ``train_config_pp.yaml`` (2 microbatches of B 4, 6 layers a stage):
    GPipe, 1F1B and 1F1B at V 2, each a float32 run within 1e-4 of one
    process and a bf16 run of 5 + 30 steps through the CLI (finite and
    falling, ``log.csv``); each stage's flash launches are the schedule's
    forward slots from its table times its chunk's layers (twice that
    backward), all "tc"; then PP 2 x TP 2 in float32 over 4 ranks. Every
    time of phases 21-23 is of ranks sharing one card, not a multi-card
    time.
23. FSDP on a (data, model) mesh as gloo ranks sharing the card: (a)
    DP×FSDP×TP on ``train_config_3d.yaml`` (data 4 × model 2, 8 ranks; the
    FSDP ring of TPU kernel rows 17-18 over each model index's data group
    on its Megatron slices): float32 dropout-0 runs of 4 steps under
    ``xla`` and ``overlapped`` within 1e-4 of one process on the config's
    batch (B 16), then ``python -m dtc_tpu_torch.main --train_config_path
    configs/train_config_3d.yaml --dataset synthetic --no-obs --steps 6
    --backend gloo --device cuda:0`` in bf16 (5 warmup steps): finite,
    falling losses, ``log.csv`` from rank 0, each rank's ring launches
    2R x 72 and R x 72 a step (R 4: 576 and 288), every one "tma" (float32:
    the CUDA cores; ``xla``: none), 12 forward and 24 backward flash
    launches a rank a step ("tc"), the replicated parameters bit-equal
    across each model group; step ms and peak memory a rank beside
    ``train_memory_bytes(fsdp, data 4, model 2)``. (b) FSDP with
    ``attention: ring`` on ``train_config_fsdp.yaml``, data 2 × model 2,
    float32, 4 steps within 1e-4 of one process; each rank's ring block
    launches 12 x (2R+1) forward calls a step (R 2), on the CUDA cores.
24. Checkpoints, resume, held-out eval and the guard's rollback on the
    flagship (``train_config_dp.yaml``, B 8, synthetic, bf16, dropout 0.1;
    checkpoints and eval every 10 steps, 2 eval batches, ``log_every`` 5,
    ``checkpoint_keep_n`` 2, in a temporary directory): (a) run A trains
    5 + 20 steps; B trains 10 and C resumes B's directory to 20: C's
    losses, eval loss and parameters equal A's bit for bit, A's flash
    launches 12 a step and an eval batch forward and 24 a step backward,
    all "tc"; (b) the chaos harness's ``maybe_corrupt_checkpoint`` cuts the
    newest step's largest file to half: its manifest fails and
    ``restore_latest`` lands on step 10; (c) ``resilience.chaos``
    ``nan_at_step: 13`` multiplies the parameters and the loss by NaN after
    the update of step 13 (``log_every`` 10, checkpoints every 5): the save
    at 15 skipped, the guard rolls back to step 10, and the run ends
    bit-equal to A; (d) a checkpoint's bytes, save and sha256 seconds,
    restore seconds, eval ms a batch and A's step median beside phase 7's.
25. ``precision: bf16_mixed`` and the LoRA finetune loop on the flagship:
    (a) ``python -m dtc_tpu_torch.main --train_config_path
    configs/train_config_bf16.yaml --optim_config_path
    configs/optim_config_bf16.yaml --dataset synthetic --no-obs --steps 35
    --output_dir <tmp>``: finite losses whose last-5 mean is below the
    first, the first 8 within 3% of phase 7's (same seed, batches and
    masks), every parameter's dtype as on the CPU with float32 masters and
    moments, 12 forward and 24 backward flash launches a step, all "tc";
    the step median beside phase 7's, the peak beside
    ``train_memory_bytes(precision="bf16_mixed")``, a torch.profiler window
    of 5 steps of each precision (busy share, elementwise passes and
    copies). (b) ``python -m dtc_tpu_torch.adapters.finetune
    --finetune_config configs/finetune_lora.yaml --no-obs --out
    <tmp>/adapter.npz --output_dir <tmp>`` (60 steps, eval and checkpoints
    at 20, 40, 60): exit 0 with the gate passed, the eval loss at 60 below
    the one at 20, the base bit-equal to ``GPT(seed)``'s, checkpoints of the
    adapter alone, a run stopped at 40 and resumed to 60 bit-equal to the
    uninterrupted one, every flash launch "tc"; the checkpoint's bytes, save
    and restore seconds, the step median. (c) The export read back by
    ``load_adapter_file`` and served beside base requests and a second
    tenant through phase 12's checks under ``fused_layers`` and ``fused``:
    float32 tokens equal ``generate(lora=trained)``, bf16 tokens each
    request's solo run, a trained-adapter request's tokens off the base's,
    a megakernel launch per decode iteration.
26. The telemetry subsystem (``obs/``) in the trainer on the flagship:
    (a) ``python -m dtc_tpu_torch.main --train_config_path
    configs/train_config_dp.yaml --dataset synthetic --steps 40
    --output_dir <tmp>`` as a subprocess, telemetry on as the config says:
    exit 0; ``obs/events.r0.jsonl`` holds ``run_start``, one step-0
    ``compile``, a ``step`` event per timed step whose parts sum to its
    ``step_time_s`` within 1e-9, ``window``, ``memory`` and ``run_summary``
    events; ``summary.json``; 40 ``log.csv`` rows. (b) In this process 40
    steps with telemetry on and a device-profile window at steps 30–31,
    then 40 with it off: the losses equal bit for bit, 12 forward and 24
    backward flash launches a step, all "tc". (c) The capture read by
    ``obs.devprof.analyze_capture``: every flash kernel of the window
    attributed to ``attn_kernel`` (12 forward in ``fwd``, 24 dq and dk/dv
    in ``bwd`` a step, all "tc"), every matrix product attributed, the
    unattributed share at most 0.10, the kernels' summed time within 1% of
    ``key_averages()``'s device total; the device-time MFU, the component
    table and the window's own costs. (d) The last memory sample's peak
    equals ``torch.cuda.max_memory_allocated()``. (e) Reported, not gated:
    the step median with telemetry on and off, the runs alternated, and
    the step clock's split (data_wait, dispatch, block, other).
27. The chaos harness and the recovery bus: (a)
    ``configs/train_config_dev_chaos.yaml`` as written on the flagship
    (``model_config.yaml``, bf16) through ``train()``, its output and
    checkpoint directories moved to a temporary one: 40 steps with a
    finite last loss and 40 ``log.csv`` rows; ``chaos`` events
    ``nan_loss`` (25) and ``ckpt_corrupt`` (30), one anomaly, one rollback
    to step 20; after the run step 30 fails its manifest; a flight dump
    with the anomaly's reason; 12 forward and 24 backward flash launches
    for every step run (warmup and the replay included), all "tc"; the
    run's wall time and what the rollback cost in steps and seconds. (b)
    Phase 4's six requests under ``fused`` and under ``fused_layers`` with
    ``Telemetry.for_serving`` into a temporary directory,
    ``verify_pages_every: 1`` and chaos preemption (iteration 4), a
    corrupted page (6), poisoned logits (8) and a stall (10): float32
    tokens equal ``generate()``; bf16 tokens equal phases 4 and 10 for
    every request never evicted, and for an evicted one up to its first
    eviction (reported: how far past it they agree); the
    counters (4 injections, 1 preemption, 1 corruption, retries, a hung
    iteration); one ``serve_request`` a rid; decode-kernel launches 12 a
    decode attempt under ``fused``, a megakernel launch a decode attempt
    under ``fused_layers`` (attempts: decode iterations plus retries); an
    impossible TTFT objective degrades the next admission to 16 tokens,
    phase 4's first 16; ``shutdown("evict")`` ends what is in flight FAILED
    with ``EngineClosedError``, the partial tokens phase 4's prefix; ms
    per token with the engine's telemetry on and off, alternated, beside
    phase 10's.
28. The serving fleet (``dtc_tpu_torch.serve.router`` over
    ``configs/router_config.yaml`` + ``model_config.yaml``: 3 replicas of 4
    slots sharing one model, ``placement: affinity``), twelve seeded
    prompts of 32 tokens (every third opening with a 16-token shared
    prefix), 64 new tokens each, through ``dtc_tpu_torch.serve.fleet``:
    (a) bf16 under ``fused`` with the config's documented chaos block (a
    partition at router iteration 3, a stall at 6, a kill at 9, replica
    0): every request done, none silently dropped, one death and at least
    one failover, bf16 tokens equal to ``generate()`` up to each request's
    first hop, n_layers decode-kernel launches per replica decode attempt;
    the card memory of a router of one replica and of three, the shards
    reduced (``obs.reduce_shards``), each hopped request's prefill and
    re-prefill; a replica spawned after the run serves a request with the
    run's tokens and no kernel library built or first loaded. (b) float32
    under ``fused_layers`` with ``finetune_lora.yaml``'s adapter block, two
    tenants and base requests, tenant t1's home (replica 0) killed at 9:
    every request's tokens equal ``generate()`` with its tenant's factors,
    a megakernel launch per decode attempt, t1 re-loaded on a survivor.
    Fleet times are of replicas time-sliced on one card, not a
    multi-replica throughput.

Prints one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import re
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: Published H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and
#: operations/s by input type (float32 outside the tensor cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(f"[chip-smoke] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0 and out.stdout.strip(), f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 20) -> float:
    """Mean ms per call of ``fn`` from CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


@functools.cache
def _capture_stream():
    """One stream for every capture: each stream that runs a cuBLAS call
    keeps its own workspace for the life of the process."""
    import torch

    return torch.cuda.Stream()


def graph_ms(fn, iters: int) -> float:
    """Mean ms per call of ``fn`` on the device alone: ``iters`` calls
    captured in one CUDA graph, replayed between CUDA events, so the
    launches run back to back with no host dispatch between them."""
    import torch

    side = _capture_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    graph.replay()
    e.record()
    torch.cuda.synchronize()
    graph.reset()  # frees the graph's memory pool
    return s.elapsed_time(e) / iters


def instance_name(mangled: str) -> str:
    """A kernel's mangled name as its name and ``<type, int, ...>``
    template arguments."""
    found = re.search(r"\d+([a-z_]+_kernel)I", mangled)
    kname = found.group(1) if found else mangled
    args = []
    if kname.startswith("flash"):
        # the template's types: __nv_bfloat16, float, or a repeat (S..._) of
        # the bfloat16 seen before
        seg = mangled.split(kname + "I", 1)[-1].split("Li", 1)[0]
        args = ["f32" if tok == "f" else "bf16"
                for tok in re.findall(r"13__nv_bfloat16|S\d*_|f", seg)]
    args += re.findall(r"L[ib](\d+)E", mangled)
    return f"{kname}<{', '.join(args)}>"


def ptxas_report(text: str):
    """(instance, "N registers, smem, spills") per compiled kernel from
    ``nvcc -Xptxas -v`` output (:func:`instance_name`)."""
    out, inst, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            inst = instance_name(m.group(1))
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and inst:
            out.append((inst, line.split(":", 1)[-1].strip() + "; " + spill))
            inst = None
    return out


# ---------------------------------------------------------------------------
# phase 3: the decode-attention kernel against its plain version
# ---------------------------------------------------------------------------

def decode_bound(b, s, h, d, starts, qdtype, kvdtype):
    """Least time for the call on these inputs: the bytes it must move
    (q, K and V up to each row's frontier, the int8 scales, the frontier,
    the output) over HBM bandwidth, against its operations (2 per
    multiply-add, q·K and p·V) over the peak rate of q's type."""
    el = {"float32": 4, "bfloat16": 2, "int8": 1}
    visible = sum(min(st + 1, s) for st in starts)
    hd = h * d
    nbytes = (
        2 * b * hd * el[qdtype]                 # q in, out
        + 2 * visible * hd * el[kvdtype]        # K, V
        + (2 * visible * h * 4 if kvdtype == "int8" else 0)
        + 4 * len(starts)
    )
    ops = 4 * visible * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[qdtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def decode_split_faults(q, k, v, start, h, d, kw) -> dict:
    """The kernel's split twin with a planted fault, on any device: one
    split's partials dropped (the first of every row that has more than
    one), and the partials combined without their rescale (every weight
    exp(m_j - M) taken as 1). Empty where no row has two splits."""
    from dtc_tpu_torch.ops import decode_attention as da

    m, l, acc, live = da.split_partials(q, k, v, start, h=h, d=d, **kw)
    multi = live.sum(dim=1) > 1
    if not bool(multi.any()):
        return {}
    dropped = live.clone()
    dropped[:, 0] &= ~multi
    return {
        "one split dropped": da.combine_splits(m, l, acc, dropped, q.dtype),
        "partials not rescaled": da.combine_splits(m.new_zeros(m.shape), l, acc, live, q.dtype),
    }


def kernel_case(name, b, s, h, d, qdtype, kvdtype, starts, per_row, seed, iters, ptxas=None):
    """One phase-3 case: the kernel against its plain version and its split
    twin, planted faults, times. ``ptxas``: {instance: compiler report}."""
    import torch
    import torch.nn.functional as F

    from dtc_tpu_torch.ops import _build
    from dtc_tpu_torch.ops import decode_attention as da
    from dtc_tpu_torch.parity import BF16_ULPS, FP32_ATOL, attention_tolerance

    rule = (f"{FP32_ATOL:g} absolute" if qdtype == "float32"
            else f"{BF16_ULPS} bf16 ulps of each head's max |output|")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    qdt = getattr(torch, qdtype)
    q = torch.randn(b, 1, h * d, device=dev, generator=g).to(qdt)
    kf = torch.randn(b, s, h * d, device=dev, generator=g)
    vf = torch.randn(b, s, h * d, device=dev, generator=g)
    kw = {}
    if kvdtype == "int8":
        k, ks = da.quantize_kv(kf, h)
        v, vs = da.quantize_kv(vf, h)
        kw = dict(k_scale=ks.contiguous(), v_scale=vs.contiguous())
    else:
        k, v = kf.to(getattr(torch, kvdtype)), vf.to(getattr(torch, kvdtype))
    start = torch.tensor(starts if per_row else starts[0], dtype=torch.int32, device=dev)
    row_starts = starts if per_row else [starts[0]] * b

    # The instances, the split length (the library's against the twin's) and
    # the grids: a block per (split, head, row), splits past a row's
    # frontier exiting at once; past one split, the combine's block per
    # (head, row).
    codes = da._DTYPE_CODES
    inst = f"decode_split_kernel<{codes[q.dtype]}, {codes[k.dtype]}, {d}>"
    combine = inst.replace("split", "combine")
    split = da.split_len(d, k.dtype)
    lib_split = _build.load("decode_attention").dtc_decode_split_len(codes[k.dtype], d)
    check(lib_split == split, f"{name}: the library's split length {lib_split}, the twin's {split}")
    splits = -(-s // split)
    live = h * sum(-(-min(max(x + 1, 1), s) // split) for x in row_starts)
    log(f"kernel {name}: {inst}: {(ptxas or {}).get(inst, 'no ptxas report')}; split {split} "
        f"positions, grid ({splits}, {h}, {b}), {live} live blocks")
    if splits > 1:
        log(f"kernel {name}: {combine}: {(ptxas or {}).get(combine, 'no ptxas report')}; "
            f"grid ({h}, {b})")

    got = da.fused_decode_attention(q, k, v, start, h=h, d=d, **kw)
    want = da.decode_attention_reference(q, k, v, start, h=h, d=d, **kw)
    torch.cuda.synchronize()
    check(got.shape == q.shape and got.dtype == q.dtype, f"{name}: bad output")
    check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite output")
    limit = attention_tolerance(want, h).to(dev)
    diff = (got.float() - want.float()).abs()
    err, ratio = diff.max().item(), (diff / limit).max().item()
    log(f"kernel {name}: max_abs_err {err:.3e}, {ratio:.3f} of its limit "
        f"({limit.min().item():.3e}..{limit.max().item():.3e}; {rule})")
    check(ratio <= 1.0, f"{name}: error {err} over its limit")
    twin = da.decode_split_twin(q, k, v, start, h=h, d=d, **kw)
    tdiff = (got.float() - twin.float()).abs()
    twin_ratio = (tdiff / attention_tolerance(twin, h).to(dev)).max().item()
    log(f"kernel {name}: against its split twin: max_abs_err {tdiff.max().item():.3e}, "
        f"{twin_ratio:.3f} of the limit")
    check(twin_ratio <= 1.0, f"{name}: the kernel is over the limit from its split twin")

    # What the limit can see: the plain version with a planted fault, on
    # the same inputs, must land over it. Faults: every row one visible
    # column short; past 4096 positions, the columns after them dropped;
    # the split twin with one split's partials dropped or combined without
    # their rescale (where some row has two splits).
    faults = {"one column short": [max(x - 1, 0) for x in row_starts]}
    if s > 4096:
        faults["chunks after the first dropped"] = [min(x, 4095) for x in row_starts]
    faults = {
        fname: da.decode_attention_reference(
            q, k, v, torch.tensor(fstarts, dtype=torch.int32, device=dev), h=h, d=d, **kw)
        for fname, fstarts in faults.items()
    }
    faults.update(decode_split_faults(q, k, v, start, h, d, kw))
    fault_ratio = {}
    for fname, bad in faults.items():
        fdiff = (bad.float() - want.float()).abs()
        fault_ratio[fname] = (fdiff / limit).max().item()
        log(f"kernel {name}: planted fault '{fname}': max_abs_err "
            f"{fdiff.max().item():.3e}, {fault_ratio[fname]:.3f} of the limit")
        check(fault_ratio[fname] > 1.0, f"{name}: the limit misses the fault '{fname}'")

    kernel_ms = graph_ms(lambda: da.fused_decode_attention(q, k, v, start, h=h, d=d, **kw), iters)
    wrapper_ms = cuda_ms(lambda: da.fused_decode_attention(q, k, v, start, h=h, d=d, **kw), iters)
    plain_ms = graph_ms(lambda: da.decode_attention_reference(q, k, v, start, h=h, d=d, **kw), iters)
    library_ms = None
    if kvdtype != "int8":
        # Yardstick only: one library call computing the same function.
        q4 = q.view(b, 1, h, d).transpose(1, 2)
        k4 = k.view(b, s, h, d).transpose(1, 2).to(qdt)
        v4 = v.view(b, s, h, d).transpose(1, 2).to(qdt)
        st = torch.tensor(row_starts, device=dev)
        mask = (torch.arange(s, device=dev)[None, :] <= st[:, None])[:, None, None, :]
        library_ms = graph_ms(
            lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask), iters
        )
    bound_ms, bound_by, nbytes = decode_bound(b, s, h, d, row_starts, qdtype, kvdtype)
    log(
        f"kernel {name}: kernel_ms {kernel_ms:.6f} wrapper_ms {wrapper_ms:.6f} "
        f"plain_ms {plain_ms:.6f} library_ms "
        f"{'null' if library_ms is None else f'{library_ms:.6f}'} "
        f"bound_ms {bound_ms:.6f} ({bound_by}, {nbytes} B)"
    )
    return dict(
        case=name, b=b, s=s, h=h, d=d, q_dtype=qdtype, kv_dtype=kvdtype,
        starts=starts, per_row=per_row, max_abs_err=err, err_over_limit=ratio,
        twin_over_limit=twin_ratio, limit=rule, fault_over_limit=fault_ratio,
        instance=inst, ptxas=(ptxas or {}).get(inst), split=split, grid=[splits, h, b],
        live_blocks=live, combine_ptxas=(ptxas or {}).get(combine) if splits > 1 else None,
        ms=kernel_ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
        bytes=nbytes,
    )


# ---------------------------------------------------------------------------
# phases 4-5: the serving main path
# ---------------------------------------------------------------------------

def flagship_requests(vocab: int, seed: int, max_new: int):
    import numpy as np

    from dtc_tpu_torch.serve import Request

    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, vocab, size=16).tolist()
    lengths = [8, 40, 64, 100, 31, 77]
    reqs = []
    for i, n in enumerate(lengths):
        shared = i in (1, 2)
        body = rng.randint(0, vocab, size=n - (16 if shared else 0)).tolist()
        reqs.append(Request(
            rid=f"r{i}", prompt=(prefix + body) if shared else body,
            max_new_tokens=max_new, shared_prefix_len=16 if shared else 0,
        ))
    return reqs


def serve(serve_cfg, model_cfg, seed: int, reqs, device: str = "cuda", adapters=None,
          telemetry=None):
    """Serve ``reqs`` on a fresh model from ``seed`` after a warm-up
    request; ``adapters`` ({name: factors}) are loaded into the engine
    first, ``telemetry`` (a ``Telemetry.for_serving``) is the timed
    engine's. Returns (model, engine, results, wall s, kernel launches of
    the timed run)."""
    import dataclasses

    import torch

    from dtc_tpu_torch.config.schema import ChaosConfig
    from dtc_tpu_torch.models.gpt import GPT
    from dtc_tpu_torch.ops import decode_attention as da
    from dtc_tpu_torch.serve import Request, ServingEngine

    from dtc_tpu_torch.ops import decode_fused

    cuda = device == "cuda"
    model = GPT(model_cfg, device=device, seed=seed)
    # Warm-up: one short request through a throwaway engine, so the timed
    # run below does not pay first-call costs (cuBLAS workspaces, lazy
    # module loading).
    adapters = adapters or {}
    warm = ServingEngine(model, dataclasses.replace(serve_cfg, chaos=ChaosConfig()))
    for name, fac in adapters.items():
        warm.load_adapter(name, fac)
    warm.submit(Request(rid="warm", prompt=list(reqs[0].prompt), max_new_tokens=4,
                        adapter=next(iter(adapters), None)))
    warm.run()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    eng = ServingEngine(model, serve_cfg, telemetry=telemetry)
    for name, fac in adapters.items():
        eng.load_adapter(name, fac)
    for r in reqs:
        eng.submit(r)
    da.launches = decode_fused.launches = 0  # the main path starts here
    t0 = time.perf_counter()
    # eng.run(), one iteration at a time, noting which ran a prefill
    eng.prefill_iterations = []
    for _ in range(10_000):
        before = eng.counters["serve_prefills"]
        more = eng.step()
        if eng.counters["serve_prefills"] > before:
            eng.prefill_iterations.append(eng._it)
        if not more:
            break
    res = eng.results
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(decode_attention=da.launches,  # ...and ends here
                    fused_layers=decode_fused.launches)
    return model, eng, res, wall, launches


def watchdog_report(eng, tag: str) -> list[dict]:
    """Log each iteration the serving watchdog flagged (``serve_hung_steps``):
    its index, whether it ran a prefill, its time against the trailing
    median of the working iterations before it."""
    rows = []
    for flag in eng.hung_steps:
        row = dict(flag, prefill=flag["step"] in eng.prefill_iterations)
        rows.append(row)
        log(f"{tag}: the watchdog flags iteration {flag['step']} "
            f"({'with' if row['prefill'] else 'without'} a prefill; prefills at iterations "
            f"{eng.prefill_iterations}): {flag['duration_s'] * 1e3:.1f} ms against a trailing "
            f"median of {flag['median_s'] * 1e3:.1f} ms ({flag['factor']}x, limit "
            f"{eng.cfg.watchdog.factor}x)")
    if not rows:
        log(f"{tag}: the watchdog flags no iteration")
    return rows


def profile_decode(model, serve_cfg, reqs, iterations: int = 16):
    """Device time by kernel over ``iterations`` steady decode iterations
    of a full batch (torch.profiler, CUDA activity), against the host
    wall time of the same window: the device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dtc_tpu_torch.serve import ServingEngine

    eng = ServingEngine(model, serve_cfg)
    for r in reqs[: serve_cfg.slots]:
        eng.submit(r)
    for _ in range(3):  # admissions + first decode iterations
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iterations):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return dict(iterations=iterations, **device_time_by_kernel(prof, wall))


def device_time_by_kernel(prof, wall: float) -> dict:
    """The device's busy time, busy share of ``wall`` and kernel count in a
    torch.profiler window, and its 15 largest kernels by device time."""
    from torch.autograd import DeviceType

    rows = []  # kernels only: CPU-op rows repeat their kernels' time
    for ev in prof.key_averages():
        # record_function ranges (the model's devprof scopes) put device
        # spans over their kernels: not kernels, so left out.
        if (getattr(ev, "device_type", None) != DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((ev.key, dev_us, ev.count))
    rows.sort(key=lambda r: -r[1])
    busy_s = sum(r[1] for r in rows) / 1e6
    return dict(
        wall_s=wall, device_busy_s=busy_s, busy_share=busy_s / wall,
        kernel_launches=sum(r[2] for r in rows),
        # the flash kernels (forward, dq, dk/dv), every instance
        flash_device_s=sum(r[1] for r in rows if "flash_" in r[0]) / 1e6,
        # the FSDP ring's step kernels (TPU kernel rows 17-18), every instance
        overlap_device_s=sum(r[1] for r in rows if "overlap_" in r[0]) / 1e6,
        # PyTorch's elementwise passes and its copies (dtype casts among them)
        elementwise_device_s=sum(r[1] for r in rows if "elementwise" in r[0]) / 1e6,
        copy_device_s=sum(r[1] for r in rows if "copy" in r[0].lower()) / 1e6,
        top=[dict(name=k[:120], device_ms=us / 1e3, count=c) for k, us, c in rows[:15]],
    )


def percentile(xs, q):
    """Nearest-rank percentile (the ceil(q*n)-th smallest)."""
    xs = sorted(xs)
    return xs[max(0, math.ceil(q * len(xs)) - 1)]


def zero_flash_counts() -> None:
    """Set every flash launch counter to 0, those by route too: the path
    starts here."""
    from dtc_tpu_torch.ops import flash_attention as fa

    fa.fwd_launches = fa.bwd_launches = fa.block_fwd_launches = fa.block_bwd_launches = 0
    for counts in (fa.fwd_route_launches, fa.dq_route_launches, fa.dkv_route_launches):
        counts.update(dict.fromkeys(counts, 0))


def flash_routes() -> dict:
    """The flash launches by kind and route since :func:`zero_flash_counts`."""
    from dtc_tpu_torch.ops import flash_attention as fa

    return {"fwd": dict(fa.fwd_route_launches), "dq": dict(fa.dq_route_launches),
            "dkv": dict(fa.dkv_route_launches)}


def check_flash_routes(what: str, dtype: str) -> dict:
    """Every flash forward, dq and dk/dv launch since
    :func:`zero_flash_counts` (the causal wrappers' and the ring blocks')
    took the route of ``dtype``'s plan: bfloat16 "tc" (tensor cores),
    float32 "fma" (CUDA cores). Returns the launches by route."""
    from dtc_tpu_torch.ops import flash_attention as fa

    want = "tc" if dtype == "bfloat16" else "fma"
    fwd = fa.fwd_launches + fa.block_fwd_launches
    bwd = (fa.bwd_launches + fa.block_bwd_launches) // fa.BWD_KERNELS
    got = flash_routes()
    expect = {kind: {r: n if r == want else 0 for r in got[kind]}
              for kind, n in (("fwd", fwd), ("dq", bwd), ("dkv", bwd))}
    check(got == expect, f"{what}: flash launches by route {got}, want {expect}")
    return got


# ---------------------------------------------------------------------------
# phase 6: the flash-attention kernels against their plain versions
# ---------------------------------------------------------------------------

def flash_bounds(b, t, h, d, dtype):
    """Least time of the forward, of the backward and of both on these
    inputs: the bytes each must move (forward q, k, v in, out and lse out;
    backward q, k, v, out, dO and lse in, dq, dk, dv out) over HBM
    bandwidth, against the causal products it must do (key <= query pairs
    only: 2 products in the forward, 5 in the backward, 2 operations per
    multiply-add) over the peak rate of the dtype. Returns
    {"fwd"|"bwd"|"fwd_bwd": (ms, bound_by, bytes)}."""
    el = {"float32": 4, "bfloat16": 2}[dtype]
    tensor = b * t * h * d * el
    stats = b * h * t * 4
    pairs = b * h * t * (t + 1) // 2
    out = {}
    for kind, nbytes, products in (("fwd", 4 * tensor + stats, 2),
                                   ("bwd", 8 * tensor + stats, 5),
                                   ("fwd_bwd", 12 * tensor + 2 * stats, 7)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * products * pairs * d / PEAK_OPS[dtype] * 1e3
        out[kind] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", nbytes)
    return out


def dq_bound(b, t, h, d, dtype, causal, grad_dtype):
    """Least time of the dq kernel alone on these inputs: the bytes it must
    move (q, k, v, out, dO and lse in, dq in ``grad_dtype`` and delta out)
    over HBM bandwidth, against its three products (S, dP, dS·K) on the
    visible (query, key) pairs over the dtype's peak rate. Returns (ms,
    bound_by, bytes)."""
    el, gel = ({"float32": 4, "bfloat16": 2}[x] for x in (dtype, grad_dtype))
    tensor = b * t * h * d
    stats = b * h * t * 4
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    nbytes = 5 * tensor * el + tensor * gel + 2 * stats
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * 3 * pairs * d / PEAK_OPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", nbytes


def dq_plain(q, k, v, out, lse, do, h, causal, grad_dtype=None, *, round_ds=True,
             round_scale=True, delta_shift=0, pad_keys=0):
    """The plain dq (``flash_attention_backward_reference``'s arithmetic)
    with a planted fault: dS not rounded to k's dtype (``round_ds``); q
    scaled by the float32 ``D**-0.5`` with no rounding (``round_scale``);
    delta read ``delta_shift`` rows on; K and V zero-padded by ``pad_keys``
    rows that no mask keeps out (without ``causal``, as the last tile past
    a ragged T is staged)."""
    import torch

    from dtc_tpu_torch.ops import flash_attention as fa

    b, t, hd = q.shape
    d = hd // h
    q4, k4, v4, do4, o4 = (x.reshape(b, -1, h, d) for x in (q, k, v, do, out))
    qs = (q4 * fa._scale_q(d, q.dtype)).float() if round_scale else q4.float() * d ** -0.5
    if pad_keys:
        k4, v4 = (torch.cat([x, x.new_zeros(b, pad_keys, h, d)], dim=1) for x in (k4, v4))
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qs, k4.float()) - lse[..., None])
    if causal:
        ar = torch.arange(t + pad_keys, device=q.device)
        p = torch.where(ar[None, :t + pad_keys] <= ar[:t, None], p, 0.0)
    delta = (do4.float() * o4.float()).sum(-1).permute(0, 2, 1).roll(-delta_shift, dims=-1)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do4.float(), v4.float()) - delta[..., None])
    if round_ds:
        ds = ds.to(k.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k4.float()) * fa._scale(d)
    return dq.to(grad_dtype or q.dtype).reshape(b, t, hd)


def dq_fault_cases(device: str = "cuda") -> dict:
    """Planted faults of the dq kernel on crafted bf16 inputs (T 2, one
    head of 32, given out and lse), each over ``grad_tolerance`` of the
    true dq while the kernel stays within it (the plain version on the
    CPU). A fault that makes dq non-finite counts as over the limit.

    - dS not rounded to bf16: query 1 sees two keys, both e0, with dP
      256.5 and -256 and delta 0, so dS rounds to 256 and -256 and dq's row
      is 0; unrounded it is 0.5 D^-0.5.
    - q's scale unrounded: q e0, key 0 5120 e0, lse the rounded score 905:
      p 1; unrounded the score is 905.097 and p 1.10.
    - keys past a ragged T unmasked, no causal mask: K and V are zeros
      there, so a key past T adds p (0 - delta) times a zero row to dq,
      nothing unless p overflows; with lse -100 it does (exp(100) is inf in
      float32), and inf times a zero row is NaN. The real keys' scores are
      -181 (p = exp(-81)), so the true dq is finite.

    Returns {fault: (kernel's ratio, fault's ratio)}."""
    import torch

    from dtc_tpu_torch.ops import flash_attention as fa
    from dtc_tpu_torch.parity import grad_tolerance

    dev = torch.device(device)
    bf = torch.bfloat16

    def case():
        return [torch.zeros(1, 2, 32, device=dev) for _ in range(5)] + [
            torch.zeros(1, 1, 2, device=dev)]

    q, k, v, out, do, lse = case()
    k[0, :, 0], v[0, 0, 0], v[0, 0, 1], v[0, 1, 0], do[0, 1, :2] = 1, 256, 0.5, -256, 1
    cancelling = (q, k, v, out, do, lse, True, dict(round_ds=False))
    q, k, v, out, do, lse = case()
    q[0, 1, 0], k[0, 0, 0], v[0, 0, 1], do[0, 1, 1], lse[0, 0, 1] = 1, 5120, 1, 1, 905
    scale = (q, k, v, out, do, lse, True, dict(round_scale=False))
    q, k, v, out, do, lse = case()
    q[0, :, 0], k[0, :, 0], out[0, :, 1], do[0, :, 1], lse[:] = 16, -64, 1, 1, -100
    tail = (q, k, v, out, do, lse, False, dict(pad_keys=62))

    res = {}
    for name, (q, k, v, out, do, lse, causal, fault) in (
            ("dS not rounded to bf16 (cancelling row)", cancelling),
            ("q's scale unrounded", scale),
            ("keys past a ragged T unmasked, no causal mask", tail)):
        q, k, v, out, do = (x.to(bf) for x in (q, k, v, out, do))
        want = dq_plain(q, k, v, out, lse, do, 1, causal)
        if device == "cpu":
            got, _ = fa.flash_dq_twin(q, k, v, out, lse, do, 1, causal)
        else:
            got, _ = fa._dq_kernel(q, k, v, out, lse, do, 1, causal, bf)
        bad = dq_plain(q, k, v, out, lse, do, 1, causal, **fault)
        limit = grad_tolerance(want, 1).to(dev)
        ratios = []
        for x in (got, bad):
            diff = (x.float() - want.float()).abs().nan_to_num(nan=math.inf)
            ratios.append((diff / limit).max().item())
        check(math.isfinite(want.float().abs().max().item()), f"dq fault case '{name}': "
              "the true dq is not finite")
        res[name] = tuple(ratios)
    return res


def _flash_faulty_forward(q, k, v, h):
    """The plain forward with the causal mask one column off (each query
    also sees the next key): what the limit must catch."""
    import torch

    b, t, hd = q.shape
    d = hd // h
    qs = q.view(b, t, h, d) * float(torch.tensor(d ** -0.5, dtype=q.dtype))
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.view(b, t, h, d).float())
    ar = torch.arange(t, device=q.device)
    s = torch.where(ar[None, :] <= ar[:, None] + 1, s, -1e9)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.view(b, t, h, d).float())
    return o.to(q.dtype).reshape(b, t, hd)


def _flash_backward_without_delta(q, k, v, out, lse, do, h):
    """The plain backward with delta = rowsum(dO ⊙ O) dropped (a zero
    output passed in its place makes delta 0)."""
    import torch

    from dtc_tpu_torch.ops import flash_attention as fa

    return fa.flash_attention_backward_reference(q, k, v, torch.zeros_like(out), lse, do, h)


def _by_rows(fn, rows, *xs):
    """``fn`` over ``xs`` a batch slice of ``rows`` rows at a time, the
    outputs concatenated along the batch: the same function, since the
    plain versions treat every batch row apart, in a fraction of their
    memory."""
    import torch

    if rows is None:
        return fn(*xs)
    parts = [fn(*(x[i:i + rows] for x in xs)) for i in range(0, xs[0].shape[0], rows)]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts)
    return tuple(torch.cat(p) for p in zip(*parts))


def flash_case(name, b, t, h, d, dtype, seed, iters, rows=None):
    """The flash kernels against their plain versions on one shape: the
    errors over their limits, the planted faults over them, and device
    times beside the bounds. ``rows``: run the plain versions (and the
    faults) that many batch rows at a time, timed eagerly (CUDA events
    around whole calls), where a whole call's float32 (B, H, T, T)
    tensors would not fit."""
    import torch
    import torch.nn.functional as F

    from dtc_tpu_torch.ops import flash_attention as fa
    from dtc_tpu_torch.parity import FP32_ATOL, attention_tolerance, grad_tolerance

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(b, t, h * d, device=dev, generator=g).to(dt) for _ in range(4))

    def ref_fwd(q, k, v):
        return fa.flash_attention_reference(q, k, v, h)

    def ref_bwd(q, k, v, o, lse, do):
        return fa.flash_attention_backward_reference(q, k, v, o, lse, do, h)

    def ratio(got, want, limit):
        diff = (got.float() - want.float()).abs()
        return diff.max().item(), (diff / limit.to(dev)).max().item()

    zero_flash_counts()
    out, lse = fa.flash_attention_forward(q, k, v, h)
    want_out, want_lse = _by_rows(ref_fwd, rows, q, k, v)
    grads = fa.flash_attention_backward(q, k, v, want_out, want_lse, do, h)
    routes = check_flash_routes(f"flash {name}", dtype)
    want_grads = _by_rows(ref_bwd, rows, q, k, v, want_out, want_lse, do)
    torch.cuda.synchronize()
    limits = {"out": attention_tolerance(want_out, h),
              "lse": torch.full(want_lse.shape, FP32_ATOL)}
    limits.update({n: grad_tolerance(w, h) for n, w in zip(("dq", "dk", "dv"), want_grads)})
    pairs = {"out": (out, want_out), "lse": (lse, want_lse)}
    pairs.update({n: (gg, w) for n, gg, w in zip(("dq", "dk", "dv"), grads, want_grads)})
    errs = {}
    for n, (got, want) in pairs.items():
        check(bool(torch.isfinite(got.float()).all()), f"flash {name}: non-finite {n}")
        errs[n] = ratio(got, want, limits[n])
        log(f"flash {name}: {n} max_abs_err {errs[n][0]:.3e}, {errs[n][1]:.3f} of its limit")
        check(errs[n][1] <= 1.0, f"flash {name}: {n} error {errs[n][0]} over its limit")
    del out, lse, grads

    faults = {
        "causal mask one column off (out)": (
            _by_rows(lambda q, k, v: _flash_faulty_forward(q, k, v, h), rows, q, k, v),
            want_out, limits["out"]),
    }
    bad = _by_rows(lambda *xs: _flash_backward_without_delta(*xs, h), rows,
                   q, k, v, want_out, want_lse, do)
    for n, gb, w in zip(("dq", "dk"), bad, want_grads):
        faults[f"delta dropped ({n})"] = (gb, w, limits[n])
    faults["delta from the next row (dq)"] = (
        _by_rows(lambda *xs: dq_plain(*xs, h, True, delta_shift=1), rows,
                 q, k, v, want_out, want_lse, do), want_grads[0], limits["dq"])
    fault_ratio = {}
    for fname, (got, want, limit) in faults.items():
        fault_ratio[fname] = ratio(got, want, limit)[1]
        log(f"flash {name}: planted fault '{fname}': {fault_ratio[fname]:.3f} of the limit")
        check(fault_ratio[fname] > 1.0, f"flash {name}: the limit misses '{fname}'")
    del faults, bad, want_grads, limits
    torch.cuda.empty_cache()

    # Device times, each from ``iters`` calls replayed as one CUDA graph.
    fwd_ms = graph_ms(lambda: fa.flash_attention_forward(q, k, v, h), iters)
    bwd_ms = graph_ms(
        lambda: fa.flash_attention_backward(q, k, v, want_out, want_lse, do, h), iters)
    _, delta = fa._dq_kernel(q, k, v, want_out, want_lse, do, h, True, dt)
    dq_ms = graph_ms(lambda: fa._dq_kernel(q, k, v, want_out, want_lse, do, h, True, dt), iters)
    dkv_ms = graph_ms(
        lambda: fa._dkv_kernel(q, k, v, want_lse, delta, do, h, True, dt), iters)
    del delta
    plain_timer = graph_ms if rows is None else functools.partial(cuda_ms, warmup=1)
    plain_fwd_ms = plain_timer(lambda: _by_rows(ref_fwd, rows, q, k, v), iters)
    plain_bwd_ms = plain_timer(
        lambda: _by_rows(ref_bwd, rows, q, k, v, want_out, want_lse, do), iters)
    torch.cuda.empty_cache()
    # Yardstick only, never called by the port: SDPA's forward, and its
    # backward alone (the forward's graph is kept and differentiated again).
    q4, k4, v4 = (x.view(b, t, h, d).transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    do4 = do.view(b, t, h, d).transpose(1, 2)
    lib_fwd_ms = graph_ms(
        lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True), iters)
    # The forward runs on the capture stream, where autograd then runs its
    # backward.
    side = _capture_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    torch.cuda.current_stream().wait_stream(side)
    lib_bwd_ms = graph_ms(
        lambda: torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True), iters)
    lib_fwd_bwd_ms = graph_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(q4, k4, v4, is_causal=True), (q4, k4, v4), do4), iters)
    bounds = flash_bounds(b, t, h, d, dtype)
    for kind, ms, plain, lib in (("fwd", fwd_ms, plain_fwd_ms, lib_fwd_ms),
                                 ("bwd", bwd_ms, plain_bwd_ms, lib_bwd_ms)):
        bms, by, nbytes = bounds[kind]
        log(f"flash {name} {kind}: kernel_ms {ms:.6f} plain_ms {plain:.6f} library_ms "
            f"{lib:.6f} bound_ms {bms:.6f} ({by}, {nbytes} B)")
    dq_b = dq_bound(b, t, h, d, dtype, True, dtype)
    route = fa.flash_plan(dt, d, True).route
    log(f"flash {name} bwd: dq kernel {dq_ms:.6f} ms ({route}; bound {dq_b[0]:.6f} ms, "
        f"{dq_b[1]}), dk/dv kernel {dkv_ms:.6f} ms ({route})")
    log(f"flash {name}: kernels fwd + bwd {fwd_ms + bwd_ms:.6f} ms, SDPA fwd + bwd "
        f"{lib_fwd_bwd_ms:.6f} ms, bound {bounds['fwd_bwd'][0]:.6f} ms ({bounds['fwd_bwd'][1]})")
    return dict(
        case=name, b=b, t=t, h=h, d=d, dtype=dtype, errors=errs, fault_over_limit=fault_ratio,
        plain_rows_at_a_time=rows, routes=routes,
        fwd_max_abs_err=max(errs["out"][0], errs["lse"][0]),
        bwd_max_abs_err=max(errs[n][0] for n in ("dq", "dk", "dv")),
        fwd_ms=fwd_ms, bwd_ms=bwd_ms, dq_ms=dq_ms, dkv_ms=dkv_ms,
        dq_bound_ms=dq_b[0], dq_bound_by=dq_b[1],
        plain_fwd_ms=plain_fwd_ms, plain_bwd_ms=plain_bwd_ms,
        library_fwd_ms=lib_fwd_ms, library_bwd_ms=lib_bwd_ms, library_fwd_bwd_ms=lib_fwd_bwd_ms,
        fwd_bound_ms=bounds["fwd"][0], fwd_bound_by=bounds["fwd"][1],
        bwd_bound_ms=bounds["bwd"][0], bwd_bound_by=bounds["bwd"][1],
        fwd_bwd_bound_ms=bounds["fwd_bwd"][0], fwd_bwd_bound_by=bounds["fwd_bwd"][1],
    )


# ---------------------------------------------------------------------------
# phases 7-8: the training main path
# ---------------------------------------------------------------------------

def train_flagship(steps: int, warmup: int, out_dir: str):
    """``python -m dtc_tpu_torch.main --train_config_path
    configs/train_config_dp.yaml --dataset synthetic --no-obs``, with
    ``steps`` timed steps after ``warmup`` warmup steps and ``log.csv`` in
    ``out_dir``. Returns (result, configs, launches (fwd, bwd), peak bytes)."""
    import dataclasses

    import torch

    from dtc_tpu_torch.config.loader import load_config
    from dtc_tpu_torch.ops import flash_attention as fa
    from dtc_tpu_torch.train.trainer import train

    tcfg, mcfg, ocfg = load_config(ROOT / "configs" / "train_config_dp.yaml")
    tcfg = dataclasses.replace(
        tcfg, dataset="synthetic", obs=dataclasses.replace(tcfg.obs, enabled=False),
        steps=steps, warmup_steps=warmup, log_every=10, output_dir=out_dir,
        overwrite=True,
    )
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_flash_counts()                          # the main path starts here
    res = train(tcfg, mcfg, ocfg)
    launches = (fa.fwd_launches, fa.bwd_launches)  # ...and ends here
    check_flash_routes("flagship training", mcfg.compute_dtype)
    peak = torch.cuda.max_memory_allocated() - base
    return res, (tcfg, mcfg, ocfg), launches, peak


def profile_train(model_cfg, train_cfg, opt_cfg, steps: int = 5, host_keys=(),
                  device: str = "cuda", fsdp=None):
    """Device time by kernel over ``steps`` steady training steps of the
    flagship (torch.profiler, CUDA activity) against the host wall time of
    the same window: the device's busy share. ``host_keys``: profiler rows
    (host ranges and ops) whose names hold one of these are also returned,
    with their host and device times. ``fsdp``: the steps' FSDP state. An
    adapter-enabled ``model_cfg`` profiles the LoRA finetune's step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dtc_tpu_torch.data.prefetch import split_to_device
    from dtc_tpu_torch.data.synthetic import synthetic_batch_iterator
    from dtc_tpu_torch.models.gpt import GPT
    from dtc_tpu_torch.train.optimizer import create_optimizer
    from dtc_tpu_torch.train.train_step import train_step

    dev = torch.device(device)
    model = GPT(model_cfg, device=dev, seed=train_cfg.seed)
    trainable, lora = model.parameters(), None
    if model_cfg.adapter.rank > 0:  # a LoRA finetune's step: the factors alone train
        from dtc_tpu_torch.adapters.lora import init_lora

        model.requires_grad_(False)
        lora = {k: v.requires_grad_(True) for k, v in init_lora(model, train_cfg.seed).items()}
        trainable = lora.values()
    opt = create_optimizer(trainable, opt_cfg, total_steps=train_cfg.steps)
    gen = torch.Generator(device=dev).manual_seed(train_cfg.seed)
    batches = synthetic_batch_iterator(train_cfg.batch, model_cfg.max_seq_len + 1,
                                       model_cfg.vocab_size, seed=train_cfg.seed * 1000)
    for _ in range(3):
        train_step(model, opt, *split_to_device(next(batches), dev), gen, fsdp, lora=lora)
    data = [split_to_device(next(batches), dev) for _ in range(steps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x, y in data:
            train_step(model, opt, x, y, gen, fsdp, lora=lora)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    host = [dict(name=ev.key[:80], count=ev.count, host_ms=ev.cpu_time_total / 1e3,
                 device_ms=getattr(ev, "device_time_total", 0) / 1e3)
            for ev in prof.key_averages() if any(k in ev.key for k in host_keys)]
    return dict(steps=steps, host=host, **device_time_by_kernel(prof, wall))


def profile_nccl_world1(model_cfg, train_cfg, opt_cfg, steps: int = 10,
                        device: str = "cuda"):
    """Phase 17's flagship step profiled alone and then inside an NCCL
    process group of one rank (joined here as torchrun's environment asks;
    ``train_step`` then averages the gradients): wall and device time per
    step of each, and the host and device time of the gradient average
    (``average_over_ranks``) and of its all-reduce."""
    import os

    from torch.profiler import record_function

    from dtc_tpu_torch.train import train_step as ts_mod
    from dtc_tpu_torch.utils import dist as dist_utils

    real_avg = ts_mod.average_over_ranks

    def avg(*a, **k):
        with record_function("average_over_ranks"):
            return real_avg(*a, **k)

    out = {}
    for mode in ("alone", "nccl"):
        env = dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0", MASTER_ADDR="localhost",
                   MASTER_PORT=str(_free_port())) if mode == "nccl" else {}
        os.environ.update(env)
        ts_mod.average_over_ranks = avg
        try:
            dist_utils.initialize(device)
            out[mode] = profile_train(model_cfg, train_cfg, opt_cfg, steps,
                                      host_keys=("average_over_ranks", "all_reduce",
                                                 "allreduce", "nccl", "Optimizer.step"),
                                      device=device)
        finally:
            ts_mod.average_over_ranks = real_avg
            dist_utils.teardown()
            for key in env:
                del os.environ[key]
    return out


def path_agreement(seed: int, head_dim: int = 32, steps: int = 4, max_seq_len: int = 256):
    """A small float32 model (8 heads of ``head_dim``, T ``max_seq_len``,
    batch 4) trained ``steps`` steps once with the flash kernels and once with dense
    attention, same weights and batches: returns the two loss lists and
    the flash run's kernel launches (forward, backward)."""
    import dataclasses

    from dtc_tpu_torch.config.schema import ModelConfig, ObsConfig, OptimConfig, TrainConfig
    from dtc_tpu_torch.ops import flash_attention as fa
    from dtc_tpu_torch.train.trainer import train

    tcfg = TrainConfig(seed=seed, parallel="dp", batch=4, steps=steps, log_every=steps,
                       output_dir="", dataset="synthetic", warmup_steps=0, prefetch=0,
                       obs=ObsConfig(enabled=False))
    ocfg = OptimConfig(lr=1e-3, weight_decay=0.1, grad_clip=1.0)
    d_model = 8 * head_dim
    base = ModelConfig(vocab_size=1000, d_model=d_model, n_layers=2, n_heads=8,
                       d_ff=4 * d_model, max_seq_len=max_seq_len, dropout=0.0,
                       compute_dtype="float32")
    losses, launches = {}, {}
    for impl in ("flash", "dense"):
        fa.fwd_launches = fa.bwd_launches = 0    # the path starts here
        losses[impl] = train(tcfg, dataclasses.replace(base, attention=impl), ocfg).losses
        launches[impl] = (fa.fwd_launches, fa.bwd_launches)  # ...and ends here
        want = (base.n_layers * steps, base.n_layers * steps * fa.BWD_KERNELS)
        check(launches[impl] == (want if impl == "flash" else (0, 0)),
              f"path agreement: attention {impl} launched the flash kernels {launches[impl]} "
              f"times")
    return losses, launches["flash"]


# ---------------------------------------------------------------------------
# phases 13-14: long-context training and the remat modes
# ---------------------------------------------------------------------------

def train_long_context(out_dir: str, steps: int, t8192: bool = False):
    """13(a): ``python -m dtc_tpu_torch.main --train_config_path
    configs/train_config_longctx.yaml --model_config_path
    configs/model_config_longctx.yaml --dataset synthetic --no-obs --steps
    STEPS --output_dir OUT_DIR`` (5 warmup steps, the trainer's default).
    13(b) with ``t8192``: the same configs after
    ``dataclasses.replace(max_seq_len=8192, attention_block_kv_bwd=1024)``
    and batch 2, as ``bench.py``'s ``long_context_t8192_b2``, through
    ``train()``. Returns (result, configs, launches (fwd, bwd), peak bytes)."""
    import dataclasses

    import torch

    from dtc_tpu_torch import main as cli
    from dtc_tpu_torch.config.loader import load_config
    from dtc_tpu_torch.ops import flash_attention as fa
    from dtc_tpu_torch.train.trainer import train

    cfgs = [ROOT / "configs" / n for n in ("train_config_longctx.yaml",
                                           "model_config_longctx.yaml")]
    tcfg, mcfg, ocfg = load_config(*cfgs)
    tcfg = dataclasses.replace(
        tcfg, dataset="synthetic", obs=dataclasses.replace(tcfg.obs, enabled=False),
        steps=steps, output_dir=out_dir)
    if t8192:
        mcfg = dataclasses.replace(mcfg, max_seq_len=8192, attention_block_kv_bwd=1024)
        tcfg = dataclasses.replace(tcfg, batch=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_flash_counts()                          # the main path starts here
    if t8192:
        res = train(tcfg, mcfg, ocfg)
    else:
        res = cli.main(["--train_config_path", str(cfgs[0]), "--model_config_path",
                        str(cfgs[1]), "--dataset", "synthetic", "--no-obs", "--steps",
                        str(steps), "--output_dir", out_dir])
    launches = (fa.fwd_launches, fa.bwd_launches)  # ...and ends here
    check_flash_routes(f"long context T {mcfg.max_seq_len}", mcfg.compute_dtype)
    peak = torch.cuda.max_memory_allocated() - base
    return res, (tcfg, mcfg, ocfg), launches, peak


def remat_modes(warmup: int = 2, steps: int = 4, ce_rows: int | None = None):
    """14: the T 4096 long-context configs (B 4, dropout 0.1, bfloat16)
    under each remat mode, ``warmup`` + ``steps`` steps from one seed, no
    ``log.csv``; with ``ce_rows`` the head + CE works on that many rows at
    a time (all 16,384 of them: the backward as it was before it was
    chunked). Returns ({mode: (losses, launches (fwd, bwd), peak bytes,
    train_memory_bytes, mean step seconds)}, train config, model config)."""
    import dataclasses

    import torch

    from dtc_tpu_torch.config.loader import load_config
    from dtc_tpu_torch.ops import flash_attention as fa
    from dtc_tpu_torch.ops import fused_ce
    from dtc_tpu_torch.train.trainer import train
    from dtc_tpu_torch.utils.metrics import train_memory_bytes

    tcfg, mcfg, ocfg = load_config(ROOT / "configs" / "train_config_longctx.yaml",
                                   ROOT / "configs" / "model_config_longctx.yaml")
    tcfg = dataclasses.replace(tcfg, dataset="synthetic", steps=steps, warmup_steps=warmup,
                               obs=dataclasses.replace(tcfg.obs, enabled=False), output_dir="")
    out = {}
    default_rows = fused_ce.CE_CHUNK_ROWS
    fused_ce.CE_CHUNK_ROWS = ce_rows or default_rows
    try:
        for mode in ("none", "block", "block_save_flash", "mlp"):
            cfg = dataclasses.replace(mcfg, remat=mode)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            zero_flash_counts()                      # the path starts here
            res = train(tcfg, cfg, ocfg)
            launches = (fa.fwd_launches, fa.bwd_launches)  # ...and ends here
            check_flash_routes(f"remat {mode}", cfg.compute_dtype)
            peak = torch.cuda.max_memory_allocated() - base
            out[mode] = (res.losses, launches, peak,
                         train_memory_bytes(cfg, tcfg.batch, cfg.max_seq_len),
                         res.elapsed_times[-1] / steps)
            del res
    finally:
        fused_ce.CE_CHUNK_ROWS = default_rows
    return out, tcfg, mcfg


def memory_trace(ce_rows: int | None = None, min_bytes: int = 256 << 20):
    """One ``remat: none`` training step of the T 4096 long-context model
    under ``torch.cuda.memory``'s allocation history (the head + CE on
    ``ce_rows`` rows at a time, its default when None): the step's peak
    above what was allocated before it, and the blocks of at least
    ``min_bytes`` live at that peak, by the port's source line that
    allocated them (innermost ``dtc_tpu_torch`` frame)."""
    import dataclasses

    import torch

    from dtc_tpu_torch.config.loader import load_config
    from dtc_tpu_torch.data.prefetch import split_to_device
    from dtc_tpu_torch.data.synthetic import synthetic_batch_iterator
    from dtc_tpu_torch.models.gpt import GPT
    from dtc_tpu_torch.ops import fused_ce
    from dtc_tpu_torch.train.optimizer import create_optimizer
    from dtc_tpu_torch.train.train_step import train_step

    tcfg, mcfg, ocfg = load_config(ROOT / "configs" / "train_config_longctx.yaml",
                                   ROOT / "configs" / "model_config_longctx.yaml")
    mcfg = dataclasses.replace(mcfg, remat="none")
    dev = torch.device("cuda")
    model = GPT(mcfg, seed=tcfg.seed)
    opt = create_optimizer(model.parameters(), ocfg, total_steps=2)
    gen = torch.Generator(device=dev).manual_seed(tcfg.seed)
    batches = synthetic_batch_iterator(tcfg.batch, mcfg.max_seq_len + 1, mcfg.vocab_size,
                                       seed=tcfg.seed * 1000)
    default_rows = fused_ce.CE_CHUNK_ROWS
    fused_ce.CE_CHUNK_ROWS = ce_rows or default_rows
    try:
        train_step(model, opt, *split_to_device(next(batches), dev), gen)
        x, y = split_to_device(next(batches), dev)
        torch.cuda.synchronize()
        torch.cuda.memory._record_memory_history(stacks="python", max_entries=1 << 20,
                                                 clear_history=True)
        train_step(model, opt, x, y, gen)
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
        torch.cuda.memory._record_memory_history(enabled=None)
    finally:
        fused_ce.CE_CHUNK_ROWS = default_rows
    events = snap["device_traces"][torch.cuda.current_device()]

    def replay(stop=None):
        live, cur, peak, at = {}, 0, 0, 0
        for i, ev in enumerate(events[:stop]):
            if ev["action"] == "alloc":
                live[ev["addr"]] = ev
                cur += ev["size"]
            elif ev["action"] == "free_requested" and ev["addr"] in live:
                cur -= live.pop(ev["addr"])["size"]
            if cur > peak:
                peak, at = cur, i + 1
        return live, peak, at

    _, peak, at = replay()
    live, _, _ = replay(at)
    big: dict[str, list[int]] = {}
    for ev in live.values():
        if ev["size"] < min_bytes:
            continue
        frame = next((f for f in ev.get("frames", []) if "dtc_tpu_torch" in f["filename"]),
                     None)
        where = (f"{Path(frame['filename']).name}:{frame['line']} ({frame['name']})"
                 if frame else "?")
        big.setdefault(where, []).append(ev["size"])
    del model, opt
    torch.cuda.empty_cache()
    return dict(ce_rows=ce_rows or default_rows, peak_above_step_start=peak, events=len(events),
                live_at_peak={w: sorted(v, reverse=True) for w, v in big.items()},
                live_big_bytes=sum(sum(v) for v in big.values()))


# ---------------------------------------------------------------------------
# phase 15: the ring's block kernels against their plain versions
# ---------------------------------------------------------------------------

def block_bounds(b, tc, h, d, dtype, causal):
    """Least time of the ring's block forward and backward on these inputs:
    the bytes each must move (forward q, k, v in, out and lse out; backward
    q, k, v, out, dO and lse in, float32 dq, dk, dv out) over HBM bandwidth,
    against the products on the visible (query, key) pairs (all tc² without
    the causal mask; 2 products in the forward, 5 in the backward, 2
    operations per multiply-add) over the dtype's peak rate. Returns
    {"fwd"|"bwd": (ms, bound_by, bytes)}."""
    el = {"float32": 4, "bfloat16": 2}[dtype]
    tensor = b * tc * h * d
    stats = b * h * tc * 4
    pairs = b * h * (tc * (tc + 1) // 2 if causal else tc * tc)
    out = {}
    for kind, nbytes, products in (("fwd", 4 * tensor * el + stats, 2),
                                   ("bwd", 5 * tensor * el + stats + 3 * tensor * 4, 5)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * products * pairs * d / PEAK_OPS[dtype] * 1e3
        out[kind] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", nbytes)
    return out


def _block_forward_unmasked_tail(q, k, v, h):
    """The plain non-causal block forward over keys zero-padded to a
    multiple of the kernels' 64-key tile, the padding left unmasked: what
    the ``key < n`` mask of the last, partial tile keeps out."""
    import torch

    from dtc_tpu_torch.ops import flash_attention as fa

    b, tc, hd = q.shape
    pad = (-tc) % 64
    kp, vp = (torch.cat([x, x.new_zeros(b, pad, hd)], dim=1) for x in (k, v))
    d = hd // h
    qs = q.view(b, tc, h, d) * fa._scale_q(d, q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), kp.view(b, tc + pad, h, d).float())
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vp.view(b, tc + pad, h, d).float())
    return o.to(q.dtype).reshape(b, tc, hd)


def bf16_share(x) -> float:
    """Share of ``x``'s float32 values that bfloat16 cannot hold (near 1
    for real float32 results; 0 for values rounded to bfloat16)."""
    import torch

    return float((x.to(torch.bfloat16).float() != x).float().mean())


def block_case(name, b, tc, h, d, dtype, seed, iters, device: str = "cuda"):
    """The ring's block kernels against their plain versions at one chunk
    shape: forward causal and not, the backward (both) from a given lse
    and out (the block's own, its lse raised by log 2 as if the ring had
    merged as much mass again); errors over the limits, planted faults
    over them, device times beside the bounds and SDPA's."""
    import torch
    import torch.nn.functional as F

    from dtc_tpu_torch.ops import flash_attention as fa
    from dtc_tpu_torch.parity import FP32_ATOL, attention_tolerance, grad_tolerance

    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(b, tc, h * d, device=dev, generator=g).to(dt) for _ in range(4))

    def ratio(got, want, limit):
        diff = (got.float() - want.float()).abs()
        return diff.max().item(), (diff / limit.to(dev)).max().item()

    errs, faults, given = {}, {}, {}
    for causal in (False, True):
        tag = "causal" if causal else "full"
        zero_flash_counts()
        out, lse = fa.flash_block_forward(q, k, v, h, causal)
        want_out, want_lse = fa.flash_block_reference(q, k, v, h, causal)
        lse_g = want_lse + math.log(2.0)
        grads = fa.flash_block_backward(q, k, v, want_out, lse_g, do, h, causal)
        check_flash_routes(f"block {name} {tag}", dtype)
        want_grads = fa.flash_block_backward_reference(q, k, v, want_out, lse_g, do, h, causal)
        torch.cuda.synchronize()
        limits = {"out": attention_tolerance(want_out, h),
                  "lse": torch.full(want_lse.shape, FP32_ATOL)}
        for n, w in zip(("dq", "dk", "dv"), want_grads):
            limits[n] = grad_tolerance(w.to(dt), h)
        pairs = {"out": (out, want_out), "lse": (lse, want_lse)}
        pairs.update({n: (gg, w) for n, gg, w in zip(("dq", "dk", "dv"), grads, want_grads)})
        for n, (got, want) in pairs.items():
            check(bool(torch.isfinite(got.float()).all()), f"block {name} {tag}: non-finite {n}")
            errs[f"{tag}_{n}"] = ratio(got, want, limits[n])
            log(f"block {name} {tag}: {n} max_abs_err {errs[f'{tag}_{n}'][0]:.3e}, "
                f"{errs[f'{tag}_{n}'][1]:.3f} of its limit")
            check(errs[f"{tag}_{n}"][1] <= 1.0, f"block {name} {tag}: {n} over its limit")
        shares = [bf16_share(gg) for gg in grads]
        check(all(gg.dtype == torch.float32 for gg in grads) and min(shares) > 0.5,
              f"block {name} {tag}: gradients not float32 ({[gg.dtype for gg in grads]}, "
              f"share bf16 cannot hold {shares})")
        # The planted faults, against the same limits.
        rounded = [w.to(torch.bfloat16).float() for w in want_grads]
        faults[f"{tag}: gradients rounded to bf16"] = max(
            max(ratio(r, w, limits[n])[1] for r, w, n in zip(rounded, want_grads,
                                                             ("dq", "dk", "dv"))),
            2.0 * (min(bf16_share(r) for r in rounded) <= 0.5))
        if not causal:
            masked, _ = fa.flash_block_reference(q, k, v, h, True)
            faults["full: the diagonal still masked"] = ratio(masked, want_out, limits["out"])[1]
            if tc % 64:
                tail = _block_forward_unmasked_tail(q, k, v, h)
                faults["full: keys past tc unmasked"] = ratio(tail, want_out, limits["out"])[1]
        given[causal] = (want_out, lse_g)
        del out, lse, grads, want_grads, limits
    for fname, r in faults.items():
        log(f"block {name}: planted fault '{fname}': {r:.3f} of the limit")
        check(r > 1.0, f"block {name}: the limit misses '{fname}'")
    torch.cuda.empty_cache()

    times = {}
    for causal in (False, True):
        tag = "causal" if causal else "full"
        o_g, l_g = given[causal]
        times[f"{tag}_fwd"] = graph_ms(lambda: fa.flash_block_forward(q, k, v, h, causal), iters)
        times[f"{tag}_bwd"] = graph_ms(
            lambda: fa.flash_block_backward(q, k, v, o_g, l_g, do, h, causal), iters)
        if device != "cpu":
            f32 = torch.float32
            _, delta = fa._dq_kernel(q, k, v, o_g, l_g, do, h, causal, f32)
            times[f"{tag}_dq"] = graph_ms(
                lambda: fa._dq_kernel(q, k, v, o_g, l_g, do, h, causal, f32), iters)
            times[f"{tag}_dkv"] = graph_ms(
                lambda: fa._dkv_kernel(q, k, v, l_g, delta, do, h, causal, f32), iters)
            times[f"{tag}_dq_bound"] = dq_bound(b, tc, h, d, dtype, causal, "float32")[0]
            log(f"block {name} {tag} bwd: dq kernel {times[f'{tag}_dq']:.6f} ms (bound "
                f"{times[f'{tag}_dq_bound']:.6f} ms), dk/dv kernel {times[f'{tag}_dkv']:.6f} ms")
            del delta
        times[f"{tag}_plain_fwd"] = graph_ms(
            lambda: fa.flash_block_reference(q, k, v, h, causal), iters)
        times[f"{tag}_plain_bwd"] = graph_ms(
            lambda: fa.flash_block_backward_reference(q, k, v, o_g, l_g, do, h, causal), iters)
        # Yardstick only, never called by the port: SDPA on the same inputs.
        q4, k4, v4 = (x.view(b, tc, h, d).transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        do4 = do.view(b, tc, h, d).transpose(1, 2)
        times[f"{tag}_library_fwd"] = graph_ms(
            lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal), iters)
        side = _capture_stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
        torch.cuda.current_stream().wait_stream(side)
        times[f"{tag}_library_bwd"] = graph_ms(
            lambda: torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True), iters)
        bounds = block_bounds(b, tc, h, d, dtype, causal)
        for kind in ("fwd", "bwd"):
            times[f"{tag}_{kind}_bound"], times[f"{tag}_{kind}_bound_by"], _ = bounds[kind]
            log(f"block {name} {tag} {kind}: kernel_ms {times[f'{tag}_{kind}']:.6f} plain_ms "
                f"{times[f'{tag}_plain_{kind}']:.6f} library_ms "
                f"{times[f'{tag}_library_{kind}']:.6f} bound_ms {bounds[kind][0]:.6f} "
                f"({bounds[kind][1]}, {bounds[kind][2]} B)")
        del o4, q4, k4, v4
    torch.cuda.empty_cache()
    return dict(case=name, b=b, tc=tc, h=h, d=d, dtype=dtype, errors=errs,
                fault_over_limit=faults,
                fwd_max_abs_err=max(v[0] for k_, v in errs.items()
                                    if k_.endswith(("out", "lse"))),
                bwd_max_abs_err=max(v[0] for k_, v in errs.items()
                                    if k_.endswith(("dq", "dk", "dv"))),
                **times)


# ---------------------------------------------------------------------------
# phase 16: the zigzag ring on one card
# ---------------------------------------------------------------------------

def ring_on_one_card(ring, b, t, h, d, dtype, seed, reps: int = 3, device: str = "cuda"):
    """The zigzag ring's per-rank schedules over ``ring`` virtual ranks of
    one card (the in-process transport) at (B, T, H, D): forward and the
    gradients against the same schedules on the block kernels' plain
    versions and against the single-card flash kernels on the whole
    sequence; block launches per call; ring ms beside flash ms (fwd + bwd,
    mean of ``reps``; one card emulating the ranks, not a multi-card
    time)."""
    import torch

    from dtc_tpu_torch.ops import flash_attention as fa
    from dtc_tpu_torch.ops import ring_attention as ra
    from dtc_tpu_torch.parity import attention_tolerance, grad_tolerance

    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(b, t, h, d, device=dev, generator=g).to(dt) for _ in range(4))
    vring = ra.InProcessRing(ring)

    def run(fn):
        xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out = fn(*xs)
        grads = torch.autograd.grad(out, xs, do)
        return out.detach(), grads

    zero_flash_counts()                                    # the path starts here
    got = run(lambda *xs: ra.ring_causal_attention(*xs, vring))
    launches = (fa.block_fwd_launches, fa.block_bwd_launches)  # ...and ends here
    check_flash_routes(f"ring {ring} {dtype}", dtype)
    want_calls = ring * (2 * ring + 1)
    check(launches == (want_calls, want_calls * fa.BWD_KERNELS),
          f"ring {ring} {dtype}: block launches {launches} for one call over {ring} ranks "
          f"(want {2 * ring + 1} forward and {2 * ring + 1} backward calls a rank)")
    real = fa.flash_block_forward, fa.flash_block_backward
    fa.flash_block_forward = lambda *a: fa.flash_block_reference(*a)
    fa.flash_block_backward = lambda *a: fa.flash_block_backward_reference(*a)
    try:
        plain = run(lambda *xs: ra.ring_causal_attention(*xs, vring))
    finally:
        fa.flash_block_forward, fa.flash_block_backward = real
    flash = run(fa.flash_causal_attention)
    torch.cuda.synchronize()
    hd = h * d
    pk = lambda x: x.reshape(b, t, hd)
    res = dict(ring=ring, b=b, t=t, h=h, d=d, dtype=dtype, block_fwd_launches=launches[0],
               block_bwd_launches=launches[1])
    for ref_name, ref in (("plain", plain), ("flash", flash)):
        pairs = [("out", got[0], ref[0], attention_tolerance(pk(ref[0]), h))]
        pairs += [(n, gg, w, grad_tolerance(pk(w), h))
                  for n, gg, w in zip(("dq", "dk", "dv"), got[1], ref[1])]
        for n, a, w, lim in pairs:
            diff = (pk(a).float() - pk(w).float()).abs()
            r = (diff / lim.to(dev)).max().item()
            res[f"{ref_name}_{n}"] = (diff.max().item(), r)
            log(f"ring {ring} {dtype} vs {ref_name}: {n} max_abs_err {diff.max().item():.3e}, "
                f"{r:.3f} of its limit")
            check(r <= 1.0, f"ring {ring} {dtype}: {n} against {ref_name} over its limit")
    del plain, flash
    torch.cuda.empty_cache()

    def timed(fn):
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            run(fn)
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / reps

    run(lambda *xs: ra.ring_causal_attention(*xs, vring))   # warm
    res["ring_ms"] = timed(lambda *xs: ra.ring_causal_attention(*xs, vring))
    res["flash_ms"] = timed(fa.flash_causal_attention)
    log(f"ring {ring} {dtype} (B {b}, T {t}, {h} heads of {d}): block launches {launches} "
        f"(= {ring} ranks x {2 * ring + 1} calls); forward + backward {res['ring_ms']:.3f} ms "
        f"over {ring} virtual ranks on one card (not a multi-card time) against the "
        f"single-card flash kernels' {res['flash_ms']:.3f} ms")
    torch.cuda.empty_cache()
    return res


def ring_training_step(ring: int, seed: int, device: str = "cuda", t: int = 8192):
    """One training step of the long-context flagship at T ``t``, B 2
    (float32 compute, ``remat: none``, dropout 0) with ``attention: ring``
    over ``ring`` virtual ranks of one card, against the same step with
    the flash kernels from the same weights and batch: the losses within
    1e-4 (phase 8's limit for two attention paths) and the block launches
    of 12 layers."""
    import dataclasses

    import torch

    from dtc_tpu_torch.config.loader import load_config
    from dtc_tpu_torch.data.prefetch import split_to_device
    from dtc_tpu_torch.data.synthetic import synthetic_batch_iterator
    from dtc_tpu_torch.models.gpt import GPT
    from dtc_tpu_torch.ops import flash_attention as fa
    from dtc_tpu_torch.ops import ring_attention as ra
    from dtc_tpu_torch.train.optimizer import create_optimizer
    from dtc_tpu_torch.train.train_step import train_step

    tcfg, mcfg, ocfg = load_config(ROOT / "configs" / "train_config_longctx.yaml",
                                   ROOT / "configs" / "model_config_longctx.yaml")
    mcfg = dataclasses.replace(mcfg, max_seq_len=t, remat="none", dropout=0.0,
                               compute_dtype="float32")
    dev = torch.device(device)
    x, y = split_to_device(next(synthetic_batch_iterator(2, t + 1, mcfg.vocab_size,
                                                         seed=seed)), dev)
    out, routes = {}, {}
    for impl in ("ring", "flash"):
        model = GPT(dataclasses.replace(mcfg, attention=impl), device=dev, seed=seed)
        opt = create_optimizer(model.parameters(), ocfg, total_steps=1)
        zero_flash_counts()                                    # the path starts here
        with ra.use_ring(ra.InProcessRing(ring)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(train_step(model, opt, x, y, None))
            step_s = time.perf_counter() - t0
        out[impl] = (loss, (fa.block_fwd_launches, fa.block_bwd_launches), step_s)  # ...end
        routes[impl] = check_flash_routes(f"ring training ({impl})", mcfg.compute_dtype)
        del model, opt
        torch.cuda.empty_cache()
    calls = mcfg.n_layers * ring * (2 * ring + 1)
    check(out["ring"][1] == (calls, calls * fa.BWD_KERNELS) and out["flash"][1] == (0, 0),
          f"ring training: block launches {out['ring'][1]} (want {calls} forward calls of "
          f"{mcfg.n_layers} layers x {ring} ranks x {2 * ring + 1})")
    gap = abs(out["ring"][0] - out["flash"][0])
    log(f"ring training (T {t}, B 2, {mcfg.n_layers} layers, ring {ring} on one card): loss "
        f"{out['ring'][0]:.6f} vs flash {out['flash'][0]:.6f} (gap {gap:.3e}, limit 1e-4); "
        f"block launches {out['ring'][1]}; step {out['ring'][2] * 1e3:.1f} ms (flash "
        f"{out['flash'][2] * 1e3:.1f} ms; first step of each, one card)")
    check(gap <= 1e-4, f"ring training loss {out['ring'][0]} vs flash {out['flash'][0]}")
    return dict(ring=ring, loss_ring=out["ring"][0], loss_flash=out["flash"][0], gap=gap,
                flash_routes=routes["ring"],
                block_launches=out["ring"][1], step_ms_ring=out["ring"][2] * 1e3,
                step_ms_flash=out["flash"][2] * 1e3)


# ---------------------------------------------------------------------------
# phase 17: the trainer over NCCL at world size 1
# ---------------------------------------------------------------------------

def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def train_nccl_world1(steps: int, out_dir: str, device: str | None = None):
    """``torchrun --nproc_per_node 1 -m dtc_tpu_torch.main
    --train_config_path configs/train_config_dp.yaml --dataset synthetic
    --no-obs --steps STEPS --output_dir OUT_DIR``, the rendezvous in this
    process (torchrun's environment set here), then the same command
    without it: the losses equal bit for bit. Returns (losses over NCCL,
    single-process losses, the backend, gradient averages, flash launches
    of the NCCL run, log.csv rows)."""
    import os
    import shutil

    import torch.distributed as dist

    from dtc_tpu_torch import main as cli
    from dtc_tpu_torch.ops import flash_attention as fa
    from dtc_tpu_torch.train import train_step as ts_mod
    from dtc_tpu_torch.utils import dist as dist_utils

    argv = ["--train_config_path", str(ROOT / "configs" / "train_config_dp.yaml"),
            "--dataset", "synthetic", "--no-obs", "--steps", str(steps)]
    if device:
        argv += ["--device", device]
    env = dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()))
    seen = {"backend": None, "averages": 0}
    real_init, real_avg = dist_utils.initialize, ts_mod.average_over_ranks

    def init(*a, **k):
        dev = real_init(*a, **k)
        seen["backend"] = dist.get_backend()
        return dev

    def avg(*a, **k):
        seen["averages"] += 1
        return real_avg(*a, **k)

    for d in (out_dir, out_dir + "_alone"):  # an earlier run's log.csv is refused
        shutil.rmtree(d, ignore_errors=True)
    os.environ.update(env)
    dist_utils.initialize, ts_mod.average_over_ranks = init, avg
    try:
        fa.fwd_launches = fa.bwd_launches = 0        # the main path starts here
        res = cli.main(argv + ["--output_dir", out_dir])
        launches = (fa.fwd_launches, fa.bwd_launches)  # ...and ends here
    finally:
        dist_utils.initialize, ts_mod.average_over_ranks = real_init, real_avg
        for key in env:
            del os.environ[key]
    check(not dist.is_initialized(), "phase 17: the trainer left its process group open")
    rows = (Path(out_dir) / "log.csv").read_text().splitlines()
    alone = cli.main(argv + ["--output_dir", out_dir + "_alone"])
    return res, alone, seen, launches, rows


def _sass(lib_path) -> str:
    from dtc_tpu_torch.ops import _build

    tool = Path(_build.nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                         timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-2000:]}")
    return out.stdout


def sass_counts(lib_path, opcodes=("HGMMA", "UTMALDG")) -> dict:
    """How many of each SASS opcode the built library holds (``cuobjdump
    -sass``, from the toolkit beside ``nvcc``): HGMMA is a wgmma on the
    tensor cores, UTMALDG a TMA tensor load."""
    text = _sass(lib_path)
    return {op: len(re.findall(rf"\b{op}\b", text)) for op in opcodes}


def sass_counts_by_function(lib_path, opcodes=("HGMMA", "UTMALDG")) -> dict:
    """:func:`sass_counts` for each kernel of the library, by
    :func:`instance_name`."""
    out = {}
    for part in _sass(lib_path).split("Function : ")[1:]:
        name = instance_name(part.split(None, 1)[0])
        out[name] = {op: len(re.findall(rf"\b{op}\b", part)) for op in opcodes}
    return out


# ---------------------------------------------------------------------------
# phase 18: the FSDP ring's kernels against their plain versions
# ---------------------------------------------------------------------------

def overlap_bounds(rows, k, n, dtype):
    """Least time of the ring's forward pass (row 17: ``x (rows, k) @ w (k,
    n)``, float32 out) and of its dw pass (row 18: ``xᵀ @ dy``, dy (rows,
    n), float32 (k, n) out) over all the ring's ranks: each input read
    once and the float32 output written once over HBM bandwidth, against
    2·rows·k·n operations over the dtype's peak. Returns {"ag"|"rs": (ms,
    bound_by)}."""
    el = {"float32": 4, "bfloat16": 2}[dtype]
    t_ops = 2 * rows * k * n / PEAK_OPS[dtype] * 1e3
    out = {}
    for kind, nbytes in (("ag", (rows * k + k * n) * el + rows * n * 4),
                         ("rs", (rows * k + rows * n) * el + k * n * 4)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        out[kind] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    return out


def overlap_faults(ring: int):
    """Planted faults in the plain step versions, each breaking the ring
    one way: ``{name: (kind, step)}``, ``kind`` "ag" or "rs"."""
    import torch

    from dtc_tpu_torch.ops import overlap_collectives as oc

    def chunk_off(x, w, out, *, src, **kw):          # chunk order one ring step off
        oc.ag_step_reference(x, w, out, src=(src + 1) % ring, **kw)

    def w_t_ignored(x, w, out, *, w_t, **kw):        # the chunk's bytes read untransposed
        if w_t:
            w = w.contiguous().reshape(w.shape[1], w.shape[0])
        oc.ag_step_reference(x, w, out, w_t=False, **kw)

    def acc_dropped(a, b, acc, **kw):                # the arriving accumulator not added
        return oc.rs_step_reference(a, b, None, **kw)

    def ag_rounded(x, w, out, *, src, slice_x, slice_out, w_t, accumulate):
        xs, ws = oc._ag_operands(x, w, src, slice_x, w_t)  # partials rounded to bf16 first
        part = (xs.float() @ ws.float()).to(torch.bfloat16).float()
        n = ws.shape[1]
        dest = out[:, src * n:(src + 1) * n] if slice_out else out
        dest.copy_(dest + part if accumulate else part)

    def rs_rounded(a, b, acc, **kw):
        part = oc.rs_step_reference(a, b, None, **kw).to(torch.bfloat16).float()
        return part if acc is None else acc + part

    return {"chunk order one ring step off": ("ag", chunk_off),
            "w_t ignored": ("ag", w_t_ignored),
            "arriving accumulator not added": ("rs", acc_dropped),
            "partials rounded to bf16 (all-gather-matmul)": ("ag", ag_rounded),
            "partials rounded to bf16 (reduce-scatter)": ("rs", rs_rounded)}


def overlap_plans(x, w, dy, vring, shard_axis, sms: int):
    """The plans of every step of the forward, dx and dw rings (the real
    schedules, with steps that only plan): ``[{ring, m, n, k, plan...,
    steps}]``, one entry per distinct (ring, shape, plan)."""
    import dataclasses

    import torch

    from dtc_tpu_torch.ops import overlap_collectives as oc

    seen: dict = {}

    def note(tag, m, n, k, plan):
        key = (tag, m, n, k, plan)
        seen[key] = seen.get(key, 0) + 1

    def ag(tag):
        def step(x, w, out, *, src, slice_x, slice_out, w_t, accumulate):
            xs, ws = oc._ag_operands(x, w, src, slice_x, w_t)
            note(tag, xs.shape[0], ws.shape[1], xs.shape[1],
                 oc.ag_plan(x, w, src=src, slice_x=slice_x, w_t=w_t, sms=sms))
        return step

    def rs(a, b, acc, *, j, blk, slice_a):
        a_j, b_j = oc._rs_operands(a, b, j, blk, slice_a)
        note("dw", a_j.shape[1], b_j.shape[1], a_j.shape[0],
             oc.rs_plan(a, b, j=j, blk=blk, slice_a=slice_a, sms=sms))
        return torch.zeros(a_j.shape[1], b_j.shape[1], device=a.device)

    oc.ring_ag_matmul(x, w, vring, shard_axis=shard_axis, step=ag("forward"))
    oc.ring_backward(x, w, dy, vring, shard_axis=shard_axis, ag=ag("dx"), rs=rs)
    return [dict(ring=tag, m=m, n=n, k=k, **dataclasses.asdict(plan), steps=c)
            for (tag, m, n, k, plan), c in seen.items()]


def overlap_case(name, b, t, k, n, shard_axis, dtype, seed, ring: int = 4, iters: int = 0,
                 device: str = "cuda", route: str | None = None):
    """The FSDP ring's kernels against their plain versions over ``ring``
    virtual ranks of one card, at x (b, t, k), w (k, n) sharded along
    ``shard_axis``: the forward ring (row 17) and the backward rings (row 17
    for dx with ``w_t``, row 18 for dw), float32 ring outputs within
    ``row_tolerance(float32)`` (bf16 products are exact in float32: the sums'
    order is the only difference), the op's outputs rounded to ``dtype``
    within ``row_tolerance(dtype)``; launch counts; the planted faults over
    the float32 limit. ``route``: the route every launch must take ("tma",
    "cuda_cores"), or "threads" for a ragged case, where the per-thread
    loader must take some; the launches by route and, for bfloat16, every
    step's plan go in the record. With ``iters``: device times of the
    forward ring and the dw ring (kernels, plain versions, one
    ``torch.matmul``) beside the bounds."""
    import torch

    from dtc_tpu_torch.ops import overlap_collectives as oc
    from dtc_tpu_torch.ops.ring_attention import InProcessRing
    from dtc_tpu_torch.parity import row_tolerance

    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    x, dy = (torch.randn(b * t, c, device=dev, generator=g).to(dt) for c in (k, n))
    w = (torch.randn(k, n, device=dev, generator=g) * k ** -0.5).to(dt)
    vring = InProcessRing(ring)
    f32 = torch.float32

    def rings(ag=None, rs=None):
        y = oc.ring_ag_matmul(x, w, vring, shard_axis=shard_axis, step=ag)
        return (y, *oc.ring_backward(x, w, dy, vring, shard_axis=shard_axis, ag=ag, rs=rs))

    oc.ag_launches = oc.rs_launches = 0
    oc.route_launches.update(dict.fromkeys(oc.route_launches, 0))
    got = rings()
    launches = (oc.ag_launches, oc.rs_launches)
    routes = dict(oc.route_launches)
    check(launches == (2 * ring * ring, ring * ring),
          f"overlap {name}: launches {launches} (want {2 * ring * ring} all-gather-matmul "
          f"and {ring * ring} reduce-scatter steps over {ring} ranks)")
    if route == "threads":
        check(routes["threads"] > 0 and routes["cuda_cores"] == 0,
              f"overlap {name}: routes {routes}, want the per-thread loader among them")
    elif route is not None:
        check(routes[route] == sum(launches), f"overlap {name}: routes {routes}, want {route}")
    want = rings(oc.ag_step_reference, oc.rs_step_reference)
    xt, wt = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    y_op = oc.overlap_dense_matmul(xt, wt, shard_axis=shard_axis, ring=vring)
    op = (y_op.detach(), *torch.autograd.grad(y_op, (xt, wt), dy))
    torch.cuda.synchronize()
    res = dict(case=name, b=b, t=t, k=k, n=n, shard_axis=shard_axis, dtype=dtype, ring=ring,
               launches=launches, routes=routes, errors={}, fault_over_limit={})
    if dt == torch.bfloat16:
        sms = (torch.cuda.get_device_properties(dev).multi_processor_count
               if dev.type == "cuda" else 132)  # 132: an H100's, for a CPU rehearsal
        res["plans"] = overlap_plans(x, w, dy, vring, shard_axis, sms)
        log(f"overlap {name}: launches by route {routes}; plans (ring, m x n, k: route, tile, "
            f"split, A/B MN-major, blocks; steps) " + "; ".join(
                f"{p['ring']} {p['m']}x{p['n']} k {p['k']}: {p['route']} {p['tile_m']}x"
                f"{p['tile_n']} split {p['split']} {int(p['a_mn'])}/{int(p['b_mn'])} "
                f"{p['blocks']}; {p['steps']}" for p in res["plans"]))
    names = ("y", "dx", "dw")
    for nm, a, ref in zip(names, got, want):
        check(a.dtype == f32 and bool(torch.isfinite(a).all()), f"overlap {name}: {nm} not finite")
        diff = (a - ref).abs()
        r = (diff / row_tolerance(ref, f32).to(dev)).max().item()
        res["errors"][f"{nm}_f32"] = (diff.max().item(), r)
        check(r <= 1.0, f"overlap {name}: float32 {nm} {r:.3f} of its limit")
    for nm, a, ref in zip(names, op, want):
        ref = ref.to(dt)
        check(a.dtype == dt, f"overlap {name}: the op's {nm} is {a.dtype}")
        diff = (a.float() - ref.float()).abs()
        r = (diff / row_tolerance(ref, dt).to(dev)).max().item()
        res["errors"][nm] = (diff.max().item(), r)
        check(r <= 1.0, f"overlap {name}: {nm} {r:.3f} of its {dtype} limit")
    for fname, (kind, fault) in overlap_faults(ring).items():
        bad = rings(ag=fault) if kind == "ag" else rings(rs=fault)
        r = max(((a - ref).abs() / row_tolerance(ref, f32).to(dev)).max().item()
                for a, ref in zip(bad, want))
        res["fault_over_limit"][fname] = r
    log(f"overlap {name} ({dtype}, x ({b * t}, {k}) @ w ({k}, {n}), shard axis {shard_axis}, "
        f"ring {ring}): launches {launches}; " + ", ".join(
            f"{kk} {v[0]:.3e} ({v[1]:.3f} of the limit)" for kk, v in res["errors"].items()))
    for fname, r in res["fault_over_limit"].items():
        log(f"overlap {name}: planted fault '{fname}': {r:.3f} of the float32 limit")
        check(r > 1.0, f"overlap {name}: the limit misses '{fname}'")
    res["max_abs_err_ag"] = max(res["errors"][kk][0] for kk in ("y", "dx", "y_f32", "dx_f32"))
    res["max_abs_err_rs"] = max(res["errors"][kk][0] for kk in ("dw", "dw_f32"))
    del got, want, op
    if iters:
        fwd = lambda step=None: oc.ring_ag_matmul(x, w, vring, shard_axis=shard_axis, step=step)
        dw = lambda step=None: oc.reduce_scatter_matmul(x, dy, shard_axis=shard_axis,
                                                        ring=vring, step=step)
        bounds = overlap_bounds(b * t, k, n, dtype)
        res.update(
            ag_ms=graph_ms(fwd, iters), ag_plain_ms=graph_ms(
                lambda: fwd(oc.ag_step_reference), iters),
            ag_library_ms=graph_ms(lambda: torch.matmul(x, w), iters),
            rs_ms=graph_ms(dw, iters), rs_plain_ms=graph_ms(
                lambda: dw(oc.rs_step_reference), iters),
            rs_library_ms=graph_ms(lambda: torch.matmul(x.t(), dy), iters),
            ag_bound_ms=bounds["ag"][0], ag_bound_by=bounds["ag"][1],
            rs_bound_ms=bounds["rs"][0], rs_bound_by=bounds["rs"][1])
        for kind in ("ag", "rs"):
            log(f"overlap {name} {kind} ring ({ring} virtual ranks, {ring * ring} launches): "
                f"kernel_ms {res[f'{kind}_ms']:.6f} plain_ms {res[f'{kind}_plain_ms']:.6f} "
                f"library_ms {res[f'{kind}_library_ms']:.6f} bound_ms "
                f"{res[f'{kind}_bound_ms']:.6f} ({res[f'{kind}_bound_by']})")
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 19: FSDP over virtual ranks on one card
# ---------------------------------------------------------------------------

def fsdp_virtual(seed: int, ring: int = 4, steps32: int = 4, steps: int = 35,
                 device: str = "cuda", profile: bool = False):
    """The flagship (``train_config_fsdp.yaml`` + ``model_config.yaml``, B 8,
    T 512, dropout 0) under ``collectives: overlapped`` with an FSDP ring of
    ``ring`` virtual ranks on one card, so every dense site runs the ring's
    kernels: float32 losses within 1e-4 of the unsharded run over
    ``steps32`` steps; bf16 ``steps`` steps with finite losses whose last-5
    mean is below the first, the kernels' launches (counted on this run:
    the main path's), the step ms beside the unsharded bf16 step (one card
    emulating the ranks, not a multi-card time) and the peak memory beside
    ``train_memory_bytes(parallel="fsdp")``. ``profile``: also the device
    time by kernel of 3 steady bf16 steps on the ring (torch.profiler)."""
    import dataclasses

    import torch

    from dtc_tpu_torch.config.loader import load_config
    from dtc_tpu_torch.data.prefetch import split_to_device
    from dtc_tpu_torch.data.synthetic import synthetic_batch_iterator
    from dtc_tpu_torch.models.gpt import GPT
    from dtc_tpu_torch.ops import overlap_collectives as oc
    from dtc_tpu_torch.ops.ring_attention import InProcessRing
    from dtc_tpu_torch.parallel.fsdp import FSDP
    from dtc_tpu_torch.train.optimizer import create_optimizer
    from dtc_tpu_torch.train.train_step import train_step
    from dtc_tpu_torch.utils.metrics import train_memory_bytes

    tcfg, mcfg, ocfg = load_config(ROOT / "configs" / "train_config_fsdp.yaml",
                                   ROOT / "configs" / "model_config.yaml",
                                   ROOT / "configs" / "optim_config.yaml")
    mcfg = dataclasses.replace(mcfg, dropout=0.0, collectives="overlapped")
    dev = torch.device(device)
    it = synthetic_batch_iterator(tcfg.batch, mcfg.max_seq_len + 1, mcfg.vocab_size, seed=seed)
    batches = [split_to_device(next(it), dev) for _ in range(steps)]

    def run(cfg, n, state):
        model = GPT(cfg, device=dev, seed=seed)
        opt = create_optimizer(model.parameters(), ocfg, total_steps=steps)
        losses, times = [], []
        for x, y in batches[:n]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(train_step(model, opt, x, y, None, state)))  # syncs
            times.append(time.perf_counter() - t0)
        return losses, sorted(times)[len(times) // 2] * 1e3

    rec = dict(ring=ring, batch=tcfg.batch, t=mcfg.max_seq_len)
    m32 = dataclasses.replace(mcfg, compute_dtype="float32")
    plain32, _ = run(m32, steps32, None)
    ring32, _ = run(m32, steps32, FSDP(InProcessRing(ring)))
    gap = max(abs(a - b_) for a, b_ in zip(plain32, ring32))
    rec.update(float32_losses=ring32, float32_losses_unsharded=plain32, float32_gap=gap)
    log(f"fsdp float32 ({ring} virtual ranks, overlapped): losses {ring32} vs unsharded "
        f"{plain32} (gap {gap:.3e}, limit 1e-4)")
    check(gap <= 1e-4, f"fsdp float32: ring losses {ring32} vs unsharded {plain32}")

    torch.cuda.empty_cache()
    plain, plain_ms = run(mcfg, 10, None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    oc.ag_launches = oc.rs_launches = 0                     # the main path starts here
    oc.route_launches.update(dict.fromkeys(oc.route_launches, 0))
    losses, step_ms = run(mcfg, steps, FSDP(InProcessRing(ring)))
    launches = (oc.ag_launches, oc.rs_launches)             # ...and ends here
    routes = dict(oc.route_launches)
    peak = torch.cuda.max_memory_allocated() - base
    sites = mcfg.n_layers * 6
    want = (steps * ring * sites * 2 * ring, steps * ring * sites * ring)
    budget = train_memory_bytes(mcfg, tcfg.batch, mcfg.max_seq_len, {"data": ring}, "fsdp")
    rec.update(losses=losses, launches=launches, routes=routes, launches_per_rank_step=(
        launches[0] // (steps * ring), launches[1] // (steps * ring)), step_ms=step_ms,
        step_ms_unsharded=plain_ms, peak_allocated=peak,
        train_memory_bytes_fsdp=budget["total"])
    log(f"fsdp bf16 ({ring} virtual ranks, overlapped, {steps} steps): losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; launches {launches} (= {steps} steps x {ring} "
        f"ranks x ({2 * ring * sites}, {ring * sites}) a rank); step_ms median {step_ms:.3f} on "
        f"one card emulating {ring} ranks, not a multi-card time (unsharded {plain_ms:.3f}); "
        f"peak allocated {peak} B for all {ring} virtual ranks, train_memory_bytes(fsdp, data "
        f"{ring}) {budget['total']:.0f} B a rank")
    check(all(math.isfinite(v) for v in losses), f"fsdp bf16: non-finite losses {losses}")
    check(sum(losses[-5:]) / 5 < losses[0], f"fsdp bf16: losses do not fall {losses}")
    check(launches == want, f"fsdp bf16: launches {launches}, want {want}")
    log(f"fsdp bf16: launches by route {routes}")
    check(routes["tma"] == sum(launches), f"fsdp bf16: routes {routes}: every step must take "
          f"TMA and the tensor cores")
    torch.cuda.empty_cache()
    if profile:
        pr = profile_train(mcfg, tcfg, ocfg, steps=3, device=device,
                           fsdp=FSDP(InProcessRing(ring)))
        rec["profile"] = pr
        log(f"profile fsdp bf16 ({ring} virtual ranks): {pr['wall_s'] / 3 * 1e3:.3f} ms a step "
            f"wall, device busy {pr['device_busy_s'] / 3 * 1e3:.3f} ms a step (share "
            f"{pr['busy_share']:.4f}), {pr['kernel_launches']} kernels; the ring's step "
            f"kernels {pr['overlap_device_s'] / 3 * 1e3:.3f} ms a step")
        for row in pr["top"][:8]:
            log(f"  {row['device_ms']:.4f} ms x{row['count']} {row['name']}")
        torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 20: the FSDP trainer over NCCL at world size 1
# ---------------------------------------------------------------------------

def fsdp_nccl_world1(steps: int, out_dir: str, device: str | None = None):
    """``torchrun --nproc_per_node 1 -m dtc_tpu_torch.main
    --train_config_path configs/train_config_fsdp.yaml --dataset synthetic
    --no-obs --steps STEPS --output_dir OUT_DIR`` (torchrun's environment set
    in this process) under ``collectives: xla`` and, from a copy of the
    config that adds ``collectives: overlapped``, under ``overlapped``; then
    the xla command in one process. Returns {mode: (result, stdout, ring
    launches, log.csv rows)}, the backend, and the single-process result."""
    import contextlib
    import io
    import os
    import shutil

    import torch.distributed as dist

    from dtc_tpu_torch import main as cli
    from dtc_tpu_torch.ops import overlap_collectives as oc
    from dtc_tpu_torch.utils import dist as dist_utils

    base = Path(out_dir)
    shutil.rmtree(base, ignore_errors=True)  # an earlier run's log.csv is refused
    base.mkdir(parents=True)
    ovl = base / "train_config_fsdp_overlapped.yaml"
    ovl.write_text((ROOT / "configs" / "train_config_fsdp.yaml").read_text()
                   + "\ncollectives: overlapped\n")
    argv = ["--model_config_path", str(ROOT / "configs" / "model_config.yaml"),
            "--optim_config_path", str(ROOT / "configs" / "optim_config.yaml"),
            "--dataset", "synthetic", "--no-obs", "--steps", str(steps)]
    if device:
        argv += ["--device", device]
    configs = {"xla": ROOT / "configs" / "train_config_fsdp.yaml", "overlapped": ovl}
    env = dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()))
    seen = {"backend": None}
    real_init = dist_utils.initialize

    def init(*a, **k):
        dev = real_init(*a, **k)
        seen["backend"] = dist.get_backend()
        return dev

    runs = {}
    os.environ.update(env)
    dist_utils.initialize = init
    try:
        for mode, cfg in configs.items():
            buf = io.StringIO()
            oc.ag_launches = oc.rs_launches = 0
            with contextlib.redirect_stdout(buf):
                res = cli.main(["--train_config_path", str(cfg), *argv,
                                "--output_dir", str(base / mode)])
            rows = (base / mode / "log.csv").read_text().splitlines()
            runs[mode] = (res, buf.getvalue(), (oc.ag_launches, oc.rs_launches), rows)
            check(not dist.is_initialized(), "phase 20: the trainer left its process group open")
    finally:
        dist_utils.initialize = real_init
        for key in env:
            del os.environ[key]
    alone = cli.main(["--train_config_path", str(configs["xla"]), *argv,
                      "--output_dir", str(base / "alone")])
    return runs, seen["backend"], alone


# ---------------------------------------------------------------------------
# phases 21-22: tensor and pipeline parallelism, ranks sharing one card
# ---------------------------------------------------------------------------

SHARED_CARD = "ranks sharing one card, not a multi-card time"


def rank_worker(run_dir: str) -> int:
    """One rank of phases 21-23 (``chip_smoke.py --rank-worker DIR``, run
    by :func:`spawn_ranks` with torchrun's environment): joins the gloo
    process group on the device ``DIR/spec.json`` names and runs its runs
    in order, each either through ``python -m dtc_tpu_torch.main``'s
    ``main(argv)`` (``argv``) or through ``train()`` on the named train
    config and its siblings with fields replaced (``train_over``,
    ``model_over``; synthetic data, no telemetry). The flash and FSDP ring
    launch counters are set to 0 just before each run and read just after.
    Writes ``DIR/rank<RANK>.json``: per run the losses, elapsed times,
    flash launches by kind and route, the ring blocks' launches, the FSDP
    ring's launches and their routes, peak memory and whether the
    replicated parameters are bit-equal across the model group; with
    ``allreduce_probe`` (a
    shape) also the mean ms of one float32 all-reduce of that shape over
    the world, as tensor parallelism's reductions run it. A run named in
    the spec's ``profile`` runs inside a torch.profiler window (CUDA
    activity) on every rank of a card: its record gains the rank's device
    time by kernel over the whole run (:func:`device_time_by_kernel`)."""
    import contextlib
    import dataclasses
    import os

    import torch

    from dtc_tpu_torch import main as cli
    from dtc_tpu_torch.config.loader import load_config
    from dtc_tpu_torch.config.schema import MeshConfig
    from dtc_tpu_torch.ops import flash_attention as fa
    from dtc_tpu_torch.ops import overlap_collectives as oc
    from dtc_tpu_torch.train.train_step import replicas_equal
    from dtc_tpu_torch.train.trainer import train
    from dtc_tpu_torch.utils import dist as dist_utils

    out = Path(run_dir)
    spec = json.loads((out / "spec.json").read_text())
    dev = spec["device"]
    cuda = dev.startswith("cuda")
    dist_utils.initialize(dev, "gloo")
    rank = dist_utils.rank()
    records = []
    for run in spec["runs"]:
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if cuda else 0
        zero_flash_counts()                          # this run's path starts here
        oc.ag_launches = oc.rs_launches = 0
        oc.route_launches.update(dict.fromkeys(oc.route_launches, 0))
        profiled = cuda and run["name"] in spec.get("profile", ())
        window = contextlib.nullcontext()
        if profiled:
            from torch.profiler import ProfilerActivity, profile

            window = profile(activities=[ProfilerActivity.CUDA])
        with window as prof:
            t0 = time.perf_counter()
            if "argv" in run:
                res = cli.main(run["argv"])
            else:
                tcfg, mcfg, ocfg = load_config(ROOT / run["train_config"])
                over = dict(run.get("train_over", {}))
                if "mesh" in over:
                    over["mesh"] = MeshConfig(**over["mesh"])
                tcfg = dataclasses.replace(
                    tcfg, dataset="synthetic", obs=dataclasses.replace(tcfg.obs, enabled=False),
                    **over)
                mcfg = dataclasses.replace(mcfg, **run.get("model_over", {}))
                res = train(tcfg, mcfg, ocfg, device=dev, backend="gloo")
            if cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = (fa.fwd_launches, fa.bwd_launches)  # ...and ends here
        blocks = (fa.block_fwd_launches, fa.block_bwd_launches)
        ring = ((oc.ag_launches, oc.rs_launches), dict(oc.route_launches))
        routes = flash_routes()
        tp = res.model.tp
        records.append(dict(
            name=run["name"], losses=res.losses, elapsed=res.elapsed_times,
            launches=launches, routes=routes, block_launches=blocks, ring_launches=ring[0],
            ring_routes=ring[1],
            peak=(torch.cuda.max_memory_allocated() - base) if cuda else None,
            replicas_equal=None if tp is None else replicas_equal(res.model, tp),
            profile=device_time_by_kernel(prof, wall) if profiled else None))
    probe = None
    if spec.get("allreduce_probe"):
        import torch.distributed as dist

        x = torch.ones(spec["allreduce_probe"], device=dev)
        for i in range(23):                           # 3 untimed, 20 timed
            if i == 3:
                if cuda:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
            dist.all_reduce(x)
        if cuda:
            torch.cuda.synchronize()
        probe = (time.perf_counter() - t0) / 20 * 1e3
    (out / f"rank{rank}.json").write_text(json.dumps(dict(
        rank=rank, pid=os.getpid(), records=records, allreduce_ms=probe)))
    dist_utils.teardown()
    return 0


def spawn_ranks(world: int, run_dir: Path, spec: dict, timeout: float = 900.0) -> list[dict]:
    """Write ``spec`` into ``run_dir`` and run :func:`rank_worker` in
    ``world`` processes (torchrun's environment: a free local port, every
    rank on the spec's device). Every process is stopped before this
    returns; a rank that fails fails the phase with the end of its log.
    Returns each rank's record, in rank order."""
    import os
    import shutil

    shutil.rmtree(run_dir, ignore_errors=True)  # an earlier run's log.csv is refused
    run_dir.mkdir(parents=True)
    (run_dir / "spec.json").write_text(json.dumps(spec))
    port = str(_free_port())
    procs, logs = [], []
    try:
        for rank in range(world):
            logs.append(open(run_dir / f"rank{rank}.log", "w"))
            env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                       LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost", MASTER_PORT=port,
                       OMP_NUM_THREADS="2")
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--rank-worker", str(run_dir)],
                cwd=ROOT, env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for rank, p in enumerate(procs):
        tail = (run_dir / f"rank{rank}.log").read_text()[-4000:]
        check(p.returncode == 0, f"{run_dir.name}: rank {rank} of {world} exited "
              f"{p.returncode}:\n{tail}")
    return [json.loads((run_dir / f"rank{r}.json").read_text()) for r in range(world)]


def one_process_fp32(steps: int, device: str = "cuda",
                     config: str = "configs/train_config_dp.yaml") -> list[float]:
    """The flagship trained in this process on ``config``'s batch and seed
    (``train_config_dp.yaml``'s: B 8, seed 0), float32 at dropout 0,
    ``steps`` steps without warmup: the losses phases 21-23 hold their
    float32 runs to."""
    import dataclasses

    from dtc_tpu_torch.config.loader import load_config
    from dtc_tpu_torch.config.schema import MeshConfig
    from dtc_tpu_torch.train.trainer import train

    tcfg, mcfg, ocfg = load_config(ROOT / config)
    tcfg = dataclasses.replace(tcfg, **FP32_TRAIN, dataset="synthetic", steps=steps,
                               parallel="dp", mesh=MeshConfig(), collectives="xla",
                               obs=dataclasses.replace(tcfg.obs, enabled=False))
    return train(tcfg, dataclasses.replace(mcfg, **FP32_MODEL), ocfg, device=device).losses


#: The float32 comparison runs of phases 21-22: no warmup, a loss a step,
#: no log.csv; float32 compute at dropout 0.
FP32_TRAIN = dict(warmup_steps=0, log_every=1, output_dir="")
FP32_MODEL = dict(dropout=0.0, compute_dtype="float32")


def step_ms(elapsed) -> float:
    """Median of the differences of a run's cumulative elapsed times."""
    steps = sorted(b - a for a, b in zip([0.0] + list(elapsed[:-1]), elapsed))
    return steps[len(steps) // 2] * 1e3


def check_parallel_run(what: str, ranks: list[dict], name: str, want_losses, n_steps: int,
                       fwd_per_step: list[int], dtype: str, rows_dir: Path | None):
    """Phase 21-22's gates on one run of every rank: the same losses on
    every rank; float32 within 1e-4 of ``want_losses``, bf16 finite with
    the last-5 mean below the first-5; each rank's flash launches
    ``fwd_per_step[rank] x n_steps`` forward and twice that backward (dq,
    dk/dv), all on ``dtype``'s route; ``log.csv`` (bf16) from rank 0 with
    one row per timed step; the replicated parameters bit-equal across
    each model group. Returns the launches and routes by rank."""
    from dtc_tpu_torch.ops import flash_attention as fa

    recs = [next(r for r in rank["records"] if r["name"] == name) for rank in ranks]
    losses = recs[0]["losses"]
    check(all(r["losses"] == losses for r in recs), f"{what}: ranks logged different losses "
          f"{[r['losses'] for r in recs]}")
    if want_losses is not None:
        gap = max(abs(a - b) for a, b in zip(losses, want_losses))
        log(f"{what}: float32 losses {losses} vs one process {want_losses} (gap {gap:.3e}, "
            f"limit 1e-4)")
        check(len(losses) == len(want_losses) and gap <= 1e-4,
              f"{what}: losses {losses} vs one process {want_losses}")
    else:
        first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
        check(all(math.isfinite(v) for v in losses) and last < first,
              f"{what}: losses not finite or not falling {losses}")
    route = "tc" if dtype == "bfloat16" else "fma"
    for rank, r in enumerate(recs):
        want = fwd_per_step[rank] * n_steps
        check(tuple(r["launches"]) == (want, want * fa.BWD_KERNELS),
              f"{what}: rank {rank} flash launches {r['launches']}, want "
              f"({want}, {want * fa.BWD_KERNELS})")
        for kind in ("fwd", "dq", "dkv"):
            check(r["routes"][kind].get(route, 0) == want and sum(r["routes"][kind].values())
                  == want, f"{what}: rank {rank} {kind} launches by route {r['routes'][kind]}")
        check(r["replicas_equal"] in (None, True),
              f"{what}: rank {rank}'s replicated parameters differ across its model group")
    if rows_dir is not None:
        rows = (rows_dir / "log.csv").read_text().splitlines()
        check(rows[0] == "step,elapsed_time,loss" and len(rows) == len(losses) + 1,
              f"{what}: log.csv {rows[:3]}... ({len(rows)} lines)")
    return dict(losses=losses, launches=[r["launches"] for r in recs],
                routes=[r["routes"] for r in recs], peak=[r["peak"] for r in recs],
                step_ms=[step_ms(r["elapsed"]) for r in recs],
                replicas_equal=[r["replicas_equal"] for r in recs])


def tensor_parallel_phase(ref32, smi: str, device: str = "cuda", bf16_steps: int = 30):
    """Phase 21: ``python -m dtc_tpu_torch.main --train_config_path
    configs/train_config_tp.yaml --dataset synthetic --no-obs --backend
    gloo --device cuda:0`` over 2 ranks on one card (TP 2: 8 heads of 32 a
    rank at B 8), after a float32 dropout-0 run of 4 steps held to one
    process. Returns the phase's record."""
    from dtc_tpu_torch.config.loader import load_config
    from dtc_tpu_torch.utils.metrics import train_memory_bytes

    run_dir = ROOT / "build" / "chip_smoke_tp"
    dev = "cuda:0" if device == "cuda" else device
    tcfg, mcfg, _ = load_config(ROOT / "configs" / "train_config_tp.yaml")
    runs = [
        dict(name="fp32", train_config="configs/train_config_tp.yaml",
             train_over=dict(FP32_TRAIN, steps=len(ref32)), model_over=FP32_MODEL),
        dict(name="bf16", argv=[
            "--train_config_path", str(ROOT / "configs" / "train_config_tp.yaml"),
            "--dataset", "synthetic", "--no-obs", "--steps", str(bf16_steps),
            "--output_dir", str(run_dir / "bf16"), "--backend", "gloo", "--device", dev]),
    ]
    ranks = spawn_ranks(2, run_dir, {"device": dev, "runs": runs, "allreduce_probe": [
        tcfg.batch, mcfg.max_seq_len, mcfg.d_model]})
    per_step = [mcfg.n_layers] * 2
    rec = dict(ranks=2, mesh=dict(pipe=1, data=1, model=2), card=smi)
    rec["fp32"] = check_parallel_run("phase 21 TP 2 float32", ranks, "fp32", ref32, len(ref32),
                                     per_step, "float32", None)
    n = bf16_steps + tcfg.warmup_steps
    rec["bf16"] = check_parallel_run("phase 21 TP 2 bf16", ranks, "bf16", None, n, per_step,
                                     mcfg.compute_dtype, run_dir / "bf16")
    budget = train_memory_bytes(mcfg, tcfg.batch, mcfg.max_seq_len, {"model": 2}, "dp")
    rec["train_memory_bytes"] = budget["total"]
    rec["allreduce_ms"] = [r["allreduce_ms"] for r in ranks]
    b = rec["bf16"]
    log(f"phase 21 TP 2 (train_config_tp.yaml, {mcfg.n_heads // 2} heads of {mcfg.head_dim} a "
        f"rank, B {tcfg.batch}): bf16 "
        f"losses {b['losses'][0]:.4f} -> {b['losses'][-1]:.4f} over {bf16_steps} steps after "
        f"{tcfg.warmup_steps} warmup; flash launches a rank {b['launches']} (12 forward and 24 "
        f"backward a step, all tc); replicated parameters bit-equal {b['replicas_equal']}; "
        f"step_ms median by rank {[round(v, 3) for v in b['step_ms']]}; peak allocated by "
        f"rank {b['peak']} B, train_memory_bytes(model 2) {budget['total']:.0f} B a rank; one "
        f"float32 all-reduce of the ({tcfg.batch}, {mcfg.max_seq_len}, {mcfg.d_model}) "
        f"activations over gloo {[round(v, 3) for v in rec['allreduce_ms']]} ms by rank "
        f"({4 * mcfg.n_layers} of them a step) [{smi}; {SHARED_CARD}]")
    return rec


def pipeline_phase(ref32, smi: str, device: str = "cuda", bf16_steps: int = 30):
    """Phase 22: ``configs/train_config_pp.yaml`` (2 stages, 2 microbatches
    of B 4, 6 layers a stage) over 2 ranks on one card under GPipe (as
    ``python -m dtc_tpu_torch.main --train_config_path ... --backend gloo``
    runs it), 1F1B and interleaved 1F1B (V 2; the config with
    ``pp_schedule`` / ``pp_virtual_stages`` appended), each after a float32
    dropout-0 run of 4 steps held to one process; then PP 2 x TP 2 in
    float32 over 4 ranks. Each stage's flash launches are the schedule's
    forward slots (from its table) x its chunk's layers. Returns the
    phase's record."""
    from dtc_tpu_torch.config.loader import load_config
    from dtc_tpu_torch.parallel.pipeline import forward_slots, schedule_rows
    from dtc_tpu_torch.utils.metrics import train_memory_bytes

    run_dir = ROOT / "build" / "chip_smoke_pp"
    dev = "cuda:0" if device == "cuda" else device
    cfg_path = ROOT / "configs" / "train_config_pp.yaml"
    tcfg, mcfg, _ = load_config(cfg_path)
    schedules = (("gpipe", {}), ("1f1b", dict(pp_schedule="1f1b")),
                 ("1f1b_v2", dict(pp_schedule="1f1b", pp_virtual_stages=2)))
    copies = ROOT / "build" / "chip_smoke_pp_configs"
    copies.mkdir(parents=True, exist_ok=True)
    runs = []
    for name, over in schedules:
        path = cfg_path
        if over:
            path = copies / f"train_config_pp_{name}.yaml"
            path.write_text(cfg_path.read_text() + "".join(
                f"\n{k}: {v}" for k, v in over.items()) + "\n")
        runs.append(dict(name=f"{name}_fp32", train_config="configs/train_config_pp.yaml",
                         train_over=dict(FP32_TRAIN, steps=len(ref32), **over),
                         model_over=FP32_MODEL))
        runs.append(dict(name=f"{name}_bf16", argv=[
            "--train_config_path", str(path),
            "--model_config_path", str(ROOT / "configs" / "model_config.yaml"),
            "--optim_config_path", str(ROOT / "configs" / "optim_config.yaml"),
            "--dataset", "synthetic", "--no-obs", "--steps", str(bf16_steps),
            "--output_dir", str(run_dir / name), "--backend", "gloo", "--device", dev]))
    ranks = spawn_ranks(2, run_dir, {"device": dev, "runs": runs})
    rec = dict(ranks=2, mesh=dict(pipe=2, data=1, model=1), card=smi)
    budget = train_memory_bytes(mcfg, tcfg.batch, mcfg.max_seq_len, {"pipe": 2}, "pp")
    rec["train_memory_bytes"] = budget["total"]
    for name, over in schedules:
        virtual = over.get("pp_virtual_stages", 1)
        rows = schedule_rows(over.get("pp_schedule", "gpipe"), tcfg.pp_microbatches, 2, virtual)
        layers = mcfg.n_layers // (2 * virtual)
        per_step = [forward_slots(rows, s) * layers for s in range(2)]
        what = f"phase 22 PP 2 {name}"
        r32 = check_parallel_run(f"{what} float32", ranks, f"{name}_fp32", ref32, len(ref32),
                                 per_step, "float32", None)
        n = bf16_steps + tcfg.warmup_steps
        r16 = check_parallel_run(f"{what} bf16", ranks, f"{name}_bf16", None, n, per_step,
                                 mcfg.compute_dtype, run_dir / name)
        rec[name] = dict(fp32=r32, bf16=r16, ticks=len(rows), launches_per_stage_step=per_step)
        log(f"{what} (2 microbatches of B {tcfg.batch // tcfg.pp_microbatches}, "
            f"{mcfg.n_layers // 2} layers a stage, {virtual} chunk(s) a stage, {len(rows)} "
            f"ticks): bf16 losses {r16['losses'][0]:.4f} -> {r16['losses'][-1]:.4f} over "
            f"{bf16_steps} steps; flash forward launches a stage a step {per_step} (the "
            f"table's), totals by stage {r16['launches']}, all tc; step_ms median by stage "
            f"{[round(v, 3) for v in r16['step_ms']]}; peak allocated by stage {r16['peak']} B, "
            f"train_memory_bytes(pipe 2) {budget['total']:.0f} B a stage [{smi}; {SHARED_CARD}]")
    # PP 2 x TP 2: four ranks, float32
    both_dir = ROOT / "build" / "chip_smoke_pp_tp"
    mesh = dict(pipe=2, data=1, model=2)
    spec = {"device": dev, "runs": [dict(
        name="fp32", train_config="configs/train_config_pp.yaml",
        train_over=dict(FP32_TRAIN, steps=len(ref32), parallel="3d", mesh=mesh),
        model_over=FP32_MODEL)]}
    ranks4 = spawn_ranks(4, both_dir, spec)
    rows = schedule_rows("gpipe", tcfg.pp_microbatches, 2)
    per_step = [forward_slots(rows, r // 2) * (mcfg.n_layers // 2) for r in range(4)]
    rec["pp_tp"] = check_parallel_run("phase 22 PP 2 x TP 2 float32", ranks4, "fp32", ref32,
                                      len(ref32), per_step, "float32", None)
    rec["pp_tp"].update(mesh=mesh, train_memory_bytes=train_memory_bytes(
        mcfg, tcfg.batch, mcfg.max_seq_len, mesh, "3d")["total"])
    log(f"phase 22 PP 2 x TP 2 (4 ranks, {mcfg.n_heads // 2} heads of {mcfg.head_dim} a rank, "
        f"{mcfg.n_layers // 2} layers a stage): float32 "
        f"losses equal one process's within 1e-4; flash launches by rank "
        f"{rec['pp_tp']['launches']}; step_ms median by rank "
        f"{[round(v, 3) for v in rec['pp_tp']['step_ms']]}; peak allocated by rank "
        f"{rec['pp_tp']['peak']} B, train_memory_bytes(pipe 2, model 2) "
        f"{rec['pp_tp']['train_memory_bytes']:.0f} B a rank [{smi}; {SHARED_CARD}]")
    return rec


# ---------------------------------------------------------------------------
# phase 23: DP×FSDP×TP and FSDP with ring attention, ranks sharing one card
# ---------------------------------------------------------------------------

def check_ring_launches(what: str, ranks: list[dict], name: str, per_step, n_steps: int,
                        route: str | None) -> list:
    """Each rank's FSDP ring launches over run ``name``: ``per_step``
    (all-gather-matmul, reduce-scatter steps) a step for ``n_steps`` steps,
    every one on ``route``. Returns the launches by rank."""
    want = (per_step[0] * n_steps, per_step[1] * n_steps)
    recs = [next(r for r in rank["records"] if r["name"] == name) for rank in ranks]
    for rank, r in enumerate(recs):
        check(tuple(r["ring_launches"]) == want,
              f"{what}: rank {rank} ring launches {r['ring_launches']}, want {want}")
        if route is not None:
            check(r["ring_routes"][route] == sum(want) == sum(r["ring_routes"].values()),
                  f"{what}: rank {rank} ring launches by route {r['ring_routes']}, want all "
                  f"{sum(want)} on {route}")
    return [r["ring_launches"] for r in recs]


def fsdp_mesh_phase(ref32, smi: str, device: str = "cuda", bf16_steps: int = 6,
                    ring_bf16_steps: int = 3):
    """Phase 23: (a) ``configs/train_config_3d.yaml`` (DP×FSDP×TP,
    ``collectives: overlapped``, data 4 × model 2: 8 gloo ranks sharing the
    card) in float32 at dropout 0 under ``xla`` and under
    ``overlapped``, ``len(ref32)`` steps each, held to one process on the
    config's batch within 1e-4; then ``python -m dtc_tpu_torch.main --train_config_path
    configs/train_config_3d.yaml --dataset synthetic --no-obs --backend gloo
    --device cuda:0`` in bf16, every rank inside a torch.profiler window on
    a card (the ring kernels' device time a step, each rank's busy time).
    (b) ``train_config_fsdp.yaml`` with ``attention: ring`` on data 2 ×
    model 2 (4 ranks), float32, held to ``ref32`` (one process on the same
    batch and seed), then bf16 for ``ring_bf16_steps`` steps
    (finite, every block launch on the tensor-core route). Returns the
    phase's record."""
    from dtc_tpu_torch.config.loader import load_config
    from dtc_tpu_torch.ops import flash_attention as fa
    from dtc_tpu_torch.utils.metrics import train_memory_bytes

    cfg = "configs/train_config_3d.yaml"
    dev = "cuda:0" if device == "cuda" else device
    tcfg, mcfg, _ = load_config(ROOT / cfg)
    mesh = dict(pipe=1, data=tcfg.mesh.data, model=tcfg.mesh.model)
    world, ring = mesh["data"] * mesh["model"], mesh["data"]
    sites = mcfg.n_layers * 6
    per_step = (sites * 2 * ring, sites * ring)       # the gate: a rank's ring steps a step
    run_dir = ROOT / "build" / "chip_smoke_3d"
    ref3d = one_process_fp32(len(ref32), device, cfg)
    runs = [dict(name=f"{mode}_fp32", train_config=cfg, model_over=FP32_MODEL,
                 train_over=dict(FP32_TRAIN, steps=len(ref3d), collectives=mode))
            for mode in ("xla", "overlapped")]
    runs.append(dict(name="bf16", argv=[
        "--train_config_path", str(ROOT / cfg), "--dataset", "synthetic", "--no-obs",
        "--steps", str(bf16_steps), "--output_dir", str(run_dir / "bf16"), "--backend", "gloo",
        "--device", dev]))
    ranks = spawn_ranks(world, run_dir, {"device": dev, "runs": runs, "profile": ["bf16"]},
                        timeout=700.0)
    flash = [mcfg.n_layers] * world                   # TP: each rank's heads, every layer
    rec = dict(ranks=world, mesh=mesh, card=smi, one_process_fp32=ref3d)
    for mode in ("xla", "overlapped"):
        what = f"phase 23 3D {mode} float32"
        rec[f"{mode}_fp32"] = check_parallel_run(what, ranks, f"{mode}_fp32", ref3d, len(ref3d),
                                                 flash, "float32", None)
        rec[f"{mode}_fp32"]["ring_launches"] = check_ring_launches(
            what, ranks, f"{mode}_fp32", per_step if mode == "overlapped" else (0, 0),
            len(ref3d), "cuda_cores" if mode == "overlapped" else None)
    n = bf16_steps + tcfg.warmup_steps
    b = rec["bf16"] = check_parallel_run("phase 23 3D overlapped bf16", ranks, "bf16", None, n,
                                         flash, mcfg.compute_dtype, run_dir / "bf16")
    b["ring_launches"] = check_ring_launches("phase 23 3D overlapped bf16", ranks, "bf16",
                                             per_step, n, "tma")
    # what each rank launched a step in this run (the gate above held it to per_step)
    rec["ring_launches_per_rank_step"] = [(a // n, r // n) for a, r in b["ring_launches"]]
    budget = train_memory_bytes(mcfg, tcfg.batch, mcfg.max_seq_len,
                                {"data": mesh["data"], "model": mesh["model"]}, "fsdp")
    rec["train_memory_bytes"] = budget["total"]
    log(f"phase 23 DP×FSDP×TP (train_config_3d.yaml, {world} ranks, data {mesh['data']} x "
        f"model {mesh['model']}, {mcfg.n_heads // mesh['model']} heads of {mcfg.head_dim} a "
        f"rank, B {tcfg.batch // mesh['data']} a rank): float32 xla and overlapped losses "
        f"within 1e-4 of one process ({ref3d}); bf16 overlapped losses {b['losses'][0]:.4f} -> "
        f"{b['losses'][-1]:.4f} over {bf16_steps} steps after {tcfg.warmup_steps} warmup; "
        f"ring launches a rank a step {rec['ring_launches_per_rank_step']} (all tma), "
        f"flash launches a rank "
        f"{b['launches'][0]} ({mcfg.n_layers} forward and {2 * mcfg.n_layers} backward a step, "
        f"all tc); replicated parameters bit-equal {b['replicas_equal']}; step_ms median by "
        f"rank {[round(v, 3) for v in b['step_ms']]}; peak allocated by rank {b['peak']} B, "
        f"train_memory_bytes(fsdp, data {mesh['data']}, model {mesh['model']}) "
        f"{budget['total']:.0f} B a rank [{smi}; {SHARED_CARD}]")
    if device == "cuda":                              # the ranks profile only on a card
        prof = [next(r for r in rank["records"] if r["name"] == "bf16")["profile"]
                for rank in ranks]
        wall = max(p["wall_s"] for p in prof)
        pr = b["profile"] = dict(
            steps=n, wall_s=[p["wall_s"] for p in prof],
            device_busy_s=[p["device_busy_s"] for p in prof],
            ring_kernel_ms_a_step=[p["overlap_device_s"] * 1e3 / n for p in prof],
            flash_ms_a_step=[p["flash_device_s"] * 1e3 / n for p in prof],
            card_busy_share=sum(p["device_busy_s"] for p in prof) / wall,
            top_rank0=prof[0]["top"][:8])
        log(f"phase 23 3D bf16 under torch.profiler (CUDA activity, every rank, the whole run of "
            f"{n} steps): ring kernels {[round(v, 3) for v in pr['ring_kernel_ms_a_step']]} ms a "
            f"step by rank, flash {[round(v, 3) for v in pr['flash_ms_a_step']]} ms a step, device "
            f"busy {[round(v, 3) for v in pr['device_busy_s']]} s of walls "
            f"{[round(v, 3) for v in pr['wall_s']]} s; the ranks' busy time summed "
            f"{pr['card_busy_share']:.4f} of the longest wall; rank 0's largest kernels "
            f"{[(t['name'][:60], round(t['device_ms'], 3), t['count']) for t in pr['top_rank0']]} "
            f"[{smi}; {SHARED_CARD}]")
        check(all(p["overlap_device_s"] > 0 for p in prof),
              f"phase 23 3D bf16: the profiler saw no ring kernel on some rank "
              f"{[p['overlap_device_s'] for p in prof]}")

    # (b) FSDP with ring attention over the model axis
    ring_mesh = dict(pipe=1, data=2, model=2)
    ring_dir = ROOT / "build" / "chip_smoke_fsdp_ring"
    spec = {"device": dev, "runs": [
        dict(name="fp32", train_config="configs/train_config_fsdp.yaml",
             train_over=dict(FP32_TRAIN, steps=len(ref32), mesh=ring_mesh),
             model_over=dict(FP32_MODEL, attention="ring")),
        dict(name="bf16", train_config="configs/train_config_fsdp.yaml",
             train_over=dict(FP32_TRAIN, steps=ring_bf16_steps, mesh=ring_mesh),
             model_over=dict(attention="ring"))]}
    spawned = spawn_ranks(4, ring_dir, spec, timeout=400.0)
    recs = [r["records"][0] for r in spawned]
    losses = recs[0]["losses"]
    gap = max(abs(a - b_) for a, b_ in zip(losses, ref32))
    calls = mcfg.n_layers * (2 * ring_mesh["model"] + 1) * len(ref32)  # 2R+1 blocks a layer
    log(f"phase 23 FSDP x ring attention (train_config_fsdp.yaml, data 2 x model 2, T "
        f"{mcfg.max_seq_len // 2} a rank, float32): losses {losses} vs one process {ref32} "
        f"(gap {gap:.3e}, limit 1e-4); block launches by rank "
        f"{[r['block_launches'] for r in recs]}; step_ms median by rank "
        f"{[round(step_ms(r['elapsed']), 3) for r in recs]} [{smi}; {SHARED_CARD}]")
    check(all(r["losses"] == losses for r in recs), f"phase 23 ring: ranks logged different "
          f"losses {[r['losses'] for r in recs]}")
    check(len(losses) == len(ref32) and gap <= 1e-4,
          f"phase 23 ring: losses {losses} vs one process {ref32}")
    for rank, r in enumerate(recs):
        check(tuple(r["block_launches"]) == (calls, calls * fa.BWD_KERNELS)
              and tuple(r["launches"]) == (0, 0) and tuple(r["ring_launches"]) == (0, 0),
              f"phase 23 ring: rank {rank} block launches {r['block_launches']} (want "
              f"{calls} forward calls), flash {r['launches']}, FSDP ring {r['ring_launches']}")
        check(r["routes"]["fwd"] == {"tc": 0, "fma": calls}
              and r["routes"]["dq"] == r["routes"]["dkv"] == {"tc": 0, "fma": calls},
              f"phase 23 ring: rank {rank} block launches by route {r['routes']}")
    # bf16, the configs' compute dtype: every block launch on the tensor cores
    r16 = [r["records"][1] for r in spawned]
    calls16 = mcfg.n_layers * (2 * ring_mesh["model"] + 1) * ring_bf16_steps
    log(f"phase 23 FSDP x ring attention bf16: losses {r16[0]['losses']} over "
        f"{ring_bf16_steps} steps; block launches by rank {[r['block_launches'] for r in r16]} "
        f"by route {r16[0]['routes']}; step_ms median by rank "
        f"{[round(step_ms(r['elapsed']), 3) for r in r16]} [{smi}; {SHARED_CARD}]")
    check(all(r["losses"] == r16[0]["losses"] for r in r16)
          and len(r16[0]["losses"]) == ring_bf16_steps
          and all(math.isfinite(v) for v in r16[0]["losses"]),
          f"phase 23 ring bf16: losses by rank {[r['losses'] for r in r16]}")
    for rank, r in enumerate(r16):
        check(tuple(r["block_launches"]) == (calls16, calls16 * fa.BWD_KERNELS)
              and tuple(r["launches"]) == (0, 0) and tuple(r["ring_launches"]) == (0, 0)
              and all(r["routes"][k] == {"tc": calls16, "fma": 0} for k in ("fwd", "dq", "dkv")),
              f"phase 23 ring bf16: rank {rank} block launches {r['block_launches']} by route "
              f"{r['routes']} (want {calls16} forward calls, all tc), flash {r['launches']}, "
              f"FSDP ring {r['ring_launches']}")
    rec["fsdp_ring"] = dict(mesh=ring_mesh, losses=losses, gap=gap,
                            block_launches=[r["block_launches"] for r in recs],
                            step_ms=[step_ms(r["elapsed"]) for r in recs],
                            peak=[r["peak"] for r in recs],
                            bf16=dict(losses=r16[0]["losses"],
                                      block_launches=[r["block_launches"] for r in r16],
                                      step_ms=[step_ms(r["elapsed"]) for r in r16]))
    return rec


# ---------------------------------------------------------------------------
# phase 24: checkpoints, resume, held-out eval and the guard's rollback
# ---------------------------------------------------------------------------

def _models_equal(a, b) -> bool:
    import torch

    return all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))


def checkpoint_phase(smi: str, phase7_step_ms: float, steps: int = 20, warmup: int = 5,
                     poison_step: int = 13, device: str = "cuda") -> dict:
    """The flagship (``train_config_dp.yaml`` + ``model_config.yaml``, B 8,
    synthetic data, bf16 compute) with checkpoints and held-out eval every
    10 steps (2 eval batches, ``log_every`` 5, ``checkpoint_keep_n`` 2), in
    a temporary directory: (a) run A trains ``steps`` steps; run B trains
    10 and run C resumes B's directory to ``steps``: C's losses, its eval
    loss and its parameters equal A's bit for bit, and every flash launch
    of A (its eval forwards among them) is "tc"; (b) a truncated file of
    the newest step fails its manifest and ``restore_latest`` lands on the
    previous step; (c) the trainer's ``train_step`` wrapped to multiply the
    parameters and the loss by NaN after the update of ``poison_step``
    (the JAX package's chaos ``maybe_poison``), with ``log_every`` 10 and
    checkpoints every 5: the save at 15 is skipped, the guard rolls back to
    step 10 and the run ends with A's losses, eval losses and parameters
    bit for bit; (d) a checkpoint's bytes, save seconds (sha256 seconds
    inside them), restore seconds, eval ms per batch (CUDA events) and A's
    step median beside phase 7's. ``device``: ``cpu`` rehearses the phase
    (no timing is a card's there)."""
    import dataclasses
    import io
    import shutil
    import tempfile

    import torch

    from dtc_tpu_torch.config.loader import load_config
    from dtc_tpu_torch.config.schema import ChaosConfig
    from dtc_tpu_torch.data.prefetch import split_to_device
    from dtc_tpu_torch.ops import flash_attention as fa
    from dtc_tpu_torch.resilience import ChaosInjector, RecoveryBus
    from dtc_tpu_torch.train import trainer as trainer_mod
    from dtc_tpu_torch.train.train_step import eval_loss
    from dtc_tpu_torch.utils.checkpoint import CheckpointManager

    tcfg0, mcfg, ocfg = load_config(ROOT / "configs" / "train_config_dp.yaml")
    rec: dict = dict(card=smi)
    cuda = device.startswith("cuda")

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize()

    with tempfile.TemporaryDirectory(prefix="dtc_chip_smoke_ckpt_") as tmp:
        tmp = Path(tmp)

        def cfg(name, **over):
            kw = dict(dataset="synthetic", obs=dataclasses.replace(tcfg0.obs, enabled=False),
                      steps=steps, warmup_steps=warmup, log_every=5, checkpoint_every=10,
                      eval_every=10, eval_batches=2, output_dir=str(tmp / name),
                      checkpoint_dir=str(tmp / f"{name}_ckpt"), overwrite=False,
                      resilience=dataclasses.replace(tcfg0.resilience, checkpoint_keep_n=2))
            kw.update(over)
            return dataclasses.replace(tcfg0, **kw)

        def train(name, **over):
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                res = trainer_mod.train(cfg(name, **over), mcfg, ocfg, device=device)
            return res, out.getvalue(), time.perf_counter() - t0

        # (a) resume is bit-exact
        zero_flash_counts()
        a, _, a_s = train("a")
        a_launches = [fa.fwd_launches, fa.bwd_launches]
        routes = check_flash_routes("phase 24 run A", mcfg.compute_dtype)
        n_steps, n_evals = warmup + steps, 2 * 2
        check(not cuda or a_launches == [mcfg.n_layers * (n_steps + n_evals),
                                         mcfg.n_layers * n_steps * fa.BWD_KERNELS],
              f"phase 24: flash launches fwd / bwd {a_launches}, want "
              f"{mcfg.n_layers} a step and an eval batch / {mcfg.n_layers * fa.BWD_KERNELS} a "
              f"step over {n_steps} steps and {n_evals} eval batches")
        check(len(a.losses) == steps and all(math.isfinite(x) for x in a.losses)
              and [s for s, _ in a.eval_losses] == [10, 20],
              f"phase 24 run A: losses {a.losses}, eval {a.eval_losses}")
        b, _, b_s = train("b", steps=10)
        c, c_out, c_s = train("b")
        check("resumed from checkpoint step 10" in c_out, f"phase 24 run C did not resume:\n{c_out}")
        check(b.losses == a.losses[:10] and c.losses == a.losses[10:],
              f"phase 24: B + C losses {b.losses} + {c.losses} != A's {a.losses}")
        check(b.eval_losses + c.eval_losses == a.eval_losses,
              f"phase 24: B + C eval {b.eval_losses} + {c.eval_losses} != A's {a.eval_losses}")
        check(_models_equal(a.model, c.model), "phase 24: C's parameters differ from A's")
        eval_rows = (tmp / "b" / "eval_log.csv").read_text().splitlines()
        log_rows = (tmp / "b" / "log.csv").read_text().splitlines()
        check(eval_rows[0] == "step,loss" and len(eval_rows) == 3 and len(log_rows) == steps + 1,
              f"phase 24: B/C eval_log.csv {eval_rows}, log.csv {len(log_rows) - 1} rows")
        rec["resume"] = dict(losses=a.losses, eval_losses=a.eval_losses,
                             flash_launches=a_launches,
                             flash_routes=routes, run_s=dict(a=a_s, b=b_s, c=c_s))
        log(f"phase 24 (a): the flagship with checkpoints and eval every 10 steps: C resumed "
            f"B's step 10 to {steps}; its {len(c.losses)} losses, eval loss "
            f"{c.eval_losses[0][1]!r} at step 20 and parameters equal run A's bit for bit; "
            f"A's flash launches fwd {a_launches[0]} ({n_steps} steps + {n_evals} eval "
            f"batches) and bwd {a_launches[1]}, by route {routes} [{smi}]")
        del b, c
        torch.cuda.empty_cache()

        # (b) a truncated newest step falls back to the previous one: the
        # chaos harness damages it (its largest file cut to half)
        b_dir = tmp / "b_ckpt"
        steps_b = CheckpointManager(str(b_dir)).all_steps()
        check(steps_b == [10, 20], f"phase 24: B's steps {steps_b} (keep_n 2)")
        sizes = {f.name: f.stat().st_size for f in (b_dir / "20").iterdir()}
        bus = RecoveryBus()
        injector = ChaosInjector(ChaosConfig(enabled=True, corrupt_ckpt_at_step=20,
                                             corrupt_mode="truncate"), bus)
        with contextlib.redirect_stdout(io.StringIO()):
            check(injector.maybe_corrupt_checkpoint(20, str(b_dir / "20")),
                  "phase 24 (b): the chaos injector damaged nothing")
        cut = [n for n, size in sizes.items() if (b_dir / "20" / n).stat().st_size != size]
        check(len(cut) == 1 and bus.drain() == [("chaos", dict(kind="ckpt_corrupt", step=20,
                                                                  mode="truncate"))],
              f"phase 24 (b): files cut {cut}")
        victim = b_dir / "20" / cut[0]
        fallbacks = []
        reopened = CheckpointManager(str(b_dir), on_event=lambda *a, **k: fallbacks.append(k))
        check(not reopened.verify_step(20), "phase 24: the truncated step 20 passed its manifest")
        _, got = reopened.restore_latest(map_location=device)
        check(got == 10 and [f["rejected_step"] for f in fallbacks] == [20],
              f"phase 24: restore_latest landed on {got}, not 10; fallbacks {fallbacks}")
        rec["fallback"] = dict(truncated=str(victim.relative_to(tmp)), restored_step=got)
        log(f"phase 24 (b): step 20's {victim.name} truncated to half by the chaos injector: the "
            f"manifest rejects it, restore_latest lands on step {got} and posts ckpt_fallback")
        shutil.rmtree(b_dir)

        # (c) the rollback drill: the chaos harness's NaN
        chaos = ChaosConfig(enabled=True, nan_at_step=poison_step)
        d, d_out, d_s = train("d", log_every=10, checkpoint_every=5,
                              resilience=dataclasses.replace(
                                  tcfg0.resilience, checkpoint_keep_n=2, chaos=chaos))
        check(f"CHAOS: injecting nan_loss ({{'step': {poison_step}}})" in d_out
              and "restored checkpoint step 10," in d_out
              and "skipping checkpoint at step 15" in d_out,
              f"phase 24 (c): no injection, rollback to 10 or skipped save:\n{d_out}")
        check(d.losses == a.losses and d.eval_losses == a.eval_losses
              and _models_equal(a.model, d.model),
              f"phase 24 (c): the drill's losses {d.losses} / eval {d.eval_losses} != A's")
        rec["rollback"] = dict(poison_step=poison_step, to_step=10, skipped_save=15, run_s=d_s)
        log(f"phase 24 (c): resilience.chaos nan_at_step {poison_step}: the save at 15 "
            f"skipped, rolled back to step 10; the {steps} losses, eval losses and parameters "
            f"equal run A's bit for bit [{smi}]")
        del d
        shutil.rmtree(tmp / "d_ckpt")
        torch.cuda.empty_cache()

        # (d) costs
        a_dir = tmp / "a_ckpt"
        sync()
        t0 = time.perf_counter()
        state, got = CheckpointManager(str(a_dir)).restore_latest(map_location=device)
        sync()
        restore_s = time.perf_counter() - t0
        check(got == 20 and torch.equal(state["model"]["head.lm_head.weight"],
                                        a.model.head.lm_head.weight),
              "phase 24 (d): restored step 20 differs from run A's model")
        mgr = CheckpointManager(str(tmp / "cost"), keep_n=1)
        t0 = time.perf_counter()
        mgr.save(20, {"model": state["model"], "optimizer": state["optimizer"]},
                 {"rng": state["rng"]})
        save_s = time.perf_counter() - t0
        nbytes = mgr.bytes_written
        del state
        x, y = split_to_device(next(trainer_mod.make_eval_iterator(cfg("e"), mcfg)), a.model
                               .head.lm_head.weight.device)
        eval_ms = cuda_ms(lambda: eval_loss(a.model, x, y), iters=20, warmup=3) if cuda else None
        el = a.elapsed_times
        step_ms = sorted(b_ - a_ for a_, b_ in zip([0.0] + el[:-1], el))[len(el) // 2] * 1e3
        rec["costs"] = dict(bytes=nbytes, params=sum(p.numel() for p in a.model.parameters()),
                            save_s=save_s, sha256_s=mgr.hash_s, restore_s=restore_s,
                            eval_ms_per_batch=eval_ms, step_ms_median=step_ms,
                            phase7_step_ms_median=phase7_step_ms, card=smi)
        log(f"phase 24 (d): a checkpoint {nbytes} B ({rec['costs']['params']} parameters, "
            f"float32 + 2 moments); save {save_s:.6f} s (sha256 {mgr.hash_s:.6f} s of it); "
            f"restore (verify + load onto the card) {restore_s:.6f} s; eval {eval_ms} ms a "
            f"batch (B {tcfg0.batch}, T {mcfg.max_seq_len}); run A's step_ms median "
            f"{step_ms:.6f} (phase 7: {phase7_step_ms:.6f}) [{smi}]")
        del a
        torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 25: bf16_mixed master weights; the LoRA finetune -> gate -> export ->
# serve loop
# ---------------------------------------------------------------------------

def bf16_mixed_phase(smi: str, phase7, steps: int = 35, device: str = "cuda") -> dict:
    """25(a): ``python -m dtc_tpu_torch.main --train_config_path
    configs/train_config_bf16.yaml --optim_config_path
    configs/optim_config_bf16.yaml --dataset synthetic --no-obs --steps 35
    --output_dir <tmp>`` (5 warmup steps): finite losses whose last-5 mean
    is below the first; the first 8 within 3% of phase 7's (``phase7``: its
    record; same seed, batches and dropout masks); every parameter's dtype
    as on the CPU, masters and moments float32; 12 forward and 24 backward
    flash launches a step, all "tc". Records the step median beside phase
    7's, the peak memory beside ``train_memory_bytes(precision=
    "bf16_mixed")``, and a torch.profiler window of 5 steps of each
    precision (busy share, elementwise passes and copies a step)."""
    import dataclasses
    import tempfile

    import torch

    from dtc_tpu_torch import main as cli
    from dtc_tpu_torch.config.loader import load_config
    from dtc_tpu_torch.models.gpt import GPT
    from dtc_tpu_torch.ops import flash_attention as fa
    from dtc_tpu_torch.train.train_step import resolve_precision
    from dtc_tpu_torch.utils.metrics import train_memory_bytes

    cfgs = [ROOT / "configs" / n for n in ("train_config_bf16.yaml", "optim_config_bf16.yaml")]
    tcfg, mcfg, ocfg = load_config(cfgs[0], optim_config_path=cfgs[1])
    rcfg = resolve_precision(ocfg, mcfg)
    cuda = device.startswith("cuda")
    with tempfile.TemporaryDirectory(prefix="dtc_chip_smoke_bf16_") as tmp:
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if cuda else 0
        zero_flash_counts()                          # the main path starts here
        argv = ["--train_config_path", str(cfgs[0]), "--optim_config_path", str(cfgs[1]),
                "--dataset", "synthetic", "--no-obs", "--steps", str(steps),
                "--output_dir", tmp] + ([] if cuda else ["--device", device])
        res = cli.main(argv)
        launches = (fa.fwd_launches, fa.bwd_launches)  # ...and ends here
        peak = torch.cuda.max_memory_allocated() - base if cuda else None
        routes = check_flash_routes("phase 25(a) bf16_mixed", rcfg.compute_dtype)
        rows = (Path(tmp) / "log.csv").read_text().splitlines()
    losses = res.losses
    n_steps = steps + tcfg.warmup_steps
    check(len(losses) == steps and all(math.isfinite(x) for x in losses)
          and sum(losses[-5:]) / 5 < losses[0],
          f"phase 25(a): {len(losses)} losses, not finite or not falling: {losses}")
    check(len(rows) == steps + 1, f"phase 25(a): log.csv {len(rows) - 1} rows for {steps}")
    want7 = phase7["losses"][:8]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[:8], want7)]
    check(max(rel) < 0.03, f"phase 25(a): the first 8 losses {losses[:8]} not within 3% of "
          f"phase 7's {want7} ({rel})")
    opt = res.optimizer
    # the CPU's dtypes, by name with the layer index dropped (one layer built)
    unlayer = functools.partial(re.sub, r"blocks\.\d+\.", "blocks.")
    want_dtypes = {unlayer(n): p.dtype for n, p in GPT(
        dataclasses.replace(rcfg, n_layers=1), device="cpu").named_parameters()}
    got_dtypes = {unlayer(n): p.dtype for n, p in res.model.named_parameters()}
    check(got_dtypes == want_dtypes and set(want_dtypes.values()) == {torch.bfloat16,
                                                                       torch.float32},
          f"phase 25(a): parameter dtypes {got_dtypes} differ from the CPU's {want_dtypes}")
    check(all(t.dtype == torch.float32 for t in opt.masters + opt.mu + opt.nu)
          and all(torch.equal(p.detach(), m.to(p.dtype)) for p, m in zip(opt.params,
                                                                          opt.masters)),
          "phase 25(a): masters or moments not float32, or a parameter not its master rounded")
    check(not cuda or launches == (rcfg.n_layers * n_steps,
                                   rcfg.n_layers * n_steps * fa.BWD_KERNELS),
          f"phase 25(a): flash launches {launches} for {n_steps} steps")
    budget = train_memory_bytes(rcfg, tcfg.batch, rcfg.max_seq_len, precision="bf16_mixed")
    budget32 = train_memory_bytes(mcfg, tcfg.batch, mcfg.max_seq_len)
    rec = dict(losses=losses, first8_rel_to_phase7=rel, step_ms_median=step_ms(
        res.elapsed_times), phase7_step_ms_median=phase7["step_ms_median"],
        peak_allocated=peak, phase7_peak_allocated=phase7["peak_allocated"],
        train_memory_bytes=budget, train_memory_bytes_fp32=budget32,
        flash_launches=launches, flash_routes=routes, card=smi)
    del res, opt
    if cuda:
        torch.cuda.empty_cache()
        for tag, (m, o) in (("bf16_mixed", (rcfg, ocfg)),
                            ("fp32", (mcfg, dataclasses.replace(ocfg, precision="fp32")))):
            prof = profile_train(m, tcfg, o, steps=5)
            rec[f"profile_{tag}"] = prof
            log(f"phase 25(a) profile {tag}: 5 steps, wall {prof['wall_s'] / 5 * 1e3:.6f} ms a "
                f"step, device busy {prof['device_busy_s'] / 5 * 1e3:.6f} ms a step (share "
                f"{prof['busy_share']:.4f}), {prof['kernel_launches'] // 5} kernels a step; "
                f"elementwise passes "
                f"{prof['elementwise_device_s'] / 5 * 1e3:.6f} ms and copies "
                f"{prof['copy_device_s'] / 5 * 1e3:.6f} ms a step; flash "
                f"{prof['flash_device_s'] / 5 * 1e3:.6f} ms a step [{smi}]")
            for row in prof["top"][:8]:
                log(f"  {row['device_ms'] / 5:.4f} ms a step x{row['count'] // 5} {row['name']}")
            torch.cuda.empty_cache()
    log(f"phase 25(a) bf16_mixed (train_config_bf16.yaml + optim_config_bf16.yaml, {steps} "
        f"steps after {tcfg.warmup_steps} warmup): loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"the first 8 within {max(rel):.6f} of phase 7's; flash launches {launches}, by route "
        f"{routes}; step_ms median {rec['step_ms_median']:.6f} (phase 7: "
        f"{phase7['step_ms_median']:.6f}); peak allocated {peak} B (phase 7: "
        f"{phase7['peak_allocated']} B), train_memory_bytes bf16_mixed {budget['total']:.0f} B "
        f"(params {budget['params']:.0f}, master {budget['master']:.0f}, moments "
        f"{budget['moments']:.0f}), fp32 {budget32['total']:.0f} B [{smi}]")
    return rec


def finetune_phase(smi: str, device: str = "cuda") -> tuple[dict, Path]:
    """25(b): ``python -m dtc_tpu_torch.adapters.finetune --finetune_config
    configs/finetune_lora.yaml --no-obs --out <tmp>/adapter.npz --output_dir
    <tmp>``
    (the flagship with the adapter block, 60 steps, eval and checkpoints at
    20, 40 and 60), read back from the files it writes (``log.csv``,
    ``eval_log.csv``, the checkpoints, the exported ``.npz``): exit 0 with
    the gate passed; the eval loss at 60 below the one at 20; the exported
    factors on a fresh ``GPT(seed)`` give the step-60 eval loss bit for bit
    (the base the run evaluated is the seed's); the checkpoints hold the
    adapter, its optimizer state and the generator alone; the same command
    stopped at 40 (``--steps 40``) and run again to 60 gives the
    uninterrupted run's losses, eval losses and factors bit for bit;
    every flash launch "tc", 12 a step and an eval batch forward and 24 a
    step backward. Records the checkpoint bytes, save and restore seconds
    and the step median. Returns the record and the directory holding the
    export (the caller removes it)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from dtc_tpu_torch.adapters import finetune as ft
    from dtc_tpu_torch.adapters.lora import load_adapter_file
    from dtc_tpu_torch.config.loader import load_finetune_config
    from dtc_tpu_torch.data.prefetch import split_to_device
    from dtc_tpu_torch.models.gpt import GPT, adapter_param_count
    from dtc_tpu_torch.ops import flash_attention as fa
    from dtc_tpu_torch.train.train_step import eval_loss
    from dtc_tpu_torch.train.trainer import make_eval_iterator
    from dtc_tpu_torch.utils.checkpoint import CheckpointManager

    path = ROOT / "configs" / "finetune_lora.yaml"
    tcfg, mcfg, ocfg = load_finetune_config(path)
    cuda = device.startswith("cuda")
    tmp = Path(tempfile.mkdtemp(prefix="dtc_chip_smoke_finetune_"))

    def run(name, *extra):
        argv = ["--finetune_config", str(path), "--no-obs", "--out", str(tmp / f"{name}.npz"),
                "--output_dir", str(tmp / name)] + list(extra)
        if not cuda:
            argv += ["--device", device]
        t0 = time.perf_counter()
        code = ft.main(argv)
        return code, time.perf_counter() - t0

    def rows(name, csv):
        return [r.split(",") for r in (tmp / name / csv).read_text().splitlines()[1:]]

    zero_flash_counts()                          # the main path starts here
    code, full_s = run("full")
    launches = (fa.fwd_launches, fa.bwd_launches)  # ...and ends here
    routes = check_flash_routes("phase 25(b) finetune", mcfg.compute_dtype)
    n_steps = tcfg.steps + tcfg.warmup_steps
    n_evals = (tcfg.steps // tcfg.eval_every) * tcfg.eval_batches
    check(code == 0 and (tmp / "full.npz").exists(), f"phase 25(b): exit {code}")
    trained, meta = load_adapter_file(str(tmp / "full.npz"))
    check(meta["gate_passed"] is True, f"phase 25(b): the export's meta {meta}")
    evals = [(int(s), float(v)) for s, v in rows("full", "eval_log.csv")]
    losses = [float(r[2]) for r in rows("full", "log.csv")]
    elapsed = [float(r[1]) for r in rows("full", "log.csv")]
    check([s for s, _ in evals] == [20, 40, 60] and evals[-1][1] < evals[0][1]
          and (meta["eval_first"], meta["eval_final"]) == (evals[0][1], evals[-1][1]),
          f"phase 25(b): eval losses {evals} (want 20, 40, 60, falling), meta {meta}")
    check(len(losses) == tcfg.steps and all(math.isfinite(x) for x in losses),
          f"phase 25(b): losses {losses}")
    check(not cuda or launches == (mcfg.n_layers * (n_steps + n_evals),
                                   mcfg.n_layers * n_steps * fa.BWD_KERNELS),
          f"phase 25(b): flash launches {launches} for {n_steps} steps and {n_evals} eval "
          f"batches")
    # The export on the seed's base gives the run's last eval loss bit for
    # bit: the base the run trained against did not move.
    fresh = GPT(mcfg, device=device, seed=tcfg.seed)
    factors = {k: v.to(device) for k, v in trained.items()}
    it = make_eval_iterator(tcfg, mcfg)
    dev = torch.device(device)
    again = float(np.mean([float(eval_loss(fresh, *split_to_device(next(it), dev), lora=factors))
                           for _ in range(tcfg.eval_batches)]))
    check(again == evals[-1][1],
          f"phase 25(b): the export on GPT(seed)'s base evaluates to {again!r}, the run's "
          f"step-60 eval loss {evals[-1][1]!r}: the base moved")
    del fresh
    ckdir = tmp / "full" / "checkpoints"
    mgr = CheckpointManager(str(ckdir))
    steps_saved = mgr.all_steps()
    files = sorted(f.name for f in Path(mgr.step_dir(60)).iterdir())
    check(steps_saved == [20, 40, 60] and files == ["adapter.pt", "optimizer.pt", "rng_p0.pt"],
          f"phase 25(b): checkpoints {steps_saved}, files {files}")
    nbytes = sum((Path(mgr.step_dir(60)) / n).stat().st_size for n in files)
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, got = mgr.restore_latest(map_location=device)
    if cuda:
        torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(got == 60 and sorted(state["adapter"]) == sorted(factors)
          and all(torch.equal(state["adapter"][k], v) for k, v in factors.items()),
          "phase 25(b): the step-60 checkpoint's factors differ from the export's")
    cost = CheckpointManager(str(tmp / "cost"), keep_n=1)
    t0 = time.perf_counter()
    cost.save(60, {"adapter": state["adapter"], "optimizer": state["optimizer"]},
              {"rng": state["rng"]})
    save_s = time.perf_counter() - t0
    n_params = sum(v.numel() for v in trained.values())
    check(n_params == adapter_param_count(mcfg),
          f"phase 25(b): {n_params} adapter parameters, adapter_param_count "
          f"{adapter_param_count(mcfg)}")
    del state

    # stopped at 40, run again to 60 (the CLI resumes from the checkpoints)
    code40, _ = run("part", "--steps", "40")
    code60, _ = run("part")
    check(code40 == 0 and code60 == 0, f"phase 25(b): resume exits {code40}, {code60}")
    part_losses = [float(r[2]) for r in rows("part", "log.csv")]
    part_evals = [(int(s), float(v)) for s, v in rows("part", "eval_log.csv")]
    resumed, _ = load_adapter_file(str(tmp / "part.npz"))
    check(part_losses == losses and part_evals == evals
          and all(torch.equal(resumed[k], v) for k, v in trained.items()),
          f"phase 25(b): stopped at 40 and resumed: losses {part_losses}, eval {part_evals} "
          f"differ from the uninterrupted run's {losses}, {evals}")
    shutil.rmtree(tmp / "part")
    shutil.rmtree(tmp / "cost")
    prof = None
    if cuda:
        torch.cuda.empty_cache()
        prof = profile_train(mcfg, tcfg, ocfg, steps=5)
        log(f"phase 25(b) profile: 5 finetune steps, wall {prof['wall_s'] / 5 * 1e3:.6f} ms a "
            f"step, device busy {prof['device_busy_s'] / 5 * 1e3:.6f} ms a step (share "
            f"{prof['busy_share']:.4f}), {prof['kernel_launches'] // 5} kernels a step; "
            f"elementwise passes {prof['elementwise_device_s'] / 5 * 1e3:.6f} ms and copies "
            f"{prof['copy_device_s'] / 5 * 1e3:.6f} ms a step; flash "
            f"{prof['flash_device_s'] / 5 * 1e3:.6f} ms a step [{smi}]")
        for row in prof["top"][:6]:
            log(f"  {row['device_ms'] / 5:.4f} ms a step x{row['count'] // 5} {row['name']}")
    rec = dict(losses=losses, eval_losses=evals, eval_first=meta["eval_first"],
               eval_final=meta["eval_final"], gate_passed=meta["gate_passed"],
               flash_launches=launches, flash_routes=routes, adapter_params=n_params,
               checkpoint_bytes=nbytes, save_s=save_s, sha256_s=cost.hash_s,
               restore_s=restore_s, run_s=full_s, profile=prof,
               step_ms_median=step_ms(elapsed), card=smi)
    log(f"phase 25(b) finetune (finetune_lora.yaml, rank {mcfg.adapter.rank} on "
        f"{len(mcfg.adapter.target_modules)} sites, {n_params} adapter parameters, {tcfg.steps} "
        f"steps): exit 0, gate passed (eval {evals[0][1]:.6f} at 20 -> {evals[-1][1]:.6f} at "
        f"60); the export on GPT(seed)'s base gives the step-60 eval loss bit for bit; checkpoints hold the adapter alone; stopped "
        f"at 40 and resumed to 60: losses, eval losses and factors bit-equal; flash launches "
        f"{launches}, by route {routes} [{smi}]")
    log(f"phase 25(b): an adapter checkpoint {nbytes} B (save {save_s:.6f} s, sha256 "
        f"{cost.hash_s:.6f} s of it; restore onto the card {restore_s:.6f} s); step_ms median "
        f"{rec['step_ms_median']:.6f}; the CLI's run {full_s:.3f} s [{smi}]")
    return rec, tmp


# ---------------------------------------------------------------------------
# phase 9: the decode megakernel against its plain version
# ---------------------------------------------------------------------------

#: Phase 9's limits where a bf16 or int8 rounding lies on the path: at one
#: layer at most MK_ULPS_ONE ulps of each row's largest |value| and, with
#: bf16 compute over a bf16 cache, at most MK_SHARE of the outputs
#: differing at all (the kernel's and cuBLAS's sum orders flip a bf16
#: rounding only where an fp32 sum lies within its error of a rounding
#: boundary: 0.2% at t 1 and 2.1% at t 4, while a misplaced rounding point
#: flips about a third of every product: 61-63% of the outputs; an int8
#: cache is left out of the share, since one flipped step there moves a
#: whole head's scale: 8.3% at t 1); through the whole stack at most
#: MK_ULPS_ALL ulps (a flip moves the next layer's inputs and spreads
#: through its products). float32 throughout: 1e-5 of each row's largest
#: |value| (at least 1e-5), summation order only.
MK_ULPS_ONE, MK_SHARE, MK_ULPS_ALL = 2, 0.10, 16


@contextlib.contextmanager
def exact_products():
    """The plain version's dense products as float32 GEMMs of the operands
    rounded to the compute dtype (TF32 off): exact products and float32
    sums, the rounding its docstring states. cuBLAS's bf16 GEMM departs from
    float32 sums at some shapes (15-23% of one layer's outputs differ from
    this at d_model 640, 768 and 896, B 4, where the kernel's differ in
    0.3%), which phase 9's share limit would charge to the kernel; phase 9
    uses it for its cases at those widths."""
    import torch.nn.functional as F

    from dtc_tpu_torch.models import gpt

    real = gpt.Dense.forward

    def forward(self, z, lora=None, dropout=0.0, gen=None):
        cd = self.cdtype
        y = F.linear(z.to(cd).float(), self.weight.to(cd).float()).to(cd)
        y = y + self.bias.to(cd)
        return y if lora is None else gpt.apply_lora(y, z, lora, self.lora_scale, dropout, gen)

    gpt.Dense.forward = forward
    try:
        yield
    finally:
        gpt.Dense.forward = real

#: The megakernel's SASS opcodes phase 9 counts: 1-D bulk copies (its
#: weight ring), tensor-map TMA loads, and mbarrier operations.
MK_SASS_OPCODES = ("UBLKCP", "UTMALDG", "SYNCS")


def megakernel_bound(cfg, b, t, starts, cdtype, kvdtype, lora_ids=None):
    """Least time for one launch on these inputs: the bytes it must move
    (every layer's float32 parameters, the cached K/V (and int8 scales)
    below each row's frontier, the window's K/V written, the residual in
    and out, the frontiers; with adapters, the float32 factors of each
    distinct non-base slot in ``lora_ids`` and the ids) over HBM bandwidth,
    against its operations (2 per multiply-add: the dense products, q·K and
    p·V over each position's visible columns, with adapters each row's
    x·A and z·B) over the peak rate of the compute dtype."""
    from dtc_tpu_torch.models.gpt import adapter_param_count

    el = {"float32": 4, "bfloat16": 2, "int8": 1}
    n_l, dm, dff, h, d, s = (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_heads,
                             cfg.head_dim, cfg.max_seq_len)
    hd = h * d
    params = 4 * dm * dm + 2 * dm * dff + 4 * dm + dff + dm + 4 * dm
    per_pos = 2 * hd * el[kvdtype] + (2 * h * 4 if kvdtype == "int8" else 0)
    cached = sum(min(max(st, 0), s) for st in starts)
    nbytes = (n_l * (4 * params + (cached + b * t) * per_pos)
              + 2 * b * t * dm * el[cdtype] + 4 * len(starts))
    visible = sum(min(max(st, 0) + j, s) + 1 for st in starts for j in range(t))
    ops = n_l * (2 * b * t * (4 * dm * dm + 2 * dm * dff) + 4 * hd * visible)
    if lora_ids is not None:
        tenants = len({i for i in lora_ids if i != 0})
        nbytes += tenants * 4 * adapter_param_count(cfg) + 4 * len(lora_ids)
        ops += 2 * b * t * adapter_param_count(cfg)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[cdtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def megakernel_model(base_cfg, compute: str, seed: int):
    """The flagship's layer stack on the card with random weights from
    ``seed``, its biases and LayerNorm parameters random too (the model's
    own initialisation zeroes them, and a zero bias hides where it is
    added)."""
    import dataclasses

    import torch

    from dtc_tpu_torch.models.gpt import GPT

    model = GPT(dataclasses.replace(base_cfg, compute_dtype=compute,
                                    decode_attention="fused_layers"), seed=seed)
    g = torch.Generator(device=model.device).manual_seed(seed + 1)
    with torch.no_grad():
        for prm in model.parameters():
            if prm.ndim == 1:
                prm.add_(0.2 * torch.randn(prm.shape, device=prm.device, generator=g))
    return model


def megakernel_inputs(model, b, t, kvdtype, seed):
    """The residual (B, t, d_model) in the compute dtype and a decode cache
    of random contents in ``kvdtype`` (int8: payloads and positive
    scales)."""
    import torch

    from dtc_tpu_torch.models.gpt import DTYPES

    cfg = model.cfg
    dev = model.device
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (cfg.n_layers, b, cfg.max_seq_len, cfg.d_model)
    if kvdtype == "int8":
        sshape = shape[:3] + (cfg.n_heads,)
        cache = {n: torch.randint(-127, 128, shape, device=dev, generator=g).to(torch.int8)
                 for n in ("k", "v")}
        cache.update({n: 0.005 + 0.015 * torch.rand(sshape, device=dev, generator=g)
                      for n in ("k_scale", "v_scale")})
    else:
        cache = {n: (0.5 * torch.randn(shape, device=dev, generator=g)).to(getattr(torch, kvdtype))
                 for n in ("k", "v")}
    # A residual of the embeddings' scale, so attention's share of each
    # layer's output is not lost under it.
    x = 0.1 * torch.randn(b, t, cfg.d_model, device=dev, generator=g)
    return x.to(DTYPES[cfg.compute_dtype]), cache


def megakernel_compare(got, want, compute, kvdtype, depth_one: bool):
    """(max |error| over its limit, share of outputs that differ, within
    the limit?) of ``got`` against ``want`` under phase 9's limits."""
    import torch

    g, w = got.float(), want.float()
    diff = (g - w).abs()
    rowmax = w.abs().amax(dim=-1, keepdim=True)
    if compute == "float32" and kvdtype == "float32":
        limit = 1e-5 * rowmax.clamp_min(1.0)
    else:
        _, e = torch.frexp(rowmax)
        limit = (MK_ULPS_ONE if depth_one else MK_ULPS_ALL) * torch.exp2((e - 8).float())
    ratio = (diff / limit).max().item()
    share = (g != w).float().mean().item()
    by_share = depth_one and compute == kvdtype == "bfloat16"
    ok = ratio <= 1.0 and not (by_share and share > MK_SHARE)
    return ratio, share, ok


def lora_stack(model, tenants):
    """A resident stack (``init_lora_stack``) with slot 0 the base and the
    tenants in slots 1, 2, ..."""
    from dtc_tpu_torch.adapters import init_lora_stack

    stack = init_lora_stack(model, len(tenants) + 1)
    for slot, fac in enumerate(tenants, start=1):
        for k, v in stack.items():
            v[slot].copy_(fac[k])
    return stack


def megakernel_case(name, model, b, t, kvdtype, starts, seed, lora=None, ids=None,
                    exact=False):
    """The megakernel against its plain version on the same inputs, over
    one layer and over the whole stack; at one layer, the plain version
    with each planted fault must land over the limit. With ``lora`` (a
    stack) and ``ids`` (per-row slots) the LoRA sites are on, and the
    faults are the LoRA sites' own. ``exact``: the plain version's products
    by :func:`exact_products` (the faults' too)."""
    import torch
    import torch.nn.functional as F

    from dtc_tpu_torch.models import gpt
    from dtc_tpu_torch.ops import decode_fused

    compute = model.cfg.compute_dtype
    dev = model.device
    x, cache = megakernel_inputs(model, b, t, kvdtype, seed)
    idx = torch.tensor(starts, dtype=torch.int32, device=dev)
    lids = None if ids is None else torch.tensor(ids, dtype=torch.int32, device=dev)

    def run(fn, depth, frontier=idx, slots=lids):
        c = {k: v[:depth].clone() for k, v in cache.items()}
        plain = fn is decode_fused.fused_layers_reference and gpt.Dense.forward is real_dense
        with exact_products() if exact and plain else contextlib.nullcontext():
            out = fn(x, model.stage.blocks[:depth], c, frontier, lora, slots)
        torch.cuda.synchronize()
        return out, c

    real_dense = gpt.Dense.forward

    real_lora = gpt.apply_lora

    @contextlib.contextmanager
    def patched_lora(fn):
        gpt.apply_lora = fn
        try:
            yield
        finally:
            gpt.apply_lora = real_lora

    def delta_unrounded(y, z, factors, scale, *_):
        # z = x A rounded as before; z B, scaled and added to y in float32,
        # rounded once with the sum.
        a, bb = factors[0].to(y.dtype), factors[1].to(y.dtype)
        if a.ndim == 2:
            delta = F.linear(F.linear(z.to(y.dtype), a).float(), bb.float())
        else:
            zz = torch.einsum("bti,bri->btr", z.to(y.dtype), a)
            delta = torch.einsum("btr,bor->bto", zz.float(), bb.float())
        return (y.float() + delta * scale).to(y.dtype)

    @contextlib.contextmanager
    def bias_before_rounding():
        real = gpt.Dense.forward
        if exact:
            gpt.Dense.forward = lambda self, z, *_: F.linear(
                z.to(self.cdtype).float(), self.weight.to(self.cdtype).float(),
                self.bias.to(self.cdtype).float()).to(self.cdtype)
        else:
            gpt.Dense.forward = lambda self, z, *_: F.linear(
                z.to(self.cdtype), self.weight.to(self.cdtype), self.bias.to(self.cdtype))
        try:
            yield
        finally:
            gpt.Dense.forward = real

    rec = dict(case=name, b=b, t=t, compute=compute, kv=kvdtype, starts=starts,
               lora_slots=ids, lora_scale=None if lora is None else model.cfg.adapter.scale)
    for depth, tag in ((1, "one_layer"), (model.cfg.n_layers, "all_layers")):
        got, c_got = run(decode_fused.fused_layers, depth)
        want, c_want = run(decode_fused.fused_layers_reference, depth)
        check(got.shape == x.shape and got.dtype == x.dtype, f"megakernel {name}: bad output")
        check(bool(torch.isfinite(got.float()).all()), f"megakernel {name}: non-finite output")
        ratio, share, ok = megakernel_compare(got, want, compute, kvdtype, depth == 1)
        err = (got.float() - want.float()).abs().max().item()
        kv_err = max((c_got[n].float() - c_want[n].float()).abs().max().item() for n in c_got)
        rec[tag] = dict(max_abs_err=err, err_over_limit=ratio, share_differing=share,
                        cache_max_abs_err=kv_err)
        log(f"megakernel {name} {tag}: max_abs_err {err:.3e}, {ratio:.3f} of its limit, "
            f"{share:.4f} of outputs differ, cache max_abs_err {kv_err:.3e}")
        check(ok, f"megakernel {name} {tag}: over its limit")
    ref = decode_fused.fused_layers_reference
    if lora is None:
        faults = {"cache mask one column short": lambda: run(ref, 1, (idx - 1).clamp_min(0))[0]}
        if compute == kvdtype == "bfloat16":
            def bias_fault():
                with bias_before_rounding():
                    return run(ref, 1)[0]
            faults["bias added before rounding"] = bias_fault
    else:
        faults = {"rows' slot ids permuted": lambda: run(ref, 1, slots=lids.roll(1))[0]}
        if compute == kvdtype == "bfloat16":
            def unrounded_delta():
                with patched_lora(delta_unrounded):
                    return run(ref, 1)[0]
            faults["delta added before it is rounded"] = unrounded_delta
            exact_scale = model.cfg.adapter.scale
            if gpt.lora_scale(model.cfg) != exact_scale:
                def unrounded_scale():
                    with patched_lora(lambda y, z, f, _s, *_: real_lora(y, z, f, exact_scale)):
                        return run(ref, 1)[0]
                faults["scale left unrounded"] = unrounded_scale
    want, _ = run(decode_fused.fused_layers_reference, 1)
    rec["faults"] = {}
    for fname, fn in faults.items():
        ratio, share, ok = megakernel_compare(fn(), want, compute, kvdtype, True)
        rec["faults"][fname] = dict(err_over_limit=ratio, share_differing=share)
        log(f"megakernel {name}: planted fault '{fname}': {ratio:.3f} of the limit, "
            f"{share:.4f} of outputs differ")
        check(not ok, f"megakernel {name}: the limit misses the fault '{fname}'")
    rec["max_abs_err"] = max(rec["one_layer"]["max_abs_err"], rec["all_layers"]["max_abs_err"])
    return rec


def megakernel_times(model, b, t, kvdtype, starts, seed, iters, lora=None, ids=None):
    """Device times (CUDA graph replay) of the megakernel, its plain version
    and the per-layer yardstick (the ``fused`` decode path over the same
    blocks: per layer the dense products, the cache write and the
    single-query decode kernel) at these inputs, plus the bound. With
    ``lora`` (a stack) and ``ids`` all of them run the LoRA sites, and
    ``base_ms`` is the kernel without adapters on the same inputs."""
    import torch

    from dtc_tpu_torch.ops import decode_fused

    x, cache = megakernel_inputs(model, b, t, kvdtype, seed)
    dev = model.device
    idx = torch.tensor(starts, dtype=torch.int32, device=dev)
    lids = None if ids is None else torch.tensor(ids, dtype=torch.int32, device=dev)
    blocks = model.stage.blocks
    out = dict(
        ms=graph_ms(lambda: decode_fused.fused_layers(x, blocks, cache, idx, lora, lids), iters),
        wrapper_ms=cuda_ms(lambda: decode_fused.fused_layers(x, blocks, cache, idx, lora, lids),
                           iters),
        plain_ms=graph_ms(lambda: decode_fused.fused_layers_reference(
            x, blocks, cache, idx, lora, lids), iters),
    )
    if lora is not None:
        out["base_ms"] = graph_ms(lambda: decode_fused.fused_layers(x, blocks, cache, idx), iters)
    if t == 1:
        @torch.no_grad()
        def stage():
            # No autograd: the cache's in-place writes would chain each
            # call's graph to the last (4 GB of weight copies a call at the
            # 1b ladder).
            return model.stage(x, cache=cache, idx=idx, lora=lora, lora_ids=lids)
        out["per_layer_ms"] = graph_ms(stage, iters)
        out["per_layer_wrapper_ms"] = cuda_ms(stage, iters)
    out["bound_ms"], out["bound_by"], out["bytes"] = megakernel_bound(
        model.cfg, b, t, starts, model.cfg.compute_dtype, kvdtype, ids)
    return out


# ---------------------------------------------------------------------------
# phase 12: multi-tenant adapter serving
# ---------------------------------------------------------------------------

#: Phase 4's requests r0..r5 by tenant: r1 and r2 share a prompt prefix
#: under two tenants, r0 and r5 are base requests.
ADAPTER_SPREAD = (None, "t1", "t2", "t3", "t1", None)


def adapter_requests(vocab: int, seed: int, max_new: int, spread=ADAPTER_SPREAD):
    import dataclasses

    return [dataclasses.replace(r, adapter=a)
            for r, a in zip(flagship_requests(vocab, seed, max_new), spread)]


def serve_adapters(scfg, mcfg_ad, seed: int, max_new: int, tokens_fl, fl_rec, smi,
                   device: str = "cuda", tenants=None, spread=ADAPTER_SPREAD,
                   must_move=None, tag: str = "adapters"):
    """Phase 12: three tenants on the flagship under ``fused_layers`` and
    ``fused`` in bf16 (launch counts, ms/token; under ``fused_layers`` each
    request equals its solo run, and the base requests equal phase 10's
    tokens), then float32 under both: each request equals ``generate()``
    with its tenant's factors. ``tokens_fl`` / ``fl_rec``: phase 10's
    tokens and record. ``tenants`` ({name: factors}; three random ones by
    default) and ``spread`` (each request's tenant) as phase 25(c) serves
    them; ``must_move``: tenants that must move at least one of their
    requests' tokens off the base's (any tenant when None)."""
    import dataclasses

    import torch

    from dtc_tpu_torch.generate import generate
    from dtc_tpu_torch.serve import ServingEngine
    from dtc_tpu_torch.serve.fleet import random_factors

    if tenants is None:
        tenants = dict(zip(("t1", "t2", "t3"),
                           random_factors(mcfg_ad, torch.device(device), seed + 1200, 3)))
    out = {}
    for backend in ("fused_layers", "fused"):
        mcfg_b = dataclasses.replace(mcfg_ad, decode_attention=backend)
        reqs = adapter_requests(mcfg_ad.vocab_size, seed, max_new, spread)
        model, eng, res, wall, launched = serve(scfg, mcfg_b, seed, reqs, device, tenants)
        steps = eng.counters["serve_decode_steps"]
        for r in reqs:
            rr = res[r.rid]
            check(rr.state.value == "done" and len(rr.tokens) == max_new,
                  f"{tag} {backend} {r.rid}: {rr.state.value}, {len(rr.tokens)} tokens "
                  f"({rr.error})")
        check(eng.counters["serve_prefix_builds"] == 2 and eng.counters["serve_prefix_hits"] == 0,
              f"{tag} {backend}: the prefix store is not scoped per adapter: "
              f"{dict(eng.counters)}")
        if backend == "fused_layers":
            ok_launch = launched["fused_layers"] == steps and launched["decode_attention"] == 0
        else:
            ok_launch = (launched["decode_attention"] == mcfg_ad.n_layers * steps
                         and launched["fused_layers"] == 0)
        check(ok_launch and steps > 0,
              f"{tag} {backend}: {launched} launches for {steps} decode iterations")
        tokens = {r.rid: list(res[r.rid].tokens) for r in reqs}
        n_tok = sum(len(t) for t in tokens.values())
        ttft = [res[r.rid].ttft_s for r in reqs]
        mspt = [res[r.rid].ms_per_token for r in reqs]
        rec = dict(
            requests=len(reqs), adapters=list(spread), tokens=n_tok,
            decode_iterations=steps, megakernel_launches=launched["fused_layers"],
            decode_attention_launches=launched["decode_attention"], wall_s=wall,
            ttft_p50_s=percentile(ttft, 0.5), ms_per_token_mean=sum(mspt) / len(mspt),
            tokens_per_s=n_tok / wall, counters=dict(eng.counters), card=smi,
            watchdog_flags=watchdog_report(eng, f"serve {tag} {backend}"),
        )
        log(f"serve {tag} {backend}: 6/6 done ({', '.join(str(a) for a in spread)}), "
            f"{n_tok} tokens, {steps} decode iterations, launches {launched}; ms/token "
            f"{rec['ms_per_token_mean']:.6f}, tokens/s {rec['tokens_per_s']:.3f}, ttft_p50 "
            f"{rec['ttft_p50_s']:.6f} s (phase 10 without adapters: ms/token "
            f"{fl_rec['ms_per_token_mean']:.6f}, tokens/s {fl_rec['tokens_per_s']:.3f}) [{smi}]")
        if backend == "fused_layers":
            base_same = [tokens[r.rid] == tokens_fl[r.rid] for r in reqs if r.adapter is None]
            moved = [tokens[r.rid] != tokens_fl[r.rid] for r in reqs if r.adapter is not None]
            moved_by = {name: sum(tokens[r.rid] != tokens_fl[r.rid] for r in reqs
                                  if r.adapter == name) for name in tenants}
            solo_same = 0
            for r in reqs:
                solo = ServingEngine(model, scfg)
                for name, fac in tenants.items():
                    solo.load_adapter(name, fac)
                solo.submit(r)
                solo_same += solo.run(max_steps=10_000)[r.rid].tokens == tokens[r.rid]
            rec.update(solo_identical=solo_same, base_equal_phase10=sum(base_same),
                       tenants_moved=sum(moved), moved_by_tenant=moved_by)
            log(f"serve {tag} fused_layers bf16: {solo_same}/{len(reqs)} requests equal "
                f"their solo runs; base requests equal phase 10's tokens: {sum(base_same)}/"
                f"{len(base_same)}; tenant requests whose tokens the adapter moved: "
                f"{sum(moved)}/{len(moved)} (by tenant {moved_by})")
            check(solo_same == len(reqs),
                  f"{tag}: {solo_same}/{len(reqs)} equal their solo runs")
            check(all(base_same), f"{tag}: a base request differs from phase 10")
            check(any(moved) if must_move is None else all(moved_by[t] for t in must_move),
                  f"{tag}: no request's tokens moved off the base's ({moved_by})")
        del model, eng
        torch.cuda.empty_cache()

        mcfg32 = dataclasses.replace(mcfg_b, compute_dtype="float32")
        reqs32 = adapter_requests(mcfg_ad.vocab_size, seed, max_new, spread)
        model, eng, res, _, launched32 = serve(scfg, mcfg32, seed, reqs32, device, tenants)
        same = 0
        for r in reqs32:
            ref = generate(model, [list(r.prompt)], max_new, lora=tenants.get(r.adapter))
            same += res[r.rid].state.value == "done" and res[r.rid].tokens == ref[0].tolist()
        rec["fp32_matching_generate"] = same
        rec["fp32_launches"] = launched32
        log(f"serve {tag} {backend} fp32: {same}/{len(reqs32)} requests equal generate() "
            f"with their tenant's factors; launches {launched32}")
        check(same == len(reqs32), f"{tag} {backend} fp32: {same}/{len(reqs32)} match generate")
        out[backend] = rec
        del model, eng
        torch.cuda.empty_cache()
    return out


#: Phase 25(c)'s requests by tenant: the trained adapter ("ft") on three,
#: a second tenant with random factors on one (r2, sharing r1's prefix),
#: base on two.
TRAINED_SPREAD = (None, "ft", "t2", "ft", "ft", None)


def serve_trained_adapter(npz: Path, scfg, seed: int, max_new: int, tokens_fl, fl_rec, smi,
                          device: str = "cuda") -> dict:
    """25(c): the exported adapter read back by the port's
    ``load_adapter_file`` and served on its base (``finetune_lora.yaml``'s
    model and seed) beside base requests and a second tenant, through phase
    12's checks (:func:`serve_adapters`) under ``fused_layers`` and
    ``fused``: float32 tokens equal ``generate(lora=trained)``; bf16
    ``fused_layers`` tokens equal each request's solo run, base requests
    phase 10's; at least one trained-adapter request's tokens differ from
    the base's; a megakernel launch per decode iteration. ``tokens_fl`` /
    ``fl_rec``: phase 10's (served from ``seed``)."""
    import dataclasses

    import torch

    from dtc_tpu_torch.adapters.lora import load_adapter_file
    from dtc_tpu_torch.config.loader import load_finetune_config
    from dtc_tpu_torch.serve.fleet import random_factors

    tcfg, mcfg, _ = load_finetune_config(ROOT / "configs" / "finetune_lora.yaml")
    trained, meta = load_adapter_file(str(npz))
    check(meta["gate_passed"] and meta["rank"] == mcfg.adapter.rank,
          f"phase 25(c): the export's meta {meta}")
    dev = torch.device(device)
    tenants = {"ft": {k: v.to(dev) for k, v in trained.items()},
               "t2": random_factors(mcfg, dev, seed + 1250, 1)[0]}
    if seed != tcfg.seed:
        # phase 10 served another base: the base requests' tokens anew
        mcfg_fl = dataclasses.replace(mcfg, decode_attention="fused_layers")
        reqs = flagship_requests(mcfg.vocab_size, tcfg.seed, max_new)
        _, _, res, _, _ = serve(scfg, mcfg_fl, tcfg.seed, reqs, device)
        tokens_fl = {r.rid: list(res[r.rid].tokens) for r in reqs}
    return serve_adapters(scfg, mcfg, tcfg.seed, max_new, tokens_fl, fl_rec, smi, device,
                          tenants=tenants, spread=TRAINED_SPREAD, must_move=("ft",),
                          tag="phase 25(c) trained adapter")


# ---------------------------------------------------------------------------
# phase 26: the telemetry subsystem (obs/) in the trainer
# ---------------------------------------------------------------------------

FLASH_KERNELS = {"flash_fwd_tc_kernel": ("fwd", "tc"), "flash_dq_tc_kernel": ("bwd", "tc"),
                 "flash_dkv_tc_kernel": ("bwd", "tc"), "flash_fwd_kernel": ("fwd", "fma"),
                 "flash_bwd_dq_kernel": ("bwd", "fma"), "flash_bwd_dkv_kernel": ("bwd", "fma")}


def flash_kernel(name: str):
    """``(phase, route)`` of a flash kernel's trace name, None for any other
    kernel (the ring's block kernels included)."""
    m = re.search(r"\b(flash_[a-z_]+_kernel)\b", name)
    return FLASH_KERNELS.get(m.group(1)) if m else None


def step_events(obs_dir: Path) -> list[dict]:
    from dtc_tpu_torch.obs import read_jsonl, shard_path

    return read_jsonl(shard_path(str(obs_dir), 0))


def check_event_stream(what: str, events: list[dict], steps: int) -> dict:
    """The shard of a fresh ``steps``-step run: ``run_start`` then one
    ``compile`` at step 0, one ``step`` event per timed step whose parts
    sum to its ``step_time_s`` within 1e-9, a ``window`` at each log
    boundary, ``memory`` samples and one ``run_summary``. Returns the
    medians of the step clock's split (seconds)."""
    kinds = [e["etype"] for e in events]
    check(kinds[0] == "run_start", f"{what}: the shard starts with {kinds[:3]}")
    compiles = [e for e in events if e["etype"] == "compile"]
    check(len(compiles) == 1 and compiles[0]["step"] == 0,
          f"{what}: compile events {compiles}")
    steps_ev = [e for e in events if e["etype"] == "step"]
    check([e["step"] for e in steps_ev] == list(range(1, steps + 1)),
          f"{what}: step events {[e['step'] for e in steps_ev]}")
    worst = max(abs(e["data_wait_s"] + e["dispatch_s"] + e["block_s"] + e["other_s"]
                    - e["step_time_s"]) for e in steps_ev)
    check(worst <= 1e-9, f"{what}: a step's parts miss its step_time_s by {worst}")
    check(kinds.count("window") >= 1 and kinds.count("memory") >= 1
          and kinds.count("run_summary") == 1,
          f"{what}: windows {kinds.count('window')}, memory {kinds.count('memory')}, "
          f"run_summary {kinds.count('run_summary')}")
    split = {k: percentile([e[k] for e in steps_ev], 0.5)
             for k in ("data_wait_s", "dispatch_s", "block_s", "other_s", "step_time_s")}
    split["compile_time_s"] = compiles[0]["compile_time_s"]
    split["compile_count"] = compiles[0]["count"]
    return split


def telemetry_run(out_dir: str, obs: bool, steps: int, devprof_every: int = 0,
                  device: str = "cuda"):
    """``train()`` on ``train_config_dp.yaml`` as written (synthetic data),
    ``steps`` timed steps, telemetry on or off, a devprof window of 2 steps
    every ``devprof_every``. Returns (result, flash launches (fwd, bwd),
    flash routes, max memory allocated after the run)."""
    import dataclasses

    import torch

    from dtc_tpu_torch.config.loader import load_config
    from dtc_tpu_torch.ops import flash_attention as fa
    from dtc_tpu_torch.train.trainer import train

    tcfg, mcfg, ocfg = load_config(ROOT / "configs" / "train_config_dp.yaml")
    tcfg = dataclasses.replace(
        tcfg, dataset="synthetic", steps=steps, output_dir=out_dir,
        obs=dataclasses.replace(tcfg.obs, enabled=obs, devprof_every=devprof_every))
    cuda = device.startswith("cuda")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    zero_flash_counts()                          # the main path starts here
    res = train(tcfg, mcfg, ocfg, device=None if cuda else device)
    launches = (fa.fwd_launches, fa.bwd_launches)  # ...and ends here
    routes = check_flash_routes(f"phase 26 obs {'on' if obs else 'off'}", mcfg.compute_dtype)
    peak = torch.cuda.max_memory_allocated() if cuda else None
    return res, launches, routes, peak


def telemetry_phase(smi: str, phase7: dict, steps: int = 40, device: str = "cuda") -> dict:
    """26: (a) ``python -m dtc_tpu_torch.main --train_config_path
    configs/train_config_dp.yaml --dataset synthetic --steps 40
    --output_dir <tmp>`` as a subprocess, telemetry on as the config says:
    exit 0, the shard's stream (:func:`check_event_stream`), ``summary.json``
    and ``log.csv``'s 40 rows. (b) In this process 40 steps with telemetry
    on and a devprof window at steps 30-31, then 40 with it off: losses
    equal bit for bit; then on and off again, every run's step median
    recorded. (c) The capture read by ``analyze_capture``: every flash
    kernel attributed to ``attn_kernel``, 12 forward ("fwd") and 24
    backward ("bwd") launches a step, all "tc"; every matrix product
    attributed; the unattributed share at most 0.10; the kernels' summed
    time within 1% of ``key_averages()``'s device total over the window;
    the device-time MFU and component table. (d) The last memory sample's
    peak equals ``torch.cuda.max_memory_allocated()`` after the run. (e)
    The step clock's split of the flagship step."""
    import json as _json
    import os
    import tempfile

    from dtc_tpu_torch.config.loader import load_config
    from dtc_tpu_torch.obs import analyze_capture, find_captures
    from dtc_tpu_torch.obs.devprof import classify_scope, structural_gates

    tcfg, mcfg, _ = load_config(ROOT / "configs" / "train_config_dp.yaml")
    cuda = device.startswith("cuda")
    rec: dict = {"card": smi}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dtc_chip_smoke_obs_") as tmp:
        tmp = Path(tmp)
        # (a) the committed config as written, through the command line
        cmd = [sys.executable, "-m", "dtc_tpu_torch.main", "--train_config_path",
               str(ROOT / "configs" / "train_config_dp.yaml"), "--dataset", "synthetic",
               "--steps", str(steps), "--output_dir", str(tmp / "cli")]
        if not cuda:
            cmd += ["--device", device]
        out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                             env=dict(os.environ, PYTHONPATH=str(ROOT)))
        check(out.returncode == 0, f"phase 26(a): exit {out.returncode}:\n{out.stdout[-3000:]}"
              f"\n{out.stderr[-3000:]}")
        cli_split = check_event_stream("phase 26(a)", step_events(tmp / "cli" / "obs"), steps)
        summary = _json.loads((tmp / "cli" / "obs" / "summary.json").read_text())
        rows = (tmp / "cli" / "log.csv").read_text().splitlines()
        check(rows[0] == "step,elapsed_time,loss" and len(rows) == steps + 1,
              f"phase 26(a): log.csv {rows[:2]}, {len(rows) - 1} rows")
        check(summary["summary"]["steps"] == steps and summary["hosts"]["n_hosts"] == 1,
              f"phase 26(a): summary.json {summary['summary'].get('steps')}, "
              f"{summary['hosts']}")
        rec["cli"] = dict(split=cli_split, wall_s=time.perf_counter() - t0,
                          tokens_per_sec=summary["summary"]["tokens_per_sec"])
        log(f"phase 26(a) python -m dtc_tpu_torch.main --train_config_path "
            f"configs/train_config_dp.yaml --dataset synthetic --steps {steps}: exit 0, "
            f"{steps} step events whose parts sum to step_time_s, summary.json, log.csv "
            f"{steps} rows; compile event {cli_split['compile_time_s']} s over "
            f"{cli_split['compile_count']} library loads [{smi}]")

        # (b) obs on (a devprof window at steps 30-31) against obs off, bit for bit
        on, on_launch, on_routes, peak_after = telemetry_run(
            str(tmp / "on"), True, steps, devprof_every=30, device=device)
        off, off_launch, _, _ = telemetry_run(str(tmp / "off"), False, steps, device=device)
        check(on.losses == off.losses and len(on.losses) == steps,
              f"phase 26(b): losses with obs on {on.losses[:4]}... differ from off "
              f"{off.losses[:4]}...")
        check(on_launch == off_launch, f"phase 26(b): flash launches on {on_launch}, off "
              f"{off_launch}")
        n_steps = steps + tcfg.warmup_steps
        check(not cuda or on_launch == (mcfg.n_layers * n_steps, 2 * mcfg.n_layers * n_steps),
              f"phase 26(b): flash launches {on_launch} for {n_steps} steps")
        rec["launches"] = on_launch
        rec["routes"] = on_routes
        events = step_events(tmp / "on" / "obs")
        split = check_event_stream("phase 26(b)", events, steps)

        # (c) the capture
        caps = find_captures(str(tmp / "on" / "obs" / "devprof"))
        check(len(caps) == 1, f"phase 26(c): captures {caps}")
        cap = analyze_capture(caps[0])
        check(cap is not None, f"phase 26(c): no trace in {caps[0]}")
        att, meta = cap["attribution"], cap["meta"]
        win = meta["steps"]
        check(win == 2 and meta["step_start"] == 30, f"phase 26(c): window {meta}")
        flash_rows = [(r, flash_kernel(r.name)) for r in cap["rows"]]
        flash_rows = [(r, k) for r, k in flash_rows if k is not None]
        by = {"fwd": 0, "bwd": 0}
        for r, (part, route) in flash_rows:
            comp, phase = classify_scope(r.scope)
            check(route == "tc" and comp == "attn_kernel" and phase == part,
                  f"phase 26(c): {r.name[:60]} ({route}) attributed to {comp!r} / "
                  f"{phase!r}, scope {r.scope!r}")
            by[part] += 1
        check(not cuda or by == {"fwd": mcfg.n_layers * win, "bwd": 2 * mcfg.n_layers * win},
              f"phase 26(c): flash kernels in the window {by}, want "
              f"{mcfg.n_layers} fwd and {2 * mcfg.n_layers} bwd a step over {win} steps")
        gates = structural_gates(att)
        check(gates["all_dot_fusions_attributed"] and gates["unattributed_share_ok"],
              f"phase 26(c): structural gates {gates}")
        prof_s = meta["profiler_device_s"]
        if cuda:
            check(prof_s and abs(att.total_s - prof_s) <= 0.01 * prof_s,
                  f"phase 26(c): the capture's kernels {att.total_s} s, key_averages() "
                  f"{prof_s} s")
        table = att.component_table(win)
        dmfu = att.device_mfu(meta["step_flops"], meta["peak_flops"], win)
        rec["capture"] = dict(
            window_steps=win, flash_kernels=by, gates=gates, device_s=att.total_s,
            profiler_device_s=prof_s, busy_s_per_step=att.busy_s / win,
            device_mfu=dmfu, components=table,
            phases={k: v / win for k, v in att.phases.items()},
            n_kernels=att.n_ops, peak_hbm_bytes=meta["peak_hbm_bytes"],
            costs_s={k: meta[k] for k in ("start_s", "stop_and_write_s",
                                          "profiler_device_read_s")})
        log(f"phase 26(c) devprof capture of steps 30-31: {att.n_ops} device rows, "
            f"{by['fwd']} forward + {by['bwd']} backward flash kernels all 'tc' in "
            f"attn_kernel (fwd / bwd), unattributed share {gates['unattributed_share']}, "
            f"kernels {att.total_s:.6f} s vs key_averages() {prof_s} s, busy "
            f"{att.busy_s / win * 1e3:.6f} ms a step, device-time MFU {dmfu}; the "
            f"window's costs: start {meta['start_s']} s, stop and trace write "
            f"{meta['stop_and_write_s']} s, key_averages() {meta['profiler_device_read_s']} s "
            f"[{smi}]")
        for row in table:
            log(f"  component {row['component']}: {row['s_per_step'] * 1e3:.6f} ms a step, "
                f"share {row['share']}")
        log(f"  phases (ms a step): "
            f"{ {k: round(v / win * 1e3, 6) for k, v in att.phases.items()} }")

        # (d) memory
        mem = [e for e in events if e["etype"] == "memory"]
        last = mem[-1]["devices"]
        if cuda:
            got = last[0]["stats"]["peak_bytes_in_use"]
            check(got == peak_after, f"phase 26(d): last memory sample's peak {got} != "
                  f"max_memory_allocated() {peak_after}")
        else:
            check(last is None, f"phase 26(d): memory stats {last} on the CPU")
        rec["memory"] = dict(peak_bytes=peak_after, samples=len(mem))

        # (e) costs: obs on vs off, alternated; the step clock's split
        def med(res):
            el = [0.0] + res.elapsed_times
            return percentile([b - a for a, b in zip(el, el[1:])], 0.5) * 1e3

        on2, _, _, _ = telemetry_run(str(tmp / "on2"), True, steps, device=device)
        off2, _, _, _ = telemetry_run(str(tmp / "off2"), False, steps, device=device)
        check(on2.losses == off2.losses == on.losses,
              "phase 26(e): the second pair's losses differ")
        medians = {"on_devprof": med(on), "off": med(off), "on": med(on2), "off_2": med(off2)}
        rec["step_ms_median"] = medians
        rec["split_s"] = split
        rec["wall_s"] = time.perf_counter() - t0
    log(f"phase 26(e) step median (ms) obs on {medians['on_devprof']:.6f} (with the window) / "
        f"{medians['on']:.6f}, off {medians['off']:.6f} / {medians['off_2']:.6f} "
        f"(phase 7: {phase7['step_ms_median']:.6f}) [{smi}]")
    log(f"phase 26(e) step clock split (median s): data_wait {split['data_wait_s']:.6f}, "
        f"dispatch {split['dispatch_s']:.6f}, block {split['block_s']:.6f}, other "
        f"{split['other_s']:.6f}, step {split['step_time_s']:.6f}; startup compile "
        f"{split['compile_time_s']} s [{smi}]")
    log(f"phase 26 wall {rec['wall_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phase 27: the chaos harness and the recovery bus
# ---------------------------------------------------------------------------

def chaos_train_phase(smi: str, device: str = "cuda") -> dict:
    """27(a): ``configs/train_config_dev_chaos.yaml`` as written on the
    flagship (the sibling ``model_config.yaml``, bf16) through ``train()``,
    only its output and checkpoint directories moved to a temporary one.
    Gates: 40 steps with a finite last loss and 40 ``log.csv`` rows; the
    ``chaos`` events ``nan_loss`` at 25 and ``ckpt_corrupt`` at 30, one
    anomaly and one rollback to step 20; step 30 fails its manifest after
    the run; a flight dump with the anomaly's reason; every flash launch
    "tc", 12 forward and 24 backward a step run (warmup and replay
    included). Reports the run's wall time and the rollback's cost: the
    replayed steps, the detection-to-restore seconds and the replayed
    steps' seconds. ``device``: ``cpu`` rehearses the phase (no launch or
    timing gate is a card's there)."""
    import dataclasses
    import io
    import tempfile

    from dtc_tpu_torch.config.loader import load_config
    from dtc_tpu_torch.obs import read_jsonl, shard_path
    from dtc_tpu_torch.obs.trace import FlightRecorder
    from dtc_tpu_torch.ops import flash_attention as fa
    from dtc_tpu_torch.train.trainer import train
    from dtc_tpu_torch.utils.checkpoint import CheckpointManager

    tcfg, mcfg, ocfg = load_config(ROOT / "configs" / "train_config_dev_chaos.yaml")
    cuda = device.startswith("cuda")
    reasons: list[str] = []
    real_dump = FlightRecorder.dump

    def dump(self, path, *, reason, **meta):
        reasons.append(reason)
        return real_dump(self, path, reason=reason, **meta)

    with tempfile.TemporaryDirectory(prefix="dtc_chip_smoke_chaos_") as tmp:
        out = Path(tmp) / "dev_chaos"
        cfg = dataclasses.replace(tcfg, output_dir=str(out),
                                  checkpoint_dir=str(out / "checkpoints"))
        text = io.StringIO()
        FlightRecorder.dump = dump
        try:
            zero_flash_counts()                            # the main path starts here
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(text):
                res = train(cfg, mcfg, ocfg, device=None if cuda else device)
            wall = time.perf_counter() - t0
            launches = (fa.fwd_launches, fa.bwd_launches)  # ...and ends here
        finally:
            FlightRecorder.dump = real_dump
        routes = check_flash_routes("phase 27(a)", mcfg.compute_dtype)
        events = read_jsonl(shard_path(str(out / "obs"), 0))
        rows = (out / "log.csv").read_text().splitlines()
        check(len(res.losses) == cfg.steps == 40 and math.isfinite(res.losses[-1])
              and len(rows) == cfg.steps + 1,
              f"phase 27(a): {len(res.losses)} losses (last {res.losses[-1:]}), log.csv "
              f"{len(rows) - 1} rows")
        chaos = sorted((e["kind"], e["step"]) for e in events if e["etype"] == "chaos")
        rollbacks = [e for e in events if e["etype"] == "recovery" and e["action"] == "rollback"]
        anomalies = [e for e in events if e["etype"] == "anomaly"]
        check(chaos == [("ckpt_corrupt", 30), ("nan_loss", 25)] and len(anomalies) == 1
              and [e["to_step"] for e in rollbacks] == [20],
              f"phase 27(a): chaos {chaos}, anomalies {anomalies}, rollbacks {rollbacks}\n"
              f"{text.getvalue()}")
        check(not CheckpointManager(cfg.checkpoint_dir).verify_step(30),
              "phase 27(a): the corrupted step 30 passed its manifest")
        check(f"anomaly: {anomalies[0]['reason']}" in reasons,
              f"phase 27(a): flight dumps {reasons}")
        step_events = [e for e in events if e["etype"] == "step"]
        n_run = cfg.warmup_steps + len(step_events)
        check(not cuda or launches == (mcfg.n_layers * n_run,
                                       mcfg.n_layers * n_run * fa.BWD_KERNELS),
              f"phase 27(a): flash launches {launches} for {n_run} steps run")
        rb = rollbacks[0]
        replay = [e for e in events[events.index(rb):]
                  if e["etype"] == "step" and e["step"] <= rb["step"]]
        restore_s = rb["t_restored"] - rb["t_detect"]
        replay_s = sum(e["step_time_s"] for e in replay)
    rec = dict(wall_s=wall, losses=res.losses, chaos=chaos, to_step=rb["to_step"],
               detected_at=rb["step"], replayed_steps=len(replay), restore_s=restore_s,
               replay_s=replay_s, steps_run=n_run, flash_launches=launches, flash_routes=routes,
               flight_dumps=reasons,
               hung_steps=sum(e["etype"] == "hung_step" for e in events), card=smi)
    log(f"phase 27(a) train_config_dev_chaos.yaml on the flagship (bf16): 40 steps in "
        f"{wall:.3f} s wall, loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f}; chaos {chaos}; "
        f"the anomaly at step {rb['step']} rolled back to {rb['to_step']}: "
        f"{len(replay)} steps replayed ({replay_s:.6f} s) after a {restore_s:.6f} s restore; "
        f"step 30 fails its manifest; flight dumps {reasons}; flash launches fwd "
        f"{launches[0]} / bwd {launches[1]} for {n_run} steps run, by route {routes} [{smi}]")
    return rec


#: Phase 27(b)'s faults, at scheduler iterations.
SERVE_FAULTS = dict(enabled=True, serve_preempt_at_step=4, serve_corrupt_page_at_step=6,
                    serve_poison_logits_at_step=8, serve_stall_at_step=10, stall_s=0.5)


def chaos_serve_phase(scfg, seed: int, max_new: int, tokens_fused: dict, tokens_fl: dict,
                      fl_rec: dict, smi: str, device: str = "cuda") -> dict:
    """27(b): phase 4's six requests under ``fused`` and ``fused_layers``,
    bf16 and float32, with ``Telemetry.for_serving`` into a temporary
    directory, ``verify_pages_every: 1`` and :data:`SERVE_FAULTS`: tokens
    (bf16: phases 4 and 10 in this process; float32: ``generate()``), the
    counters, one ``serve_request`` a rid in the shard, the decode kernel
    12 times and the megakernel once a decode attempt; then an impossible
    TTFT objective degrading the next admission, ``shutdown("evict")``, and
    ms per token with the telemetry on and off, alternated. Tokens: in
    float32 every request's; in bf16 those of the requests never evicted,
    and of an evicted one those before its first eviction (its re-prefill
    rounds K/V as the prefill path does, not as the decode steps did)."""
    import dataclasses
    import io
    import tempfile

    import torch

    from dtc_tpu_torch.config.loader import load_serve_config
    from dtc_tpu_torch.config.schema import ChaosConfig, SloConfig
    from dtc_tpu_torch.generate import generate
    from dtc_tpu_torch.models.gpt import GPT
    from dtc_tpu_torch.obs import read_jsonl, shard_path
    from dtc_tpu_torch.obs.telemetry import Telemetry
    from dtc_tpu_torch.serve import EngineClosedError, ServingEngine

    rec: dict = dict(card=smi, faults=SERVE_FAULTS)
    chaos_cfg = dataclasses.replace(scfg, verify_pages_every=1,
                                    chaos=ChaosConfig(**SERVE_FAULTS))
    with tempfile.TemporaryDirectory(prefix="dtc_chip_smoke_serve_chaos_") as tmp:
        for backend, want_bf16 in (("fused", tokens_fused), ("fused_layers", tokens_fl)):
            for dtype in ("bfloat16", "float32"):
                what = f"phase 27(b) {backend} {dtype}"
                _, mc = load_serve_config(ROOT / "configs" / "serve_config.yaml", model_overrides={
                    "compute_dtype": dtype, "decode_attention": backend})
                reqs = flagship_requests(mc.vocab_size, seed, max_new)
                tele = Telemetry.for_serving(str(Path(tmp) / f"{backend}_{dtype}"))
                text = io.StringIO()
                with contextlib.redirect_stdout(text):
                    model, eng, res, wall, launched = serve(chaos_cfg, mc, seed, reqs,
                                                            device=device, telemetry=tele)
                tele.flush()
                c = eng.counters
                if dtype == "bfloat16":
                    want = want_bf16
                else:
                    want = {r.rid: generate(model, [list(r.prompt)], max_new)[0].tolist()
                            for r in reqs}
                got = {r.rid: list(res[r.rid].tokens) for r in reqs}
                tele.flush()
                events = read_jsonl(shard_path(str(Path(tmp) / f"{backend}_{dtype}" / "obs"), 0))
                # A re-prefill recomputes the evicted request's K/V through the
                # prefill path: in bf16 its rounding is not the decode steps',
                # so past its first eviction a request may part from the clean
                # run; before it, and for every request never evicted, the
                # tokens must be equal; in float32 all of them.
                evicted_at = {}
                for e in events:
                    if e["etype"] == "serve_evict":
                        evicted_at.setdefault(e["rid"], e["generated"])
                agree = {rid: next((i for i, (a, b) in enumerate(zip(got[rid], want[rid]))
                                    if a != b), min(len(got[rid]), len(want[rid])))
                         for rid in want}
                must = {rid: (len(want[rid]) if dtype == "float32" or rid not in evicted_at
                              else evicted_at[rid]) for rid in want}
                short = sorted(rid for rid in want if agree[rid] < must[rid])
                check(all(res[r.rid].state.value == "done" and len(got[r.rid]) == max_new
                          for r in reqs) and not short,
                      f"{what}: states {[res[r.rid].state.value for r in reqs]}, tokens part "
                      f"from {'phase 4/10' if dtype == 'bfloat16' else 'generate()'} too early "
                      f"for {short} (agree {agree}, evicted at {evicted_at})")
                check((c["chaos_injections"], c["serve_preemptions"], c["serve_corruptions"])
                      == (4, 1, 1) and c["serve_retries"] >= 1 and c["serve_hung_steps"] >= 1,
                      f"{what}: counters {dict(c)}")
                terminal = sorted(e["rid"] for e in events if e["etype"] == "serve_request")
                check(terminal == sorted(r.rid for r in reqs), f"{what}: serve_request {terminal}")
                attempts = c["serve_decode_steps"] + c["serve_retries"]
                want_launch = (dict(decode_attention=mc.n_layers * attempts, fused_layers=0)
                               if backend == "fused"
                               else dict(decode_attention=0, fused_layers=attempts))
                check(launched == want_launch and attempts > 0,
                      f"{what}: launches {launched} for {attempts} decode attempts "
                      f"({c['serve_decode_steps']} iterations + {c['serve_retries']} retries)")
                rec[f"{backend}_{dtype}"] = dict(
                    evicted_at=evicted_at, tokens_equal={rid: agree[rid] for rid in want},
                    all_equal=all(got[rid] == want[rid] for rid in want),
                    launches=launched, decode_attempts=attempts,
                    decode_iterations=c["serve_decode_steps"], retries=c["serve_retries"],
                    hung_steps=c["serve_hung_steps"], wall_s=wall,
                    evicted=[r.rid for r in reqs if res[r.rid].n_evictions],
                    events=len(events), counters=dict(c))
                tele.close()
                ref = ("phase " + ("4" if backend == "fused" else "10") if dtype == "bfloat16"
                       else "generate()")
                log(f"{what}: 6/6 done; tokens equal to {ref}'s for "
                    f"{sum(got[rid] == want[rid] for rid in want)}/6 requests (the leading "
                    f"tokens each agrees on {agree}; evicted and re-prefilled after "
                    f"{evicted_at} tokens); "
                    f"chaos {c['chaos_injections']}, preemptions {c['serve_preemptions']}, "
                    f"corruptions {c['serve_corruptions']}, retries {c['serve_retries']}, hung "
                    f"iterations {c['serve_hung_steps']}; launches {launched} for {attempts} "
                    f"decode attempts; {len(events)} events in the shard [{smi}]")
                del model, eng, res
                torch.cuda.empty_cache()

        # an SLO breach degrades the next admission; shutdown("evict")
        _, mc = load_serve_config(ROOT / "configs" / "serve_config.yaml")
        reqs = flagship_requests(mc.vocab_size, seed, max_new)
        model = GPT(mc, device=device, seed=seed)
        eng = ServingEngine(model, dataclasses.replace(scfg, slo=SloConfig(
            ttft_p99_s=1e-9, window=8, min_samples=1, check_every=1)))
        eng.submit(reqs[0])
        eng.run()
        eng.submit(reqs[3])
        res = eng.run()
        cap = scfg.degrade_max_new_tokens
        check(not res["r0"].degraded and res["r3"].degraded and eng.slo.degrade_active
              and res["r3"].tokens == tokens_fused["r3"][:cap],
              f"phase 27(b) SLO: r0 degraded {res['r0'].degraded}, r3 degraded "
              f"{res['r3'].degraded} with {len(res['r3'].tokens)} tokens")
        rec["slo_degraded_tokens"] = len(res["r3"].tokens)
        eng.shutdown()
        eng = ServingEngine(model, scfg)
        for r in flagship_requests(mc.vocab_size, seed, max_new):
            eng.submit(r)
        for _ in range(8):
            eng.step()
        res = eng.shutdown(mode="evict", reason="preemption notice")
        check(all(r.state.value == "failed" and isinstance(r.error, EngineClosedError)
                  and r.tokens == tokens_fused[rid][:len(r.tokens)] for rid, r in res.items())
              and any(r.tokens for r in res.values()),
              f"phase 27(b) shutdown: {[(rid, r.state.value, len(r.tokens)) for rid, r in res.items()]}")
        rec["shutdown_partial_tokens"] = {rid: len(r.tokens) for rid, r in res.items()}
        log(f"phase 27(b): ttft_p99_s 1e-9 breached and the next admission was capped at {cap} "
            f"tokens (phase 4's first {cap}); shutdown('evict') after 8 iterations: every "
            f"request FAILED with EngineClosedError, partial tokens "
            f"{rec['shutdown_partial_tokens']} (phase 4's prefixes)")
        del model, eng
        torch.cuda.empty_cache()

        # ms per token, the engine's telemetry off and on, alternated
        _, mc = load_serve_config(ROOT / "configs" / "serve_config.yaml",
                                  model_overrides={"decode_attention": "fused_layers"})
        mspt = {"off": [], "on": []}
        flags = {"off": [], "on": []}   # the watchdog's flags, and flight dumps written
        for i, mode in enumerate(("off", "on", "on", "off")):
            tele = (Telemetry.for_serving(str(Path(tmp) / f"timing_{i}")) if mode == "on"
                    else None)
            reqs = flagship_requests(mc.vocab_size, seed, max_new)
            model, eng, res, wall, _ = serve(scfg, mc, seed, reqs, device=device, telemetry=tele)
            mspt[mode].append(sum(res[r.rid].ms_per_token for r in reqs) / len(reqs))
            flags[mode].append((eng.counters["serve_hung_steps"],
                                len(tele.recorder.dumps) if tele is not None else 0))
            if tele is not None:
                tele.close()
            del model, eng, res
            torch.cuda.empty_cache()
    rec["ms_per_token"] = mspt
    rec["hung_steps_and_dumps"] = flags
    log(f"phase 27(b) fused_layers ms/token, telemetry off {mspt['off']} / on {mspt['on']} "
        f"(runs off, on, on, off; phase 10: {fl_rec['ms_per_token_mean']:.6f}); hung "
        f"iterations and flight dumps written a run: off {flags['off']}, on {flags['on']} "
        f"[{smi}]")
    return rec


def fleet_phase(smi: str, seed: int, device: str = "cuda") -> dict:
    """28: the serving fleet (``configs/router_config.yaml`` +
    ``model_config.yaml``: 3 replicas of 4 slots, ``placement: affinity``)
    through ``dtc_tpu_torch.serve.fleet``'s traffic and checks, twelve
    requests of 64 tokens. (a) As written (bf16, ``fused``) with the
    config's documented chaos block (a partition at router iteration 3, a
    stall at 6, a kill at 9, replica 0): zero silent drops, one death and
    failovers, every request done, bf16 tokens equal to ``generate()`` up
    to each request's first hop, ``n_layers`` decode-kernel launches per
    replica decode attempt; the card memory of one replica's router
    against three; the fleet's shards reduced; each hopped request's
    re-prefill; a replica spawned after the run serves a request with no
    kernel library built or first loaded (the build listener) and
    tokens equal to the run's. (b) float32 under ``fused_layers`` with
    ``finetune_lora.yaml``'s adapter block (rank 8), two tenants and base
    requests, the kill of tenant t1's home (replica 0): every request's
    tokens equal ``generate()`` with its tenant's factors, in full; one
    megakernel launch per decode attempt; t1 re-loaded on a survivor."""
    import dataclasses
    import tempfile

    import torch

    from dtc_tpu_torch.config.loader import load_finetune_config, load_router_config
    from dtc_tpu_torch.config.schema import ChaosConfig
    from dtc_tpu_torch.models.gpt import GPT
    from dtc_tpu_torch.obs import read_jsonl, reduce_shards, shard_path
    from dtc_tpu_torch.ops import _build, decode_fused
    from dtc_tpu_torch.ops import decode_attention as da
    from dtc_tpu_torch.ops import flash_attention as fa
    from dtc_tpu_torch.serve import FleetRouter
    from dtc_tpu_torch.serve.fleet import (
        EXAMPLE_CHAOS,
        check_fleet,
        fleet_requests,
        random_factors,
        reference_tokens,
        serve_fleet,
    )

    cuda = device == "cuda"

    def allocated() -> int:
        if not cuda:
            return 0
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    rcfg, mcfg = load_router_config(ROOT / "configs" / "router_config.yaml")
    _, mcfg_ad, _ = load_finetune_config(ROOT / "configs" / "finetune_lora.yaml")
    parts = (
        ("a", mcfg, dataclasses.replace(rcfg, chaos=ChaosConfig(**EXAMPLE_CHAOS))),
        ("b", dataclasses.replace(mcfg_ad, compute_dtype="float32",
                                  decode_attention="fused_layers"),
         dataclasses.replace(rcfg, chaos=ChaosConfig(
             enabled=True, fleet_kill_replica_at_step=9, fleet_target_replica=0))),
    )
    rec: dict = dict(card=smi, faults=EXAMPLE_CHAOS)
    with tempfile.TemporaryDirectory(prefix="dtc_chip_smoke_fleet_") as tmp:
        for part, mc, rc in parts:
            what = f"phase 28({part}) {mc.compute_dtype} {mc.decode_attention}"
            model = GPT(mc, device=device, seed=seed)
            factors = ({} if mc.adapter.rank == 0 else dict(zip(
                ("t1", "t2"), random_factors(mc, model.device, seed + 1, 2))))
            max_new = min(rc.serve.max_new_tokens, mc.max_seq_len // 2)
            reqs, _ = fleet_requests(mc, 12, seed, max_new, bool(factors))
            refs = reference_tokens(model, reqs, factors)
            r_rec: dict = {}
            if part == "a":
                # The card memory a router of one replica and of three takes
                # beside the shared weights: each replica's cache and stacks.
                mem = {}
                for n in (1, 3):
                    m0 = allocated()
                    probe = FleetRouter(model, dataclasses.replace(rc, n_replicas=n,
                                                                   chaos=ChaosConfig()))
                    mem[n] = allocated() - m0
                    del probe
                r_rec["replica_bytes"] = mem
                r_rec["weights_bytes"] = sum(p.numel() * p.element_size()
                                             for p in model.parameters())
            tables0 = len(decode_fused._tables)
            obs_dir = str(Path(tmp) / part)
            m0 = allocated()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            da.launches = decode_fused.launches = fa.fwd_launches = 0  # the main path starts here
            t0 = time.perf_counter()
            router, events = serve_fleet(rc, model, reqs, factors, obs_dir=obs_dir)
            if cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = dict(decode_attention=da.launches,  # ...and ends here
                            fused_layers=decode_fused.launches)
            r_rec["peak_allocated_above_start"] = (
                torch.cuda.max_memory_allocated() - m0 if cuda else 0)
            router.close()
            chk = check_fleet(router, reqs, refs, events, exact=mc.compute_dtype == "float32")
            check(not chk["failures"] and chk["done"] == len(reqs),
                  f"{what}: {chk['failures']}; {chk['done']}/{len(reqs)} done, states "
                  f"{chk['states']}")
            attempts = {rep.replica_id: rep.engine.counters["serve_decode_steps"]
                        + rep.engine.counters["serve_retries"] for rep in router.replicas}
            total = sum(attempts.values())
            want = (dict(decode_attention=mc.n_layers * total, fused_layers=0)
                    if mc.decode_attention == "fused"
                    else dict(decode_attention=0, fused_layers=total))
            check(launched == want and total > 0,
                  f"{what}: launches {launched} for {total} replica decode attempts "
                  f"{attempts} (want {want})")
            if factors:
                loads = [(e["adapter"], e["replica"]) for e in events
                         if e["etype"] == "router_adapter_load"]
                t1_homes = [r for a, r in loads if a == "t1"]
                check(t1_homes[:1] == [0] and any(r != 0 for r in t1_homes[1:]),
                      f"{what}: t1 loaded on replicas {t1_homes} (want its home 0, then a "
                      "survivor after the kill)")
                r_rec["adapter_loads"] = loads
            # the fleet's shards: the port's reducer, and each hopped
            # request's prefill on its first replica against its re-prefill
            red = reduce_shards(obs_dir)
            check(red is not None and red["serve"]["requests"] >= len(reqs)
                  and red["serve"].get("failover_hops", 0) >= 1,
                  f"{what}: reduced shards {red and red.get('serve')}")
            prefills: dict = {}
            for k in range(len(router.replicas)):
                for e in read_jsonl(shard_path(obs_dir, k)):
                    if e["etype"] == "span" and e["name"] == "req.prefill":
                        prefills.setdefault(e["rid"], []).append(
                            dict(replica=k, ms=e["dur_s"] * 1e3, resident=e["resident"]))
            reprefill = {rid: prefills.get(rid) for rid in chk["hops_at"]}
            res = router.results
            ttft = [res[r.rid].ttft_s for r in reqs]
            mspt = [res[r.rid].ms_per_token for r in reqs]
            n_tok = sum(len(res[r.rid].tokens) for r in reqs)
            # 12 requests in one admission wave bear no tail: their median and
            # largest, with n (the fleet entry point's open-loop run reads tails)
            r_rec.update(
                wall_s=wall, tokens=n_tok, tokens_per_s=n_tok / wall, n_timed=len(reqs),
                ttft_median_s=percentile(ttft, 0.5), ttft_max_s=max(ttft),
                ms_per_token_median=percentile(mspt, 0.5), ms_per_token_max=max(mspt),
                launches=launched, decode_attempts=attempts,
                flash_fwd_launches=fa.fwd_launches, routes=chk["routes"],
                hops_at=chk["hops_at"], tokens_equal=chk["tokens_equal"],
                all_equal=all(res[r.rid].tokens == refs[r.rid] for r in reqs),
                prefills=reprefill, summary=chk["summary"], reduced=red["serve"],
                megakernel_tables=len(decode_fused._tables) - tables0,
                lora_tables=len(decode_fused._lora_tables),
            )
            check(r_rec["megakernel_tables"] <= 1
                  and r_rec["lora_tables"] <= decode_fused._LORA_TABLES_KEPT,
                  f"{what}: the megakernel's module tables grew by {r_rec['megakernel_tables']} "
                  f"(LoRA tables {r_rec['lora_tables']})")
            log(f"{what}: {chk['done']}/{len(reqs)} done, {len(chk['hops_at'])} failed over "
                f"(tokens carried {chk['hops_at']}), routes {chk['routes']}, deaths "
                f"{chk['summary']['replica_deaths']}, failovers {chk['summary']['failovers']}; "
                f"tokens equal to generate() {chk['tokens_equal']}; launches {launched} for "
                f"replica decode attempts {attempts}; flash forward launches "
                f"{fa.fwd_launches} (the prefill attends densely) [{smi}]")
            log(f"{what} (time-sliced on one card, not a multi-replica throughput): wall "
                f"{wall:.3f} s, {n_tok} tokens, {r_rec['tokens_per_s']:.3f} tokens/s; over n "
                f"{len(reqs)} requests TTFT median {r_rec['ttft_median_s']:.6f} / max "
                f"{r_rec['ttft_max_s']:.6f} s, ms/token median "
                f"{r_rec['ms_per_token_median']:.6f} / max {r_rec['ms_per_token_max']:.6f}; "
                f"prefill and re-prefill of the hopped "
                f"requests {reprefill}; peak {r_rec['peak_allocated_above_start']} B above the "
                f"start [{smi}]")
            if part == "a":
                log(f"{what}: card memory of a router of 1 replica {mem[1]} B, of 3 {mem[3]} B, "
                    f"beside the shared weights' {r_rec['weights_bytes']} B [{smi}]")
                # A replica spawned after the run builds and loads nothing, and
                # serves a request as the run's replica did.
                heard: list = []

                def hear(sec: float, count: int) -> None:
                    heard.append((sec, count))

                _build.add_listener(hear)
                try:
                    sp = FleetRouter(model, dataclasses.replace(rc, n_replicas=1,
                                                                chaos=ChaosConfig()),
                                     router_proc=8)
                    t0 = time.perf_counter()
                    spawned = sp.spawn_replica()
                    spawn_s = time.perf_counter() - t0
                    sp.kill_replica(0, reason="spawn check")
                    sp.submit(reqs[1])
                    sp.run()
                finally:
                    _build.remove_listener(hear)
                got = sp.results[reqs[1].rid]
                check(not heard and got.state.value == "done" and spawned.replica_id == 1
                      and got.tokens == res[reqs[1].rid].tokens,
                      f"{what} spawn: builds and first loads heard {heard}, {got.state.value}, "
                      f"tokens equal to the run's {got.tokens == res[reqs[1].rid].tokens}")
                r_rec["spawn_s"] = spawn_s
                log(f"{what}: a replica spawned after the run in {spawn_s * 1e3:.3f} ms served "
                    f"{reqs[1].rid} with the run's tokens; builds and first loads heard: none")
                del sp, spawned
            rec[part] = r_rec
            del model, router, events
            if cuda:
                torch.cuda.empty_cache()
    return rec


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="", help="write every measured number to this JSON file")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", action="store_true",
                   help="also profile steady bf16 decode iterations and flagship "
                        "training steps (device busy share), the latter alone, "
                        "over NCCL at world size 1 and under FSDP over 4 virtual "
                        "ranks as well")
    p.add_argument("--rank-worker", default="", metavar="DIR",
                   help=argparse.SUPPRESS)  # one rank of phases 21-23 (spawn_ranks)
    args = p.parse_args()
    if args.rank_worker:
        sys.path.insert(0, str(ROOT))
        return rank_worker(args.rank_worker)

    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "dtc_tpu_torch" / "csrc").is_dir() or not (ROOT / "configs").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    record: dict = {}
    wall0 = time.perf_counter()
    walls: dict[str, float] = {}
    running = [wall0, "1"]

    def mark(phase: str) -> None:
        """Close the running phase's wall seconds and start ``phase``'s."""
        now = time.perf_counter()
        walls[running[1]] = walls.get(running[1], 0.0) + now - running[0]
        running[:] = [now, phase]

    try:
        # 1. device
        smi = nvidia_smi_line()
        kind = torch.cuda.get_device_name(0)
        log(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.device_count()} device(s)); nvidia-smi: {smi}")
        record["device"] = dict(name=kind, nvidia_smi=smi, torch=torch.__version__,
                                cuda=torch.version.cuda)

        mark("2")
        # 2. build: one nvcc per library, all started together. The six
        # megakernel libraries take minutes: phases 3, 5, 6, 8, 15 and 18
        # (kernel cases timed on the device, and correctness) run while
        # they compile; the host-timed phases 4 and 7 wait for the whole
        # build.
        from dtc_tpu_torch.ops import _build

        mk_names = list(_build._MEGAKERNELS)
        mk_took: dict = {}
        mk_failed: list = []

        def build_megakernels() -> None:
            try:
                mk_took.update(_build.build_all(mk_names))
            except Exception as e:  # raised in this thread when phase 9 needs them
                mk_failed.append(e)

        mk_build = threading.Thread(target=build_megakernels, name="megakernel-build")
        mk_build.start()
        took = _build.build_all([n for n in _build._SIGNATURES if n not in mk_names])

        def log_builds(took: dict) -> None:
            for name, sec in took.items():
                log(f"build {name}: {sec:.1f} s -> {_build.library_path(name).name}")
                for inst, rep in ptxas_report(_build.log_path(name).read_text()):
                    log(f"  ptxas {inst}: {rep}")

        log_builds(took)
        record["build_s"] = took
        # the FSDP ring's bf16 instances: dynamic shared memory a block, and
        # proof in the SASS that they run wgmma (HGMMA) on TMA loads (UTMALDG)
        from dtc_tpu_torch.ops.overlap_collectives import TC_TILES

        ovl = _build.load("overlap_collectives")
        tc_smem = {f"{tm}x{tn}, {st} stages": ovl.dtc_overlap_tc_smem_bytes(tm, tn, st)
                   for tm, tn in TC_TILES for st in (1, 2, 4)}
        sass = sass_counts(_build.library_path("overlap_collectives"))
        record["overlap_build"] = dict(tc_dynamic_smem=tc_smem, sass=sass)
        log(f"overlap_collectives: tensor-core instances' dynamic shared memory a block "
            f"{tc_smem} B; SASS {sass}")
        check(all(v > 0 for v in sass.values()),
              f"overlap_collectives: no tensor-core or TMA instruction in the SASS: {sass}")
        # the flash library's bf16 instances: the same proof, kernel by kernel
        from dtc_tpu_torch.ops.flash_attention import KERNEL_HEAD_DIMS

        ftc = _build.load("flash_attention_tc")
        from dtc_tpu_torch.ops.flash_attention import tc_smem_bytes

        ftc_smem = {f"{kind} D {d}": ftc.dtc_flash_tc_smem_bytes(i, d)
                    for i, kind in enumerate(("fwd", "dkv", "dq")) for d in KERNEL_HEAD_DIMS}
        want_smem = {f"{kind} D {d}": tc_smem_bytes(kind, d)
                     for kind in ("fwd", "dkv", "dq") for d in KERNEL_HEAD_DIMS}
        check(ftc_smem == want_smem, f"flash_attention_tc: shared memory {ftc_smem} B, the "
              f"plan's {want_smem} B")
        fsass = sass_counts_by_function(_build.library_path("flash_attention_tc"))
        record["flash_tc_build"] = dict(dynamic_smem=ftc_smem, sass=fsass)
        log(f"flash_attention_tc: dynamic shared memory a block {ftc_smem} B")
        for fn, counts in sorted(fsass.items()):
            log(f"  SASS {fn}: {counts}")
        for kern, n in (("flash_fwd_tc_kernel", 8), ("flash_dkv_tc_kernel", 16),
                        ("flash_dq_tc_kernel", 16)):
            insts = {fn: c for fn, c in fsass.items() if fn.startswith(kern + "<")}
            check(len(insts) == n and all(min(c.values()) > 0 for c in insts.values()),
                  f"flash_attention_tc: {kern} instances without a tensor-core or TMA "
                  f"instruction in the SASS: {insts}")

        mark("3")
        # 3. kernels vs plain
        from dtc_tpu_torch.ops import decode_attention as da

        flagship = (4, 512, 16, 32)
        cases = [
            ("bf16_per_row", *flagship, "bfloat16", "bfloat16", [0, 37, 511, 600], True),
            ("bf16_scalar", *flagship, "bfloat16", "bfloat16", [300], False),
            ("fp32_per_row", *flagship, "float32", "float32", [0, 37, 511, 600], True),
            ("int8_per_row", *flagship, "bfloat16", "int8", [0, 37, 511, 600], True),
            ("bf16_s8192", 4, 8192, 16, 32, "bfloat16", "bfloat16", [0, 4095, 5000, 9000], True),
            # the cache model_config_longctx.yaml serves at; model_ladder_350m's
            # head width; row 10's flash shape (a head dim the earlier kernel refused)
            ("bf16_s4096", 4, 4096, 16, 32, "bfloat16", "bfloat16", [0, 1000, 2047, 4095], True),
            ("bf16_d128", 4, 1024, 8, 128, "bfloat16", "bfloat16", [0, 300, 1023, 1100], True),
            ("bf16_d48", 4, 1024, 8, 48, "bfloat16", "bfloat16", [0, 300, 1023, 1100], True),
        ]
        decode_ptxas = dict(ptxas_report(_build.log_path("decode_attention").read_text()))
        results = [
            kernel_case(name, b, s, h, d, qd, kd, st, pr, seed=args.seed + i, iters=200,
                        ptxas=decode_ptxas)
            for i, (name, b, s, h, d, qd, kd, st, pr) in enumerate(cases)
        ]
        record["kernel_cases"] = results
        # ms and plain_ms replay CUDA graphs (device time); wrapper_ms
        # dispatches from the host, which the megakernel build shares here
        record["kernel_cases_wrapper_ms"] = "host-dispatched, during the megakernel build"
        log("phase 3: wrapper_ms is host-dispatched and was taken while the megakernel "
            "libraries build beside it (not comparable with readings on an idle host); ms and "
            "plain_ms are CUDA-graph device times")

        from dtc_tpu_torch.config.loader import load_serve_config

        scfg, mcfg = load_serve_config(ROOT / "configs" / "serve_config.yaml")
        max_new = 64

        mark("5")
        # 5. serve in float32: token-identical to generate()
        from dtc_tpu_torch.generate import generate

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _, mcfg32 = load_serve_config(
            ROOT / "configs" / "serve_config.yaml",
            model_overrides={"compute_dtype": "float32"},
        )
        reqs32 = flagship_requests(mcfg.vocab_size, args.seed, max_new)
        model, eng, res, wall, _ = serve(scfg, mcfg32, args.seed, reqs32)
        same = 0
        for r in reqs32:
            ref = generate(model, [list(r.prompt)], max_new)[0].tolist()
            ok = res[r.rid].state.value == "done" and res[r.rid].tokens == ref
            same += ok
            log(f"serve fp32 {r.rid}: {'matches generate' if ok else 'MISMATCH vs generate'}")
        record["serve_fp32"] = dict(matching=same, requests=len(reqs32), wall_s=wall,
                                    tokens_per_s=sum(len(res[r.rid].tokens) for r in reqs32) / wall)
        check(same == len(reqs32), f"fp32 serve: {same}/{len(reqs32)} requests match generate")
        del model, eng
        torch.cuda.empty_cache()

        mark("6")
        # 6. flash-attention kernels vs plain (TF32 off since phase 5)
        from dtc_tpu_torch.ops import flash_attention as fa

        flash_cases = [
            ("bf16_flagship", 8, 512, 16, 32, "bfloat16"),
            ("fp32_flagship", 8, 512, 16, 32, "float32"),
            ("bf16_t1000", 2, 1000, 16, 32, "bfloat16"),
            # the JAX package's transpose-layout shapes (rows 10-14); fp32_d48
            # is phase 8's call
            ("bf16_d48", 4, 1024, 8, 48, "bfloat16"),
            ("fp32_d48", 4, 1024, 8, 48, "float32"),
            ("bf16_h3", 2, 1000, 3, 32, "bfloat16"),
            ("fp32_h3", 2, 1000, 3, 32, "float32"),
            # a rank's call under TP 2 (phase 21) and a stage's microbatch
            # under PP 2 (phase 22)
            ("bf16_tp2", 8, 512, 8, 32, "bfloat16"),
            ("bf16_pp2", 4, 512, 16, 32, "bfloat16"),
        ]
        flash = [
            flash_case(name, b, t, h, d, dt, seed=args.seed + 100 + i, iters=50)
            for i, (name, b, t, h, d, dt) in enumerate(flash_cases)
        ]
        # the long-context training calls of phases 13-14: T 4096 (B 4) and
        # T 8192 (B 2), where the JAX package takes its split backward
        # (rows 8-9); the plain versions one row at a time
        flash_4k = flash_case("bf16_t4096", 4, 4096, 16, 32, "bfloat16",
                              seed=args.seed + 111, iters=5, rows=1)
        flash_8k = flash_case("bf16_t8192", 2, 8192, 16, 32, "bfloat16",
                              seed=args.seed + 110, iters=5, rows=1)
        record["flash_cases"] = flash + [flash_4k, flash_8k]
        dq_faults = dq_fault_cases()
        for fname, (kern_r, fault_r) in dq_faults.items():
            log(f"flash dq planted fault '{fname}': {fault_r:.3f} of the limit; the kernel on "
                f"the same inputs {kern_r:.3f}")
            check(fault_r > 1.0 and kern_r <= 1.0,
                  f"flash dq: the limit misses '{fname}' or the kernel is over it")
        record["flash_dq_faults"] = dq_faults
        torch.cuda.empty_cache()

        mark("8")
        # 8. path agreement: flash kernels vs dense attention, float32, at
        # head dims 32 and 48 (the latter the JAX package's transpose-layout
        # family, at phase 6's fp32_d48 shape)
        record["path_agreement"] = {}
        for head_dim, seq in ((32, 256), (48, 1024)):
            agree, pa_launches = path_agreement(args.seed, head_dim=head_dim, max_seq_len=seq)
            gap = max(abs(a - b) for a, b in zip(agree["flash"], agree["dense"]))
            record["path_agreement"][f"d{head_dim}"] = dict(
                agree, max_abs_diff=gap, flash_launches=pa_launches)
            log(f"path agreement (8 heads of {head_dim}, T {seq}): flash {agree['flash']} vs dense "
                f"{agree['dense']}: max abs diff {gap:.3e} (limit 1e-4); flash launches "
                f"{pa_launches}")
            check(gap <= 1e-4, f"flash and dense training disagree by {gap} at D {head_dim}")

        mark("15")
        # 15. the ring's block kernels against their plain versions
        block_specs = [
            ("bf16_tc1024", 2, 1024, 16, 32, "bfloat16"),   # T 8192 over a ring of 4
            ("fp32_tc1024", 2, 1024, 16, 32, "float32"),
            ("bf16_tc512", 4, 512, 16, 32, "bfloat16"),     # T 4096 over a ring of 4
            ("bf16_tc8", 2, 8, 16, 32, "bfloat16"),         # ragged chunks
            ("bf16_tc40", 2, 40, 16, 32, "bfloat16"),
            ("bf16_tc1000", 2, 1000, 16, 32, "bfloat16"),
            ("fp32_tc1000", 2, 1000, 16, 32, "float32"),
            ("bf16_d16", 2, 512, 32, 16, "bfloat16"),       # other head dims
            ("bf16_d64", 2, 512, 8, 64, "bfloat16"),
            ("bf16_d128", 2, 512, 4, 128, "bfloat16"),
            ("fp32_d128", 2, 512, 4, 128, "float32"),
        ]
        blocks = [block_case(name, b, tc, h, d, dt, seed=args.seed + 150 + i, iters=20)
                  for i, (name, b, tc, h, d, dt) in enumerate(block_specs)]
        record["block_cases"] = blocks

        mark("18")
        # 18. the FSDP ring's kernels (rows 17-18) against their plain
        # versions over 4 virtual ranks, at the flagship's dense sites
        overlap_specs = [
            ("bf16_qkv", 8, 512, 512, 512, 0, "bfloat16", 20),
            ("bf16_fc1", 8, 512, 512, 2048, 0, "bfloat16", 20),
            ("bf16_out_proj", 8, 512, 512, 512, 1, "bfloat16", 20),
            ("bf16_fc2", 8, 512, 2048, 512, 1, "bfloat16", 20),
            ("fp32_qkv", 8, 512, 512, 512, 0, "float32", 0),
            ("fp32_fc1", 8, 512, 512, 2048, 0, "float32", 0),
            ("fp32_out_proj", 8, 512, 512, 512, 1, "float32", 0),
            ("fp32_fc2", 8, 512, 2048, 512, 1, "float32", 0),
            # the DP×FSDP×TP sites of train_config_3d.yaml (a model rank's
            # Megatron widths, 4 ranks of 2,048 rows)
            ("bf16_3d_qkv", 16, 512, 512, 256, 0, "bfloat16", 20),
            ("bf16_3d_fc1", 16, 512, 512, 1024, 0, "bfloat16", 20),
            ("bf16_3d_out_proj", 16, 512, 256, 512, 1, "bfloat16", 20),
            ("bf16_3d_fc2", 16, 512, 1024, 512, 1, "bfloat16", 20),
            ("fp32_3d_qkv", 16, 512, 512, 256, 0, "float32", 0),
            ("fp32_3d_fc1", 16, 512, 512, 1024, 0, "float32", 0),
            ("fp32_3d_out_proj", 16, 512, 256, 512, 1, "float32", 0),
            ("fp32_3d_fc2", 16, 512, 1024, 512, 1, "float32", 0),
            ("bf16_ragged", 4, 100, 200, 300, 0, "bfloat16", 0),   # m 100, blocks 50 / 75
            ("bf16_ragged_out", 4, 100, 200, 300, 1, "bfloat16", 0),
            ("fp32_ragged", 4, 100, 200, 300, 0, "float32", 0),
        ]
        overlap = [overlap_case(name, b, t, k, n, sa, dt, seed=args.seed + 180 + i, iters=it,
                                route="threads" if "ragged" in name and dt == "bfloat16"
                                else "tma" if dt == "bfloat16" else "cuda_cores")
                   for i, (name, b, t, k, n, sa, dt, it) in enumerate(overlap_specs)]
        record["overlap_cases"] = overlap

        # the megakernel libraries: their build ran beside phases 3, 5, 6, 8, 15
        # and 18
        mark("2 (megakernel build, waited for)")
        mk_build.join()
        if mk_failed:
            raise mk_failed[0]
        log_builds(mk_took)
        record["build_s"].update(mk_took)

        mark("4")
        # 4. serve the flagship as configured
        reqs = flagship_requests(mcfg.vocab_size, args.seed, max_new)
        mem_base = torch.cuda.memory_allocated()  # what earlier phases still hold
        log(f"device memory still allocated before serving: {mem_base} B")
        model, eng, res, wall, launched = serve(scfg, mcfg, args.seed, reqs)
        launches = launched["decode_attention"]
        steps = eng.counters["serve_decode_steps"]
        for r in reqs:
            rr = res[r.rid]
            check(rr.state.value == "done", f"{r.rid}: {rr.state.value} ({rr.error})")
            check(len(rr.tokens) == max_new, f"{r.rid}: {len(rr.tokens)} tokens")
            check(all(0 <= t < mcfg.vocab_size for t in rr.tokens), f"{r.rid}: token out of vocab")
        check(eng.counters["serve_prefix_builds"] == 1 and eng.counters["serve_prefix_hits"] == 1,
              f"prefix store not shared: {dict(eng.counters)}")
        tokens_fused = {r.rid: list(res[r.rid].tokens) for r in reqs}  # phase 27's reference
        check(launches == mcfg.n_layers * steps and steps > 0,
              f"decode attention launched {launches} times for {steps} decode "
              f"iterations (want {mcfg.n_layers} per iteration)")
        ttft = [res[r.rid].ttft_s for r in reqs]
        mspt = [res[r.rid].ms_per_token for r in reqs]
        n_tok = sum(len(res[r.rid].tokens) for r in reqs)
        serve_rec = dict(
            requests=len(reqs), tokens=n_tok, decode_iterations=steps,
            kernel_launches=launches, wall_s=wall,
            ttft_p50_s=percentile(ttft, 0.5), ttft_max_s=max(ttft),
            ms_per_token_mean=sum(mspt) / len(mspt), tokens_per_s=n_tok / wall,
            peak_allocated=torch.cuda.max_memory_allocated() - mem_base,
            counters=dict(eng.counters), card=smi,
        )
        record["serve_bf16"] = serve_rec
        log(f"serve bf16: 6/6 done, {n_tok} tokens, {steps} decode iterations, "
            f"{launches} kernel launches (= {mcfg.n_layers} x {steps}) [{smi}]")
        log(f"serve bf16: ttft_p50 {serve_rec['ttft_p50_s']:.6f} s, ms/token "
            f"{serve_rec['ms_per_token_mean']:.6f}, tokens/s {serve_rec['tokens_per_s']:.3f}, "
            f"peak allocated {serve_rec['peak_allocated']} B [{smi}]")
        main_launches = launches
        if args.profile:
            prof = profile_decode(model, scfg, flagship_requests(mcfg.vocab_size, args.seed, max_new))
            record["profile_bf16"] = prof
            log(f"profile bf16: {prof['iterations']} decode iterations, wall "
                f"{prof['wall_s']:.6f} s, device busy {prof['device_busy_s']:.6f} s "
                f"(share {prof['busy_share']:.4f}), {prof['kernel_launches']} kernels [{smi}]")
            for row in prof["top"]:
                log(f"  {row['device_ms']:.4f} ms x{row['count']} {row['name']}")
        del model, eng
        torch.cuda.empty_cache()

        mark("7")
        # 7. train the flagship as the command line would
        steps, warmup = 30, 5
        out_dir = ROOT / "build" / "chip_smoke_train"
        res, (tcfg, tmcfg, ocfg), (fwd_n, bwd_n), peak = train_flagship(steps, warmup, str(out_dir))
        losses = res.losses
        check(len(losses) == steps and all(math.isfinite(x) for x in losses),
              f"flagship training: {len(losses)} losses, not all finite: {losses}")
        first, last5 = losses[0], sum(losses[-5:]) / 5
        check(last5 < first, f"flagship loss did not fall: first {first}, last-5 mean {last5}")
        rows = (out_dir / "log.csv").read_text().splitlines()
        check(rows[0] == "step,elapsed_time,loss" and len(rows) == steps + 1,
              f"log.csv: header {rows[:1]}, {len(rows) - 1} rows for {steps} steps")
        n_steps = steps + warmup
        check(fwd_n == tmcfg.n_layers * n_steps
              and bwd_n == tmcfg.n_layers * n_steps * fa.BWD_KERNELS,
              f"flash launches fwd {fwd_n} / bwd {bwd_n} for {n_steps} steps of "
              f"{tmcfg.n_layers} layers (want {tmcfg.n_layers} and "
              f"{tmcfg.n_layers * fa.BWD_KERNELS} per step)")
        from dtc_tpu_torch.utils.metrics import H100_BF16_PEAK_FLOPS, gpt_step_flops

        el = res.elapsed_times
        step_s = sorted(b - a for a, b in zip([0.0] + el[:-1], el))[len(el) // 2]
        tok = tcfg.batch * tmcfg.max_seq_len
        train_rec = dict(
            steps=steps, warmup_steps=warmup, losses=losses, step_ms_median=step_s * 1e3,
            tokens_per_s=tok / step_s,
            mfu=gpt_step_flops(tmcfg, tcfg.batch, tmcfg.max_seq_len) / (step_s * H100_BF16_PEAK_FLOPS),
            peak_allocated=peak, flash_fwd_launches=fwd_n, flash_bwd_launches=bwd_n,
            total_time_s=res.total_time_s, card=smi,
        )
        routes7 = flash_routes()
        train_rec["flash_routes"] = routes7
        record["train_flagship"] = train_rec
        log(f"train flagship: {steps} steps after {warmup} warmup, loss {first:.4f} -> "
            f"{losses[-1]:.4f} (last-5 mean {last5:.4f}), log.csv {steps} rows, flash "
            f"launches fwd {fwd_n} = {tmcfg.n_layers} x {n_steps}, bwd {bwd_n} = "
            f"{tmcfg.n_layers} x {n_steps} x {fa.BWD_KERNELS} [{smi}]")
        log(f"train flagship: step_ms median {train_rec['step_ms_median']:.6f}, tokens/s "
            f"{train_rec['tokens_per_s']:.3f}, MFU {train_rec['mfu']:.6f} (of 989 TFLOP/s "
            f"bf16 dense), peak allocated {peak} B [{smi}]")
        del res
        torch.cuda.empty_cache()
        if args.profile:
            prof = profile_train(tmcfg, tcfg, ocfg)
            record["profile_train"] = prof
            log(f"profile train: {prof['steps']} steps, wall {prof['wall_s']:.6f} s, device "
                f"busy {prof['device_busy_s']:.6f} s (share {prof['busy_share']:.4f}), "
                f"{prof['kernel_launches']} kernels [{smi}]")
            for row in prof["top"]:
                log(f"  {row['device_ms']:.4f} ms x{row['count']} {row['name']}")
            torch.cuda.empty_cache()

        mark("9")
        # 9. the decode megakernel vs plain at the flagship widths and depth
        import dataclasses

        from dtc_tpu_torch.ops import decode_fused

        mk_cases, mk_models = [], {}
        for i, (name, compute, t, kvd, d) in enumerate((
            ("bf16_bf16kv_t1", "bfloat16", 1, "bfloat16", 32),
            ("bf16_bf16kv_t4", "bfloat16", 4, "bfloat16", 32),
            ("bf16_int8_t1", "bfloat16", 1, "int8", 32),
            ("bf16_int8_t4", "bfloat16", 4, "int8", 32),
            ("fp32_fp32kv_t1", "float32", 1, "float32", 32),
            ("fp32_fp32kv_t4", "float32", 4, "float32", 32),
            ("fp32_bf16kv_t1", "float32", 1, "bfloat16", 32),
            ("fp32_int8_t4", "float32", 4, "int8", 32),
            # head dims whose position groups leave lanes idle: 8 heads of D,
            # d_ff 4 * d_model, the flagship's depth and cache; the plain
            # version's products exact there (exact_products)
            ("bf16_bf16kv_t1_d48", "bfloat16", 1, "bfloat16", 48),
            ("bf16_int8_t4_d80", "bfloat16", 4, "int8", 80),
            ("fp32_fp32kv_t1_d96", "float32", 1, "float32", 96),
            ("bf16_bf16kv_t4_d112", "bfloat16", 4, "bfloat16", 112),
        )):
            if (compute, d) not in mk_models:
                cfg_d = mcfg if d == mcfg.head_dim else dataclasses.replace(
                    mcfg, n_heads=8, d_model=8 * d, d_ff=32 * d)
                mk_models[compute, d] = megakernel_model(cfg_d, compute, args.seed + 900)
            starts = [2, 37, mcfg.max_seq_len - t, mcfg.max_seq_len + 88]
            mk_cases.append(megakernel_case(name, mk_models[compute, d], 4, t, kvd, starts,
                                            seed=args.seed + 910 + i, exact=d != mcfg.head_dim))
        mk_flag = megakernel_times(mk_models["bfloat16", 32], 4, 1, "bfloat16",
                                   [2, 37, 300, 511], args.seed + 920, iters=100)
        mk_verify = megakernel_times(mk_models["bfloat16", 32], 4, 4, "bfloat16",
                                     [2, 37, 300, 508], args.seed + 921, iters=100)
        mk_grid, mk_smem = decode_fused.kernel_config(mk_models["bfloat16", 32].cfg,
                                                      torch.bfloat16)
        mk_ptxas = [rep for name in _build._MEGAKERNELS
                    for rep in ptxas_report(_build.log_path(name).read_text())]
        mk_sass = sass_counts_by_function(_build.library_path("decode_fused_bf16_bf16"),
                                          MK_SASS_OPCODES)
        del mk_models
        torch.cuda.empty_cache()
        # the ladder configs at B 4, t 1: the bound is bytes (1.21 and 4.03 GB
        # of float32 weights)
        mk_ladder = {}
        for tag in ("350m", "1b"):
            from dtc_tpu_torch.config.loader import load_yaml_dataclass
            from dtc_tpu_torch.config.schema import ModelConfig

            lcfg = load_yaml_dataclass(ROOT / "configs" / f"model_ladder_{tag}.yaml", ModelConfig)
            lmodel = megakernel_model(lcfg, "bfloat16", args.seed + 900)
            starts = [2, 37, 300, lcfg.max_seq_len - 1]
            mk_ladder[tag] = dict(megakernel_times(lmodel, 4, 1, "bfloat16", starts,
                                                   args.seed + 925, iters=20),
                                  starts=starts, n_layers=lcfg.n_layers, d_model=lcfg.d_model,
                                  d_ff=lcfg.d_ff, head_dim=lcfg.head_dim, card=smi)
            del lmodel
            torch.cuda.empty_cache()
        for tag, tm_ in (("flagship t1", mk_flag), ("flagship t4", mk_verify),
                         ("ladder_350m t1", mk_ladder["350m"]), ("ladder_1b t1", mk_ladder["1b"])):
            log(f"megakernel {tag} (B 4, bf16, bf16 KV): kernel_ms "
                f"{tm_['ms']:.6f} wrapper_ms {tm_['wrapper_ms']:.6f} plain_ms {tm_['plain_ms']:.6f}"
                + (f" per_layer_ms {tm_['per_layer_ms']:.6f} per_layer_wrapper_ms "
                   f"{tm_['per_layer_wrapper_ms']:.6f}" if "per_layer_ms" in tm_ else "")
                + f" bound_ms {tm_['bound_ms']:.6f} ({tm_['bound_by']}, {tm_['bytes']} B; kernel "
                f"{tm_['ms'] / tm_['bound_ms']:.2f}x the bound) [{smi}]")
        log(f"megakernel launch: {mk_grid} blocks (one an SM) of 384 threads (8 consumer warps "
            f"with 232 registers and a producer warpgroup with 40, by setmaxnreg), {mk_smem} B "
            f"dynamic shared memory per block; library_ms null (no single PyTorch call computes "
            f"a layer stack)")
        for fn, counts in sorted(mk_sass.items()):
            log(f"  SASS {fn}: {counts}")
        mk_insts = [fn for fn in mk_sass if fn.startswith("fused_layers_kernel<")]
        check(len(mk_insts) == len(decode_fused.KERNEL_HEAD_DIMS)
              and sum(c["UBLKCP"] + c["UTMALDG"] for c in mk_sass.values()) > 0,
              f"decode_fused: {len(mk_insts)} kernel instances, or no bulk copy in the SASS: "
              f"{mk_sass}")

        mark("9b")
        # 9b. the megakernel's LoRA sites: rank 8 on all six sites (the adapter
        # block of finetune_lora.yaml), slots [0, 1, 2, 1] of a stack whose slot
        # 0 is the base, scale 2 and 8/3 (not a bf16 value)
        from dtc_tpu_torch.config.loader import load_finetune_config
        from dtc_tpu_torch.serve.fleet import random_factors

        _, mcfg_ad, _ = load_finetune_config(ROOT / "configs" / "finetune_lora.yaml")
        lora_ids = [0, 1, 2, 1]
        lora_models, mk_lora = {}, []
        for i, (name, compute, t, kvd, alpha) in enumerate((
            ("lora_bf16_bf16kv_t1_s2", "bfloat16", 1, "bfloat16", 16.0),
            ("lora_bf16_bf16kv_t1_s8/3", "bfloat16", 1, "bfloat16", 64.0 / 3.0),
            ("lora_bf16_bf16kv_t4_s8/3", "bfloat16", 4, "bfloat16", 64.0 / 3.0),
            ("lora_bf16_int8_t1_s8/3", "bfloat16", 1, "int8", 64.0 / 3.0),
            ("lora_fp32_fp32kv_t1_s8/3", "float32", 1, "float32", 64.0 / 3.0),
        )):
            if (compute, alpha) not in lora_models:
                cfg_l = dataclasses.replace(
                    mcfg_ad, adapter=dataclasses.replace(mcfg_ad.adapter, alpha=alpha))
                model_l = megakernel_model(cfg_l, compute, args.seed + 900)
                factors = random_factors(model_l.cfg, model_l.device, args.seed + 930, 2)
                lora_models[compute, alpha] = (model_l, lora_stack(model_l, factors))
            model_l, stack = lora_models[compute, alpha]
            starts = [2, 37, mcfg.max_seq_len - t, mcfg.max_seq_len + 88]
            mk_lora.append(megakernel_case(name, model_l, 4, t, kvd, starts,
                                           seed=args.seed + 940 + i, lora=stack, ids=lora_ids))
        model_l, stack = lora_models["bfloat16", 16.0]
        mk_lora_t1 = megakernel_times(model_l, 4, 1, "bfloat16", [2, 37, 300, 511],
                                      args.seed + 920, iters=100, lora=stack, ids=lora_ids)
        log(f"megakernel flagship t1 with adapters (B 4, 12 layers, bf16, bf16 KV, rank 8, "
            f"slots {lora_ids}): kernel_ms {mk_lora_t1['ms']:.6f} (without adapters on the "
            f"same inputs {mk_lora_t1['base_ms']:.6f}) wrapper_ms {mk_lora_t1['wrapper_ms']:.6f} "
            f"plain_ms {mk_lora_t1['plain_ms']:.6f} per_layer_ms {mk_lora_t1['per_layer_ms']:.6f} "
            f"bound_ms {mk_lora_t1['bound_ms']:.6f} ({mk_lora_t1['bound_by']}, "
            f"{mk_lora_t1['bytes']} B) [{smi}]")
        record["megakernel"] = dict(cases=mk_cases, flagship_t1=mk_flag, flagship_t4=mk_verify,
                                    lora_cases=mk_lora, flagship_t1_lora=mk_lora_t1,
                                    ladder=mk_ladder, grid=mk_grid, smem=mk_smem,
                                    ptxas=mk_ptxas, sass=mk_sass, card=smi)
        del lora_models, model_l, stack
        torch.cuda.empty_cache()

        mark("10")
        # 10. serve the flagship under fused_layers: one megakernel launch per
        # decode step, no per-layer decode kernel
        mcfg_fl = dataclasses.replace(mcfg, decode_attention="fused_layers")
        reqs_fl = flagship_requests(mcfg.vocab_size, args.seed, max_new)
        model, eng, res, wall, launched = serve(scfg, mcfg_fl, args.seed, reqs_fl)
        steps_fl = eng.counters["serve_decode_steps"]
        for r in reqs_fl:
            rr = res[r.rid]
            check(rr.state.value == "done" and len(rr.tokens) == max_new,
                  f"fused_layers {r.rid}: {rr.state.value}, {len(rr.tokens)} tokens ({rr.error})")
        check(launched["fused_layers"] == steps_fl and steps_fl > 0
              and launched["decode_attention"] == 0,
              f"fused_layers serve: {launched} launches for {steps_fl} decode iterations "
              f"(want one megakernel launch each and no decode-attention launch)")
        tokens_fl = {r.rid: list(res[r.rid].tokens) for r in reqs_fl}
        n_tok = sum(len(t) for t in tokens_fl.values())
        ttft = [res[r.rid].ttft_s for r in reqs_fl]
        mspt = [res[r.rid].ms_per_token for r in reqs_fl]
        fl_rec = dict(
            requests=len(reqs_fl), tokens=n_tok, decode_iterations=steps_fl,
            megakernel_launches=launched["fused_layers"],
            decode_attention_launches=launched["decode_attention"], wall_s=wall,
            ttft_p50_s=percentile(ttft, 0.5), ms_per_token_mean=sum(mspt) / len(mspt),
            tokens_per_s=n_tok / wall, counters=dict(eng.counters), card=smi,
            watchdog_flags=watchdog_report(eng, "serve fused_layers"),
        )
        log(f"serve fused_layers: 6/6 done, {n_tok} tokens, {steps_fl} decode iterations, "
            f"{launched['fused_layers']} megakernel launches, {launched['decode_attention']} "
            f"decode-attention launches [{smi}]")
        log(f"serve fused_layers: ttft_p50 {fl_rec['ttft_p50_s']:.6f} s, ms/token "
            f"{fl_rec['ms_per_token_mean']:.6f}, tokens/s {fl_rec['tokens_per_s']:.3f} "
            f"(per-layer 'fused' run of phase 4: ms/token {serve_rec['ms_per_token_mean']:.6f}, "
            f"tokens/s {serve_rec['tokens_per_s']:.3f}) [{smi}]")
        if args.profile:
            prof = profile_decode(model, scfg, flagship_requests(mcfg.vocab_size, args.seed, max_new))
            fl_rec["profile"] = prof
            log(f"profile fused_layers: {prof['iterations']} decode iterations, wall "
                f"{prof['wall_s']:.6f} s, device busy {prof['device_busy_s']:.6f} s (share "
                f"{prof['busy_share']:.4f}), {prof['kernel_launches']} kernels = "
                f"{prof['kernel_launches'] / prof['iterations']:.1f} per iteration [{smi}]")
            for row in prof["top"]:
                log(f"  {row['device_ms']:.4f} ms x{row['count']} {row['name']}")
        record["serve_fused_layers"] = fl_rec
        del model, eng
        torch.cuda.empty_cache()

        mark("10b")
        # 10b. float32 under fused_layers: the engine's tokens equal generate()'s
        _, mcfg32_fl = load_serve_config(
            ROOT / "configs" / "serve_config.yaml",
            model_overrides={"compute_dtype": "float32", "decode_attention": "fused_layers"},
        )
        reqs32 = flagship_requests(mcfg.vocab_size, args.seed, max_new)
        model, eng, res, _, launched32 = serve(scfg, mcfg32_fl, args.seed, reqs32)
        same = 0
        for r in reqs32:
            ref = generate(model, [list(r.prompt)], max_new)[0].tolist()
            same += res[r.rid].state.value == "done" and res[r.rid].tokens == ref
        record["serve_fused_layers_fp32"] = dict(matching=same, requests=len(reqs32),
                                                 launches=launched32)
        log(f"serve fused_layers fp32: {same}/{len(reqs32)} requests match generate(); "
            f"launches {launched32}")
        check(same == len(reqs32), f"fused_layers fp32 serve: {same}/{len(reqs32)} match generate")
        del model, eng
        torch.cuda.empty_cache()

        mark("11")
        # 11. speculative serving on the megakernel: token-identical to phase 10
        from dtc_tpu_torch.config.schema import SpecConfig

        spec_k, draft_layers = 4, 4
        scfg_spec = dataclasses.replace(scfg, spec=SpecConfig(spec_k=spec_k,
                                                              draft_layers=draft_layers))
        reqs_sp = flagship_requests(mcfg.vocab_size, args.seed, max_new)
        model, eng, res, wall, launched = serve(scfg_spec, mcfg_fl, args.seed, reqs_sp)
        c = eng.counters
        rounds = c["serve_spec_rounds"]
        same = sum(res[r.rid].tokens == tokens_fl[r.rid] for r in reqs_sp)
        for r in reqs_sp:
            if res[r.rid].tokens != tokens_fl[r.rid]:
                log(f"serve spec {r.rid}: MISMATCH vs phase 10 ({res[r.rid].state.value})")
        n_tok = sum(len(res[r.rid].tokens) for r in reqs_sp)
        decoded = n_tok - c["serve_admissions"]       # each admission's prefill emits one
        mspt = [res[r.rid].ms_per_token for r in reqs_sp]
        sp_rec = dict(
            spec_k=spec_k, draft_layers=draft_layers, matching_phase10=same,
            requests=len(reqs_sp), tokens=n_tok, verify_launches=rounds,
            megakernel_launches=launched["fused_layers"],
            decode_attention_launches=launched["decode_attention"],
            proposed=c["serve_spec_proposed"], accepted=c["serve_spec_accepted"],
            accept_rate=c["serve_spec_accepted"] / max(c["serve_spec_proposed"], 1),
            tokens_per_verify_launch=decoded / max(rounds, 1),
            ms_per_token_mean=sum(mspt) / len(mspt), tokens_per_s=n_tok / wall,
            wall_s=wall, counters=dict(c), card=smi,
        )
        record["serve_spec"] = sp_rec
        log(f"serve spec (k {spec_k}, draft {draft_layers} layers): {same}/{len(reqs_sp)} "
            f"requests token-identical to phase 10; {rounds} verify launches, "
            f"{launched['fused_layers']} megakernel launches, accept rate "
            f"{sp_rec['accept_rate']:.4f}, tokens per verify launch "
            f"{sp_rec['tokens_per_verify_launch']:.4f}, ms/token {sp_rec['ms_per_token_mean']:.6f}, "
            f"tokens/s {sp_rec['tokens_per_s']:.3f} [{smi}]")
        check(same == len(reqs_sp), f"spec serve: {same}/{len(reqs_sp)} requests match phase 10")
        check(launched["decode_attention"] == 0
              and launched["fused_layers"] == rounds * (spec_k + 1),
              f"spec serve: {launched} launches for {rounds} rounds (want {spec_k} draft steps "
              f"and one verify window per round, all on the megakernel)")
        del model, eng
        torch.cuda.empty_cache()

        mark("12")
        # 12. multi-tenant adapter serving on the flagship
        ad_rec = serve_adapters(scfg, mcfg_ad, args.seed, max_new, tokens_fl, fl_rec, smi)
        record["serve_adapters"] = ad_rec

        mark("13")
        # 13. long-context training: T 4096 from the command line, T 8192 as
        # bench.py's long_context_t8192_b2
        from dtc_tpu_torch.utils.metrics import train_memory_bytes

        long_rec, steps = {}, 30
        for tag, t8192 in (("t4096", False), ("t8192", True)):
            out_dir = ROOT / "build" / f"chip_smoke_longctx_{tag}"
            res, (ltcfg, lmcfg, locfg), (fwd_l, bwd_l), peak = train_long_context(
                str(out_dir), steps, t8192)
            losses = res.losses
            check(len(losses) == steps and all(math.isfinite(x) for x in losses),
                  f"long context {tag}: {len(losses)} losses, not all finite: {losses}")
            first, last5 = losses[0], sum(losses[-5:]) / 5
            check(last5 < first, f"long context {tag}: loss did not fall: first {first}, "
                  f"last-5 mean {last5}")
            rows = (out_dir / "log.csv").read_text().splitlines()
            check(rows[0] == "step,elapsed_time,loss" and len(rows) == steps + 1,
                  f"long context {tag} log.csv: header {rows[:1]}, {len(rows) - 1} rows for "
                  f"{steps} steps")
            routes_l = flash_routes()
            n_steps = steps + ltcfg.warmup_steps
            per_step = (fwd_l / n_steps, bwd_l / n_steps)
            check(per_step == (lmcfg.n_layers, lmcfg.n_layers * fa.BWD_KERNELS),
                  f"long context {tag}: flash launches fwd {fwd_l} / bwd {bwd_l} for "
                  f"{n_steps} steps (want {lmcfg.n_layers} and "
                  f"{lmcfg.n_layers * fa.BWD_KERNELS} per step)")
            # sync_every_step: false stamps rows at dispatch; the window's
            # last row is re-stamped after its sync, so the mean step is the
            # last elapsed time over the steps
            step_s = res.elapsed_times[-1] / steps
            tok = ltcfg.batch * lmcfg.max_seq_len
            budget = train_memory_bytes(lmcfg, ltcfg.batch, lmcfg.max_seq_len)
            long_rec[tag] = dict(
                batch=ltcfg.batch, seq_len=lmcfg.max_seq_len, remat=lmcfg.remat_mode,
                steps=steps, warmup_steps=ltcfg.warmup_steps, losses=losses,
                step_ms_mean=step_s * 1e3, tokens_per_s=tok / step_s,
                mfu=gpt_step_flops(lmcfg, ltcfg.batch, lmcfg.max_seq_len)
                / (step_s * H100_BF16_PEAK_FLOPS),
                peak_allocated=peak, train_memory_bytes=budget,
                flash_fwd_launches=fwd_l, flash_bwd_launches=bwd_l, flash_routes=routes_l,
                total_time_s=res.total_time_s, card=smi,
            )
            log(f"long context {tag} (B {ltcfg.batch}, T {lmcfg.max_seq_len}, "
                f"{lmcfg.remat_mode}): {steps} steps after {ltcfg.warmup_steps} warmup, loss "
                f"{first:.4f} -> {losses[-1]:.4f} (last-5 mean {last5:.4f}), log.csv {steps} "
                f"rows, flash launches fwd {fwd_l} = {lmcfg.n_layers} x {n_steps}, bwd "
                f"{bwd_l} = {lmcfg.n_layers * fa.BWD_KERNELS} x {n_steps} [{smi}]")
            log(f"long context {tag}: step_ms mean {step_s * 1e3:.6f}, tokens/s {tok / step_s:.3f}, "
                f"MFU {long_rec[tag]['mfu']:.6f} (of 989 TFLOP/s bf16 dense), peak allocated "
                f"{peak} B, train_memory_bytes total {budget['total']:.0f} B (activations "
                f"{budget['activations']:.0f} B) [{smi}]")
            del res
            torch.cuda.empty_cache()
            if t8192 and args.profile:
                prof = profile_train(lmcfg, ltcfg, locfg, steps=3)
                long_rec[tag]["profile"] = prof
                log(f"profile long context {tag}: {prof['steps']} steps, wall "
                    f"{prof['wall_s']:.6f} s, device busy {prof['device_busy_s']:.6f} s (share "
                    f"{prof['busy_share']:.4f}), {prof['kernel_launches']} kernels [{smi}]")
                for row in prof["top"]:
                    log(f"  {row['device_ms']:.4f} ms x{row['count']} {row['name']}")
                torch.cuda.empty_cache()
        record["long_context"] = long_rec

        mark("14")
        # 14. the remat modes at T 4096: the same bits, their launches and
        # their peak memory
        modes, rtcfg, rmcfg = remat_modes()
        n_steps = rtcfg.warmup_steps + rtcfg.steps
        recompute = {"block": 2}
        for mode, (losses, (fwd_r, bwd_r), peak, budget, step_s) in modes.items():
            log(f"remat {mode} (T {rmcfg.max_seq_len}, B {rtcfg.batch}, dropout "
                f"{rmcfg.dropout}): losses {losses}; flash launches fwd {fwd_r} "
                f"({fwd_r / n_steps:g} a step), bwd {bwd_r}; step_ms mean {step_s * 1e3:.6f} "
                f"over {rtcfg.steps} steps; peak allocated {peak} B, train_memory_bytes total "
                f"{budget['total']:.0f} B (activations {budget['activations']:.0f} B) [{smi}]")
            check(losses == modes["none"][0],
                  f"remat {mode}: losses {losses} differ from none's {modes['none'][0]}")
            want = rmcfg.n_layers * n_steps
            check((fwd_r, bwd_r) == (want * recompute.get(mode, 1), want * fa.BWD_KERNELS),
                  f"remat {mode}: flash launches fwd {fwd_r} / bwd {bwd_r} for {n_steps} steps")
        peaks = {m: v[2] for m, v in modes.items()}
        check(peaks["block"] < peaks["block_save_flash"] < peaks["none"]
              and peaks["mlp"] < peaks["none"], f"remat peak memory out of order: {peaks}")
        record["remat"] = {m: dict(losses=v[0], flash_launches=v[1], peak_allocated=v[2],
                                   train_memory_bytes=v[3], step_ms_mean=v[4] * 1e3, card=smi)
                           for m, v in modes.items()}
        log(f"remat: losses of the four modes equal bit for bit; peak memory {peaks} [{smi}]")
        torch.cuda.empty_cache()
        mark("14b")
        # 14b. the head + CE's float32 (B·T, V) temporaries: each mode's peak
        # with the CE on all 16,384 rows at once (as before it was chunked)
        # beside its peak now, and an allocation trace of one step each way
        from dtc_tpu_torch.ops import fused_ce

        whole = rmcfg.max_seq_len * rtcfg.batch
        old_modes, _, _ = remat_modes(ce_rows=whole)
        old_peaks = {m: v[2] for m, v in old_modes.items()}
        for mode in peaks:
            log(f"remat {mode}: peak allocated {peaks[mode]} B with the head + CE chunked "
                f"({fused_ce.CE_CHUNK_ROWS} rows), {old_peaks[mode]} B unchunked; drop "
                f"{old_peaks[mode] - peaks[mode]} B; step_ms mean {modes[mode][4] * 1e3:.6f} "
                f"chunked, {old_modes[mode][4] * 1e3:.6f} unchunked [{smi}]")
            record["remat"][mode]["peak_allocated_ce_unchunked"] = old_peaks[mode]
            record["remat"][mode]["step_ms_mean_ce_unchunked"] = old_modes[mode][4] * 1e3
            check(peaks[mode] < old_peaks[mode],
                  f"remat {mode}: the chunked head + CE did not lower the peak "
                  f"({peaks[mode]} B against {old_peaks[mode]} B)")
        record["memory_trace"] = {}
        for tag, rows_ in (("unchunked", whole), ("chunked", None)):
            tr = memory_trace(ce_rows=rows_)
            record["memory_trace"][tag] = tr
            log(f"memory trace, remat none, head + CE {tag} ({tr['ce_rows']} rows): the step's "
                f"peak {tr['peak_above_step_start']} B above its start ({tr['events']} events); "
                f"blocks >= 256 MiB live at the peak: {tr['live_big_bytes']} B [{smi}]")
            for where, sizes in sorted(tr["live_at_peak"].items(), key=lambda kv: -sum(kv[1])):
                log(f"  {len(sizes)} x {sizes[0]} B (sum {sum(sizes)} B) from {where}")
        torch.cuda.empty_cache()

        mark("16")
        # 16. the zigzag ring on one card: R virtual ranks at (B 2, T 8192,
        # H 16, D 32), then one training step of the model on the ring
        ring_recs = [ring_on_one_card(r, 2, 8192, 16, 32, dt, seed=args.seed + 160 + i)
                     for i, (r, dt) in enumerate(((4, "bfloat16"), (2, "bfloat16"),
                                                  (4, "float32"), (2, "float32")))]
        record["ring_one_card"] = ring_recs
        record["ring_training"] = ring_training_step(4, args.seed)

        mark("17")
        # 17. the trainer over NCCL at world size 1: bit-equal to one process
        from dtc_tpu_torch.config.loader import load_config

        steps17 = 20
        res17, alone17, seen17, launches17, rows17 = train_nccl_world1(
            steps17, str(ROOT / "build" / "chip_smoke_nccl"))
        n17 = steps17 + load_config(ROOT / "configs" / "train_config_dp.yaml")[0].warmup_steps
        check(seen17["backend"] == "nccl" and seen17["averages"] == n17,
              f"phase 17: backend {seen17['backend']}, {seen17['averages']} gradient averages "
              f"for {n17} steps")
        check(res17.losses == alone17.losses and len(res17.losses) == steps17,
              f"phase 17: NCCL losses {res17.losses} != one process's {alone17.losses}")
        check(rows17[0] == "step,elapsed_time,loss" and len(rows17) == steps17 + 1,
              f"phase 17: log.csv {rows17}")
        check(launches17 == (12 * n17, 12 * n17 * fa.BWD_KERNELS),
              f"phase 17: flash launches {launches17} for {n17} steps")
        record["nccl_world1"] = dict(losses=res17.losses, losses_alone=alone17.losses,
                                     backend=seen17["backend"], averages=seen17["averages"],
                                     flash_launches=launches17, card=smi,
                                     step_ms_median=step_ms(res17.elapsed_times),
                                     step_ms_median_alone=step_ms(alone17.elapsed_times))
        log(f"trainer over NCCL at world size 1 (torchrun's environment, the flagship, "
            f"{steps17} steps after 5 warmup): losses {res17.losses} equal the single-process "
            f"run's bit for bit; {seen17['averages']} gradient all-reduces; flash launches "
            f"{launches17}; log.csv {len(rows17) - 1} rows; step_ms median "
            f"{record['nccl_world1']['step_ms_median']:.6f} (one process: "
            f"{record['nccl_world1']['step_ms_median_alone']:.6f}). This proves the process "
            f"group, the reduction and rank-0 logging on one card, not several cards [{smi}]")
        if args.profile:
            tcfg17, mcfg17, ocfg17 = load_config(ROOT / "configs" / "train_config_dp.yaml")
            prof17 = profile_nccl_world1(mcfg17, tcfg17, ocfg17)
            record["profile_nccl_world1"] = prof17
            for mode, pr in prof17.items():
                log(f"profile phase 17 {mode}: {pr['steps']} steps, wall "
                    f"{pr['wall_s'] / pr['steps'] * 1e3:.6f} ms a step, device busy "
                    f"{pr['device_busy_s'] / pr['steps'] * 1e3:.6f} ms a step (share "
                    f"{pr['busy_share']:.4f}), {pr['kernel_launches']} kernels [{smi}]")
                for row in pr["top"][:8] + pr["host"]:
                    log(f"  {row}")
            torch.cuda.empty_cache()

        mark("19")
        # 19. FSDP over 4 virtual ranks on one card, overlapped: the dense
        # sites run the kernels (the launches of the kernels line)
        record["fsdp_virtual"] = fsdp_virtual(args.seed, profile=args.profile)

        mark("20")
        # 20. the FSDP trainer over NCCL at world size 1: xla bit-equal to one
        # process, overlapped inert
        steps20 = 10
        runs20, backend20, alone20 = fsdp_nccl_world1(
            steps20, str(ROOT / "build" / "chip_smoke_fsdp"))
        x20, o20 = runs20["xla"], runs20["overlapped"]
        inert = "collectives: overlapped is inert on this run" in o20[1]
        check(backend20 == "nccl", f"phase 20: backend {backend20}")
        check(x20[0].losses == alone20.losses and len(x20[0].losses) == steps20,
              f"phase 20: NCCL losses {x20[0].losses} != one process's {alone20.losses}")
        check(o20[0].losses == x20[0].losses,
              f"phase 20: overlapped losses {o20[0].losses} != xla's {x20[0].losses}")
        check(inert and o20[2] == (0, 0) and x20[2] == (0, 0),
              f"phase 20: overlapped inert warning {inert}, ring launches {o20[2]} / {x20[2]}")
        for mode, (_, _, _, rows) in runs20.items():
            check(rows[0] == "step,elapsed_time,loss" and len(rows) == steps20 + 1,
                  f"phase 20 {mode}: log.csv {rows}")
        record["fsdp_nccl_world1"] = dict(
            losses=x20[0].losses, losses_alone=alone20.losses,
            losses_overlapped=o20[0].losses, backend=backend20, inert_warning=inert,
            ring_launches=dict(xla=x20[2], overlapped=o20[2]), card=smi)
        log(f"FSDP trainer over NCCL at world size 1 (torchrun's environment, the flagship, "
            f"{steps20} steps after 5 warmup): xla losses {x20[0].losses} equal the "
            f"single-process run's bit for bit; overlapped: the inert warning printed, ring "
            f"launches {o20[2]}, losses equal xla's; log.csv {len(x20[3]) - 1} rows each. "
            f"This proves the process group, the gathers and reduce-scatters and rank-0 "
            f"logging on one card, not several cards [{smi}]")

        mark("21-22")
        # 21-22. tensor and pipeline parallelism over gloo ranks sharing the
        # card, each rank's flash kernels on its heads / its stage's layers
        ref32 = one_process_fp32(4)
        record["one_process_fp32"] = ref32
        record["tp"] = tensor_parallel_phase(ref32, smi)
        record["pp"] = pipeline_phase(ref32, smi)

        mark("23")
        # 23. DP×FSDP×TP (train_config_3d.yaml) and FSDP with ring attention
        # over gloo ranks sharing the card: the FSDP ring's kernels over each
        # model index's data group, on the Megatron slices
        record["fsdp_mesh"] = fsdp_mesh_phase(ref32, smi)

        mark("24")
        # 24. checkpoints, resume, held-out eval and the guard's rollback on
        # the flagship
        record["checkpoints"] = checkpoint_phase(smi, train_rec["step_ms_median"])

        mark("25")
        # 25. bf16_mixed master weights; the LoRA finetune -> eval gate ->
        # export -> serve loop on the flagship
        walls25 = [time.perf_counter()]
        record["bf16_mixed"] = bf16_mixed_phase(smi, train_rec)
        torch.cuda.empty_cache()
        walls25.append(time.perf_counter())
        ft_rec, ft_dir = finetune_phase(smi)
        record["finetune"] = ft_rec
        walls25.append(time.perf_counter())
        try:
            ft_rec["serve"] = serve_trained_adapter(ft_dir / "full.npz", scfg, args.seed,
                                                    max_new, tokens_fl, fl_rec, smi)
        finally:
            import shutil

            shutil.rmtree(ft_dir, ignore_errors=True)
        torch.cuda.empty_cache()
        walls25.append(time.perf_counter())
        parts25 = [b - a for a, b in zip(walls25, walls25[1:])]
        record["phase25_wall_s"] = dict(total=walls25[-1] - walls25[0], a=parts25[0],
                                        b=parts25[1], c=parts25[2])
        log(f"phase 25 wall {walls25[-1] - walls25[0]:.1f} s: (a) {parts25[0]:.1f}, (b) "
            f"{parts25[1]:.1f}, (c) {parts25[2]:.1f}")

        mark("26")
        # 26. the telemetry subsystem in the trainer: the committed config
        # as written, obs on against off, the devprof capture, memory, costs
        record["telemetry"] = telemetry_phase(smi, train_rec)
        torch.cuda.empty_cache()

        mark("27")
        # 27. the chaos harness and the recovery bus: the dev chaos config on
        # the flagship, and the serving drill under both decode backends
        walls27 = [time.perf_counter()]
        record["chaos_train"] = chaos_train_phase(smi)
        torch.cuda.empty_cache()
        walls27.append(time.perf_counter())
        record["chaos_serve"] = chaos_serve_phase(scfg, args.seed, max_new, tokens_fused,
                                                  tokens_fl, fl_rec, smi)
        walls27.append(time.perf_counter())
        record["phase27_wall_s"] = dict(total=walls27[-1] - walls27[0],
                                        a=walls27[1] - walls27[0], b=walls27[2] - walls27[1])
        log(f"phase 27 wall {walls27[-1] - walls27[0]:.1f} s: (a) {walls27[1] - walls27[0]:.1f}, "
            f"(b) {walls27[2] - walls27[1]:.1f}")
        chaos_serve = record["chaos_serve"]

        mark("28")
        # 28. the serving fleet: router_config.yaml's three replicas of the
        # flagship with its documented chaos block, then float32 tenants
        # under fused_layers with their home replica killed
        record["fleet"] = fleet_phase(smi, args.seed)
        fleet = record["fleet"]

        main = results[0]
        kernels = [dict(
            name="decode_attention", route="cuda",
            source="dtc_tpu_torch/csrc/decode_attention.cu",
            replaces="dtc_tpu/ops/decode_attention.py:150",
            also_replaces="dtc_tpu/ops/decode_attention.py:189",
            launches=main_launches, max_abs_err=max(c["max_abs_err"] for c in results),
            ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
            bound_by=main["bound_by"], library_ms=main["library_ms"],
            launches_trained_adapter=ft_rec["serve"]["fused"]["decode_attention_launches"],
            launches_chaos_serve={dt: chaos_serve[f"fused_{dt}"]["launches"]["decode_attention"]
                                  for dt in ("bfloat16", "float32")},
            launches_fleet=fleet["a"]["launches"]["decode_attention"],
        )]
        # The flash rows: the plan's route of the timed bf16 kernels ("tc":
        # tensor cores) and the main path's launches by kind and route; the
        # backward's dq and dk/dv kernels apart, dq beside its own bound.
        fl = flash[0]
        for part, launched, row, multi, routes in (
                ("fwd", fwd_n, 506, 558, routes7["fwd"]),
                ("bwd", bwd_n, 527, 605, routes7["dkv"])):
            kernels.append(dict(
                name=f"flash_attention_{part}", route="cuda",
                source="dtc_tpu_torch/csrc/flash_attention.cu",
                replaces=f"dtc_tpu/ops/flash_attention.py:{row}",
                also_replaces=f"dtc_tpu/ops/flash_attention.py:{multi}",
                launches=launched,
                max_abs_err=max(c[f"{part}_max_abs_err"] for c in flash[:3]),
                ms=fl[f"{part}_ms"], plain_ms=fl[f"plain_{part}_ms"],
                bound_ms=fl[f"{part}_bound_ms"], bound_by=fl[f"{part}_bound_by"],
                library_ms=fl[f"library_{part}_ms"], plan_route="tc", route_launches=routes,
                launches_tp2=[n[part == "bwd"] for n in record["tp"]["bf16"]["launches"]],
                **{f"{c['case'][5:]}_{key}": c[src] for c in flash
                   if c["case"] in ("bf16_tp2", "bf16_pp2")
                   for key, src in (("ms", f"{part}_ms"), ("bound_ms", f"{part}_bound_ms"),
                                    ("plain_ms", f"plain_{part}_ms"),
                                    ("library_ms", f"library_{part}_ms"))},
                launches_pp2={name: [n[part == "bwd"] for n in record["pp"][name]["bf16"][
                    "launches"]] for name in ("gpipe", "1f1b", "1f1b_v2")},
                launches_checkpoint_run=record["checkpoints"]["resume"]["flash_launches"][
                    part == "bwd"],
                route_launches_checkpoint_run=record["checkpoints"]["resume"]["flash_routes"],
                launches_bf16_mixed=record["bf16_mixed"]["flash_launches"][part == "bwd"],
                route_launches_bf16_mixed=record["bf16_mixed"]["flash_routes"],
                launches_finetune=ft_rec["flash_launches"][part == "bwd"],
                route_launches_finetune=ft_rec["flash_routes"],
                launches_telemetry=record["telemetry"]["launches"][part == "bwd"],
                route_launches_telemetry=record["telemetry"]["routes"],
                capture_kernels_telemetry=record["telemetry"]["capture"]["flash_kernels"][part],
                launches_chaos_train=record["chaos_train"]["flash_launches"][part == "bwd"],
                route_launches_chaos_train=record["chaos_train"]["flash_routes"],
                **({"dq_ms": fl["dq_ms"], "dkv_ms": fl["dkv_ms"],
                    "dq_bound_ms": fl["dq_bound_ms"], "dq_route_launches": routes7["dq"]}
                   if part == "bwd" else {}),
            ))
        kernels.append(dict(
            name="decode_fused_layers", route="cuda",
            source="dtc_tpu_torch/csrc/decode_fused.cu",
            replaces="dtc_tpu/ops/decode_fused.py:151",
            launches=fl_rec["megakernel_launches"],
            max_abs_err=max(c["max_abs_err"] for c in mk_cases),
            ms=mk_flag["ms"], plain_ms=mk_flag["plain_ms"], bound_ms=mk_flag["bound_ms"],
            bound_by=mk_flag["bound_by"], library_ms=None,
            yardstick_per_layer_ms=mk_flag["per_layer_ms"], t4_ms=mk_verify["ms"],
            ladder_ms={tag: r["ms"] for tag, r in mk_ladder.items()},
            ladder_bound_ms={tag: r["bound_ms"] for tag, r in mk_ladder.items()},
            launches_chaos_serve={dt: chaos_serve[f"fused_layers_{dt}"]["launches"]["fused_layers"]
                                  for dt in ("bfloat16", "float32")},
        ))
        kernels.append(dict(
            name="decode_fused_layers_lora", route="cuda",
            source="dtc_tpu_torch/csrc/decode_fused.cu",
            replaces="dtc_tpu/ops/decode_fused.py:151",
            also_replaces="dtc_tpu/ops/decode_fused.py:216",
            launches=ad_rec["fused_layers"]["megakernel_launches"],
            max_abs_err=max(c["max_abs_err"] for c in mk_lora),
            ms=mk_lora_t1["ms"], plain_ms=mk_lora_t1["plain_ms"],
            bound_ms=mk_lora_t1["bound_ms"], bound_by=mk_lora_t1["bound_by"], library_ms=None,
            without_adapters_ms=mk_lora_t1["base_ms"],
            yardstick_per_layer_ms=mk_lora_t1["per_layer_ms"],
            launches_trained_adapter=ft_rec["serve"]["fused_layers"]["megakernel_launches"],
            launches_fleet=fleet["b"]["launches"]["fused_layers"],
        ))
        kernels.append(dict(
            name="flash_attention_bwd_t8192", route="cuda",
            source="dtc_tpu_torch/csrc/flash_attention.cu",
            replaces="dtc_tpu/ops/flash_attention.py:704",
            also_replaces="dtc_tpu/ops/flash_attention.py:733",
            launches=long_rec["t8192"]["flash_bwd_launches"],
            max_abs_err=flash_8k["bwd_max_abs_err"],
            ms=flash_8k["bwd_ms"], plain_ms=flash_8k["plain_bwd_ms"],
            bound_ms=flash_8k["bwd_bound_ms"], bound_by=flash_8k["bwd_bound_by"],
            library_ms=flash_8k["library_bwd_ms"],
            fwd_ms=flash_8k["fwd_ms"], fwd_bound_ms=flash_8k["fwd_bound_ms"],
            dq_ms=flash_8k["dq_ms"], dkv_ms=flash_8k["dkv_ms"], plan_route="tc",
            dq_bound_ms=flash_8k["dq_bound_ms"], dq_bound_by=flash_8k["dq_bound_by"],
            dq_route_launches=long_rec["t8192"]["flash_routes"]["dq"],
            route_launches=long_rec["t8192"]["flash_routes"],
        ))
        d48 = next(c for c in flash if c["case"] == "fp32_d48")  # phase 8's call
        bf48 = next(c for c in flash if c["case"] == "bf16_d48")
        d48_launches = record["path_agreement"]["d48"]["flash_launches"]
        kernels.append(dict(
            name="flash_attention_fwd_bwd_d48", route="cuda",
            source="dtc_tpu_torch/csrc/flash_attention.cu",
            replaces="dtc_tpu/ops/flash_attention.py:74",
            also_replaces=[f"dtc_tpu/ops/flash_attention.py:{n}" for n in (97, 198, 246, 276)],
            launches=sum(d48_launches),
            max_abs_err=max(c[f"{part}_max_abs_err"] for c in flash
                            if c["d"] == 48 or c["h"] == 3 for part in ("fwd", "bwd")),
            ms=d48["fwd_ms"] + d48["bwd_ms"], plain_ms=d48["plain_fwd_ms"] + d48["plain_bwd_ms"],
            bound_ms=d48["fwd_bwd_bound_ms"], bound_by=d48["fwd_bwd_bound_by"],
            library_ms=d48["library_fwd_bwd_ms"],
            fwd_ms=d48["fwd_ms"], bwd_ms=d48["bwd_ms"], dq_ms=d48["dq_ms"], dkv_ms=d48["dkv_ms"],
            fwd_launches=d48_launches[0], bwd_launches=d48_launches[1], plan_route="fma",
            bf16_fwd_ms=bf48["fwd_ms"], bf16_dq_ms=bf48["dq_ms"], bf16_dkv_ms=bf48["dkv_ms"],
            bf16_plan_route="tc",
        ))
        main_block = blocks[0]
        # The model's own run on the ring (phase 16's training step) counts
        # the launches; the op-level calls' counts gate each call above.
        ring_launches = record["ring_training"]["block_launches"]
        for part, launched, row in (("fwd", ring_launches[0], 1096),
                                    ("bwd", ring_launches[1], 1118)):
            kernels.append(dict(
                name=f"flash_block_{part}", route="cuda",
                source="dtc_tpu_torch/csrc/flash_attention.cu",
                replaces=f"dtc_tpu/ops/flash_attention.py:{row}",
                launches=launched,
                max_abs_err=max(c[f"{part}_max_abs_err"] for c in blocks),
                ms=main_block[f"full_{part}"], plain_ms=main_block[f"full_plain_{part}"],
                bound_ms=main_block[f"full_{part}_bound"],
                bound_by=main_block[f"full_{part}_bound_by"],
                library_ms=main_block[f"full_library_{part}"],
                causal_ms=main_block[f"causal_{part}"], plan_route="tc",
                launches_fsdp_ring=[n[part == "bwd"] for n in
                                    record["fsdp_mesh"]["fsdp_ring"]["block_launches"]],
                route_launches=record["ring_training"]["flash_routes"],
                **({"dq_ms": main_block["full_dq"], "dkv_ms": main_block["full_dkv"],
                    "dq_bound_ms": main_block["full_dq_bound"],
                    "dq_route_launches": record["ring_training"]["flash_routes"]["dq"]}
                   if part == "bwd" else {}),
            ))
        # Rows 17-18: launches from phase 19's FSDP training (the model's
        # own run over 4 virtual ranks); times at the bf16 site where the
        # kernel is slowest against its bound, every timed site's in sites_ms.
        timed = [c for c in overlap if "ag_ms" in c]
        fsdp_launches = record["fsdp_virtual"]["launches"]
        for kind, launched, row, name in (("ag", fsdp_launches[0], 231, "overlap_ag_matmul"),
                                          ("rs", fsdp_launches[1], 296, "overlap_rs_matmul")):
            worst = max(timed, key=lambda c: c[f"{kind}_ms"] / c[f"{kind}_bound_ms"])
            kernels.append(dict(
                name=name, route="cuda", source="dtc_tpu_torch/csrc/overlap_collectives.cu",
                replaces=f"dtc_tpu/ops/overlap_collectives.py:{row}",
                launches=launched,
                max_abs_err=max(c[f"max_abs_err_{kind}"] for c in overlap),
                ms=worst[f"{kind}_ms"], plain_ms=worst[f"{kind}_plain_ms"],
                bound_ms=worst[f"{kind}_bound_ms"], bound_by=worst[f"{kind}_bound_by"],
                library_ms=worst[f"{kind}_library_ms"], site=worst["case"],
                sites_ms={c["case"]: c[f"{kind}_ms"] for c in timed},
                sites_bound_ms={c["case"]: c[f"{kind}_bound_ms"] for c in timed},
                routes=record["fsdp_virtual"]["routes"],
                launches_3d=[n[kind == "rs"] for n in
                             record["fsdp_mesh"]["bf16"]["ring_launches"]],
                launches_3d_per_rank_step=[n[kind == "rs"] for n in
                                           record["fsdp_mesh"]["ring_launches_per_rank_step"]],
            ))
        record["kernels"] = kernels
        mark("end")
        record["phase_wall_s"] = walls
        log("phase walls (s): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    except Exception:
        traceback.print_exc()
        log("FAIL")
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(record, indent=1, default=str))
        return 1

    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1, default=str))
    log(f"chip smoke: {time.perf_counter() - wall0:.1f} s wall in all")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
