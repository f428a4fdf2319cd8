"""The port over several processes (``torch.distributed`` with gloo on the
CPU, as ``torchrun --device cpu`` runs it) against the JAX package on its
8-device CPU mesh, on the same flax weights and synthetic batches at
dropout 0.

- One spawn of 4 processes: the ring's ``DistRing`` transport at R 4
  gives the in-process transport's result bit for bit in float32, forward
  and gradients, on every path (the zigzag on the block kernels' plain
  versions, the zigzag on plain blocks, the uniform schedule); the
  zigzag conversion's self-pairs are local copies (gloo refuses a send to
  one's own rank). Then the trainer under ``parallel: 3d`` with
  ``MeshConfig(pipe=1, data=2, model=2)`` and ``attention: ring`` against
  JAX's ring training (``data=4, model=2``: JAX's mesh must cover its 8
  devices; the global batch, the ring of 2 and so the losses are the
  same), 3 steps, JAX's rtol 2e-4 (``tests/test_ring_attention.py``), and
  the resume below under ring attention.
- One spawn of 2 processes: ``parallel: dp`` against JAX's dp on 8
  devices at the same global batch, 3 steps, rtol 2e-4; rank 0 alone
  writes ``log.csv``, one row per step. Then, at dropout 0.1 with
  checkpoints and eval every 2 steps, a resume to 4 steps from the step-2
  checkpoint gives the uninterrupted run's losses and eval losses bit for
  bit on both ranks. Then the LoRA finetune (rank 4 on all six sites,
  eval every 2 steps) and ``precision: bf16_mixed`` training, 4 steps
  each, against the port's one-process runs within 1e-6 (bf16_mixed's
  taking each step as the two ranks do; no JAX oracle: both are held
  against JAX in ``tests/test_torch_finetune.py`` and
  ``tests/test_torch_bf16.py``). The spawn runs once a session, under a
  file lock, for both of its tests.
- One spawn of 4 processes: the FSDP ring's op (``overlap_dense_matmul``,
  both shard axes, forward and gradients, and ``reduce_scatter_matmul``)
  over a ``DistRing`` gives the in-process ring's result bit for bit in
  float32; then ``parallel: fsdp`` under ``collectives: xla`` and under
  ``overlapped`` against JAX's FSDP training of each mode on its 8
  devices (same global batch), 3 steps, rtol 2e-4; each rank holds a
  quarter of every sharded parameter and the gathered model equals its
  shards; rank 0 alone writes ``log.csv``; one FSDP backward's reduced
  gradients, loss and clip norm equal one process's on the whole batch
  (AdamW hides a wrong gradient scale from the losses).

The worker is this file run as a script (it imports no JAX). Each spawn
has its own timeout.
"""

import dataclasses
import json
import os
import pickle
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
SPAWN_TIMEOUT_S = 180

# The ring transport cases: (name, schedule, heads, head dim); 32 takes the
# block kernels' path, 24 the plain blocks'.
RING_CASES = (("zigzag_kernels", "zigzag", 4, 32), ("zigzag_blocks", "zigzag", 2, 24),
              ("uniform", "uniform", 2, 24))


def _ring_inputs(h, d):
    rng = np.random.RandomState(d)
    return [rng.randn(2, 64, h, d).astype(np.float32) for _ in range(3)]


# The FSDP ring's op cases: (name, shard axis, K, N).
OVERLAP_CASES = (("contract", 0, 64, 128), ("out", 1, 64, 128), ("contract_kn", 0, 128, 64),
                 ("out_kn", 1, 128, 64))


def _overlap_inputs(k, n):
    rng = np.random.RandomState(k + n)
    return [rng.randn(*shape).astype(np.float32) for shape in ((8, 4, k), (k, n), (8, 4, n))]


def _overlap_result(ring, x, w, dy, shard_axis):
    """Out and the gradients of ``<out, dy>`` for the rows and chunk a ring
    holds, then the reduce-scatter of ``xᵀ @ dy`` over the sharded dim."""
    from dtc_tpu_torch.ops import overlap_collectives as oc

    tx, tw = (torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True) for a in (x, w))
    tdy = torch.from_numpy(np.ascontiguousarray(dy))
    out = oc.overlap_dense_matmul(tx, tw, shard_axis=shard_axis, ring=ring)
    dx, dw = torch.autograd.grad(out, (tx, tw), tdy)
    rs = oc.reduce_scatter_matmul(tx.detach(), tdy, shard_axis=shard_axis, ring=ring)
    return [out.detach().numpy(), dx.numpy(), dw.numpy(), rs.numpy()]


def _ring_result(ring, q, k, v, schedule):
    """Out and the gradients of sum(out²) for the tensors a ring holds."""
    from dtc_tpu_torch.ops import ring_attention as tra

    tq, tk, tv = (torch.from_numpy(np.ascontiguousarray(x)).requires_grad_(True)
                  for x in (q, k, v))
    out = tra.ring_causal_attention(tq, tk, tv, ring, schedule=schedule)
    grads = torch.autograd.grad((out ** 2).sum(), (tq, tk, tv))
    return [out.detach().numpy()] + [g.numpy() for g in grads]


# ---------------------------------------------------------------------------
# the worker (a process of the spawn)
# ---------------------------------------------------------------------------

def _worker(case: str, out_dir: str) -> None:
    from dtc_tpu_torch.config import schema as ts
    from dtc_tpu_torch.config.loader import _build
    from dtc_tpu_torch.ops import ring_attention as tra
    from dtc_tpu_torch.train.trainer import train
    from dtc_tpu_torch.utils import dist as dist_utils

    out = Path(out_dir)
    dist_utils.initialize("cpu")
    rank, world = dist_utils.rank(), dist_utils.world_size()
    if case == "ring":
        ring = tra.DistRing(range(world))
        for name, schedule, h, d in RING_CASES:
            shards = [x[:, rank * 64 // world:(rank + 1) * 64 // world]
                      for x in _ring_inputs(h, d)]
            np.savez(out / f"{name}_r{rank}.npz", *_ring_result(ring, *shards, schedule))
    if case == "fsdp":
        ring = tra.DistRing(range(world))
        for name, axis, k, n in OVERLAP_CASES:
            x, w, dy = _overlap_inputs(k, n)
            rows = slice(rank * 8 // world, (rank + 1) * 8 // world)
            chunk = np.split(w, world, axis=axis)[rank]
            np.savez(out / f"{name}_r{rank}.npz",
                     *_overlap_result(ring, x[rows], chunk, dy[rows], axis))
    spec = json.loads((out / "config.json").read_text())
    with open(out / "params.pkl", "rb") as f:
        params = pickle.load(f)
    train_cfg = _build(ts.TrainConfig, spec["train"], "train")
    runs = [("", train_cfg)]
    if case == "fsdp":
        runs.append(("_overlapped", dataclasses.replace(
            train_cfg, collectives="overlapped", output_dir=train_cfg.output_dir + "_overlapped")))
    for tag, cfg in runs:
        steps = _count_ring_steps()
        res = train(cfg, _build(ts.ModelConfig, spec["model"], "model"),
                    _build(ts.OptimConfig, spec["optim"], "optim"), device="cpu", params=params)
        (out / f"losses{tag}_r{rank}.json").write_text(json.dumps(res.losses))
        if case == "fsdp":
            report = dict(params=_shard_report(res, rank, world), ring_steps=steps())
            (out / f"shards{tag}_r{rank}.json").write_text(json.dumps(report))
            _fsdp_gradients(out / f"grads{tag}_r{rank}.npz", spec, params, tag, rank, world)
    if case in ("dp", "ring"):
        _dp_resume(out, spec, rank)
    if case == "dp":
        with open(out / f"lora_bf16_r{rank}.pkl", "wb") as f:
            pickle.dump(_lora_and_bf16_runs(spec, out / f"lora_bf16_r{rank}"), f)
    dist_utils.teardown()


def _lora_and_bf16_runs(spec: dict, out: Path) -> dict:
    """:func:`_lora_run` and :func:`_bf16_run` (a rank's or one process's)."""
    return dict(lora=_lora_run(spec, out), bf16=_bf16_run(spec, out))


def _lora_run(spec: dict, out: Path) -> dict:
    """The spawn's model as a LoRA finetune (rank 4 on all six sites, eval
    every 2 steps), 4 steps from the seed: losses, eval losses and the
    factors (float32 numpy)."""
    from dtc_tpu_torch.config import schema as ts
    from dtc_tpu_torch.config.loader import _build
    from dtc_tpu_torch.train.trainer import train

    lora = train(dataclasses.replace(_four_steps(spec), eval_every=2, eval_batches=1,
                                     output_dir=str(out / "lora")),
                 dataclasses.replace(_build(ts.ModelConfig, spec["model"], "model"),
                                     adapter=ts.AdapterConfig(rank=4, alpha=8.0)),
                 _build(ts.OptimConfig, spec["optim"], "optim"), device="cpu")
    return dict(losses=lora.losses, evals=lora.eval_losses,
                factors={k: v.detach().float().numpy() for k, v in lora.adapter.items()})


def _bf16_run(spec: dict, out: Path) -> dict:
    """The spawn's model under ``precision: bf16_mixed``, 4 steps from the
    seed: losses, the parameters' dtypes, the masters (float32 numpy)."""
    from dtc_tpu_torch.config import schema as ts
    from dtc_tpu_torch.config.loader import _build
    from dtc_tpu_torch.train.trainer import train

    bf16 = train(dataclasses.replace(_four_steps(spec), output_dir=str(out / "bf16")),
                 _build(ts.ModelConfig, spec["model"], "model"),
                 dataclasses.replace(_build(ts.OptimConfig, spec["optim"], "optim"),
                                     precision="bf16_mixed"), device="cpu")
    return dict(losses=bf16.losses,
                dtypes={n: str(p.dtype) for n, p in bf16.model.named_parameters()},
                masters=[m.detach().numpy().copy() for m in bf16.optimizer.masters])


def _four_steps(spec: dict):
    from dtc_tpu_torch.config import schema as ts
    from dtc_tpu_torch.config.loader import _build

    return dataclasses.replace(_build(ts.TrainConfig, spec["train"], "train"), steps=4,
                               warmup_steps=1, log_every=2)


def _step_as_two_ranks(model, opt, x, y, gen, fsdp=None, group=None, average=True,
                       lora=None):
    """``train_step`` as two DP ranks take it, in one process: each half of
    the batch (a rank's rows) its own forward and backward, the gradients
    and losses summed in their own dtype and halved (what gloo's sum and
    ``average_over_ranks``' division give: bfloat16 gradients stay
    bfloat16), then the clip and AdamW."""
    grads, losses = [], []
    for xs, ys in zip(x.chunk(2), y.chunk(2)):
        opt.zero_grad()
        loss = model(xs, train=True, targets=ys, generator=gen, lora=lora)
        loss.backward()
        grads.append([p.grad.clone() for p in opt.params])
        losses.append(loss.detach())
    for p, a, b in zip(opt.params, *grads):
        p.grad = (a + b) / 2
    opt.step()
    return (losses[0] + losses[1]) / 2


def _dp_resume(out: Path, spec: dict, rank: int) -> None:
    """The spawn's run (DP, or DP with ring attention) at dropout 0.1 with
    checkpoints and eval every 2 steps: 4 steps
    uninterrupted, then 2 steps and a resume to 4 from the step-2
    checkpoint (rank 0's model and optimizer, each rank's generator)."""
    from dtc_tpu_torch.config import schema as ts
    from dtc_tpu_torch.config.loader import _build
    from dtc_tpu_torch.train.trainer import train

    model = dataclasses.replace(_build(ts.ModelConfig, spec["model"], "model"), dropout=0.1)
    opt = _build(ts.OptimConfig, spec["optim"], "optim")
    base = _build(ts.TrainConfig, spec["train"], "train")

    def run(name, steps):
        cfg = dataclasses.replace(base, steps=steps, warmup_steps=1, checkpoint_every=2,
                                  eval_every=2, eval_batches=1,
                                  output_dir=str(out / f"resume_{name}"),
                                  checkpoint_dir=str(out / f"resume_{name}_ckpt"))
        res = train(cfg, model, opt, device="cpu")
        return dict(losses=res.losses, evals=res.eval_losses)

    report = dict(full=run("full", 4), part=run("part", 2), resumed=run("part", 4))
    (out / f"resume_r{rank}.json").write_text(json.dumps(report))


def _fsdp_batch(vocab: int, seq: int):
    return np.random.RandomState(7).randint(0, vocab, (8, seq + 1))


def _fsdp_gradients(path, spec, params, tag, rank, world):
    """One FSDP backward from the flax weights on this rank's rows of a
    fixed batch, reduced as the train step reduces it: this rank's
    gradients (shards or whole), the averaged loss, the clip's global
    norm and the FSDP ring's step calls (the ``_overlapped`` tag's model
    runs its dense sites through the ring)."""
    from dtc_tpu_torch.config import schema as ts
    from dtc_tpu_torch.config.loader import _build
    from dtc_tpu_torch.models.gpt import GPT
    from dtc_tpu_torch.ops import ring_attention as tra
    from dtc_tpu_torch.parallel.fsdp import FSDP, use_fsdp
    from dtc_tpu_torch.parity import from_flax
    from dtc_tpu_torch.train.optimizer import create_optimizer

    cfg = _build(ts.ModelConfig, spec["model"], "model")
    if tag:
        cfg = dataclasses.replace(cfg, collectives="overlapped")
    model = GPT(cfg, device="cpu")
    model.load_state_dict(from_flax(params, cfg))
    state = FSDP(tra.DistRing(range(world))).shard_(model)
    opt = create_optimizer(model.parameters(), _build(ts.OptimConfig, spec["optim"], "optim"),
                           3, fsdp=state)
    tokens = torch.from_numpy(_fsdp_batch(cfg.vocab_size, cfg.max_seq_len))
    rows = tokens[rank * 8 // world:(rank + 1) * 8 // world]
    steps = _count_ring_steps()
    with use_fsdp(state):
        loss = model(rows[:, :-1], train=True, targets=rows[:, 1:])
        loss.backward()
    ring_steps = steps()
    loss = state.reduce_gradients(opt.params, loss)
    norm = torch.linalg.vector_norm(opt._param_norms([p.grad for p in opt.params]))
    np.savez(path, loss=loss.detach().numpy(), norm=norm.numpy(), ring_steps=ring_steps,
             **{n: p.grad.numpy() for n, p in model.named_parameters()})


def _count_ring_steps():
    """Count the FSDP ring's step calls (the kernels' plain versions on the
    CPU) from now on; returns a function that stops counting and gives
    ``[all-gather-matmul steps, reduce-scatter steps]``."""
    from dtc_tpu_torch.ops import overlap_collectives as oc

    real, counts = (oc.ag_step, oc.rs_step), [0, 0]

    def counted(i):
        def step(*a, **k):
            counts[i] += 1
            return real[i](*a, **k)
        return step

    oc.ag_step, oc.rs_step = counted(0), counted(1)

    def stop():
        oc.ag_step, oc.rs_step = real
        return counts
    return stop


def _shard_report(res, rank, world):
    """Per parameter: (its shape, this rank's shard's shape, whether the
    shard is the gathered model's chunk bit for bit and the gathered
    model holds no gradient)."""
    from dtc_tpu_torch.parallel.sharding import param_shard_dim

    report = {}
    for (name, whole), shard in zip(res.model.named_parameters(), res.optimizer.params):
        d = param_shard_dim(name)
        want = whole if d is None else whole.chunk(world, d)[rank]
        report[name] = (list(whole.shape), list(shard.shape),
                        bool(torch.equal(want, shard)) and whole.grad is None)
    return report


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(world: int, case: str, out_dir: Path, script: str = __file__) -> None:
    """Run the worker of ``script`` (this file's by default) in ``world``
    processes with torchrun's environment."""
    port = str(_free_port())
    procs = []
    for rank in range(world):
        env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                   MASTER_ADDR="localhost", MASTER_PORT=port, OMP_NUM_THREADS="1",
                   PYTHONPATH=str(ROOT))
        procs.append(subprocess.Popen(
            [sys.executable, script, case, str(out_dir)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{log}"


# ---------------------------------------------------------------------------
# the tests (JAX in the test process only)
# ---------------------------------------------------------------------------

def _write_run(out_dir: Path, train_cfg, model_cfg, opt_cfg, params) -> None:
    import jax

    spec = {k: dataclasses.asdict(c) for k, c in
            (("train", train_cfg), ("model", model_cfg), ("optim", opt_cfg))}
    (out_dir / "config.json").write_text(json.dumps(spec))
    with open(out_dir / "params.pkl", "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)


def _flax_params(cfg):
    import jax
    import jax.numpy as jnp

    from dtc_tpu.models.gpt import GPT as JGPT

    return jax.jit(
        lambda r, x: JGPT(cfg).init({"params": r, "dropout": r}, x, train=False)
    )(jax.random.PRNGKey(0), jnp.ones((1, cfg.max_seq_len), jnp.int32))["params"]


def _check_losses(out_dir: Path, world: int, want, tag: str = "") -> None:
    losses = [json.loads((out_dir / f"losses{tag}_r{r}.json").read_text())
              for r in range(world)]
    assert all(lo == losses[0] for lo in losses), "the ranks logged different losses"
    np.testing.assert_allclose(losses[0], want, rtol=2e-4)
    rows = (out_dir / f"log{tag}" / "log.csv").read_text().splitlines()
    assert rows[0] == "step,elapsed_time,loss" and len(rows) == len(want) + 1
    np.testing.assert_allclose([float(r.split(",")[2]) for r in rows[1:]], losses[0],
                               rtol=1e-6)


def test_ring_transport_and_ring_training_over_four_gloo_processes(
        tmp_path, tiny_model_cfg, opt_cfg, train_cfg_factory):
    from dtc_tpu.config.schema import MeshConfig as JMesh
    from dtc_tpu.train.trainer import train as jtrain
    from dtc_tpu_torch.ops import ring_attention as tra

    ring_model = dataclasses.replace(tiny_model_cfg, attention="ring")
    want = jtrain(train_cfg_factory("3d", steps=3, log_every=1,
                                    mesh=JMesh(pipe=1, data=4, model=2)),
                  ring_model, opt_cfg).losses
    port_cfg = train_cfg_factory("3d", steps=3, log_every=1,
                                 mesh=JMesh(pipe=1, data=2, model=2),
                                 output_dir=str(tmp_path / "log"))
    port_cfg = dataclasses.replace(port_cfg, obs=dataclasses.replace(port_cfg.obs,
                                                                     enabled=False))
    # the same parameter tree as the dense model (JAX inits outside any mesh)
    _write_run(tmp_path, port_cfg, ring_model, opt_cfg, _flax_params(tiny_model_cfg))
    _spawn(4, "ring", tmp_path)

    for name, schedule, h, d in RING_CASES:
        want_ring = _ring_result(tra.InProcessRing(4), *_ring_inputs(h, d), schedule)
        got = [np.load(tmp_path / f"{name}_r{r}.npz") for r in range(4)]
        for j, label in enumerate(("out", "dq", "dk", "dv")):
            whole = np.concatenate([g[f"arr_{j}"] for g in got], axis=1)
            assert whole.tobytes() == want_ring[j].tobytes(), f"{name} {label}"
    _check_losses(tmp_path, 4, want)
    _check_resume(tmp_path, 4)


def _check_resume(out_dir: Path, world: int) -> None:
    """The resume of :func:`_dp_resume`: bit-equal to the uninterrupted
    run, on every rank, eval included."""
    reports = [json.loads((out_dir / f"resume_r{r}.json").read_text()) for r in range(world)]
    assert all(rep == reports[0] for rep in reports)
    rep = reports[0]
    assert rep["resumed"]["losses"] == rep["full"]["losses"][2:]
    assert rep["part"]["losses"] == rep["full"]["losses"][:2]
    assert rep["part"]["evals"] + rep["resumed"]["evals"] == rep["full"]["evals"]
    assert [s for s, _ in rep["full"]["evals"]] == [2, 4]


@pytest.fixture(scope="session")
def dp_spawn(tmp_path_factory):
    """The spawn of 2 processes under ``parallel: dp`` (the tiny model of
    ``tests/conftest.py``), once a session (the first xdist worker to ask,
    under a file lock); its directory."""
    from filelock import FileLock

    from dtc_tpu.config.schema import ModelConfig, OptimConfig
    from tests.conftest import make_train_cfg

    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    out = base / "dp_spawn"
    with FileLock(str(out) + ".lock"):
        if not (out / "done").exists():
            out.mkdir(exist_ok=True)
            model = ModelConfig(vocab_size=97, d_model=64, n_layers=4, n_heads=4, d_ff=128,
                                max_seq_len=32, dropout=0.0, param_dtype="float32",
                                compute_dtype="float32", attention="dense")
            # Telemetry on: every rank writes its shard, rank 0 the
            # cross-process summary.
            cfg = make_train_cfg("dp", steps=3, log_every=1, output_dir=str(out / "log"))
            _write_run(out, cfg, model, OptimConfig(lr=1e-3, weight_decay=0.1, grad_clip=1.0),
                       _flax_params(model))
            _spawn(2, "dp", out)
            (out / "done").write_text("")
    return out


def test_dp_training_over_two_gloo_processes_matches_jax(
        dp_spawn, tiny_model_cfg, opt_cfg, train_cfg_factory):
    from dtc_tpu.train.trainer import train as jtrain

    want = jtrain(train_cfg_factory("dp", steps=3, log_every=1), tiny_model_cfg,
                  opt_cfg).losses
    _check_losses(dp_spawn, 2, want)
    _check_resume(dp_spawn, 2)


def test_dp_telemetry_writes_every_ranks_shard_and_the_leads_summary(dp_spawn):
    """The DP spawn's run with telemetry on: one event shard per rank, each
    with its 3 ``step`` events and ``run_summary``; rank 0's shard ends with
    the ``hosts`` reduction over both ranks, which ``summary.json``
    holds; rank 1 writes no reduction."""
    from dtc_tpu_torch.obs import find_shards, read_jsonl

    obs = dp_spawn / "log" / "obs"
    shards = find_shards(str(obs))
    assert sorted(shards) == [0, 1]
    events = {r: read_jsonl(p) for r, p in shards.items()}
    for r, evs in events.items():
        assert [e["step"] for e in evs if e["etype"] == "step"] == [1, 2, 3]
        assert all(e["proc"] == r for e in evs)
        assert sum(e["etype"] == "run_summary" for e in evs) == 1
    assert not any(e["etype"] == "hosts" for e in events[1])
    hosts = events[0][-1]
    assert hosts["etype"] == "hosts" and hosts["n_hosts"] == 2
    assert sorted(hosts["hosts"]) == ["0", "1"]
    summary = json.loads((obs / "summary.json").read_text())
    assert summary["hosts"]["n_hosts"] == 2 and summary["summary"]["steps"] == 3


def test_dp_finetune_and_bf16_mixed_over_two_gloo_processes(dp_spawn, tmp_path, monkeypatch):
    """The LoRA finetune and bf16_mixed training under DP over 2 gloo
    ranks: the ranks agree bit for bit, and each run equals the port's
    one-process run within 1e-6 (rtol and atol): the finetune's losses,
    eval losses and factors (float32) against the whole batch in one
    process; bf16_mixed's losses and float32 masters against one process
    that takes each step as the two ranks do (:func:`_step_as_two_ranks`).
    Against the whole batch bf16_mixed cannot hold 1e-6: each rank's
    bfloat16 gradients of its half batch are averaged in bfloat16 (the JAX
    package keeps them bfloat16 on the wire too), and the whole batch's
    gradient rounds once (losses 3.4e-4 and masters 6.0e-3 apart at step
    4; against the two-rank reference both are 0)."""
    from dtc_tpu_torch.train import trainer

    spec = json.loads((dp_spawn / "config.json").read_text())
    ranks = [pickle.loads((dp_spawn / f"lora_bf16_r{r}.pkl").read_bytes()) for r in range(2)]
    one = dict(lora=_lora_run(spec, tmp_path))
    monkeypatch.setattr(trainer, "train_step", _step_as_two_ranks)
    one["bf16"] = _bf16_run(spec, tmp_path)
    for r in ranks[1:]:
        assert r["lora"]["losses"] == ranks[0]["lora"]["losses"]
        assert r["bf16"]["losses"] == ranks[0]["bf16"]["losses"]
        assert all(np.array_equal(a, b) for a, b in zip(r["bf16"]["masters"],
                                                        ranks[0]["bf16"]["masters"]))
    got = ranks[0]
    for kind in ("lora", "bf16"):
        np.testing.assert_allclose(got[kind]["losses"], one[kind]["losses"], rtol=1e-6,
                                   atol=1e-6, err_msg=kind)
    assert [s for s, _ in got["lora"]["evals"]] == [2, 4]
    np.testing.assert_allclose([v for _, v in got["lora"]["evals"]],
                               [v for _, v in one["lora"]["evals"]], rtol=1e-6)
    for k, v in one["lora"]["factors"].items():
        np.testing.assert_allclose(got["lora"]["factors"][k], v, rtol=1e-6, atol=1e-6, err_msg=k)
    assert got["bf16"]["dtypes"] == one["bf16"]["dtypes"]
    assert set(one["bf16"]["dtypes"].values()) == {"torch.bfloat16", "torch.float32"}
    assert len(got["bf16"]["masters"]) == len(one["bf16"]["masters"]) > 0
    for i, (a, b) in enumerate(zip(got["bf16"]["masters"], one["bf16"]["masters"])):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=f"master {i}")


def test_fsdp_over_four_gloo_processes_matches_jax(
        tmp_path, tiny_model_cfg, opt_cfg, train_cfg_factory):
    from dtc_tpu.train.trainer import train as jtrain
    from dtc_tpu_torch.ops import ring_attention as tra
    from dtc_tpu_torch.parallel.sharding import param_shard_dim

    want = {tag: jtrain(train_cfg_factory("fsdp", steps=3, log_every=1, collectives=mode),
                        tiny_model_cfg, opt_cfg).losses
            for tag, mode in (("", "xla"), ("_overlapped", "overlapped"))}
    port_cfg = train_cfg_factory("fsdp", steps=3, log_every=1, output_dir=str(tmp_path / "log"))
    port_cfg = dataclasses.replace(port_cfg, obs=dataclasses.replace(port_cfg.obs,
                                                                     enabled=False))
    _write_run(tmp_path, port_cfg, tiny_model_cfg, opt_cfg, _flax_params(tiny_model_cfg))
    _spawn(4, "fsdp", tmp_path)

    for name, axis, k, n in OVERLAP_CASES:
        want_ring = _overlap_result(tra.InProcessRing(4), *_overlap_inputs(k, n), axis)
        got = [np.load(tmp_path / f"{name}_r{r}.npz") for r in range(4)]
        for j, (label, cat_axis) in enumerate((("out", 0), ("dx", 0), ("dw", axis),
                                               ("reduce_scatter", axis))):
            whole = np.concatenate([g[f"arr_{j}"] for g in got], axis=cat_axis)
            assert whole.tobytes() == want_ring[j].tobytes(), f"{name} {label}"
    # The reduced gradients (gathered from the ranks' shards), loss and
    # clip norm against one process's on the whole batch: the 1/R applied
    # once, the whole parameters averaged, the norm over the shards.
    from dtc_tpu_torch.config import schema as ts
    from dtc_tpu_torch.config.loader import _build
    from dtc_tpu_torch.models.gpt import GPT
    from dtc_tpu_torch.parity import from_flax, gather_shards

    cfg = _build(ts.ModelConfig, dataclasses.asdict(tiny_model_cfg), "model")
    model = GPT(cfg, device="cpu")
    model.load_state_dict(from_flax(_flax_params(tiny_model_cfg), cfg))
    tokens = torch.from_numpy(_fsdp_batch(cfg.vocab_size, cfg.max_seq_len))
    loss = model(tokens[:, :-1], train=True, targets=tokens[:, 1:])
    loss.backward()
    norm = torch.linalg.vector_norm(torch.stack([p.grad.norm() for p in model.parameters()]))
    # A rank's ring steps in a step: 6 dense sites of every layer, R steps
    # forward and R for dx (all-gather-matmul), R for dw (reduce-scatter).
    calls = tiny_model_cfg.n_layers * 6
    for tag in want:
        got = [dict(np.load(tmp_path / f"grads{tag}_r{r}.npz")) for r in range(4)]
        for g in got:
            assert g["ring_steps"].tolist() == ([calls * 8, calls * 4] if tag else [0, 0]), tag
        np.testing.assert_allclose(got[0]["loss"], loss.item(), rtol=1e-6)
        np.testing.assert_allclose(got[0]["norm"], norm.item(), rtol=1e-5)
        grads = gather_shards([{n: torch.from_numpy(g[n]) for n, _ in model.named_parameters()}
                               for g in got])
        for n, p in model.named_parameters():
            np.testing.assert_allclose(grads[n].numpy(), p.grad.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{tag} {n}")

    for tag in want:
        _check_losses(tmp_path, 4, want[tag], tag)
        for r in range(4):
            report = json.loads((tmp_path / f"shards{tag}_r{r}.json").read_text())
            assert report["ring_steps"] == ([3 * calls * 8, 3 * calls * 4] if tag
                                            else [0, 0]), tag
            for pname, (whole, shard, equal) in report["params"].items():
                d = param_shard_dim(pname)
                quarter = list(whole) if d is None else [
                    s // 4 if i == d else s for i, s in enumerate(whole)]
                assert shard == quarter and equal, (tag, r, pname, whole, shard, equal)


def test_ring_under_pipeline_parallelism_raises(tiny_model_cfg, opt_cfg, train_cfg_factory):
    """As JAX's trainer: ValueError naming the pipeline, before any mesh."""
    from dtc_tpu_torch.config import schema as ts
    from dtc_tpu_torch.config.loader import _build
    from dtc_tpu_torch.train.trainer import train

    cfg = train_cfg_factory("3d", steps=1, pp_microbatches=2,
                            mesh=ts.MeshConfig(pipe=2, data=2, model=2))
    port = lambda cls, c: _build(cls, dataclasses.asdict(c), "test")
    with pytest.raises(ValueError, match="pipeline"):
        train(port(ts.TrainConfig, cfg),
              port(ts.ModelConfig, dataclasses.replace(tiny_model_cfg, attention="ring")),
              port(ts.OptimConfig, opt_cfg), device="cpu")


@pytest.mark.parametrize("parallel,mesh,n,layers", [
    ("dp", (0, 0, 0), 8, None), ("tp", (0, 0, 0), 8, None), ("3d", (1, 2, 4), 8, None),
    ("dp", (0, 0, 2), 8, None), ("pp", (0, 0, 0), 8, 4), ("3d", (2, 2, 2), 8, 4),
    ("dp", (1, 1, 1), 1, None), ("3d", (1, 2, 2), 8, None), ("dp", (0, 3, 0), 8, None),
])
def test_resolve_mesh_shape_matches_jax(parallel, mesh, n, layers):
    """The port's copy of ``resolve_mesh_shape``: the JAX package's shape,
    or its ValueError."""
    from dtc_tpu.config.schema import MeshConfig as JMesh
    from dtc_tpu.parallel.mesh import resolve_mesh_shape as jresolve
    from dtc_tpu_torch.config.schema import MeshConfig
    from dtc_tpu_torch.parallel.mesh import resolve_mesh_shape

    try:
        want = jresolve(parallel, n, JMesh(*mesh), n_layers=layers)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            resolve_mesh_shape(parallel, n, MeshConfig(*mesh), n_layers=layers)
        return
    assert resolve_mesh_shape(parallel, n, MeshConfig(*mesh), n_layers=layers) == want


@pytest.mark.parametrize("shape", [(1, 2, 4), (1, 4, 2), (2, 2, 2), (1, 8, 1)])
def test_rank_coordinates_follow_the_jax_mesh_device_order(shape):
    from dtc_tpu.config.schema import MeshConfig as JMesh
    from dtc_tpu.parallel.mesh import mesh_from_config
    from dtc_tpu_torch.parallel.mesh import coords

    mesh = mesh_from_config("3d", JMesh(*shape))
    ids = np.vectorize(lambda dev: dev.id)(mesh.devices)
    for rank in range(8):
        assert ids[coords(rank, shape)] == rank


def test_gradient_average_reduces_the_dtypes_in_one_order(monkeypatch):
    """``average_over_ranks`` under mixed dtypes (bf16_mixed's bfloat16
    gradients beside the float32 LayerNorms' and the loss): one all-reduce
    a dtype in the order of their names, the same on every rank (a set of
    dtypes iterates by hash, which differs between processes: the ranks'
    reductions then paired up wrongly and gloo aborted); the averages
    land in each gradient and the loss."""
    import torch.distributed as dist

    from dtc_tpu_torch.train.train_step import average_over_ranks

    seen = []
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "all_reduce",
                        lambda t, group=None: seen.append(t.dtype) or t.mul_(2))
    params = [torch.zeros(3, dtype=dt, requires_grad=True)
              for dt in (torch.bfloat16, torch.float32, torch.bfloat16, torch.float16)]
    for i, p in enumerate(params):
        p.grad = torch.full_like(p, float(i + 1))
    loss = average_over_ranks(params, torch.tensor(5.0))
    assert seen == sorted({torch.bfloat16, torch.float32, torch.float16}, key=str)
    assert float(loss) == 5.0
    assert all(torch.equal(p.grad, torch.full_like(p, float(i + 1)))
               for i, p in enumerate(params))


def test_failed_rendezvous_raises(monkeypatch):
    """torchrun's environment asks for 2 processes; the other never comes:
    the rank raises instead of training alone."""
    from dtc_tpu_torch.utils import dist as dist_utils

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setattr(dist_utils, "TIMEOUT_S", 2)
    with pytest.raises(RuntimeError, match="does not train alone"):
        dist_utils.initialize("cpu")
    assert not torch.distributed.is_initialized()
    assert dist_utils.world_size() == 1 and dist_utils.is_lead_process()


@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
def test_nccl_with_two_ranks_on_one_card_raises(monkeypatch, device):
    """Two ranks of one host and one card: NCCL refuses two ranks on one
    device, so asking for it raises and names gloo, before any rendezvous."""
    from dtc_tpu_torch.utils import dist as dist_utils

    for key, value in dict(WORLD_SIZE="2", RANK="0", LOCAL_RANK="0", LOCAL_WORLD_SIZE="2",
                           MASTER_ADDR="localhost", MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="backend='gloo'"):
        dist_utils.initialize(device, "nccl")
    assert not torch.distributed.is_initialized()


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
