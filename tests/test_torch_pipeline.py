"""Megatron tensor parallelism and pipeline parallelism in the port, over
gloo processes on the CPU, against the JAX package on its 8-device CPU mesh
(the same flax weights and synthetic batches, dropout 0, float32).

- One spawn of 4 processes (the worker is this file run as a script; it
  imports no JAX), shared by the tests below through a session fixture that
  runs it once even under xdist: the trainer for 4 steps under TP (data 2
  × model 2), GPipe, 1F1B at V 1 and V 2 (pipe 2 × data 2, 2 microbatches)
  and PP × TP (pipe 2 × model 2); each run's losses against JAX's
  ``train()`` in the same ``parallel`` / ``pp_schedule`` /
  ``pp_virtual_stages`` (JAX's data axis is larger, its global batch the
  same) at JAX's tolerances (``tests/test_train_parity.py``: 2e-4 for TP,
  5e-4 for PP), and the parameters after the steps, gathered back through
  ``parity.gather_tp`` / ``gather_stages``, against JAX's
  (``pp_unstack_params``) at JAX's 3e-4. Then TP at dropout 0.1: the
  replicated parameters stay bit-equal across each model group (the
  dropout generator is seeded per (pipe, data) coordinate, the same across
  the model group), and the vocab-parallel head + CE over a model group of
  2 against JAX's ``fused_head_ce``, loss and gradients, with targets on
  both ranks and inside the pad's rank, in one chunk and in 7-row chunks.
  In the same spawn, FSDP on a (data 2, model 2) mesh: DP×FSDP×TP under
  ``xla`` and ``overlapped`` and FSDP with ring attention, against JAX's
  ``train()`` (3D on data 4 × model 2, ``overlapped``; the ring on data 2 ×
  model 4) at JAX's 5e-4 on losses and 3e-4 on the parameters gathered by
  ``parity.gather_mesh``, the first step's reduced gradients and clip norm
  against one process's, the ring's step counts; and a ``DistRing``
  exchange that takes its tensors for CUDA tensors under gloo (through
  host buffers).
- Pure Python: the port's ``simulate_interleaved`` / ``simulate_1f1b``
  tables equal JAX's over a grid of (M, S, V); GPipe's table; the stage
  layout equals ``pp_stack_params``; ``pp_stage`` / ``tp_shards`` and
  their gathers; the Megatron dims against JAX's ``param_specs``;
  ``train_memory_bytes`` on TP and PP meshes against JAX's; under
  FSDP_RULES and the ring's rules every parameter's spec against JAX's,
  ``mesh_shards`` / ``gather_mesh``, ``check_fsdp``, and the FSDP metrics
  on (data, model) meshes against JAX's.
"""

import dataclasses
import json
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_dist import _count_ring_steps, _flax_params, _spawn, _write_run

#: The spawn's training runs: (name, the port's train-config overrides,
#: JAX's overrides on its 8 devices, loss tolerance).
RUNS = (
    ("tp", dict(parallel="dp", mesh=(1, 0, 2)), dict(parallel="dp", mesh=(0, 0, 2)), 2e-4),
    ("gpipe", dict(parallel="pp", pp_microbatches=2, mesh=(2, 2, 1)),
     dict(parallel="pp", pp_microbatches=2, mesh=(2, 4, 1)), 5e-4),
    ("1f1b", dict(parallel="pp", pp_microbatches=2, pp_schedule="1f1b", mesh=(2, 2, 1)),
     dict(parallel="pp", pp_microbatches=2, pp_schedule="1f1b", mesh=(2, 4, 1)), 5e-4),
    ("1f1b_v2", dict(parallel="pp", pp_microbatches=2, pp_schedule="1f1b",
                     pp_virtual_stages=2, mesh=(2, 2, 1)),
     dict(parallel="pp", pp_microbatches=2, pp_schedule="1f1b", pp_virtual_stages=2,
          mesh=(2, 4, 1)), 5e-4),
    ("pp_tp", dict(parallel="3d", pp_microbatches=2, mesh=(2, 1, 2)),
     dict(parallel="3d", pp_microbatches=2, mesh=(2, 2, 2)), 5e-4),
)
#: The spawn's FSDP runs on a (pipe 1, data 2, model 2) mesh: (name, the
#: port's train-config overrides, its model-config overrides, the JAX
#: oracle they are held to). DP×FSDP×TP under both collectives, and FSDP
#: with ring attention over the model axis.
FSDP_RUNS = (
    ("3d_xla", dict(parallel="fsdp", mesh=(1, 2, 2)), {}, "3d"),
    ("3d_overlapped", dict(parallel="fsdp", collectives="overlapped", mesh=(1, 2, 2)), {}, "3d"),
    ("fsdp_ring", dict(parallel="fsdp", mesh=(1, 2, 2)), dict(attention="ring"), "ring"),
)
#: JAX's ``train()`` on its 8 devices for each oracle: (train overrides,
#: model overrides). The two 3D runs share JAX's ``overlapped`` one (JAX's
#: own test holds ``xla`` and ``overlapped`` to the same losses); the
#: global batch is the same, so the losses are.
JAX_FSDP = {"3d": (dict(parallel="fsdp", collectives="overlapped", mesh=(0, 4, 2)), {}),
            "ring": (dict(parallel="fsdp", mesh=(0, 2, 4)), dict(attention="ring"))}
STEPS = 4
CE_ROWS, CE_D, CE_VOCAB = 24, 16, 97     # padded to 128: rank 1 holds 64..127


def _ce_inputs():
    rng = np.random.RandomState(11)
    h = rng.randn(2, CE_ROWS // 2, CE_D).astype(np.float32)
    w = (0.2 * rng.randn(CE_D, 128)).astype(np.float32)        # flax (in, out)
    b = (0.1 * rng.randn(128)).astype(np.float32)
    y = rng.randint(0, CE_VOCAB, size=(2, CE_ROWS // 2)).astype(np.int32)
    y[0, :3] = (5, 70, 96)            # rank 0's columns, and two in the pad's rank
    return h, w, b, y


# ---------------------------------------------------------------------------
# the worker (a process of the spawn)
# ---------------------------------------------------------------------------

def _worker(case: str, out_dir: str) -> None:
    from dtc_tpu_torch.config import schema as ts
    from dtc_tpu_torch.config.loader import _build
    from dtc_tpu_torch.utils import dist as dist_utils

    out = Path(out_dir)
    dist_utils.initialize("cpu")
    rank = dist_utils.rank()
    _vocab_parallel_ce(out, rank)
    spec = json.loads((out / "config.json").read_text())
    with open(out / "params.pkl", "rb") as f:
        params = pickle.load(f)
    from dtc_tpu_torch.train.trainer import train

    model_spec = spec["model"]
    _staged_exchange(out, rank)
    runs = [(name, over, {}) for name, over, _, _ in RUNS]
    runs += [("tp_dropout", RUNS[0][1], dict(dropout=0.1))]
    runs += [(name, over, model_over) for name, over, model_over, _ in FSDP_RUNS]
    for name, over, model_over in runs:
        over = dict(over, mesh=ts.MeshConfig(*over["mesh"]))
        cfg = _build(ts.TrainConfig, spec["train"], "train")
        cfg = dataclasses.replace(cfg, output_dir=str(out / f"log_{name}"), **over)
        mcfg = _build(ts.ModelConfig, dict(model_spec, **model_over), "model")
        fsdp_run = name in {r[0] for r in FSDP_RUNS}
        if fsdp_run:
            first, steps = _record_first_step(), _count_ring_steps()
        res = train(cfg, mcfg, _build(ts.OptimConfig, spec["optim"], "optim"), device="cpu",
                    params=params)
        (out / f"losses_{name}_r{rank}.json").write_text(json.dumps(res.losses))
        np.savez(out / f"params_{name}_r{rank}.npz",
                 **{k: v.detach().numpy() for k, v in res.model.state_dict().items()})
        if fsdp_run:
            # this rank's shards after the steps, its first step's reduced
            # gradients (shards) and clip norm, and its ring steps
            names = [n for n, _ in res.model.named_parameters()]
            grads, norm = first()
            np.savez(out / f"shards_{name}_r{rank}.npz",
                     **{n: p.detach().numpy() for n, p in zip(names, res.optimizer.params)})
            np.savez(out / f"grads_{name}_r{rank}.npz", norm=norm, ring_steps=steps(),
                     **{n: g.numpy() for n, g in zip(names, grads)})
    dist_utils.teardown()


def _record_first_step():
    """Record the gradients the optimizer's first ``step`` sees (reduced
    as the train step reduces them) and the clip's global norm; returns a
    function that stops recording and gives ``(gradients, norm)``."""
    from dtc_tpu_torch.train.optimizer import ClippedAdamW

    real, seen = ClippedAdamW.step, {}

    def step(self):
        if not seen:
            grads = [p.grad for p in self.params]
            seen["grads"] = [g.detach().clone() for g in grads]
            seen["norm"] = float(torch.linalg.vector_norm(self._param_norms(grads)))
        return real(self)

    ClippedAdamW.step = step

    def stop():
        ClippedAdamW.step = real
        return seen["grads"], seen["norm"]
    return stop


def _staged_exchange(out: Path, rank: int) -> None:
    """A ``DistRing`` exchange over the 4 ranks with every tensor taken for
    a CUDA tensor under gloo (``_host_staged`` answers yes): a chunk sent
    right and a non-contiguous one kept home. Records which tensors were
    asked about, the transfers in flight and the tensors staged when
    ``start`` returned, and whether what arrived equals the unstaged
    exchange's result."""
    from dtc_tpu_torch.ops import ring_attention as tra
    from dtc_tpu_torch.utils import dist as dist_utils

    ring = tra.DistRing(range(4))
    x = torch.arange(12.0).reshape(3, 4) + 100 * rank
    right, home = tuple((i + 1) % 4 for i in range(4)), tuple(range(4))
    (plain,) = ring.exchange((right,), [x])
    asked, real = [], dist_utils._host_staged
    dist_utils._host_staged = lambda t, group=None: asked.append(list(t.shape)) or True
    try:
        pending = ring.start((right, home), [x, x.t()])
        in_flight, staged = len(pending._works), len(pending._staged)
        got = pending.wait()
    finally:
        dist_utils._host_staged = real
    (out / f"staged_r{rank}.json").write_text(json.dumps(dict(
        asked=asked, in_flight=in_flight, staged=staged,
        equal=[torch.equal(got[0], plain), torch.equal(got[1], x.t())])))


def _vocab_parallel_ce(out: Path, rank: int) -> None:
    """The vocab-parallel head + CE over the model groups of a (1, 2, 2)
    mesh (ranks 0-1 and 2-3 compute the same case), in one chunk and in
    7-row chunks: the loss, dh (reduced by ``copy_to_model``'s backward),
    and this rank's columns of dW and db."""
    from dtc_tpu_torch.ops import fused_ce
    from dtc_tpu_torch.parallel.mesh import Mesh
    from dtc_tpu_torch.parallel.tensor import TensorParallel, copy_to_model

    mesh = Mesh((1, 2, 2), rank)
    tp = TensorParallel(mesh.model_ranks, mesh.model_group)
    h, w, b, y = _ce_inputs()
    cols = slice(tp.index * 64, (tp.index + 1) * 64)
    results = {}
    for tag, rows in (("whole", fused_ce.CE_CHUNK_ROWS), ("chunks", 7)):
        real, fused_ce.CE_CHUNK_ROWS = fused_ce.CE_CHUNK_ROWS, rows
        try:
            th = torch.tensor(h, requires_grad=True)
            tw = torch.tensor(w.T[cols].copy(), requires_grad=True)
            tb = torch.tensor(b[cols].copy(), requires_grad=True)
            loss = fused_ce.fused_head_ce(copy_to_model(th, tp), tw, tb, torch.from_numpy(y),
                                          CE_VOCAB, tp)
            loss.backward()
        finally:
            fused_ce.CE_CHUNK_ROWS = real
        results.update({f"{tag}_loss": loss.detach().numpy(), f"{tag}_dh": th.grad.numpy(),
                        f"{tag}_dw": tw.grad.numpy(), f"{tag}_db": tb.grad.numpy()})
    np.savez(out / f"ce_r{rank}.npz", **results)


# ---------------------------------------------------------------------------
# the spawn, once a session (a lock shares it among xdist's workers)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="session")
def spawned(tmp_path_factory):
    """The spawn's output directory. Under xdist every worker's basetemp
    lies in one session directory, so the first worker to get here runs
    the spawn under a file lock and the others read its results."""
    from filelock import FileLock

    from dtc_tpu.config.schema import OptimConfig

    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    out = base / "torch_tp_pp_spawn"
    with FileLock(str(out) + ".lock"):
        if not (out / "done").exists():
            out.mkdir(exist_ok=True)
            model_cfg = _tiny_cfg()
            from tests.conftest import make_train_cfg

            train_cfg = make_train_cfg("dp", steps=STEPS, log_every=1, output_dir="x")
            train_cfg = dataclasses.replace(
                train_cfg, obs=dataclasses.replace(train_cfg.obs, enabled=False))
            _write_run(out, train_cfg, model_cfg,
                       OptimConfig(lr=1e-3, weight_decay=0.1, grad_clip=1.0),
                       _flax_params(model_cfg))
            _spawn(4, "tp_pp", out, script=__file__)
            (out / "done").write_text("")
    return out


def _gathered(out: Path, name: str, shape, virtual: int):
    """The whole parameters of run ``name`` from its ranks' slices: the
    model ranks of data rank 0, stage by stage."""
    from dtc_tpu_torch.parallel.mesh import rank_of
    from dtc_tpu_torch.parity import gather_stages, gather_tp

    def load(rank):
        return {k: torch.from_numpy(v) for k, v in
                np.load(out / f"params_{name}_r{rank}.npz").items()}

    p, _, m = shape
    stages = [gather_tp([load(rank_of((s, 0, i), shape)) for i in range(m)])
              for s in range(p)]
    return stages[0] if p == 1 else gather_stages(stages, virtual)


@pytest.mark.parametrize("run", [r[0] for r in RUNS])
def test_tp_and_pp_training_match_jax(spawned, run, tiny_model_cfg, opt_cfg, train_cfg_factory):
    import jax

    from dtc_tpu.config.schema import MeshConfig as JMesh
    from dtc_tpu.parallel.pipeline import pp_unstack_params
    from dtc_tpu.train.trainer import train as jtrain
    from dtc_tpu_torch.config import schema as ts
    from dtc_tpu_torch.parallel.mesh import resolve_mesh_shape
    from dtc_tpu_torch.parity import from_flax

    _, over, jover, tol = next(r for r in RUNS if r[0] == run)
    jres = jtrain(train_cfg_factory(steps=STEPS, log_every=1,
                                    **dict(jover, mesh=JMesh(*jover["mesh"]))),
                  tiny_model_cfg, opt_cfg)
    losses = [json.loads((spawned / f"losses_{run}_r{r}.json").read_text()) for r in range(4)]
    assert all(lo == losses[0] for lo in losses), "the ranks logged different losses"
    np.testing.assert_allclose(losses[0], jres.losses, rtol=tol, atol=tol)
    rows = (spawned / f"log_{run}" / "log.csv").read_text().splitlines()
    assert rows[0] == "step,elapsed_time,loss" and len(rows) == STEPS + 1

    shape = resolve_mesh_shape(over["parallel"], 4, ts.MeshConfig(*over["mesh"]),
                               n_layers=tiny_model_cfg.n_layers)
    virtual = over.get("pp_virtual_stages", 1)
    got = _gathered(spawned, run, shape, virtual)
    jparams = jax.device_get(jres.state.params)
    if shape[0] > 1:
        jparams = pp_unstack_params(jparams, virtual)
    want = from_flax(jax.tree.map(np.asarray, jparams), tiny_model_cfg)
    assert got.keys() == want.keys()
    for name, w in want.items():
        # JAX's own limit for parameters after steps (test_train_parity).
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=3e-4, err_msg=name)


def test_tp_dropout_keeps_replicated_parameters_bit_equal(spawned):
    """At dropout 0.1 the ranks of a model group draw the same masks (the
    generator is seeded per (pipe, data) coordinate), so after 4 steps
    the parameters TP replicates are bit-equal across each model group
    (the trainer checks it too, and raises otherwise), while the two data
    ranks drew different masks from each other."""
    from dtc_tpu_torch.parallel.sharding import tp_shard_dim

    params = [np.load(spawned / f"params_tp_dropout_r{r}.npz") for r in range(4)]
    replicated = [n for n in params[0].files if tp_shard_dim(n) is None]
    assert "embed.wte.weight" in replicated and "head.ln_f.bias" in replicated
    for a, b in ((0, 1), (2, 3)):           # the model groups of the (1, 2, 2) mesh
        for n in replicated:
            assert params[a][n].tobytes() == params[b][n].tobytes(), n
    losses = json.loads((spawned / "losses_tp_dropout_r0.json").read_text())
    dense = json.loads((spawned / "losses_tp_r0.json").read_text())
    assert all(np.isfinite(losses)) and losses != dense


def test_vocab_parallel_ce_over_two_ranks_matches_jax(spawned):
    import jax
    import jax.numpy as jnp

    from dtc_tpu.ops.fused_ce import fused_head_ce as jfused_head_ce

    h, w, b, y = _ce_inputs()
    jloss, (jdh, jdw, jdb) = jax.value_and_grad(
        lambda h, w, b: jfused_head_ce(h, w, b, jnp.asarray(y), CE_VOCAB), argnums=(0, 1, 2)
    )(jnp.asarray(h), jnp.asarray(w), jnp.asarray(b))
    got = [np.load(spawned / f"ce_r{r}.npz") for r in range(4)]
    for tag in ("whole", "chunks"):
        for g in got:
            np.testing.assert_allclose(g[f"{tag}_loss"], jloss, atol=1e-5, rtol=0)
            np.testing.assert_allclose(g[f"{tag}_dh"], jdh,
                                       atol=1e-5 * max(float(np.abs(jdh).max()), 1.0))
        dw = np.concatenate([got[0][f"{tag}_dw"], got[1][f"{tag}_dw"]]).T
        db = np.concatenate([got[0][f"{tag}_db"], got[1][f"{tag}_db"]])
        np.testing.assert_allclose(dw, jdw, atol=1e-5 * max(float(np.abs(jdw).max()), 1.0))
        np.testing.assert_allclose(db, jdb, atol=1e-5 * max(float(np.abs(jdb).max()), 1.0))
        assert float(np.abs(db[CE_VOCAB:]).max()) == 0.0    # pad columns get nothing


# ---------------------------------------------------------------------------
# FSDP on a (data, model) mesh: DP×FSDP×TP and FSDP with ring attention
# ---------------------------------------------------------------------------

def _tiny_cfg(**over):
    from dtc_tpu.config.schema import ModelConfig

    return ModelConfig(**dict(dict(vocab_size=97, d_model=64, n_layers=4, n_heads=4, d_ff=128,
                                   max_seq_len=32, dropout=0.0, param_dtype="float32",
                                   compute_dtype="float32", attention="dense"), **over))


@pytest.fixture(scope="session")
def jax_fsdp(tmp_path_factory):
    """JAX's ``train()`` for an oracle of :data:`JAX_FSDP`, run once a
    session (by the first xdist worker to ask, under a file lock): a
    function of the oracle's tag giving its losses and its parameters
    after the steps as a ``from_flax`` state."""
    from filelock import FileLock

    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent

    def get(tag):
        out = base / f"jax_fsdp_{tag}"
        with FileLock(str(out) + ".lock"):
            if not (out / "done").exists():
                import jax

                from dtc_tpu.config.schema import MeshConfig as JMesh
                from dtc_tpu.config.schema import OptimConfig
                from dtc_tpu.train.trainer import train as jtrain
                from dtc_tpu_torch.parity import from_flax
                from tests.conftest import make_train_cfg

                over, model_over = JAX_FSDP[tag]
                cfg = _tiny_cfg(**model_over)
                res = jtrain(make_train_cfg(steps=STEPS, log_every=1,
                                            **dict(over, mesh=JMesh(*over["mesh"]))),
                             cfg, OptimConfig(lr=1e-3, weight_decay=0.1, grad_clip=1.0))
                out.mkdir(exist_ok=True)
                state = from_flax(jax.tree.map(np.asarray, jax.device_get(res.state.params)),
                                  cfg)
                np.savez(out / "params.npz", **{k: v.numpy() for k, v in state.items()})
                (out / "losses.json").write_text(json.dumps(res.losses))
                (out / "done").write_text("")
        return (json.loads((out / "losses.json").read_text()),
                {k: torch.from_numpy(v) for k, v in np.load(out / "params.npz").items()})
    return get


def _one_process_first_step(spawned, model_over):
    """The port's first step in one process on the spawn's weights and
    global batch: the gradients the optimizer sees and the clip's norm."""
    from dtc_tpu_torch.config import schema as ts
    from dtc_tpu_torch.config.loader import _build
    from dtc_tpu_torch.train.trainer import train

    spec = json.loads((spawned / "config.json").read_text())
    with open(spawned / "params.pkl", "rb") as f:
        params = pickle.load(f)
    cfg = dataclasses.replace(_build(ts.TrainConfig, spec["train"], "train"), steps=1,
                              output_dir="")
    first = _record_first_step()
    res = train(cfg, _build(ts.ModelConfig, dict(spec["model"], **model_over), "model"),
                _build(ts.OptimConfig, spec["optim"], "optim"), device="cpu", params=params)
    grads, norm = first()
    return dict(zip([n for n, _ in res.model.named_parameters()], grads)), norm


@pytest.mark.parametrize("run", [r[0] for r in FSDP_RUNS])
def test_fsdp_on_a_data_model_mesh_matches_jax(spawned, jax_fsdp, run):
    """DP×FSDP×TP (``xla`` and ``overlapped``) and FSDP with ring attention
    over 4 gloo ranks (data 2 × model 2) against JAX's ``train()`` (3D:
    data 4 × model 2 ``overlapped``; ring: data 2 × model 4): the losses
    within JAX's 5e-4, every rank's shards the shape ``parity.mesh_shards``
    cuts, the parameters after the steps (each rank's shards gathered by
    ``parity.gather_mesh``) within JAX's 3e-4, the replicated shards
    bit-equal across each model group. The first step's reduced gradients
    (gathered) and clip norm against one process's on the whole batch
    (AdamW hides a wrong gradient scale from the losses), and the ring's
    steps: 2R all-gather-matmul and R reduce-scatter steps at each of the
    24 dense sites a step under ``overlapped`` (every site on the ring),
    none otherwise."""
    from dtc_tpu_torch.parallel.sharding import tp_shard_dim
    from dtc_tpu_torch.parity import gather_mesh, mesh_shards

    _, _, model_over, oracle = next(r for r in FSDP_RUNS if r[0] == run)
    want_losses, want = jax_fsdp(oracle)
    losses = [json.loads((spawned / f"losses_{run}_r{r}.json").read_text()) for r in range(4)]
    assert all(lo == losses[0] for lo in losses), "the ranks logged different losses"
    np.testing.assert_allclose(losses[0], want_losses, rtol=5e-4, atol=5e-4)
    rows = (spawned / f"log_{run}" / "log.csv").read_text().splitlines()
    assert rows[0] == "step,elapsed_time,loss" and len(rows) == STEPS + 1

    def load(kind, rank):
        return {k: torch.from_numpy(v) for k, v in
                np.load(spawned / f"{kind}_{run}_r{rank}.npz").items()}

    n_model = 1 if model_over.get("attention") == "ring" else 2
    shards = [[load("shards", 2 * d + m) for m in range(2)] for d in range(2)]
    for d in range(2):
        for m in range(2):
            cut = mesh_shards(want, d, 2, m % n_model, n_model)
            assert {k: tuple(v.shape) for k, v in shards[d][m].items()} == \
                {k: tuple(v.shape) for k, v in cut.items()}, (d, m)
        for name, x in shards[d][0].items():
            if n_model == 1 or tp_shard_dim(name) is None:
                assert torch.equal(x, shards[d][1][name]), (d, name)
    got = gather_mesh([row[:n_model] for row in shards])
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=3e-4, err_msg=name)

    ref, ref_norm = _one_process_first_step(spawned, model_over)
    grads = [[load("grads", 2 * d + m) for m in range(2)] for d in range(2)]
    steps = [0, 0]
    if run == "3d_overlapped":
        steps = [STEPS * 4 * 6 * 2 * 2, STEPS * 4 * 6 * 2]
    for row in grads:
        for g in row:
            assert g.pop("ring_steps").tolist() == steps
            np.testing.assert_allclose(float(g.pop("norm")), ref_norm, rtol=1e-5)
    whole = gather_mesh([row[:n_model] for row in grads])
    for name, g in ref.items():
        np.testing.assert_allclose(whole[name].numpy(), g.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_dist_ring_stages_cuda_tensors_through_host_buffers(spawned):
    """Gloo moves CUDA tensors only in collectives: a ``DistRing`` exchange
    of a tensor that travels under gloo from a card asks ``_host_staged``,
    sends a host copy and copies what arrives back at ``wait()``, with the
    transfers already in flight when ``start`` returns; the self-pair stays
    a local copy; the result equals the unstaged exchange's."""
    for rank in range(4):
        rec = json.loads((spawned / f"staged_r{rank}.json").read_text())
        assert rec["asked"] == [[3, 4]], rec
        assert rec["staged"] == 1 and rec["in_flight"] > 0 and rec["equal"] == [True, True]


# ---------------------------------------------------------------------------
# pure Python
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stages,virtual", [(2, 1), (3, 1), (4, 1), (2, 2), (2, 3), (4, 2)])
def test_simulate_interleaved_equals_jax(stages, virtual):
    from dtc_tpu.parallel import pipeline as jpp
    from dtc_tpu_torch.parallel import pipeline as tpp

    for m in (1, 2, 3, 4, 5, 8):
        want = jpp.simulate_interleaved(m, stages, virtual)
        got = tpp.simulate_interleaved(m, stages, virtual)
        assert [(list(f), list(b)) for f, b in got[0]] == \
            [(list(f), list(b)) for f, b in want[0]], (m, stages, virtual)
        assert got[1:] == want[1:]
        if virtual == 1:
            assert tpp.simulate_1f1b(m, stages) == jpp.simulate_1f1b(m, stages)


@pytest.mark.parametrize("m,stages", [(1, 2), (2, 2), (4, 3), (8, 4)])
def test_gpipe_table_fills_then_drains(m, stages):
    """Every stage forwards each microbatch once and then runs its
    backward once; a microbatch reaches stage s+1 a tick after stage s and
    its cotangent stage s a tick after stage s+1."""
    from dtc_tpu_torch.parallel.pipeline import forward_slots, gpipe_rows, schedule_rows

    rows = gpipe_rows(m, stages)
    assert rows == schedule_rows("gpipe", m, stages)
    assert len(rows) == 2 * (m + stages - 1)
    f_at = {(s, f[s][0]): t for t, (f, _) in enumerate(rows) for s in range(stages)
            if f[s][0] >= 0}
    b_at = {(s, b[s][0]): t for t, (_, b) in enumerate(rows) for s in range(stages)
            if b[s][0] >= 0}
    assert len(f_at) == len(b_at) == m * stages
    for j in range(m):
        for s in range(stages - 1):
            assert f_at[(s + 1, j)] == f_at[(s, j)] + 1
            assert b_at[(s, j)] == b_at[(s + 1, j)] + 1
    assert all(forward_slots(rows, s) == m for s in range(stages))
    with pytest.raises(ValueError):
        schedule_rows("gpipe", m, stages, virtual=2)


@pytest.mark.parametrize("stages,virtual,layers", [(2, 1, 4), (4, 1, 4), (2, 2, 4),
                                                   (2, 3, 12), (3, 2, 12)])
def test_stage_layout_equals_pp_stack_params(stages, virtual, layers):
    """The port's layer assignment is JAX's ``pp_stack_params``: stage s
    holds leaf[s] of the stacked layout, chunk by chunk; ``pp_stage`` cuts
    a ``from_flax`` parameter set that way and ``gather_stages`` puts it
    back bit for bit."""
    import jax.numpy as jnp

    from dtc_tpu.parallel.pipeline import pp_stack_params
    from dtc_tpu_torch.parallel.pipeline import StageLayout
    from dtc_tpu_torch.parity import gather_stages, pp_stage

    stacked = pp_stack_params({"stage": jnp.arange(layers)}, stages, virtual)["stage"]
    state = {"embed.wte.weight": torch.zeros(3), "head.ln_f.bias": torch.ones(3)}
    state.update({f"stage.blocks.{i}.ln_1.bias": torch.full((2,), float(i))
                  for i in range(layers)})
    parts = []
    for s in range(stages):
        want = np.asarray(stacked[s]).reshape(-1).tolist()
        assert StageLayout(s, stages, virtual).layers(layers) == want
        part = pp_stage(state, s, stages, virtual)
        assert [float(part[f"stage.blocks.{i}.ln_1.bias"][0]) for i in range(len(want))] == want
        assert ("embed.wte.weight" in part) == (s == 0)
        assert ("head.ln_f.bias" in part) == (s == stages - 1)
        parts.append(part)
    back = gather_stages(parts, virtual)
    assert back.keys() == state.keys() and all(torch.equal(back[k], state[k]) for k in state)
    with pytest.raises(ValueError, match="not divisible"):
        StageLayout(0, stages, virtual).layers(layers + 1)


def test_tp_dims_match_jax_param_specs_and_shards_round_trip(tiny_model_cfg):
    """Megatron's dims of every port parameter against JAX's
    ``param_specs(DEFAULT_RULES)`` through the layouts; ``tp_shards`` of a
    ``from_flax`` set over 2 and 4 ranks gathered back bit for bit."""
    import jax
    from jax.sharding import PartitionSpec as P

    from dtc_tpu.parallel import sharding as js
    from dtc_tpu_torch.parallel.sharding import TP_ROLES, tp_shard_dim
    from dtc_tpu_torch.parity import from_flax, gather_tp, tp_shards

    params = _flax_params(tiny_model_cfg)
    specs = js.param_specs(params, js.DEFAULT_RULES)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): spec for path, spec in
            jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda s: isinstance(s, P))[0]}
    state = from_flax(jax.tree.map(np.asarray, params), tiny_model_cfg)
    for name in state:
        parts = name.split(".")
        mod = parts[-2]
        leaf = {"weight": {"wte": "embedding", "wpe": "embedding"}.get(
                    mod, "scale" if mod.startswith("ln") else "kernel"), "bias": "bias"}[parts[-1]]
        axes = list(next(s for p, s in flat.items() if p.endswith(f"/{mod}/{leaf}")))
        if "blocks" in name:
            axes = axes[1:]
        if leaf == "kernel":
            axes = axes[::-1]
        want = axes.index("model") if "model" in axes else None
        assert tp_shard_dim(name) == want, name
        role = TP_ROLES.get(mod)
        assert want == {None: None, "column": 0, "vocab": 0,
                        "row": 1 if leaf == "kernel" else None}[role], name
    for size in (2, 4):
        shards = [tp_shards(state, r, size) for r in range(size)]
        assert shards[1]["stage.blocks.0.attn.q_proj.weight"].shape == (64 // size, 64)
        assert shards[1]["stage.blocks.0.mlp.fc2.weight"].shape == (64, 128 // size)
        back = gather_tp(shards)
        assert all(torch.equal(back[n], state[n]) for n in state)


@pytest.mark.parametrize("mesh_shape,parallel", [
    ({"model": 2}, "dp"), ({"data": 2, "model": 4}, "dp"), ({"pipe": 2}, "pp"),
    ({"pipe": 2, "data": 2, "model": 2}, "3d"), ({"pipe": 4, "data": 2}, "pp"),
])
def test_train_memory_bytes_on_tp_and_pp_meshes_matches_jax(tiny_model_cfg, mesh_shape,
                                                             parallel):
    from dtc_tpu.utils.metrics import comm_bytes_per_step as jcomm
    from dtc_tpu.utils.metrics import tp_sharded_param_count as jcount
    from dtc_tpu.utils.metrics import train_memory_bytes as jmem
    from dtc_tpu_torch.config import schema as ts
    from dtc_tpu_torch.config.loader import _build
    from dtc_tpu_torch.utils import metrics as tm

    for cfg in (tiny_model_cfg, dataclasses.replace(tiny_model_cfg, compute_dtype="bfloat16",
                                                    remat="block")):
        port = _build(ts.ModelConfig, dataclasses.asdict(cfg), "test")
        assert tm.tp_sharded_param_count(port) == jcount(cfg)
        assert tm.comm_bytes_per_step(port, 8, 32, mesh_shape, parallel, 2) == \
            pytest.approx(jcomm(cfg, 8, 32, mesh_shape, parallel, 2), rel=1e-12)
        want = jmem(cfg, 8, cfg.max_seq_len, mesh_shape, parallel)
        got = tm.train_memory_bytes(port, 8, cfg.max_seq_len, mesh_shape, parallel)
        for key, value in got.items():
            assert value == pytest.approx(want[key], rel=1e-12), (parallel, key)



@pytest.mark.parametrize("ring", [False, True], ids=["3d", "ring"])
def test_fsdp_param_specs_match_jax_and_mesh_shards_round_trip(tiny_model_cfg, ring):
    """Every port parameter's spec under FSDP_RULES (an FSDP dim over
    ``data`` and a Megatron dim over ``model``: q_proj's kernel
    ``P(None, "data", "model")``) and under the ring's derived rules (the
    FSDP dim alone: ``P(None, "data")``) against JAX's ``param_specs``
    through the layouts; ``mesh_shards`` over data 4 × model 2 (ring: data 2,
    no Megatron slices) gathered back bit for bit by ``gather_mesh``."""
    import jax
    from jax.sharding import PartitionSpec as P

    from dtc_tpu.parallel import sharding as js
    from dtc_tpu_torch.parallel import sharding as ps
    from dtc_tpu_torch.parity import from_flax, gather_mesh, mesh_shards

    params = _flax_params(tiny_model_cfg)
    jrules = js.ring_rules_from(js.FSDP_RULES) if ring else js.FSDP_RULES
    rules = ps.ring_rules_from(ps.FSDP_RULES) if ring else ps.FSDP_RULES
    specs = js.param_specs(params, jrules)
    qk = specs["stage"]["blocks"]["Block_0"]["attn"]["q_proj"]["kernel"]
    # (JAX's trained kernel shows the spec without its trailing None)
    assert P(*tuple(qk)[:2 if ring else 3]) == (P(None, "data") if ring
                                                else P(None, "data", "model"))
    assert tuple(qk)[2 if ring else 3:] in ((), (None,))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): spec for path, spec in
            jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda s: isinstance(s, P))[0]}
    state = from_flax(jax.tree.map(np.asarray, params), tiny_model_cfg)
    for name in state:
        parts = name.split(".")
        mod = parts[-2]
        leaf = {"weight": {"wte": "embedding", "wpe": "embedding"}.get(
                    mod, "scale" if mod.startswith("ln") else "kernel"), "bias": "bias"}[parts[-1]]
        spec = next(s for p, s in flat.items() if p.endswith(f"/{mod}/{leaf}"))
        axes = list(spec) + [None] * (state[name].ndim + ("blocks" in name) - len(spec))
        if "blocks" in name:
            axes = axes[1:]
        if leaf == "kernel":
            axes = axes[::-1]
        assert list(ps.param_spec(name, rules)) == axes, name
    n_data, n_model = (2, 1) if ring else (4, 2)
    grid = [[mesh_shards(state, d, n_data, m, n_model) for m in range(n_model)]
            for d in range(n_data)]
    q = grid[1][0]["stage.blocks.0.attn.q_proj.weight"]
    assert q.shape == (64 // n_model, 64 // n_data)
    back = gather_mesh(grid)
    assert back.keys() == state.keys() and all(torch.equal(back[n], state[n]) for n in state)


def test_check_fsdp_refuses_only_a_pipe_axis(tiny_model_cfg, opt_cfg, train_cfg_factory):
    """FSDP trains with a model axis (Megatron or ring attention) and still
    refuses a pipe axis, before any process group."""
    from dtc_tpu_torch.config import schema as ts
    from dtc_tpu_torch.config.loader import _build
    from dtc_tpu_torch.parallel.mesh import check_fsdp
    from dtc_tpu_torch.train.trainer import refuse_unported

    for shape in ((1, 4, 2), (1, 2, 4), (1, 8, 1), (1, 1, 8)):
        check_fsdp(shape)
    with pytest.raises(NotImplementedError, match="pipe axis"):
        check_fsdp((2, 2, 2))
    port = lambda cls, c: _build(cls, dataclasses.asdict(c), "test")

    def fsdp_cfg(**mesh):
        cfg = train_cfg_factory("fsdp", mesh=ts.MeshConfig(**mesh))
        return port(ts.TrainConfig, dataclasses.replace(
            cfg, obs=dataclasses.replace(cfg.obs, enabled=False)))

    for attention in ("dense", "ring"):
        model = port(ts.ModelConfig, dataclasses.replace(tiny_model_cfg, attention=attention))
        refuse_unported(fsdp_cfg(data=4, model=2), model)
    with pytest.raises(NotImplementedError, match="pipe axis"):
        refuse_unported(fsdp_cfg(pipe=2, data=2, model=2), port(ts.ModelConfig, tiny_model_cfg))


@pytest.mark.parametrize("mesh_shape,attention", [
    ({"data": 4, "model": 2}, "dense"), ({"data": 2, "model": 4}, "ring"),
    ({"pipe": 1, "data": 2, "model": 2}, "dense"),
])
def test_comm_bytes_and_memory_on_fsdp_meshes_match_jax(tiny_model_cfg, mesh_shape, attention):
    """``comm_bytes_per_step`` and ``train_memory_bytes`` under ``fsdp``
    with a model axis against JAX's, and at data 4 × model 2 against the
    terms of JAX's ``test_comm_bytes_3d_terms``."""
    from dtc_tpu.utils.metrics import comm_bytes_per_step as jcomm
    from dtc_tpu.utils.metrics import train_memory_bytes as jmem
    from dtc_tpu_torch.config import schema as ts
    from dtc_tpu_torch.config.loader import _build
    from dtc_tpu_torch.models.gpt import param_count
    from dtc_tpu_torch.utils import metrics as tm

    for cfg in (dataclasses.replace(tiny_model_cfg, attention=attention),
                dataclasses.replace(tiny_model_cfg, attention=attention,
                                    compute_dtype="bfloat16", remat="block")):
        port = _build(ts.ModelConfig, dataclasses.asdict(cfg), "test")
        got = tm.comm_bytes_per_step(port, 8, 32, mesh_shape, "fsdp")
        assert got == pytest.approx(jcomm(cfg, 8, 32, mesh_shape, "fsdp"), rel=1e-12)
        want = jmem(cfg, 8, cfg.max_seq_len, mesh_shape, "fsdp")
        mem = tm.train_memory_bytes(port, 8, cfg.max_seq_len, mesh_shape, "fsdp")
        for key, value in mem.items():
            assert value == pytest.approx(want[key], rel=1e-12), key
        if mesh_shape == {"data": 4, "model": 2} and cfg.compute_dtype == "float32":
            n, n_tp = param_count(port), tm.tp_sharded_param_count(port)
            assert got["dp_allreduce"] == pytest.approx(3.0 * 3 / 4 * (n_tp / 2 + n - n_tp) * 4)
            act = 8 * 32 * cfg.d_model * 4 / 4
            assert got["tp_allreduce"] == pytest.approx(4.0 * cfg.n_layers * 2.0 / 2 * act)


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
