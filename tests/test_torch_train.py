"""The port's training path against the JAX package's, on the same numpy
inputs and flax weights (``parity.from_flax``): the fused head + CE, the
model's loss and every parameter gradient with flash attention, the
trainer's loss trajectory, ``log.csv``, the command line, and the rules
(no silent CPU, explicit dropout generator).

Tolerances: float32 compute throughout. Loss and gradients of one forward
1e-5 × the largest |value| (summation order only). Trainer losses 2e-4, as
``tests/test_train_parity.py`` holds the JAX strategies to each other
(measured here: ~6e-6 over 8 steps).
"""

import csv
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dtc_tpu.config import schema as js
from dtc_tpu.models.gpt import GPT as JGPT
from dtc_tpu.ops.fused_ce import fused_head_ce as jfused_head_ce
from dtc_tpu.train.trainer import train as jtrain
from dtc_tpu_torch.config import schema as ts
from dtc_tpu_torch.config.loader import _build
from dtc_tpu_torch.models.gpt import GPT
from dtc_tpu_torch.ops.fused_ce import fused_head_ce
from dtc_tpu_torch.parity import from_flax
from dtc_tpu_torch.train.optimizer import lr_schedule
from dtc_tpu_torch.train.train_step import cross_entropy_loss
from dtc_tpu_torch.train.trainer import train
from tests.conftest import make_train_cfg


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the port's small CPU runs take as long, and the
    test workers do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parent.parent


def _port(cls, cfg, **over):
    """A JAX config dataclass rebuilt as the port's, with overrides."""
    return dataclasses.replace(_build(cls, dataclasses.asdict(cfg), "test"), **over)


def _flax_params(cfg, seed=0):
    params = jax.jit(
        lambda r, x: JGPT(cfg).init({"params": r, "dropout": r}, x, train=False)
    )(jax.random.PRNGKey(seed), jnp.ones((1, cfg.max_seq_len), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def _close(got: torch.Tensor, want, name):
    want = np.asarray(want, np.float32)
    tol = 1e-5 * max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got.detach().float().numpy(), want, atol=tol, rtol=0,
                               err_msg=name)


def test_fused_head_ce_matches_jax():
    """Loss and (dh, dW, db) at float32 with a padded vocab (97 -> 128)."""
    rng = np.random.RandomState(0)
    n, d, v, vocab = 24, 16, 128, 97
    h = rng.randn(2, n // 2, d).astype(np.float32)
    w = (0.2 * rng.randn(d, v)).astype(np.float32)          # flax (in, out)
    b = (0.1 * rng.randn(v)).astype(np.float32)
    y = rng.randint(0, vocab, size=(2, n // 2)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(
        lambda h, w, b: jfused_head_ce(h, w, b, jnp.asarray(y), vocab), argnums=(0, 1, 2)
    )(jnp.asarray(h), jnp.asarray(w), jnp.asarray(b))
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w.T.copy(), requires_grad=True)       # nn.Linear (out, in)
    tb = torch.tensor(b, requires_grad=True)
    loss = fused_head_ce(th, tw, tb, torch.from_numpy(y), vocab)
    loss.backward()
    _close(loss, jloss, "loss")
    _close(th.grad, jgrads[0], "dh")
    _close(tw.grad.T, jgrads[1], "dW")
    _close(tb.grad, jgrads[2], "db")
    assert float(tb.grad[vocab:].abs().max()) == 0.0       # pad columns get nothing


def test_fused_head_ce_chunk_boundary_matches_jax(monkeypatch):
    """The head + CE works on ``CE_CHUNK_ROWS`` rows at a time: with 7-row
    chunks over 24 rows (the last chunk 3 rows) the loss and dh are the
    unchunked ones bit for bit (exact per row), and the loss and all three
    gradients match JAX's within the float32 limits."""
    from dtc_tpu_torch.ops import fused_ce as tce

    rng = np.random.RandomState(5)
    n, d, v, vocab = 24, 16, 128, 97
    h = rng.randn(2, n // 2, d).astype(np.float32)
    w = (0.2 * rng.randn(d, v)).astype(np.float32)
    b = (0.1 * rng.randn(v)).astype(np.float32)
    y = rng.randint(0, vocab, size=(2, n // 2)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(
        lambda h, w, b: jfused_head_ce(h, w, b, jnp.asarray(y), vocab), argnums=(0, 1, 2)
    )(jnp.asarray(h), jnp.asarray(w), jnp.asarray(b))

    def port():
        th = torch.tensor(h, requires_grad=True)
        tw = torch.tensor(w.T.copy(), requires_grad=True)
        tb = torch.tensor(b, requires_grad=True)
        loss = fused_head_ce(th, tw, tb, torch.from_numpy(y), vocab)
        loss.backward()
        return loss, th.grad, tw.grad, tb.grad

    whole = port()
    monkeypatch.setattr(tce, "CE_CHUNK_ROWS", 7)
    loss, dh, dw, db = port()
    assert torch.equal(loss, whole[0]) and torch.equal(dh, whole[1])
    _close(loss, jloss, "loss")
    _close(dh, jgrads[0], "dh")
    _close(dw.T, jgrads[1], "dW")
    _close(db, jgrads[2], "db")


def test_model_loss_and_every_gradient_match_jax_with_flash():
    """GPT(x, targets=y) at dropout 0, float32, attention: flash, on a config
    that takes JAX's packed single-tile kernels (T 128, D 32): the loss and
    the gradient of every parameter, by name."""
    cfg = js.ModelConfig(vocab_size=97, d_model=128, n_layers=2, n_heads=4, d_ff=256,
                         max_seq_len=128, dropout=0.0, param_dtype="float32",
                         compute_dtype="float32", attention="flash")
    params = _flax_params(cfg)
    rng = np.random.RandomState(1)
    x = rng.randint(0, 97, size=(2, 128)).astype(np.int32)
    y = rng.randint(0, 97, size=(2, 128)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JGPT(cfg).apply({"params": p}, jnp.asarray(x), train=False,
                                  targets=jnp.asarray(y))
    )(jax.tree.map(jnp.asarray, params))
    tcfg = _port(ts.ModelConfig, cfg)
    model = GPT(tcfg, device="cpu")
    model.load_state_dict(from_flax(params, tcfg))
    loss = model(torch.from_numpy(x), train=True, targets=torch.from_numpy(y))
    loss.backward()
    _close(loss, jloss, "loss")
    with torch.no_grad():  # the eval path: logits, then the same cross entropy
        _close(cross_entropy_loss(model(torch.from_numpy(x)), torch.from_numpy(y)), jloss,
               "eval loss")
    want = from_flax(jax.tree.map(np.asarray, jgrads), tcfg)
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        _close(got[name].grad, g.numpy(), name)


def _trajectory(tiny_model_cfg, opt_cfg, **train_kw):
    jcfg = make_train_cfg("dp", steps=8, **train_kw)
    want = jtrain(jcfg, tiny_model_cfg, opt_cfg).losses
    tcfg = _port(ts.TrainConfig, jcfg, obs=ts.ObsConfig(enabled=False))
    got = train(tcfg, _port(ts.ModelConfig, tiny_model_cfg), _port(ts.OptimConfig, opt_cfg),
                device="cpu", params=_flax_params(tiny_model_cfg)).losses
    return np.asarray(got), np.asarray(want)


@pytest.mark.parametrize("variant", ["constant", "warmup_cosine"])
def test_train_losses_match_jax_trainer(tiny_model_cfg, opt_cfg, variant):
    """8 timed steps from the same initial params and synthetic batches.
    ``warmup_cosine`` also runs 2 untimed warmup steps, which are real
    updates on the first two batches in both trainers."""
    kw = {}
    if variant == "warmup_cosine":
        opt_cfg = dataclasses.replace(opt_cfg, schedule="warmup_cosine", warmup_steps=2)
        kw = dict(warmup_steps=2)
    got, want = _trajectory(tiny_model_cfg, opt_cfg, **kw)
    assert got.shape == want.shape == (8,)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_lr_schedule_matches_optax():
    import optax

    cfg = ts.OptimConfig(lr=3e-4, weight_decay=0.1, grad_clip=1.0,
                         schedule="warmup_cosine", warmup_steps=3, min_lr_ratio=0.1)
    ref = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 3, 10, 3e-5)
    port = lr_schedule(cfg, 10)
    for c in range(14):
        assert port(c) == pytest.approx(float(ref(c)), rel=1e-6, abs=1e-12)


def _tiny_train_cfg(tmp_path, **over):
    cfg = ts.TrainConfig(seed=0, parallel="dp", batch=2, steps=5, log_every=2,
                         output_dir=str(tmp_path), dataset="synthetic", warmup_steps=1,
                         prefetch=2, obs=ts.ObsConfig(enabled=False))
    return dataclasses.replace(cfg, **over)


def _tiny_model_cfg(**over):
    return ts.ModelConfig(vocab_size=97, d_model=32, n_layers=1, n_heads=2, d_ff=64,
                          max_seq_len=16, compute_dtype="float32", **over)


def test_log_csv_schema_and_rows(tmp_path):
    cfg = _tiny_train_cfg(tmp_path)
    res = train(cfg, _tiny_model_cfg(), ts.OptimConfig(lr=1e-3, weight_decay=0.1, grad_clip=1.0),
                device="cpu")
    with open(tmp_path / "log.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["step", "elapsed_time", "loss"]
    assert [int(r[0]) for r in rows[1:]] == [1, 2, 3, 4, 5]
    np.testing.assert_allclose([float(r[2]) for r in rows[1:]], res.losses, rtol=1e-6)
    times = [float(r[1]) for r in rows[1:]]
    assert times == sorted(times) and times[0] > 0
    with pytest.raises(ValueError, match="refusing to overwrite"):
        train(cfg, _tiny_model_cfg(), ts.OptimConfig(lr=1e-3, weight_decay=0.1, grad_clip=1.0),
              device="cpu")


def test_dropout_draws_from_the_trainer_generator(tmp_path):
    """Two runs with one seed give identical losses at dropout 0.1; another
    seed gives others (the masks come from the seeded generator)."""
    ocfg = ts.OptimConfig(lr=1e-3, weight_decay=0.1, grad_clip=1.0)
    runs = [
        train(_tiny_train_cfg(tmp_path / str(i), seed=seed), _tiny_model_cfg(dropout=0.1),
              ocfg, device="cpu").losses
        for i, seed in enumerate((3, 3, 4))
    ]
    assert runs[0] == runs[1]
    # Same weights, other dropout masks: the first loss differs.
    model_cfg = _tiny_model_cfg(dropout=0.1)
    model = GPT(model_cfg, device="cpu", seed=0)
    x = torch.randint(0, 97, (2, 16), generator=torch.Generator().manual_seed(0))
    losses = [model(x, train=True, targets=x, generator=torch.Generator().manual_seed(s))
              for s in (5, 5, 6)]
    assert losses[0] == losses[1] and losses[0] != losses[2]
    with pytest.raises(ValueError, match="Generator"):
        model(x, train=True, targets=x)


def test_serving_never_draws_dropout(monkeypatch):
    from dtc_tpu_torch.generate import generate
    from dtc_tpu_torch.models import gpt as gpt_mod
    from dtc_tpu_torch.serve import Request, ServingEngine
    from dtc_tpu_torch.config.schema import ServeConfig

    real = gpt_mod._dropout

    def spy(x, p, gen):
        assert p == 0.0 and gen is None, "serving drew a dropout mask"
        return real(x, p, gen)

    monkeypatch.setattr(gpt_mod, "_dropout", spy)
    model = GPT(_tiny_model_cfg(dropout=0.1), device="cpu", seed=0)
    generate(model, [[1, 2, 3]], 4)
    eng = ServingEngine(model, ServeConfig(slots=2, page_size=4, prefill_bucket=4))
    eng.submit(Request(rid="a", prompt=[5, 6, 7], max_new_tokens=3))
    assert eng.run()["a"].state.value == "done"


def test_main_cli_trains_on_cpu(tmp_path):
    mcfg = tmp_path / "model.yaml"
    mcfg.write_text("vocab_size: 97\nd_model: 32\nn_layers: 1\nn_heads: 2\nd_ff: 64\n"
                    "max_seq_len: 16\ncompute_dtype: float32\n")
    tcfg = tmp_path / "train.yaml"
    tcfg.write_text(f"seed: 0\nparallel: dp\nbatch: 2\nsteps: 10\nlog_every: 1\n"
                    f"output_dir: {tmp_path / 'out'}\nwarmup_steps: 1\n")
    out = subprocess.run(
        [sys.executable, "-m", "dtc_tpu_torch.main", "--train_config_path", str(tcfg),
         "--model_config_path", str(mcfg),
         "--optim_config_path", str(ROOT / "configs" / "optim_config.yaml"),
         "--device", "cpu", "--dataset", "synthetic", "--no-obs", "--steps", "3"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "Total time" in out.stdout
    assert len((tmp_path / "out" / "log.csv").read_text().splitlines()) == 4


def test_trainer_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(_tiny_train_cfg(tmp_path), _tiny_model_cfg(),
              ts.OptimConfig(lr=1e-3, weight_decay=0.1, grad_clip=1.0))


@pytest.mark.parametrize("over", [
    dict(parallel="fsdp", mesh=ts.MeshConfig(pipe=2)),
    dict(mesh=ts.MeshConfig(dcn_data=2)),
    dict(multihost=True), dict(debug_nans=True),
])
def test_unported_training_features_raise(tmp_path, over):
    with pytest.raises(NotImplementedError):
        train(_tiny_train_cfg(tmp_path, **over), _tiny_model_cfg(),
              ts.OptimConfig(lr=1e-3, weight_decay=0.1, grad_clip=1.0), device="cpu")


@pytest.mark.parametrize("shape,ring,fsdp", [
    ((1, 1, 2), False, False), ((2, 1, 1), False, False), ((1, 4, 1), False, True),
    ((1, 2, 2), True, True),
])
@pytest.mark.parametrize("feature", [dict(checkpoint_every=10), dict(eval_every=5)])
def test_checkpoints_and_eval_refused_where_a_rank_holds_a_slice(tmp_path, shape, ring, fsdp,
                                                                  feature):
    """Under tensor parallelism, a pipeline and FSDP a rank holds a slice of
    the model: checkpoints and held-out eval raise, naming the ROADMAP item
    they wait for. DP, DP with ring attention and one process take them."""
    from dtc_tpu_torch.train.trainer import refuse_sharded_state

    cfg = _tiny_train_cfg(tmp_path, **feature)
    with pytest.raises(NotImplementedError, match="ROADMAP.md §A2"):
        refuse_sharded_state(cfg, shape, ring, fsdp)
    for whole in (((1, 1, 1), False, False), ((1, 4, 1), False, False),
                  ((1, 2, 2), True, False)):
        refuse_sharded_state(cfg, *whole)


@pytest.mark.parametrize("over", [
    dict(parallel="pp", mesh=ts.MeshConfig(pipe=2)), dict(mesh=ts.MeshConfig(pipe=2)),
    dict(parallel="tp", mesh=ts.MeshConfig(model=2)),
])
def test_tp_and_pp_meshes_wider_than_one_process_raise(tmp_path, over):
    """Tensor and pipeline parallelism train now; in one process a mesh
    that asks for two ranks raises JAX's ``resolve_mesh_shape`` error,
    which names the device count."""
    from dtc_tpu.config.schema import MeshConfig as JMesh
    from dtc_tpu.parallel.mesh import resolve_mesh_shape as jresolve

    cfg = _tiny_train_cfg(tmp_path, **over)
    m = cfg.mesh
    with pytest.raises(ValueError, match="device count 1") as want:
        jresolve(cfg.parallel, 1, JMesh(m.pipe, m.data, m.model), n_layers=2)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        train(cfg, dataclasses.replace(_tiny_model_cfg(), n_layers=2),
              ts.OptimConfig(lr=1e-3, weight_decay=0.1, grad_clip=1.0), device="cpu")


def test_pp_on_one_process_is_the_plain_step(tmp_path):
    """``parallel: pp`` on one process resolves to a pipe of 1 and trains
    the plain step (as the JAX package's trainer does): the losses equal
    ``parallel: dp``'s bit for bit."""
    ocfg = ts.OptimConfig(lr=1e-3, weight_decay=0.1, grad_clip=1.0)
    runs = [train(_tiny_train_cfg(tmp_path / par, parallel=par, pp_microbatches=2),
                  dataclasses.replace(_tiny_model_cfg(), n_layers=2), ocfg,
                  device="cpu").losses
            for par in ("pp", "dp")]
    assert runs[0] == runs[1]


@pytest.mark.parametrize("over", [dict(moe_experts=2), dict(attention="ulysses")])
def test_unported_model_features_raise(over):
    model_cfg = _tiny_model_cfg(**over)
    with pytest.raises(NotImplementedError):
        model = GPT(model_cfg, device="cpu")
        model(torch.zeros(1, 4, dtype=torch.long))


@pytest.mark.parametrize("feature,parallel,mesh", [
    ("bf16_mixed", "tp", ts.MeshConfig()), ("bf16_mixed", "dp", ts.MeshConfig(model=2)),
    ("bf16_mixed", "pp", ts.MeshConfig()), ("bf16_mixed", "fsdp", ts.MeshConfig()),
    ("lora", "tp", ts.MeshConfig()), ("lora", "3d", ts.MeshConfig(data=1, model=2)),
    ("lora", "fsdp", ts.MeshConfig()),
])
def test_sharded_bf16_mixed_and_lora_training_raise(tmp_path, feature, parallel, mesh):
    """``precision: bf16_mixed`` under tensor or pipeline parallelism or
    FSDP, and LoRA training under tensor parallelism or FSDP, wait for the
    sharded optimizer state (ROADMAP §A2): NotImplementedError naming it,
    before any process group."""
    ocfg = ts.OptimConfig(lr=1e-3, weight_decay=0.0, grad_clip=1.0,
                          precision="bf16_mixed" if feature == "bf16_mixed" else "fp32")
    mcfg = _tiny_model_cfg(adapter=ts.AdapterConfig(rank=2 if feature == "lora" else 0))
    cfg = _tiny_train_cfg(tmp_path, parallel=parallel, mesh=mesh, pp_microbatches=2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md §A2") as e:
        train(cfg, mcfg, ocfg, device="cpu")
    assert ("bf16_mixed" if feature == "bf16_mixed" else "LoRA") in str(e.value)
    assert not torch.distributed.is_initialized()
