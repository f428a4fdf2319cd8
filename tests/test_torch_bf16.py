"""``precision: bf16_mixed`` in the port against the JAX package on the CPU.

- The master weights of ``ClippedAdamW`` against ``with_master_weights``
  (``dtc_tpu/train/optimizer.py``), on the same parameters and gradients,
  mirroring ``tests/test_bf16.py``: distinct float32 masters; the masters
  and moments within 1e-6 (relative and absolute, the tolerance
  ``tests/test_torch_checkpoint.py`` holds the optimizer to) of JAX's
  after every update, each bfloat16 parameter its master rounded bit for
  bit; a step below a bfloat16 ulp accumulating in the master;
  skip-nonfinite against ``optax.apply_if_finite(with_master_weights(…))``.
- ``resolve_precision`` against JAX's: the lifted dtypes, the float16
  refusal, the fp32 pass-through; every parameter's dtype leaf by leaf.
- The loss trajectory of ``tests/test_bf16.py``'s dev model (vocab 97,
  d_model 64, 4 layers, 4 heads, d_ff 128, T 32, B 8, dropout 0, lr 1e-3,
  8 steps) from JAX's own initial weights: the port's ``bf16_mixed``
  within JAX's documented 3% a step of JAX's ``bf16_mixed``, and of the
  port's ``fp32``; both fall by 5%. JAX's two runs are shared by the
  tests through one fixture, run once a session under a file lock.
- ``bf16_mixed`` resume in the trainer: bit-equal to the uninterrupted run
  at dropout 0.1, masters restored.
"""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from dtc_tpu.config import schema as js
from dtc_tpu.train.optimizer import create_optimizer as jcreate_optimizer
from dtc_tpu.train.optimizer import with_master_weights
from dtc_tpu.train.train_step import resolve_precision as jresolve_precision
from dtc_tpu_torch.config import schema as ts
from dtc_tpu_torch.models.gpt import GPT
from dtc_tpu_torch.parity import from_flax
from dtc_tpu_torch.train.optimizer import create_optimizer
from dtc_tpu_torch.train.train_step import resolve_precision, train_step
from dtc_tpu_torch.train.trainer import train
from tests.test_torch_train import _one_thread, _port  # noqa: F401  (_one_thread: autouse)

#: JAX's documented loss-parity tolerance (``tests/test_bf16.py``).
PARITY_RTOL = 0.03
STEPS = 8


# ---------------------------------------------------------------------------
# master weights against with_master_weights
# ---------------------------------------------------------------------------

def _tree():
    """``tests/test_bf16.py``'s tree: a bfloat16 matrix and a float32 leaf
    (a LayerNorm island), as numpy (bf16 held in float32: exact)."""
    return {"w": np.array([[1.0, -2.0], [0.5, 3.0]], np.float32),
            "ln": np.array([1.0, 1.0], np.float32)}


def _grads(i):
    rng = np.random.RandomState(i)
    w = np.asarray(jnp.asarray(rng.randn(2, 2) * 0.3, jnp.bfloat16), np.float32)
    return {"w": w, "ln": (rng.randn(2) * 0.01).astype(np.float32)}


def _jax_tree(t):
    return {"w": jnp.asarray(t["w"], jnp.bfloat16), "ln": jnp.asarray(t["ln"])}


def _port_params(t):
    return [torch.tensor(t["w"]).to(torch.bfloat16).requires_grad_(True),
            torch.tensor(t["ln"]).requires_grad_(True)]


def _set_grads(params, g):
    params[0].grad = torch.tensor(g["w"]).to(torch.bfloat16)
    params[1].grad = torch.tensor(g["ln"])


def _inner(state):
    """``(masters, adam state)`` of a JAX optimizer state, through
    ``apply_if_finite`` when it wraps one."""
    state = getattr(state, "inner_state", state)
    adam = next(s for s in jax.tree.leaves(
        state.inner, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))
    return state.master, adam


def _same_as_jax(opt, params, jparams, jstate, what):
    masters, adam = _inner(jstate)
    for i, key in enumerate(("w", "ln")):
        for got, want, name in ((opt.masters[i], masters[key], "master"),
                                (opt.mu[i], adam.mu[key], "mu"), (opt.nu[i], adam.nu[key], "nu")):
            assert got.dtype == torch.float32, (what, key, name)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6,
                                       err_msg=f"{what} {key} {name}")
        want_p = np.asarray(jnp.asarray(jparams[key], jnp.float32))
        assert params[i].dtype == (torch.bfloat16 if key == "w" else torch.float32)
        # the float32 leaf within the masters' 1e-6; the bfloat16 one, the
        # masters rounded, equal
        np.testing.assert_allclose(params[i].detach().float().numpy(), want_p,
                                   rtol=1e-6 if key == "ln" else 0, err_msg=f"{what} {key}")
        # each parameter is its own master rounded, bit for bit
        assert torch.equal(params[i].detach(), opt.masters[i].to(params[i].dtype))


def test_masters_are_distinct_float32_buffers():
    """``test_init_builds_fp32_masters_with_distinct_buffers``: a float32
    master of every trainable tensor, a copy even of the float32 one."""
    params = _port_params(_tree())
    opt = create_optimizer(params, ts.OptimConfig(lr=0.1, weight_decay=0.0, grad_clip=0.0,
                                                  precision="bf16_mixed"))
    assert [m.dtype for m in opt.masters] == [torch.float32, torch.float32]
    assert all(m.data_ptr() != p.data_ptr() for m, p in zip(opt.masters, params))
    for m, p in zip(opt.masters, params):
        assert torch.equal(m, p.detach().float())
    assert all(s.dtype == torch.float32 for s in opt.mu + opt.nu)
    assert create_optimizer(params, ts.OptimConfig(lr=0.1, weight_decay=0.0,
                                                   grad_clip=0.0)).masters is None


@pytest.mark.parametrize("clip", [0.0, 0.1])
def test_updates_match_with_master_weights(clip):
    """Clip + AdamW on the masters, 4 updates from the same gradients (the
    clip active at 0.1): the masters and moments equal JAX's within 1e-6
    relative after each, every parameter its master rounded."""
    cfg = dict(lr=1e-2, weight_decay=0.1, grad_clip=clip, precision="bf16_mixed")
    tx = jcreate_optimizer(js.OptimConfig(**cfg))
    jparams = _jax_tree(_tree())
    jstate = tx.init(jparams)
    params = _port_params(_tree())
    opt = create_optimizer(params, ts.OptimConfig(**cfg))
    for i in range(4):
        g = _grads(i)
        upd, jstate = tx.update(_jax_tree(g), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        _set_grads(params, g)
        opt.step()
        _same_as_jax(opt, params, jparams, jstate, f"update {i}")


def test_tiny_updates_accumulate_in_master_not_lost_in_bf16():
    """``test_tiny_updates_accumulate_in_master_not_lost_in_bf16`` with the
    port's AdamW (no weight decay, a constant gradient, so each step is
    lr = 0.25, a quarter of bfloat16's ulp below 256): a bfloat16
    ``256 - 0.25`` stays 256 for ever, while the master falls by 0.25 a
    step and the parameter follows it rounded (to 254 after 8 steps);
    JAX's ``with_master_weights(adamw)`` alike, step by step."""
    cfg = dict(lr=0.25, weight_decay=0.0, grad_clip=0.0, precision="bf16_mixed")
    tx = with_master_weights(optax.adamw(0.25, weight_decay=0.0))
    jp = {"w": jnp.asarray([256.0], jnp.bfloat16)}
    jstate = tx.init(jp)
    p = torch.tensor([256.0], dtype=torch.bfloat16, requires_grad=True)
    opt = create_optimizer([p], ts.OptimConfig(**cfg))
    seen = []
    for _ in range(8):
        upd, jstate = tx.update({"w": jnp.asarray([0.25], jnp.bfloat16)}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        p.grad = torch.tensor([0.25], dtype=torch.bfloat16)
        opt.step()
        np.testing.assert_allclose(opt.masters[0].numpy(), np.asarray(jstate.master["w"]),
                                   rtol=1e-6)
        assert float(p.detach()) == float(jp["w"][0])
        seen.append((float(opt.masters[0]), float(p.detach())))
    np.testing.assert_allclose([m for m, _ in seen], [256 - 0.25 * k for k in range(1, 9)],
                               rtol=1e-6)
    assert [w for _, w in seen] == [256.0, 256.0, 255.0, 255.0, 255.0, 254.0, 254.0, 254.0]
    naive = torch.tensor([256.0], dtype=torch.bfloat16) - torch.tensor([0.25],
                                                                      dtype=torch.bfloat16)
    assert float(naive) == 256.0


def test_skip_nonfinite_wraps_outside_masters():
    """``test_skip_nonfinite_wraps_outside_masters``: a non-finite step
    leaves masters, moments, count and parameters as they were, as
    ``apply_if_finite(with_master_weights(…))`` does; the finite steps
    around it match JAX's."""
    cfg = dict(lr=1e-1, weight_decay=0.1, grad_clip=1.0, precision="bf16_mixed")
    tx = jcreate_optimizer(js.OptimConfig(**cfg), skip_nonfinite=True)
    jparams = _jax_tree(_tree())
    jstate = tx.init(jparams)
    params = _port_params(_tree())
    opt = create_optimizer(params, ts.OptimConfig(**cfg), skip_nonfinite=True)
    for i in range(4):
        g = _grads(i)
        if i == 1:
            g["w"][0, 0] = np.nan
        before = [m.clone() for m in opt.masters + opt.mu + opt.nu + params]
        upd, jstate = tx.update(_jax_tree(g), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        _set_grads(params, g)
        opt.step()
        if i == 1:
            after = opt.masters + opt.mu + opt.nu + params
            assert all(torch.equal(a.detach(), b.detach()) for a, b in zip(after, before))
            assert int(opt.count) == 1 and int(opt.total_notfinite) == 1
        _same_as_jax(opt, params, jparams, jstate, f"update {i}")
    assert int(opt.count) == int(jstate.inner_state.inner[1][0].count)


def test_state_dict_carries_the_masters_and_refuses_the_other_precision():
    params = _port_params(_tree())
    cfg = ts.OptimConfig(lr=1e-2, weight_decay=0.1, grad_clip=1.0, precision="bf16_mixed")
    opt = create_optimizer(params, cfg)
    _set_grads(params, _grads(0))
    opt.step()
    state = opt.state_dict()
    fresh_params = _port_params(_tree())
    fresh = create_optimizer(fresh_params, cfg)
    fresh.load_state_dict(state)
    for a, b in zip(fresh.masters + fresh.mu + fresh.nu + fresh_params,
                    opt.masters + opt.mu + opt.nu + params):
        assert torch.equal(a.detach(), b.detach())
    fp32 = create_optimizer(_port_params(_tree()), dataclasses.replace(cfg, precision="fp32"))
    with pytest.raises(ValueError, match="other precision"):
        fp32.load_state_dict(state)
    with pytest.raises(ValueError, match="other precision"):
        fresh.load_state_dict(fp32.state_dict())


# ---------------------------------------------------------------------------
# resolve_precision and the model's dtypes
# ---------------------------------------------------------------------------

def _dev_model(**over):
    """``tests/test_bf16.py:_train_losses``' dev model, as JAX's config."""
    kw = dict(vocab_size=97, d_model=64, n_layers=4, n_heads=4, d_ff=128, max_seq_len=32,
              dropout=0.0, param_dtype="float32", compute_dtype="float32", attention="dense")
    kw.update(over)
    return js.ModelConfig(**kw)


@pytest.mark.parametrize("over,lifted", [
    ({}, True), (dict(param_dtype="bfloat16", compute_dtype="bfloat16"), False),
    (dict(compute_dtype="bfloat16"), True),
])
def test_resolve_precision_matches_jax(over, lifted):
    jcfg = _dev_model(**over)
    mcfg = _port(ts.ModelConfig, jcfg)
    for prec in ("fp32", "bf16_mixed"):
        jopt = js.OptimConfig(lr=1e-3, weight_decay=0.1, grad_clip=1.0, precision=prec)
        got = resolve_precision(_port(ts.OptimConfig, jopt), mcfg)
        want = jresolve_precision(jopt, jcfg)
        assert (got.param_dtype, got.compute_dtype) == (want.param_dtype, want.compute_dtype)
        assert (got is mcfg) == (prec == "fp32" or not lifted)


def test_resolve_precision_refuses_float16():
    jopt = js.OptimConfig(lr=1e-3, weight_decay=0.1, grad_clip=1.0, precision="bf16_mixed")
    jcfg = _dev_model(compute_dtype="float16")
    with pytest.raises(ValueError, match="float16") as want:
        jresolve_precision(jopt, jcfg)
    with pytest.raises(ValueError, match="float16") as got:
        resolve_precision(_port(ts.OptimConfig, jopt), _port(ts.ModelConfig, jcfg))
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the loss trajectory against JAX's bf16_mixed
# ---------------------------------------------------------------------------

def _batches():
    """``tests/test_bf16.py:_train_losses``' batches (x == y there)."""
    return np.random.RandomState(0).randint(0, 97, (STEPS, 8, 32)).astype(np.int32)


def _jax_run(precision: str):
    """``tests/test_bf16.py:_train_losses`` with the initial weights kept:
    JAX's train step on its dp mesh, 8 steps, lr 1e-3."""
    from flax import linen as nn
    from jax.sharding import NamedSharding

    from dtc_tpu.models.gpt import GPT as JGPT
    from dtc_tpu.parallel.mesh import mesh_from_config
    from dtc_tpu.parallel.sharding import DEFAULT_RULES, batch_spec
    from dtc_tpu.train.train_step import Batch, create_train_step
    from dtc_tpu.train.trainer import init_state
    from tests.conftest import make_train_cfg

    opt = js.OptimConfig(lr=1e-3, weight_decay=0.1, grad_clip=1.0, precision=precision)
    model_cfg = jresolve_precision(opt, _dev_model())
    mesh = mesh_from_config("dp", js.MeshConfig())
    model = JGPT(model_cfg)
    f32 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)  # noqa: E731
    losses = []
    with mesh, nn.logical_axis_rules(DEFAULT_RULES):
        state = init_state(model, model_cfg, make_train_cfg("dp", steps=STEPS), opt, mesh,
                           DEFAULT_RULES)
        init = f32(state.params)
        dtypes = jax.tree.map(lambda a: str(a.dtype), state.params)
        step = create_train_step(mesh, model=model, state=state)
        rng = jax.random.PRNGKey(0)
        for i, xs in enumerate(_batches()):
            x = jax.device_put(xs, NamedSharding(mesh, batch_spec(DEFAULT_RULES)))
            state, loss = step(state, Batch(x=x, y=x), jax.random.fold_in(rng, i))
            losses.append(float(loss))
    return dict(losses=losses, init=init, dtypes=dtypes)


@pytest.fixture(scope="session")
def jax_bf16_runs(tmp_path_factory):
    """JAX's fp32 and bf16_mixed runs, once a session (the first xdist
    worker to ask, under a file lock)."""
    from filelock import FileLock

    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    out = base / "jax_bf16_oracle"
    with FileLock(str(out) + ".lock"):
        if not (out / "runs.pkl").exists():
            out.mkdir(exist_ok=True)
            runs = {p: _jax_run(p) for p in ("fp32", "bf16_mixed")}
            with open(out / "runs.pkl.tmp", "wb") as f:
                pickle.dump(runs, f)
            os.replace(out / "runs.pkl.tmp", out / "runs.pkl")
    with open(out / "runs.pkl", "rb") as f:
        return pickle.load(f)


def _port_run(precision: str, init) -> tuple[list[float], GPT, object]:
    """The same 8 steps through the port's ``train_step`` from JAX's
    initial weights."""
    jopt = js.OptimConfig(lr=1e-3, weight_decay=0.1, grad_clip=1.0, precision=precision)
    ocfg = _port(ts.OptimConfig, jopt)
    mcfg = resolve_precision(ocfg, _port(ts.ModelConfig, _dev_model()))
    model = GPT(mcfg, device="cpu")
    model.load_state_dict(from_flax(init, mcfg))
    opt = create_optimizer(model.parameters(), ocfg, total_steps=STEPS)
    losses = []
    for xs in _batches():
        x = torch.from_numpy(xs).long()
        losses.append(float(train_step(model, opt, x, x, None)))
    return losses, model, opt


def test_bf16_mixed_loss_parity_vs_jax_and_fp32(jax_bf16_runs):
    """The acceptance run of ``tests/test_bf16.py`` held across the two
    packages: the port's bf16_mixed within 3% a step of JAX's bf16_mixed
    and of the port's fp32 (each from JAX's initial weights of that
    precision); all four runs fall by 5%."""
    runs = jax_bf16_runs
    port = {p: _port_run(p, runs[p]["init"])[0] for p in runs}
    for got, want in ((port["bf16_mixed"], runs["bf16_mixed"]["losses"]),
                      (port["bf16_mixed"], port["fp32"]), (port["fp32"], runs["fp32"]["losses"])):
        rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
        assert len(got) == STEPS and max(rel) < PARITY_RTOL, (got, want, rel)
    for losses in list(port.values()) + [r["losses"] for r in runs.values()]:
        assert losses[-1] < losses[0] * 0.95, losses


def test_bf16_mixed_dtypes_leaf_by_leaf_equal_jax(jax_bf16_runs):
    """Under bf16_mixed every parameter has JAX's dtype (bfloat16 matrices,
    embeddings and biases; float32 LayerNorms), and after the steps each
    bfloat16 parameter is its float32 master rounded."""
    runs = jax_bf16_runs["bf16_mixed"]
    _, model, opt = _port_run("bf16_mixed", runs["init"])
    # each flax leaf filled with its dtype's code, carried to the port's names
    codes = jax.tree.map(lambda a, d: np.full(a.shape, float(d == "bfloat16"), np.float32),
                         runs["init"], runs["dtypes"])
    want = {n: torch.bfloat16 if t.reshape(-1)[0] else torch.float32
            for n, t in from_flax(codes, model.cfg).items()}
    assert {n: p.dtype for n, p in model.named_parameters()} == want
    assert set(want.values()) == {torch.bfloat16, torch.float32}
    for p, m in zip(opt.params, opt.masters):
        assert m.dtype == torch.float32 and torch.equal(p.detach(), m.to(p.dtype))


# ---------------------------------------------------------------------------
# bf16_mixed resume
# ---------------------------------------------------------------------------

def test_bf16_mixed_resume_is_bit_exact(tmp_path):
    """Dropout 0.1, checkpoints every 2 steps: 4 steps uninterrupted, then 2
    and a resume to 4 from the step-2 checkpoint: the losses, the bfloat16
    parameters and the float32 masters and moments equal the uninterrupted
    run's bit for bit; the checkpoint holds the masters."""
    from dtc_tpu_torch.utils.checkpoint import CheckpointManager

    mcfg = _port(ts.ModelConfig, _dev_model(n_layers=2, dropout=0.1))
    ocfg = ts.OptimConfig(lr=1e-3, weight_decay=0.1, grad_clip=1.0, precision="bf16_mixed")

    def run(name, steps):
        cfg = ts.TrainConfig(seed=0, parallel="dp", batch=8, steps=steps, log_every=2,
                             output_dir=str(tmp_path / name), dataset="synthetic",
                             warmup_steps=1, prefetch=0, checkpoint_every=2,
                             checkpoint_dir=str(tmp_path / f"{name}_ckpt"),
                             obs=ts.ObsConfig(enabled=False))
        return train(cfg, mcfg, ocfg, device="cpu")

    full, part = run("full", 4), run("part", 2)
    saved = CheckpointManager(str(tmp_path / "part_ckpt")).restore(2)["optimizer"]
    assert [m.dtype for m in saved["master"]] == [torch.float32] * len(saved["master"])
    resumed = run("part", 4)
    assert part.losses + resumed.losses == full.losses and len(resumed.losses) == 2
    for a, b in zip(resumed.model.parameters(), full.model.parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert {p.dtype for p in full.model.parameters()} == {torch.bfloat16, torch.float32}
    for a, b in zip(resumed.optimizer.masters + resumed.optimizer.mu,
                    full.optimizer.masters + full.optimizer.mu):
        assert torch.equal(a, b)
