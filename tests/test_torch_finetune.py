"""The LoRA finetune leg in the port against the JAX package on the CPU.

- The finetune against JAX's ``finetune_adapter`` (``dtc_tpu/adapters/
  finetune.py``) on a tiny adapter-enabled model (rank 4, all six
  targets, float32, dropout 0; eval and checkpoints every 2 steps, 6
  steps) from the same base and initial factors (JAX's init, carried by
  ``parity.from_flax`` / ``lora_from_flax``): losses and eval losses
  within rtol 2e-4 (JAX's trainer tolerance), the trained factors within
  3e-4, the base bit-equal to its start with no ``.grad`` and no optimizer
  slot, the same gate decision and ``meta()`` keys. JAX's run is shared
  by the tests through one fixture, run once a session under a file lock.
- The export: the ``.npz`` reads back equal through JAX's
  ``load_adapter_file`` and the port's.
- Adapter checkpoints, the port against itself at adapter dropout 0.1:
  a resume from the step-4 checkpoint (the base built again from the
  seed) gives the uninterrupted run's losses, eval losses and factors bit
  for bit; the checkpoint holds the factors, their optimizer state and
  the generator, no base tensor; a checkpoint of other factor shapes is
  refused. LoRA training under each remat mode equals ``none`` bit for
  bit with adapter dropout 0.1.
- The CLI (``python -m dtc_tpu_torch.adapters.finetune``) exits 0, 1 and
  2 where ``scripts/finetune_adapter.py`` does; LoRA under a pipeline
  raises JAX's ValueError.
"""

import dataclasses
import importlib.util
import json
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dtc_tpu.config import schema as js
from dtc_tpu_torch.adapters import finetune as ft
from dtc_tpu_torch.adapters.lora import load_adapter_file, save_adapter
from dtc_tpu_torch.config import schema as ts
from dtc_tpu_torch.models.gpt import adapter_param_count
from dtc_tpu_torch.parity import from_flax, lora_from_flax
from dtc_tpu_torch.train.trainer import train
from tests.conftest import make_train_cfg
from tests.test_torch_train import _one_thread, _port  # noqa: F401  (_one_thread: autouse)

ROOT = Path(__file__).resolve().parent.parent
STEPS = 6
JAX_OPT = js.OptimConfig(lr=1e-2, weight_decay=0.1, grad_clip=1.0)


def _model(**adapter):
    kw = dict(rank=4, alpha=8.0)
    kw.update(adapter)
    return js.ModelConfig(vocab_size=97, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                          max_seq_len=32, dropout=0.0, param_dtype="float32",
                          compute_dtype="float32", attention="dense",
                          adapter=js.AdapterConfig(**kw))


def _train_cfg(tmp, name, **over):
    kw = dict(steps=STEPS, log_every=2, eval_every=2, eval_batches=2, checkpoint_every=2,
              warmup_steps=1, output_dir=str(tmp / name), checkpoint_dir=str(tmp / f"{name}_ckpt"),
              obs=js.ObsConfig(enabled=False))
    kw.update(over)
    return make_train_cfg("dp", **kw)


def _flax_init(cfg, seed=0):
    """JAX's ``init_adapter_state`` init: the base and the factors of one
    ``model.init`` at ``PRNGKey(seed)``, as numpy."""
    from dtc_tpu.models.gpt import GPT as JGPT

    v = jax.jit(lambda r, x: JGPT(cfg).init({"params": r, "dropout": r}, x, train=False))(
        jax.random.PRNGKey(seed), jnp.ones((1, cfg.max_seq_len), jnp.int32))
    numpy = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return numpy(v["params"]), numpy(v["lora"])


@pytest.fixture(scope="session")
def jax_finetune(tmp_path_factory):
    """JAX's ``finetune_adapter`` once a session (the first xdist worker to
    ask, under a file lock): its outcome as numpy, with the init it
    started from."""
    from filelock import FileLock

    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    out = base / "jax_finetune_oracle"
    with FileLock(str(out) + ".lock"):
        if not (out / "run.pkl").exists():
            from dtc_tpu.adapters.finetune import finetune_adapter as jfinetune

            out.mkdir(exist_ok=True)
            cfg = _train_cfg(out, "run")
            res = jfinetune(cfg, _model(), JAX_OPT)
            params, lora = _flax_init(_model())
            numpy = lambda t: jax.tree.map(np.asarray, jax.device_get(t))  # noqa: E731
            run = dict(losses=res.losses, eval_first=res.eval_first, eval_final=res.eval_final,
                       gate=res.gate_passed, adapter=numpy(res.adapter),
                       meta=res.meta(_model(), cfg), base=params, lora=lora,
                       evals=_read_evals(out / "run" / "eval_log.csv"))
            with open(out / "run.pkl.tmp", "wb") as f:
                pickle.dump(run, f)
            os.replace(out / "run.pkl.tmp", out / "run.pkl")
    with open(out / "run.pkl", "rb") as f:
        return pickle.load(f)


def _read_evals(path):
    rows = Path(path).read_text().splitlines()[1:]
    return [(int(r.split(",")[0]), float(r.split(",")[1])) for r in rows]


def _port_finetune(tmp, name="port", jax_run=None, **over):
    """The port's finetune on the tiny model, from JAX's init when given."""
    cfg = _port(ts.TrainConfig, _train_cfg(tmp, name, **over))
    kw = {} if jax_run is None else dict(params=jax_run["base"], lora=jax_run["lora"])
    return ft.finetune_adapter(cfg, _port(ts.ModelConfig, _model()),
                               _port(ts.OptimConfig, JAX_OPT), device="cpu", **kw), cfg


def test_finetune_matches_jax_finetune_adapter(tmp_path, jax_finetune):
    run = jax_finetune
    got, cfg = _port_finetune(tmp_path, jax_run=run)
    np.testing.assert_allclose(got.losses, run["losses"], rtol=2e-4)
    assert len(got.losses) == STEPS
    assert _read_evals(tmp_path / "port" / "eval_log.csv") == [
        (s, pytest.approx(v, rel=2e-4)) for s, v in run["evals"]]
    np.testing.assert_allclose([got.eval_first, got.eval_final],
                               [run["eval_first"], run["eval_final"]], rtol=2e-4)
    want = lora_from_flax(run["adapter"])
    assert sorted(got.adapter) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got.adapter[k].numpy(), v.numpy(), rtol=0, atol=3e-4,
                                   err_msg=k)
        assert not torch.equal(v, lora_from_flax(run["lora"])[k]), f"{k} never moved"
    # the base: bit-equal to its start, frozen, outside the optimizer
    start = from_flax(run["base"], _port(ts.ModelConfig, _model()))
    assert sorted(got.base_params) == sorted(start)
    for k, v in start.items():
        assert torch.equal(got.base_params[k], v), k
        assert not got.base_params[k].requires_grad
    assert got.gate_passed == run["gate"] and got.gate_passed
    assert got.meta(_port(ts.ModelConfig, _model()), cfg).keys() == run["meta"].keys()


def test_finetune_trains_the_adapter_alone(tmp_path):
    """The trainer's state is the factors: the optimizer's parameters are
    the result's adapter tensors, the model's parameters have no ``.grad``
    and require none, and ``TrainResult.base_params`` is the model's."""
    cfg = _port(ts.TrainConfig, _train_cfg(tmp_path, "alone", steps=2, checkpoint_every=0))
    res = train(cfg, _port(ts.ModelConfig, _model()), _port(ts.OptimConfig, JAX_OPT),
                device="cpu")
    assert [id(p) for p in res.optimizer.params] == [id(v) for v in res.adapter.values()]
    assert all(p.grad is None and not p.requires_grad for p in res.model.parameters())
    assert all(v.requires_grad and v.grad is not None for v in res.adapter.values())
    assert len(res.optimizer.mu) == len(res.adapter)
    assert res.base_params.keys() == res.model.state_dict().keys()
    assert sum(v.numel() for v in res.adapter.values()) == adapter_param_count(res.model.cfg)


def test_export_reads_back_through_both_packages(tmp_path):
    """The artifact of a port finetune: JAX's ``load_adapter_file`` (into
    the model's lora tree) and the port's give the factors and the meta."""
    from dtc_tpu.adapters.lora import load_adapter_file as jload
    from dtc_tpu.models.gpt import GPT as JGPT

    got, cfg = _port_finetune(tmp_path, steps=2, checkpoint_every=0)
    path = str(tmp_path / "adapter.npz")
    meta = got.meta(_port(ts.ModelConfig, _model()), cfg)
    save_adapter(path, got.adapter, meta)
    like = jax.eval_shape(lambda: JGPT(_model()).init(
        {"params": jax.random.PRNGKey(0)}, jnp.ones((1, 1), jnp.int32), train=False))["lora"]
    jtree, jmeta = jload(path, like=like)
    ptree, pmeta = load_adapter_file(path, like=got.adapter)
    assert jmeta == pmeta == json.loads(json.dumps(meta))
    jport = lora_from_flax(jax.tree.map(np.asarray, jtree))
    for k, v in got.adapter.items():
        assert torch.equal(ptree[k], v) and torch.equal(jport[k], v), k


# ---------------------------------------------------------------------------
# adapter checkpoints and remat (the port against itself)
# ---------------------------------------------------------------------------

def _port_run(tmp, name, model=None, **over):
    cfg = _port(ts.TrainConfig, _train_cfg(tmp, name, **over))
    return train(cfg, model or _port(ts.ModelConfig, _model(dropout=0.1)),
                 _port(ts.OptimConfig, JAX_OPT), device="cpu")


def test_adapter_checkpoint_resume_is_bit_exact(tmp_path):
    """Adapter dropout 0.1 (the masks replayed from the checkpointed
    generator): 4 steps and a resume to 6 equal 6 uninterrupted steps bit
    for bit, eval included; the step holds the adapter, its optimizer
    state and the generator, no base tensor, about 1% of a full one."""
    from dtc_tpu_torch.utils.checkpoint import CheckpointManager

    full = _port_run(tmp_path, "full")
    part = _port_run(tmp_path, "part", steps=4)
    mgr = CheckpointManager(str(tmp_path / "part_ckpt"))
    assert mgr.all_steps() == [2, 4]
    saved = mgr.restore(4)
    assert sorted(saved) == ["adapter", "optimizer", "rng"]
    assert sorted(saved["adapter"]) == sorted(full.adapter)
    assert len(saved["optimizer"]["mu"]) == len(full.adapter)
    assert sorted(os.listdir(mgr.step_dir(4))) == ["adapter.pt", "optimizer.pt", "rng_p0.pt"]
    resumed = _port_run(tmp_path, "part")
    assert part.losses + resumed.losses == full.losses and len(resumed.losses) == 2
    assert part.eval_losses + resumed.eval_losses == full.eval_losses
    for k, v in full.adapter.items():
        assert torch.equal(resumed.adapter[k], v), k
    for k, v in full.base_params.items():
        assert torch.equal(resumed.base_params[k], v), k


@pytest.mark.parametrize("other", [dict(rank=2), dict(target_modules=["q_proj", "v_proj"]),
                                   "full"])
def test_adapter_checkpoint_of_other_shapes_is_refused(tmp_path, other):
    """A checkpoint whose factors are not this finetune's (another rank,
    other targets, or a full training's model) is refused on resume."""
    _port_run(tmp_path, "a", steps=2)
    if other == "full":
        model = dataclasses.replace(_port(ts.ModelConfig, _model()), adapter=ts.AdapterConfig())
        cfg = _port(ts.TrainConfig, _train_cfg(tmp_path, "b", steps=2))
        train(cfg, model, _port(ts.OptimConfig, JAX_OPT), device="cpu")
        with pytest.raises(ValueError, match="adapter factors"):
            _port_run(tmp_path, "b", steps=4)
        return
    with pytest.raises(ValueError, match="adapter factors"):
        _port_run(tmp_path, "a", model=_port(ts.ModelConfig, _model(dropout=0.1, **other)),
                  steps=4)


@pytest.mark.parametrize("mode", ["block", "block_save_flash", "mlp"])
def test_lora_training_under_remat_equals_none(tmp_path, mode):
    """LoRA training with adapter and model dropout 0.1 under each remat
    mode: the recompute replays the adapter's masks too, so the losses and
    factors equal ``none``'s bit for bit."""
    def run(remat, name):
        model = _port(ts.ModelConfig, dataclasses.replace(
            _model(dropout=0.1), dropout=0.1, remat=remat))
        return _port_run(tmp_path, name, model=model, steps=3, checkpoint_every=0, eval_every=0)

    ref, got = run(False, "none"), run(mode, mode)
    assert got.losses == ref.losses
    for k, v in ref.adapter.items():
        assert torch.equal(got.adapter[k], v), k


# ---------------------------------------------------------------------------
# the CLI and the refusals
# ---------------------------------------------------------------------------

def _write_configs(tmp: Path, rank: int, eval_every: int) -> Path:
    """A finetune config of the tiny model with its sibling model and optim
    configs (the shapes both CLIs read)."""
    m = _model()
    (tmp / "model_config.yaml").write_text("\n".join(
        f"{k}: {v}" for k, v in (("vocab_size", m.vocab_size), ("d_model", m.d_model),
                                 ("n_layers", m.n_layers), ("n_heads", m.n_heads),
                                 ("d_ff", m.d_ff), ("max_seq_len", m.max_seq_len),
                                 ("dropout", 0.0), ("param_dtype", "float32"),
                                 ("compute_dtype", "float32"), ("attention", "dense"))) + "\n")
    (tmp / "optim_config.yaml").write_text("lr: 1.0e-2\nweight_decay: 0.1\ngrad_clip: 1.0\n")
    path = tmp / "finetune.yaml"
    path.write_text(
        f"seed: 0\nparallel: dp\nbatch: 8\nsteps: 2\nlog_every: 1\noutput_dir: {tmp / 'out'}\n"
        f"dataset: synthetic\nwarmup_steps: 0\nprefetch: 0\neval_every: {eval_every}\n"
        "eval_batches: 1\nobs:\n  enabled: false\n"
        f"adapter:\n  rank: {rank}\n  alpha: 8.0\n  dropout: 0.0\n")
    return path


def _jax_cli(argv) -> int:
    spec = importlib.util.spec_from_file_location(
        "finetune_adapter_cli", ROOT / "scripts" / "finetune_adapter.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    old = sys.argv
    sys.argv = ["finetune_adapter.py"] + argv
    try:
        return mod.main()
    finally:
        sys.argv = old


@pytest.mark.parametrize("case,rank,eval_every,extra,code", [
    ("export", 4, 1, [], 0), ("gate_fails", 4, 1, ["--gate-ratio", "0"], 1),
    ("rank_0", 0, 1, [], 2), ("no_eval", 4, 0, [], 2),
])
def test_cli_exit_codes_match_jax(tmp_path, case, rank, eval_every, extra, code):
    """0 exported, 1 the gate failed and nothing written, 2 a config error:
    the port's CLI and JAX's on the same config."""
    got = {}
    for name, cli in (("port", lambda a: ft.main(a + ["--device", "cpu"])), ("jax", _jax_cli)):
        d = tmp_path / name
        d.mkdir()
        cfg = _write_configs(d, rank, eval_every)
        out = d / "adapter.npz"
        got[name] = (cli(["--finetune_config", str(cfg), "--out", str(out)] + extra),
                     out.exists())
    assert got["port"] == got["jax"] == (code, code == 0)
    if code == 0:
        _, meta = load_adapter_file(str(tmp_path / "port" / "adapter.npz"))
        assert meta["gate_passed"] and meta["rank"] == rank


def test_lora_under_pipeline_raises_jax_error(train_cfg_factory):
    """``tests/test_adapters.py::test_lora_under_pp_raises``: ValueError
    naming the pipeline, with JAX's words."""
    from dtc_tpu.train.trainer import train as jtrain

    cfg = train_cfg_factory("pp", pp_microbatches=2)
    with pytest.raises(ValueError, match="pipeline") as want:
        jtrain(cfg, _model(rank=2), JAX_OPT)
    with pytest.raises(ValueError, match="pipeline") as got:
        train(_port(ts.TrainConfig, cfg), _port(ts.ModelConfig, _model(rank=2)),
              _port(ts.OptimConfig, JAX_OPT), device="cpu")
    assert str(got.value) == str(want.value)
