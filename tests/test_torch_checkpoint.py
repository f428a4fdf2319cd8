"""Checkpoints, resume, held-out eval and the guard's ladder in the port,
against the JAX package on the CPU:

- the checkpoint manager: the behaviours of ``tests/test_resilience.py``'s
  manager tests (each test names the one it follows), on the port's
  ``torch.save`` layout;
- skip-nonfinite: the optimizer against ``optax.apply_if_finite(chain(clip,
  adamw))`` on the same parameters and gradients, non-finite steps
  included, at 1e-6 after every step;
- the guard's decisions against JAX's ``AnomalyGuard`` on the same windows;
- the trainer against JAX's ``train()`` (tiny model, dropout 0, float32, at
  JAX's rtol 2e-4): the resumed losses, the eval losses, and a resume from
  a JAX checkpoint carried across by ``parity.from_flax`` and
  ``parity.adam_from_optax``. JAX's two runs (4 steps with checkpoints
  every 2, then its resume to 6) are shared by every test through one
  fixture, run once a session under a file lock;
- the port against itself at dropout 0.1, bit for bit: resume, the NaN
  rollback (aligned and misaligned boundaries), a poisoned save skipped,
  the tolerate rung under skip-nonfinite, SIGTERM, and the FineWeb resume
  through injected documents, with the held-out split.

The NaN drills wrap the trainer's ``train_step`` as the JAX package's chaos
``maybe_poison`` acts: after the update of one loop step the parameters
and the loss are multiplied by NaN, once.
"""

import dataclasses
import glob
import json
import os
import pickle
import signal

import numpy as np
import pytest
import torch

from dtc_tpu.config import schema as js
from dtc_tpu.resilience.guard import AnomalyGuard as JGuard
from dtc_tpu_torch.config import schema as ts
from dtc_tpu_torch.config.loader import _build
from dtc_tpu_torch.resilience.guard import AnomalyGuard
from dtc_tpu_torch.train import trainer as trainer_mod
from dtc_tpu_torch.train.optimizer import create_optimizer
from dtc_tpu_torch.utils.checkpoint import CheckpointManager
from tests.test_torch_train import _one_thread  # noqa: F401  (autouse: one intra-op thread)


# ---------------------------------------------------------------------------
# the checkpoint manager
# ---------------------------------------------------------------------------


def _mini_state(v: float):
    return {"model": {"w": torch.full((4, 4), float(v))}, "optimizer": {"count": int(v)}}


def _corrupt_largest_file(root: str) -> str:
    target = max((os.path.join(d, n) for d, _, names in os.walk(root) for n in names),
                 key=os.path.getsize)
    with open(target, "r+b") as f:
        f.truncate(os.path.getsize(target) // 2)
    return target


def test_checkpoint_manifest_written_and_verified(tmp_path):
    """``test_checkpoint_manifest_written_and_verified``: the manifest lists
    every file of the step with its size and sha256; the step verifies, and
    a rank's own file restores to that rank alone."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, _mini_state(2), {"rng": torch.arange(3)}, process_index=1)
    manifest = json.load(open(tmp_path / "manifest_2.json"))
    assert manifest["step"] == 2
    assert sorted(manifest["files"]) == ["model.pt", "optimizer.pt", "rng_p1.pt"]
    assert mgr.verify_step(2) and mgr.bytes_written == sum(
        f["size"] for f in manifest["files"].values())
    got = mgr.restore(2, process_index=1)
    assert torch.equal(got["model"]["w"], torch.full((4, 4), 2.0))
    assert torch.equal(got["rng"], torch.arange(3)) and "rng" not in mgr.restore(2)
    assert not glob.glob(str(tmp_path / "*.partial")), "the step was renamed into place"


def test_corrupt_latest_falls_back_to_intact_step(tmp_path, capsys):
    """``test_corrupt_latest_falls_back_to_intact_step``: a truncated file
    of the newest step fails the manifest, ``latest_step`` and
    ``restore_latest`` land on the previous step, and the fallback is
    reported once."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, _mini_state(2))
    mgr.save(4, _mini_state(4))
    assert mgr.latest_step() == 4
    _corrupt_largest_file(mgr.step_dir(4))
    assert not mgr.verify_step(4)
    assert mgr.latest_step() == 2
    restored, step = mgr.restore_latest()
    assert step == 2 and torch.equal(restored["model"]["w"], torch.full((4, 4), 2.0))
    assert capsys.readouterr().out.count("checkpoint step 4 failed integrity") == 1
    # Without a manifest (verify=False) the truncated file fails to load and
    # the restore falls back all the same; none intact raises.
    unverified = CheckpointManager(str(tmp_path / "nv"), verify=False)
    unverified.save(1, _mini_state(1))
    unverified.save(3, _mini_state(3))
    _corrupt_largest_file(unverified.step_dir(3))
    assert unverified.restore_latest()[1] == 1
    _corrupt_largest_file(unverified.step_dir(1))
    with pytest.raises(FileNotFoundError, match="no intact checkpoint"):
        unverified.restore_latest()


def test_save_overwrites_stale_step_after_rollback(tmp_path):
    """``test_save_overwrites_stale_step_after_rollback``: a replay re-saves
    a corrupt step, which verifies again with the new state."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, _mini_state(2))
    _corrupt_largest_file(mgr.step_dir(2))
    assert mgr.latest_step() is None
    mgr.save(2, _mini_state(7))
    assert mgr.verify_step(2) and mgr.latest_step() == 2
    assert torch.equal(mgr.restore_latest()[0]["model"]["w"], torch.full((4, 4), 7.0))


def test_checkpoint_keep_n_gc_prunes_verified_older_steps(tmp_path):
    """``test_checkpoint_keep_n_gc_prunes_verified_older_steps``: keep_n
    bounds the steps, their manifests go with them, and the fallback still
    works inside the retained window."""
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    for s in (2, 4, 6, 8):
        mgr.save(s, _mini_state(s))
    assert mgr.all_steps() == [6, 8]
    assert sorted(os.path.basename(m) for m in glob.glob(str(tmp_path / "manifest_*"))) == [
        "manifest_6.json", "manifest_8.json"]
    assert not os.path.isdir(mgr.step_dir(2))
    _corrupt_largest_file(mgr.step_dir(8))
    restored, step = mgr.restore_latest()
    assert step == 6 and torch.equal(restored["model"]["w"], torch.full((4, 4), 6.0))
    with pytest.raises(ValueError, match="keep_n"):
        CheckpointManager(str(tmp_path / "bad"), keep_n=0)


def test_checkpoint_replay_resave_below_stale_latest_survives_gc(tmp_path):
    """``test_checkpoint_replay_resave_below_stale_latest_survives_gc``: a
    replay re-saves a step below a stale newer one; the re-save and its
    manifest survive retention, even at keep_n 1."""
    mgr = CheckpointManager(str(tmp_path), keep_n=3)
    for s in (10, 20, 30, 40):
        mgr.save(s, _mini_state(s))
    mgr2 = CheckpointManager(str(tmp_path), keep_n=3)
    mgr2.save(30, _mini_state(77))
    assert os.path.isdir(mgr2.step_dir(30)) and mgr2.verify_step(30)
    assert mgr2.all_steps() == [20, 30, 40]
    root1 = tmp_path / "k1"
    m = CheckpointManager(str(root1), keep_n=1)
    for s in (10, 20):
        m.save(s, _mini_state(s))
    m = CheckpointManager(str(root1), keep_n=1)
    m.save(10, _mini_state(5))
    assert os.path.isdir(m.step_dir(10)) and os.path.exists(root1 / "manifest_10.json")
    assert m.verify_step(10)


def test_sidecars_atomic_and_tolerant_of_torn_files(tmp_path):
    """``test_sidecars_atomic_and_tolerant_of_torn_files`` and
    ``tests/test_data.py::test_stream_position_sidecar_roundtrip``: stream
    and eval-set sidecars round-trip with no temp litter, are pruned to
    keep_n, and a torn one reads as missing."""
    mgr = CheckpointManager(str(tmp_path), verify=False)
    for step in (2, 4, 6, 8):
        mgr.save_stream(step, {"position": {"docs_consumed": step, "buffer": [1, 2]},
                               "stream_index": step}, 0)
    assert not glob.glob(str(tmp_path / "*.tmp"))
    assert mgr.load_stream(8, 0)["position"]["docs_consumed"] == 8
    assert mgr.load_stream(2, 0) is None and mgr.load_stream(4, 0) is not None
    (tmp_path / "stream_10_p0.json").write_text('{"position": {"docs')
    assert mgr.load_stream(10, 0) is None
    batches = [np.arange(6, dtype=np.int32).reshape(2, 3)]
    mgr.save_eval_set(batches, 0)
    assert not glob.glob(str(tmp_path / "*.tmp"))
    np.testing.assert_array_equal(mgr.load_eval_set(0)[0], batches[0])
    (tmp_path / "eval_set_p1.npz").write_bytes(b"not an npz")
    assert mgr.load_eval_set(1) is None


def test_a_save_cut_short_leaves_no_step(tmp_path):
    """Files land in ``<step>.partial/`` and the step exists only once
    committed: a save that dies before its commit is not a restore target,
    and the next save of that step starts clean."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, _mini_state(2))
    mgr.begin(4)
    mgr.write(4, {"model": {"w": torch.zeros(2)}})
    assert mgr.all_steps() == [2] and mgr.restore_latest()[1] == 2
    mgr.save(4, _mini_state(4))
    assert mgr.all_steps() == [2, 4] and sorted(os.listdir(mgr.step_dir(4))) == [
        "model.pt", "optimizer.pt"]


# ---------------------------------------------------------------------------
# skip-nonfinite against optax.apply_if_finite
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule,clip", [("constant", 1.0), ("warmup_cosine", 1.0),
                                           ("constant", 0.0)])
def test_skip_nonfinite_matches_optax_apply_if_finite(schedule, clip):
    """Gradient sequences with non-finite steps, among them a run of
    ``max_consecutive_skips + 1`` (the last of which optax applies): the
    parameters, both moments, the count and the skip count agree with
    optax's after every step (NaN where both are NaN)."""
    import jax
    import jax.numpy as jnp
    import optax

    cfg = ts.OptimConfig(lr=1e-2, weight_decay=0.1, grad_clip=clip, schedule=schedule,
                         warmup_steps=2, min_lr_ratio=0.1)
    total, skips = 10, 2
    lr = (cfg.lr if schedule == "constant" else
          optax.warmup_cosine_decay_schedule(0.0, cfg.lr, 2, total, cfg.lr * 0.1))
    inner = optax.adamw(lr, b1=cfg.b1, b2=cfg.b2, weight_decay=cfg.weight_decay)
    if clip:
        inner = optax.chain(optax.clip_by_global_norm(clip), inner)
    tx = optax.apply_if_finite(inner, max_consecutive_errors=skips)
    update = jax.jit(tx.update)
    rng = np.random.RandomState(3)
    p0 = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    jp = jax.tree.map(jnp.asarray, p0)
    state = tx.init(jp)
    tp = [torch.tensor(p0["a"], requires_grad=True), torch.tensor(p0["b"], requires_grad=True)]
    opt = create_optimizer(tp, cfg, total, skip_nonfinite=True, max_consecutive_skips=skips)
    bad = {1: np.nan, 4: np.inf, 5: np.nan, 6: -np.inf}   # 4-6: skips + 1 in a row
    for i in range(11):
        g = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
        if i in bad:
            g["b"][2] = bad[i]
        upd, state = update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        tp[0].grad, tp[1].grad = torch.tensor(g["a"]), torch.tensor(g["b"])
        opt.step()
        adam = next(s for s in jax.tree.leaves(
            state.inner_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState))
        assert int(opt.count) == int(adam.count), i
        assert int(opt.notfinite_count) == int(state.notfinite_count), i
        assert int(opt.total_notfinite) == int(state.total_notfinite), i
        for j, k in enumerate("ab"):
            for got, want in ((tp[j], jp[k]), (opt.mu[j], adam.mu[k]), (opt.nu[j], adam.nu[k])):
                np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-6, err_msg=f"step {i} {k}")
    assert int(opt.count) < 11 and not np.isfinite(tp[1].detach().numpy()).all()


def test_optimizer_state_dict_round_trip():
    """``state_dict`` / ``load_state_dict``: a second optimizer loaded from
    the first's state takes the same next step, bit for bit, with and
    without skip-nonfinite."""
    cfg = ts.OptimConfig(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    for skip in (False, True):
        rng = np.random.RandomState(0)
        ps = [[torch.tensor(rng.randn(3), requires_grad=True)] for _ in range(2)]
        ps[1][0].data.copy_(ps[0][0].data)
        opts = [create_optimizer(p, cfg, 5, skip_nonfinite=skip) for p in ps]
        for _ in range(3):
            ps[0][0].grad = torch.tensor(rng.randn(3))
            opts[0].step()
        ps[1][0].data.copy_(ps[0][0].data)
        opts[1].load_state_dict(opts[0].state_dict())
        g = torch.tensor(rng.randn(3))
        for p, o in zip(ps, opts):
            p[0].grad = g.clone()
            o.step()
        assert torch.equal(ps[0][0], ps[1][0]) and int(opts[1].count) == 4
    with pytest.raises(ValueError, match="shapes"):
        opts[1].load_state_dict({"count": 0, "mu": [torch.zeros(2)], "nu": [torch.zeros(2)]})


# ---------------------------------------------------------------------------
# the guard's ladder against JAX's
# ---------------------------------------------------------------------------

NAN, INF = float("nan"), float("inf")
GUARD_CASES = {
    "rollback_then_abort": (dict(max_rollbacks=1), True, [
        [1.0, 0.9], [NAN, 0.8], "rollback", [INF], [1.0]]),
    "warn_without_checkpoint": (dict(spike_factor=2.0, spike_window=4), False, [
        [5.0, 4.8], [4.6], [4.5, 4.4], [4.3], [9.5, 9.9], [NAN], [INF], [4.0], []]),
    "spike_vs_trailing_median": (dict(spike_factor=3.0), True, [
        [1.0, 1.1]] * 5 + [[10.0, 11.0], "rollback", [1.2], ("healthy", 10.0),
                           ("healthy", 1.2), ("healthy", NAN)]),
    "tolerate_then_rollback": (dict(skip_nonfinite_updates=True, max_consecutive_skips=2), True,
                               [[NAN], [NAN], [NAN], "rollback", [1.0], [NAN], "failed",
                                [INF], [INF], [INF]]),
    "forgiveness": (dict(max_rollbacks=1, clean_steps_to_forgive=3), True, [
        [NAN], "rollback", [1.0, 0.9], [1.0], [1.0], [NAN], "rollback", [1.0], [1.0], [INF]]),
    "lifetime_budget": (dict(max_rollbacks=1), True, [
        [NAN], "rollback"] + [[1.0]] * 10 + [[NAN]]),
}


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_guard_ladder_decisions_equal_jax(case):
    """Window by window the same action and reason as JAX's guard; the
    trainer's ``note_rollback`` / ``note_rollback_failed`` and the save
    gate's ``healthy_loss`` in between."""
    kw, can_rollback, script = GUARD_CASES[case]
    port = AnomalyGuard(ts.GuardConfig(**kw), can_rollback=can_rollback)
    ref = JGuard(js.GuardConfig(**kw), can_rollback=can_rollback)
    for step, event in enumerate(script):
        if event == "rollback":
            port.note_rollback(), ref.note_rollback()
        elif event == "failed":
            port.note_rollback_failed(), ref.note_rollback_failed()
        elif isinstance(event, tuple):
            assert port.healthy_loss(event[1]) == ref.healthy_loss(event[1])
        else:
            got, want = port.check_window(step, event), ref.check_window(step, event)
            assert (got.action, got.reason) == (want.action, want.reason), (step, event)
        assert port.rollbacks_done == ref.rollbacks_done


# ---------------------------------------------------------------------------
# the trainer against JAX's train()
# ---------------------------------------------------------------------------

JAX_RUN = dict(steps=4, warmup_steps=2, log_every=1, checkpoint_every=2, eval_every=2,
               eval_batches=2)


def _tiny_model(**over):
    return js.ModelConfig(vocab_size=97, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                          max_seq_len=32, dropout=0.0, param_dtype="float32",
                          compute_dtype="float32", attention="dense", **over)


JAX_OPT = js.OptimConfig(lr=1e-3, weight_decay=0.1, grad_clip=1.0)


@pytest.fixture(scope="session")
def jax_resume(tmp_path_factory):
    """JAX's ``train()`` run once a session (by the first xdist worker to
    ask, under a file lock): 4 steps after 2 warmup steps with checkpoints
    and eval every 2 steps, then its resume to 6. Gives both runs' losses
    and eval losses, the flax init and the step-4 checkpoint restored by
    JAX's own ``CheckpointManager`` (parameters, AdamW's moments and
    count), as numpy."""
    from filelock import FileLock

    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    out = base / "jax_checkpoint_oracle"
    with FileLock(str(out) + ".lock"):
        if not (out / "done").exists():
            import jax
            import optax

            from dtc_tpu.train.trainer import train as jtrain
            from dtc_tpu.utils.checkpoint import CheckpointManager as JManager
            from tests.conftest import make_train_cfg
            from tests.test_torch_train import _flax_params

            out.mkdir(exist_ok=True)
            cfg = make_train_cfg("dp", checkpoint_dir=str(out / "ckpt"),
                                 output_dir=str(out / "run"),
                                 obs=js.ObsConfig(enabled=False), **JAX_RUN)
            first = jtrain(cfg, _tiny_model(), JAX_OPT)
            restored, step = JManager(cfg.checkpoint_dir).restore_latest(first.state)
            adam = next(s for s in jax.tree.leaves(
                restored.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
                if isinstance(s, optax.ScaleByAdamState))
            numpy = lambda t: jax.tree.map(np.asarray, jax.device_get(t))  # noqa: E731
            with open(out / "state.pkl", "wb") as f:
                pickle.dump(dict(step=step, params=numpy(restored.params), mu=numpy(adam.mu),
                                 nu=numpy(adam.nu), count=int(adam.count),
                                 init=_flax_params(_tiny_model())), f)
            second = jtrain(dataclasses.replace(cfg, steps=6), _tiny_model(), JAX_OPT)
            (out / "runs.json").write_text(json.dumps(dict(
                first=first.losses, first_eval=first.eval_losses,
                second=second.losses, second_eval=second.eval_losses)))
            (out / "done").write_text("")
    with open(out / "state.pkl", "rb") as f:
        state = pickle.load(f)
    return json.loads((out / "runs.json").read_text()), state


def _port_cfg(tmp_path, name, **over):
    from tests.conftest import make_train_cfg

    kw = dict(JAX_RUN, output_dir=str(tmp_path / name),
              checkpoint_dir=str(tmp_path / f"{name}_ckpt"))
    kw.update(over)
    cfg = _build(ts.TrainConfig, dataclasses.asdict(make_train_cfg("dp", **kw)), "train")
    return dataclasses.replace(cfg, obs=ts.ObsConfig(enabled=False))


def _port(cls, cfg):
    return _build(cls, dataclasses.asdict(cfg), "test")


def test_resumed_and_eval_losses_match_jax(tmp_path, jax_resume):
    """The port trains 4 steps (checkpoints and eval every 2), then resumes
    to 6 from its own checkpoint: every loss and every eval loss matches
    JAX's runs at 2e-4; ``eval_log.csv`` holds ``step,loss`` rows, the
    resumed run appending to it."""
    runs, state = jax_resume
    model, opt = _port(ts.ModelConfig, _tiny_model()), _port(ts.OptimConfig, JAX_OPT)
    first = trainer_mod.train(_port_cfg(tmp_path, "a"), model, opt, device="cpu",
                              params=state["init"])
    second = trainer_mod.train(_port_cfg(tmp_path, "a", steps=6), model, opt, device="cpu")
    np.testing.assert_allclose(first.losses, runs["first"], rtol=2e-4)
    np.testing.assert_allclose(second.losses, runs["second"], rtol=2e-4)
    assert len(second.losses) == 2
    got_eval = first.eval_losses + second.eval_losses
    want_eval = runs["first_eval"] + runs["second_eval"]
    assert [s for s, _ in got_eval] == [s for s, _ in want_eval] == [2, 4, 6]
    np.testing.assert_allclose([v for _, v in got_eval], [v for _, v in want_eval], rtol=2e-4)
    rows = (tmp_path / "a" / "eval_log.csv").read_text().splitlines()
    assert rows[0] == "step,loss" and [r.split(",")[0] for r in rows[1:]] == ["2", "4", "6"]
    log = (tmp_path / "a" / "log.csv").read_text().splitlines()
    assert log[0] == "step,elapsed_time,loss"
    assert [r.split(",")[0] for r in log[1:]] == ["1", "2", "3", "4", "5", "6"]


def test_port_resumes_a_jax_checkpoint_like_jax(tmp_path, jax_resume):
    """JAX's step-4 checkpoint (restored by JAX's own manager) carried
    across by ``parity.from_flax`` and ``parity.adam_from_optax`` and
    written as a port checkpoint: the port resumes it to 6 and matches
    JAX's own resume, losses and eval."""
    from dtc_tpu_torch.models.gpt import GPT
    from dtc_tpu_torch.parity import adam_from_optax, from_flax

    runs, state = jax_resume
    model_cfg = _port(ts.ModelConfig, _tiny_model())
    names = [n for n, _ in GPT(model_cfg, device="cpu").named_parameters()]
    assert state["step"] == 4 and state["count"] == 6, "the count holds the 2 warmup updates"
    cfg = _port_cfg(tmp_path, "j", steps=6)
    CheckpointManager(cfg.checkpoint_dir).save(
        4, {"model": from_flax(state["params"], model_cfg),
            "optimizer": adam_from_optax(state["mu"], state["nu"], state["count"], model_cfg,
                                         names)},
        {"rng": torch.Generator().manual_seed(0).get_state()})
    res = trainer_mod.train(cfg, model_cfg, _port(ts.OptimConfig, JAX_OPT), device="cpu")
    np.testing.assert_allclose(res.losses, runs["second"], rtol=2e-4)
    assert res.eval_losses[0][0] == 6
    np.testing.assert_allclose(res.eval_losses[0][1], runs["second_eval"][0][1], rtol=2e-4)
    assert int(res.optimizer.count) == 8


# ---------------------------------------------------------------------------
# the port against itself, dropout 0.1, bit for bit
# ---------------------------------------------------------------------------

SELF_MODEL = ts.ModelConfig(vocab_size=97, d_model=32, n_layers=2, n_heads=2, d_ff=64,
                            max_seq_len=16, compute_dtype="float32", dropout=0.1)
SELF_OPT = ts.OptimConfig(lr=1e-3, weight_decay=0.1, grad_clip=1.0)


def _self_cfg(tmp_path, name, **over):
    cfg = ts.TrainConfig(seed=0, parallel="dp", batch=4, steps=6, log_every=1,
                         output_dir=str(tmp_path / name), dataset="synthetic", warmup_steps=2,
                         prefetch=2, checkpoint_every=2,
                         checkpoint_dir=str(tmp_path / f"{name}_ckpt"),
                         obs=ts.ObsConfig(enabled=False))
    return dataclasses.replace(cfg, **over)


def _run(cfg, model_cfg=SELF_MODEL):
    return trainer_mod.train(cfg, model_cfg, SELF_OPT, device="cpu")


@pytest.fixture
def poison(monkeypatch):
    """``poison(n)``: after the update of the trainer's ``n``-th
    ``train_step`` call (warmup included), once, multiply the parameters
    and the loss by NaN (the JAX package's chaos ``maybe_poison``)."""
    real = trainer_mod.train_step

    def arm(n):
        calls = [0]

        def poisoned(model, opt, *args):
            loss = real(model, opt, *args)
            calls[0] += 1
            if calls[0] == n:
                with torch.no_grad():
                    for p in model.parameters():
                        p.mul_(float("nan"))
                loss = loss * float("nan")
            return loss
        monkeypatch.setattr(trainer_mod, "train_step", poisoned)
    return arm


def test_resume_equals_the_uninterrupted_run(tmp_path):
    """``tests/test_checkpoint.py::test_resume_matches_uninterrupted``:
    4 steps, then a resume to 6 from the step-4 checkpoint (the stream
    seeked past warmup and 4 steps, the generators restored) gives the
    uninterrupted run's last two losses bit for bit; a resume into the same
    directory needs no ``overwrite``."""
    full = _run(_self_cfg(tmp_path, "full"))
    _run(_self_cfg(tmp_path, "part", steps=4))
    resumed = _run(_self_cfg(tmp_path, "part"))
    assert resumed.losses == full.losses[4:]
    assert len((tmp_path / "part" / "log.csv").read_text().splitlines()) == 7
    with pytest.raises(RuntimeError, match="no checkpoint could be restored"):
        for root in glob.glob(str(tmp_path / "part_ckpt" / "[0-9]*")):
            _corrupt_largest_file(root)
        _run(_self_cfg(tmp_path, "part", steps=8))


@pytest.mark.parametrize("log_every,checkpoint_every,nan_at,to_step", [
    (1, 2, 3, 2),    # tests/test_resilience.py::test_nan_rollback_synthetic_matches_clean
    (3, 2, 5, 4),    # ...::test_rollback_commits_window_prefix_when_boundaries_misalign
    (3, 1, 2, 1),    # ...::test_poisoned_checkpoint_is_never_saved
])
def test_nan_rollback_replays_the_clean_run(tmp_path, capsys, poison, log_every,
                                            checkpoint_every, nan_at, to_step):
    """NaN after the update of step ``nan_at``: the guard rolls back to the
    newest verified checkpoint (``to_step``), the stream is re-seeked and
    the generators restored, and the run's losses and ``log.csv`` rows
    equal the clean run's bit for bit. A save inside the poisoned window is
    skipped."""
    kw = dict(log_every=log_every, checkpoint_every=checkpoint_every)
    clean = _run(_self_cfg(tmp_path, "clean", **kw))
    poison(2 + nan_at)
    capsys.readouterr()
    drill = _run(_self_cfg(tmp_path, "drill", **kw))
    out = capsys.readouterr().out
    assert f"restored checkpoint step {to_step}," in out
    assert drill.losses == clean.losses
    rows = (tmp_path / "drill" / "log.csv").read_text().splitlines()
    assert [float(r.split(",")[2]) for r in rows[1:]] == clean.losses
    if checkpoint_every == 1:
        assert f"skipping checkpoint at step {nan_at}:" in out


def test_tolerate_rung_under_skip_nonfinite(tmp_path, capsys, poison):
    """skip-nonfinite: the poisoned parameters give non-finite gradients,
    whose updates the optimizer drops; the guard tolerates
    ``max_consecutive_skips`` windows, skips the unhealthy save, then rolls
    back, and the run ends with the clean run's losses and count."""
    guard = ts.GuardConfig(skip_nonfinite_updates=True, max_consecutive_skips=2)
    kw = dict(resilience=ts.ResilienceConfig(guard=guard))
    clean = _run(_self_cfg(tmp_path, "clean", **kw))
    poison(2 + 3)
    capsys.readouterr()
    drill = _run(_self_cfg(tmp_path, "drill", **kw))
    out = capsys.readouterr().out
    assert out.count("-> tolerate") == 2 and "skipping checkpoint at step 4" in out
    assert "restored checkpoint step 2," in out
    assert drill.losses == clean.losses
    assert int(drill.optimizer.count) == int(clean.optimizer.count) == 8


def test_sigterm_checkpoints_flushes_and_stops(tmp_path):
    """``tests/test_checkpoint.py::test_sigterm_checkpoints_flushes_and_stops``:
    SIGTERM sent from inside a caller's ``host_iterator`` stops the run,
    which checkpoints at the step it lands in, flushes ``log.csv`` (header
    and one row a step) and restores the previous handler."""
    from dtc_tpu_torch.data.synthetic import synthetic_batch_iterator

    cfg = _self_cfg(tmp_path, "term", steps=50, warmup_steps=0, checkpoint_every=1000)

    def signaling_batches():
        it = synthetic_batch_iterator(cfg.batch, SELF_MODEL.max_seq_len + 1, 97)
        for i, b in enumerate(it):
            if i == 7:
                os.kill(os.getpid(), signal.SIGTERM)
            yield b

    before = signal.getsignal(signal.SIGTERM)
    res = trainer_mod.train(cfg, SELF_MODEL, SELF_OPT, device="cpu",
                            host_iterator=signaling_batches())
    done = len(res.losses)
    assert 0 < done < 50
    assert CheckpointManager(cfg.checkpoint_dir).latest_step() == done
    assert len((tmp_path / "term" / "log.csv").read_text().splitlines()) == done + 1
    assert signal.getsignal(signal.SIGTERM) is before


def _fineweb(monkeypatch, docs, seq, calls):
    """``make_host_iterator`` over injected pre-tokenized documents (the
    JAX package's tests do the same); each construction's position is
    recorded, and a resumed one reads only unconsumed documents."""
    from dtc_tpu_torch.data.fineweb import FinewebStream
    from tests.test_data import _TailOnlySeq

    def fake(train_cfg, model_cfg, skip_batches=0, seed_offset=0, stream_position=None,
             history=64, chaos=None, on_recovery=None, cancel=None):
        calls.append(stream_position)
        source = docs
        if stream_position is not None:
            source = _TailOnlySeq(docs, stream_position["docs_consumed"])
        it = FinewebStream(train_cfg.batch, seq, documents=source, position=stream_position,
                           history=history, chaos=chaos, on_recovery=on_recovery,
                           cancel=cancel)
        for _ in range(skip_batches):
            next(it)
        return it
    monkeypatch.setattr(trainer_mod, "make_host_iterator", fake)


@pytest.mark.parametrize("holdout", [False, True])
def test_fineweb_resume_seeks_via_sidecar(tmp_path, monkeypatch, holdout):
    """``tests/test_checkpoint.py::test_fineweb_resume_seeks_via_sidecar``
    and ``::test_fineweb_resume_with_holdout_eval``: the resumed run is
    built from the checkpointed stream position (a seek, not a drain),
    keeps withholding the held-out batches it has not passed, and gives
    the uninterrupted run's losses and eval losses bit for bit."""
    from tests.test_data import _docs

    calls = []
    _fineweb(monkeypatch, _docs(n=2000, tokens=50), SELF_MODEL.max_seq_len + 1, calls)
    kw = dict(dataset="fineweb")
    if holdout:
        kw.update(eval_every=3, eval_batches=2, eval_holdout_every=4)
    full = _run(_self_cfg(tmp_path, "full", **kw))
    _run(_self_cfg(tmp_path, "part", steps=2 if holdout else 4, **kw))
    calls.clear()
    resumed = _run(_self_cfg(tmp_path, "part", **kw))
    assert resumed.losses == full.losses[-len(resumed.losses):]
    assert calls and calls[0] is not None and calls[0]["docs_consumed"] > 0
    if holdout:
        assert len(calls) == 1, "the eval set came from its sidecar, not the stream's head"
        full_evals = dict(full.eval_losses)
        assert resumed.eval_losses and all(full_evals[s] == v for s, v in resumed.eval_losses)
