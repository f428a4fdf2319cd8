"""Rematerialisation in the port (``remat``: ``block`` / ``true``,
``block_save_flash``, ``mlp``) against the JAX package's same modes and
against the port's own ``remat: none``, the memory budget against JAX's,
and the long-context slice as a whole: an 8-step ``train()`` trajectory
with ``block_save_flash`` against JAX's, whose backward takes its packed
split kernels (TPU kernel rows 8-9).

Tolerances: against JAX, float32, loss and gradients of one forward 1e-5 ×
the largest |value| (summation order only); trainer losses 2e-4, as
``tests/test_torch_train.py`` holds ``train()`` to JAX's. Against the
port's ``none``: the same bits, generator state included, with dropout
0.1: a recompute that drew new keep masks would change the gradients.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dtc_tpu.config import schema as js
from dtc_tpu.models.gpt import GPT as JGPT
from dtc_tpu.ops import flash_attention as jfa
from dtc_tpu.train.trainer import train as jtrain
from dtc_tpu.utils.metrics import train_memory_bytes as jtrain_memory_bytes
from dtc_tpu_torch.config import schema as ts
from dtc_tpu_torch.models import gpt as gpt_mod
from dtc_tpu_torch.models.gpt import GPT
from dtc_tpu_torch.ops import flash_attention as tfa
from dtc_tpu_torch.parity import from_flax
from dtc_tpu_torch.train.trainer import train
from dtc_tpu_torch.utils.metrics import train_memory_bytes
from tests.conftest import make_train_cfg
from tests.test_torch_train import (  # noqa: F401  (_one_thread: autouse)
    _close, _flax_params, _one_thread, _port,
)


MODES = ["block", "block_save_flash", "mlp", True]


def _jax_cfg(**over):
    base = dict(vocab_size=97, d_model=128, n_layers=2, n_heads=4, d_ff=256, max_seq_len=128,
                dropout=0.0, param_dtype="float32", compute_dtype="float32", attention="flash")
    base.update(over)
    return js.ModelConfig(**base)


@pytest.mark.parametrize("mode,n_heads", [(m, 4) for m in MODES] + [("block_save_flash", 2)])
def test_remat_matches_jax_same_mode(mode, n_heads, monkeypatch):
    """GPT(x, train=True, targets=y) under each remat mode, dropout 0,
    float32, ``attention: flash``: the loss and every parameter gradient
    against JAX's model under the same mode. 4 heads of 32 take JAX's
    packed kernels; 2 heads of 48 (d_model 96) its transpose-layout family
    (``_flash``), whose residuals ``block_save_flash`` saves by the same
    names."""
    head_dim = 32 if n_heads == 4 else 48
    cfg = _jax_cfg(n_heads=n_heads, d_model=n_heads * head_dim, remat=mode)
    transposed = jfa._packed_group(head_dim, n_heads) is None
    assert transposed == (head_dim == 48)
    params = _flax_params(cfg)
    routes = []
    real_flash = jfa._flash
    monkeypatch.setattr(jfa, "_flash", lambda *a: routes.append(1) or real_flash(*a))
    rng = np.random.RandomState(2)
    x = rng.randint(0, 97, size=(2, 128)).astype(np.int32)
    y = rng.randint(0, 97, size=(2, 128)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JGPT(cfg).apply({"params": p}, jnp.asarray(x), train=True,
                                  targets=jnp.asarray(y))
    )(jax.tree.map(jnp.asarray, params))
    assert bool(routes) == transposed
    tcfg = _port(ts.ModelConfig, cfg)
    assert tcfg.remat_mode == js.ModelConfig(**dataclasses.asdict(cfg)).remat_mode != "none"
    model = GPT(tcfg, device="cpu")
    model.load_state_dict(from_flax(params, tcfg))
    loss = model(torch.from_numpy(x), train=True, targets=torch.from_numpy(y))
    loss.backward()
    _close(loss, jloss, "loss")
    want = from_flax(jax.tree.map(np.asarray, jgrads), tcfg)
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        _close(got[name].grad, g.numpy(), name)


def _step_bits(mode, dtype, attention):
    cfg = ts.ModelConfig(vocab_size=97, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                         max_seq_len=64, dropout=0.1, compute_dtype=dtype,
                         attention=attention, remat=mode)
    model = GPT(cfg, device="cpu", seed=0)
    x = torch.randint(0, 97, (2, 64), generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(3)
    loss = model(x, train=True, targets=x.roll(-1, 1), generator=gen)
    loss.backward()
    return loss.detach(), [p.grad for p in model.parameters()], gen.get_state()


@pytest.mark.parametrize("attention", ["flash", "dense"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_remat_gives_the_bits_of_none_with_dropout(mode, dtype, attention):
    """With dropout 0.1 every mode gives ``none``'s loss and gradients bit
    for bit and leaves the generator in the same state: the recompute
    replays the forward's keep masks and does not advance the generator
    (a plain ``torch.utils.checkpoint`` fails both)."""
    loss, grads, state = _step_bits(mode, dtype, attention)
    loss0, grads0, state0 = _step_bits("none", dtype, attention)
    assert torch.equal(loss, loss0)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads0))
    assert torch.equal(state, state0)


def test_remat_recomputes_what_its_mode_says(monkeypatch):
    """Flash forward calls in one training step of 2 layers: ``block``
    re-runs the forward in the backward (4), ``block_save_flash`` and
    ``mlp`` do not (2); and the bytes saved for the backward outside any
    checkpoint order ``block`` < ``block_save_flash`` < ``mlp`` < ``none``
    (the CPU's view of phase 14's peak memory order on the card)."""
    calls = []
    real = tfa.flash_attention_forward

    def counting(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(tfa, "flash_attention_forward", counting)
    saved = {}
    for mode in ("none", "block", "block_save_flash", "mlp"):
        cfg = ts.ModelConfig(vocab_size=97, d_model=64, n_layers=2, n_heads=4, d_ff=256,
                             max_seq_len=64, dropout=0.1, compute_dtype="bfloat16",
                             attention="flash", remat=mode)
        model = GPT(cfg, device="cpu", seed=0)
        x = torch.randint(0, 97, (2, 64), generator=torch.Generator().manual_seed(1))
        storages = {}

        def pack(t):
            storages[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
            return t

        calls.clear()
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = model.stage(model.embed(x), train=True, gen=torch.Generator().manual_seed(0))
        loss.float().sum().backward()
        assert len(calls) == {"block": 4}.get(mode, 2), mode
        saved[mode] = sum(storages.values())
    assert saved["block"] < saved["block_save_flash"] < saved["mlp"] < saved["none"], saved


def test_remat_only_in_training_with_gradients(monkeypatch):
    """Evaluation and decode run the plain forward: no checkpoint."""
    def refuse(*args, **kw):
        raise AssertionError("checkpointed outside training")

    monkeypatch.setattr(gpt_mod, "_recompute", refuse)
    cfg = ts.ModelConfig(vocab_size=97, d_model=32, n_layers=1, n_heads=2, d_ff=64,
                         max_seq_len=16, compute_dtype="float32", remat="block")
    model = GPT(cfg, device="cpu")
    x = torch.randint(0, 97, (1, 16))
    model(x)
    with torch.no_grad():
        model(x, train=True, targets=x)


@pytest.mark.parametrize("attention", ["flash", "dense"])
@pytest.mark.parametrize("mode", ["none"] + MODES)
def test_train_memory_bytes_matches_jax(mode, attention):
    jcfg = js.ModelConfig(vocab_size=50258, d_model=512, n_layers=12, n_heads=16, d_ff=2048,
                          max_seq_len=4096, compute_dtype="bfloat16", attention=attention,
                          remat=mode)
    want = jtrain_memory_bytes(jcfg, 4, 4096, {"data": 1, "model": 1, "pipe": 1}, "dp")
    assert train_memory_bytes(_port(ts.ModelConfig, jcfg), 4, 4096) == want


def test_train_losses_match_jax_with_block_save_flash_and_split_backward(monkeypatch, opt_cfg):
    """The long-context slice at a tiny size: 8 ``train()`` steps at T 256
    with ``remat: block_save_flash`` and ``attention: flash``, JAX with
    ``_PACKED_MAX_T`` lowered to 128 so that its backward takes the packed
    split kernels (rows 8-9) at blocks of 128, against the port."""
    monkeypatch.setattr(jfa, "_PACKED_MAX_T", 128)
    calls = []
    real = jfa._packed_split_bwd_call
    monkeypatch.setattr(jfa, "_packed_split_bwd_call",
                        lambda *a: calls.append(1) or real(*a))
    mcfg = js.ModelConfig(vocab_size=97, d_model=128, n_layers=2, n_heads=4, d_ff=256,
                          max_seq_len=256, dropout=0.0, param_dtype="float32",
                          compute_dtype="float32", attention="flash", remat="block_save_flash",
                          attention_block_q=128, attention_block_kv=128,
                          attention_block_q_bwd=128, attention_block_kv_bwd=128)
    jcfg = make_train_cfg("dp", steps=8, batch=8, log_every=4)
    want = np.asarray(jtrain(jcfg, mcfg, opt_cfg).losses)
    assert calls, "JAX did not take its split backward"
    tcfg = _port(ts.TrainConfig, jcfg, obs=ts.ObsConfig(enabled=False))
    got = np.asarray(train(tcfg, _port(ts.ModelConfig, mcfg), _port(ts.OptimConfig, opt_cfg),
                           device="cpu", params=_flax_params(mcfg)).losses)
    assert got.shape == want.shape == (8,)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
