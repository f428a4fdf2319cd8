"""The port's GPT against the JAX package's, with the flax weights carried
across by ``parity.from_flax``: parameter counts, the full forward, and
KV-cache decode (prefill, then single-token steps at scalar and per-row
frontiers, through each decode attention backend).

Tolerances: float32 compute 1e-4 on the logits (summation order only).
bfloat16 compute 0.125, four bf16 ulps at |logit| ~ 4: both packages
round every matmul output, the residual stream and the logits to bf16,
but at different places inside fused ops, so an ulp or two of drift
accumulates over the four layers.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dtc_tpu.analysis.lowering import audit_model_cfg
from dtc_tpu.config.loader import load_yaml_dataclass as jload
from dtc_tpu.config.schema import ModelConfig as JCfg
from dtc_tpu.generate import decode_step as jdecode_step
from dtc_tpu.generate import init_cache as jinit_cache
from dtc_tpu.models.gpt import GPT as JGPT
from dtc_tpu.models.gpt import param_count as jparam_count
from dtc_tpu_torch.config.loader import load_yaml_dataclass as tload
from dtc_tpu_torch.config.schema import ModelConfig as TCfg
from dtc_tpu_torch.generate import decode_step, init_cache
from dtc_tpu_torch.models.gpt import GPT, param_count
from dtc_tpu_torch.parity import from_flax
from tests.test_torch_train import _one_thread  # noqa: F401  (autouse: one intra-op thread)


TOL = {"float32": 1e-4, "bfloat16": 0.125}


def _pair(**over):
    """The JAX and port models on one tiny config, same weights."""
    jcfg = audit_model_cfg(**over)
    kw = {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__ if f != "adapter"}
    tcfg = TCfg(**kw)
    jm = JGPT(jcfg)
    params = jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.ones((1, 1), jnp.int32), train=False
    )["params"]
    tm = GPT(tcfg, device="cpu")
    tm.load_state_dict(from_flax(jax.tree.map(np.asarray, params), tcfg))
    return jm, params, tm


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)),
        atol=tol, rtol=0,
    )


@pytest.mark.parametrize("name", ["model_config.yaml", "model_config_dev.yaml"])
def test_param_count_matches_jax(name):
    jcfg = jload(f"configs/{name}", JCfg)
    tcfg = tload(f"configs/{name}", TCfg)
    assert param_count(tcfg) == jparam_count(jcfg)
    if name == "model_config.yaml":
        assert param_count(tcfg) // 100_000 == 896  # GPT-89.6M


def test_module_parameters_add_up_to_param_count():
    cfg = tload("configs/model_config_dev.yaml", TCfg)
    model = GPT(cfg, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == param_count(cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_jax(dtype):
    jm, params, tm = _pair(compute_dtype=dtype)
    x = np.random.RandomState(0).randint(0, 97, size=(2, 12)).astype(np.int32)
    want = jm.apply({"params": params}, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, TOL[dtype])
    # Pad columns are masked in both.
    assert (got[..., 97:].float() < -1e8).all()


_DECODE = [
    ("float32", "fused", "auto", "scalar"),
    ("float32", "fused", "auto", "per_row"),
    ("float32", "xla", "auto", "scalar"),
    ("float32", "xla", "auto", "per_row"),
    ("bfloat16", "fused", "auto", "per_row"),
    ("float32", "fused", "int8", "per_row"),
]


@pytest.mark.parametrize("dtype,backend,kv,frontier", _DECODE)
def test_decode_logits_match_jax(dtype, backend, kv, frontier):
    """Prefill 7 tokens, then 6 single-token steps on fixed tokens. With
    ``per_row`` the frontier becomes a (B,) vector after prefill, each row
    at its own position (the serving slots' layout)."""
    jm, params, tm = _pair(compute_dtype=dtype, decode_attention=backend,
                           kv_cache_dtype=kv)
    rng = np.random.RandomState(1)
    b = 3
    prompt = rng.randint(0, 97, size=(b, 7)).astype(np.int32)
    steps = rng.randint(0, 97, size=(6, b, 1)).astype(np.int32)
    jstep = jax.jit(lambda p, c, t: jdecode_step(jm, p, c, t))
    jc = jinit_cache(jm, b)
    tc = init_cache(tm, b)
    jc, jl = jstep(params, jc, jnp.asarray(prompt))
    tc, tl = decode_step(tm, tc, torch.from_numpy(prompt))
    _close(tl, jl, TOL[dtype])
    if frontier == "per_row":
        idx = np.array([7, 5, 3], np.int32)
        jc = dict(jc)
        jc["index"] = jnp.asarray(idx)
        tc["index"] = torch.from_numpy(idx)
    for tok in steps:
        jc, jl = jstep(params, jc, jnp.asarray(tok))
        tc, tl = decode_step(tm, tc, torch.from_numpy(tok))
        _close(tl, jl, TOL[dtype])
    assert tuple(tc["index"].shape) == ((b,) if frontier == "per_row" else ())
    np.testing.assert_array_equal(tc["index"].numpy(), np.asarray(jc["index"]))
