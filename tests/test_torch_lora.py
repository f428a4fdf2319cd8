"""The port's LoRA adapters against the JAX package's (``dtc_tpu.adapters``),
on the CPU: the finetune config, the store, one bf16 site bit for bit, the
model's logits with adapters, the merge oracle and the ``.npz`` artifact.

Same flax weights and factors in both (``parity.from_flax`` /
``parity.lora_from_flax``). Two adapter scales: 16 / 6, which bfloat16
cannot hold, so a port that multiplied by the unrounded scale would show
(JAX rounds its weakly typed Python scale to bf16 first), and the shipped
16 / 8 = 2.0.

Tolerances: one site in bf16 on grid inputs is compared bit for bit (every
float32 partial sum is exact there, so only where each package rounds is
compared); on Gaussian inputs the two summation orders flip a few outputs
by one ulp. Model logits as in ``test_torch_model.py``: float32 1e-4,
bfloat16 0.125 (four bf16 ulps at |logit| ~ 4).
"""

import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest

import flax.linen as fnn
import jax
import jax.numpy as jnp
import torch

from dtc_tpu.adapters import AdapterStore as JAdapterStore
from dtc_tpu.adapters import apply_lora as japply_lora
from dtc_tpu.adapters import init_lora as jinit_lora
from dtc_tpu.adapters import load_adapter_file as jload_adapter_file
from dtc_tpu.adapters import save_adapter as jsave_adapter
from dtc_tpu.config import loader as jloader
from dtc_tpu.config.schema import AdapterConfig as JAdapterConfig
from dtc_tpu.config.schema import ModelConfig as JCfg
from dtc_tpu.generate import decode_step as jdecode_step
from dtc_tpu.generate import init_cache as jinit_cache
from dtc_tpu.models.gpt import GPT as JGPT
from dtc_tpu.models.gpt import adapter_param_count as jadapter_param_count
from dtc_tpu.serve.request import AdapterStoreFullError as JStoreFull
from dtc_tpu_torch.adapters import (
    AdapterStore,
    gather_slot_lora,
    init_lora,
    init_lora_stack,
    load_adapter_file,
    lora_shapes,
    merge_lora,
    save_adapter,
    validate_lora_tree,
)
from dtc_tpu_torch.config import loader as tloader
from dtc_tpu_torch.config.schema import AdapterConfig, ModelConfig
from dtc_tpu_torch.generate import decode_step, generate, init_cache
from dtc_tpu_torch.models.gpt import GPT, Dense, adapter_param_count, apply_lora
from dtc_tpu_torch.parity import from_flax, lora_from_flax
from dtc_tpu_torch.serve import AdapterStoreFullError
from tests.test_torch_train import _one_thread  # noqa: F401  (autouse: one intra-op thread)


ROOT = Path(__file__).resolve().parent.parent
VOCAB = 97
TINY = dict(vocab_size=VOCAB, d_model=64, n_layers=4, n_heads=4, d_ff=128, max_seq_len=32,
            dropout=0.0, param_dtype="float32", attention="dense")
#: (rank, alpha): a scale bfloat16 cannot hold, and the shipped 2.0.
SCALES = [(6, 16.0), (8, 16.0)]
TOL = {"float32": 1e-4, "bfloat16": 0.125}

_PAIRS = {}


def _rand_flax_lora(jm, seed, scale=0.3):
    """Random nonzero factors in the flax layout (init_lora's B is zero)."""
    base = jinit_lora(jm, 0)
    leaves, td = jax.tree.flatten(base)
    rng = np.random.RandomState(seed)
    return jax.tree.unflatten(td, [
        (scale * rng.randn(*l.shape) / np.sqrt(l.shape[-2])).astype(np.float32) for l in leaves
    ])


def _pair(compute="float32", rank=6, alpha=16.0, **over):
    """The JAX and port models with adapters on the tiny config, the same
    base weights, and two random adapters in each layout (cached)."""
    key = (compute, rank, alpha, tuple(sorted(over.items())))
    if key not in _PAIRS:
        kw = dict(TINY, compute_dtype=compute, **over)
        jm = JGPT(JCfg(**kw, adapter=JAdapterConfig(rank=rank, alpha=alpha)))
        params = jm.init(
            {"params": jax.random.PRNGKey(0)}, jnp.ones((1, 1), jnp.int32), train=False
        )["params"]
        tm = GPT(ModelConfig(**kw, adapter=AdapterConfig(rank=rank, alpha=alpha)), device="cpu")
        tm.load_state_dict(from_flax(jax.tree.map(np.asarray, params), tm.cfg))
        jl = [_rand_flax_lora(jm, s) for s in (11, 22)]
        tl = [lora_from_flax(l) for l in jl]
        _PAIRS[key] = (jm, params, tm, jl, tl)
    return _PAIRS[key]


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)), atol=tol, rtol=0,
    )


# ---------------------------------------------------------------------------
# config, counts, shapes, the store
# ---------------------------------------------------------------------------

def test_finetune_config_loads_equal_to_jax():
    """The adapter block of ``finetune_lora.yaml`` is lifted onto the model
    config as JAX's ``load_finetune_config`` does: rank 8, alpha 16, all six
    sites on the flagship."""
    path = ROOT / "configs" / "finetune_lora.yaml"
    for j, t in zip(jloader.load_finetune_config(path), tloader.load_finetune_config(path)):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    _, mcfg, _ = tloader.load_finetune_config(path)
    assert (mcfg.adapter.rank, mcfg.adapter.alpha, mcfg.adapter.scale) == (8, 16.0, 2.0)
    assert len(mcfg.adapter.target_modules) == 6 and mcfg.d_model == 512


@pytest.mark.parametrize("over,targets", [
    ({}, ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")),
    ({}, ("q_proj", "fc2")),
    ({"moe_experts": 4}, ("q_proj", "out_proj", "fc1")),
])
def test_adapter_param_count_and_shapes_match_jax(over, targets):
    kw = dict(TINY, **over)
    jcfg = JCfg(**kw, adapter=JAdapterConfig(rank=4, target_modules=targets))
    tcfg = ModelConfig(**kw, adapter=AdapterConfig(rank=4, target_modules=targets))
    assert adapter_param_count(tcfg) == jadapter_param_count(jcfg)
    shapes = lora_shapes(tcfg)
    assert sum(int(np.prod(s)) for s in shapes.values()) == adapter_param_count(tcfg)
    if not over:
        want = jax.tree.map(lambda x: x.shape, jinit_lora(JGPT(jcfg), 0))
        got = {k: v.shape for k, v in lora_from_flax(jax.tree.map(
            lambda s: np.zeros(s, np.float32), want, is_leaf=lambda x: isinstance(x, tuple),
        )).items()}
        assert got == shapes
    assert adapter_param_count(ModelConfig(**TINY)) == 0 and lora_shapes(ModelConfig(**TINY)) == {}


def test_flagship_adapter_is_294912_bytes_a_layer():
    """rank 8 on all six sites of the flagship: 73,728 float32 parameters a
    layer (the megakernel's per-tenant bytes)."""
    _, mcfg, _ = tloader.load_finetune_config(ROOT / "configs" / "finetune_lora.yaml")
    assert adapter_param_count(mcfg) * 4 == 294_912 * mcfg.n_layers


def _store_script(store, full_error):
    """One script of register / acquire / release / evict; every return
    value, or the error's type, in order."""
    out = []

    def do(fn, *a):
        try:
            out.append(fn(*a))
        except (ValueError, KeyError, full_error) as e:
            out.append(type(e).__name__ if not isinstance(e, full_error) else "full")

    for name in ("a", "b", "a", "c"):
        do(store.register, name)
    do(store.slot_of, "b")
    do(store.slot_of, "c")
    do(store.slot_of, None)
    do(store.acquire, "a")
    do(store.acquire, "c")
    do(store.register, "d")
    do(store.register, "a")
    do(store.release, "c")
    do(store.register, "d")
    do(store.register, "base")
    do(store.register, "")
    do(store.acquire, "ghost")
    do(store.refcount, "a")
    do(store.release, "a")
    do(store.release, "a")
    do(store.refcount, "a")
    do(store.register, "e")
    out.append("d" in store)
    out.append(store.snapshot())
    return out


def test_store_script_matches_jax():
    assert _store_script(AdapterStore(3), AdapterStoreFullError) == \
        _store_script(JAdapterStore(3), JStoreFull)
    for cap in (0, 1):
        with pytest.raises(ValueError):
            AdapterStore(cap)


# ---------------------------------------------------------------------------
# one site in bf16, bit for bit
# ---------------------------------------------------------------------------

N_ROWS, D_IN, D_OUT = 64, 512, 512


class _Site(fnn.Module):
    cfg: JCfg

    @fnn.compact
    def __call__(self, x):
        base = fnn.Dense(D_OUT, dtype=jnp.bfloat16, param_dtype=jnp.float32, name="q_proj")
        return japply_lora(self, base, x, cfg=self.cfg, name="q_proj", train=False)


def _site_inputs(seed, rank, per_row, grid=True):
    """x (B, T, in), flax kernel (in, out), bias, A (in, r) / B (r, out) or
    per row (B, in, r) / (B, r, out). On the grid x is a multiple of 2^-3,
    W and A of 2^-8 (at most 1/4), B of 2^-4 (at most 1/2): every float32
    partial sum of x W, x A and round(z) B is exact."""
    rng = np.random.RandomState(seed)
    b, t = 4, N_ROWS // 4
    lead = (b,) if per_row else ()
    if grid:
        x = rng.randint(-8, 9, size=(b, t, D_IN)) / 8.0
        w = rng.randint(-64, 65, size=(D_IN, D_OUT)) / 256.0
        a = rng.randint(-64, 65, size=lead + (D_IN, rank)) / 256.0
        bb = rng.randint(-8, 9, size=lead + (rank, D_OUT)) / 16.0
    else:
        x = rng.randn(b, t, D_IN)
        w = rng.randn(D_IN, D_OUT) / np.sqrt(D_IN)
        a = rng.randn(*lead, D_IN, rank) / np.sqrt(D_IN)
        bb = rng.randn(*lead, rank, D_OUT) / np.sqrt(rank)
    bias = rng.randn(D_OUT)
    return [np.asarray(v, np.float32) for v in (x, w, bias, a, bb)]


def _site_pair(x, w, bias, a, bb, rank, alpha):
    """JAX's ``apply_lora`` at one q_proj site in bf16, and the port's
    ``Dense`` with the same factors."""
    jcfg = JCfg(vocab_size=VOCAB, d_model=D_IN, n_layers=1, n_heads=8, d_ff=D_OUT,
                max_seq_len=32, compute_dtype="bfloat16",
                adapter=JAdapterConfig(rank=rank, alpha=alpha))
    want = _Site(jcfg).apply(
        {"params": {"q_proj": {"kernel": jnp.asarray(w), "bias": jnp.asarray(bias)}},
         "lora": {"q_proj_a": jnp.asarray(a), "q_proj_b": jnp.asarray(bb)}},
        jnp.asarray(x).astype(jnp.bfloat16),
    )
    tcfg = ModelConfig(vocab_size=VOCAB, d_model=D_IN, n_layers=1, n_heads=8, d_ff=D_OUT,
                       max_seq_len=32, compute_dtype="bfloat16",
                       adapter=AdapterConfig(rank=rank, alpha=alpha))
    dense = Dense(D_IN, D_OUT, tcfg, device="cpu")
    with torch.no_grad():
        dense.weight.copy_(torch.from_numpy(w.T.copy()))
        dense.bias.copy_(torch.from_numpy(bias))
        fac = (torch.from_numpy(np.swapaxes(a, -1, -2).copy()),
               torch.from_numpy(np.swapaxes(bb, -1, -2).copy()))
        got = dense(torch.from_numpy(x).to(torch.bfloat16), fac)
    return dense, fac, got, np.asarray(want)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


@pytest.mark.parametrize("rank,alpha", SCALES)
@pytest.mark.parametrize("per_row", [False, True])
def test_bf16_lora_site_is_bit_equal_to_jax(per_row, rank, alpha):
    """Dense + LoRA in bf16 equals JAX's ``apply_lora`` bit for bit, shared
    and per-row factors; with 16 / 6 the unrounded scale would not."""
    x, w, bias, a, bb = _site_inputs(rank + per_row, rank, per_row)
    dense, fac, got, want = _site_pair(x, w, bias, a, bb, rank, alpha)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), want.view(np.int16))
    scale = alpha / rank
    assert dense.lora_scale == float(jnp.asarray(scale, jnp.float32).astype(jnp.bfloat16))
    if scale != 2.0:
        # What rounding the scale first repairs: the unrounded scale moves
        # a good share of the outputs.
        y = dense(torch.from_numpy(x).to(torch.bfloat16))
        unrounded = apply_lora(y, torch.from_numpy(x), fac, scale)
        assert (_bits(unrounded) != want.view(np.int16)).mean() > 0.05


@pytest.mark.parametrize("per_row", [False, True])
def test_bf16_lora_site_on_gaussian_inputs_differs_only_by_summation_order(per_row):
    """At most 1% of 32,768 outputs differ, each by one ulp: a sum landing
    on the other side of a bf16 rounding boundary in the other order (in x
    W, z or the delta); a misplaced rounding point moves far more."""
    rank, alpha = 6, 16.0
    x, w, bias, a, bb = _site_inputs(7, rank, per_row, grid=False)
    _, _, got, want = _site_pair(x, w, bias, a, bb, rank, alpha)
    diff = np.abs(_bits(got).astype(np.int32) - want.view(np.int16).astype(np.int32))
    assert (diff != 0).mean() <= 0.01 and diff.max() <= 1, ((diff != 0).sum(), diff.max())


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rank,alpha", SCALES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_with_lora_match_jax(dtype, rank, alpha):
    jm, params, tm, jl, tl = _pair(dtype, rank, alpha)
    x = np.random.RandomState(0).randint(0, VOCAB, size=(2, 12)).astype(np.int32)
    want = jm.apply({"params": params, "lora": jl[0]}, jnp.asarray(x), train=False)
    base = jm.apply({"params": params}, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), lora=tl[0])
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, TOL[dtype])
    # The adapter moves the logits well past the tolerance.
    assert float(jnp.abs(want.astype(jnp.float32) - base.astype(jnp.float32)).max()) > 0.5


@pytest.mark.parametrize("dtype,backend,kv", [
    ("float32", "fused", "auto"), ("float32", "xla", "auto"),
    ("bfloat16", "fused", "auto"), ("float32", "fused", "int8"),
])
def test_decode_with_lora_matches_jax(dtype, backend, kv):
    """Prefill 7 tokens, then 6 single-token steps at per-row frontiers,
    one adapter shared by the batch, through the per-layer decode path."""
    jm, params, tm, jl, tl = _pair(dtype, decode_attention=backend, kv_cache_dtype=kv)
    rng = np.random.RandomState(1)
    b = 3
    prompt = rng.randint(0, VOCAB, size=(b, 7)).astype(np.int32)
    steps = rng.randint(0, VOCAB, size=(6, b, 1)).astype(np.int32)
    jstep = jax.jit(lambda p, c, t, l: jdecode_step(jm, p, c, t, l))
    jc, tc = jinit_cache(jm, b), init_cache(tm, b)
    jc, jlog = jstep(params, jc, jnp.asarray(prompt), jl[1])
    tc, tlog = decode_step(tm, tc, torch.from_numpy(prompt), lora=tl[1])
    _close(tlog, jlog, TOL[dtype])
    idx = np.array([7, 5, 3], np.int32)
    jc = dict(jc, index=jnp.asarray(idx))
    tc["index"] = torch.from_numpy(idx)
    for tok in steps:
        jc, jlog = jstep(params, jc, jnp.asarray(tok), jl[1])
        tc, tlog = decode_step(tm, tc, torch.from_numpy(tok), lora=tl[1])
        _close(tlog, jlog, TOL[dtype])


def test_per_row_stack_with_base_slot_equals_each_tenant_solo():
    """A stack with slot 0 as base, rows on slots [0, 1, 2, 1]: each row's
    logits equal that tenant's solo run (shared factors, or none for base)."""
    _, _, tm, _, tl = _pair("float32")
    stack = init_lora_stack(tm, 3)
    for slot, fac in ((1, tl[0]), (2, tl[1])):
        for k in stack:
            stack[k][slot].copy_(fac[k])
    ids = torch.tensor([0, 1, 2, 1], dtype=torch.int32)
    rng = np.random.RandomState(3)
    prompt = torch.from_numpy(rng.randint(0, VOCAB, size=(1, 7)).astype(np.int32))
    with torch.no_grad():
        batch = tm(prompt.repeat(4, 1), lora=stack, lora_ids=ids)
        solos = [tm(prompt), tm(prompt, lora=tl[0]), tm(prompt, lora=tl[1]), tm(prompt, lora=tl[0])]
    for row, solo in enumerate(solos):
        np.testing.assert_allclose(batch[row].numpy(), solo[0].numpy(), atol=1e-5, rtol=0)
    rows = gather_slot_lora(stack, ids)
    assert torch.equal(rows["q_proj_a"][2], tl[1]["q_proj_a"])
    assert not rows["q_proj_a"][0].any()


def test_merged_weights_oracle_is_token_exact():
    """float32: generate() with the adapter equals generate() of a rank-0
    model whose weights have the adapter folded in; the adapter changes
    the tokens of at least one prompt."""
    _, _, tm, _, tl = _pair("float32")
    plain = GPT(ModelConfig(**dict(TINY, compute_dtype="float32")), device="cpu")
    plain.load_state_dict(merge_lora(tm.state_dict(), tl[0], tm.cfg))
    base = GPT(plain.cfg, device="cpu")
    base.load_state_dict(tm.state_dict())
    changed = False
    for i, n in enumerate((6, 9, 4)):
        p = np.random.RandomState(20 + i).randint(0, VOCAB, size=(1, n))
        runtime = generate(tm, p, 8, lora=tl[0])
        assert torch.equal(runtime, generate(plain, p, 8)), i
        changed |= not torch.equal(runtime, generate(base, p, 8))
    assert changed


def test_rank0_and_zero_factors_are_bitwise_the_base_model():
    """A rank-0 adapter config builds the same model and logits bit for bit;
    a rank > 0 model without factors, or with init_lora's (B zero), is the
    base model bit for bit, in training (the finetune's first step) too."""
    _, _, tm, _, _ = _pair("bfloat16")
    kw = dict(TINY, compute_dtype="bfloat16")
    plain = GPT(ModelConfig(**kw), device="cpu", seed=4)
    r0 = GPT(ModelConfig(**kw, adapter=AdapterConfig(rank=0)), device="cpu", seed=4)
    for (n1, a), (n2, b) in zip(plain.state_dict().items(), r0.state_dict().items()):
        assert n1 == n2 and torch.equal(a, b)
    x = torch.from_numpy(np.random.RandomState(5).randint(0, VOCAB, size=(2, 9)).astype(np.int32))
    with torch.no_grad():
        assert torch.equal(plain(x), r0(x))
        base = GPT(ModelConfig(**kw), device="cpu")
        base.load_state_dict(tm.state_dict())
        want = base(x)
        assert torch.equal(tm(x), want)
        assert torch.equal(tm(x, lora=init_lora(tm, seed=3)), want)
    y = torch.roll(x, -1, dims=1).long()
    want = base(x, train=True, targets=y, generator=torch.Generator().manual_seed(0))
    got = tm(x, train=True, targets=y, generator=torch.Generator().manual_seed(0),
             lora={k: v.requires_grad_(True) for k, v in init_lora(tm).items()})
    assert torch.equal(got.detach(), want.detach())


def test_init_lora_shapes_scale_and_seed():
    _, _, tm, _, _ = _pair("float32")
    a, b = init_lora(tm, seed=1), init_lora(tm, seed=1)
    assert set(a) == set(lora_shapes(tm.cfg))
    for k, v in a.items():
        assert tuple(v.shape) == lora_shapes(tm.cfg)[k] and v.dtype == torch.float32
        assert torch.equal(v, b[k])
        if k.endswith("_b"):
            assert not v.any()
        else:  # lecun normal: variance 1 / in, truncated at 2 sigma
            std = float(v.std())
            assert 0.7 / np.sqrt(v.shape[-1]) < std < 1.3 / np.sqrt(v.shape[-1])
            assert float(v.abs().max()) <= 2.0 / 0.8796 / np.sqrt(v.shape[-1]) + 1e-6
    assert not torch.equal(init_lora(tm, seed=2)["q_proj_a"], a["q_proj_a"])
    stack = init_lora_stack(tm, 4)
    validate_lora_tree(stack, a)
    with pytest.raises(ValueError):
        validate_lora_tree(stack, {k: v for k, v in a.items() if k != "fc1_a"})
    with pytest.raises(ValueError):
        validate_lora_tree(stack, dict(a, q_proj_a=a["q_proj_a"][:, :2]))
    with pytest.raises(ValueError):
        init_lora(GPT(ModelConfig(**TINY), device="cpu"))


# ---------------------------------------------------------------------------
# the artifact
# ---------------------------------------------------------------------------

def test_jax_artifact_loads_in_the_port_and_back(tmp_path):
    """An ``.npz`` JAX's ``save_adapter`` writes loads in the port to the same
    factors (its meta too); the port's ``save_adapter`` writes a file JAX's
    ``load_adapter_file`` reads back to the flax tree, bit for bit."""
    jm, _, tm, jl, tl = _pair("float32")
    path = str(tmp_path / "j.npz")
    jsave_adapter(path, jl[0], {"rank": 6, "name": "t"})
    fac, meta = load_adapter_file(path, like=init_lora_stack(tm, 2))
    assert meta == {"rank": 6, "name": "t"}
    assert list(fac) == list(tl[0])
    for k in tl[0]:
        assert torch.equal(fac[k], tl[0][k]), k
    out = str(tmp_path / "t.npz")
    save_adapter(out, fac, meta)
    tree, meta2 = jload_adapter_file(out, like=jl[0])
    assert meta2 == meta
    for x, y in zip(jax.tree.leaves(tree), jax.tree.leaves(jl[0])):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]
    with np.load(out, allow_pickle=False) as z:
        assert "stage/blocks/Block_0/attn/q_proj_a" in z.files


def test_artifact_of_another_shape_is_refused(tmp_path):
    _, _, tm, _, _ = _pair("float32")
    _, _, other, _, tl4 = _pair("float32", rank=8)
    path = str(tmp_path / "r8.npz")
    save_adapter(path, tl4[0], {})
    with pytest.raises(ValueError, match="shape"):
        load_adapter_file(path, like=init_lora(tm))
    short = str(tmp_path / "short.npz")
    save_adapter(short, {k: v for k, v in init_lora(tm).items() if not k.startswith("fc")}, {})
    with pytest.raises(ValueError, match="missing"):
        load_adapter_file(short, like=init_lora(tm))
    assert other.cfg.adapter.rank == 8
