"""The port's FSDP ring and its rule table against the JAX package's, on the
same numpy inputs.

- The overlapped matmul (TPU kernel rows 17-18): JAX runs its Pallas
  kernels in interpret mode on its 8-device CPU mesh
  (``overlap_dense_matmul(..., backend="pallas")`` and
  ``reduce_scatter_matmul(..., backend="pallas")``, as
  ``tests/test_overlap_collectives.py`` drives them), the port the kernels'
  plain versions over an in-process ring of 8 virtual ranks, which are what
  the CUDA kernels are held against on the card. x (8, 4, K), both shard
  axes, K 64 / N 128 and K 128 / N 64. Tolerances: JAX's own in float32
  (forward rtol/atol 1e-5, the gradients of ``sum(sin(y))`` 1e-4, the
  reduce-scatter 1e-5); in bfloat16 one ulp of each value (both round a
  float32 sum once, and only the summation order differs), for the
  forward and for the gradients of a given cotangent.
- JAX's ladder: a ring of 1, K 60, N 100 and batch 3 under a ring of 8 give
  the plain product and run no ring step.
- The rule table: FSDP's sharded dim of every port parameter against
  JAX's ``param_specs(FSDP_RULES)`` through the layouts; an unknown name
  raises; ``fsdp_axis`` against ``fsdp_axis_in_scope``; splitting a
  ``from_flax`` parameter set into shards and gathering them back is
  exact; ``train_memory_bytes`` under FSDP against JAX's.
- ``resolve_collectives`` routing and its pipeline rejection; the inert
  warning; FSDP training over an in-process ring of 4 against the
  unsharded run.
- The step kernels' launch plans (``step_plan``, decided before each
  launch from shapes and strides alone): every step of the flagship's four
  dense sites (B 8, T 512, d_model 512, d_ff 2048, a ring of 4 ranks on a
  132-SM card) in the forward, dx and dw rings takes TMA and the tensor
  cores and fills the card unless it is a contract-mode step of K 128;
  ragged blocks and rows TMA cannot take go to the per-thread loader;
  float32 to the CUDA-core tiles; K 128 is never split; bad dims raise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dtc_tpu.ops import overlap_collectives as joc
from dtc_tpu_torch.config import schema as ts
from dtc_tpu_torch.config.loader import _build
from dtc_tpu_torch.ops import overlap_collectives as toc
from dtc_tpu_torch.ops.ring_attention import InProcessRing
from tests.test_torch_train import _one_thread  # noqa: F401  (autouse: one intra-op thread)


SHAPES = ((64, 128), (128, 64))


@pytest.fixture
def mesh8():
    return jax.make_mesh((8,), ("data",))


def _inputs(seed, k, n, b=8, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 4, k)).astype(dtype),
            rng.standard_normal((k, n)).astype(dtype),
            rng.standard_normal((b, 4, n)).astype(dtype))


def _jax_op(mesh, x, w, shard_axis, monkeypatch):
    """JAX's op through its Pallas kernels in interpret mode: ``(y, f)``
    with ``f(x, w)`` the jitted op; asserts the kernels were traced."""
    monkeypatch.setenv("DTC_OVERLAP", "pallas")
    traced = []
    real = joc._pallas_ag_matmul
    monkeypatch.setattr(joc, "_pallas_ag_matmul",
                        lambda *a, **k: traced.append(1) or real(*a, **k))

    def f(a, b):
        return joc.overlap_dense_matmul(a, b, shard_axis=shard_axis, axis_name="data",
                                        backend="pallas")

    with mesh:
        y = jax.jit(f)(x, w)
    assert traced, "JAX did not take its Pallas kernels"
    return y, f


def _count_steps(monkeypatch):
    counts = [0, 0]
    real = toc.ag_step, toc.rs_step

    def counted(i):
        def step(*a, **k):
            counts[i] += 1
            return real[i](*a, **k)
        return step

    monkeypatch.setattr(toc, "ag_step", counted(0))
    monkeypatch.setattr(toc, "rs_step", counted(1))
    return counts


@pytest.mark.parametrize("k,n", SHAPES)
@pytest.mark.parametrize("shard_axis", [0, 1])
def test_overlap_matmul_matches_jax_pallas_float32(mesh8, monkeypatch, shard_axis, k, n):
    x, w, _ = _inputs(0, k, n)
    want_y, f = _jax_op(mesh8, x, w, shard_axis, monkeypatch)
    with mesh8:
        want_dx, want_dw = jax.jit(jax.grad(lambda a, b: jnp.sum(jnp.sin(f(a, b))),
                                            argnums=(0, 1)))(x, w)
    counts = _count_steps(monkeypatch)
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    y = toc.overlap_dense_matmul(tx, tw, shard_axis=shard_axis, ring=InProcessRing(8))
    dx, dw = torch.autograd.grad(torch.sin(y).sum(), (tx, tw))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), rtol=1e-4, atol=1e-4)
    # 8 ranks x 8 steps, forward and dx; 8 x 8 reduce-scatter steps for dw
    assert counts == [128, 64]


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp of each value (the ulp of a value in [2^e, 2^(e+1))
    is 2^(e-7))."""
    _, e = np.frexp(np.abs(x.astype(np.float32)))
    return np.exp2(e.astype(np.float32) - 8)


@pytest.mark.parametrize("shard_axis", [0, 1])
def test_overlap_matmul_matches_jax_pallas_bfloat16(mesh8, monkeypatch, shard_axis):
    k, n = SHAPES[0]
    x, w, dy = (a.astype(jnp.bfloat16) for a in _inputs(1, k, n))
    want_y, f = _jax_op(mesh8, x, w, shard_axis, monkeypatch)
    with mesh8:
        _, vjp = jax.vjp(f, x, w)
        want_dx, want_dw = vjp(dy)
    bf = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    tx, tw = bf(x).requires_grad_(True), bf(w).requires_grad_(True)
    y = toc.overlap_dense_matmul(tx, tw, shard_axis=shard_axis, ring=InProcessRing(8))
    dx, dw = torch.autograd.grad(y, (tx, tw), bf(dy))
    for name, got, want in (("y", y, want_y), ("dx", dx, want_dx), ("dw", dw, want_dw)):
        assert got.dtype == torch.bfloat16, name
        got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
        assert (np.abs(got - want) <= _bf16_ulp(want)).all(), name


@pytest.mark.parametrize("shard_axis", [0, 1])
def test_reduce_scatter_matmul_matches_jax_pallas(mesh8, shard_axis):
    rng = np.random.default_rng(2)
    a = rng.standard_normal((16, 64)).astype(np.float32)
    b = rng.standard_normal((16, 128)).astype(np.float32)
    with mesh8:
        want = jax.jit(lambda p, q: joc.reduce_scatter_matmul(
            p, q, shard_axis=shard_axis, axis_name="data", mesh=mesh8, backend="pallas"))(a, b)
    got = toc.reduce_scatter_matmul(torch.from_numpy(a), torch.from_numpy(b),
                                    shard_axis=shard_axis, ring=InProcessRing(8))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("xshape,wshape,shard_axis,ring", [
    ((2, 4, 64), (64, 32), 0, 1),      # a ring of one
    ((8, 4, 60), (60, 128), 0, 8),     # K 60 not divisible by the ring
    ((8, 4, 64), (64, 100), 1, 8),     # N 100 not divisible by the ring
    ((3, 4, 64), (64, 128), 0, 8),     # batch 3 narrower than the ring
])
def test_ladder_gives_the_plain_product(mesh8, monkeypatch, xshape, wshape, shard_axis, ring):
    rng = np.random.default_rng(4)
    x = rng.standard_normal(xshape).astype(np.float32)
    w = rng.standard_normal(wshape).astype(np.float32)
    mesh = mesh8 if ring == 8 else jax.make_mesh((1,), ("data",))
    with mesh:
        want = jax.jit(lambda a, b: joc.overlap_dense_matmul(
            a, b, shard_axis=shard_axis, axis_name="data"))(x, w)
    counts = _count_steps(monkeypatch)
    got = toc.overlap_dense_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                   shard_axis=shard_axis, ring=InProcessRing(ring))
    assert counts == [0, 0]
    assert torch.equal(got, torch.from_numpy(x) @ torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_op_rejects_what_it_cannot_take():
    x, w = torch.zeros(8, 4, 64), torch.zeros(64, 128)
    with pytest.raises(ValueError):
        toc.overlap_dense_matmul(x, w.to(torch.bfloat16), shard_axis=0, ring=InProcessRing(8))
    with pytest.raises(ValueError):
        toc.overlap_dense_matmul(x, w[:32], shard_axis=0, ring=InProcessRing(8))
    with pytest.raises(ValueError):
        toc.overlap_dense_matmul(x, w, shard_axis=2, ring=InProcessRing(8))
    with pytest.raises(ValueError, match="not divisible"):
        toc.reduce_scatter_matmul(torch.zeros(16, 60), torch.zeros(16, 128), shard_axis=0,
                                  ring=InProcessRing(8))


# ---------------------------------------------------------------------------
# the rule table and the shards
# ---------------------------------------------------------------------------

def _model_cfg(tiny_model_cfg, **over):
    return _build(ts.ModelConfig, dataclasses.asdict(dataclasses.replace(tiny_model_cfg, **over)),
                  "test")


def _flax_params(cfg):
    from dtc_tpu.models.gpt import GPT as JGPT

    return jax.tree.map(np.asarray, jax.jit(
        lambda r, x: JGPT(cfg).init({"params": r, "dropout": r}, x, train=False)
    )(jax.random.PRNGKey(0), jnp.ones((1, cfg.max_seq_len), jnp.int32))["params"])


def test_sharded_dims_match_jax_fsdp_specs(tiny_model_cfg):
    """Every port parameter's FSDP dim is JAX's ``data`` axis of the same
    flax parameter, through the port's layout (kernels transposed, layers
    unstacked)."""
    from dtc_tpu.parallel import sharding as js
    from dtc_tpu_torch.models.gpt import GPT
    from dtc_tpu_torch.parallel import sharding as tsh

    assert tsh.DEFAULT_RULES == js.DEFAULT_RULES and tsh.FSDP_RULES == js.FSDP_RULES
    params = _flax_params(tiny_model_cfg)
    specs = js.param_specs(params, js.FSDP_RULES)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): spec for path, spec in
            jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda s: isinstance(s, P))[0]}
    model = GPT(_model_cfg(tiny_model_cfg), device="cpu")
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == 6 + tiny_model_cfg.n_layers * 16
    for name in names:
        parts = name.split(".")
        mod = parts[-2]
        leaf = {"weight": {"wte": "embedding", "wpe": "embedding"}.get(
                    mod, "scale" if mod.startswith("ln") else "kernel"), "bias": "bias"}[parts[-1]]
        spec = next(s for p, s in flat.items() if p.endswith(f"/{mod}/{leaf}"))
        axes = list(spec)
        if "blocks" in name:
            axes = axes[1:]                               # the stacked layer axis
        if leaf == "kernel":
            axes = axes[::-1]                             # (in, out) -> (out, in)
        want = axes.index("data") if "data" in axes else None
        assert tsh.param_shard_dim(name) == want, name
    whole = {n for n in names if tsh.param_shard_dim(n) is None}
    assert whole == {n for n in names if n.endswith(("q_proj.bias", "k_proj.bias",
                                                     "v_proj.bias", "fc1.bias",
                                                     "lm_head.bias"))}
    with pytest.raises(KeyError, match="PARAM_AXES_TABLE"):
        tsh.param_shard_dim("stage.blocks.0.attn.rope.weight")


def test_fsdp_axis_matches_fsdp_axis_in_scope(mesh8):
    from flax import linen as nn

    from dtc_tpu.parallel import sharding as js
    from dtc_tpu_torch.parallel import sharding as tsh

    mesh42 = jax.make_mesh((4, 2), ("data", "model"))
    for mesh in (mesh8, mesh42):
        sizes = dict(zip(mesh.axis_names, (int(s) for s in mesh.shape.values())))
        for jrules, trules in ((js.FSDP_RULES, tsh.FSDP_RULES),
                               (js.DEFAULT_RULES, tsh.DEFAULT_RULES),
                               (js.ring_rules_from(js.FSDP_RULES),
                                tsh.ring_rules_from(tsh.FSDP_RULES))):
            assert tsh.ring_rules_from(trules) == js.ring_rules_from(jrules)
            with mesh, nn.logical_axis_rules(jrules):
                assert tsh.fsdp_axis(trules, sizes) == js.fsdp_axis_in_scope()


def test_shards_split_and_gather_exactly(tiny_model_cfg):
    from dtc_tpu_torch.parallel.sharding import param_shard_dim
    from dtc_tpu_torch.parity import fsdp_shards, from_flax, gather_shards

    sd = from_flax(_flax_params(tiny_model_cfg), tiny_model_cfg)
    shards = [fsdp_shards(sd, r, 4) for r in range(4)]
    for name, x in sd.items():
        d = param_shard_dim(name)
        for s in shards:
            assert s[name].shape[d if d is not None else 0] == (
                x.shape[d] // 4 if d is not None else x.shape[0]), name
    back = gather_shards(shards)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[n], sd[n]) for n in sd)


@pytest.mark.parametrize("mesh_shape", [{"data": 4}, {"data": 8}, {"data": 1}, {"data": 2}])
def test_train_memory_bytes_under_fsdp_matches_jax(tiny_model_cfg, mesh_shape):
    from dtc_tpu.utils.metrics import train_memory_bytes as jmem
    from dtc_tpu_torch.utils.metrics import train_memory_bytes

    for cfg in (tiny_model_cfg, dataclasses.replace(tiny_model_cfg, compute_dtype="bfloat16",
                                                    remat="block")):
        for parallel in ("fsdp", "dp"):
            want = jmem(cfg, 8, cfg.max_seq_len, mesh_shape, parallel)
            got = train_memory_bytes(_model_cfg(cfg), 8, cfg.max_seq_len, mesh_shape,
                                     parallel)
            for key, value in got.items():
                assert value == pytest.approx(want[key], rel=1e-12), (parallel, key)


# ---------------------------------------------------------------------------
# collectives routing and training
# ---------------------------------------------------------------------------

def _port(cls, cfg):
    return _build(cls, dataclasses.asdict(cfg), "test")


def test_resolve_collectives_routes_both_configs(tiny_model_cfg, train_cfg_factory):
    from dtc_tpu.train.train_step import resolve_collectives as jresolve
    from dtc_tpu_torch.train.train_step import resolve_collectives

    model = _port(ts.ModelConfig, tiny_model_cfg)
    model_ovl = dataclasses.replace(model, collectives="overlapped")
    t_xla = _port(ts.TrainConfig, train_cfg_factory("fsdp"))
    t_ovl = dataclasses.replace(t_xla, collectives="overlapped")
    assert resolve_collectives(t_xla, model_ovl).collectives == "overlapped"
    assert resolve_collectives(t_ovl, model).collectives == "overlapped"
    assert resolve_collectives(t_xla, model) is model
    j_model = dataclasses.replace(tiny_model_cfg, collectives="overlapped")
    j_pp = train_cfg_factory("pp", collectives="overlapped", pp_microbatches=2)
    with pytest.raises(ValueError, match="pipeline") as want:
        jresolve(j_pp, j_model)
    with pytest.raises(ValueError, match="pipeline") as got:
        resolve_collectives(_port(ts.TrainConfig, j_pp), model_ovl)
    assert str(got.value) == str(want.value)


def test_overlapped_under_a_pipeline_is_refused_by_the_trainer(tiny_model_cfg, opt_cfg,
                                                              train_cfg_factory):
    from dtc_tpu_torch.train.trainer import train

    cfg = train_cfg_factory("pp", collectives="overlapped", pp_microbatches=2)
    with pytest.raises(ValueError, match="pipeline"):
        train(_port(ts.TrainConfig, cfg), _port(ts.ModelConfig, tiny_model_cfg),
              _port(ts.OptimConfig, opt_cfg), device="cpu")


@pytest.mark.parametrize("parallel", ["fsdp", "dp"])
def test_inert_overlapped_prints_the_warning_and_trains_as_xla(
        capsys, tiny_model_cfg, opt_cfg, train_cfg_factory, parallel):
    """One process: no FSDP ring of more than one rank, so ``overlapped``
    is inert (JAX's warning) and the losses are the ``xla`` run's bits."""
    from dtc_tpu_torch.train.trainer import train

    model = _port(ts.ModelConfig, dataclasses.replace(tiny_model_cfg, n_layers=1))
    opt = _port(ts.OptimConfig, opt_cfg)
    losses = {}
    for mode in ("xla", "overlapped"):
        cfg = _port(ts.TrainConfig, train_cfg_factory(parallel, steps=2, collectives=mode))
        cfg = dataclasses.replace(cfg, obs=dataclasses.replace(cfg.obs, enabled=False))
        losses[mode] = train(cfg, model, opt, device="cpu").losses
        out = capsys.readouterr().out
        assert ("collectives: overlapped is inert on this run" in out) == (mode == "overlapped")
    assert losses["overlapped"] == losses["xla"]


def test_fsdp_over_an_in_process_ring_matches_the_unsharded_run(monkeypatch, tiny_model_cfg,
                                                               opt_cfg):
    """The overlapped dense sites over 4 virtual ranks train as the plain
    model does (float32, 3 steps), through every site's ring."""
    from dtc_tpu_torch.models.gpt import GPT
    from dtc_tpu_torch.parallel.fsdp import FSDP
    from dtc_tpu_torch.train.optimizer import create_optimizer
    from dtc_tpu_torch.train.train_step import train_step

    cfg = _model_cfg(tiny_model_cfg)
    rng = np.random.default_rng(5)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, cfg.max_seq_len + 1)))
               for _ in range(3)]
    losses = {}
    for mode in ("xla", "overlapped"):
        model = GPT(dataclasses.replace(cfg, collectives=mode), device="cpu", seed=0)
        opt = create_optimizer(model.parameters(), _port(ts.OptimConfig, opt_cfg), 3)
        state = FSDP(InProcessRing(4)) if mode == "overlapped" else None
        counts = _count_steps(monkeypatch)
        losses[mode] = [float(train_step(model, opt, b[:, :-1], b[:, 1:], None, state))
                        for b in batches]
        sites = 3 * cfg.n_layers * 6
        assert counts == ([sites * 4 * 8, sites * 4 * 4] if state else [0, 0])
    np.testing.assert_allclose(losses["overlapped"], losses["xla"], rtol=1e-5)


# ---------------------------------------------------------------------------
# the step kernels' launch plans
# ---------------------------------------------------------------------------

H100_SMS = 132
#: The flagship's dense sites: (d_in, d_out, shard_axis), as models/gpt.py builds them.
FLAGSHIP_SITES = {"qkv": (512, 512, 0), "fc1": (512, 2048, 0), "out_proj": (512, 512, 1),
                  "fc2": (2048, 512, 1)}


def _ring_plans(d_in, d_out, shard_axis, rows=4096, ring=4, dtype=torch.bfloat16):
    """Every step's plan of one site's forward, dx and dw rings over
    ``ring`` virtual ranks, by the real schedules, with ``Dense``'s
    operands (x and dy contiguous, w the transposed ``(out, in)`` weight):
    ``[(ring, k, plan)]``. The recorders compute nothing."""
    x = torch.zeros(rows, d_in, dtype=dtype)
    dy = torch.zeros(rows, d_out, dtype=dtype)
    w = torch.zeros(d_out, d_in, dtype=dtype).t()
    plans = []

    def ag(tag):
        def step(x, w, out, *, src, slice_x, slice_out, w_t, accumulate):
            xs, _ = toc._ag_operands(x, w, src, slice_x, w_t)
            plans.append((tag, xs.shape[1], toc.ag_plan(x, w, src=src, slice_x=slice_x,
                                                        w_t=w_t, sms=H100_SMS)))
        return step

    def rs(a, b, acc, *, j, blk, slice_a):
        a_j, b_j = toc._rs_operands(a, b, j, blk, slice_a)
        plans.append(("dw", a_j.shape[0], toc.rs_plan(a, b, j=j, blk=blk, slice_a=slice_a,
                                                      sms=H100_SMS)))
        return torch.zeros(a_j.shape[1], b_j.shape[1])

    vring = InProcessRing(ring)
    toc.ring_ag_matmul(x, w, vring, shard_axis=shard_axis, step=ag("forward"))
    toc.ring_backward(x, w, dy, vring, shard_axis=shard_axis, ag=ag("dx"), rs=rs)
    return plans


@pytest.mark.parametrize("site", sorted(FLAGSHIP_SITES))
def test_flagship_steps_take_tma_and_fill_the_card(site):
    plans = _ring_plans(*FLAGSHIP_SITES[site])
    assert [tag for tag, _, _ in plans].count("forward") == 16
    assert [tag for tag, _, _ in plans].count("dx") == 16
    assert [tag for tag, _, _ in plans].count("dw") == 16
    for tag, k, plan in plans:
        assert plan.route == "tma", (tag, plan)
        assert (plan.tile_m, plan.tile_n) in toc.TC_TILES, (tag, plan)
        assert plan.blocks >= H100_SMS or (k == 128 and plan.split == 1), (tag, k, plan)
        if k == 128:
            assert plan.split == 1, (tag, plan)


def test_flagship_operands_are_staged_as_they_lie():
    """Forward: x and the transposed weight are both K-major; dx: the chunk
    read untransposed is N-major; dw: a_jᵀ and dy's block are both
    MN-major. Nothing is copied to change a layout."""
    majors = {}
    for site, spec in FLAGSHIP_SITES.items():
        for tag, _, plan in _ring_plans(*spec):
            majors.setdefault((tag, spec[2]), set()).add((plan.a_mn, plan.b_mn))
    assert majors == {("forward", 0): {(False, False)}, ("forward", 1): {(False, False)},
                      ("dx", 0): {(False, True)}, ("dx", 1): {(False, True)},
                      ("dw", 0): {(True, True)}, ("dw", 1): {(True, True)}}


def test_ragged_blocks_and_unaligned_rows_take_the_thread_loader():
    bf = torch.bfloat16
    # phase 18's ragged case: blocks of 50 (K 200 over 4) and of 75 (N 300 over 4)
    x, w = torch.zeros(400, 200, dtype=bf), torch.zeros(200, 300, dtype=bf)
    k_block = toc.ag_plan(x, w[50:100], src=1, slice_x=True, w_t=False, sms=H100_SMS)
    n_block = toc.ag_plan(x, w[:, 75:150], src=1, slice_x=False, w_t=False, sms=H100_SMS)
    dw_block = toc.rs_plan(x, torch.zeros(400, 300, dtype=bf), j=1, blk=75, slice_a=False,
                           sms=H100_SMS)
    # (33, 20, 7) a rank: K blocks of 20 at 40-byte offsets, rows of 7 (14 bytes)
    x2, w2 = torch.zeros(132, 80, dtype=bf), torch.zeros(80, 28, dtype=bf)
    small = toc.ag_plan(x2, w2[20:40], src=1, slice_x=True, w_t=False, sms=H100_SMS)
    rows7 = toc.ag_plan(x2[:, :20], torch.zeros(20, 7, dtype=bf), src=0, slice_x=False,
                        w_t=False, sms=H100_SMS)
    # a row stride of 100 elements: 200 bytes, not a multiple of 16
    strided = toc.ag_plan(torch.zeros(64, 100, dtype=bf)[:, :96], torch.zeros(96, 64, dtype=bf),
                          src=0, slice_x=False, w_t=False, sms=H100_SMS)
    for plan in (k_block, n_block, dw_block, small, rows7, strided):
        assert plan.route == "threads", plan
    # the same shapes at aligned offsets take TMA
    assert toc.ag_plan(x, w[:50], src=0, slice_x=True, w_t=False,
                       sms=H100_SMS).route == "threads"   # 50 columns: 100-byte rows
    assert toc.ag_plan(torch.zeros(64, 96, dtype=bf), torch.zeros(96, 64, dtype=bf), src=0,
                       slice_x=False, w_t=False, sms=H100_SMS).route == "tma"


@pytest.mark.parametrize("m,n,k", [(1024, 128, 2048), (4096, 512, 512), (33, 7, 20),
                                   (128, 512, 1024)])
def test_float32_takes_the_cuda_core_tiles(m, n, k):
    plan = toc.step_plan(m, n, k, (k, 1), (n, 1), torch.float32, H100_SMS)
    small = -(-m // 64) * -(-n // 64) < H100_SMS
    assert plan.route == "cuda_cores"
    assert (plan.tile_m, plan.tile_n, plan.split) == ((32, 32, 4) if small else (64, 64, 1))
    assert not (plan.a_mn or plan.b_mn)


@pytest.mark.parametrize("m,n", [(1024, 128), (64, 32), (128, 512), (4096, 2048), (1, 1)])
@pytest.mark.parametrize("k", [1, 64, 100, 128])
def test_a_plan_never_splits_a_contraction_of_128_or_less(m, n, k):
    for a_strides, b_strides in (((k, 1), (n, 1)), ((1, m), (1, k))):
        plan = toc.step_plan(m, n, k, a_strides, b_strides, torch.bfloat16, H100_SMS)
        assert plan.split == 1, plan


def test_long_contractions_split_over_a_cluster():
    plan = toc.step_plan(1024, 128, 2048, (2048, 1), (1, 2048), torch.bfloat16, H100_SMS)
    assert plan.split in toc.TC_SPLITS and plan.split > 1 and plan.blocks >= H100_SMS
    # never more blocks than 64-deep stages to share
    assert toc.step_plan(64, 32, 256, (256, 1), (1, 256), torch.bfloat16, H100_SMS).split == 4


@pytest.mark.parametrize("m,n,k,sms,dtype", [
    (0, 8, 8, 132, torch.bfloat16), (8, 0, 8, 132, torch.bfloat16),
    (8, 8, 0, 132, torch.bfloat16), (-1, 8, 8, 132, torch.float32),
    (32 * 65536, 8, 8, 132, torch.bfloat16), (8, 8, 8, 0, torch.bfloat16),
    (8, 8, 8, 132, torch.float16),
])
def test_step_plan_rejects_bad_dims(m, n, k, sms, dtype):
    with pytest.raises(ValueError):
        toc.step_plan(m, n, k, (k, 1), (n, 1), dtype, sms)
