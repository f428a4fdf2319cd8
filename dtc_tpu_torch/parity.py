"""Carry a flax GPT parameter tree into the port's ``GPT``.

The flax tree is ``{embed, stage, head}`` with every block parameter
scan-stacked under ``stage/blocks/Block_0`` with a leading ``(L,)`` axis,
and Dense kernels laid out ``(in, out)``. :func:`from_flax` unstacks the
layers and transposes the kernels to ``nn.Linear``'s ``(out, in)``.
Takes numpy arrays (``jax.tree.map(np.asarray, params)``), so this module
needs neither jax nor flax. :func:`lora_from_flax` carries a flax
``"lora"`` collection (adapter factors) the same way. :func:`fsdp_shards`
cuts such a parameter set into one rank's FSDP shards and
:func:`gather_shards` puts every rank's shards back together;
:func:`tp_shards` / :func:`gather_tp` do the same for Megatron tensor
parallelism, :func:`mesh_shards` / :func:`gather_mesh` for both at once on
a ``(data, model)`` mesh, and :func:`pp_stage` / :func:`gather_stages`
cut a parameter set into a pipeline stage's part (its chunks' layers,
renumbered, with the embedding on the first stage and the head on the
last) and back. Composed with :func:`from_flax` they take a flax tree to
each rank's parameters.

:func:`attention_tolerance` is the limit attention outputs are held to
when two implementations are compared (kernel vs plain version, port vs
JAX package); :func:`grad_tolerance` the limit on attention gradients;
:func:`row_tolerance` the limit on matmul outputs (the FSDP ring's).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from dtc_tpu_torch.adapters.lora import from_flax_arrays

#: float32 outputs differ by summation order only.
FP32_ATOL = 1e-5
#: bfloat16 outputs may differ by this many ulps of each head's largest
#: |output|: rounding flips in p and in the output cast, not more (the
#: JAX package's blocked kernel, which rounds p against a running max,
#: sits 2.5 ulps from the one-pass plain version at S 4608).
BF16_ULPS = 4


def attention_tolerance(want: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Per-element limit on ``|got - want|`` for packed ``(..., H·D)``
    attention outputs of ``want``'s dtype: :data:`FP32_ATOL` for float32;
    for bfloat16, :data:`BF16_ULPS` ulps of the largest ``|want|`` among the
    same head's D outputs (the ulp of x in [2^e, 2^(e+1)) is 2^(e-7)), so
    the limit scales with the values it compares."""
    if want.dtype == torch.float32:
        return torch.full(want.shape, FP32_ATOL)
    if want.dtype != torch.bfloat16:
        raise ValueError(f"no tolerance for {want.dtype}")
    *lead, hd = want.shape
    heads = want.detach().float().cpu().reshape(*lead, n_heads, hd // n_heads)
    _, e = torch.frexp(heads.abs().amax(dim=-1, keepdim=True))  # amax = m·2^e, m in [0.5, 1)
    ulp = torch.exp2((e - 8).float())
    return (BF16_ULPS * ulp).expand(heads.shape).reshape(want.shape)


def grad_tolerance(want: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Per-element limit on ``|got - want|`` for packed ``(B, T, H·D)``
    attention gradients. A gradient row is a sum over many rows of the
    other operand, so its error follows the size of the terms, not of the
    row: float32 :data:`FP32_ATOL` times the tensor's largest ``|want|``;
    bfloat16 :data:`BF16_ULPS` ulps of each head's largest ``|want|`` over
    the whole tensor (the rounding of ds or p to bfloat16 can flip by one
    ulp where two sum orders differ)."""
    w = want.detach().float().cpu()
    if want.dtype == torch.float32:
        return torch.full(want.shape, FP32_ATOL * float(w.abs().max()))
    if want.dtype != torch.bfloat16:
        raise ValueError(f"no tolerance for {want.dtype}")
    b, t, hd = want.shape
    heads = w.reshape(b * t, n_heads, hd // n_heads)
    _, e = torch.frexp(heads.abs().amax(dim=(0, 2), keepdim=True))
    ulp = torch.exp2((e - 8).float())
    return (BF16_ULPS * ulp).expand(heads.shape).reshape(want.shape)


def row_tolerance(want: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Per-element limit on ``|got - want|`` for matmul outputs compared in
    ``dtype``: float32 :data:`FP32_ATOL` of each row's largest ``|want|``
    (summation order only); bfloat16 :data:`BF16_ULPS` ulps of each row's
    largest ``|want|``."""
    top = want.detach().float().cpu().abs().amax(dim=-1, keepdim=True)
    if dtype == torch.float32:
        return (FP32_ATOL * top).expand(want.shape)
    if dtype != torch.bfloat16:
        raise ValueError(f"no tolerance for {dtype}")
    _, e = torch.frexp(top)
    return (BF16_ULPS * torch.exp2((e - 8).float())).expand(want.shape)


_DENSE = {
    "attn.q_proj": ("attn", "q_proj"), "attn.k_proj": ("attn", "k_proj"),
    "attn.v_proj": ("attn", "v_proj"), "attn.out_proj": ("attn", "out_proj"),
    "mlp.fc1": ("mlp", "fc1"), "mlp.fc2": ("mlp", "fc2"),
}


def from_flax(params, cfg) -> dict[str, torch.Tensor]:
    """A ``state_dict`` for :class:`dtc_tpu_torch.models.gpt.GPT` built
    from a flax parameter tree of numpy arrays (CPU tensors; load with
    ``model.load_state_dict``, which copies to the model's device)."""
    def t(x):
        return torch.from_numpy(np.array(x))

    sd = {
        "embed.wte.weight": t(params["embed"]["wte"]["embedding"]),
        "embed.wpe.weight": t(params["embed"]["wpe"]["embedding"]),
        "head.ln_f.weight": t(params["head"]["ln_f"]["scale"]),
        "head.ln_f.bias": t(params["head"]["ln_f"]["bias"]),
        "head.lm_head.weight": t(params["head"]["lm_head"]["kernel"]).T.contiguous(),
        "head.lm_head.bias": t(params["head"]["lm_head"]["bias"]),
    }
    blk = params["stage"]["blocks"]["Block_0"]
    for i in range(cfg.n_layers):
        pre = f"stage.blocks.{i}."
        for ln in ("ln_1", "ln_2"):
            sd[pre + ln + ".weight"] = t(blk[ln]["scale"][i])
            sd[pre + ln + ".bias"] = t(blk[ln]["bias"][i])
        for name, (grp, layer) in _DENSE.items():
            sd[pre + name + ".weight"] = t(blk[grp][layer]["kernel"][i]).T.contiguous()
            sd[pre + name + ".bias"] = t(blk[grp][layer]["bias"][i])
    return sd


def adam_from_optax(mu, nu, count: int, cfg, names) -> dict:
    """The port optimizer's ``state_dict``
    (:meth:`~dtc_tpu_torch.train.optimizer.ClippedAdamW.load_state_dict`)
    from optax's AdamW state: ``mu`` / ``nu``, the ``ScaleByAdamState``
    moments as flax trees of numpy arrays, carried across by
    :func:`from_flax`'s mapping, and its ``count``, in the order of
    ``names`` (the model's parameter names)."""
    m, n = from_flax(mu, cfg), from_flax(nu, cfg)
    return {"count": int(count), "mu": [m[k] for k in names], "nu": [n[k] for k in names]}


def fsdp_shards(state: dict[str, torch.Tensor], rank: int, world: int) -> dict[str, torch.Tensor]:
    """Rank ``rank``'s FSDP shards of a whole ``state_dict`` (such as
    :func:`from_flax` gives): each parameter FSDP shards cut into ``world``
    equal chunks along its sharded dim
    (:func:`~dtc_tpu_torch.parallel.sharding.param_shard_dim`), the others
    whole."""
    from dtc_tpu_torch.parallel.sharding import param_shard_dim

    out = {}
    for name, x in state.items():
        d = param_shard_dim(name)
        if d is not None and x.shape[d] % world:
            raise ValueError(f"{name}: dim {d} of {tuple(x.shape)} does not divide by {world}")
        out[name] = x if d is None else x.chunk(world, d)[rank].clone()
    return out


def gather_shards(shards: list[dict[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
    """The whole ``state_dict`` from every rank's :func:`fsdp_shards`, in
    rank order (the whole parameters from rank 0)."""
    from dtc_tpu_torch.parallel.sharding import param_shard_dim

    out = {}
    for name, x in shards[0].items():
        d = param_shard_dim(name)
        out[name] = x if d is None else torch.cat([s[name] for s in shards], d)
    return out


def tp_shards(state: dict[str, torch.Tensor], rank: int, size: int) -> dict[str, torch.Tensor]:
    """Rank ``rank``'s parameters of a whole ``state_dict`` under Megatron
    tensor parallelism over ``size`` ranks: each parameter the rule table
    shards over ``model`` cut into ``size`` equal chunks along its dim
    (:func:`~dtc_tpu_torch.parallel.sharding.tp_shard_dim`), the others
    whole."""
    from dtc_tpu_torch.parallel.sharding import tp_shard_dim

    out = {}
    for name, x in state.items():
        d = tp_shard_dim(name)
        if d is not None and x.shape[d] % size:
            raise ValueError(f"{name}: dim {d} of {tuple(x.shape)} does not divide by {size}")
        out[name] = x if d is None else x.chunk(size, d)[rank].clone()
    return out


def gather_tp(shards: list[dict[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
    """The whole ``state_dict`` from every model rank's :func:`tp_shards`,
    in rank order (the replicated parameters from rank 0)."""
    from dtc_tpu_torch.parallel.sharding import tp_shard_dim

    out = {}
    for name, x in shards[0].items():
        d = tp_shard_dim(name)
        out[name] = x if d is None else torch.cat([s[name] for s in shards], d)
    return out


def mesh_shards(state: dict[str, torch.Tensor], data_idx: int, n_data: int,
                model_idx: int, n_model: int) -> dict[str, torch.Tensor]:
    """The parameters of the rank at ``(data_idx, model_idx)`` of a
    ``(data, model)`` mesh under FSDP with Megatron tensor parallelism, from
    a whole ``state_dict``: its model index's :func:`tp_shards` slice, then
    that slice's :func:`fsdp_shards` shard for its **data** index (the FSDP
    ring is the data group, not the world). With ``n_model`` 1 (ring
    attention's model axis holds sequence shards, no parameter slices) the
    FSDP shard alone."""
    return fsdp_shards(tp_shards(state, model_idx, n_model), data_idx, n_data)


def gather_mesh(grid: list[list[dict[str, torch.Tensor]]]) -> dict[str, torch.Tensor]:
    """The whole ``state_dict`` from every rank's :func:`mesh_shards`,
    ``grid[d][m]`` the rank at data index d and model index m (the global
    rank ``d·model + m``): each model index's FSDP shards gathered over the
    data axis, then the Megatron slices over the model axis."""
    return gather_tp([gather_shards([row[m] for row in grid]) for m in range(len(grid[0]))])


_BLOCK = re.compile(r"stage\.blocks\.(\d+)\.(.+)")


def _n_layers(state) -> int:
    return 1 + max(int(m.group(1)) for m in map(_BLOCK.match, state) if m)


def pp_stage(state: dict[str, torch.Tensor], stage: int, stages: int,
             virtual: int = 1) -> dict[str, torch.Tensor]:
    """Stage ``stage``'s parameters of a whole ``state_dict`` over
    ``stages`` stages of ``virtual`` chunks each: the layers of its chunks
    (``c = v·stages + stage``, the JAX package's ``pp_stack_params``) in
    chunk order, renumbered from 0; ``embed.*`` on stage 0 and ``head.*``
    on the last stage."""
    from dtc_tpu_torch.parallel.pipeline import StageLayout

    layers = StageLayout(stage, stages, virtual).layers(_n_layers(state))
    out = {}
    for name, x in state.items():
        m = _BLOCK.match(name)
        if m is not None:
            if int(m.group(1)) in layers:
                out[f"stage.blocks.{layers.index(int(m.group(1)))}.{m.group(2)}"] = x
        elif (name.startswith("embed.") and stage == 0
              or name.startswith("head.") and stage == stages - 1):
            out[name] = x
    return out


def gather_stages(parts: list[dict[str, torch.Tensor]], virtual: int = 1) -> dict[str, torch.Tensor]:
    """The whole ``state_dict`` from every stage's :func:`pp_stage`, in
    stage order."""
    from dtc_tpu_torch.parallel.pipeline import StageLayout

    n = sum(_n_layers(p) for p in parts)
    blocks, out = {}, {}
    for stage, part in enumerate(parts):
        layers = StageLayout(stage, len(parts), virtual).layers(n)
        for name, x in part.items():
            m = _BLOCK.match(name)
            if m is None:
                out[name] = x
            else:
                blocks[(layers[int(m.group(1))], m.group(2))] = x
    out.update({f"stage.blocks.{i}.{rest}": x for (i, rest), x in sorted(blocks.items())})
    return out


def lora_from_flax(lora) -> dict[str, torch.Tensor]:
    """One adapter's factors (CPU tensors, see ``dtc_tpu_torch.adapters``)
    from a flax ``"lora"`` collection of numpy arrays: per site
    ``(L, in, r)`` -> ``(L, r, in)`` and ``(L, r, out)`` -> ``(L, out, r)``,
    the layer axis kept."""
    flat = {}

    def walk(node, path):
        for key, sub in node.items():
            if isinstance(sub, dict):
                walk(sub, path + [key])
            else:
                flat["/".join(path + [key])] = sub

    walk(lora, [])
    return from_flax_arrays(flat)
