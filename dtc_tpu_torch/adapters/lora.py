"""LoRA adapter factors for the port: shapes, initialisation, the resident
serving stack, validation, the offline merge oracle and the adapter
artifact.

A site ``s`` (a targeted dense layer: q/k/v/out_proj in attention, fc1 and
fc2 in the MLP) computes ``y = W x + b + (alpha / rank) * B (A x)``; the
delta's rounding points are :func:`dtc_tpu_torch.models.gpt.apply_lora`'s.
The factors of one adapter are a flat dict of tensors in ``nn.Linear``'s
orientation with the layer axis first, so a kernel reads contiguous rows:

- ``"<s>_a"``: ``(L, rank, in)``; ``"<s>_b"``: ``(L, out, rank)``.

The serving engine keeps a stack of ``n_adapters`` of them (a leading
axis; slot 0 all zero, the base model) and passes per-row slot ids; the
model and the decode megakernel index the stack by the ids, no copy.

The artifact is the JAX package's ``.npz``: the flax ``"lora"``
collection's leaves under their ``/``-joined keys
(``stage/blocks/Block_0/attn/q_proj_a``) in flax's orientation
(``(L, in, rank)`` / ``(L, rank, out)``), a ``__meta__`` JSON string, no
pickle; so an adapter either package writes, the other serves.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch
import torch.nn as nn

from dtc_tpu_torch.models.gpt import DTYPES

#: Every site an adapter can target, in the kernel's table order.
SITES = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")
_GROUP = {"q_proj": "attn", "k_proj": "attn", "v_proj": "attn", "out_proj": "attn",
          "fc1": "mlp", "fc2": "mlp"}
#: Where the flax collection keeps the scan-stacked block variables.
FLAX_PREFIX = "stage/blocks/Block_0"


def lora_enabled(cfg) -> bool:
    """True when ``cfg`` (a ModelConfig) carries an active adapter block."""
    return cfg.adapter.rank > 0


def site_dims(cfg, site: str) -> tuple[int, int]:
    """(in, out) features of one site."""
    d, f = cfg.d_model, cfg.d_ff
    return {"fc1": (d, f), "fc2": (f, d)}.get(site, (d, d))


def lora_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """``{key: shape}`` of one adapter's factors for ``cfg`` (empty at rank
    0). Under mixture-of-experts only the attention sites exist."""
    a = cfg.adapter
    if a.rank <= 0:
        return {}
    out = {}
    for site in SITES:
        if site not in a.target_modules or (cfg.moe_experts > 0 and _GROUP[site] == "mlp"):
            continue
        d_in, d_out = site_dims(cfg, site)
        out[f"{site}_a"] = (cfg.n_layers, a.rank, d_in)
        out[f"{site}_b"] = (cfg.n_layers, d_out, a.rank)
    return out


def init_lora(model, seed: int = 0) -> dict[str, torch.Tensor]:
    """Fresh factors for ``model`` on its device: A lecun-normal (flax's
    truncated normal, variance 1 / in) from a generator seeded by ``seed``,
    B zero, so the adapted model starts equal to the base."""
    cfg = model.cfg
    shapes = lora_shapes(cfg)
    if not shapes:
        raise ValueError("model has no adapter sites (adapter.rank == 0)")
    pdt = DTYPES[cfg.param_dtype]
    gen = torch.Generator(device=model.device).manual_seed(seed)
    out = {}
    for key, shape in shapes.items():
        t = torch.zeros(shape, dtype=pdt, device=model.device)
        if key.endswith("_a"):
            std = math.sqrt(1.0 / shape[-1]) / 0.87962566103423978
            nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
        out[key] = t
    return out


def init_lora_stack(model, n_adapters: int) -> dict[str, torch.Tensor]:
    """The resident serving stack: every factor with a leading
    ``(n_adapters,)`` axis, all zeros, on the model's device. Slot 0 stays
    zero: zero factors make the delta exactly zero, so slot 0 is the base
    model."""
    shapes = lora_shapes(model.cfg)
    if not shapes:
        raise ValueError("model has no adapter sites (adapter.rank == 0)")
    pdt = DTYPES[model.cfg.param_dtype]
    return {k: torch.zeros((n_adapters,) + s, dtype=pdt, device=model.device)
            for k, s in shapes.items()}


def validate_lora_tree(stack: dict, factors: dict) -> None:
    """Raise ValueError unless ``factors`` has the stack's keys and each
    leaf the stack leaf's shape without its adapter axis."""
    if set(factors) != set(stack):
        raise ValueError(
            f"adapter factors {sorted(factors)} do not match the model's sites "
            f"{sorted(stack)}"
        )
    for key, s in stack.items():
        if tuple(factors[key].shape) != tuple(s.shape[1:]):
            raise ValueError(
                f"adapter factor {key} has shape {tuple(factors[key].shape)}, the "
                f"model's is {tuple(s.shape[1:])} (wrong rank or model dims?)"
            )


def merge_lora(state_dict: dict, lora: dict, cfg) -> dict:
    """The offline oracle: base weights with the adapter folded in,
    ``W' = W + (alpha / rank) * B A`` per site and layer, as a new
    ``state_dict`` of a rank-0 model (the inputs are not changed)."""
    out = dict(state_dict)
    scale = cfg.adapter.scale
    for key, a in lora.items():
        if not key.endswith("_a"):
            continue
        site = key[:-2]
        b = lora[site + "_b"]
        for i in range(a.shape[0]):
            w = f"stage.blocks.{i}.{_GROUP[site]}.{site}.weight"
            delta = scale * (b[i].float() @ a[i].float())
            base = state_dict[w]
            out[w] = (base.float() + delta.to(base.device)).to(base.dtype)
    return out


def _flax_key(key: str) -> str:
    return f"{FLAX_PREFIX}/{_GROUP[key[:-2]]}/{key}"


def to_flax_arrays(lora: dict) -> dict[str, np.ndarray]:
    """One adapter's factors as the flax collection's flat leaves: ``/``
    keys, flax orientation (``(L, in, r)`` / ``(L, r, out)``)."""
    return {_flax_key(k): v.detach().cpu().transpose(-1, -2).contiguous().numpy()
            for k, v in lora.items()}


def from_flax_arrays(flat: dict) -> dict[str, torch.Tensor]:
    """The inverse of :func:`to_flax_arrays`: flat flax leaves (numpy) to the
    port's factors (CPU tensors). A key is ``stage/blocks[/<scan
    module>]/<attn|mlp>/<site>_<a|b>``."""
    out = {}
    for key, arr in flat.items():
        parts = key.split("/")
        leaf = parts[-1]
        if (parts[:2] != ["stage", "blocks"] or leaf[:-2] not in SITES
                or leaf[-2:] not in ("_a", "_b")):
            raise ValueError(f"not a LoRA factor key: {key!r}")
        out[leaf] = torch.from_numpy(np.array(arr)).transpose(-1, -2).contiguous()
    return {k: out[k] for k in sorted(out, key=lambda k: (SITES.index(k[:-2]), k))}


def save_adapter(path: str, lora: dict, meta: dict) -> None:
    """Write one adapter artifact (the JAX package's ``.npz`` format),
    atomically: a temporary file, fsync, rename."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __meta__=json.dumps(meta), **to_flax_arrays(lora))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_adapter_file(path: str, like: dict | None = None):
    """Read an adapter artifact -> ``(factors, meta)``, factors as CPU
    tensors. With ``like`` (a model's factors or an engine's stack) the
    file must hold every one of its keys, at its shape."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        lora = from_flax_arrays({k: z[k] for k in z.files if k != "__meta__"})
    if like is not None:
        missing = sorted(set(like) - set(lora))
        if missing:
            raise ValueError(f"adapter file {path} is missing {missing}")
        for k, v in like.items():
            if tuple(lora[k].shape) != tuple(v.shape[-3:]):
                raise ValueError(
                    f"adapter file {path}: {k} has shape {tuple(lora[k].shape)}, "
                    f"the model's is {tuple(v.shape[-3:])}"
                )
        lora = {k: lora[k] for k in like}
    return lora, meta
