"""Which parameters FSDP and Megatron tensor parallelism shard, and along
which dim: the port's copy of the JAX package's logical-axis rule table
(``parallel/sharding.py``), restricted to the dense model.

The JAX model names every axis of every parameter logically
(:data:`PARAM_AXES_TABLE`) and a rule table maps logical axes to mesh axes.
Under :data:`FSDP_RULES` the d_model axis of parameters (``embed_p``) maps
to ``data``, so every parameter with a d_model axis is cut into equal
shards over the data ranks, and the rest (the q/k/v and fc1 biases, whose
only axis is ``qkv`` / ``mlp``, and ``lm_head``'s bias, ``vocab_out``)
stays whole on every rank.

:func:`param_shard_dim` maps a parameter of the port's ``GPT`` (its
``named_parameters`` name) to the dim that shards over ``data``;
:func:`param_spec` gives every dim's mesh axis under a rule table, so a
parameter on a ``(data, model)`` mesh under :data:`FSDP_RULES` shows both
its FSDP dim and its Megatron dim. The
layouts differ: a flax Dense kernel is ``(in, out)`` and the port's
``Dense.weight`` / ``lm_head.weight`` are ``(out, in)``, and the port keeps
one module per layer where flax stacks the layers on a leading axis. So
flax's ``embed_p`` on axis 0 of the q/k/v/fc1 kernels is dim 1 of the
port's weight.

:data:`DEFAULT_RULES` is also the Megatron table: ``qkv`` and ``mlp``
(the q/k/v and fc1 outputs: column-parallel, weight and bias) and
``vocab_out`` (the head's columns: vocab-parallel, weight and bias) map to
``model``; out_proj and fc2 contract over ``qkv`` / ``mlp`` (row-parallel)
and their biases, on ``embed_p``, stay whole, as do ``wte``, ``wpe`` and
the LayerNorms. :func:`tp_shard_dim` gives the dim of the port's
parameter that shards over ``model``, :data:`TP_ROLES` the role each site
plays.

:func:`fsdp_axis` is the rule behind the JAX package's
``fsdp_axis_in_scope``: the mesh axis FSDP shards over, or None when the
rules do not shard ``embed_p``, its axis has one rank, or
sequence-parallel rules own the activations.
"""

from __future__ import annotations

#: Logical -> mesh axis rules (``DEFAULT_RULES`` of the JAX package).
DEFAULT_RULES: tuple[tuple[str, str | None], ...] = (
    ("batch", "data"),
    ("heads", "model"),
    ("qkv", "model"),
    ("mlp", "model"),
    ("vocab_out", "model"),
    ("embed", None),
    ("embed_p", None),
    ("seq", None),
    ("head_dim", None),
    ("layers", None),
    ("stages", "pipe"),
    ("vocab_in", None),
    ("seqpos", None),
    ("microbatch", None),
    ("experts", "model"),
    ("experts_p", "model"),
)

#: FSDP / ZeRO-3: the d_model axis of parameters shards over the axis the
#: batch uses.
FSDP_RULES: tuple[tuple[str, str | None], ...] = tuple(
    (name, "data") if name == "embed_p" else (name, axis)
    for name, axis in DEFAULT_RULES
)


def ring_rules_from(rules):
    """Sequence-parallel rules derived from ``rules``: ``seq`` over
    ``model`` and the Megatron axes off it (``ring_rules_from`` of the JAX
    package)."""
    return tuple(
        (name, "model") if name == "seq"
        else (name, None) if name in ("heads", "qkv", "mlp", "vocab_out")
        else (name, axis)
        for name, axis in rules
    )


#: Flax parameter-path suffix -> logical axes, for the dense model (the
#: ``layers`` axis is flax's scan stacking).
PARAM_AXES_TABLE: tuple[tuple[tuple[str, ...], tuple[str | None, ...]], ...] = (
    (("wte", "embedding"), ("vocab_in", "embed_p")),
    (("wpe", "embedding"), ("seqpos", "embed_p")),
    (("ln_f", "scale"), ("embed_p",)),
    (("ln_f", "bias"), ("embed_p",)),
    (("lm_head", "kernel"), ("embed_p", "vocab_out")),
    (("lm_head", "bias"), ("vocab_out",)),
    (("ln_1", "scale"), ("layers", "embed_p")),
    (("ln_1", "bias"), ("layers", "embed_p")),
    (("ln_2", "scale"), ("layers", "embed_p")),
    (("ln_2", "bias"), ("layers", "embed_p")),
    (("q_proj", "kernel"), ("layers", "embed_p", "qkv")),
    (("q_proj", "bias"), ("layers", "qkv")),
    (("k_proj", "kernel"), ("layers", "embed_p", "qkv")),
    (("k_proj", "bias"), ("layers", "qkv")),
    (("v_proj", "kernel"), ("layers", "embed_p", "qkv")),
    (("v_proj", "bias"), ("layers", "qkv")),
    (("out_proj", "kernel"), ("layers", "qkv", "embed_p")),
    (("out_proj", "bias"), ("layers", "embed_p")),
    (("fc1", "kernel"), ("layers", "embed_p", "mlp")),
    (("fc1", "bias"), ("layers", "mlp")),
    (("fc2", "kernel"), ("layers", "mlp", "embed_p")),
    (("fc2", "bias"), ("layers", "embed_p")),
)

#: The port's module / parameter names -> the flax path suffix, and
#: whether the port's tensor is the flax one transposed.
_PORT_TO_FLAX = {
    ("wte", "weight"): (("wte", "embedding"), False),
    ("wpe", "weight"): (("wpe", "embedding"), False),
    ("ln_f", "weight"): (("ln_f", "scale"), False),
    ("ln_f", "bias"): (("ln_f", "bias"), False),
    ("lm_head", "weight"): (("lm_head", "kernel"), True),
    ("lm_head", "bias"): (("lm_head", "bias"), False),
    **{(ln, "weight"): ((ln, "scale"), False) for ln in ("ln_1", "ln_2")},
    **{(ln, "bias"): ((ln, "bias"), False) for ln in ("ln_1", "ln_2")},
    **{(d, "weight"): ((d, "kernel"), True)
       for d in ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")},
    **{(d, "bias"): ((d, "bias"), False)
       for d in ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")},
}


def port_logical_axes(name: str) -> tuple[str | None, ...]:
    """The logical axes of the port's parameter ``name`` (as
    ``GPT.named_parameters`` gives it), in the port's layout. Raises
    ``KeyError`` for a parameter the table does not cover."""
    parts = tuple(name.split("."))
    key = parts[-2:]
    if key not in _PORT_TO_FLAX:
        raise KeyError(
            f"parameter {name} has no entry in PARAM_AXES_TABLE (sharding must be "
            "explicit for every parameter)"
        )
    suffix, transposed = _PORT_TO_FLAX[key]
    axes = dict(PARAM_AXES_TABLE)[suffix]
    axes = tuple(a for a in axes if a != "layers")
    return axes[::-1] if transposed else axes


def param_spec(name: str, rules) -> tuple[str | None, ...]:
    """The mesh axis each dim of the port's parameter ``name`` shards over
    under ``rules`` (None: whole), in the port's layout: the counterpart of
    the JAX package's ``param_specs`` for one parameter, its ``layers`` axis
    dropped and a Dense kernel's axes reversed. Under :data:`FSDP_RULES` a
    parameter may shard two dims, over ``data`` (its FSDP dim) and over
    ``model`` (its Megatron dim); under ``ring_rules_from(FSDP_RULES)``
    only the FSDP dim stays."""
    table = dict(rules)
    return tuple(table[a] for a in port_logical_axes(name))


def _shard_dim(name: str, rules, axis: str) -> int | None:
    spec = param_spec(name, rules)
    return spec.index(axis) if axis in spec else None


def param_shard_dim(name: str) -> int | None:
    """The dim of the port's parameter ``name`` that :data:`FSDP_RULES`
    shard over ``data``, or None when the parameter stays whole."""
    return _shard_dim(name, FSDP_RULES, "data")


def tp_shard_dim(name: str) -> int | None:
    """The dim of the port's parameter ``name`` that Megatron tensor
    parallelism (:data:`DEFAULT_RULES`) shards over ``model``, or None
    when every rank of the model group holds it whole (replicated)."""
    return _shard_dim(name, DEFAULT_RULES, "model")


#: The dense sites under Megatron tensor parallelism, as
#: :func:`tp_shard_dim` derives them from the rule table: column-parallel
#: sites hold a slice of the outputs (and of the bias), row-parallel ones a
#: slice of the contraction (their products are partial sums, reduced over
#: the model group before the whole bias is added once), the vocab-parallel
#: head a slice of the padded vocab's columns.
TP_ROLES = {"q_proj": "column", "k_proj": "column", "v_proj": "column", "fc1": "column",
            "out_proj": "row", "fc2": "row", "lm_head": "vocab"}


def fsdp_axis(rules, mesh_sizes: dict[str, int]) -> str | None:
    """The mesh axis FSDP shards parameters over under ``rules`` on a mesh
    of ``mesh_sizes``, or None (the rule of the JAX package's
    ``fsdp_axis_in_scope``)."""
    table = dict(rules)
    axis = table.get("embed_p")
    if not isinstance(axis, str):
        return None
    seq = table.get("seq")
    if isinstance(seq, str) and mesh_sizes.get(seq, 1) > 1:
        # Sequence-parallel rules own the activations: the serialized
        # path runs (as in the JAX package).
        return None
    return axis if mesh_sizes.get(axis, 1) > 1 else None
