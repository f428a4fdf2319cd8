"""Throughput, MFU and memory accounting. :func:`mfu` takes the device's
peak rate as a parameter; :func:`peak_flops` knows only the card the port
is written for; :func:`train_memory_bytes` is the JAX package's analytic
budget of one training step on a ``(pipe, data, model)`` mesh, with its
:func:`comm_bytes_per_step` and :func:`tp_sharded_param_count`."""

from __future__ import annotations

from dtc_tpu_torch.config.schema import DTYPE_BYTES, ModelConfig
from dtc_tpu_torch.models.gpt import param_count

#: NVIDIA H100 SXM dense bf16 tensor-core peak (data sheet), FLOP/s, at the
#: full 700 W power limit.
H100_BF16_PEAK_FLOPS = 989e12


def peak_flops(device) -> float | None:
    """The dense bf16 peak of ``device`` when it is an H100, else None (no
    MFU is reported for other devices or the CPU)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and "H100" in torch.cuda.get_device_name(dev):
        return H100_BF16_PEAK_FLOPS
    return None


def gpt_step_flops(cfg: ModelConfig, batch: int, seq_len: int) -> float:
    """Training FLOPs of one step (forward + backward): 6·N·tokens over
    the non-embedding parameters (the LM head counts, the wte/wpe gathers
    do not, on the padded-vocab basis of ``param_count``) plus the causal
    attention term 12·L·B·T²·d_model / 2."""
    n = param_count(cfg)
    n_matmul = n - cfg.padded_vocab_size * cfg.d_model - cfg.max_seq_len * cfg.d_model
    tokens = batch * seq_len
    dense = 6.0 * n_matmul * tokens
    attn = 12.0 * cfg.n_layers * batch * (seq_len ** 2) * cfg.d_model / 2.0
    return dense + attn


def mfu(cfg: ModelConfig, batch: int, seq_len: int, step_time_s: float,
        peak_flops: float | None) -> float | None:
    """Model FLOPs utilization of one device against ``peak_flops``; None
    without a peak or at zero step time."""
    if peak_flops is None or peak_flops <= 0 or step_time_s <= 0:
        return None
    return gpt_step_flops(cfg, batch, seq_len) / (step_time_s * peak_flops)


def tp_sharded_param_count(cfg: ModelConfig) -> int:
    """Parameters Megatron tensor parallelism shards over ``model`` (the
    JAX package's ``tp_sharded_param_count``, dense model): the block
    matmul weights, the column-parallel biases (q/k/v, fc1) and the
    vocab-parallel head's weight and bias. LayerNorms, the row-parallel
    biases and the embeddings are replicated."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    v = cfg.padded_vocab_size
    per_block = 4 * d * d + 3 * d + (d * f + f + f * d)
    return L * per_block + d * v + v


def comm_bytes_per_step(cfg: ModelConfig, batch: int, seq_len: int,
                        mesh_shape: dict[str, int], parallel: str,
                        pp_microbatches: int = 1) -> dict[str, float]:
    """The JAX package's estimate of one device's collective traffic in one
    training step (``comm_bytes_per_step``), in bytes: the gradient
    all-reduce over ``data`` (``2·(d-1)/d`` of the device's parameters;
    FSDP's gathers and reduce-scatter ``3·(d-1)/d``), Megatron's four
    activation all-reduces a layer forward and backward over ``model``,
    and the activations and cotangents each microbatch sends across the
    ``pipe - 1`` stage boundaries. Every term is 0 for an axis of one."""
    d_axis = max(mesh_shape.get("data", 1), 1)
    m_axis = max(mesh_shape.get("model", 1), 1)
    p_axis = max(mesh_shape.get("pipe", 1), 1)
    pbytes = float(DTYPE_BYTES.get(cfg.param_dtype, 4))
    abytes = float(DTYPE_BYTES.get(cfg.compute_dtype, 4))
    n_params = param_count(cfg)
    dp = 0.0
    if d_axis > 1:
        factor = 3.0 if parallel == "fsdp" else 2.0
        if parallel == "fsdp" and m_axis > 1:
            n_tp = tp_sharded_param_count(cfg)
            local_params = (n_tp / m_axis + (n_params - n_tp)) / p_axis
        else:
            local_params = n_params / (m_axis * p_axis)
        dp = factor * (d_axis - 1) / d_axis * local_params * pbytes
    tp = 0.0
    if m_axis > 1:
        act = batch * seq_len * cfg.d_model * abytes / d_axis
        tp = 4.0 * cfg.n_layers * 2.0 * (m_axis - 1) / m_axis * act
    pp = 0.0
    if p_axis > 1:
        micro = batch / max(pp_microbatches, 1) / d_axis
        act = micro * seq_len * cfg.d_model * abytes
        pp = 2.0 * (p_axis - 1) * pp_microbatches * act
    return {"dp_allreduce": dp, "tp_allreduce": tp, "pp_p2p": pp, "total": dp + tp + pp}


def train_memory_bytes(cfg: ModelConfig, batch: int, seq_len: int,
                       mesh_shape: dict[str, int] | None = None,
                       parallel: str = "dp", precision: str = "fp32") -> dict[str, float]:
    """The JAX package's analytic device-memory budget of one training step
    (``dtc_tpu/utils/metrics.py`` ``train_memory_bytes``) for a device of a
    ``mesh_shape`` mesh (``{"pipe", "data", "model"}`` sizes, 1 where
    absent) under ``parallel`` and ``precision``. Bytes by component:

    - ``params``, ``grads``: the device's parameters in ``param_dtype``
      (bfloat16 under ``bf16_mixed``): ``1/model`` of the tensor-parallel
      ones and the replicated ones whole, over ``pipe`` stages, and under
      ``fsdp`` ``1/data`` of that;
    - ``master``: their float32 masters under ``bf16_mixed`` (0 under
      ``fp32``, where the parameters are the masters): 2 + 4 + 8 = 14
      bytes a parameter with the moments, against fp32's 12;
    - ``moments``: AdamW's two float32 moments of those;
    - ``activations``: per layer of the stage ``(10·d_model + 2·d_ff)``
      values a token of the device's batch rows in ``compute_dtype``, plus
      with ``attention: dense`` the float32 (B, H, T, T) probabilities;
      ``remat`` ``block`` and ``block_save_flash`` keep one residual a
      layer plus one layer's working set, ``mlp`` drops the two
      ``d_ff``-wide intermediates; plus the device's ``1/model`` of the
      logits;
    - ``comm_buffers``: :func:`comm_bytes_per_step`'s total;
    - ``batch_io``: the int32 (x, y) rows.

    A structural estimate, not a simulator: it does not tell
    ``block_save_flash``'s saved flash residuals from ``block``."""
    mesh_shape = mesh_shape or {}
    d_axis = max(mesh_shape.get("data", 1), 1)
    m_axis = max(mesh_shape.get("model", 1), 1)
    p_axis = max(mesh_shape.get("pipe", 1), 1)
    n = param_count(cfg)
    n_tp = tp_sharded_param_count(cfg)
    local = (n_tp / m_axis + (n - n_tp)) / p_axis
    if parallel == "fsdp" and d_axis > 1:
        local = local / d_axis
    pbytes = float(DTYPE_BYTES.get("bfloat16" if precision == "bf16_mixed"
                                   else cfg.param_dtype, 4))
    cbytes = float(DTYPE_BYTES.get(cfg.compute_dtype, 4))
    params = local * pbytes
    master = local * 4.0 if precision == "bf16_mixed" else 0.0
    moments = local * 8.0
    grads = local * pbytes
    b_loc = batch / d_axis
    dm, ff = cfg.d_model, cfg.d_ff
    layer_acts = b_loc * seq_len * (10.0 * dm + 2.0 * ff) * cbytes
    if cfg.attention == "dense":
        layer_acts += b_loc * cfg.n_heads * (seq_len ** 2) * 4.0
    n_layers = cfg.n_layers / p_axis
    if cfg.remat_mode in ("block", "block_save_flash"):
        acts = n_layers * b_loc * seq_len * dm * cbytes + layer_acts
    elif cfg.remat_mode == "mlp":
        acts = n_layers * (layer_acts - b_loc * seq_len * 2.0 * ff * cbytes)
    else:
        acts = n_layers * layer_acts
    acts += b_loc * seq_len * cfg.padded_vocab_size * cbytes / m_axis  # logits
    comm = comm_bytes_per_step(cfg, batch, seq_len, mesh_shape, parallel)["total"]
    batch_io = 2.0 * b_loc * seq_len * 4.0
    total = params + master + moments + grads + acts + comm + batch_io
    return {
        "params": params, "master": master, "moments": moments, "grads": grads,
        "activations": acts, "comm_buffers": comm, "batch_io": batch_io, "total": total,
    }
