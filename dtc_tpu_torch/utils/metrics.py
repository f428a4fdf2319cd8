"""Throughput, MFU and memory accounting. :func:`mfu` takes the device's
peak rate as a parameter; :func:`peak_flops` knows only the card the port
is written for; :func:`train_memory_bytes` is the JAX package's analytic
budget of one training step."""

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


def train_memory_bytes(cfg: ModelConfig, batch: int, seq_len: int, data: int = 1,
                       parallel: str = "dp") -> dict[str, float]:
    """The JAX package's analytic device-memory budget of one training step
    (``dtc_tpu/utils/metrics.py`` ``train_memory_bytes``) for a device of a
    data axis of ``data`` devices under ``parallel`` (``dp`` or ``fsdp``;
    the port trains no TP or PP mesh yet), with float32 master weights (no
    master copy). Bytes by component:

    - ``params``, ``grads``: the device's parameters in ``param_dtype``,
      every parameter, or 1/``data`` of them under ``fsdp``;
    - ``moments``: AdamW's two float32 moments of those;
    - ``activations``: per layer ``(10·d_model + 2·d_ff)`` values a token
      of the device's batch rows in ``compute_dtype``, plus with
      ``attention: dense`` the float32 (B, H, T, T) probabilities;
      ``remat`` ``block`` and ``block_save_flash`` keep one residual a
      layer plus one layer's working set, ``mlp`` drops the two
      ``d_ff``-wide intermediates; plus the logits;
    - ``comm_buffers``: the JAX package's ``comm_bytes_per_step`` over the
      data axis, ``2·(d-1)/d`` (DP's all-reduce) or ``3·(d-1)/d`` (FSDP's
      gathers and reduce-scatter) of the parameters' bytes;
    - ``batch_io``: the int32 (x, y) rows.

    A structural estimate, not a simulator: it does not tell
    ``block_save_flash``'s saved flash residuals from ``block``."""
    n = param_count(cfg)
    local = n / data if parallel == "fsdp" else n
    pbytes = float(DTYPE_BYTES.get(cfg.param_dtype, 4))
    cbytes = float(DTYPE_BYTES.get(cfg.compute_dtype, 4))
    params = local * pbytes
    moments = local * 8.0
    grads = local * pbytes
    b_loc = batch / data
    dm, ff = cfg.d_model, cfg.d_ff
    layer_acts = b_loc * seq_len * (10.0 * dm + 2.0 * ff) * cbytes
    if cfg.attention == "dense":
        layer_acts += b_loc * cfg.n_heads * (seq_len ** 2) * 4.0
    n_layers = float(cfg.n_layers)
    if cfg.remat_mode in ("block", "block_save_flash"):
        acts = n_layers * b_loc * seq_len * dm * cbytes + layer_acts
    elif cfg.remat_mode == "mlp":
        acts = n_layers * (layer_acts - b_loc * seq_len * 2.0 * ff * cbytes)
    else:
        acts = n_layers * layer_acts
    acts += b_loc * seq_len * cfg.padded_vocab_size * cbytes  # logits
    comm = (3.0 if parallel == "fsdp" else 2.0) * (data - 1) / data * n * pbytes
    batch_io = 2.0 * b_loc * seq_len * 4.0
    master = 0.0
    total = params + master + moments + grads + acts + comm + batch_io
    return {
        "params": params, "master": master, "moments": moments, "grads": grads,
        "activations": acts, "comm_buffers": comm, "batch_io": batch_io, "total": total,
    }
