"""Throughput and MFU accounting. :func:`mfu` takes the device's peak
rate as a parameter; :func:`peak_flops` knows only the card the port is
written for."""

from __future__ import annotations

from dtc_tpu_torch.config.schema import ModelConfig
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
