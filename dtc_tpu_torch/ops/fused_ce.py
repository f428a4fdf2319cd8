"""LM-head logits with the padded-vocab mask.

Only :func:`head_logits` is ported so far (the serving path); the fused
head + cross-entropy with its augmented-matmul backward comes with the
training slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e9


def head_logits(h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                vocab_size: int) -> torch.Tensor:
    """Logits in h's (compute) dtype: ``h @ weight.T + bias`` with weight
    ``(V_padded, d)``, then the pad columns ``>= vocab_size`` set to -1e9
    (rounded to the compute dtype), so no softmax or argmax over the
    padded vocab can pick them."""
    cdtype = h.dtype
    logits = F.linear(h, weight.to(cdtype), bias.to(cdtype))
    v = weight.shape[0]
    if v != vocab_size:
        pad = torch.arange(v, device=h.device) >= vocab_size
        logits = logits.masked_fill(pad, NEG_INF)
    return logits
