"""LM-head logits with the padded-vocab mask, and the fused head +
cross-entropy of the training path.

:func:`fused_head_ce` is the loss the model returns when it is given
targets. Its backward recomputes ``dlogits = (softmax - onehot)·g/N`` in
float32 from the saved logits and softmax statistics, casts it to the
activations' dtype, and forms dW and db as one product ``[h; 1]ᵀ·dlogits``
(the bias gradient rides along as the last column), plus
``dh = dlogits·W`` — the JAX package's ``ops/fused_ce.py`` backward. The
products are plain ``torch.matmul``; the JAX package leaves them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e9


def head_logits(h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                vocab_size: int) -> torch.Tensor:
    """Logits in h's (compute) dtype: ``h @ weight.T`` rounded to the
    compute dtype, then ``+ bias`` in the compute dtype (the reference's
    ``jnp.dot(h, w) + b``) with weight ``(V_padded, d)``, then the pad
    columns ``>= vocab_size`` set to -1e9 (rounded to the compute dtype),
    so no softmax or argmax over the padded vocab can pick them."""
    cdtype = h.dtype
    logits = F.linear(h, weight.to(cdtype)) + bias.to(cdtype)
    v = weight.shape[0]
    if v != vocab_size:
        pad = torch.arange(v, device=h.device) >= vocab_size
        logits = logits.masked_fill(pad, NEG_INF)
    return logits


def _stats_loss(logits: torch.Tensor, y: torch.Tensor):
    """Mean cross entropy and the softmax statistics, in the reference's
    op order: float32 logits, the row max (no gradient), log-sum-exp of the
    shifted logits, the gold logit. Returns ``(loss, (maxl, logz))``. The
    gold logit is gathered; the reference's iota-match sum adds exact
    zeros to the same value."""
    l32 = logits.float()
    maxl = l32.amax(dim=-1, keepdim=True).detach()
    shifted = l32 - maxl
    logz = torch.log(torch.exp(shifted).sum(dim=-1))
    gold = shifted.gather(-1, y.long()[..., None]).squeeze(-1)
    return (logz - gold).mean(), (maxl, logz)


class _FusedHeadCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, weight, bias, y, vocab_size):
        logits = head_logits(h, weight, bias, vocab_size)
        loss, (maxl, logz) = _stats_loss(logits, y)
        ctx.save_for_backward(h, weight, y, logits, maxl, logz)
        return loss

    @staticmethod
    def backward(ctx, g):
        h, weight, y, logits, maxl, logz = ctx.saved_tensors
        v = logits.shape[-1]
        d = h.shape[-1]
        n = float(logits.numel() // v)
        p = torch.exp(logits.float() - maxl - logz[..., None])
        onehot = torch.zeros_like(p).scatter_(-1, y.long()[..., None], 1.0)
        dl = ((p - onehot) * (g / n)).to(h.dtype).reshape(-1, v)
        h2 = h.reshape(-1, d)
        hb = torch.cat([h2, torch.ones(h2.shape[0], 1, dtype=h.dtype, device=h.device)], dim=1)
        dwb = torch.matmul(dl.t(), hb)                     # (V, d + 1): [dW | db]
        dw = dwb[:, :d].to(weight.dtype)
        db = dwb[:, d].to(weight.dtype)
        dh = torch.matmul(dl, weight.to(h.dtype)).reshape(h.shape)
        return dh, dw, db, None, None


def fused_head_ce(h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  y: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Mean next-token cross entropy of ``softmax(head_logits(h, W, b))``
    against ``y``. ``h``: (..., d) compute-dtype activations; ``weight``
    ``(V_padded, d)`` and ``bias`` ``(V_padded,)`` parameters; ``y``: (...)
    integer targets. Returns a float32 scalar."""
    return _FusedHeadCE.apply(h, weight, bias, y, vocab_size)
