"""LM-head logits with the padded-vocab mask, and the fused head +
cross-entropy of the training path.

:func:`fused_head_ce` is the loss the model returns when it is given
targets. Its backward recomputes ``dlogits = (softmax - onehot)·g/N`` in
float32 from the saved logits and softmax statistics, casts it to the
activations' dtype, and forms dW and db as one product ``[h; 1]ᵀ·dlogits``
(the bias gradient rides along as the last column), plus
``dh = dlogits·W`` — the JAX package's ``ops/fused_ce.py`` backward. The
products are plain ``torch.matmul``; the JAX package leaves them to XLA.

XLA fuses the float32 ``(B·T, V)`` chain into the products, so dlogits
never reaches device memory there; eager PyTorch would hold several such
tensors at once (3.3 GB each at 16,384 tokens of the 50,304-wide vocab).
So the softmax statistics and the backward work on :data:`CE_CHUNK_ROWS`
rows at a time: the statistics and dh are exact per row, and dW / db sum
the chunks' products in float32 (one chunk, as at the flagship, gives the
unchunked bits).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e9

#: Rows of the float32 ``(rows, V)`` temporaries the head + CE holds at once.
CE_CHUNK_ROWS = 4096


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
    zeros to the same value. The rows go :data:`CE_CHUNK_ROWS` at a time."""
    v = logits.shape[-1]
    rows, ys = logits.reshape(-1, v), y.reshape(-1).long()
    maxl, logz, gold = [], [], []
    for i in range(0, rows.shape[0], CE_CHUNK_ROWS):
        l32 = rows[i:i + CE_CHUNK_ROWS].float()
        m = l32.amax(dim=-1, keepdim=True).detach()
        shifted = l32 - m
        maxl.append(m)
        logz.append(torch.log(torch.exp(shifted).sum(dim=-1)))
        gold.append(shifted.gather(-1, ys[i:i + CE_CHUNK_ROWS, None]).squeeze(-1))
    lead = logits.shape[:-1]
    maxl, logz = torch.cat(maxl).reshape(*lead, 1), torch.cat(logz).reshape(lead)
    return (logz - torch.cat(gold).reshape(lead)).mean(), (maxl, logz)


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
        n = logits.numel() // v
        rows, ys = logits.reshape(n, v), y.reshape(n, 1).long()
        maxl, logz = maxl.reshape(n, 1), logz.reshape(n, 1)
        h2 = h.reshape(n, d)
        w = weight.to(h.dtype)
        dwb = torch.zeros(v, d + 1, dtype=torch.float32, device=h.device)  # [dW | db]
        dh = []
        for i in range(0, n, CE_CHUNK_ROWS):
            c = slice(i, i + CE_CHUNK_ROWS)
            p = torch.exp(rows[c].float() - maxl[c] - logz[c])
            onehot = torch.zeros_like(p).scatter_(-1, ys[c], 1.0)
            dl = ((p - onehot) * (g / float(n))).to(h.dtype)
            del p, onehot
            hb = torch.cat([h2[c], torch.ones(dl.shape[0], 1, dtype=h.dtype, device=h.device)],
                           dim=1)
            dwb += torch.matmul(dl.t(), hb)                # (V, d + 1) in h's dtype
            dh.append(torch.matmul(dl, w))
        dw = dwb[:, :d].to(weight.dtype)
        db = dwb[:, d].to(weight.dtype)
        return torch.cat(dh).reshape(h.shape), dw, db, None, None


def fused_head_ce(h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  y: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Mean next-token cross entropy of ``softmax(head_logits(h, W, b))``
    against ``y``. ``h``: (..., d) compute-dtype activations; ``weight``
    ``(V_padded, d)`` and ``bias`` ``(V_padded,)`` parameters; ``y``: (...)
    integer targets. Returns a float32 scalar."""
    return _FusedHeadCE.apply(h, weight, bias, y, vocab_size)
