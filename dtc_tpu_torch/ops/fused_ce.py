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

Under Megatron tensor parallelism (``tp``, a
:class:`~dtc_tpu_torch.parallel.tensor.TensorParallel`) the head is
vocab-parallel: a rank holds ``V_padded / model`` columns of the weight and
bias, the pad columns masked on the rank that holds them. In each chunk the
row max is reduced over the model group (max), then the sums of
exponentials and the target's shifted logit (zero on every rank but the
one holding the target's column) are reduced in one float32 sum. The
backward is local: each rank forms its columns' dlogits from the reduced
statistics, their dW and db, and its partial dh, which the caller's
:func:`~dtc_tpu_torch.parallel.tensor.copy_to_model` sums.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

NEG_INF = -1e9

#: Rows of the float32 ``(rows, V)`` temporaries the head + CE holds at once.
CE_CHUNK_ROWS = 4096


def head_logits(h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                vocab_size: int, first: int = 0) -> torch.Tensor:
    """Logits in h's (compute) dtype: ``h @ weight.T`` rounded to the
    compute dtype, then ``+ bias`` in the compute dtype (the reference's
    ``jnp.dot(h, w) + b``) with weight ``(V_padded, d)``, then the pad
    columns ``>= vocab_size`` set to -1e9 (rounded to the compute dtype),
    so no softmax or argmax over the padded vocab can pick them.
    ``first``: the vocab index of the weight's first row (a vocab-parallel
    rank's columns)."""
    cdtype = h.dtype
    logits = F.linear(h, weight.to(cdtype)) + bias.to(cdtype)
    v = weight.shape[0]
    if first + v > vocab_size:
        pad = torch.arange(first, first + v, device=h.device) >= vocab_size
        logits = logits.masked_fill(pad, NEG_INF)
    return logits


def _stats_loss(logits: torch.Tensor, y: torch.Tensor, tp=None, first: int = 0):
    """Mean cross entropy and the softmax statistics, in the reference's
    op order: float32 logits, the row max (no gradient), log-sum-exp of the
    shifted logits, the gold logit. Returns ``(loss, (maxl, logz))``. The
    gold logit is gathered; the reference's iota-match sum adds exact
    zeros to the same value. The rows go :data:`CE_CHUNK_ROWS` at a time.
    Under ``tp`` the logits are this rank's vocab columns from ``first``
    on, and the statistics are reduced over the model group."""
    v = logits.shape[-1]
    rows, ys = logits.reshape(-1, v), y.reshape(-1).long()
    if tp is not None:
        mine = (ys >= first) & (ys < first + v)
        ys = (ys - first).clamp(0, v - 1)
    maxl, logz, gold = [], [], []
    for i in range(0, rows.shape[0], CE_CHUNK_ROWS):
        l32 = rows[i:i + CE_CHUNK_ROWS].float()
        m = l32.amax(dim=-1, keepdim=True).detach()
        if tp is not None:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=tp.group)
        shifted = l32 - m
        maxl.append(m)
        total = torch.exp(shifted).sum(dim=-1)
        g = shifted.gather(-1, ys[i:i + CE_CHUNK_ROWS, None]).squeeze(-1)
        if tp is not None:
            both = torch.stack([total, torch.where(mine[i:i + CE_CHUNK_ROWS], g, 0.0)])
            dist.all_reduce(both, group=tp.group)
            total, g = both[0], both[1]
        logz.append(torch.log(total))
        gold.append(g)
    lead = logits.shape[:-1]
    maxl, logz = torch.cat(maxl).reshape(*lead, 1), torch.cat(logz).reshape(lead)
    return (logz - torch.cat(gold).reshape(lead)).mean(), (maxl, logz)


class _FusedHeadCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, weight, bias, y, vocab_size, tp):
        first = 0 if tp is None else tp.index * weight.shape[0]
        logits = head_logits(h, weight, bias, vocab_size, first)
        loss, (maxl, logz) = _stats_loss(logits, y, tp, first)
        ctx.first = first
        ctx.save_for_backward(h, weight, y, logits, maxl, logz)
        return loss

    @staticmethod
    def backward(ctx, g):
        h, weight, y, logits, maxl, logz = ctx.saved_tensors
        v = logits.shape[-1]
        d = h.shape[-1]
        n = logits.numel() // v
        rows, ys = logits.reshape(n, v), y.reshape(n, 1).long() - ctx.first
        # A target outside this rank's columns adds no one-hot here.
        hot = ((ys >= 0) & (ys < v)).to(torch.float32)
        ys = ys.clamp(0, v - 1)
        maxl, logz = maxl.reshape(n, 1), logz.reshape(n, 1)
        h2 = h.reshape(n, d)
        w = weight.to(h.dtype)
        dwb = torch.zeros(v, d + 1, dtype=torch.float32, device=h.device)  # [dW | db]
        dh = []
        for i in range(0, n, CE_CHUNK_ROWS):
            c = slice(i, i + CE_CHUNK_ROWS)
            p = torch.exp(rows[c].float() - maxl[c] - logz[c])
            onehot = torch.zeros_like(p).scatter_(-1, ys[c], hot[c])
            dl = ((p - onehot) * (g / float(n))).to(h.dtype)
            del p, onehot
            hb = torch.cat([h2[c], torch.ones(dl.shape[0], 1, dtype=h.dtype, device=h.device)],
                           dim=1)
            dwb += torch.matmul(dl.t(), hb)                # (V, d + 1) in h's dtype
            dh.append(torch.matmul(dl, w))
        dw = dwb[:, :d].to(weight.dtype)
        db = dwb[:, d].to(weight.dtype)
        return torch.cat(dh).reshape(h.shape), dw, db, None, None, None


def fused_head_ce(h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  y: torch.Tensor, vocab_size: int, tp=None) -> torch.Tensor:
    """Mean next-token cross entropy of ``softmax(head_logits(h, W, b))``
    against ``y``. ``h``: (..., d) compute-dtype activations; ``weight``
    ``(V_padded, d)`` and ``bias`` ``(V_padded,)`` parameters; ``y``: (...)
    integer targets. Returns a float32 scalar. Under ``tp`` the weight and
    bias are this rank's ``V_padded / model`` columns and the loss is the
    whole vocab's (the same on every rank of the model group); h's
    gradient is this rank's part of it."""
    return _FusedHeadCE.apply(h, weight, bias, y, vocab_size, tp)
