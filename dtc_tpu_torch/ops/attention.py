"""Attention ops: the plain masked softmax (causal forward and the
multi-token decode path) and the ``impl`` dispatcher of the training
forward.

One masked-softmax core serves both plain paths: causal attention is
:func:`decode_attention` with a zero offset and full-length keys. Scores
and softmax run in float32 whatever the input dtype; masked columns get
-1e9 (the reference's additive mask value), so a softmax over them is
exactly zero. :func:`causal_attention` picks an implementation by name.
"""

from __future__ import annotations

import torch

NEG_INF = -1e9


def dense_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention over ``(B, T, H, D)`` tensors, output in q's dtype."""
    return decode_attention(q, k, v, 0)


def decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, start
) -> torch.Tensor:
    """Attention for KV-cache decode: ``q`` is ``(B, T_new, H, D)`` for the
    tokens written at position ``start``; ``k``/``v`` are the full cache
    ``(B, S, H, D)``. Query row r (global position start + r) sees cache
    columns ``col <= start + r``.

    ``start`` is a Python int, a 0-d tensor (every row at one position),
    or a ``(B,)`` tensor of per-row write frontiers (the serving slots).
    """
    b, t, h, d = q.shape
    s = k.shape[1]
    scale = d ** -0.5
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    row = torch.arange(t, device=q.device)[:, None]
    col = torch.arange(s, device=q.device)[None, :]
    start = torch.as_tensor(start, device=q.device)
    if start.ndim == 1:
        mask = col[None] <= start[:, None, None] + row[None]   # (B, T, S)
        scores = torch.where(mask[:, None], scores, NEG_INF)
    else:
        mask = col <= start + row                              # (T, S)
        scores = torch.where(mask[None, None], scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    # The weights are cast to v's dtype and the product lands in v's
    # dtype before the cast to q's, as the reference's einsum does.
    out = torch.einsum("bhts,bshd->bthd", weights.to(v.dtype).float(), v.float())
    return out.to(v.dtype).to(q.dtype)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     impl: str = "auto") -> torch.Tensor:
    """Causal self-attention over ``(B, T, H, D)`` tensors. ``flash`` is the
    flash-attention wrapper (the Hopper kernels on a CUDA tensor, their
    plain versions on a CPU tensor); ``dense`` the plain masked softmax;
    ``auto`` takes flash for a CUDA tensor, at any T, and dense otherwise;
    ``ring`` the zigzag ring over the current ring
    (:func:`dtc_tpu_torch.ops.ring_attention.use_ring`; dense without one).
    ``ulysses`` is not ported."""
    if impl == "auto":
        impl = "flash" if q.is_cuda else "dense"
    if impl == "dense":
        return dense_causal_attention(q, k, v)
    if impl == "flash":
        from dtc_tpu_torch.ops.flash_attention import flash_causal_attention

        return flash_causal_attention(q, k, v)
    if impl == "ring":
        from dtc_tpu_torch.ops.ring_attention import ring_causal_attention

        return ring_causal_attention(q, k, v)
    if impl == "ulysses":
        raise NotImplementedError(
            "attention 'ulysses' (all-to-all sequence parallelism) is not ported yet; "
            "it comes with MoE and multi-host (ROADMAP.md §A7)"
        )
    raise ValueError(f"unknown attention impl {impl!r}")
