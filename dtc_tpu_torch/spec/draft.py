"""Draft-model extraction: a truncated-layer rung of the target GPT.

Speculative decoding needs a proposer that is much cheaper than the target
and close to it in distribution. The cheapest answer that needs no other
checkpoint is the target's own bottom layers: the draft is a ``GPT`` whose
embedding, head and first ``draft_layers`` blocks ARE the target's module
objects (the same parameters, the same storage; nothing is copied and no
random initialization runs). Its proposals are imperfect — verification
gates every emitted token against the target — so a poor draft costs
acceptance rate, never correctness.
"""

from __future__ import annotations

import dataclasses

import torch.nn as nn

from dtc_tpu_torch.models.gpt import GPT, GPTStage


def draft_config(cfg, draft_layers: int):
    """The draft rung's config: ``cfg`` with ``n_layers`` truncated and
    adapters off (speculation is adapter-free). Widths, vocab,
    ``max_seq_len``, decode backend and KV dtype are inherited, so the
    draft's cache rides the same kernels and pool arithmetic."""
    if not 1 <= draft_layers < cfg.n_layers:
        raise ValueError(
            f"draft_layers must be in [1, {cfg.n_layers - 1}] "
            f"(a strict truncation of the {cfg.n_layers}-layer target), "
            f"got {draft_layers}"
        )
    return dataclasses.replace(
        cfg, n_layers=draft_layers,
        adapter=dataclasses.replace(cfg.adapter, rank=0),
    )


def extract_draft(model, draft_layers: int) -> GPT:
    """A draft ``GPT`` sharing ``model``'s embed, head and first
    ``draft_layers`` blocks (zero-copy). Every decode path — ``init_cache``,
    ``decode_step``, the megakernel, the engine's slot caches — serves it
    unchanged. Mixture-of-experts targets are refused."""
    cfg = model.cfg
    if cfg.moe_experts > 0:
        raise ValueError(
            "speculative draft extraction does not support MoE targets "
            "(expert-stacked params have no bottom-layers truncation)"
        )
    dcfg = draft_config(cfg, draft_layers)
    # Built without GPT.__init__, whose parameter draw the draft must not pay.
    draft = GPT.__new__(GPT)
    nn.Module.__init__(draft)
    draft.cfg = dcfg
    draft.tp = draft.layout = None
    draft.embed = model.embed
    stage = GPTStage.__new__(GPTStage)
    nn.Module.__init__(stage)
    stage.blocks = nn.ModuleList(list(model.stage.blocks)[:draft_layers])
    draft.stage = stage
    draft.head = model.head
    return draft
