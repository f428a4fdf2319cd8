"""The speculative round: draft-propose, verify a window in one launch,
accept, roll back.

One ROUND emits between 1 and ``spec_k`` tokens of the target model:

1. **Propose** — the draft rung (:mod:`dtc_tpu_torch.spec.draft`) runs
   ``spec_k`` single-token decode steps from the last emitted token,
   yielding ``spec_k - 1`` proposals. (The last step only advances its
   cache, so the draft's frontier lands where the target's verify leaves
   the target's, and rollback is the same on both.)
2. **Verify** — ONE :func:`~dtc_tpu_torch.generate.decode_step` with the
   ``(B, spec_k)`` window ``[t_last, d_1 .. d_{k-1}]`` and
   ``spec_verify=True``: under ``decode_attention: fused_layers`` the
   megakernel takes all ``spec_k`` positions in a single launch.
3. **Accept** — greedy: proposal ``d_{j+1}`` is accepted iff it equals the
   target's argmax at position j and every earlier proposal was accepted;
   the emitted tokens are the TARGET's argmax row, so the output is
   token-identical to plain greedy decode. Sampled (``temperature > 0``):
   Leviathan et al.'s rule — accept ``d`` with probability
   ``min(1, q(d)/p(d))``, resample the first rejection from
   ``normalize(max(q - p, 0))``, take a bonus sample from ``q`` when all
   are accepted — so every emitted token is an exact target sample.
4. **Rollback** — the verify wrote all ``spec_k`` positions; the round
   returns caches whose index is a NEW tensor ``start + n_emit`` (the
   input caches' index is never edited). Positions past a frontier are
   masked from every read and rewritten by the next step over them. The
   K/V buffers are written in place, so a round re-run from the same
   input caches rewrites the same positions with the same values: a
   retried round is bit-exact.

Randomness comes from an explicit ``torch.Generator``; the acceptance rule
itself (:func:`_accept_sampled`) takes its uniforms as arguments.
"""

from __future__ import annotations

import torch

from dtc_tpu_torch.generate import decode_step, init_cache
from dtc_tpu_torch.ops.decode_fused import SPEC_MAX_K


def _reindex(cache: dict, new_index: torch.Tensor) -> dict:
    """The cache with its frontier rebound — the rollback primitive."""
    new = dict(cache)
    new["index"] = new_index
    return new


def check_spec_backend(cfg) -> None:
    """Exactness gate: greedy acceptance is token-identical to plain decode
    only when the single-token path and the verify path share ONE numeric
    implementation — ``fused_layers`` (the megakernel serves both) or
    ``xla`` (the plain path serves both). ``fused`` runs the per-layer
    decode kernel for single tokens but the plain path for the window,
    whose near-tie argmaxes can disagree, so it is refused."""
    if cfg.decode_attention == "fused":
        raise ValueError(
            "speculative decoding requires decode_attention='fused_layers' "
            "or 'xla' (one numeric path for both plain decode and the "
            "k-verify window); 'fused' pairs the per-layer kernel with the "
            "plain verify path and greedy acceptance loses its "
            "token-identity guarantee"
        )


def _propose_greedy(draft, dcache: dict, tok: torch.Tensor, spec_k: int):
    """``spec_k`` draft steps from ``tok`` (B, 1); returns the advanced draft
    cache (frontier + spec_k) and (B, spec_k - 1) proposals."""
    drafts = []
    for _ in range(spec_k):
        dcache, logits = decode_step(draft, dcache, tok)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        drafts.append(tok)
    return dcache, torch.cat(drafts[: spec_k - 1], dim=1)


def _propose_sampled(draft, dcache: dict, tok: torch.Tensor, spec_k: int,
                     temperature: float, generator: torch.Generator):
    """Like :func:`_propose_greedy`, with each proposal drawn from the draft
    distribution at ``temperature``; also returns those distributions
    (B, spec_k - 1, V) for the rejection test."""
    drafts, probs = [], []
    for _ in range(spec_k):
        dcache, logits = decode_step(draft, dcache, tok)
        pr = torch.softmax(logits[:, -1].float() / temperature, dim=-1)
        tok = torch.multinomial(pr, 1, generator=generator).to(torch.int32)
        drafts.append(tok)
        probs.append(pr)
    return (dcache, torch.cat(drafts[: spec_k - 1], dim=1),
            torch.stack(probs[: spec_k - 1], dim=1))


def _accept_sampled(proposals: torch.Tensor, p_probs: torch.Tensor,
                    q_probs: torch.Tensor, u_accept: torch.Tensor,
                    u_resample: torch.Tensor):
    """Leviathan rejection. ``proposals`` (B, k-1) drawn from ``p_probs``
    (B, k-1, V); ``q_probs`` (B, k, V) the target's; ``u_accept`` (B, k-1)
    and ``u_resample`` (B,) uniforms in [0, 1). Returns ``(n_acc,
    t_extra)``: the accepted-proposal count per row and the token that
    follows the accepted prefix (drawn from the residual at the first
    rejection, or from q at the bonus position) by inverting its CDF at
    ``u_resample``."""
    b, km1 = proposals.shape
    rows = torch.arange(b, device=proposals.device)
    idx = proposals.long()[..., None]
    q_d = torch.gather(q_probs[:, :km1], 2, idx)[..., 0]
    p_d = torch.gather(p_probs, 2, idx)[..., 0]
    # u < q/p without the division: p_d == 0 only pairs with a proposal
    # of probability zero, which the product form accepts iff q_d > 0.
    acc = u_accept * p_d < q_d
    n_acc = torch.cumprod(acc.long(), dim=1).sum(dim=1)
    q_row = q_probs[rows, n_acc]
    p_row = torch.where(
        (n_acc < km1)[:, None], p_probs[rows, n_acc.clamp_max(km1 - 1)],
        torch.zeros((), dtype=p_probs.dtype, device=p_probs.device),
    )
    resid = torch.clamp_min(q_row - p_row, 0.0)
    norm = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(norm > 0, resid / norm, q_row)
    cdf = torch.cumsum(resid, dim=-1)
    thr = (1.0 - u_resample)[:, None] * cdf[:, -1:]   # in (0, total]
    t_extra = (cdf < thr).sum(dim=-1).clamp_max(resid.shape[-1] - 1)
    return n_acc, t_extra.to(torch.int32)


@torch.no_grad()
def spec_round(model, draft, spec_k: int, tcache: dict, dcache: dict,
               tok: torch.Tensor, remaining: torch.Tensor, *,
               temperature: float = 0.0,
               generator: torch.Generator | None = None):
    """ONE propose/verify/accept/rollback round over a (B,)-frontier batch.

    ``tok`` (B, 1) is each row's last emitted token; ``remaining`` (B,)
    caps emission (0 freezes a row: its frontier does not move and its
    lanes compute discarded values — the engine's idle slots, generate's
    finished rows). Returns ``(tcache, dcache, tok_next, emit, n_emit,
    fin)``: ``emit`` (B, spec_k) holds each row's emitted tokens in its
    first ``n_emit`` columns; ``fin`` flags rows whose verify logits were
    all finite (the engine's poison localization)."""
    start_t, start_d = tcache["index"], dcache["index"]
    b = tok.shape[0]
    rows = torch.arange(b, device=tok.device)
    greedy = temperature == 0.0
    if greedy:
        dcache, proposals = _propose_greedy(draft, dcache, tok, spec_k)
    else:
        dcache, proposals, p_probs = _propose_sampled(
            draft, dcache, tok, spec_k, temperature, generator
        )
    window = torch.cat([tok, proposals], dim=1)                 # (B, k)
    tcache, logits = decode_step(model, tcache, window, spec_verify=True)
    fin = torch.isfinite(logits.float()).all(dim=2).all(dim=1)
    if greedy:
        target = torch.argmax(logits, dim=-1).to(torch.int32)    # (B, k)
        match = window[:, 1:] == target[:, :-1]
        n_acc = torch.cumprod(match.long(), dim=1).sum(dim=1)
        emit = target  # the accepted prefix IS the target's argmax row
    else:
        q_probs = torch.softmax(logits.float() / temperature, dim=-1)
        u = torch.rand((b, spec_k), generator=generator, device=tok.device)
        n_acc, t_extra = _accept_sampled(proposals, p_probs, q_probs, u[:, 1:], u[:, 0])
        pos = torch.arange(spec_k, device=tok.device)[None]
        prop = torch.nn.functional.pad(proposals, (0, 1))
        emit = torch.where(
            pos < n_acc[:, None], prop,
            torch.where(pos == n_acc[:, None], t_extra[:, None], torch.zeros_like(prop)),
        )
    n_emit = torch.where(
        remaining > 0, torch.minimum(n_acc + 1, remaining.long()).clamp_min(1),
        torch.zeros_like(n_acc),
    ).to(torch.int32)
    last = emit[rows, (n_emit.long() - 1).clamp_min(0)]
    tok_next = torch.where(n_emit > 0, last, tok[:, 0])[:, None]
    return (_reindex(tcache, start_t + n_emit), _reindex(dcache, start_d + n_emit),
            tok_next, emit, n_emit, fin)


@torch.no_grad()
def spec_generate(
    model,
    draft,
    prompt,
    max_new_tokens: int,
    generator: torch.Generator | None = None,
    *,
    spec_k: int,
    temperature: float = 0.0,
    return_stats: bool = False,
):
    """Speculative :func:`~dtc_tpu_torch.generate.generate`: ``(B,
    max_new_tokens)`` int32 continuations of ``prompt`` served by
    draft-propose / window-verify rounds. ``temperature == 0`` is
    token-identical to greedy ``generate``; ``temperature > 0`` is exact in
    distribution through rejection sampling (``generator`` required).

    ``return_stats`` also returns ``{"proposed", "accepted", "rounds"}``
    (``accept_rate = accepted / proposed``)."""
    cfg = model.cfg
    prompt = torch.as_tensor(prompt, dtype=torch.int32, device=model.device)
    b, t_prompt = prompt.shape
    check_spec_backend(cfg)
    if not 2 <= spec_k <= SPEC_MAX_K:
        raise ValueError(f"spec_k must be in [2, {SPEC_MAX_K}], got {spec_k}")
    # The verify window writes spec_k positions from the frontier before
    # rolling back, so the last round (one token left) still needs them.
    if t_prompt + max_new_tokens + spec_k - 1 > cfg.max_seq_len:
        raise ValueError(
            f"prompt ({t_prompt}) + max_new_tokens ({max_new_tokens}) + "
            f"spec_k-1 ({spec_k - 1}) verify headroom exceeds max_seq_len "
            f"({cfg.max_seq_len}) — the KV cache cannot grow past it"
        )
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature sampling needs a torch.Generator")

    tcache, logits = decode_step(model, init_cache(model, b), prompt)
    dcache, _ = decode_step(draft, init_cache(draft, b), prompt)
    if temperature == 0.0:
        first = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    else:
        pr = torch.softmax(logits[:, -1].float() / temperature, dim=-1)
        first = torch.multinomial(pr, 1, generator=generator)[:, 0].to(torch.int32)

    # One frontier per row from here on: rows accept independently.
    vec = torch.full((b,), t_prompt, dtype=torch.int32, device=prompt.device)
    tcache, dcache = _reindex(tcache, vec), _reindex(dcache, vec.clone())
    out = torch.zeros((b, max_new_tokens), dtype=torch.int32, device=prompt.device)
    out[:, 0] = first
    n_done = torch.ones((b,), dtype=torch.int32, device=prompt.device)
    tok = first[:, None]
    cols = torch.arange(spec_k, device=prompt.device)[None]
    rows = torch.arange(b, device=prompt.device)[:, None].expand(b, spec_k)
    proposed = accepted = rounds = 0
    while bool((n_done < max_new_tokens).any()):
        remaining = (max_new_tokens - n_done).clamp_min(0)
        tcache, dcache, tok, emit, n_emit, _ = spec_round(
            model, draft, spec_k, tcache, dcache, tok, remaining,
            temperature=temperature, generator=generator,
        )
        valid = cols < n_emit[:, None]
        dest = n_done[:, None] + cols
        out[rows[valid], dest[valid].long()] = emit[valid]
        n_done = n_done + n_emit
        rounds += 1
        proposed += (spec_k - 1) * b
        accepted += int((n_emit - 1).clamp_min(0).sum())
    if return_stats:
        return out, {"proposed": proposed, "accepted": accepted, "rounds": rounds}
    return out
