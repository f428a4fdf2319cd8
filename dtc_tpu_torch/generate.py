"""Autoregressive generation with the packed per-layer KV cache.

One prefill call consumes the whole prompt; each later call appends one
token at O(S) cost. :func:`decode_step` is the single step both decode
callers share — :func:`generate` here and the serving engine's
continuous-batching scheduler — so serving cannot drift numerically from
generation.
"""

from __future__ import annotations

import torch

from dtc_tpu_torch.models.gpt import DTYPES
from dtc_tpu_torch.ops import decode_fused


def init_cache(model, batch_size: int) -> dict:
    """Fresh decode cache for ``batch_size`` sequences on the model's
    device: ``index`` (the write frontier, ``()`` int32 = 0) and the
    packed K/V ``(L, B, S, H·D)`` at the model's KV dtype, plus
    ``(L, B, S, H)`` fp32 scales for an int8 cache."""
    cfg = model.cfg
    dev = model.device
    quant = cfg.kv_quantized
    kv_dt = torch.int8 if quant else DTYPES[cfg.kv_store_dtype]
    shape = (cfg.n_layers, batch_size, cfg.max_seq_len, cfg.n_heads * cfg.head_dim)
    cache = {
        "index": torch.zeros((), dtype=torch.int32, device=dev),
        "k": torch.zeros(shape, dtype=kv_dt, device=dev),
        "v": torch.zeros(shape, dtype=kv_dt, device=dev),
    }
    if quant:
        sshape = shape[:3] + (cfg.n_heads,)
        cache["k_scale"] = torch.zeros(sshape, dtype=torch.float32, device=dev)
        cache["v_scale"] = torch.zeros(sshape, dtype=torch.float32, device=dev)
    return cache


@torch.no_grad()
def decode_step(model, cache: dict, tok: torch.Tensor, spec_verify: bool = False,
                lora: dict | None = None, lora_ids: torch.Tensor | None = None):
    """ONE decode iteration: apply the model to ``tok`` (B, T_new) at the
    cache's frontier. Returns ``(new_cache, logits)`` with logits
    ``(B, T_new, V_padded)``. The K/V buffers of ``cache`` are written in
    place and shared by ``new_cache``; only its ``index`` is new, so
    re-running from ``cache`` repeats the step exactly.

    Under ``decode_attention: fused_layers`` a single-token step, or with
    ``spec_verify=True`` a speculative verify window of up to
    ``SPEC_MAX_K`` tokens, runs the layer stack as one megakernel launch
    (:func:`dtc_tpu_torch.ops.decode_fused.fused_decode_step`); prefill
    keeps the per-layer path.

    ``lora``: an adapter-enabled model's factors (``dtc_tpu_torch.adapters``),
    one adapter shared by the batch, or with ``lora_ids`` (B,) the serving
    engine's stack, row b decoding under slot ``lora_ids[b]``."""
    if decode_fused.use_fused_layers(model.cfg, tok.shape[1], verify=spec_verify):
        return decode_fused.fused_decode_step(model, cache, tok, lora, lora_ids)
    logits, new_index = model(tok, cache=cache, lora=lora, lora_ids=lora_ids)
    new = dict(cache)
    new["index"] = new_index
    return new, logits


def _top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """-inf everywhere below the k-th largest logit per row."""
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, float("-inf"), logits)


def _top_p_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filter: keep the smallest prefix of descending-probability
    tokens whose cumulative mass reaches ``p`` (the token that crosses p
    stays in)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits.float(), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < p
    cutoff = torch.where(keep, sorted_logits, float("inf")).amin(dim=-1, keepdim=True)
    return torch.where(logits < cutoff, float("-inf"), logits)


@torch.no_grad()
def generate(
    model,
    prompt,
    max_new_tokens: int,
    generator: torch.Generator | None = None,
    *,
    temperature: float = 0.0,
    top_k: int | None = None,
    top_p: float | None = None,
    lora: dict | None = None,
) -> torch.Tensor:
    """Sample ``max_new_tokens`` continuations of ``prompt`` (B, T_prompt)
    on the model's device. ``temperature == 0`` is greedy argmax;
    otherwise softmax sampling at that temperature with ``generator`` (a
    ``torch.Generator`` on the model's device), optionally filtered by
    ``top_k`` then ``top_p``. ``lora``: one adapter's factors for the whole
    batch. Returns ``(B, max_new_tokens)`` int32."""
    cfg = model.cfg
    prompt = torch.as_tensor(prompt, dtype=torch.int32, device=model.device)
    b, t_prompt = prompt.shape
    if t_prompt + max_new_tokens > cfg.max_seq_len:
        raise ValueError(
            f"prompt ({t_prompt}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"max_seq_len ({cfg.max_seq_len}) — the KV cache cannot grow past it"
        )
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature sampling needs a torch.Generator")
    if top_k is not None and not 1 <= top_k <= cfg.padded_vocab_size:
        raise ValueError(
            f"top_k must be in [1, {cfg.padded_vocab_size}], got {top_k}"
        )
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")

    def sample(last: torch.Tensor) -> torch.Tensor:
        # Pad columns carry -1e9 from the head mask: never picked.
        if temperature == 0.0:
            return torch.argmax(last, dim=-1).to(torch.int32)
        last = last.float() / temperature
        if top_k is not None:
            last = _top_k_mask(last, top_k)
        if top_p is not None:
            last = _top_p_mask(last, top_p)
        probs = torch.softmax(last, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)

    cache = init_cache(model, b)
    cache, logits = decode_step(model, cache, prompt, lora=lora)
    toks = [sample(logits[:, -1])]
    for _ in range(max_new_tokens - 1):
        cache, logits = decode_step(model, cache, toks[-1][:, None], lora=lora)
        toks.append(sample(logits[:, -1]))
    return torch.stack(toks, dim=1)
