"""GPT model in PyTorch: decoder-only pre-LN GPT-2-style transformer with
learned absolute positions, separate q/k/v projections and a GELU MLP.

Module tree mirrors the JAX package's ``{embed, stage, head}`` split:
``GPT.embed`` (:class:`GPTEmbed`), ``GPT.stage.blocks[i]``
(:class:`Block`), ``GPT.head`` (:class:`GPTHead`);
``dtc_tpu_torch.parity.from_flax`` maps a flax parameter tree onto it.

Numerics copy the reference, not PyTorch's defaults: LayerNorm in fp32
with eps 1e-6 and variance ``E[x²] - E[x]²``, cast to the compute dtype
after; GELU is the tanh approximation; Dense layers run in the compute
dtype with parameters cast from the parameter dtype, the product rounded
before the bias is added; the residual stream
stays in the compute dtype; the embedding sum is cast after the add; head
logits are in the compute dtype with pad columns at -1e9.

Training: ``GPT.forward(x, train=True, targets=y, generator=g)`` returns
the mean next-token loss through the fused head + cross-entropy. Attention
goes through ``causal_attention(impl=cfg.attention)`` (the Hopper flash
kernels on the card under ``auto``). Under ``attention: ring`` with a ring
of processes, ``x`` is this rank's sequence shard and its positions start
at the shard's offset (``ring_attention.position_offset``); the loss is the
mean over the shard's tokens. Dropout draws its keep masks from the
caller's ``torch.Generator`` (flax's semantics: keep with probability
1 - p, scale kept values by 1 / (1 - p)); nothing else in the model draws.

Rematerialisation (``cfg.remat``, the JAX package's three modes) drops a
block's activations after the forward and recomputes them in the backward
with ``torch.utils.checkpoint`` (:func:`_recompute`): ``block`` (or
``true``) the whole block, flash forward included; ``block_save_flash``
the block around the attention call, whose residuals q, k, v, out and lse
stay saved, so the backward re-runs LN, out_proj, the MLP and the
residual ops but neither the flash forward nor the q/k/v projections;
``mlp`` the MLP's ``d_ff``-wide intermediates only. The recompute replays
the forward's dropout masks and leaves the generator where the forward
left it: a remat mode gives the same bits as ``none``.

Tensor parallelism (``tp``, a
:class:`~dtc_tpu_torch.parallel.tensor.TensorParallel` over the mesh's
model group): a rank holds its slice of every column-parallel site (q, k,
v and fc1: ``n_heads / model`` heads, ``d_ff / model`` hidden units),
row-parallel site (out_proj and fc2: the same slice of their contraction,
the whole bias) and of the vocab-parallel head, and the rest whole. The
attention and MLP take their input through ``copy_to_model``, a
row-parallel product is reduced over the group before its bias, and the
flash kernels run on the rank's heads. Pipeline parallelism (``stage``, a
:class:`~dtc_tpu_torch.parallel.pipeline.StageLayout`): the model holds the
layers of its stage's chunks (chunk ``c = v·S + s`` on stage ``s``), the
embedding only on the first stage and the head only on the last, and the
pipeline step drives :meth:`GPT.embed`, :meth:`GPT.run_chunk` and
:meth:`GPT.head` itself. Either way the parameters are the one-process
model's, drawn whole from the seed and sliced.

FSDP (``parallel: fsdp``, :mod:`dtc_tpu_torch.parallel.fsdp`): under an
FSDP state a rank's parameters may be shards; every module reads a
parameter through ``fsdp.full`` where it uses it, and the dense sites
under ``collectives: overlapped`` compute on their shard over the ring
(:class:`Dense`). Without a state both are the plain reads.

LoRA adapters (``cfg.adapter.rank > 0``): the factors are not module
parameters; the caller passes them per call as ``lora`` (see
``dtc_tpu_torch.adapters``): one adapter's factors shared by every row,
or with ``lora_ids`` a stack of adapters of which row b reads slot
``lora_ids[b]`` (:func:`gather_slot_lora`, :func:`layer_lora`). Every
targeted :class:`Dense` adds :func:`apply_lora`'s delta; without ``lora``
the model is the base model, and at rank 0 nothing of it runs. In
training (the finetune) the factors are the tensors that require
gradients, the base frozen by the caller; ``adapter.dropout`` drops the
adapter's input only (the base path never sees it), its masks from the
same generator as the model's dropout, drawn in site order (q, k, v,
out_proj, fc1, fc2 of each layer), and replayed by remat's recompute.

Decode: :meth:`GPT.forward` with a ``cache`` dict (see
``dtc_tpu_torch.generate.init_cache``) writes each layer's new k/v into
the packed ``(L, B, S, H·D)`` cache at the write frontier
``cache["index"]`` (``()`` or ``(B,)``) and attends over it. The K/V
buffers are written in place (a functional update would copy the whole
cache every token); the frontier is returned as a new tensor, so a caller
holding the old cache dict can re-run the same step bit-exactly.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dtc_tpu_torch.config.schema import ModelConfig
from dtc_tpu_torch.ops import decode_attention as fused
from dtc_tpu_torch.ops import ring_attention
from dtc_tpu_torch.ops.attention import causal_attention, decode_attention
from dtc_tpu_torch.ops.fused_ce import fused_head_ce, head_logits
from dtc_tpu_torch.ops.overlap_collectives import overlap_dense_matmul
from dtc_tpu_torch.parallel import fsdp
from dtc_tpu_torch.parallel.tensor import copy_to_model, reduce_from_model

DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16,
    "float16": torch.float16, "int8": torch.int8,
}

LN_EPS = 1e-6


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when CUDA is asked for (explicitly or by default) and
    there is no card — the port never drifts to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def _dropout(x: torch.Tensor, p: float, gen: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout`` in training: keep each element with probability
    ``1 - p`` (a uniform draw from ``gen`` below it) and divide the kept
    ones by ``1 - p`` in x's dtype."""
    if p <= 0.0:
        return x
    if gen is None:
        raise ValueError("dropout in training needs the caller's torch.Generator")
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def _recompute(fn, *args, gen: torch.Generator | None = None):
    """``fn(*args, gen)`` under ``torch.utils.checkpoint`` (non-reentrant):
    the tensors it saves for the backward are dropped after the forward and
    recomputed when the backward needs them. ``preserve_rng_state`` covers
    only the global generators, not the caller's ``gen`` that dropout draws
    from; so the forward draws from ``gen`` itself and the recompute from a
    new generator set to the state ``gen`` had before the forward. The
    recompute thus draws the forward's keep masks again, and ``gen`` ends
    the step where it would without remat."""
    state = None if gen is None else gen.get_state()
    calls = 0

    def run(*xs):
        nonlocal calls
        g = gen
        if calls and gen is not None:  # the backward's recompute
            g = torch.Generator(device=gen.device)
            g.set_state(state)
        calls += 1
        return fn(*xs, g)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's ``lecun_normal``: truncated normal at ±2σ, σ rescaled so the
    truncated distribution has variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: fp32 statistics with the
    fast variance ``max(E[x²] - E[x]², 0)``, eps 1e-6, fp32 output."""

    def __init__(self, d: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp_min((x * x).mean(dim=-1, keepdim=True) - mean * mean, 0.0)
        mul = torch.rsqrt(var + LN_EPS) * fsdp.full(self.weight)
        return (x - mean) * mul + fsdp.full(self.bias)


def lora_scale(cfg: ModelConfig) -> float:
    """``alpha / rank`` rounded to the compute dtype, as the JAX package's
    weakly typed Python scale is before it multiplies a compute-dtype
    delta (PyTorch would multiply by the unrounded value)."""
    return float(torch.tensor(cfg.adapter.scale, dtype=DTYPES[cfg.compute_dtype]))


def apply_lora(y: torch.Tensor, x: torch.Tensor, factors, scale: float,
               dropout: float = 0.0, gen: torch.Generator | None = None) -> torch.Tensor:
    """``y + scale * ((x @ A) @ B)`` with the JAX package's rounding points
    (``dtc_tpu/adapters/lora.py`` ``apply_lora``): factors cast to y's
    (compute) dtype; ``z = x A`` rounded; the delta ``z B`` rounded; the
    scaled delta rounded (``scale`` already in the compute dtype, see
    :func:`lora_scale`); then added to ``y``. ``factors`` is ``(A, B)`` in
    ``nn.Linear``'s orientation: A ``(r, in)``, B ``(out, r)`` shared by
    every row, or A ``(B, r, in)``, B ``(B, out, r)`` one pair per batch
    row of x ``(B, T, in)``. ``dropout`` (training) drops x on the
    adapter's path only, its keep mask drawn from ``gen``."""
    cd = y.dtype
    a, b = factors[0].to(cd), factors[1].to(cd)
    xc = _dropout(x, dropout, gen).to(cd)
    if a.ndim == 2:
        delta = F.linear(F.linear(xc, a), b)
    else:
        z = torch.einsum("bti,bri->btr", xc, a)
        delta = torch.einsum("btr,bor->bto", z, b)
    return y + delta * scale


def gather_slot_lora(stack: dict | None, lora_ids: torch.Tensor | None) -> dict | None:
    """Each row's factors copied out of a stack, ``(B, L, ...)`` leaves for
    slot ids ``lora_ids`` (B,), once per call (the megakernel reads the
    stack by the ids instead). Without ids ``stack`` is one adapter's
    factors and passes unchanged."""
    if stack is None or lora_ids is None:
        return stack
    ids = lora_ids.long()
    return {k: v[ids] for k, v in stack.items()}


def layer_lora(lora: dict | None, layer: int, per_row: bool) -> dict:
    """The factors of one layer, ``{site: (A, B)}``: from one adapter's
    ``(L, ...)`` leaves, or ``per_row`` from :func:`gather_slot_lora`'s
    ``(B, L, ...)`` leaves."""
    if lora is None:
        return {}
    at = (slice(None), layer) if per_row else layer
    return {key[:-2]: (leaf[at], lora[key[:-2] + "_b"][at])
            for key, leaf in lora.items() if key.endswith("_a")}


class Dense(nn.Module):
    """``nn.Dense(dtype=compute, param_dtype=param)``: weight ``(out, in)``
    and bias in the parameter dtype, both cast to the compute dtype. As in
    flax, the product is rounded to the compute dtype before the bias is
    added in the compute dtype (two roundings, not ``F.linear``'s one).
    With ``lora`` factors ``(A, B)`` it adds :func:`apply_lora`'s delta.

    ``shard_axis``: the axis of the flax kernel ``(in, out)`` that FSDP
    shards, 0 (the input: q/k/v/fc1) or 1 (the output: out_proj/fc2). Under
    ``collectives: overlapped`` with an FSDP ring in scope
    (:func:`~dtc_tpu_torch.parallel.fsdp.overlap_ring`) the product runs
    through :func:`overlap_dense_matmul` on this rank's shard of the
    weight; otherwise the weight is used whole (all-gathered under FSDP).

    ``tp``: under tensor parallelism the site holds its slice over the
    model group. The sites of ``shard_axis`` 0 are column-parallel (a
    slice of the outputs and of the bias), those of 1 row-parallel (a
    slice of the contraction; the partial product is reduced over the
    group before the whole bias is added). Under both (DP×FSDP×TP) the
    FSDP shard is one of the slice, the ring runs over the data group on
    the slice's widths, and the Megatron reductions stay here, outside
    the ring."""

    def __init__(self, d_in: int, d_out: int, cfg: ModelConfig, device=None,
                 shard_axis: int = 0, tp=None):
        super().__init__()
        pdt = DTYPES[cfg.param_dtype]
        self.cdtype = DTYPES[cfg.compute_dtype]
        self.lora_scale = lora_scale(cfg)
        self.shard_axis = shard_axis
        self.overlapped = cfg.collectives == "overlapped"
        self.tp = tp
        if tp is not None and shard_axis == 0:
            d_out = tp.part(d_out, "a column-parallel site's outputs")
        elif tp is not None:
            d_in = tp.part(d_in, "a row-parallel site's inputs")
        self.weight = nn.Parameter(torch.empty(d_out, d_in, dtype=pdt, device=device))
        self.bias = nn.Parameter(torch.zeros(d_out, dtype=pdt, device=device))

    def forward(self, x: torch.Tensor, lora=None, dropout: float = 0.0,
                gen: torch.Generator | None = None) -> torch.Tensor:
        """``dropout`` / ``gen``: the adapter's input dropout (training)."""
        cd = self.cdtype
        ring = fsdp.overlap_ring() if self.overlapped else None
        if ring is None:
            y = F.linear(x.to(cd), fsdp.full(self.weight).to(cd))
        else:
            y = overlap_dense_matmul(x.to(cd), self.weight.to(cd).t(),
                                     shard_axis=self.shard_axis, ring=ring)
        if self.shard_axis == 1:
            y = reduce_from_model(y, self.tp)
        y = y + fsdp.full(self.bias).to(cd)
        return y if lora is None else apply_lora(y, x, lora, self.lora_scale, dropout, gen)


def _cache_write(buf: torch.Tensor, update: torch.Tensor, idx: torch.Tensor) -> None:
    """Write ``update`` (B, t, X) into ``buf`` (B, S, X) at the frontier, in
    place. The start clamps to ``[0, S - t]`` as the reference's
    ``dynamic_update_slice`` does, so an idle serving slot whose frontier
    ran past the cache writes harmless garbage at the end of its own row
    instead of faulting."""
    b, s = buf.shape[0], buf.shape[1]
    t = update.shape[1]
    ar = torch.arange(t, device=buf.device)
    start = idx.clamp(0, s - t)
    if idx.ndim == 1:
        pos = start[:, None].long() + ar[None]
        buf[torch.arange(b, device=buf.device)[:, None], pos] = update
    else:
        buf.index_copy_(1, start.long() + ar, update)


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, tp=None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        self.n_heads = cfg.n_heads if tp is None else tp.part(cfg.n_heads, "n_heads")
        d = cfg.d_model
        self.q_proj = Dense(d, d, cfg, device, tp=tp)
        self.k_proj = Dense(d, d, cfg, device, tp=tp)
        self.v_proj = Dense(d, d, cfg, device, tp=tp)
        self.out_proj = Dense(d, d, cfg, device, shard_axis=1, tp=tp)

    def forward(self, x: torch.Tensor, cache: dict | None = None,
                layer: int = 0, idx: torch.Tensor | None = None,
                lora: dict | None = None, lora_drop: float = 0.0,
                gen: torch.Generator | None = None) -> torch.Tensor:
        """The q/k/v projections and attention: out_proj's (B, T, d_model)
        input. The block applies ``out_proj`` itself, so that remat can
        split the block around the flash call. ``lora_drop``: the
        adapter's input dropout (training), masks from ``gen``."""
        cfg = self.cfg
        lora = lora or {}
        b, t, _ = x.shape
        h, dh = self.n_heads, cfg.head_dim
        hd = h * dh
        x = copy_to_model(x, self.tp)
        q = self.q_proj(x, lora.get("q_proj"), lora_drop, gen)
        k = self.k_proj(x, lora.get("k_proj"), lora_drop, gen)
        v = self.v_proj(x, lora.get("v_proj"), lora_drop, gen)
        if cache is None:
            out = causal_attention(
                q.view(b, t, h, dh), k.view(b, t, h, dh), v.view(b, t, h, dh),
                impl=cfg.attention,
            )
        else:
            ck, cv = cache["k"][layer], cache["v"][layer]
            quant = cfg.kv_quantized
            if quant:
                cks, cvs = cache["k_scale"][layer], cache["v_scale"][layer]
                kq, ksc = fused.quantize_kv(k, h)
                vq, vsc = fused.quantize_kv(v, h)
                _cache_write(ck, kq, idx)
                _cache_write(cv, vq, idx)
                _cache_write(cks, ksc, idx)
                _cache_write(cvs, vsc, idx)
            else:
                _cache_write(ck, k.to(ck.dtype), idx)
                _cache_write(cv, v.to(cv.dtype), idx)
            s = ck.shape[1]
            if cfg.decode_attention in ("fused", "fused_layers") and t == 1:
                out = fused.fused_decode_attention(
                    q.reshape(b, 1, hd), ck, cv, idx, h=h, d=dh,
                    k_scale=cks if quant else None,
                    v_scale=cvs if quant else None,
                )
            else:
                cdt = DTYPES[cfg.compute_dtype]
                if quant:
                    k_full = fused.dequantize_kv(ck, cks, h, cdt)
                    v_full = fused.dequantize_kv(cv, cvs, h, cdt)
                else:
                    k_full, v_full = ck, cv
                out = decode_attention(
                    q.view(b, t, h, dh), k_full.view(b, s, h, dh),
                    v_full.view(b, s, h, dh), idx,
                )
        return out.reshape(b, t, hd)


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, tp=None):
        super().__init__()
        self.tp = tp
        self.fc1 = Dense(cfg.d_model, cfg.d_ff, cfg, device, tp=tp)
        self.fc2 = Dense(cfg.d_ff, cfg.d_model, cfg, device, shard_axis=1, tp=tp)

    def forward(self, x: torch.Tensor, lora: dict | None = None, lora_drop: float = 0.0,
                gen: torch.Generator | None = None) -> torch.Tensor:
        lora = lora or {}
        x = copy_to_model(x, self.tp)
        h = F.gelu(self.fc1(x, lora.get("fc1"), lora_drop, gen), approximate="tanh")
        return self.fc2(h, lora.get("fc2"), lora_drop, gen)


class Block(nn.Module):
    """x + Attn(LN(x)); x + MLP(LN(x)), the residual in the compute dtype.
    In training with gradients, ``cfg.remat_mode`` picks what is recomputed
    in the backward (see the module docstring)."""

    def __init__(self, cfg: ModelConfig, device=None, tp=None):
        super().__init__()
        self.cfg = cfg
        self.cdtype = DTYPES[cfg.compute_dtype]
        self.ln_1 = LayerNorm(cfg.d_model, device)
        self.attn = CausalSelfAttention(cfg, device, tp)
        self.ln_2 = LayerNorm(cfg.d_model, device)
        self.mlp = MLP(cfg, device, tp)

    def forward(self, x, *, train: bool = False, gen=None, cache=None, layer: int = 0,
                idx=None, lora: dict | None = None):
        p = self.cfg.dropout if train else 0.0
        ld = self.cfg.adapter.dropout if train and lora else 0.0
        mode = self.cfg.remat_mode
        if not (train and cache is None and torch.is_grad_enabled()):
            mode = "none"
        if mode == "block":
            return _recompute(
                lambda x, g: self._rest(x, self._attend(x, lora, ld=ld, gen=g), p, g, lora, ld),
                x, gen=gen)
        if mode == "block_save_flash":
            # LN_1 recomputed; the projections and the flash call outside
            # any checkpoint, so their residuals (h, q, k, v, out, lse) stay.
            h = _recompute(lambda x, _: self.ln_1(x).to(self.cdtype), x)
            a = self.attn(h, lora=lora, lora_drop=ld, gen=gen)
            return _recompute(lambda x, a, g: self._rest(x, a, p, g, lora, ld), x, a, gen=gen)
        a = self._attend(x, lora, cache, layer, idx, ld, gen)
        return self._rest(x, a, p, gen, lora, ld, remat_mlp=mode == "mlp")

    def _attend(self, x, lora, cache=None, layer: int = 0, idx=None, ld: float = 0.0,
                gen=None):
        return self.attn(self.ln_1(x).to(self.cdtype), cache, layer, idx, lora, ld, gen)

    def _rest(self, x, a, p: float, gen, lora, ld: float = 0.0, remat_mlp: bool = False):
        """From attention's output ``a`` on: out_proj, dropout, residual;
        LN_2, the MLP (recomputed in the backward with ``remat_mlp``),
        dropout, residual. ``ld``: the adapter's input dropout."""
        lora = lora or {}
        x = x + _dropout(self.attn.out_proj(a, lora.get("out_proj"), ld, gen), p, gen)
        h = self.ln_2(x).to(self.cdtype)
        m = (_recompute(lambda h, g: self.mlp(h, lora, ld, g), h, gen=gen if ld else None)
             if remat_mlp
             else self.mlp(h, lora, ld, gen))
        return x + _dropout(m, p, gen)


class GPTEmbed(nn.Module):
    """Token + learned-position embedding (flax ``nn.Embed`` init: normal
    with std 1/sqrt(d_model))."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        pdt = DTYPES[cfg.param_dtype]
        self.wte = nn.Embedding(cfg.padded_vocab_size, cfg.d_model, dtype=pdt, device=device)
        self.wpe = nn.Embedding(cfg.max_seq_len, cfg.d_model, dtype=pdt, device=device)

    def forward(self, x: torch.Tensor, *, train: bool = False, gen=None,
                pos_offset: int | torch.Tensor = 0) -> torch.Tensor:
        cfg = self.cfg
        t = x.shape[1]
        s = cfg.max_seq_len
        tok = F.embedding(x, fsdp.full(self.wte.weight))
        wpe = fsdp.full(self.wpe.weight)
        ar = torch.arange(t, device=x.device)
        if isinstance(pos_offset, int):
            # A sequence shard from position pos_offset (ring attention).
            pos = wpe[pos_offset:pos_offset + t][None]
        elif pos_offset.ndim == 1:
            # Per-slot positions. Rows past the table (an idle slot whose
            # frontier ran on) clamp to the last row; their outputs are
            # discarded by the caller.
            rows = (pos_offset[:, None].long() + ar[None]).clamp(0, s - 1)
            pos = wpe[rows]
        else:
            start = pos_offset.clamp(0, s - t).long()
            pos = wpe[start + ar][None]
        h = (tok + pos).to(DTYPES[cfg.compute_dtype])
        return _dropout(h, cfg.dropout if train else 0.0, gen)


class GPTStage(nn.Module):
    def __init__(self, cfg: ModelConfig, n_layers: int, device=None, tp=None):
        super().__init__()
        self.blocks = nn.ModuleList(Block(cfg, device, tp) for _ in range(n_layers))

    def forward(self, h, *, train: bool = False, gen=None, cache=None, idx=None,
                lora: dict | None = None, lora_ids: torch.Tensor | None = None):
        rows = gather_slot_lora(lora, lora_ids)
        for i, blk in enumerate(self.blocks):
            h = blk(h, train=train, gen=gen, cache=cache, layer=i, idx=idx,
                    lora=layer_lora(rows, i, lora_ids is not None))
        return h


class GPTHead(nn.Module):
    """Final LayerNorm + LM head; weight ``(V_padded, d)`` (under ``tp``
    this rank's ``V_padded / model`` rows: vocab-parallel). With targets it
    returns the mean cross entropy through :func:`fused_head_ce`."""

    def __init__(self, cfg: ModelConfig, device=None, tp=None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        pdt = DTYPES[cfg.param_dtype]
        v = cfg.padded_vocab_size
        if tp is not None:
            v = tp.part(v, "the padded vocab")
        self.ln_f = LayerNorm(cfg.d_model, device)
        self.lm_head = nn.Module()
        self.lm_head.weight = nn.Parameter(
            torch.empty(v, cfg.d_model, dtype=pdt, device=device)
        )
        self.lm_head.bias = nn.Parameter(torch.zeros(v, dtype=pdt, device=device))

    def forward(self, h: torch.Tensor, targets: torch.Tensor | None = None) -> torch.Tensor:
        hc = self.ln_f(h).to(DTYPES[self.cfg.compute_dtype])
        w, b = fsdp.full(self.lm_head.weight), fsdp.full(self.lm_head.bias)
        v = self.cfg.vocab_size
        if targets is not None:
            return fused_head_ce(copy_to_model(hc, self.tp), w, b, targets, v, self.tp)
        if self.tp is not None:
            raise NotImplementedError(
                "logits under tensor parallelism (the vocab-parallel head serves the "
                "training loss only)")
        return head_logits(hc, w, b, v)


class GPT(nn.Module):
    """Full decoder-only GPT on ``device`` (``cuda`` unless named), its
    parameters drawn from flax's initializer distributions with a
    generator seeded by ``seed``. With ``adapter.rank > 0`` it serves and
    trains LoRA factors passed per call (the adapter parameters are not
    part of the module). Mixture-of-experts is not ported yet and raises
    ``NotImplementedError``. ``tp`` / ``stage``: this rank's slice under
    tensor parallelism and its stage under pipeline parallelism (see the
    module docstring); the parameters are the whole model's for ``seed``,
    sliced."""

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0, tp=None,
                 stage=None):
        super().__init__()
        if cfg.moe_experts > 0:
            raise NotImplementedError("mixture-of-experts is not ported yet")
        dev = resolve_device(device)
        self.cfg = cfg
        self.tp = tp
        self.layout = stage
        n_local = cfg.n_layers if stage is None else len(stage.layers(cfg.n_layers))
        self.embed = GPTEmbed(cfg, dev) if stage is None or stage.first else None
        self.stage = GPTStage(cfg, n_local, dev, tp)
        self.head = GPTHead(cfg, dev, tp) if stage is None or stage.last else None
        self.reset_parameters(seed)

    @property
    def device(self) -> torch.device:
        return self.stage.blocks[0].ln_1.weight.device

    @property
    def sharded(self) -> bool:
        """Does this model hold a slice of the whole (a tensor-parallel
        rank's, or a pipeline stage's)?"""
        return self.tp is not None or self.layout is not None

    def local_state(self, state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """This model's part of a whole model's ``state_dict``: its stage's
        layers (renumbered), the embedding and head where it holds them,
        each tensor-parallel parameter's slice."""
        from dtc_tpu_torch import parity

        if self.layout is not None:
            lay = self.layout
            state = parity.pp_stage(state, lay.stage, lay.stages, lay.virtual)
        if self.tp is not None:
            state = parity.tp_shards(state, self.tp.index, self.tp.size)
        return state

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """flax's initializers: Dense kernels ``lecun_normal``, biases and
        LayerNorm biases zero, LayerNorm scales one, embeddings normal
        with std 1/sqrt(d_model). A sharded model draws the whole model on
        its device and keeps its slice, so it starts from the one-process
        model's weights bit for bit."""
        if self.sharded:
            whole = GPT(self.cfg, device=self.device, seed=seed)
            self.load_state_dict(self.local_state(whole.state_dict()))
            return
        gen = torch.Generator(device=self.device).manual_seed(seed)
        std = 1.0 / math.sqrt(self.cfg.d_model)
        for emb in (self.embed.wte, self.embed.wpe):
            emb.weight.normal_(0.0, std, generator=gen)
        for mod in self.modules():
            if isinstance(mod, Dense):
                _lecun_normal_(mod.weight, mod.weight.shape[1], gen)
                mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        _lecun_normal_(self.head.lm_head.weight, self.cfg.d_model, gen)
        self.head.lm_head.bias.zero_()

    def forward(self, x: torch.Tensor, *, train: bool = False,
                cache: dict | None = None, targets: torch.Tensor | None = None,
                generator: torch.Generator | None = None,
                lora: dict | None = None, lora_ids: torch.Tensor | None = None):
        """Logits ``(B, T, V_padded)`` for tokens ``x`` (B, T), or with
        ``targets`` (B, T) the mean next-token cross entropy (float32
        scalar). ``train=True`` applies dropout with keep masks drawn from
        ``generator``. With ``cache`` (decode), returns ``(logits,
        new_index)``: the tokens are appended at the cache's write
        frontier, whose advanced value is ``new_index``. The caller keeps
        the cumulative length within ``max_seq_len``. ``lora`` /
        ``lora_ids``: adapter factors (see :func:`gather_slot_lora`); in
        training one adapter's, which require gradients (the finetune)."""
        if self.layout is not None:
            raise ValueError("a pipeline stage runs through the pipeline step "
                             "(dtc_tpu_torch.parallel.pipeline), not GPT.forward")
        if self.tp is not None and (cache is not None or lora is not None):
            raise NotImplementedError("decode and LoRA under tensor parallelism")
        if cache is None:
            # Under ring attention a rank holds one sequence shard.
            ring = self.cfg.attention == "ring"
            start = ring_attention.position_offset(x.shape[1]) if ring else 0
            h = self.embed(x, train=train, gen=generator, pos_offset=start)
            h = self.stage(h, train=train, gen=generator, lora=lora, lora_ids=lora_ids)
            return self.head(h, targets)
        idx = cache["index"]
        h = self.embed(x, train=False, pos_offset=idx)
        h = self.stage(h, cache=cache, idx=idx, lora=lora, lora_ids=lora_ids)
        return self.head(h), idx + x.shape[1]

    def run_chunk(self, v: int, h: torch.Tensor, *, train: bool = False,
                  gen: torch.Generator | None = None) -> torch.Tensor:
        """The layers of this stage's ``v``-th chunk (all of them without a
        pipeline layout) on the residual stream ``h``."""
        blocks = self.stage.blocks
        if self.layout is not None:
            per = len(blocks) // self.layout.virtual
            blocks = blocks[v * per:(v + 1) * per]
        for blk in blocks:
            h = blk(h, train=train, gen=gen)
        return h


def param_count(cfg: ModelConfig) -> int:
    """Exact base parameter count from the config."""
    d, v, L, f, s = cfg.d_model, cfg.padded_vocab_size, cfg.n_layers, cfg.d_ff, cfg.max_seq_len
    embed = v * d + s * d
    if cfg.moe_experts > 0:
        e = cfg.moe_experts
        ffn = d * e + e * (d * f + f + f * d + d)
    else:
        ffn = (d * f + f) + (f * d + d)
    per_block = 4 * (d * d + d) + ffn + 4 * d
    head = 2 * d + (d * v + v)
    return embed + L * per_block + head


def adapter_param_count(cfg: ModelConfig) -> int:
    """Exact LoRA parameter count of one adapter (0 when disabled), counted
    apart from :func:`param_count`: every tenant shares the base and pays
    only this. Per targeted site and layer ``rank * (in + out)``; under
    mixture-of-experts only the attention sites exist."""
    a = cfg.adapter
    if a.rank <= 0:
        return 0
    d, f = cfg.d_model, cfg.d_ff
    dims = {"q_proj": (d, d), "k_proj": (d, d), "v_proj": (d, d), "out_proj": (d, d)}
    if cfg.moe_experts == 0:
        dims.update(fc1=(d, f), fc2=(f, d))
    per_layer = sum(a.rank * (i + o) for t, (i, o) in dims.items() if t in a.target_modules)
    return cfg.n_layers * per_layer
