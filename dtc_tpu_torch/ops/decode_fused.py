"""Layer-fused decode megakernel: the whole decode block of every layer,
for every batch row, in ONE launch per decode step.

``decode_attention: fused_layers`` routes a single-token decode step (or a
speculative verify window of 2..8 tokens, ``verify=True``) through
:func:`fused_decode_step`: embed, then :func:`fused_layers` over the layer
stack, then the head. Per layer: LN1 -> q/k/v -> the window's k/v written
into the packed ``(L, B, S, H·D)`` cache at the frontier -> attention over
the cache columns before the frontier plus the window, causally ->
out_proj -> residual -> LN2 -> fc1 -> tanh GELU -> fc2 -> residual.

:func:`fused_layers` launches the hand-written Hopper kernel
``csrc/decode_fused.cu`` for CUDA tensors (or raises) and runs
:func:`fused_layers_reference`, the plain PyTorch version, for CPU
tensors; there is no fallback from one to the other. ``launches`` counts
the kernel's launches. Prefill (several tokens without ``verify``) and
mixture-of-experts models keep the per-layer path, as in the JAX package.
The Hopper kernel takes any cache length, so no memory gate routes shapes
away from it.

Numerics are the TPU kernel's: fp32 LayerNorm statistics; ``dense`` rounds
the product to the compute dtype before adding the bias in the compute
dtype; q is scaled in the compute dtype; scores are fp32 and one row max
covers the cached part and the position itself; the cached part's p is
rounded to the compute dtype before p·V while the position's own is not;
an int8 cache quantizes the window's k/v per (position, head) and
attention reads them dequantized. One deliberate difference: the window is
written into the cache first, and window position j reads the earlier
window positions back from it like any cached column (the TPU kernel keeps
them in registers with fp32 p). Row j of a verify window is then exactly a
single-token step at frontier ``start + j``, which makes greedy speculation
token-identical to plain decode in bfloat16 too. An idle serving slot whose
frontier ran past the cache writes at ``S - t`` and reads ``min(start + j,
S)`` columns; its output is discarded.

LoRA sites (adapter-enabled models): q, k and v on the LN1 output,
out_proj before the residual, fc1 before the GELU and fc2 before the
residual add :func:`dtc_tpu_torch.models.gpt.apply_lora`'s delta. The
factors are one adapter's ``(L, ...)`` leaves shared by every row, or a
stack's ``(n_adapters, L, ...)`` leaves with per-row slot ids (``lora_ids``,
(B,)): row ``b * t + j`` reads slot ``lora_ids[b]``. The kernel reads the
stack where it lies, through a per-layer table of the factors' pointers.
"""

from __future__ import annotations

import ctypes

import torch

from dtc_tpu_torch.adapters.lora import SITES as LORA_SITES
from dtc_tpu_torch.adapters.lora import site_dims
from dtc_tpu_torch.models.gpt import DTYPES, gather_slot_lora, layer_lora, lora_scale
from dtc_tpu_torch.ops.attention import NEG_INF
from dtc_tpu_torch.ops.decode_attention import (
    _frontier,
    dequantize_kv,
    quantize_kv,
)

#: Head dims the megakernel is instantiated for: the decode-attention and
#: flash kernels' set.
KERNEL_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)

#: Widest speculative verify window served as one launch.
SPEC_MAX_K = 8

#: flax ``nn.LayerNorm``'s default, the model's setting.
LN_EPS = 1e-6

#: The logits of :func:`fused_decode_step` are computed on blocks of this
#: many rows, so that a row's logits do not depend on how many rows share
#: the call (cuBLAS and PyTorch's reductions choose their algorithm by
#: shape); greedy speculation's token identity with plain decode rests on it.
HEAD_ROWS = 16

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "i8"}

#: Kernel launches since the last reset (the wrapper adds one per launch,
#: nowhere else).
launches = 0

# Weight pointer tables on the device, one per layer stack:
# id(blocks) -> (data_ptr tuple, (L, 16) int64 tensor).
_tables: dict[int, tuple[tuple[int, ...], torch.Tensor]] = {}

#: Widest adapter rank the kernel takes (its z buffer in shared memory).
#: Site i of ``LORA_SITES`` is bit i of the kernel's site mask.
LORA_MAX_RANK = 64
# LoRA pointer tables on the device: (data_ptrs, shapes, layers) -> (L, 12)
# int64 tensor; the newest few are kept.
_lora_tables: dict[tuple, torch.Tensor] = {}
_LORA_TABLES_KEPT = 8


def use_fused_layers(cfg, t_new: int, verify: bool = False) -> bool:
    """The decode-step routing rule: ``decode_attention == "fused_layers"``,
    a single-token step or a ``verify`` window of 2..``SPEC_MAX_K`` tokens,
    and no mixture-of-experts."""
    ok_t = t_new == 1 or (verify and 2 <= t_new <= SPEC_MAX_K)
    return cfg.decode_attention == "fused_layers" and ok_t and cfg.moe_experts == 0


def _layer_params(blk) -> list[torch.Tensor]:
    """The 16 parameters of one block in the kernel's table order."""
    a, m = blk.attn, blk.mlp
    return [
        blk.ln_1.weight, blk.ln_1.bias,
        a.q_proj.weight, a.q_proj.bias, a.k_proj.weight, a.k_proj.bias,
        a.v_proj.weight, a.v_proj.bias, a.out_proj.weight, a.out_proj.bias,
        blk.ln_2.weight, blk.ln_2.bias,
        m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias,
    ]


def _split_cache(cache: dict):
    quant = "k_scale" in cache
    return (cache["k"], cache["v"],
            cache["k_scale"] if quant else None, cache["v_scale"] if quant else None)


def _check(x: torch.Tensor, blocks, cache: dict) -> None:
    cfg = blocks[0].cfg
    if x.ndim != 3 or x.shape[2] != cfg.d_model:
        raise ValueError(f"x must be (B, t, {cfg.d_model}), got {tuple(x.shape)}")
    b, t, _ = x.shape
    if not 1 <= t <= SPEC_MAX_K:
        raise ValueError(f"the megakernel takes 1..{SPEC_MAX_K} positions, got {t}")
    k, v, ks, vs = _split_cache(cache)
    hd = cfg.n_heads * cfg.head_dim
    want = (len(blocks), b, cfg.max_seq_len, hd)
    if tuple(k.shape) != want or tuple(v.shape) != want:
        raise ValueError(f"cache k/v must be {want}, got {tuple(k.shape)}/{tuple(v.shape)}")
    if t > cfg.max_seq_len:
        raise ValueError(f"window {t} is longer than the cache ({cfg.max_seq_len})")
    if (ks is not None) != (k.dtype == torch.int8):
        raise ValueError("an int8 cache needs scales, and scales an int8 cache")
    if ks is not None and (tuple(ks.shape) != want[:3] + (cfg.n_heads,)
                           or tuple(vs.shape) != want[:3] + (cfg.n_heads,)):
        raise ValueError("scales must be (L, B, S, H)")


@torch.no_grad()
def fused_layers_reference(x: torch.Tensor, blocks, cache: dict, idx,
                           lora: dict | None = None,
                           lora_ids: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version of the kernel: ``x`` (B, t, d_model) in the compute
    dtype through every block of ``blocks`` at the frontier ``idx`` (a
    scalar or one per row), writing each layer's window k/v (and int8
    scales) into ``cache`` in place. Returns the last layer's residual
    (B, t, d_model). Uses the blocks' own ``LayerNorm`` and ``Dense`` (with
    their LoRA sites, ``lora`` / ``lora_ids`` as in ``GPT.forward``), so its
    rounding points are the per-layer path's.

    Per layer the window is written at ``min(start, S - t)`` first; window
    position j then attends to cached positions ``< min(start + j, S)``
    (the earlier window positions among them, read back from the cache)
    with p rounded to the compute dtype before p·V, and to itself with
    fp32 p: the operations of a single-token step at frontier
    ``start + j``."""
    _check(x, blocks, cache)
    _check_lora(x, blocks, lora, lora_ids)
    cfg = blocks[0].cfg
    cd = DTYPES[cfg.compute_dtype]
    b, t, _ = x.shape
    h, d = cfg.n_heads, cfg.head_dim
    hd = h * d
    s = cfg.max_seq_len
    kc, vc, ksc, vsc = _split_cache(cache)
    quant = ksc is not None
    start, per_row = _frontier(idx, b, x.device)
    st = (start if per_row else start.expand(b)).long().clamp_min(0)
    pos = st.clamp_max(s - t)[:, None] + torch.arange(t, device=x.device)  # (B, t)
    rows = torch.arange(b, device=x.device)[:, None]
    n_c = (st[:, None] + torch.arange(t, device=x.device)).clamp_max(s)    # (B, t)
    col_ok = torch.arange(s, device=x.device)[None, None, :] < n_c[:, :, None]  # (B, t, S)
    scale = float(torch.tensor(d ** -0.5, dtype=cd))  # rounded to the compute dtype

    per_row_lora = gather_slot_lora(lora, lora_ids)
    for l, blk in enumerate(blocks):
        fl = layer_lora(per_row_lora, l, lora_ids is not None)
        hln = blk.ln_1(x).to(cd)
        q = blk.attn.q_proj(hln, fl.get("q_proj")).view(b, t, h, d) * scale
        k = blk.attn.k_proj(hln, fl.get("k_proj"))
        v = blk.attn.v_proj(hln, fl.get("v_proj"))
        # The window into the cache, then every position as a reader sees it.
        if quant:
            kq, k_sc = quantize_kv(k, h)
            vq, v_sc = quantize_kv(v, h)
            kc[l][rows, pos], vc[l][rows, pos] = kq, vq
            ksc[l][rows, pos], vsc[l][rows, pos] = k_sc, v_sc
            k_new = dequantize_kv(kq, k_sc, h, cd)
            v_new = dequantize_kv(vq, v_sc, h, cd)
            k_all = dequantize_kv(kc[l], ksc[l], h, cd)
            v_all = dequantize_kv(vc[l], vsc[l], h, cd)
        else:
            kc[l][rows, pos], vc[l][rows, pos] = k.to(kc.dtype), v.to(vc.dtype)
            k_new, v_new = k.to(kc.dtype).to(cd), v.to(vc.dtype).to(cd)
            k_all, v_all = kc[l].to(cd), vc[l].to(cd)
        qf = q.float()
        sc = torch.einsum("bthd,bshd->bhts", qf, k_all.view(b, s, h, d).float())
        sc = torch.where(col_ok[:, None], sc, NEG_INF)
        s_own = (qf * k_new.view(b, t, h, d).float()).sum(-1).transpose(1, 2)[..., None]
        m = torch.maximum(sc.amax(-1, keepdim=True), s_own)              # (B, h, t, 1)
        p, p_own = torch.exp(sc - m), torch.exp(s_own - m)
        lsum = p.sum(-1, keepdim=True) + p_own
        acc = torch.einsum("bhts,bshd->bhtd", p.to(cd).float(), v_all.view(b, s, h, d).float())
        acc = acc + p_own * v_new.view(b, t, h, d).float().transpose(1, 2)
        attn = (acc / lsum).to(cd).permute(0, 2, 1, 3).reshape(b, t, hd)
        x = x + blk.attn.out_proj(attn, fl.get("out_proj"))
        x = x + blk.mlp(blk.ln_2(x).to(cd), fl)
    return x


def _check_lora(x: torch.Tensor, blocks, lora: dict | None, lora_ids) -> None:
    if lora is None:
        if lora_ids is not None:
            raise ValueError("lora_ids without lora factors")
        return
    cfg = blocks[0].cfg
    r = cfg.adapter.rank
    if r <= 0:
        raise ValueError("LoRA factors for a model without adapters (adapter.rank == 0)")
    lead = 1 if lora_ids is None else 2
    for key, leaf in lora.items():
        site, ab = key[:-2], key[-2:]
        if site not in LORA_SITES or ab not in ("_a", "_b") or site + "_a" not in lora \
                or site + "_b" not in lora:
            raise ValueError(f"not a pair of LoRA factors: {key!r}")
        d_in, d_out = site_dims(cfg, site)
        want = (r, d_in) if ab == "_a" else (d_out, r)
        if leaf.ndim != lead + 2 or tuple(leaf.shape[-2:]) != want \
                or leaf.shape[lead - 1] < len(blocks) or leaf.device != x.device:
            raise ValueError(
                f"LoRA factor {key} must be ({'n_adapters, ' if lead == 2 else ''}L, "
                f"{want[0]}, {want[1]}) on {x.device}, got {tuple(leaf.shape)} on {leaf.device}"
            )
    if lora_ids is not None and (tuple(lora_ids.shape) != (x.shape[0],)
                                 or lora_ids.device != x.device):
        raise ValueError(f"lora_ids must be ({x.shape[0]},) on {x.device}")


def _lora_table(lora: dict, n_layers: int, device) -> tuple[torch.Tensor, int, int]:
    """The ``(L, 12)`` device table of each layer's factor pointers (A, B per
    site in :data:`LORA_SITES` order; slot 0's, the kernel adds a slot's
    offset; null where the site is not targeted), its site mask and the
    factors' layer count. Built once per set of factor tensors and rebuilt
    when one moves."""
    key = tuple((k, v.data_ptr(), tuple(v.shape)) for k, v in sorted(lora.items())) + (n_layers,)
    table = _lora_tables.get(key)
    mask, lora_layers = 0, 0
    for i, site in enumerate(LORA_SITES):
        if site + "_a" in lora:
            mask |= 1 << i
            lora_layers = lora[site + "_a"].shape[-3]
    if table is None:
        ptrs = []
        for leaf in lora.values():
            if leaf.dtype != torch.float32 or not leaf.is_contiguous() or leaf.data_ptr() % 16:
                raise ValueError("the megakernel reads contiguous, 16-byte aligned float32 "
                                 f"LoRA factors; got {leaf.dtype}")
        for l in range(n_layers):
            for site in LORA_SITES:
                for ab in ("_a", "_b"):
                    leaf = lora.get(site + ab)
                    ptrs.append(0 if leaf is None else
                                leaf.data_ptr() + 4 * l * leaf.shape[-2] * leaf.shape[-1])
        table = torch.tensor(ptrs, dtype=torch.int64, device=device).view(n_layers, 12)
        while len(_lora_tables) >= _LORA_TABLES_KEPT:
            _lora_tables.pop(next(iter(_lora_tables)))
        _lora_tables[key] = table
    return table, mask, lora_layers


def _library(cd: torch.dtype, kv: torch.dtype):
    """The kernel library of one (compute, KV) dtype pair, built at first
    use."""
    from dtc_tpu_torch.ops import _build

    return _build.load(f"decode_fused_{_DTYPE_NAMES[cd]}_{_DTYPE_NAMES[kv]}")


def _weight_table(blocks, device) -> torch.Tensor:
    """The ``(L, 16)`` device table of the blocks' parameter pointers, built
    once per layer stack and rebuilt when a parameter moves."""
    params = [p for blk in blocks for p in _layer_params(blk)]
    ptrs = tuple(p.data_ptr() for p in params)
    hit = _tables.get(id(blocks))
    if hit is None or hit[0] != ptrs:
        for p in params:
            if p.device != device or p.dtype != torch.float32 or not p.is_contiguous():
                raise ValueError(
                    "the megakernel reads contiguous float32 parameters on the "
                    f"activations' device; got {p.dtype} on {p.device}"
                )
            if p.data_ptr() % 16:
                raise ValueError("parameters must be 16-byte aligned")
        hit = (ptrs, torch.tensor(ptrs, dtype=torch.int64, device=device).view(len(blocks), 16))
        _tables[id(blocks)] = hit
    return hit[1]


def fused_layers(x: torch.Tensor, blocks, cache: dict, idx, lora: dict | None = None,
                 lora_ids: torch.Tensor | None = None) -> torch.Tensor:
    """The layer stack of one decode step (or verify window) in one launch:
    ``x`` (B, t, d_model) compute-dtype residual after the embedding,
    ``blocks`` the model's ``Block``s, ``cache`` the decode cache (written
    in place at the frontier ``idx``, a scalar or one per row). ``lora``:
    adapter factors, shared, or a stack read per row through ``lora_ids``
    (B,) int32 slot ids (in range; the kernel does not check them).
    Returns the residual after the last block. CPU tensors take
    :func:`fused_layers_reference`; CUDA tensors launch the Hopper kernel on
    the current stream or raise. Replaces the JAX package's
    ``_fused_layers_call`` (kernel ``_fused_layers_kernel``)."""
    global launches
    _check(x, blocks, cache)
    _check_lora(x, blocks, lora, lora_ids)
    if x.device.type == "cpu":
        return fused_layers_reference(x, blocks, cache, idx, lora, lora_ids)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    cfg = blocks[0].cfg
    cd = DTYPES[cfg.compute_dtype]
    k, v, ks, vs = _split_cache(cache)
    tensors = [x, k, v] + ([ks, vs] if ks is not None else [])
    if any(z.device != x.device for z in tensors):
        raise ValueError("x and the cache must be on one device")
    if any(not z.is_contiguous() for z in tensors):
        raise ValueError("x and the cache must be contiguous")
    if x.dtype != cd or cd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be in the compute dtype (float32 or bfloat16), got {x.dtype}")
    if k.dtype != v.dtype or k.dtype not in _DTYPE_CODES:
        raise ValueError(f"cache must be float32, bfloat16 or int8, got {k.dtype}")
    if ks is not None and (ks.dtype != torch.float32 or vs.dtype != torch.float32):
        raise ValueError("scales must be float32")
    if cfg.head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {cfg.head_dim} not in the kernel's {KERNEL_HEAD_DIMS}")
    if cfg.d_model % 4 or cfg.d_ff % 4:
        raise ValueError("d_model and d_ff must be multiples of 4")
    if any(z.data_ptr() % 16 for z in (x, k, v)):
        raise ValueError("x and the cache must be 16-byte aligned")
    if lora_ids is not None and (lora_ids.dtype != torch.int32 or not lora_ids.is_contiguous()):
        raise ValueError("lora_ids must be contiguous int32")
    if lora is not None and cfg.adapter.rank > LORA_MAX_RANK:
        raise ValueError(f"adapter rank {cfg.adapter.rank} above the kernel's {LORA_MAX_RANK}")
    out = _launch(_library(cd, k.dtype), x, blocks, cache, idx, lora, lora_ids)
    launches += 1
    return out


def scratch_floats(lib, cfg, b: int, t: int, cd: torch.dtype, kv: torch.dtype) -> int:
    """Floats of scratch one launch of ``lib`` at these shapes needs (its
    ``dtc_fused_layers_scratch_floats``); 0 at a head dim it has no
    instance for."""
    fn = lib.dtc_fused_layers_scratch_floats
    fn.argtypes, fn.restype = [ctypes.c_int] * 9, ctypes.c_longlong
    return fn(b, t, cfg.max_seq_len, cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
              _DTYPE_CODES[cd], _DTYPE_CODES[kv])


def _launch(lib, x: torch.Tensor, blocks, cache: dict, idx, lora: dict | None = None,
            lora_ids: torch.Tensor | None = None, n_scratch: int | None = None) -> torch.Tensor:
    """One launch of ``lib``'s ``dtc_fused_layers`` on the current stream
    (the arguments checked by :func:`fused_layers`): its scratch
    (:func:`scratch_floats`, or ``n_scratch`` floats), the weight and LoRA
    tables, the scales rounded to the compute dtype. Returns the output;
    raises if the launch fails."""
    from dtc_tpu_torch.ops import _build

    cfg = blocks[0].cfg
    cd = DTYPES[cfg.compute_dtype]
    k, v, ks, vs = _split_cache(cache)
    b, t, dm = x.shape
    if n_scratch is None:
        n_scratch = scratch_floats(lib, cfg, b, t, cd, k.dtype)
    if n_scratch <= 0:
        raise ValueError(f"the megakernel library has no instance at head_dim {cfg.head_dim}")
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    table = _weight_table(blocks, x.device)
    start, per_row = _frontier(idx, b, x.device)
    # The scales are rounded to the compute dtype first, as the reference's are.
    scale = float(torch.tensor(cfg.head_dim ** -0.5, dtype=cd))
    null = ctypes.c_void_p(0)
    if lora is None:
        lora_table, lora_mask, lora_layers = None, 0, 0
    else:
        lora_table, lora_mask, lora_layers = _lora_table(lora, len(blocks), x.device)
    rc = lib.dtc_fused_layers(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(table.data_ptr()),
        ctypes.c_void_p(k.data_ptr()), ctypes.c_void_p(v.data_ptr()),
        ctypes.c_void_p(ks.data_ptr()) if ks is not None else null,
        ctypes.c_void_p(vs.data_ptr()) if vs is not None else null,
        ctypes.c_void_p(start.data_ptr()), ctypes.c_void_p(scratch.data_ptr()),
        b, t, len(blocks), cfg.max_seq_len, dm, cfg.n_heads, cfg.head_dim, cfg.d_ff,
        int(per_row), ctypes.c_float(scale), _DTYPE_CODES[cd], _DTYPE_CODES[k.dtype],
        ctypes.c_void_p(lora_table.data_ptr()) if lora_table is not None else null,
        ctypes.c_void_p(lora_ids.data_ptr()) if lora_ids is not None else null,
        lora_mask, cfg.adapter.rank if lora_mask else 0, lora_layers,
        ctypes.c_float(lora_scale(cfg) if lora_mask else 0.0),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    if rc != 0:
        raise RuntimeError(f"fused layers kernel launch failed: {_build.error_string(lib, rc)}")
    return out


def kernel_config(cfg, kv_dtype: torch.dtype) -> tuple[int, int]:
    """(blocks in the grid: one a streaming multiprocessor, dynamic shared
    memory bytes per block) that the kernel takes for ``cfg`` on the
    current CUDA device."""
    from dtc_tpu_torch.ops import _build

    cd = DTYPES[cfg.compute_dtype]
    lib = _library(cd, kv_dtype)
    grid, smem = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.dtc_fused_layers_config(
        cfg.d_model, cfg.d_ff, cfg.head_dim, _DTYPE_CODES[cd],
        _DTYPE_CODES[kv_dtype], ctypes.byref(grid), ctypes.byref(smem),
    )
    if rc != 0:
        raise RuntimeError(f"fused layers kernel configuration failed: {_build.error_string(lib, rc)}")
    return grid.value, smem.value


def head_rows(head, h: torch.Tensor) -> torch.Tensor:
    """``head(h)`` for ``h`` (B, t, d_model), computed on zero-padded
    blocks of :data:`HEAD_ROWS` rows so each row's logits are the same
    whatever B and t are."""
    b, t, dm = h.shape
    rows = h.reshape(b * t, dm)
    pad = -rows.shape[0] % HEAD_ROWS
    if pad:
        rows = torch.cat([rows, rows.new_zeros(pad, dm)])
    out = torch.cat([head(blk) for blk in rows.split(HEAD_ROWS)])
    return out[: b * t].reshape(b, t, -1)


@torch.no_grad()
def fused_decode_step(model, cache: dict, tok: torch.Tensor, lora: dict | None = None,
                      lora_ids: torch.Tensor | None = None):
    """The ``fused_layers`` decode step: ``tok`` (B, t) at the cache's
    frontier (t == 1, or a verify window of up to ``SPEC_MAX_K``). Embed,
    the layer stack in one megakernel launch (with the LoRA sites when
    ``lora`` is given), then the head. The K/V buffers are written in
    place; the returned cache shares them and carries a new index
    ``index + t``, so re-running from ``cache`` repeats the step exactly.
    Returns ``(new_cache, logits)``."""
    idx = cache["index"]
    h = model.embed(tok, pos_offset=idx)
    h = fused_layers(h, model.stage.blocks, cache, idx, lora, lora_ids)
    new = dict(cache)
    new["index"] = idx + tok.shape[1]
    return new, head_rows(model.head, h)

