#!/usr/bin/env python3
"""The decode megakernel of this checkout against that of another checkout
(the parent commit), timed in turns on one card: parent, this, this,
parent.

    git archive <parent> | tar -x -C build/parent
    python3 tools/megakernel_turns.py --parent build/parent [--out FILE]

Builds the other checkout's ``csrc/decode_fused.cu`` (bfloat16 compute over
a bfloat16 cache, the library every case here runs) with this checkout's
``nvcc`` flags, beside this checkout's library (both at once). Then times
each case from one CUDA graph of many launches (``chip_smoke.graph_ms``),
each side checked first against the plain version
(``chip_smoke.megakernel_compare``, the all-layer limit), each beside its
byte bound (``chip_smoke.megakernel_bound``). The cases separate the
kernel's costs: phase 9's flagship calls (B 4, 12 layers, frontiers [2,
37, 300, 511]; t 1, t 4, and t 1 with rank-8 adapters on slots [0, 1, 2,
1]); frontiers all 0 and all 511 (attention's share); depth 1, 6 and 12
(the cost a layer and the fixed cost); B 1 against B 4; windows t 1, 4
and 8 (R 32 rows) and 5-7 (the other verify windows of speculation, k 2-8);
the serve's own shapes (B 4, t 1, frontiers 8-164: phase 10's prompts
and new tokens); the ladder configs at B 4, t 1; and head dim 48 at
the flagship's width (refused by a side with no instance there). Then
the flagship serve under ``decode_attention: fused_layers`` (phase 10's
requests) in turns: ms a token and tokens/s. Prints every number beside
the card's name and power limit and writes them all to ``--out``
(default ``chiprun_out/megakernel_turns.json``). Needs one CUDA card;
exits non-zero without one.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

LIB = "decode_fused_bf16_bf16"
FLAGSHIP_STARTS = [2, 37, 300, 511]

#: (case, config source, overrides, B, t, frontiers, adapters)
CASES = (
    ("flagship_t1", "flagship", {}, 4, 1, FLAGSHIP_STARTS, False),
    ("flagship_t4", "flagship", {}, 4, 4, [2, 37, 300, 508], False),
    ("flagship_t1_lora", "lora", {}, 4, 1, FLAGSHIP_STARTS, True),
    ("frontiers_0", "flagship", {}, 4, 1, [0, 0, 0, 0], False),
    ("frontiers_511", "flagship", {}, 4, 1, [511, 511, 511, 511], False),
    ("depth_1", "flagship", {"n_layers": 1}, 4, 1, FLAGSHIP_STARTS, False),
    ("depth_6", "flagship", {"n_layers": 6}, 4, 1, FLAGSHIP_STARTS, False),
    ("batch_1", "flagship", {}, 1, 1, [300], False),
    ("window_t5", "flagship", {}, 4, 5, [2, 37, 300, 507], False),
    ("window_t6", "flagship", {}, 4, 6, [2, 37, 300, 506], False),
    ("window_t7", "flagship", {}, 4, 7, [2, 37, 300, 505], False),
    ("window_t8", "flagship", {}, 4, 8, [2, 37, 300, 504], False),
    # Phase 10's serve: 4 slots, prompts 8-100 plus up to 64 new tokens.
    ("serve_early", "flagship", {}, 4, 1, [8, 40, 64, 100], False),
    ("serve_mid", "flagship", {}, 4, 1, [40, 72, 96, 132], False),
    ("serve_late", "flagship", {}, 4, 1, [72, 104, 128, 164], False),
    ("head_dim_48", "flagship", {"n_heads": 8, "d_model": 384, "d_ff": 1536}, 4, 1,
     FLAGSHIP_STARTS, False),
    ("ladder_350m", "configs/model_ladder_350m.yaml", {}, 4, 1, [2, 37, 300, 1023], False),
    ("ladder_1b", "configs/model_ladder_1b.yaml", {}, 4, 1, [2, 37, 300, 1023], False),
)


def build_other(src_root: Path, prebuilt: str | None = None) -> ctypes.CDLL:
    """The other checkout's megakernel library (bf16 over bf16), built
    while this checkout's own builds, or ``prebuilt`` (a library built
    from that checkout by an earlier run: it is left in ``build/``)."""
    from dtc_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if prebuilt:
        _build.build_all([LIB])
        lib_path = Path(prebuilt)
    else:
        src = src_root / "dtc_tpu_torch" / "csrc" / "decode_fused.cu"
        lib_path = _build.BUILD_DIR / "turns_decode_fused_other.so"
        _, defines = _build._VARIANTS[LIB]
        proc = subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, *defines, "-o",
                                 str(lib_path), str(src)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        _build.build_all([LIB])
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{out}")
    lib = ctypes.CDLL(str(lib_path))
    lib.dtc_fused_layers.argtypes = _build._SIGNATURES[LIB]["dtc_fused_layers"]
    lib.dtc_fused_layers.restype = ctypes.c_int
    lib.dtc_error_string.argtypes = [ctypes.c_int]
    lib.dtc_error_string.restype = ctypes.c_char_p
    return lib


def other_wrapper(lib):
    """``decode_fused.fused_layers`` on the other checkout's library
    (``decode_fused._launch``). A library of the first design has no
    ``dtc_fused_layers_scratch_floats`` and took 64 floats of counter and
    one row of each buffer, at head dims 16, 32, 64 and 128 only. A head
    dim the library has no instance for raises ValueError."""
    from dtc_tpu_torch.ops import decode_fused as df

    sized = hasattr(lib, "dtc_fused_layers_scratch_floats")

    def call(x, blocks, cache, idx, lora=None, lora_ids=None):
        cfg = blocks[0].cfg
        n = None
        if not sized:
            if cfg.head_dim not in (16, 32, 64, 128):
                raise ValueError(f"the other kernel has no instance at head_dim {cfg.head_dim}")
            n = 64 + x.shape[0] * x.shape[1] * (5 * cfg.d_model + cfg.d_ff)
        return df._launch(lib, x, blocks, cache, idx, lora, lora_ids, n_scratch=n)

    return call


def case_model(source, overrides, lora):
    """The case's model (bf16 compute, fused_layers) with random weights,
    biases and LayerNorm parameters (``chip_smoke.megakernel_model``)."""
    import chip_smoke as cs
    from dtc_tpu_torch.config.loader import (load_finetune_config, load_serve_config,
                                              load_yaml_dataclass)
    from dtc_tpu_torch.config.schema import ModelConfig

    if source == "lora":
        _, cfg, _ = load_finetune_config(ROOT / "configs" / "finetune_lora.yaml")
    elif source == "flagship":
        _, cfg = load_serve_config(ROOT / "configs" / "serve_config.yaml")
    else:
        cfg = load_yaml_dataclass(ROOT / source, ModelConfig)
    cfg = dataclasses.replace(cfg, **overrides)
    return cs.megakernel_model(cfg, "bfloat16", 900)


def kernel_turns(case, other, iters, seed, smi):
    import torch

    import chip_smoke as cs
    from dtc_tpu_torch.ops import decode_fused as df

    name, source, overrides, b, t, starts, lora = case
    model = case_model(source, overrides, lora)
    x, cache = cs.megakernel_inputs(model, b, t, "bfloat16", seed)
    dev = model.device
    idx = torch.tensor(starts, dtype=torch.int32, device=dev)
    blocks = model.stage.blocks
    stack, ids, lids = None, None, None
    if lora:
        stack = cs.lora_stack(model, cs.tenant_factors(model.cfg, dev, seed + 1, 2))
        ids = [0, 1, 2, 1][:b]
        lids = torch.tensor(ids, dtype=torch.int32, device=dev)
    sides = {"parent": other, "this": df.fused_layers}
    want = df.fused_layers_reference(x, blocks, {k: v.clone() for k, v in cache.items()}, idx,
                                     stack, lids)
    rec = dict(case=name, b=b, t=t, starts=starts, n_layers=model.cfg.n_layers,
               d_model=model.cfg.d_model, d_ff=model.cfg.d_ff, head_dim=model.cfg.head_dim,
               max_seq_len=model.cfg.max_seq_len, lora=lora, parent_ms=[], this_ms=[],
               refused={}, err_over_limit={}, card=smi)
    for side, fn in sides.items():
        try:
            got = fn(x, blocks, {k: v.clone() for k, v in cache.items()}, idx, stack, lids)
        except ValueError as e:
            rec["refused"][side] = str(e)
            continue
        torch.cuda.synchronize()
        ratio, _, _ = cs.megakernel_compare(got, want, "bfloat16", "bfloat16", False)
        rec["err_over_limit"][side] = ratio
    del want
    for side in ("parent", "this", "this", "parent"):
        if side not in rec["refused"]:
            fn = sides[side]
            rec[f"{side}_ms"].append(cs.graph_ms(
                lambda: fn(x, blocks, cache, idx, stack, lids), iters))
    rec["bound_ms"], rec["bound_by"], rec["bytes"] = cs.megakernel_bound(
        model.cfg, b, t, starts, "bfloat16", "bfloat16", ids)
    del model, x, cache, stack
    torch.cuda.empty_cache()
    return rec


def serve_turns(other, seed):
    """Phase 10's flagship serve under ``fused_layers`` in turns: {side:
    [{ms/token mean, tokens/s, launches, iterations}]}."""
    import torch

    import chip_smoke as cs
    from dtc_tpu_torch.config.loader import load_serve_config
    from dtc_tpu_torch.ops import decode_fused as df

    scfg, mcfg = load_serve_config(ROOT / "configs" / "serve_config.yaml")
    mcfg = dataclasses.replace(mcfg, decode_attention="fused_layers")
    ours = df.fused_layers
    out = {"parent": [], "this": []}
    for side in ("parent", "this", "this", "parent"):
        df.fused_layers = other if side == "parent" else ours
        try:
            reqs = cs.flagship_requests(mcfg.vocab_size, seed, 64)
            model, eng, res, wall, launched = cs.serve(scfg, mcfg, seed, reqs)
        finally:
            df.fused_layers = ours
        mspt = [res[r.rid].ms_per_token for r in reqs]
        n_tok = sum(len(res[r.rid].tokens) for r in reqs)
        out[side].append(dict(ms_per_token_mean=sum(mspt) / len(mspt), tokens_per_s=n_tok / wall,
                              iterations=eng.counters["serve_decode_steps"],
                              tokens=[list(res[r.rid].tokens) for r in reqs]))
        del model, eng
        torch.cuda.empty_cache()
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", required=True, help="root of the other checkout")
    p.add_argument("--out", default=str(ROOT / "chiprun_out" / "megakernel_turns.json"))
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--other-lib", help="the other checkout's library, already built")
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("megakernel_turns: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs

    smi = cs.nvidia_smi_line()
    t0 = time.perf_counter()
    other = other_wrapper(build_other(Path(args.parent), args.other_lib))
    print(f"built in {time.perf_counter() - t0:.1f} s; card: {smi}", flush=True)
    rec = dict(card=smi, kernels=[])
    for i, case in enumerate(CASES):
        r = kernel_turns(case, other, args.iters, args.seed + 920 + i, smi)
        rec["kernels"].append(r)
        print(f"{r['case']} (B {r['b']}, t {r['t']}, {r['n_layers']} layers, d_model "
              f"{r['d_model']}, D {r['head_dim']}): parent {r['parent_ms'] or r['refused']} "
              f"this {r['this_ms'] or r['refused']} ms; bound {r['bound_ms']:.6f} "
              f"({r['bound_by']}); error/limit {r['err_over_limit']} [{smi}]", flush=True)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1, default=str))
    rec["serve"] = serve_turns(other, args.seed)
    same = all(run["tokens"] == rec["serve"]["parent"][0]["tokens"]
               for runs in rec["serve"].values() for run in runs)
    print("serve fused_layers: " + json.dumps({side: [
        {k: v for k, v in run.items() if k != "tokens"} for run in runs]
        for side, runs in rec["serve"].items()}) + f"; tokens equal across sides: {same} [{smi}]",
        flush=True)
    Path(args.out).write_text(json.dumps(rec, indent=1, default=str))
    print(f"megakernel_turns: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
