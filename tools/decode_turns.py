#!/usr/bin/env python3
"""The decode-attention kernel of this checkout against that of another
checkout (the parent commit), timed in turns on one card: parent, this,
this, parent.

    git archive <parent> | tar -x -C build/parent
    python3 tools/decode_turns.py --parent build/parent [--out FILE]

Builds the other checkout's ``csrc/decode_attention.cu`` with this
checkout's ``nvcc`` flags beside this checkout's library (both at once),
then times each of ``chip_smoke.py``'s phase-3 cases from one CUDA graph of
many launches (``chip_smoke.graph_ms``), each beside its byte bound and
the library yardstick (``scaled_dot_product_attention``; none over an int8
cache); a head dim the other kernel has no instance for is recorded as
refused. Then the flagship serve of phase 4 (``decode_attention: fused``)
in turns, each side's kernel behind the model's decode path: ms per token
and tokens/s, and the time of one tiny kernel from the same kind of graph
(the floor a launch costs there). Prints every number beside the card's
name and power limit and writes them all to ``--out``
(default ``chiprun_out/decode_turns.json``). Needs one CUDA card; exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

#: chip_smoke.py's phase-3 cases: (case, B, S, H, D, q dtype, kv dtype,
#: frontiers, per row).
FLAGSHIP = (4, 512, 16, 32)
CASES = (
    ("bf16_per_row", *FLAGSHIP, "bfloat16", "bfloat16", [0, 37, 511, 600], True),
    ("bf16_scalar", *FLAGSHIP, "bfloat16", "bfloat16", [300], False),
    ("fp32_per_row", *FLAGSHIP, "float32", "float32", [0, 37, 511, 600], True),
    ("int8_per_row", *FLAGSHIP, "bfloat16", "int8", [0, 37, 511, 600], True),
    ("bf16_s8192", 4, 8192, 16, 32, "bfloat16", "bfloat16", [0, 4095, 5000, 9000], True),
    ("bf16_s4096", 4, 4096, 16, 32, "bfloat16", "bfloat16", [0, 1000, 2047, 4095], True),
    ("bf16_d128", 4, 1024, 8, 128, "bfloat16", "bfloat16", [0, 300, 1023, 1100], True),
    ("bf16_d48", 4, 1024, 8, 48, "bfloat16", "bfloat16", [0, 300, 1023, 1100], True),
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: The entry point's signature before the split-KV kernel (no partials, no
#: arrival counters).
_ONE_PASS = [_P] * 7 + [_I] * 5 + [_F] + [_I] * 2 + [_P]


def build_other(src_root: Path) -> ctypes.CDLL:
    """The other checkout's decode library, built while this checkout's
    own library builds."""
    from dtc_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = src_root / "dtc_tpu_torch" / "csrc" / "decode_attention.cu"
    lib_path = _build.BUILD_DIR / "turns_decode_attention_other.so"
    proc = subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.build_all(["decode_attention"])
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{out}")
    lib = ctypes.CDLL(str(lib_path))
    split = hasattr(lib, "dtc_decode_split_len")
    sig = _build._SIGNATURES["decode_attention"]
    for fname in sig if split else ["dtc_decode_attention"]:
        getattr(lib, fname).argtypes = sig[fname] if split else _ONE_PASS
        getattr(lib, fname).restype = ctypes.c_int
    if split:
        lib.dtc_error_string.argtypes = [ctypes.c_int]
        lib.dtc_error_string.restype = ctypes.c_char_p
    lib.split = split
    return lib


def other_wrapper(lib):
    """``fused_decode_attention`` on the other checkout's library: the same
    output, its own launch (a split-KV library through the wrapper's
    ``_launch``). A head dim the library has no instance for raises
    ValueError."""
    import torch

    from dtc_tpu_torch.ops import decode_attention as da

    def call(q, k, v, start, *, h, d, k_scale=None, v_scale=None):
        if lib.split:
            return da._launch(lib, q, k, v, start, h=h, d=d, k_scale=k_scale, v_scale=v_scale)
        b, _, _ = q.shape
        start, per_row = da._frontier(start, b, q.device)
        out = torch.empty_like(q)
        null = ctypes.c_void_p(0)
        scale = ctypes.c_float(float(torch.tensor(d ** -0.5, dtype=q.dtype)))
        ptrs = [ctypes.c_void_p(x.data_ptr()) for x in (q, k, v)] + [
            ctypes.c_void_p(x.data_ptr()) if x is not None else null for x in (k_scale, v_scale)
        ] + [ctypes.c_void_p(start.data_ptr()), ctypes.c_void_p(out.data_ptr())]
        stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
        rc = lib.dtc_decode_attention(*ptrs, b, k.shape[1], h, d, int(per_row), scale,
                                      da._DTYPE_CODES[q.dtype], da._DTYPE_CODES[k.dtype], stream)
        if rc != 0:
            raise ValueError(f"the other kernel refused the call: {rc}")
        return out

    return call


def case_inputs(case, seed):
    import torch

    from dtc_tpu_torch.ops import decode_attention as da

    _, b, s, h, d, qd, kd, starts, per_row = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, 1, h * d, device="cuda", generator=g).to(getattr(torch, qd))
    k = torch.randn(b, s, h * d, device="cuda", generator=g)
    v = torch.randn(b, s, h * d, device="cuda", generator=g)
    kw = {}
    if kd == "int8":
        k, ks = da.quantize_kv(k, h)
        v, vs = da.quantize_kv(v, h)
        kw = dict(k_scale=ks.contiguous(), v_scale=vs.contiguous())
    else:
        k, v = k.to(getattr(torch, kd)), v.to(getattr(torch, kd))
    start = torch.tensor(starts if per_row else starts[0], dtype=torch.int32, device="cuda")
    return q, k, v, start, kw


def kernel_turns(case, other, iters, seed):
    """{side: [ms, ms]} of one case in turns, with its bound and yardstick."""
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from dtc_tpu_torch.ops import decode_attention as da

    name, b, s, h, d, qd, kd, starts, per_row = case
    q, k, v, start, kw = case_inputs(case, seed)
    sides = {"parent": other, "this": da.fused_decode_attention}
    want = da.decode_attention_reference(q, k, v, start, h=h, d=d, **kw)
    from dtc_tpu_torch.parity import attention_tolerance

    limit = attention_tolerance(want, h).to(q.device)
    times = {"parent": [], "this": []}
    refused = {}
    for side in sides:
        try:
            got = sides[side](q, k, v, start, h=h, d=d, **kw)
        except ValueError as e:
            refused[side] = str(e)
            continue
        torch.cuda.synchronize()
        ratio = ((got.float() - want.float()).abs() / limit).max().item()
        if ratio > 1.0:
            raise RuntimeError(f"{name}: the {side} kernel is {ratio} of its limit")
    for side in ("parent", "this", "this", "parent"):
        if side not in refused:
            fn = sides[side]
            times[side].append(cs.graph_ms(lambda: fn(q, k, v, start, h=h, d=d, **kw), iters))
    library_ms = None
    if kd != "int8":
        q4 = q.view(b, 1, h, d).transpose(1, 2)
        k4 = k.view(b, s, h, d).transpose(1, 2).to(q.dtype)
        v4 = v.view(b, s, h, d).transpose(1, 2).to(q.dtype)
        rows = starts if per_row else [starts[0]] * b
        st = torch.tensor(rows, device="cuda")
        mask = (torch.arange(s, device="cuda")[None, :] <= st[:, None])[:, None, None, :]
        library_ms = cs.graph_ms(
            lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask), iters)
    rows = starts if per_row else [starts[0]] * b
    bound_ms, bound_by, nbytes = cs.decode_bound(b, s, h, d, rows, qd, kd)
    return dict(case=name, b=b, s=s, h=h, d=d, q_dtype=qd, kv_dtype=kd, starts=starts,
                per_row=per_row, parent_ms=times["parent"], this_ms=times["this"],
                refused=refused, bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                library_ms=library_ms, split=da.split_len(d, k.dtype))


def serve_turns(other, seed):
    """Phase 4's flagship serve (bf16, ``fused``) in turns: {side: [ms/token
    mean, tokens/s]} per run."""
    import torch

    import chip_smoke as cs
    from dtc_tpu_torch.config.loader import load_serve_config
    from dtc_tpu_torch.ops import decode_attention as da

    scfg, mcfg = load_serve_config(ROOT / "configs" / "serve_config.yaml")
    ours = da.fused_decode_attention
    out = {"parent": [], "this": []}
    for side in ("parent", "this", "this", "parent"):
        da.fused_decode_attention = other if side == "parent" else ours
        try:
            reqs = cs.flagship_requests(mcfg.vocab_size, seed, 64)
            model, eng, res, wall, _ = cs.serve(scfg, mcfg, seed, reqs)
        finally:
            da.fused_decode_attention = ours
        mspt = [res[r.rid].ms_per_token for r in reqs]
        n_tok = sum(len(res[r.rid].tokens) for r in reqs)
        out[side].append(dict(ms_per_token_mean=sum(mspt) / len(mspt), tokens_per_s=n_tok / wall))
        del model, eng
        torch.cuda.empty_cache()
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", required=True, help="root of the other checkout")
    p.add_argument("--out", default=str(ROOT / "chiprun_out" / "decode_turns.json"))
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("decode_turns: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs

    smi = cs.nvidia_smi_line()
    t0 = time.perf_counter()
    other = other_wrapper(build_other(Path(args.parent)))
    print(f"built in {time.perf_counter() - t0:.1f} s; card: {smi}", flush=True)
    rec = dict(card=smi, kernels=[])
    for i, case in enumerate(CASES):
        r = kernel_turns(case, other, args.iters, args.seed + i)
        rec["kernels"].append(r)
        print(f"{r['case']}: parent {r['parent_ms'] or r['refused'].get('parent')} this "
              f"{r['this_ms']} ms; bound {r['bound_ms']:.6f} ({r['bound_by']}), SDPA "
              f"{r['library_ms']}, split {r['split']} [{smi}]", flush=True)
    x = torch.zeros(1, device="cuda")
    rec["one_tiny_kernel_ms"] = cs.graph_ms(lambda: x.add_(1), args.iters)
    print(f"one tiny kernel (x.add_(1)) from a graph: {rec['one_tiny_kernel_ms']:.6f} ms "
          f"[{smi}]", flush=True)
    torch.cuda.empty_cache()
    rec["serve"] = serve_turns(other, args.seed)
    print(f"serve bf16 fused: {rec['serve']} [{smi}]", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rec, indent=1, default=str))
    print(f"decode_turns: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
