#!/usr/bin/env python3
"""The flash kernels of this checkout against those of another checkout
(the parent commit), timed in turns on one card: parent, this, this,
parent.

    git archive <parent> | tar -x -C build/parent
    python3 tools/flash_turns.py --parent build/parent [--out FILE]

Builds the other checkout's ``csrc/flash_attention.cu`` (its CUDA-core and
its tensor-core library) with this checkout's ``nvcc`` flags beside this
checkout's libraries (all at once), then times, at the shapes the port's
paths launch (bfloat16): the forward,
the dq kernel alone and the dk/dv kernel alone, each from one CUDA graph of
many launches (``chip_smoke.graph_ms``); then training steps with the
wrappers' launchers swapped for the other checkout's (T 8192, B 2 and the
flagship, B 8, T 512), and a torch.profiler window over three T 8192 steps
of each. Prints every number beside the card's name and power limit and
writes them all to ``--out`` (default ``chiprun_out/flash_turns.json``).
Needs one CUDA card; exits non-zero without one.
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

#: (case, B, T, H, D, causal, gradient dtype): the flagship call, a ragged
#: T, the long-context calls, the ring's chunk pair of T 8192 over 4 ranks
#: (no mask, float32 gradients) and the JAX package's transpose-layout shape.
CASES = (
    ("flagship", 8, 512, 16, 32, True, "bfloat16"),
    ("t1000", 2, 1000, 16, 32, True, "bfloat16"),
    ("t4096", 4, 4096, 16, 32, True, "bfloat16"),
    ("t8192", 2, 8192, 16, 32, True, "bfloat16"),
    ("block_tc1024", 2, 1024, 16, 32, False, "float32"),
    ("block_tc1024_causal", 2, 1024, 16, 32, True, "float32"),
    ("d48", 4, 1024, 8, 48, True, "bfloat16"),
)


#: The other checkout's entry points: its CUDA-core library takes a bf16
#: dq launch (every dtype), its tensor-core library the bf16 forward and
#: dk/dv launches.
_OTHER = {
    "flash_attention": ("", {"dtc_flash_bwd_dq"}),
    "flash_attention_tc": ("-DDTC_FLASH_TC=1", {"dtc_flash_tc_fwd", "dtc_flash_tc_dkv"}),
}


def build_other(src_root: Path) -> dict:
    """The other checkout's two flash libraries, built while this
    checkout's libraries build: {library: CDLL}."""
    from dtc_tpu_torch.ops import _build

    src = src_root / "dtc_tpu_torch" / "csrc" / "flash_attention.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (define, _) in _OTHER.items():
        lib = _build.BUILD_DIR / f"other_{name}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, *([define] if define else []), "-o", str(lib),
               str(src)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    _build.build_all()
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src} ({name}):\n{out}")
        libs[name] = ctypes.CDLL(str(lib))
        for fn in _OTHER[name][1]:
            getattr(libs[name], fn).argtypes = _build._SIGNATURES[name][fn]
            getattr(libs[name], fn).restype = ctypes.c_int
    return libs


def other_launchers(libs):
    """The wrapper's three launchers (``_forward_kernel``, ``_dq_kernel``,
    ``_dkv_kernel``) on the other checkout's libraries, for bfloat16
    inputs: the forward and dk/dv kernels of its tensor-core library (this
    checkout's plan: the geometry is the same), the dq kernel of its
    CUDA-core library."""
    import torch

    from dtc_tpu_torch.ops import flash_attention as fa

    codes = fa._DTYPE_CODES
    lib, tc = libs["flash_attention"], libs["flash_attention_tc"]

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"other checkout's {what} failed: {rc}")

    def forward(q, k, v, h, causal):
        b, t, hd = q.shape
        d = hd // h
        plan = fa.flash_plan(q.dtype, d, causal)
        out = torch.empty_like(q)
        lse = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
        check(tc.dtc_flash_tc_fwd(fa._ptr(q), fa._ptr(k), fa._ptr(v), fa._ptr(out),
                                  fa._ptr(lse), b, t, h, d, fa._scale_q(d, q.dtype), int(causal),
                                  plan.swizzle, plan.boxes, plan.stages, fa._stream(q)),
              "forward")
        return out, lse

    def dq_kernel(q, k, v, out, lse, do, h, causal, grad_dtype):
        b, t, hd = q.shape
        d = hd // h
        delta = torch.empty_like(lse)
        dq = torch.empty(q.shape, dtype=grad_dtype, device=q.device)
        check(lib.dtc_flash_bwd_dq(fa._ptr(q), fa._ptr(k), fa._ptr(v), fa._ptr(out), fa._ptr(do),
                                   fa._ptr(lse), fa._ptr(delta), fa._ptr(dq), b, t, h, d,
                                   fa._scale_q(d, q.dtype), fa._scale(d), codes[q.dtype],
                                   codes[grad_dtype], int(causal), fa._stream(q)), "dq")
        return dq, delta

    def dkv_kernel(q, k, v, lse, delta, do, h, causal, grad_dtype):
        b, t, hd = q.shape
        d = hd // h
        plan = fa.flash_plan(q.dtype, d, causal)
        dk, dv = (torch.empty(q.shape, dtype=grad_dtype, device=q.device) for _ in range(2))
        check(tc.dtc_flash_tc_dkv(fa._ptr(q), fa._ptr(k), fa._ptr(v), fa._ptr(do),
                                  fa._ptr(lse), fa._ptr(delta), fa._ptr(dk), fa._ptr(dv), b, t,
                                  h, d, fa._scale_q(d, q.dtype), codes[grad_dtype], int(causal),
                                  plan.swizzle, plan.boxes, plan.stages, fa._stream(q)), "dk/dv")
        return dk, dv

    return forward, dq_kernel, dkv_kernel


class Launchers:
    """Swaps the wrapper's launchers for another set inside ``with``."""

    def __init__(self, launchers):
        self.launchers = launchers

    def __enter__(self):
        from dtc_tpu_torch.ops import flash_attention as fa

        self.saved = fa._forward_kernel, fa._dq_kernel, fa._dkv_kernel
        if self.launchers is not None:
            fa._forward_kernel, fa._dq_kernel, fa._dkv_kernel = self.launchers

    def __exit__(self, *exc):
        from dtc_tpu_torch.ops import flash_attention as fa

        fa._forward_kernel, fa._dq_kernel, fa._dkv_kernel = self.saved


def kernel_times(case, other, iters):
    """{part: ms} of the forward, dq and dk/dv launches, in turns."""
    import torch

    import chip_smoke as cs
    from dtc_tpu_torch.ops import flash_attention as fa

    name, b, t, h, d, causal, gname = case
    gdt = getattr(torch, gname)
    g = torch.Generator(device="cuda").manual_seed(t + d)
    q, k, v, do = (torch.randn(b, t, h * d, device="cuda", generator=g).to(torch.bfloat16)
                   for _ in range(4))
    out, lse = fa._forward_kernel(q, k, v, h, causal)
    _, delta = fa._dq_kernel(q, k, v, out, lse, do, h, causal, gdt)
    sides = {"parent": other, "this": None}
    times = {f"{side}_{part}": [] for side in sides for part in ("fwd", "dq", "dkv")}
    for side in ("parent", "this", "this", "parent"):
        with Launchers(sides[side]):
            times[f"{side}_fwd"].append(cs.graph_ms(
                lambda: fa._forward_kernel(q, k, v, h, causal), iters))
            times[f"{side}_dq"].append(cs.graph_ms(
                lambda: fa._dq_kernel(q, k, v, out, lse, do, h, causal, gdt), iters))
            times[f"{side}_dkv"].append(cs.graph_ms(
                lambda: fa._dkv_kernel(q, k, v, lse, delta, do, h, causal, gdt), iters))
    bounds = cs.flash_bounds(b, t, h, d, "bfloat16")
    if not causal:  # a chunk pair without the mask: every (query, key) pair
        bounds = cs.block_bounds(b, t, h, d, "bfloat16", False)
    return dict(case=name, b=b, t=t, h=h, d=d, causal=causal, grad_dtype=gname,
                bound_fwd_ms=bounds["fwd"][0], bound_bwd_ms=bounds["bwd"][0],
                bound_dq_ms=cs.dq_bound(b, t, h, d, "bfloat16", causal, gname)[0], **times)


def configs(long: bool, steps: int, warmup: int):
    """(train, model, optim) configs of the T 8192 (B 2, as chip_smoke's
    phase 13(b)) or the flagship training run."""
    from dtc_tpu_torch.config.loader import load_config

    if long:
        tcfg, mcfg, ocfg = load_config(ROOT / "configs" / "train_config_longctx.yaml",
                                       ROOT / "configs" / "model_config_longctx.yaml")
        mcfg = dataclasses.replace(mcfg, max_seq_len=8192, attention_block_kv_bwd=1024)
        tcfg = dataclasses.replace(tcfg, batch=2)
    else:
        tcfg, mcfg, ocfg = load_config(ROOT / "configs" / "train_config_dp.yaml")
    tcfg = dataclasses.replace(tcfg, dataset="synthetic", steps=steps, warmup_steps=warmup,
                               obs=dataclasses.replace(tcfg.obs, enabled=False),
                               output_dir="", log_every=steps)
    return tcfg, mcfg, ocfg


def step_ms(long: bool, steps: int, warmup: int) -> float:
    """Mean (T 8192) or median (flagship) step ms of a training run."""
    import torch

    from dtc_tpu_torch.train.trainer import train

    torch.cuda.synchronize()
    res = train(*configs(long, steps, warmup))
    el = res.elapsed_times
    if long:  # rows stamped at dispatch, the last after a sync
        return el[-1] / steps * 1e3
    return sorted(b - a for a, b in zip([0.0] + el[:-1], el))[len(el) // 2] * 1e3


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", required=True, help="root of the other checkout")
    p.add_argument("--out", default=str(ROOT / "chiprun_out" / "flash_turns.json"))
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_turns: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs

    smi = cs.nvidia_smi_line()
    t0 = time.perf_counter()
    other = other_launchers(build_other(Path(args.parent)))
    print(f"built in {time.perf_counter() - t0:.1f} s; card: {smi}", flush=True)
    rec = dict(card=smi, kernels=[], steps={})
    for case in CASES:
        iters = 3 if case[2] >= 4096 else args.iters
        r = kernel_times(case, other, iters)
        rec["kernels"].append(r)
        for part in ("fwd", "dq", "dkv"):
            print(f"{r['case']} {part}: parent {r[f'parent_{part}']} this {r[f'this_{part}']} ms "
                  f"[{smi}]", flush=True)
        print(f"{r['case']}: bound fwd {r['bound_fwd_ms']:.6f} bwd {r['bound_bwd_ms']:.6f} "
              f"dq {r['bound_dq_ms']:.6f} ms",
              flush=True)
    torch.cuda.empty_cache()
    for tag, long, steps, warmup in (("t8192", True, 6, 2), ("flagship", False, 20, 5)):
        ms = {"parent": [], "this": []}
        for side in ("parent", "this", "this", "parent"):
            with Launchers(other if side == "parent" else None):
                ms[side].append(step_ms(long, steps, warmup))
            torch.cuda.empty_cache()
        rec["steps"][tag] = ms
        print(f"step {tag}: parent {ms['parent']} this {ms['this']} ms [{smi}]", flush=True)
    tcfg, mcfg, ocfg = configs(True, 3, 0)
    for side in ("parent", "this"):
        with Launchers(other if side == "parent" else None):
            prof = cs.profile_train(mcfg, tcfg, ocfg, steps=3)
        rec[f"profile_t8192_{side}"] = prof
        print(f"profile t8192 {side}: wall {prof['wall_s']:.6f} s, busy "
              f"{prof['device_busy_s']:.6f} s (share {prof['busy_share']:.4f}) [{smi}]")
        for row in prof["top"]:
            print(f"  {row['device_ms']:.4f} ms x{row['count']} {row['name']}")
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rec, indent=1, default=str))
    print(f"flash_turns: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
