#!/usr/bin/env python3
"""How far the bf16 products of PyTorch's dense layers on the card sit from
float32 sums, at the megakernel's dense shapes (phase 9 of chip_smoke.py).

    python3 tools/gemm_rounding.py [--out FILE]

For d_model 384-896 (8 heads of 48-112, d_ff 4 d_model) and 4 or 16 rows
(B 4 at t 1 and t 4), each dense product of a layer (q/k/v and out_proj:
K d_model, N d_model; fc1: N d_ff; fc2: K d_ff) on random bf16 operands,
three ways: ``F.linear`` in bf16 (cuBLAS, the plain version's product),
``F.linear`` in float32 of the same bf16 values with TF32 off
(``chip_smoke.exact_products``), and float64 sums rounded once to bf16 (the
exact value of the products' sum). Prints for each the share of outputs
that differ from the exact rounding and the largest difference in bf16
ulps, and the CUDA kernels each ``F.linear`` ran (``torch.profiler``),
beside the card's name and power limit; writes them all to ``--out``
(default ``chiprun_out/gemm_rounding.json``). Needs one CUDA card; exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

D_MODELS = (384, 512, 640, 768, 896)
ROWS = (4, 16)


def kernels_of(fn):
    """Names of the CUDA kernels ``fn()`` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events() if e.device_type.name == "CUDA"})


def differ(got, exact):
    """(share of outputs that differ, largest difference in ulps of the
    exact value's bf16 binade)."""
    import torch

    d = (got.float() - exact.float()).abs()
    ulp = torch.ldexp(torch.ones_like(d), torch.frexp(exact.float())[1] - 8)
    return float((d > 0).float().mean()), float((d / ulp).max())


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=str(ROOT / "chiprun_out" / "gemm_rounding.json"))
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("gemm_rounding: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    rec = dict(card=smi, cases=[])
    for dm in D_MODELS:
        for site, k, n in (("q/k/v, out_proj", dm, dm), ("fc1", dm, 4 * dm), ("fc2", 4 * dm, dm)):
            for m in ROWS:
                x = torch.randn(m, k, device="cuda", generator=g).bfloat16()
                w = (0.02 * torch.randn(n, k, device="cuda", generator=g)).bfloat16()
                exact = (x.double() @ w.double().T).to(torch.bfloat16)
                bf16 = F.linear(x, w)
                fp32 = F.linear(x.float(), w.float()).to(torch.bfloat16)
                r = dict(d_model=dm, site=site, m=m, k=k, n=n,
                         cublas_bf16=differ(bf16, exact), float32=differ(fp32, exact),
                         cublas_bf16_kernels=kernels_of(lambda: F.linear(x, w)),
                         float32_kernels=kernels_of(lambda: F.linear(x.float(), w.float())))
                rec["cases"].append(r)
                print(f"d_model {dm} {site} (M {m}, K {k}, N {n}): bf16 GEMM "
                      f"{r['cublas_bf16'][0]:.4f} differ, max {r['cublas_bf16'][1]:.2f} ulp "
                      f"{r['cublas_bf16_kernels']}; float32 GEMM {r['float32'][0]:.4f}, max "
                      f"{r['float32'][1]:.2f} ulp {r['float32_kernels']} [{smi}]", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
