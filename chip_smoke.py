#!/usr/bin/env python3
"""Chip smoke for the PyTorch port: proves on one NVIDIA GPU that the port
builds its kernels from this checkout, that each kernel agrees with its
plain PyTorch version, and that the serving main path runs through them.

    python3 chip_smoke.py [--out results.json] [--seed 0]

Phases (each prints its own lines; any failure exits non-zero):

1. Device: ``nvidia-smi`` name and power limit, ``torch.cuda`` device.
2. Build: every kernel library with ``nvcc`` (one process per source, all
   started together), with the compiler's register / shared-memory report.
3. Kernels vs plain, at the flagship decode shape (B 4, S 512, H 16,
   D 32) plus an S = 8192 case: the error against the plain version
   within its limit (float32 1e-5; bfloat16 a few ulps of each head's
   largest output, ``dtc_tpu_torch.parity.attention_tolerance``), planted
   faults in the plain version landing over that limit, and device times
   of the kernel, the plain version and the library yardstick (each from
   200 calls replayed as one CUDA graph between CUDA events) beside the
   byte/operation bound; the wrapper's time per Python call besides.
4. Serve the flagship as configured (``configs/serve_config.yaml`` +
   ``configs/model_config.yaml``, random weights from ``--seed``): six
   requests, two sharing a 16-token prefix, 64 new tokens each. Every
   request must finish with 64 tokens, and the decode-attention kernel
   must have launched exactly n_layers times per decode iteration.
5. Serve the flagship in float32 compute: every request's tokens equal the
   port's ``generate()`` on the same prompt.

Prints one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: Published H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and
#: operations/s by input type (float32 outside the tensor cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(f"[chip-smoke] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0 and out.stdout.strip(), f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 20) -> float:
    """Mean ms per call of ``fn`` from CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


@functools.cache
def _capture_stream():
    """One stream for every capture: each stream that runs a cuBLAS call
    keeps its own workspace for the life of the process."""
    import torch

    return torch.cuda.Stream()


def graph_ms(fn, iters: int) -> float:
    """Mean ms per call of ``fn`` on the device alone: ``iters`` calls
    captured in one CUDA graph, replayed between CUDA events, so the
    launches run back to back with no host dispatch between them."""
    import torch

    side = _capture_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    graph.replay()
    e.record()
    torch.cuda.synchronize()
    graph.reset()  # frees the graph's memory pool
    return s.elapsed_time(e) / iters


def ptxas_report(text: str):
    """(instance, "N registers, smem, spills") per compiled kernel from
    ``nvcc -Xptxas -v`` output; template instances read as their
    ``<int, int, int>`` arguments."""
    out, inst, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            args = re.findall(r"Li(\d+)E", m.group(1))
            inst = f"<{', '.join(args)}>" if args else m.group(1)
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and inst:
            out.append((inst, line.split(":", 1)[-1].strip() + "; " + spill))
            inst = None
    return out


# ---------------------------------------------------------------------------
# phase 3: the decode-attention kernel against its plain version
# ---------------------------------------------------------------------------

def decode_bound(b, s, h, d, starts, qdtype, kvdtype):
    """Least time for the call on these inputs: the bytes it must move
    (q, K and V up to each row's frontier, the int8 scales, the frontier,
    the output) over HBM bandwidth, against its operations (2 per
    multiply-add, q·K and p·V) over the peak rate of q's type."""
    el = {"float32": 4, "bfloat16": 2, "int8": 1}
    visible = sum(min(st + 1, s) for st in starts)
    hd = h * d
    nbytes = (
        2 * b * hd * el[qdtype]                 # q in, out
        + 2 * visible * hd * el[kvdtype]        # K, V
        + (2 * visible * h * 4 if kvdtype == "int8" else 0)
        + 4 * len(starts)
    )
    ops = 4 * visible * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[qdtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def kernel_case(name, b, s, h, d, qdtype, kvdtype, starts, per_row, seed, iters):
    import torch
    import torch.nn.functional as F

    from dtc_tpu_torch.ops import decode_attention as da
    from dtc_tpu_torch.parity import BF16_ULPS, FP32_ATOL, attention_tolerance

    rule = (f"{FP32_ATOL:g} absolute" if qdtype == "float32"
            else f"{BF16_ULPS} bf16 ulps of each head's max |output|")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    qdt = getattr(torch, qdtype)
    q = torch.randn(b, 1, h * d, device=dev, generator=g).to(qdt)
    kf = torch.randn(b, s, h * d, device=dev, generator=g)
    vf = torch.randn(b, s, h * d, device=dev, generator=g)
    kw = {}
    if kvdtype == "int8":
        k, ks = da.quantize_kv(kf, h)
        v, vs = da.quantize_kv(vf, h)
        kw = dict(k_scale=ks.contiguous(), v_scale=vs.contiguous())
    else:
        k, v = kf.to(getattr(torch, kvdtype)), vf.to(getattr(torch, kvdtype))
    start = torch.tensor(starts if per_row else starts[0], dtype=torch.int32, device=dev)
    row_starts = starts if per_row else [starts[0]] * b

    got = da.fused_decode_attention(q, k, v, start, h=h, d=d, **kw)
    want = da.decode_attention_reference(q, k, v, start, h=h, d=d, **kw)
    torch.cuda.synchronize()
    check(got.shape == q.shape and got.dtype == q.dtype, f"{name}: bad output")
    check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite output")
    limit = attention_tolerance(want, h).to(dev)
    diff = (got.float() - want.float()).abs()
    err, ratio = diff.max().item(), (diff / limit).max().item()
    log(f"kernel {name}: max_abs_err {err:.3e}, {ratio:.3f} of its limit "
        f"({limit.min().item():.3e}..{limit.max().item():.3e}; {rule})")
    check(ratio <= 1.0, f"{name}: error {err} over its limit")

    # What the limit can see: the plain version with a planted fault, on
    # the same inputs, must land over it. Faults: every row one visible
    # column short; past one 4096-position chunk, the later chunks dropped.
    faults = {"one column short": [max(x - 1, 0) for x in row_starts]}
    if s > 4096:
        faults["chunks after the first dropped"] = [min(x, 4095) for x in row_starts]
    fault_ratio = {}
    for fname, fstarts in faults.items():
        bad = da.decode_attention_reference(
            q, k, v, torch.tensor(fstarts, dtype=torch.int32, device=dev), h=h, d=d, **kw)
        fdiff = (bad.float() - want.float()).abs()
        fault_ratio[fname] = (fdiff / limit).max().item()
        log(f"kernel {name}: planted fault '{fname}': max_abs_err "
            f"{fdiff.max().item():.3e}, {fault_ratio[fname]:.3f} of the limit")
        check(fault_ratio[fname] > 1.0, f"{name}: the limit misses the fault '{fname}'")

    kernel_ms = graph_ms(lambda: da.fused_decode_attention(q, k, v, start, h=h, d=d, **kw), iters)
    wrapper_ms = cuda_ms(lambda: da.fused_decode_attention(q, k, v, start, h=h, d=d, **kw), iters)
    plain_ms = graph_ms(lambda: da.decode_attention_reference(q, k, v, start, h=h, d=d, **kw), iters)
    library_ms = None
    if kvdtype != "int8":
        # Yardstick only: one library call computing the same function.
        q4 = q.view(b, 1, h, d).transpose(1, 2)
        k4 = k.view(b, s, h, d).transpose(1, 2).to(qdt)
        v4 = v.view(b, s, h, d).transpose(1, 2).to(qdt)
        st = torch.tensor(row_starts, device=dev)
        mask = (torch.arange(s, device=dev)[None, :] <= st[:, None])[:, None, None, :]
        library_ms = graph_ms(
            lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask), iters
        )
    bound_ms, bound_by, nbytes = decode_bound(b, s, h, d, row_starts, qdtype, kvdtype)
    log(
        f"kernel {name}: kernel_ms {kernel_ms:.6f} wrapper_ms {wrapper_ms:.6f} "
        f"plain_ms {plain_ms:.6f} library_ms "
        f"{'null' if library_ms is None else f'{library_ms:.6f}'} "
        f"bound_ms {bound_ms:.6f} ({bound_by}, {nbytes} B)"
    )
    return dict(
        case=name, b=b, s=s, h=h, d=d, q_dtype=qdtype, kv_dtype=kvdtype,
        starts=starts, per_row=per_row, max_abs_err=err, err_over_limit=ratio,
        limit=rule, fault_over_limit=fault_ratio,
        ms=kernel_ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
        bytes=nbytes,
    )


# ---------------------------------------------------------------------------
# phases 4-5: the serving main path
# ---------------------------------------------------------------------------

def flagship_requests(vocab: int, seed: int, max_new: int):
    import numpy as np

    from dtc_tpu_torch.serve import Request

    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, vocab, size=16).tolist()
    lengths = [8, 40, 64, 100, 31, 77]
    reqs = []
    for i, n in enumerate(lengths):
        shared = i in (1, 2)
        body = rng.randint(0, vocab, size=n - (16 if shared else 0)).tolist()
        reqs.append(Request(
            rid=f"r{i}", prompt=(prefix + body) if shared else body,
            max_new_tokens=max_new, shared_prefix_len=16 if shared else 0,
        ))
    return reqs


def serve(serve_cfg, model_cfg, seed: int, reqs, device: str = "cuda"):
    import torch

    from dtc_tpu_torch.models.gpt import GPT
    from dtc_tpu_torch.ops import decode_attention as da
    from dtc_tpu_torch.serve import Request, ServingEngine

    cuda = device == "cuda"
    model = GPT(model_cfg, device=device, seed=seed)
    # Warm-up: one short request through a throwaway engine, so the timed
    # run below does not pay first-call costs (cuBLAS workspaces, lazy
    # module loading).
    warm = ServingEngine(model, serve_cfg)
    warm.submit(Request(rid="warm", prompt=list(reqs[0].prompt), max_new_tokens=4))
    warm.run()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    eng = ServingEngine(model, serve_cfg)
    for r in reqs:
        eng.submit(r)
    da.launches = 0                      # the main path starts here
    t0 = time.perf_counter()
    res = eng.run(max_steps=10_000)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = da.launches               # ...and ends here
    return model, eng, res, wall, launches


def profile_decode(model, serve_cfg, reqs, iterations: int = 16):
    """Device time by kernel over ``iterations`` steady decode iterations
    of a full batch (torch.profiler, CUDA activity), against the host
    wall time of the same window: the device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dtc_tpu_torch.serve import ServingEngine

    eng = ServingEngine(model, serve_cfg)
    for r in reqs[: serve_cfg.slots]:
        eng.submit(r)
    for _ in range(3):  # admissions + first decode iterations
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iterations):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    rows = []  # kernels only: CPU-op rows repeat their kernels' time
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((ev.key, dev_us, ev.count))
    rows.sort(key=lambda r: -r[1])
    busy_s = sum(r[1] for r in rows) / 1e6
    return dict(
        iterations=iterations, wall_s=wall, device_busy_s=busy_s,
        busy_share=busy_s / wall, kernel_launches=sum(r[2] for r in rows),
        top=[dict(name=k[:120], device_ms=us / 1e3, count=c) for k, us, c in rows[:15]],
    )


def percentile(xs, q):
    """Nearest-rank percentile (the ceil(q*n)-th smallest)."""
    xs = sorted(xs)
    return xs[max(0, math.ceil(q * len(xs)) - 1)]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="", help="write every measured number to this JSON file")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", action="store_true",
                   help="also profile steady bf16 decode iterations (device busy share)")
    args = p.parse_args()

    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "dtc_tpu_torch" / "csrc").is_dir() or not (ROOT / "configs").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    record: dict = {}
    try:
        # 1. device
        smi = nvidia_smi_line()
        kind = torch.cuda.get_device_name(0)
        log(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.device_count()} device(s)); nvidia-smi: {smi}")
        record["device"] = dict(name=kind, nvidia_smi=smi, torch=torch.__version__,
                                cuda=torch.version.cuda)

        # 2. build
        from dtc_tpu_torch.ops import _build

        took = _build.build_all()
        for name, sec in took.items():
            log(f"build {name}: {sec:.1f} s -> {_build.library_path(name).name}")
            for inst, rep in ptxas_report(_build.log_path(name).read_text()):
                log(f"  ptxas <q dtype, kv dtype, head_dim> = {inst}: {rep}")
        record["build_s"] = took

        # 3. kernels vs plain
        from dtc_tpu_torch.ops import decode_attention as da

        flagship = (4, 512, 16, 32)
        cases = [
            ("bf16_per_row", *flagship, "bfloat16", "bfloat16", [0, 37, 511, 600], True),
            ("bf16_scalar", *flagship, "bfloat16", "bfloat16", [300], False),
            ("fp32_per_row", *flagship, "float32", "float32", [0, 37, 511, 600], True),
            ("int8_per_row", *flagship, "bfloat16", "int8", [0, 37, 511, 600], True),
            ("bf16_s8192", 4, 8192, 16, 32, "bfloat16", "bfloat16", [0, 4095, 5000, 9000], True),
        ]
        results = [
            kernel_case(name, b, s, h, d, qd, kd, st, pr, seed=args.seed + i, iters=200)
            for i, (name, b, s, h, d, qd, kd, st, pr) in enumerate(cases)
        ]
        record["kernel_cases"] = results

        # 4. serve the flagship as configured
        from dtc_tpu_torch.config.loader import load_serve_config

        scfg, mcfg = load_serve_config(ROOT / "configs" / "serve_config.yaml")
        max_new = 64
        reqs = flagship_requests(mcfg.vocab_size, args.seed, max_new)
        mem_base = torch.cuda.memory_allocated()  # what earlier phases still hold
        log(f"device memory still allocated before serving: {mem_base} B")
        model, eng, res, wall, launches = serve(scfg, mcfg, args.seed, reqs)
        steps = eng.counters["serve_decode_steps"]
        for r in reqs:
            rr = res[r.rid]
            check(rr.state.value == "done", f"{r.rid}: {rr.state.value} ({rr.error})")
            check(len(rr.tokens) == max_new, f"{r.rid}: {len(rr.tokens)} tokens")
            check(all(0 <= t < mcfg.vocab_size for t in rr.tokens), f"{r.rid}: token out of vocab")
        check(eng.counters["serve_prefix_builds"] == 1 and eng.counters["serve_prefix_hits"] == 1,
              f"prefix store not shared: {dict(eng.counters)}")
        check(launches == mcfg.n_layers * steps and steps > 0,
              f"decode attention launched {launches} times for {steps} decode "
              f"iterations (want {mcfg.n_layers} per iteration)")
        ttft = [res[r.rid].ttft_s for r in reqs]
        mspt = [res[r.rid].ms_per_token for r in reqs]
        n_tok = sum(len(res[r.rid].tokens) for r in reqs)
        serve_rec = dict(
            requests=len(reqs), tokens=n_tok, decode_iterations=steps,
            kernel_launches=launches, wall_s=wall,
            ttft_p50_s=percentile(ttft, 0.5), ttft_max_s=max(ttft),
            ms_per_token_mean=sum(mspt) / len(mspt), tokens_per_s=n_tok / wall,
            peak_allocated=torch.cuda.max_memory_allocated() - mem_base,
            counters=dict(eng.counters), card=smi,
        )
        record["serve_bf16"] = serve_rec
        log(f"serve bf16: 6/6 done, {n_tok} tokens, {steps} decode iterations, "
            f"{launches} kernel launches (= {mcfg.n_layers} x {steps}) [{smi}]")
        log(f"serve bf16: ttft_p50 {serve_rec['ttft_p50_s']:.6f} s, ms/token "
            f"{serve_rec['ms_per_token_mean']:.6f}, tokens/s {serve_rec['tokens_per_s']:.3f}, "
            f"peak allocated {serve_rec['peak_allocated']} B [{smi}]")
        main_launches = launches
        if args.profile:
            prof = profile_decode(model, scfg, flagship_requests(mcfg.vocab_size, args.seed, max_new))
            record["profile_bf16"] = prof
            log(f"profile bf16: {prof['iterations']} decode iterations, wall "
                f"{prof['wall_s']:.6f} s, device busy {prof['device_busy_s']:.6f} s "
                f"(share {prof['busy_share']:.4f}), {prof['kernel_launches']} kernels [{smi}]")
            for row in prof["top"]:
                log(f"  {row['device_ms']:.4f} ms x{row['count']} {row['name']}")
        del model, eng
        torch.cuda.empty_cache()

        # 5. serve in float32: token-identical to generate()
        from dtc_tpu_torch.generate import generate

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _, mcfg32 = load_serve_config(
            ROOT / "configs" / "serve_config.yaml",
            model_overrides={"compute_dtype": "float32"},
        )
        reqs32 = flagship_requests(mcfg.vocab_size, args.seed, max_new)
        model, eng, res, wall, _ = serve(scfg, mcfg32, args.seed, reqs32)
        same = 0
        for r in reqs32:
            ref = generate(model, [list(r.prompt)], max_new)[0].tolist()
            ok = res[r.rid].state.value == "done" and res[r.rid].tokens == ref
            same += ok
            log(f"serve fp32 {r.rid}: {'matches generate' if ok else 'MISMATCH vs generate'}")
        record["serve_fp32"] = dict(matching=same, requests=len(reqs32), wall_s=wall,
                                    tokens_per_s=sum(len(res[r.rid].tokens) for r in reqs32) / wall)
        check(same == len(reqs32), f"fp32 serve: {same}/{len(reqs32)} requests match generate")

        main = results[0]
        kernels = [dict(
            name="decode_attention", route="cuda",
            source="dtc_tpu_torch/csrc/decode_attention.cu",
            replaces="dtc_tpu/ops/decode_attention.py:150",
            also_replaces="dtc_tpu/ops/decode_attention.py:189",
            launches=main_launches, max_abs_err=max(c["max_abs_err"] for c in results),
            ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
            bound_by=main["bound_by"], library_ms=main["library_ms"],
        )]
        record["kernels"] = kernels
    except Exception:
        traceback.print_exc()
        log("FAIL")
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(record, indent=1, default=str))
        return 1

    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
