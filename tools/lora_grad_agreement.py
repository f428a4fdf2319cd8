#!/usr/bin/env python3
"""How far a LoRA finetune step's factor gradients on the card and on the
CPU sit from a float64 reference, by compute dtype, factor size and depth.

    python3 tools/lora_grad_agreement.py [--out FILE]

The flagship with ``configs/finetune_lora.yaml``'s adapter block (rank 8 on
all six sites; dropout 0, B 2, T 512), one base drawn on the CPU and loaded
on both devices, random factors: A lecun-sized and B either as large as A
(a delta the size of the dense output it joins) or a hundredth of that (a
finetuned adapter's size). For float32 (TF32 off: the flash kernels' "fma"
route on the card) and bfloat16 compute ("tc"), at 12 and 2 layers: one
forward with targets and its backward on each device through the port's
``GPT``, and once through :func:`lora_grads_float64`, a plain float64
model written here (no code of the port's model). Per factor: the card's
and the CPU's distance from the float64 gradient (normwise, and the
largest difference over the tensor's largest |gradient|), the card's
distance from the CPU's, and the share of elements within the flash
kernels' bf16 gradient limit (``parity.grad_tolerance``), beside the
losses' relative differences and the card's name and power limit. Writes
them to ``--out`` (default ``chiprun_out/lora_grad_agreement.json``).
Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def lora_grads_float64(base: dict, factors: dict, tokens, cfg):
    """The mean next-token cross entropy of ``tokens`` (B, T+1) and its
    gradient with respect to each factor, all in float64 on the CPU: the
    GPT of ``cfg`` (pre-LayerNorm blocks, eps 1e-6; causal softmax
    attention at ``D**-0.5``; a tanh-GELU MLP; the head over the first
    ``vocab_size`` rows) from ``base`` (a ``GPT`` state dict) with
    ``y + alpha/rank · (x Aᵀ) Bᵀ`` at each adapter site (``factors``
    stacked by layer, as ``lora_shapes`` gives them). Returns ``(loss,
    {name: gradient})``."""
    import torch
    import torch.nn.functional as F

    w = {k: v.detach().to("cpu", torch.float64) for k, v in base.items()}
    fac = {k: v.detach().to("cpu", torch.float64).requires_grad_(True)
           for k, v in factors.items()}
    scale = cfg.adapter.alpha / cfg.adapter.rank
    x, y = tokens[:, :-1].cpu(), tokens[:, 1:].cpu()
    b, t = x.shape
    h_, d = cfg.n_heads, cfg.d_model // cfg.n_heads

    def ln(u, name):
        mean = u.mean(-1, keepdim=True)
        var = ((u - mean) ** 2).mean(-1, keepdim=True)
        return (u - mean) / torch.sqrt(var + 1e-6) * w[name + ".weight"] + w[name + ".bias"]

    def dense(u, name, site, i):
        out = u @ w[name + ".weight"].T + w[name + ".bias"]
        if f"{site}_a" not in fac:
            return out
        return out + scale * ((u @ fac[f"{site}_a"][i].T) @ fac[f"{site}_b"][i].T)

    h = w["embed.wte.weight"][x] + w["embed.wpe.weight"][:t]
    mask = torch.ones(t, t, dtype=torch.bool).tril()
    for i in range(cfg.n_layers):
        pre = f"stage.blocks.{i}."
        u = ln(h, pre + "ln_1")
        q, k, v = (dense(u, pre + f"attn.{s}", s, i).view(b, t, h_, d).transpose(1, 2)
                   for s in ("q_proj", "k_proj", "v_proj"))
        s = (q @ k.transpose(-1, -2)) * d ** -0.5
        o = torch.softmax(s.masked_fill(~mask, float("-inf")), -1) @ v
        h = h + dense(o.transpose(1, 2).reshape(b, t, h_ * d), pre + "attn.out_proj",
                      "out_proj", i)
        u = ln(h, pre + "ln_2")
        m = F.gelu(dense(u, pre + "mlp.fc1", "fc1", i), approximate="tanh")
        h = h + dense(m, pre + "mlp.fc2", "fc2", i)
    u = ln(h, "head.ln_f")
    v_ = cfg.vocab_size
    logits = u @ w["head.lm_head.weight"][:v_].T + w["head.lm_head.bias"][:v_]
    loss = F.cross_entropy(logits.reshape(-1, v_), y.reshape(-1))
    loss.backward()
    return float(loss.detach()), {k: p.grad for k, p in fac.items()}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=str(ROOT / "chiprun_out" / "lora_grad_agreement.json"))
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("lora_grad_agreement: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from dtc_tpu_torch.adapters.lora import lora_shapes
    from dtc_tpu_torch.config.loader import load_finetune_config
    from dtc_tpu_torch.models.gpt import GPT
    from dtc_tpu_torch.ops import _build
    from dtc_tpu_torch.parity import grad_tolerance

    _build.build_all(["flash_attention", "flash_attention_tc"])
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    _, mcfg0, _ = load_finetune_config(ROOT / "configs" / "finetune_lora.yaml")
    rec = dict(card=smi, cases=[])

    def dist(got, want):
        d = got - want
        return dict(normwise=float(d.norm() / want.norm()),
                    max_over_max=float(d.abs().max() / want.abs().max()))

    for b_scale in (1.0, 0.01):
        for layers in (12, 2):
            mcfg = dataclasses.replace(mcfg0, dropout=0.0, n_layers=layers)
            g = torch.Generator().manual_seed(3)
            factors = {k: torch.randn(s, generator=g) / s[-1] ** 0.5
                       * (b_scale if k.endswith("_b") else 1.0)
                       for k, s in lora_shapes(mcfg).items()}
            tokens = torch.randint(0, mcfg.vocab_size, (2, mcfg.max_seq_len + 1), generator=g)
            base = GPT(mcfg, device="cpu", seed=0).state_dict()
            l64, g64 = lora_grads_float64(base, factors, tokens, mcfg)
            for compute in ("float32", "bfloat16"):
                ccfg = dataclasses.replace(mcfg, compute_dtype=compute)
                got = {}
                for dev in ("cpu", "cuda"):
                    model = GPT(ccfg, device=dev, seed=0).requires_grad_(False)
                    model.load_state_dict(base)
                    fac = {k: v.clone().to(dev).requires_grad_(True) for k, v in factors.items()}
                    t = tokens.to(dev)
                    loss = model(t[:, :-1], train=True, targets=t[:, 1:], lora=fac)
                    loss.backward()
                    got[dev] = (float(loss.detach()),
                                {k: v.grad.detach().double().cpu() for k, v in fac.items()})
                (l_cpu, g_cpu), (l_gpu, g_gpu) = got["cpu"], got["cuda"]
                sites = {}
                for k, want in g64.items():
                    lim = grad_tolerance(g_cpu[k].reshape(1, -1, want.shape[-1]).to(torch.bfloat16),
                                         1).reshape(want.shape)
                    sites[k] = dict(cpu_vs_f64=dist(g_cpu[k], want), card_vs_f64=dist(g_gpu[k], want),
                                    card_vs_cpu=dist(g_gpu[k], g_cpu[k]),
                                    within_limit=float(((g_gpu[k] - g_cpu[k]).abs() <= lim)
                                                       .double().mean()))
                ratio = {k: s["card_vs_f64"]["normwise"] / s["cpu_vs_f64"]["normwise"]
                         for k, s in sites.items()}
                r = dict(compute=compute, b_scale=b_scale, n_layers=layers, loss_f64=l64,
                         loss_cpu_rel=abs(l_cpu - l64) / l64, loss_card_rel=abs(l_gpu - l64) / l64,
                         sites=sites, card_over_cpu_normwise=ratio)
                rec["cases"].append(r)
                worst = max(sites, key=lambda k: sites[k]["card_vs_cpu"]["normwise"])
                print(f"{compute} B x{b_scale} {layers} layers: loss vs float64 cpu "
                      f"{r['loss_cpu_rel']:.3e} card {r['loss_card_rel']:.3e}; normwise from "
                      f"float64, largest over the factors: cpu "
                      f"{max(s['cpu_vs_f64']['normwise'] for s in sites.values()):.3e} card "
                      f"{max(s['card_vs_f64']['normwise'] for s in sites.values()):.3e}; card/cpu "
                      f"{min(ratio.values()):.3f}-{max(ratio.values()):.3f}; card vs cpu worst "
                      f"{worst} {sites[worst]['card_vs_cpu']['normwise']:.3e} normwise, "
                      f"{sites[worst]['card_vs_cpu']['max_over_max']:.3e} of its largest; "
                      f"within the bf16 limit {min(s['within_limit'] for s in sites.values()):.4f} "
                      f"(least over the factors) [{smi}]", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
