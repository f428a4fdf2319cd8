"""The port's config copy and YAML loader against the JAX package's and
PyYAML, plus the port's import isolation and device rule."""

import ast
import dataclasses
import glob
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import yaml

from dtc_tpu.config import loader as jloader
from dtc_tpu.config import schema as jschema
from dtc_tpu_torch.config import loader as tloader
from dtc_tpu_torch.config import schema as tschema

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted(Path(p).name for p in glob.glob(str(ROOT / "configs" / "*.yaml")))
MODEL_CONFIGS = [n for n in CONFIGS if n.startswith("model_")]


@pytest.mark.parametrize("name", CONFIGS)
def test_yaml_subset_parser_equals_pyyaml(name):
    text = (ROOT / "configs" / name).read_text()
    assert tloader.parse_yaml(text) == yaml.safe_load(text)


def test_yaml_scalars_type_as_pyyaml():
    text = "\n".join([
        "a: 1e-3", "b: 3.0e-4", "c: on", "d: ~", "e: 0x1f", "f: 010",
        "g: -7", "h: .5", "i: 'x # y'", 'j: "q"', "k: null", "l: No",
        "m: 1_000", "n: .inf", "o: 2.", "p: [1, two, 3.5, true]", "q: []",
        "r:", "s:", "  t: 1", "  u:", "    v: w",
    ])
    assert tloader.parse_yaml(text) == yaml.safe_load(text)
    assert tloader.parse_yaml("# only a comment\n") is None


@pytest.mark.parametrize("text", ["a:\n  - 1\n", "a: {b: 1}\n", "a: 1\n   b: 2\n"])
def test_yaml_outside_the_subset_raises(text):
    with pytest.raises(ValueError):
        tloader.parse_yaml(text)


@pytest.mark.parametrize("name", MODEL_CONFIGS)
def test_model_configs_load_equal(name):
    path = ROOT / "configs" / name
    j = jloader.load_yaml_dataclass(path, jschema.ModelConfig)
    t = tloader.load_yaml_dataclass(path, tschema.ModelConfig)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for prop in ("head_dim", "kv_store_dtype", "kv_quantized", "padded_vocab_size"):
        assert getattr(t, prop) == getattr(j, prop)


@pytest.mark.parametrize("name", [n for n in CONFIGS if n.startswith("train_config")])
def test_train_config_triples_load_equal(name):
    """The (train, model, optim) triple with sibling defaults, as JAX's
    ``load_config`` builds it."""
    path = ROOT / "configs" / name
    for j, t in zip(jloader.load_config(path), tloader.load_config(path)):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("cls,kw", [
    ("OptimConfig", dict(lr=1e-3, weight_decay=0.0, grad_clip=1.0, schedule="linear")),
    ("OptimConfig", dict(lr=1e-3, weight_decay=0.0, grad_clip=1.0, precision="fp16")),
    ("TrainConfig", dict(seed=0, parallel="zero", batch=8, steps=1, log_every=1, output_dir="")),
    ("TrainConfig", dict(seed=0, parallel="dp", batch=7, steps=1, log_every=1, output_dir="",
                         pp_microbatches=2)),
    ("ResilienceConfig", dict(checkpoint_keep_n=0)),
    ("ElasticConfig", dict(dead_hosts=(0, 1))),
])
def test_train_config_validators_match(cls, kw):
    with pytest.raises(ValueError):
        getattr(jschema, cls)(**kw)
    with pytest.raises(ValueError):
        getattr(tschema, cls)(**kw)


def test_serve_config_pair_loads_equal():
    path = ROOT / "configs" / "serve_config.yaml"
    js, jm = jloader.load_serve_config(path)
    ts, tm = tloader.load_serve_config(path)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)


def test_nested_serve_and_adapter_blocks_load_equal():
    """The serve block of the router config and the adapter block of the
    finetune config build the same dataclasses in both packages."""
    raw = yaml.safe_load((ROOT / "configs" / "router_config.yaml").read_text())
    j = jloader._build(jschema.ServeConfig, raw["serve"], "serve")
    t = tloader._build(tschema.ServeConfig, raw["serve"], "serve")
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    raw = yaml.safe_load((ROOT / "configs" / "finetune_lora.yaml").read_text())
    j = jloader._build(jschema.AdapterConfig, raw["adapter"], "adapter")
    t = tloader._build(tschema.AdapterConfig, raw["adapter"], "adapter")
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("kw", [
    dict(kv_cache_dtype="fp8"), dict(decode_attention="pallas"),
    dict(n_heads=5), dict(remat="sometimes"),
])
def test_model_config_validators_match(kw):
    base = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                max_seq_len=32)
    base.update(kw)
    with pytest.raises(ValueError):
        jschema.ModelConfig(**base)
    with pytest.raises(ValueError):
        tschema.ModelConfig(**base)


def _port_modules():
    pkg = ROOT / "dtc_tpu_torch"
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in pkg.rglob("*.py")
    )


def test_port_imports_no_jax_flax_or_dtc_tpu():
    """Importing every port module (the adapters package included) in a
    fresh interpreter loads no jax, flax, optax, click, yaml or dtc_tpu
    module."""
    assert {"dtc_tpu_torch.adapters", "dtc_tpu_torch.adapters.lora",
            "dtc_tpu_torch.adapters.store"} <= set(_port_modules())
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'click', 'yaml', 'dtc_tpu')]\n"
        "print(len(bad)); assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0"


def test_port_source_has_no_forbidden_imports():
    forbidden = ("jax", "jaxlib", "flax", "optax", "click", "yaml", "dtc_tpu")
    files = (list((ROOT / "dtc_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + list((ROOT / "tools").glob("*.py")))
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in forbidden, f"{path}: import {n}"


def test_gpt_without_device_needs_a_card(monkeypatch):
    """With no card and no explicit CPU request the entry points raise;
    they never drift to the CPU."""
    from dtc_tpu_torch.models.gpt import GPT, resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tschema.ModelConfig(vocab_size=97, d_model=64, n_layers=1, n_heads=4,
                              d_ff=128, max_seq_len=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPT(cfg)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert GPT(cfg, device="cpu").device.type == "cpu"
