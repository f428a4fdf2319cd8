"""YAML -> dataclass config loading with strict key validation.

Unknown keys raise with the file path and the valid keys, and nested
dataclasses given as mappings are built recursively. The machines the
port runs on need not have PyYAML, so this module carries its own parser
for the YAML subset ``configs/*.yaml`` use (:func:`parse_yaml`).
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Any, Type, TypeVar

T = TypeVar("T")

# Scalar resolution follows PyYAML's YAML 1.1 implicit resolvers, so a
# value types the same here as under ``yaml.safe_load`` (``1e-3`` with no
# dot stays a string, ``on``/``off`` are booleans).
_BOOL = re.compile(
    r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
    r"|on|On|ON|off|Off|OFF)$"
)
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
    r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$"
)
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$"
)


def _sexagesimal(s: str, conv) -> Any:
    sign = -1 if s.startswith("-") else 1
    total = conv(0)
    for part in s.lstrip("+-").split(":"):
        total = total * 60 + conv(part)
    return sign * total


def _scalar(tok: str) -> Any:
    """Type one plain or quoted scalar the way PyYAML's SafeLoader does."""
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "'\"":
        body = tok[1:-1]
        if tok[0] == "'":
            return body.replace("''", "'")
        if "\\" in body:
            raise ValueError(f"escape sequences are not supported: {tok!r}")
        return body
    if _NULL.match(tok):
        return None
    if _BOOL.match(tok):
        return tok in _TRUE
    if _INT.match(tok):
        s = tok.replace("_", "")
        if ":" in s:
            return _sexagesimal(s, int)
        sign = -1 if s.startswith("-") else 1
        body = s.lstrip("+-")
        if body.startswith("0b"):
            return sign * int(body[2:], 2)
        if body.startswith("0x"):
            return sign * int(body[2:], 16)
        if len(body) > 1 and body.startswith("0"):
            return sign * int(body, 8)
        return sign * int(body)
    if _FLOAT.match(tok):
        s = tok.replace("_", "").lower()
        if s.endswith(".inf"):
            return float("-inf") if s.startswith("-") else float("inf")
        if s.endswith(".nan"):
            return float("nan")
        if ":" in s:
            return _sexagesimal(s, float)
        return float(s)
    return tok


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment (start of line or after whitespace, outside
    quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _value(text: str, where: str) -> Any:
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"{where}: unterminated flow list {text!r}")
        inner = text[1:-1].strip()
        if not inner:
            return []
        items = [t.strip() for t in inner.split(",")]
        if any(not t or t[0] in "[{" for t in items):
            raise ValueError(f"{where}: only flat flow lists are supported")
        return [_scalar(t) for t in items]
    if text[:1] in ("{", "|", ">", "&", "*", "!", "-") and not (
        _INT.match(text) or _FLOAT.match(text)
    ):
        raise ValueError(f"{where}: unsupported YAML construct {text!r}")
    return _scalar(text)


def parse_yaml(text: str) -> Any:
    """Parse the YAML subset of ``configs/*.yaml``: comments, ``key: value``
    scalars, mappings nested by indentation, and flat flow lists. Returns
    None for a document with no content (as ``yaml.safe_load`` does);
    anything outside the subset raises ``ValueError``."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        body = _strip_comment(raw).rstrip()
        if not body.strip() or body.strip() in ("---", "..."):
            continue
        if "\t" in body[: len(body) - len(body.lstrip())]:
            raise ValueError(f"line {n}: tab indentation")
        lines.append((n, len(body) - len(body.lstrip()), body.strip()))
    if not lines:
        return None
    out, pos = _mapping(lines, 0, lines[0][1])
    if pos != len(lines):
        raise ValueError(f"line {lines[pos][0]}: bad indentation")
    return out


def _mapping(lines, pos: int, indent: int):
    out: dict[str, Any] = {}
    while pos < len(lines):
        n, ind, body = lines[pos]
        if ind < indent:
            break
        if ind > indent:
            raise ValueError(f"line {n}: bad indentation")
        m = re.match(r"^([^\s:][^:]*?|'[^']*'|\"[^\"]*\")\s*:(?:\s+(.*))?$", body)
        if m is None:
            raise ValueError(f"line {n}: expected 'key: value', got {body!r}")
        key = _scalar(m.group(1).strip())
        if key in out:
            raise ValueError(f"line {n}: duplicate key {key!r}")
        pos += 1
        rest = m.group(2)
        if rest is None or not rest.strip():
            if pos < len(lines) and lines[pos][1] > ind:
                out[key], pos = _mapping(lines, pos, lines[pos][1])
            else:
                out[key] = None
        else:
            out[key] = _value(rest, f"line {n}")
    return out, pos


def _build(cls: Type[T], data: dict[str, Any], source: str) -> T:
    if not isinstance(data, dict):
        raise TypeError(f"{source}: expected a mapping for {cls.__name__}, got {type(data)}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise ValueError(
            f"{source}: unknown key(s) {sorted(unknown)} for {cls.__name__}; "
            f"valid keys: {sorted(fields)}"
        )
    kwargs: dict[str, Any] = {}
    for name, value in data.items():
        fcls = _resolve_dataclass(fields[name].type)
        if fcls is not None and isinstance(value, dict):
            kwargs[name] = _build(fcls, value, f"{source}.{name}")
        else:
            kwargs[name] = value
    return cls(**kwargs)


def _resolve_dataclass(ftype: Any) -> type | None:
    """Map a (possibly string-annotated) field type to a dataclass."""
    from dtc_tpu_torch.config import schema

    if isinstance(ftype, str):
        ftype = getattr(schema, ftype, None)
    if isinstance(ftype, type) and dataclasses.is_dataclass(ftype):
        return ftype
    return None


def load_yaml_dataclass(path: str | Path, cls: Type[T], overrides: dict[str, Any] | None = None) -> T:
    """Load one YAML file into one dataclass, with optional key overrides."""
    path = Path(path)
    data = parse_yaml(path.read_text()) or {}
    if overrides:
        data.update(overrides)
    return _build(cls, data, str(path))


def load_serve_config(
    serve_config_path: str | Path,
    model_config_path: str | Path | None = None,
    serve_overrides: dict[str, Any] | None = None,
    model_overrides: dict[str, Any] | None = None,
):
    """Load the (serve, model) config pair; the model config defaults to
    the sibling ``model_config.yaml``."""
    from dtc_tpu_torch.config.schema import ModelConfig, ServeConfig

    serve_config_path = Path(serve_config_path)
    model_config_path = Path(
        model_config_path or serve_config_path.parent / "model_config.yaml"
    )
    serve_cfg = load_yaml_dataclass(
        serve_config_path, ServeConfig, overrides=serve_overrides
    )
    model_cfg = load_yaml_dataclass(
        model_config_path, ModelConfig, overrides=model_overrides
    )
    return serve_cfg, model_cfg


def load_router_config(
    router_config_path: str | Path,
    model_config_path: str | Path | None = None,
):
    """Load the (router, model) config pair of the serving fleet; the model
    config defaults to the sibling ``model_config.yaml``, and each
    replica's engine config nests under the router YAML's ``serve:``
    block."""
    from dtc_tpu_torch.config.schema import ModelConfig, RouterConfig

    router_config_path = Path(router_config_path)
    model_config_path = Path(
        model_config_path or router_config_path.parent / "model_config.yaml"
    )
    router_cfg = load_yaml_dataclass(router_config_path, RouterConfig)
    model_cfg = load_yaml_dataclass(model_config_path, ModelConfig)
    return router_cfg, model_cfg


def load_config(
    train_config_path: str | Path,
    model_config_path: str | Path | None = None,
    optim_config_path: str | Path | None = None,
    model_overrides: dict[str, Any] | None = None,
):
    """Load the (train, model, optim) config triple; the model and optim
    configs default to the siblings ``model_config.yaml`` and
    ``optim_config.yaml`` of the train config."""
    from dtc_tpu_torch.config.schema import ModelConfig, OptimConfig, TrainConfig

    train_config_path = Path(train_config_path)
    cfg_dir = train_config_path.parent
    model_config_path = Path(model_config_path or cfg_dir / "model_config.yaml")
    optim_config_path = Path(optim_config_path or cfg_dir / "optim_config.yaml")

    train_cfg = load_yaml_dataclass(train_config_path, TrainConfig)
    model_cfg = load_yaml_dataclass(model_config_path, ModelConfig, overrides=model_overrides)
    optim_cfg = load_yaml_dataclass(optim_config_path, OptimConfig)
    return train_cfg, model_cfg, optim_cfg


def load_finetune_config(
    finetune_config_path: str | Path,
    model_config_path: str | Path | None = None,
    optim_config_path: str | Path | None = None,
    model_overrides: dict[str, Any] | None = None,
):
    """Load the (train, model, optim) triple of a LoRA finetune config
    (``configs/finetune_lora.yaml``): a TrainConfig file plus one top-level
    ``adapter:`` block, which is lifted onto the model config, where
    ``AdapterConfig`` lives (an ``adapter`` key in ``model_overrides``
    wins). The model and optim configs default to the siblings, as in
    :func:`load_config`."""
    from dtc_tpu_torch.config.schema import ModelConfig, OptimConfig, TrainConfig

    finetune_config_path = Path(finetune_config_path)
    cfg_dir = finetune_config_path.parent
    model_config_path = Path(model_config_path or cfg_dir / "model_config.yaml")
    optim_config_path = Path(optim_config_path or cfg_dir / "optim_config.yaml")

    raw = parse_yaml(finetune_config_path.read_text()) or {}
    adapter = raw.pop("adapter", None)
    train_cfg = _build(TrainConfig, raw, str(finetune_config_path))
    overrides = dict(model_overrides or {})
    if adapter is not None and "adapter" not in overrides:
        overrides["adapter"] = adapter
    model_cfg = load_yaml_dataclass(model_config_path, ModelConfig, overrides=overrides)
    optim_cfg = load_yaml_dataclass(optim_config_path, OptimConfig)
    return train_cfg, model_cfg, optim_cfg
