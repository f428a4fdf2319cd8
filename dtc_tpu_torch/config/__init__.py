"""Configuration: the port's own copy of the dataclasses and YAML loading."""

from dtc_tpu_torch.config.loader import (
    load_config,
    load_finetune_config,
    load_pool_config,
    load_router_config,
    load_serve_config,
    load_yaml_dataclass,
    parse_yaml,
)
from dtc_tpu_torch.config.schema import (
    DTYPE_BYTES,
    AdapterConfig,
    ChaosConfig,
    ModelConfig,
    OptimConfig,
    PoolConfig,
    RouterConfig,
    ServeConfig,
    SloConfig,
    SpecConfig,
    StreamRetryConfig,
    TrainConfig,
    WatchdogConfig,
)

__all__ = [
    "DTYPE_BYTES", "AdapterConfig", "ChaosConfig", "ModelConfig",
    "OptimConfig", "PoolConfig", "RouterConfig", "ServeConfig", "SloConfig", "SpecConfig",
    "StreamRetryConfig", "TrainConfig", "WatchdogConfig", "load_config",
    "load_finetune_config", "load_pool_config", "load_router_config", "load_serve_config",
    "load_yaml_dataclass", "parse_yaml",
]
