"""The resource pool: one manager over the serving fleet and the elastic
trainer, trading virtual hosts through typed transitions
(:mod:`dtc_tpu_torch.pool.manager`; ``configs/pool_config.yaml``;
``python -m dtc_tpu_torch.pool``)."""

from dtc_tpu_torch.pool.manager import (
    POOL_ROUTER_PROC,
    POOL_TRAIN_PROC,
    PoolManager,
    PoolTransition,
)

__all__ = ["POOL_ROUTER_PROC", "POOL_TRAIN_PROC", "PoolManager", "PoolTransition"]
