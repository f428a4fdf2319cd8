"""Resilience: retry and position-preserving stream healing, the hung-step
watchdog, the anomaly guard's ladder, the typed failures, the recovery bus
and the chaos harness that drives every recovery path on purpose."""

from dtc_tpu_torch.resilience.chaos import ChaosInjector
from dtc_tpu_torch.resilience.errors import (
    AnomalyAbort,
    ChaosInjectedError,
    ChaosTargetError,
    DataStreamError,
    ResilienceError,
)
from dtc_tpu_torch.resilience.events import RecoveryBus

__all__ = [
    "AnomalyAbort",
    "ChaosInjectedError",
    "ChaosInjector",
    "ChaosTargetError",
    "DataStreamError",
    "RecoveryBus",
    "ResilienceError",
]
