"""Resilience: retry and position-preserving stream healing, the hung-step
watchdog, the anomaly guard's ladder, the typed failures, the recovery bus,
the chaos harness that drives every recovery path on purpose, and elastic
training's virtual hosts, heartbeat monitor and in-memory snapshots."""

from dtc_tpu_torch.resilience.chaos import ChaosInjector
from dtc_tpu_torch.resilience.elastic import (
    HostMonitor,
    VirtualHosts,
    VirtualMesh,
    resize_mesh,
    shrink_mesh,
)
from dtc_tpu_torch.resilience.errors import (
    AnomalyAbort,
    ChaosInjectedError,
    ChaosTargetError,
    DataStreamError,
    ElasticAbort,
    ResilienceError,
    SnapshotIncompleteError,
)
from dtc_tpu_torch.resilience.events import RecoveryBus
from dtc_tpu_torch.resilience.snapshot import (
    InMemorySnapshot,
    RedundancyPlan,
    SnapshotStore,
)

__all__ = [
    "AnomalyAbort",
    "ChaosInjectedError",
    "ChaosInjector",
    "ChaosTargetError",
    "DataStreamError",
    "ElasticAbort",
    "HostMonitor",
    "InMemorySnapshot",
    "RecoveryBus",
    "RedundancyPlan",
    "ResilienceError",
    "SnapshotIncompleteError",
    "SnapshotStore",
    "VirtualHosts",
    "VirtualMesh",
    "resize_mesh",
    "shrink_mesh",
]
