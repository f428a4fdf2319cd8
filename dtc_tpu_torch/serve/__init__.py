"""Continuous-batching serving runtime over the paged KV cache, and the
serving fleet: replicas of the engine behind a tenant-aware router."""

from dtc_tpu_torch.serve.engine import ServingEngine, init_slot_cache
from dtc_tpu_torch.serve.paged_cache import PageAllocator, kv_token_bytes, pages_for
from dtc_tpu_torch.serve.replica import EngineReplica, ReplicaState
from dtc_tpu_torch.serve.request import (
    TERMINAL_STATES,
    AdapterStoreFullError,
    DeadlineExceededError,
    EngineClosedError,
    FleetSaturatedError,
    QueueFullError,
    ReplicaUnreachableError,
    Request,
    RequestFailedError,
    RequestState,
    RequestTooLargeError,
    ServeError,
    ServeResult,
    ShedError,
    TransientStepError,
    UnknownAdapterError,
)
from dtc_tpu_torch.serve.router import FleetRecord, FleetRouter

__all__ = [
    "TERMINAL_STATES", "AdapterStoreFullError", "DeadlineExceededError", "EngineClosedError",
    "EngineReplica", "FleetRecord", "FleetRouter", "FleetSaturatedError", "PageAllocator",
    "QueueFullError", "ReplicaState", "ReplicaUnreachableError", "Request",
    "RequestFailedError", "RequestState", "RequestTooLargeError", "ServeError",
    "ServeResult", "ServingEngine", "ShedError", "TransientStepError",
    "UnknownAdapterError", "init_slot_cache", "kv_token_bytes", "pages_for",
]
