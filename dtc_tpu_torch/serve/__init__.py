"""Continuous-batching serving runtime over the paged KV cache."""

from dtc_tpu_torch.serve.engine import ServingEngine, init_slot_cache
from dtc_tpu_torch.serve.paged_cache import PageAllocator, kv_token_bytes, pages_for
from dtc_tpu_torch.serve.request import (
    TERMINAL_STATES,
    AdapterStoreFullError,
    DeadlineExceededError,
    EngineClosedError,
    QueueFullError,
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

__all__ = [
    "TERMINAL_STATES", "AdapterStoreFullError", "DeadlineExceededError", "EngineClosedError",
    "PageAllocator",
    "QueueFullError", "Request", "RequestFailedError", "RequestState",
    "RequestTooLargeError", "ServeError", "ServeResult", "ServingEngine",
    "ShedError", "TransientStepError", "UnknownAdapterError", "init_slot_cache", "kv_token_bytes",
    "pages_for",
]
