"""Continuous-batching serving runtime over the paged KV cache."""

from dtc_tpu_torch.serve.engine import ServingEngine, init_slot_cache
from dtc_tpu_torch.serve.paged_cache import PageAllocator, kv_token_bytes, pages_for
from dtc_tpu_torch.serve.request import (
    TERMINAL_STATES,
    DeadlineExceededError,
    QueueFullError,
    Request,
    RequestFailedError,
    RequestState,
    RequestTooLargeError,
    ServeError,
    ServeResult,
    ShedError,
    TransientStepError,
)

__all__ = [
    "TERMINAL_STATES", "DeadlineExceededError", "PageAllocator",
    "QueueFullError", "Request", "RequestFailedError", "RequestState",
    "RequestTooLargeError", "ServeError", "ServeResult", "ServingEngine",
    "ShedError", "TransientStepError", "init_slot_cache", "kv_token_bytes",
    "pages_for",
]
