"""Request model for the serving runtime: state machine, typed failures.

Every request admitted to :class:`dtc_tpu_torch.serve.engine.ServingEngine`
walks one state machine::

    QUEUED --> PREFILL --> DECODE --> DONE
       |          \\          |\\
       |           \\         | +--> EVICTED --> PREFILL  (pages reclaimed /
       |            \\        |      preempted / corrupted: re-queued, then
       |             \\       |      re-prefilled on re-admission —
       |              \\      |      bit-exact resume, a RECOVERY path)
       |               +-----+----> EXPIRED              (deadline/TTL)
       +--> SHED                                          (overload policy)
       +--> EXPIRED                                       (died waiting)

plus FAILED for retry-exhausted internal faults. Terminal states are
DONE / SHED / EXPIRED / FAILED; EVICTED is transient and observable (the
request re-queues holding its already-generated tokens, its state stays
EVICTED while it waits, and re-admission re-prefills; like any queued
request it may still be shed or expire there). Rejection at ``submit()`` (queue full, request cannot fit
the cache) raises immediately and the request never enters the machine.

Every non-success outcome is a *catchable type* carried on the
:class:`ServeResult` (or raised at submit), never a silent drop.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Sequence


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"
    EVICTED = "evicted"
    EXPIRED = "expired"
    SHED = "shed"
    FAILED = "failed"


#: States from which a request will never run again.
TERMINAL_STATES = frozenset(
    {RequestState.DONE, RequestState.EXPIRED, RequestState.SHED,
     RequestState.FAILED}
)


class ServeError(RuntimeError):
    """Base class for serving-runtime failures."""


class QueueFullError(ServeError):
    """Admission control: the bounded queue is at ``queue_depth``. Raised
    at ``submit()`` — typed backpressure, the caller decides whether to
    retry later or surface 429-equivalent to its client."""


class RequestTooLargeError(ServeError):
    """The request cannot ever run: prompt + max_new_tokens exceeds the
    model's ``max_seq_len``, or its page footprint exceeds the whole
    pool. Raised at ``submit()``."""


class ShedError(ServeError):
    """Dropped by the overload-shedding policy (lowest priority / longest
    queued past the shed watermark) — the graceful-degradation path that
    keeps p99 bounded for the requests that remain."""


class DeadlineExceededError(ServeError):
    """The request outlived its deadline/TTL — in the queue or mid-decode
    (cancellation frees its slot and pages immediately)."""


class RequestFailedError(ServeError):
    """An internal fault outlived the retry budget (see
    ``ServeConfig.retry``); carries the last underlying error as
    ``__cause__`` when known."""


class TransientStepError(ServeError):
    """A decode/prefill step produced unusable output (non-finite logits —
    a poisoned device buffer). Retryable: the engine re-runs the step from
    the pre-step cache via ``resilience.retry.retry_call``."""


class UnknownAdapterError(ServeError):
    """The request names an adapter that is not resident in the engine's
    adapter store (or the model was built without adapter support).
    Raised at ``submit()`` — load the adapter first
    (``ServingEngine.load_adapter``). At the fleet level the router
    converts this into re-load-or-reroute (it holds registered factor
    trees); only when no replica holds the factors AND none were
    registered does the request end typed with this as the cause —
    NEVER silently served on slot-0 base weights."""


class EngineClosedError(ServeError):
    """The engine is shut down (``ServingEngine.shutdown()``) or draining:
    new submissions are refused, and any request still unfinished when the
    drain budget runs out ends typed with this error — the graceful-stop
    contract (stop admitting, finish or typed-evict, drain the recovery
    bus, dump the flight recorder) the trainer follows."""


class FleetSaturatedError(QueueFullError):
    """Fleet-level backpressure: every live replica's admission queue is
    at depth (or the replica that holds a required resource is full).
    A ``QueueFullError`` subclass so single-engine callers' typed-429
    handling works unchanged against the router."""


class ReplicaUnreachableError(ServeError):
    """A replica did not answer (network partition / dead process in the
    multi-host picture; the chaos ``fleet_partition`` kind in-process).
    Transient from the router's point of view: retried with backoff via
    ``resilience.retry.retry_call``, then routed around; a replica that
    stays unreachable past the heartbeat-miss budget is declared dead and
    its requests fail over to survivors."""


class AdapterStoreFullError(ServeError):
    """``load_adapter`` found every tenant slot held by an adapter with
    in-flight requests — nothing is LRU-evictable. Typed backpressure:
    drain or wait, never a silent overwrite of a live tenant's factors."""


@dataclasses.dataclass
class Request:
    """One generation request.

    ``shared_prefix_len`` marks the first N prompt tokens as a shareable
    prefix (a common system prompt): concurrent requests with an identical
    prefix reuse its KV pages from the prefix store instead of
    re-prefilling it. Prefix entries are scoped PER ADAPTER — the same
    token prefix under two tenants holds two store entries, because their
    KV bytes differ. ``deadline_s`` is relative to submit time and
    overrides the config default (None = use default; 0 = no deadline).
    Higher ``priority`` is better; sheds take the lowest first.
    ``adapter`` names a tenant LoRA adapter previously loaded with
    ``ServingEngine.load_adapter`` (None = the base model); the adapter
    stays pinned in the store from submit to the terminal state.
    """

    rid: str
    prompt: Sequence[int]
    max_new_tokens: int
    priority: int = 0
    deadline_s: float | None = None
    eos_id: int | None = None
    shared_prefix_len: int = 0
    adapter: str | None = None

    def __post_init__(self) -> None:
        if len(self.prompt) < 1:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens must be >= 1")
        if not 0 <= self.shared_prefix_len <= len(self.prompt):
            raise ValueError(
                f"request {self.rid}: shared_prefix_len "
                f"{self.shared_prefix_len} outside [0, len(prompt)]"
            )


@dataclasses.dataclass
class ServeResult:
    """Terminal record of one request — tokens, typed error, SLO timings.

    ``tokens`` holds whatever was generated before the terminal state
    (complete for DONE, partial for EXPIRED/SHED/FAILED). ``error`` is
    None iff state is DONE. Wait/latency fields are None until the
    corresponding edge happened.
    """

    rid: str
    state: RequestState
    tokens: list[int]
    error: ServeError | None = None
    submitted_t: float | None = None
    admitted_t: float | None = None      # last (re-)admission
    first_token_t: float | None = None
    finished_t: float | None = None
    n_evictions: int = 0
    n_retries: int = 0
    degraded: bool = False               # max_new_tokens shrunk at admission
    adapter: str | None = None           # tenant adapter (None = base)
    # Cross-replica failover hops (router resubmissions of prompt +
    # generated-so-far onto a survivor). 0 for a request that never left
    # its first replica; in-replica evictions count in n_evictions.
    n_hops: int = 0
    # Eviction re-queue time: the next req.queued trace span starts here
    # instead of at submit (cleared on re-admission; never in summary()).
    # Set per HOP too — a failover resubmission restarts the queued span
    # at the hop, while ttft_s stays anchored at the ORIGINAL submit, so
    # fleet TTFT histograms include (never under-report) failover cost.
    requeued_t: float | None = None
    # Speculative decoding: draft proposals this request saw
    # and how many the target accepted — 0/0 on a spec-off engine.
    # Counts survive eviction/failover (they describe work done, and a
    # re-prefill re-derives tokens, not proposals).
    n_spec_proposed: int = 0
    n_spec_accepted: int = 0

    @property
    def queue_wait_s(self) -> float | None:
        if self.submitted_t is None or self.admitted_t is None:
            return None
        return self.admitted_t - self.submitted_t

    @property
    def ttft_s(self) -> float | None:
        """Submit -> first generated token (includes queueing + prefill)."""
        if self.submitted_t is None or self.first_token_t is None:
            return None
        return self.first_token_t - self.submitted_t

    @property
    def ms_per_token(self) -> float | None:
        """Mean decode interval after the first token (serving ms/token)."""
        if (
            self.first_token_t is None or self.finished_t is None
            or len(self.tokens) < 2
        ):
            return None
        return (self.finished_t - self.first_token_t) / (len(self.tokens) - 1) * 1e3

    @property
    def accept_rate(self) -> float | None:
        """Accepted / proposed draft tokens; None when the
        request never decoded under speculation."""
        if self.n_spec_proposed <= 0:
            return None
        return self.n_spec_accepted / self.n_spec_proposed

    def summary(self) -> dict[str, Any]:
        """JSON-ready record for telemetry / bench rows."""
        r3 = lambda v: None if v is None else round(v, 6)  # noqa: E731
        return {
            "rid": self.rid,
            "state": self.state.value,
            "n_tokens": len(self.tokens),
            "error": type(self.error).__name__ if self.error else None,
            "queue_wait_s": r3(self.queue_wait_s),
            "ttft_s": r3(self.ttft_s),
            "ms_per_token": r3(self.ms_per_token),
            "n_evictions": self.n_evictions,
            "n_retries": self.n_retries,
            "n_hops": self.n_hops,
            "degraded": self.degraded,
            "adapter": self.adapter,
            "n_spec_proposed": self.n_spec_proposed,
            "n_spec_accepted": self.n_spec_accepted,
            "accept_rate": r3(self.accept_rate),
        }
