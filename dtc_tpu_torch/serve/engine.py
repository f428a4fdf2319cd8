"""Continuous-batching serving engine over the paged KV cache.

Orca-style iteration-level scheduling over a vLLM-style paged budget, on
the model-native packed cache:

- ONE decode step over ``cfg.slots`` fixed batch slots (the shared
  :func:`dtc_tpu_torch.generate.decode_step`, driven with a per-slot
  ``(slots,)`` frontier vector). Requests enter and leave slots at
  iteration boundaries by copying a cache row.
- Admission = a batch-1 prefill on a side cache, the prompt right-padded
  to ``prefill_bucket``, then one device-side copy into the slot row with
  the frontier pinned to the VALID length. A shared system prompt
  (``Request.shared_prefix_len``) is prefilled once into the prefix store
  and reused by every admission that matches it.
- The paged allocator accounts every resident token in ``page_size``
  blocks against one pool; exhaustion triggers eviction-and-re-prefill
  (the victim re-queues with its generated tokens and greedy decode over
  prompt + generated resumes it token for token).
- Robustness: bounded queue with typed rejection, shedding past a
  watermark, per-request deadlines (queued and mid-decode), a
  max_new_tokens cap past the degrade watermark, transient-fault retry
  of a step whose logits read non-finite (from the pre-step cache),
  completed-page checksums verified on a cadence, and a hung-step
  watchdog.
- Speculative decoding (``ServeConfig.spec``): a draft rung of the
  target's bottom ``draft_layers`` blocks (zero-copy,
  :func:`dtc_tpu_torch.spec.extract_draft`) with its own slot cache
  proposes ``spec_k - 1`` tokens per slot, and one verify window per
  iteration (:func:`dtc_tpu_torch.spec.spec_round`) emits 1..spec_k
  tokens, token-identical to plain greedy decode. The draft's KV rides the
  same page pool at a ``draft_layers / n_layers`` surcharge; submission
  reserves ``spec_k - 1`` positions of verify headroom; every admission
  prefills the draft over the full sequence.

Under ``decode_attention: fused_layers`` each decode step (and each
verify window) runs the layer stack as one megakernel launch.

- Multi-tenant LoRA adapters (model ``adapter.rank > 0``): ONE resident
  ``(max_adapters, ...)`` factor stack (slot 0 all zero: the base model)
  and a device ``(slots,)`` int32 tensor of each slot's adapter; every
  decode step passes the stack with the slots' ids, so each row decodes
  under its own tenant, and a prefill runs under its tenant's slot.
  ``load_adapter`` validates a tenant's factors, registers it in the
  :class:`~dtc_tpu_torch.adapters.AdapterStore` (LRU over idle tenants,
  typed ``AdapterStoreFullError`` when all are in flight) and writes them
  into the stack in place; a request names its tenant
  (``Request.adapter``), which is pinned from submit to terminal.
  Admitting a tenant changes values, never shapes or pointers. Shared
  prefixes are stored per adapter; a (re)loaded or evicted tenant's
  entries are dropped.

- Telemetry (the JAX engine's): counters, histograms and events go
  through ``reg``, a :class:`~dtc_tpu_torch.obs.registry.MetricsRegistry`
  (``telemetry.registry`` when a
  :meth:`~dtc_tpu_torch.obs.telemetry.Telemetry.for_serving` is given,
  whose shard then holds the serving run), on the scheduler's clock
  shifted to the wall clock. Counters keep the JAX package's names
  (``serve_submitted``, ``serve_admissions``, ``serve_decode_steps``,
  ``serve_spec_proposed``, ``adapter_loads``, ...), and ``counters`` is a
  read-only view of them. Histograms: ``serve_ttft_s``,
  ``serve_queue_wait_s``, ``serve_ms_per_token`` (and per tenant under
  adapters), ``serve_batch_occupancy``, ``serve_accept_rate``,
  ``serve_accepted_per_launch``. Events: ``serve_reject``,
  ``serve_admit``, ``serve_evict``, ``serve_corruption``, one
  ``serve_request`` a terminal request, ``hung_step``, ``adapter_load`` /
  ``adapter_evict``, ``serve_shutdown``. Spans: each request's
  ``req.queued`` → ``req.prefill`` → ``req.decode`` → terminal chain and
  one ``decode_step`` an iteration. A flight recorder rings the last
  events and dumps on a chaos or recovery record, a corruption, a failed
  request, a hung iteration and the shutdown.
- Online SLO objectives (``ServeConfig.slo``) evaluated every
  ``check_every`` iterations; a breaching latency objective (or, under
  speculation, the accepted-tokens/s floor) caps new admissions at
  ``degrade_max_new_tokens``. An online goodput gauge bills each
  iteration's seconds to productive decode, prefill, re-prefill after an
  eviction, rejected draft work, and idle or degraded time.
- Chaos (``ServeConfig.chaos``, a
  :class:`~dtc_tpu_torch.resilience.chaos.ChaosInjector` on the engine's
  own recovery bus) lands at iteration boundaries on the production paths:
  a stall inside the timed iteration, a completed page overwritten on the
  device (caught by the checksum verifier), the newest request preempted,
  and a decode attempt whose logits read non-finite (retried from the
  pre-step cache). The bus is drained every iteration, before the
  watchdog's verdict.
- :meth:`ServingEngine.shutdown` drains or evicts what is in flight,
  refuses later submissions (``EngineClosedError``), drains the bus,
  dumps the flight recorder once and flushes.
- The fleet router's surface (:mod:`dtc_tpu_torch.serve.router`):
  ``submit(req, resume=...)`` takes over a request generated in part on
  another replica; ``queue_room``, ``load``, ``over_shed_watermark`` and
  ``has_prefix`` are its placement inputs.

Memory note: the K/V buffers are updated in place (see
``models/gpt.py``); a retried step re-writes the same positions with the
same values, so retries stay bit-exact. Every write into the cache (a
decode, an admission's copy, an injected corruption) resets the checksum
memo.
"""

from __future__ import annotations

import time
from collections import deque
from collections.abc import Mapping
from typing import Any, Callable, Iterator

import numpy as np
import torch

from dtc_tpu_torch.adapters import (
    BASE_SLOT,
    AdapterStore,
    init_lora_stack,
    lora_enabled,
    validate_lora_tree,
)
from dtc_tpu_torch.generate import decode_step, init_cache
from dtc_tpu_torch.obs.goodput import SPEC_REJECTED_DRAFT, OnlineGoodput
from dtc_tpu_torch.obs.registry import MetricsRegistry
from dtc_tpu_torch.obs.slo import SloMonitor
from dtc_tpu_torch.obs.telemetry import drain_bus
from dtc_tpu_torch.obs.trace import FlightRecorder, Tracer
from dtc_tpu_torch.resilience.chaos import ChaosInjector
from dtc_tpu_torch.resilience.events import RecoveryBus
from dtc_tpu_torch.resilience.retry import retry_call
from dtc_tpu_torch.resilience.watchdog import StepWatchdog
from dtc_tpu_torch.serve.paged_cache import PageAllocator, kv_token_bytes, pages_for
from dtc_tpu_torch.serve.request import (
    TERMINAL_STATES,
    DeadlineExceededError,
    EngineClosedError,
    QueueFullError,
    Request,
    RequestFailedError,
    RequestState,
    RequestTooLargeError,
    ServeResult,
    ShedError,
    TransientStepError,
    UnknownAdapterError,
)
from dtc_tpu_torch.spec import check_spec_backend, extract_draft, spec_round


def init_slot_cache(model, slots: int) -> dict:
    """Decode cache for ``slots`` independent slots: the standard cache
    with the scalar frontier replaced by a ``(slots,)`` vector."""
    cache = init_cache(model, slots)
    cache["index"] = torch.zeros((slots,), dtype=torch.int32, device=model.device)
    return cache


def _pad_to_bucket(tokens: list[int], bucket: int, limit: int) -> list[int]:
    """Right-pad to the next bucket multiple, clamped to ``limit`` (the
    remaining cache room)."""
    n = len(tokens)
    padded = min(((n + bucket - 1) // bucket) * bucket, limit)
    return tokens + [0] * (padded - n)


class _Slot:
    """Host-side per-slot record: occupant, write frontier (tokens resident
    in the cache row) and checksums of completed pages."""

    __slots__ = ("rid", "frontier", "page_fp")

    def __init__(self) -> None:
        self.rid: str | None = None
        self.frontier = 0
        self.page_fp: dict[int, float] = {}


class _CounterView(Mapping):
    """Read-only view of a registry's counters by name; a counter never
    incremented reads 0."""

    def __init__(self, reg: MetricsRegistry):
        self._reg = reg

    def __getitem__(self, name: str) -> int:
        c = self._reg._counters.get(name)
        return 0 if c is None else c.value

    def __iter__(self) -> Iterator[str]:
        return iter(list(self._reg._counters))

    def __len__(self) -> int:
        return len(self._reg._counters)


class ServingEngine:
    """Construct once per (model, config); ``submit()`` requests, then
    drive ``step()`` (or ``run()``), and ``shutdown()`` at the end. Runs on
    the model's device. ``telemetry``: a
    :meth:`~dtc_tpu_torch.obs.telemetry.Telemetry.for_serving` whose
    registry, tracer, flight recorder and goodput gauge the engine uses
    (without one it keeps its own, in memory)."""

    def __init__(
        self,
        model,
        cfg,
        *,
        telemetry=None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.model = model
        self.cfg = cfg
        self.mcfg = model.cfg
        self.device = model.device
        self.spec_on = cfg.spec.enabled
        if self.spec_on and self.mcfg.adapter.rank > 0:
            raise ValueError(
                "speculative decoding (serve.spec) does not compose with "
                "multi-tenant adapters (model adapter.rank > 0): the draft "
                "rung proposes under base weights while each tenant's "
                "verify would run adapted weights; serve an adapter-free "
                "config"
            )
        if getattr(self.mcfg, "debug_checks", False):
            raise ValueError(
                "ServingEngine does not support model debug_checks=True"
            )
        if self.spec_on:
            check_spec_backend(self.mcfg)  # token identity needs one path
        self.clock = clock
        self.sleep = sleep
        self.telemetry = telemetry
        self.reg: MetricsRegistry = (
            telemetry.registry if telemetry is not None else MetricsRegistry()
        )
        # One timebase for the serving record: event stamps, span starts
        # and the results' SLO timings all read the scheduler clock,
        # shifted by a constant onto the wall clock the trainer's shards
        # use (durations are unaffected).
        self._epoch0 = time.time() - self.clock()
        emit_clock = lambda: self.clock() + self._epoch0  # noqa: E731
        self.reg.set_clock(emit_clock)
        if telemetry is not None:
            self.tracer = telemetry.tracer
            self.tracer.clock = emit_clock
            self.recorder = telemetry.recorder
        else:
            # A bare engine: spans still reach the registry and the flight
            # recorder still rings in memory.
            self.tracer = Tracer(self.reg, clock=emit_clock, tid="sched")
            self.recorder = self.reg.add_sink(FlightRecorder(256))
        self.slo = SloMonitor.from_config(cfg.slo, self.reg, runtime="serve")
        self._slo_check_every = cfg.slo.check_every
        # The telemetry's goodput gauge (its registry is this one; None with
        # obs off), or the engine's own; fed from the iteration's
        # timestamps, never a sync.
        self.goodput: OnlineGoodput | None = (
            telemetry.goodput if telemetry is not None else OnlineGoodput(self.reg)
        )
        self._gp_work = 0.0  # seconds attributed in the current iteration
        self.bus = RecoveryBus()
        self.chaos = ChaosInjector(cfg.chaos, self.bus) if cfg.chaos.enabled else None
        self.hung_steps: deque[dict] = deque(maxlen=64)  # newest watchdog flags
        self.watchdog = (
            StepWatchdog(cfg.watchdog) if cfg.watchdog.enabled else None
        )
        # Page checksums cost a reduction and a transfer: kept when the
        # verifier reads them, or when injected corruption must be caught.
        self._track_pages = cfg.verify_pages_every > 0 or (
            cfg.chaos.enabled and cfg.chaos.serve_corrupt_page_at_step > 0
        )

        if cfg.pool_hbm_bytes > 0:
            pool = max(
                1,
                cfg.pool_hbm_bytes
                // (cfg.page_size * kv_token_bytes(self.mcfg)),
            )
        else:
            pool = cfg.total_pages or cfg.slots * pages_for(
                self.mcfg.max_seq_len, cfg.page_size
            )
        self.alloc = PageAllocator(pool, cfg.page_size)

        self.cache = init_slot_cache(model, cfg.slots)
        self.lora_on = lora_enabled(self.mcfg)
        if self.lora_on:
            self.adapter_store = AdapterStore(cfg.max_adapters)
            self.lora_stack = init_lora_stack(model, cfg.max_adapters)
            self.slot_adapter = torch.zeros((cfg.slots,), dtype=torch.int32, device=self.device)
        else:
            self.adapter_store = self.lora_stack = self.slot_adapter = None
        if self.spec_on:
            self.draft = extract_draft(model, cfg.spec.draft_layers)
            self.draft_cache = init_slot_cache(self.draft, cfg.slots)
        else:
            self.draft = self.draft_cache = None
        self.slots = [_Slot() for _ in range(cfg.slots)]
        self.last_tok = np.zeros((cfg.slots,), np.int32)
        # The accepted-token rate the SLO floor reads under speculation:
        # tokens emitted and rounds run since the last check.
        self._spec_emitted_since = 0
        self._spec_rounds_since = 0
        self._spec_rate_t0 = self.clock()

        self.closed = False  # after shutdown() submit() refuses, typed
        self._in_shutdown = False  # one flight dump for the whole drain
        self.queue: list[Request] = []
        self.requests: dict[str, Request] = {}
        self.results: dict[str, ServeResult] = {}
        self._eff_max_new: dict[str, int] = {}
        self._deadline: dict[str, float] = {}
        self._prefix_store: dict[tuple, tuple[dict, int]] = {}
        self._retry_scope: list[str] = []
        self._it = 0
        self._worked = False
        self._fps_memo: np.ndarray | None = None

    @property
    def counters(self) -> Mapping[str, int]:
        """The registry's counters by name (read-only; 0 when never
        incremented)."""
        return _CounterView(self.reg)

    # ------------------------------------------------------------------
    # submission (admission control)
    # ------------------------------------------------------------------
    def _pages_needed(self, n_tokens: int) -> int:
        """Pool pages for ``n_tokens`` resident target tokens, plus the
        draft rung's proportional KV surcharge under speculation (the
        draft cache holds the same positions at ``draft_layers`` of
        ``n_layers`` depth in the same pool)."""
        pages = pages_for(n_tokens, self.cfg.page_size)
        if self.spec_on:
            dl, nl = self.cfg.spec.draft_layers, self.mcfg.n_layers
            pages += (pages * dl + nl - 1) // nl
        return pages

    def submit(self, req: Request, *, resume: ServeResult | None = None) -> str:
        """Enqueue one request. Typed backpressure: raises
        :class:`QueueFullError` past ``queue_depth`` and
        :class:`RequestTooLargeError` for requests that could never run,
        and :class:`EngineClosedError` after :meth:`shutdown`; each with a
        ``serve_reject`` event. A ``rid`` may be reused only once its
        previous submission is terminal.

        ``resume`` is the fleet's failover path: a partial
        :class:`ServeResult` generated on another replica. The new record
        starts from its tokens, so admission re-prefills prompt +
        generated and greedy decode continues where it stopped.
        ``submitted_t`` and ``first_token_t`` carry over (TTFT and the
        deadline stay anchored at the original submit), ``requeued_t``
        restarts the ``req.queued`` span at this hop, and ``n_hops``
        increments. A resume that already holds ``max_new_tokens`` tokens
        raises ``ValueError``."""
        if self.closed:
            self._reject(req, "closed")
            raise EngineClosedError(
                f"request {req.rid}: engine is shut down / draining"
            )
        if resume is not None and len(resume.tokens) >= req.max_new_tokens:
            raise ValueError(
                f"request {req.rid}: resume carries {len(resume.tokens)} "
                f"tokens >= max_new_tokens {req.max_new_tokens}: the prior "
                "hop should have completed it"
            )
        if req.rid in self.requests:
            raise ValueError(
                f"request {req.rid}: rid already in flight "
                f"(state {self.results[req.rid].state.value})"
            )
        now = self.clock()
        total = len(req.prompt) + req.max_new_tokens
        # Under speculation the verify window writes spec_k positions from
        # the frontier before rolling back, so the last round needs
        # spec_k - 1 positions past the final token.
        spec_pad = self.cfg.spec.spec_k - 1 if self.spec_on else 0
        if total + spec_pad > self.mcfg.max_seq_len:
            self._reject(req, "too_large")
            raise RequestTooLargeError(
                f"request {req.rid}: prompt ({len(req.prompt)}) + "
                f"max_new_tokens ({req.max_new_tokens})"
                + (f" + spec_k-1 verify headroom ({spec_pad})" if spec_pad else "")
                + f" exceeds max_seq_len ({self.mcfg.max_seq_len})"
            )
        if self._pages_needed(total + spec_pad) > self.alloc.total_pages:
            self._reject(req, "too_large")
            raise RequestTooLargeError(
                f"request {req.rid}: footprint "
                f"{self._pages_needed(total + spec_pad)} pages"
                + (" (incl. draft KV surcharge)" if self.spec_on else "")
                + f" exceeds the pool ({self.alloc.total_pages})"
            )
        if req.adapter is not None and (
            not self.lora_on or req.adapter not in self.adapter_store
        ):
            self._reject(req, "unknown_adapter", adapter=req.adapter)
            raise UnknownAdapterError(
                f"request {req.rid}: adapter {req.adapter!r} is not resident"
                + ("" if self.lora_on else
                   " (model has no adapter support: adapter.rank == 0)")
            )
        if len(self.queue) >= self.cfg.queue_depth:
            self._reject(req, "queue_full")
            raise QueueFullError(
                f"request {req.rid}: queue at depth {self.cfg.queue_depth}"
            )
        if req.adapter is not None:
            # Pinned from submit to terminal: an in-flight tenant's factors
            # are never evicted under it (re-prefill after eviction needs them).
            self.adapter_store.acquire(req.adapter)
        self.requests[req.rid] = req
        res = ServeResult(
            rid=req.rid, state=RequestState.QUEUED, tokens=[], submitted_t=now,
            adapter=req.adapter,
        )
        if resume is not None:
            res.tokens = list(resume.tokens)
            if resume.submitted_t is not None:
                res.submitted_t = resume.submitted_t
            res.first_token_t = resume.first_token_t
            res.n_evictions = resume.n_evictions
            res.n_retries = resume.n_retries
            res.n_hops = resume.n_hops + 1
            res.degraded = resume.degraded
            res.n_spec_proposed = resume.n_spec_proposed
            res.n_spec_accepted = resume.n_spec_accepted
            res.requeued_t = now  # this hop's req.queued span starts here
        self.results[req.rid] = res
        ttl = self.cfg.deadline_s if req.deadline_s is None else req.deadline_s
        # A failover hop keeps the original submit's deadline.
        self._deadline[req.rid] = (
            res.submitted_t + ttl if ttl and ttl > 0 else float("inf")
        )
        self.queue.append(req)
        self.reg.counter("serve_submitted").inc()
        return req.rid

    # -- load and occupancy: the fleet router's placement inputs ---------
    @property
    def queue_room(self) -> int:
        """Submissions this engine still takes before ``QueueFullError``."""
        return max(0, self.cfg.queue_depth - len(self.queue))

    @property
    def active_count(self) -> int:
        """Slots decoding now."""
        return sum(1 for s in self.slots if s.rid is not None)

    @property
    def load(self) -> int:
        """Queued + in-flight requests (the least-loaded placement key)."""
        return len(self.queue) + self.active_count

    @property
    def over_shed_watermark(self) -> bool:
        """The queue is past the shed watermark: this engine is about to
        shed, so the router prefers peers with headroom."""
        wm = self.cfg.shed_watermark
        return wm > 0 and len(self.queue) > int(wm * self.cfg.queue_depth)

    def _reject(self, req: Request, reason: str, **fields: Any) -> None:
        self.reg.counter("serve_rejected").inc()
        self.reg.emit("serve_reject", rid=req.rid, reason=reason, **fields)

    def load_adapter(self, name: str, factors: dict) -> int:
        """Make tenant ``name``'s LoRA factors resident; returns its stack
        slot. ``factors`` is one adapter's factor dict
        (``dtc_tpu_torch.adapters``: ``init_lora``, ``load_adapter_file``,
        ``parity.lora_from_flax``). The write goes into the resident stack in
        place, so the decode step's shapes and pointers never change. A full
        store evicts the least-recently-used idle tenant; when every tenant
        has in-flight requests it raises ``AdapterStoreFullError``.
        Re-loading a resident name overwrites its factors (a hot update)
        and raises ValueError while it has requests in flight. Prefix KV
        built under an evicted or re-loaded tenant is dropped."""
        if not self.lora_on:
            raise ValueError(
                "load_adapter on a lora-free engine (model adapter.rank == 0); "
                "serve an adapter-enabled model config"
            )
        validate_lora_tree(self.lora_stack, factors)
        slot, evicted = self.adapter_store.register(name)
        if evicted is not None:
            self.reg.counter("adapter_evictions").inc()
            self.reg.emit("adapter_evict", name=evicted, slot=slot, iteration=self._it,
                          reason="store_lru")
            # A retired tenant's prefix KV and per-tenant histograms go
            # with it (a later load under the name may bring new factors).
            self._drop_adapter_prefixes(evicted)
            self.reg.drop_histogram(f"serve_ttft_s.{evicted}")
            self.reg.drop_histogram(f"serve_ms_per_token.{evicted}")
        # Prefix KV built under the old factors of this name is stale.
        self._drop_adapter_prefixes(name)
        with torch.no_grad():
            for key, buf in self.lora_stack.items():
                buf[slot].copy_(factors[key])
        self.reg.counter("adapter_loads").inc()
        self.reg.emit("adapter_load", name=name, slot=slot, iteration=self._it,
                      params=int(sum(f.numel() for f in factors.values())))
        return slot

    def _drop_adapter_prefixes(self, name: str) -> None:
        """Drop every shared-prefix entry built under adapter ``name``
        (keys are ``(adapter, *tokens)``) and return its pages."""
        for key in [k for k in self._prefix_store if k[0] == name]:
            self._prefix_store.pop(key, None)
            self.alloc.drop_prefix(key)

    def _adapter_slot(self, req: Request) -> int:
        """The request's stack slot (BASE_SLOT for base requests and on a
        lora-free engine); the refcount keeps it resident while in flight."""
        if not self.lora_on or req.adapter is None:
            return BASE_SLOT
        return self.adapter_store.slot_of(req.adapter)

    def drain_results(self) -> dict[str, ServeResult]:
        """Remove and return every terminal result."""
        done = {
            rid: r for rid, r in self.results.items()
            if r.state in TERMINAL_STATES
        }
        for rid in done:
            del self.results[rid]
        return done

    # ------------------------------------------------------------------
    # the scheduler iteration
    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One iteration: a chaos stall, expiry, shedding and admission at
        the boundary, chaos corruption, page verification on its cadence,
        chaos preemption, then one decode step over the in-flight batch;
        the bus is drained, goodput, the watchdog and the SLO monitor read
        the iteration. Returns True while any request is queued or in
        flight."""
        self._it += 1
        self._worked = False
        self._gp_work = 0.0
        t0 = self.clock()
        if self.chaos is not None:
            stall = self.chaos.serve_stall(self._it)
            if stall > 0:
                self.sleep(stall)  # inside the timed iteration, on purpose
        self._expire()
        self._shed()
        self._admit()
        # Shots that need something to act on are asked for only when it
        # exists (a completed page, an active request); otherwise the
        # fire-once shot would be spent on an injection that never happened.
        if (
            self.chaos is not None
            and self._corruption_candidates()
            and self.chaos.serve_corrupt_page(self._it)
        ):
            self._inject_corruption()
        if (
            self.cfg.verify_pages_every > 0
            and self._it % self.cfg.verify_pages_every == 0
        ):
            self._verify_pages()
        if (
            self.chaos is not None
            and any(s.rid is not None for s in self.slots)
            and self.chaos.serve_preempt(self._it)
        ):
            self._preempt_newest()
        self._ensure_pages()
        self._decode()
        # The bus before the watchdog's verdict: this iteration's chaos and
        # recovery records (and their flight dumps) land first, so a
        # stall's last dump carries the hung-step reason.
        self._drain_bus()
        now_it = self.clock()
        if self.goodput is not None:
            # The unattributed rest of the iteration (bookkeeping, a chaos
            # stall, an idle spin) is idle, or degraded while a latency
            # objective breaches.
            idle = max((now_it - t0) - self._gp_work, 0.0)
            self.goodput.note(
                "degraded" if self.slo is not None and self.slo.degrade_active
                else "shed_or_idle", idle)
            if self._it % self._slo_check_every == 0:
                pct = self.goodput.update(iteration=self._it)
                if self.slo is not None:
                    self.slo.observe("goodput_pct", pct)
        # Only working iterations (a prefill or a decode ran) feed the
        # watchdog: idle spins would collapse its trailing median.
        if self.watchdog is not None and self._worked:
            flag = self.watchdog.observe(self._it, now_it - t0)
            if flag is not None:
                self.reg.counter("serve_hung_steps").inc()
                self.hung_steps.append(flag)
                self.reg.emit("hung_step", runtime="serve", **flag)
                self.dump_flight("hung_step", iteration=self._it)
        if self.slo is not None and self._it % self._slo_check_every == 0:
            if self.spec_on and self._spec_rounds_since > 0:
                # The floor reads ACCEPTED tokens/s over the window since
                # the last check (only when rounds ran: an idle engine's
                # zero must not fake a breach).
                rate = self._spec_emitted_since / max(now_it - self._spec_rate_t0, 1e-9)
                self.reg.gauge("serve_accepted_tokens_per_s").set(rate)
                self.slo.observe("serve_accepted_tokens_per_s", rate)
                self._spec_emitted_since = 0
                self._spec_rounds_since = 0
                self._spec_rate_t0 = now_it
            self.slo.evaluate(iteration=self._it)
        return bool(self.queue) or any(s.rid is not None for s in self.slots)

    def run(self, *, max_steps: int = 100_000) -> dict[str, ServeResult]:
        """Drive ``step()`` until idle or ``max_steps`` iterations this
        call."""
        for _ in range(max_steps):
            if not self.step():
                break
        return self.results

    def shutdown(self, *, mode: str = "drain", max_steps: int = 512,
                 reason: str = "shutdown") -> dict[str, ServeResult]:
        """Graceful stop, the serving side of the trainer's SIGTERM: stop
        admitting (``submit()`` raises :class:`EngineClosedError` from here
        on), then

        - ``mode="drain"``: step until every queued and in-flight request
          is terminal or ``max_steps`` runs out; what is still unfinished
          is evicted, typed (FAILED with ``EngineClosedError``, its partial
          tokens kept on the result);
        - ``mode="evict"``: evict so at once (a preemption notice too short
          to drain).

        Either way the recovery bus is drained, the flight recorder dumps
        ONCE with the reason, and the sinks are flushed. Idempotent;
        returns ``results``."""
        if mode not in ("drain", "evict"):
            raise ValueError(f"unknown shutdown mode {mode!r}")
        if self.closed:
            return self.results
        self.closed = True
        self._in_shutdown = True  # the failed requests' dumps collapse into one
        try:
            if mode == "drain":
                for _ in range(max_steps):
                    if not self.step():
                        break
            for req in list(self.queue):
                self.queue.remove(req)
                self._finish(req.rid, RequestState.FAILED, EngineClosedError(
                    f"request {req.rid}: engine shut down while queued ({reason})"))
            for slot in self.slots:
                if slot.rid is None:
                    continue
                rid = slot.rid
                self._release_slot(rid)
                self._finish(rid, RequestState.FAILED, EngineClosedError(
                    f"request {rid}: engine shut down mid-decode ({reason}; partial "
                    "tokens preserved)"))
        finally:
            self._in_shutdown = False
        self._drain_bus()
        self.reg.emit("serve_shutdown", reason=reason, mode=mode, iteration=self._it)
        self.dump_flight(f"shutdown: {reason}", iteration=self._it)
        self.reg.flush()
        return self.results

    # ------------------------------------------------------------------
    # boundary phases
    # ------------------------------------------------------------------
    def _expire(self) -> None:
        now = self.clock()
        for req in list(self.queue):
            if now > self._deadline[req.rid]:
                self.queue.remove(req)
                self._finish(
                    req.rid, RequestState.EXPIRED,
                    DeadlineExceededError(
                        f"request {req.rid} expired after "
                        f"{now - self.results[req.rid].submitted_t:.3f}s in queue"
                    ),
                )
        for slot in self.slots:
            if slot.rid is not None and now > self._deadline[slot.rid]:
                rid = slot.rid
                self._release_slot(rid)
                self._finish(
                    rid, RequestState.EXPIRED,
                    DeadlineExceededError(
                        f"request {rid} expired mid-decode (cancelled)"
                    ),
                )

    def _shed(self) -> None:
        wm = self.cfg.shed_watermark
        if wm <= 0 or not self.queue:
            return
        target = int(wm * self.cfg.queue_depth)
        while len(self.queue) > target:
            if self.cfg.shed_policy == "longest_queued":
                victim = min(
                    self.queue, key=lambda r: self.results[r.rid].submitted_t
                )
            else:  # priority: lowest first, longest-queued within
                victim = min(
                    self.queue,
                    key=lambda r: (r.priority, self.results[r.rid].submitted_t),
                )
            self.queue.remove(victim)
            self._finish(
                victim.rid, RequestState.SHED,
                ShedError(
                    f"request {victim.rid} shed under overload (queue "
                    f"{len(self.queue) + 1} > watermark {target} of "
                    f"{self.cfg.queue_depth})"
                ),
            )

    def _admit(self) -> None:
        while self.queue:
            free = [i for i, s in enumerate(self.slots) if s.rid is None]
            if not free:
                return
            # Highest priority first, FIFO within a priority.
            cand = max(
                self.queue,
                key=lambda r: (r.priority, -self.results[r.rid].submitted_t),
            )
            seq = list(cand.prompt) + self.results[cand.rid].tokens
            # Reserve through the first decode write: one token plain, the
            # verify window under speculation.
            first_write = self.cfg.spec.spec_k if self.spec_on else 1
            need = self._pages_needed(len(seq) + first_write)
            if not self._make_room(need, cand.priority):
                return
            self.alloc.alloc(cand.rid, need)
            self.queue.remove(cand)
            self._do_admit(cand, free[0], seq)

    def _make_room(self, need: int, priority: int) -> bool:
        """Free pages for an admission: LRU prefix-store entries first, then
        strictly-lower-priority active requests."""
        while not self.alloc.can_fit(need):
            key = self.alloc.evict_prefix_lru()
            if key is None:
                break
            self._prefix_store.pop(key, None)
            self.reg.counter("serve_prefix_evictions").inc()
        while not self.alloc.can_fit(need):
            victims = [
                s.rid for s in self.slots
                if s.rid is not None and self.requests[s.rid].priority < priority
            ]
            if not victims:
                return False
            victim = min(
                victims,
                key=lambda r: (
                    self.requests[r].priority,
                    -(self.results[r].admitted_t or 0.0),
                ),
            )
            self._evict(victim, reason="admission_pressure")
        return True

    @staticmethod
    def prefix_key(req: Request) -> tuple | None:
        """The shared-prefix store key of this request (None when it
        declares no usable prefix)."""
        plen = min(req.shared_prefix_len, len(req.prompt) - 1)
        if plen <= 0:
            return None
        return (req.adapter,) + tuple(int(t) for t in req.prompt[:plen])

    def has_prefix(self, req: Request) -> bool:
        """Whether the prefix store holds this request's shared prefix (the
        router's prefix-affinity signal)."""
        key = self.prefix_key(req)
        return key is not None and key in self._prefix_store

    def _prefix_base(self, req: Request) -> tuple[dict, int]:
        """(base cache, base length) for this request's prefill: a copy of
        the matching prefix-store entry (prefilled once), else a fresh
        batch-1 cache."""
        key = self.prefix_key(req)
        if key is None:
            return init_cache(self.model, 1), 0
        plen = len(key) - 1
        if key in self._prefix_store:
            self.alloc.touch_prefix(key)
            self.reg.counter("serve_prefix_hits").inc()
            return self._copy_prefix(key)
        n_pages = pages_for(plen, self.cfg.page_size)
        fits = self.alloc.pin_prefix(key, n_pages)
        while not fits:
            lru = self.alloc.evict_prefix_lru()
            if lru is None:
                break
            self._prefix_store.pop(lru, None)
            fits = self.alloc.pin_prefix(key, n_pages)
        if not fits:
            return init_cache(self.model, 1), 0
        padded = _pad_to_bucket(
            [int(t) for t in req.prompt[:plen]], self.cfg.prefill_bucket,
            self.mcfg.max_seq_len,
        )
        try:
            cache, _tok = self._checked_prefill(
                init_cache(self.model, 1), padded, plen, self._adapter_slot(req)
            )
        except TransientStepError:
            self.alloc.drop_prefix(key)
            raise
        # The stored frontier is the VALID prefix length, not the padded
        # one the prefill advanced it by.
        cache["index"] = torch.tensor(plen, dtype=torch.int32, device=self.device)
        self._prefix_store[key] = (cache, plen)
        self.reg.counter("serve_prefix_builds").inc()
        return self._copy_prefix(key)

    def _copy_prefix(self, key: tuple) -> tuple[dict, int]:
        # The suffix prefill writes its cache in place: give it a copy so
        # the stored entry stays exactly the prefix.
        cache, plen = self._prefix_store[key]
        return {k: v.clone() for k, v in cache.items()}, plen

    def _checked_prefill(self, base: dict, padded: list[int], n_valid: int,
                         adapter_slot: int = BASE_SLOT):
        """Prefill + finite check under the transient-fault retry, under the
        adapter in stack slot ``adapter_slot``. Returns (cache, next token)
        — the token sampled from the last VALID row."""
        prompt = torch.tensor([padded], dtype=torch.int32, device=self.device)
        # One row, one adapter: its factors are views of its stack slot (the
        # base slot's are zero, so a base prefill skips them).
        lora = {}
        if adapter_slot != BASE_SLOT:
            lora["lora"] = {k: v[adapter_slot] for k, v in self.lora_stack.items()}

        def attempt():
            cache, logits = decode_step(self.model, base, prompt, **lora)
            row = logits[0, n_valid - 1]
            tok = torch.argmax(row, dim=-1).to(torch.int32)
            fin = torch.isfinite(row.float()).all()
            tok, fin = torch.stack([tok, fin.to(torch.int32)]).tolist()
            if not fin:
                raise TransientStepError("prefill produced non-finite logits")
            self.reg.counter("serve_prefills").inc()
            return cache, tok

        r = self.cfg.retry
        try:
            return retry_call(
                attempt, transient=(TransientStepError,),
                max_attempts=r.max_attempts, backoff_s=r.backoff_s,
                backoff_max_s=r.backoff_max_s, jitter=r.jitter,
                max_elapsed_s=r.max_elapsed_s, on_event=self._on_retry_event,
                sleep=self.sleep, clock=self.clock,
            )
        finally:
            self._retry_scope = []

    def _insert(self, cache: dict, row: dict, slot_i: int, n_tokens: int) -> None:
        """Admission surgery: copy a prefilled batch-1 cache into slot row
        ``slot_i`` of ``cache`` and pin its frontier to ``n_tokens`` (the
        valid length)."""
        for key, buf in cache.items():
            if key == "index":
                buf[slot_i] = n_tokens
            else:
                buf[:, slot_i].copy_(row[key][:, 0])
        self._fps_memo = None

    def _do_admit(self, req: Request, slot_i: int, seq: list[int]) -> None:
        self._worked = True
        t_adm = self.clock()
        res = self.results[req.rid]
        res.state = RequestState.PREFILL
        if req.rid not in self._eff_max_new:
            eff = req.max_new_tokens
            over_queue = (
                self.cfg.degrade_watermark > 0
                and (len(self.queue) + 1) / self.cfg.queue_depth
                > self.cfg.degrade_watermark
            )
            # A breaching latency objective degrades admissions as the
            # queue watermark does.
            slo_hot = self.slo is not None and self.slo.degrade_active
            if self.cfg.degrade_max_new_tokens > 0 and (
                over_queue or slo_hot or res.degraded
            ):
                eff = min(eff, self.cfg.degrade_max_new_tokens)
                if eff < req.max_new_tokens:
                    res.degraded = True
                    self.reg.counter("serve_degraded").inc()
            self._eff_max_new[req.rid] = eff

        try:
            self._retry_scope = [req.rid]
            base, base_len = self._prefix_base(req)
            suffix = seq[base_len:]
            padded = _pad_to_bucket(
                suffix, self.cfg.prefill_bucket, self.mcfg.max_seq_len - base_len
            )
            self._retry_scope = [req.rid]
            cache1, tok = self._checked_prefill(
                base, padded, len(suffix), self._adapter_slot(req)
            )
        except TransientStepError as e:
            self._release_slot(req.rid)
            err = RequestFailedError(
                f"request {req.rid}: prefill retries exhausted"
            )
            err.__cause__ = e
            self._finish(req.rid, RequestState.FAILED, err)
            return
        self._insert(self.cache, cache1, slot_i, len(seq))
        if self.lora_on:
            # The slot decodes under this request's adapter from now on.
            self.slot_adapter[slot_i] = self._adapter_slot(req)
        if self.spec_on:
            # The draft is prefilled over the FULL sequence at every
            # admission and re-admission (no prefix store on the draft),
            # its frontier pinned where the target's is.
            dpad = _pad_to_bucket(seq, self.cfg.prefill_bucket, self.mcfg.max_seq_len)
            dcache1, _ = decode_step(
                self.draft, init_cache(self.draft, 1),
                torch.tensor([dpad], dtype=torch.int32, device=self.device),
            )
            self._insert(self.draft_cache, dcache1, slot_i, len(seq))
        slot = self.slots[slot_i]
        slot.rid = req.rid
        slot.frontier = len(seq)
        slot.page_fp = {}
        if self._track_pages and len(seq) >= self.cfg.page_size:
            fps = self._page_fps()
            for p in range(len(seq) // self.cfg.page_size):
                slot.page_fp[p] = float(fps[slot_i, p])
        now = self.clock()
        res.admitted_t = now
        res.state = RequestState.DECODE
        res.tokens.append(tok)
        if res.first_token_t is None:
            res.first_token_t = now
            self.reg.histogram("serve_ttft_s").observe(res.ttft_s or 0.0)
            self.reg.histogram("serve_queue_wait_s").observe(res.queue_wait_s or 0.0)
            if self.lora_on:
                # Per tenant ("base" for base requests), beside the total.
                self.reg.histogram(f"serve_ttft_s.{req.adapter or 'base'}").observe(
                    res.ttft_s or 0.0)
            if self.slo is not None:
                self.slo.observe("serve_ttft_s", res.ttft_s)
                self.slo.observe("serve_queue_wait_s", res.queue_wait_s)
        # The request's waterfall: queued (from submit, or the last
        # eviction) to this admission, then the prefill, on its own track.
        q0 = res.requeued_t
        if q0 is None:
            q0 = res.submitted_t if res.submitted_t is not None else t_adm
        self.tracer.emit_span("req.queued", self._ts(q0), self._ts(t_adm), cat="serve",
                              tid=req.rid, rid=req.rid, iteration=self._it)
        res.requeued_t = None
        self.tracer.emit_span("req.prefill", self._ts(t_adm), self._ts(now), cat="serve",
                              tid=req.rid, rid=req.rid, resident=len(seq),
                              prefix_len=base_len, slot=slot_i)
        if self.goodput is not None:
            # A re-prefill after an eviction is the incident's recompute.
            self.goodput.note("failover_replay" if (res.n_evictions or res.n_hops)
                              else "prefill", now - t_adm)
            self._gp_work += now - t_adm
        self.last_tok[slot_i] = tok
        self.reg.counter("serve_admissions").inc()
        self.reg.emit("serve_admit", rid=req.rid, slot=slot_i, resident=len(seq),
                      prefix_len=base_len, iteration=self._it, adapter=req.adapter)
        self._maybe_complete(slot_i)

    def _ensure_pages(self) -> None:
        """Every active slot needs pages covering its next write (one token
        plain, the verify window under speculation); exhaustion evicts the
        lowest-priority, most-recently-admitted request (possibly the
        grower itself)."""
        step_write = self.cfg.spec.spec_k if self.spec_on else 1
        for slot in self.slots:
            if slot.rid is None:
                continue
            need = self._pages_needed(slot.frontier + step_write)
            while not self.alloc.ensure(slot.rid, need):
                key = self.alloc.evict_prefix_lru()
                if key is not None:
                    self._prefix_store.pop(key, None)
                    self.reg.counter("serve_prefix_evictions").inc()
                    continue
                active = [s.rid for s in self.slots if s.rid is not None]
                victim = min(
                    active,
                    key=lambda r: (
                        self.requests[r].priority,
                        -(self.results[r].admitted_t or 0.0),
                    ),
                )
                self._evict(victim, reason="cache_pressure")
                if slot.rid is None:  # the grower itself was evicted
                    break

    def _decode(self) -> None:
        if self.spec_on:
            return self._decode_spec()
        active = [
            (i, s.rid) for i, s in enumerate(self.slots) if s.rid is not None
        ]
        if not active:
            return
        self._worked = True
        t_dec = self.clock()
        prev_cache = self.cache  # a retry re-runs from here bit-exactly
        toks = torch.as_tensor(self.last_tok, device=self.device)[:, None]
        last_fin = np.ones((self.cfg.slots,), bool)
        lora = (dict(lora=self.lora_stack, lora_ids=self.slot_adapter)
                if self.lora_on else {})

        def attempt():
            nonlocal last_fin
            cache, logits = decode_step(self.model, prev_cache, toks, **lora)
            last = logits[:, -1]
            nxt = torch.argmax(last, dim=-1).to(torch.int32)
            fin = torch.isfinite(last.float()).all(dim=-1).to(torch.int32)
            nxt, fin = torch.stack([nxt, fin]).cpu().numpy()
            last_fin = fin.astype(bool)
            if self.chaos is not None and self.chaos.serve_poison_logits(self._it):
                last_fin[:] = False  # as if the logits had read back NaN
            if not all(bool(last_fin[i]) for i, _ in active):
                raise TransientStepError(
                    f"non-finite logits in decode step (iteration {self._it})"
                )
            return cache, nxt

        r = self.cfg.retry
        self._retry_scope = [rid for _, rid in active]
        try:
            cache, nxt = retry_call(
                attempt, transient=(TransientStepError,),
                max_attempts=r.max_attempts, backoff_s=r.backoff_s,
                backoff_max_s=r.backoff_max_s, jitter=r.jitter,
                max_elapsed_s=r.max_elapsed_s, on_event=self._on_retry_event,
                sleep=self.sleep, clock=self.clock,
            )
        except TransientStepError as e:
            # Only the slots whose logits read non-finite on the last
            # attempt fail; the others keep their slots and retry next
            # iteration (nothing advanced: the frontier is the old one).
            for i, rid in active:
                if bool(last_fin[i]):
                    continue
                self._release_slot(rid)
                err = RequestFailedError(
                    f"request {rid}: decode step retries exhausted"
                )
                err.__cause__ = e
                self._finish(rid, RequestState.FAILED, err)
            return
        finally:
            self._retry_scope = []
            # Every attempt wrote its K/V column in place.
            self._fps_memo = None
        self.cache = cache
        now = self.clock()
        # One scheduler span an iteration over the whole in-flight batch.
        self.tracer.emit_span("decode_step", self._ts(t_dec), self._ts(now), cat="serve",
                              tid="sched", iteration=self._it, batch=len(active))
        if self.goodput is not None:
            self.goodput.note("productive_decode", now - t_dec)
            self._gp_work += now - t_dec
        completed_pages = []
        for i, rid in active:
            slot = self.slots[i]
            tok = int(nxt[i])
            self.results[rid].tokens.append(tok)
            self.last_tok[i] = tok
            slot.frontier += 1  # the step's input token is now resident
            if self._track_pages and slot.frontier % self.cfg.page_size == 0:
                completed_pages.append((i, slot.frontier // self.cfg.page_size - 1))
        if completed_pages:
            fps = self._page_fps()
            for i, p in completed_pages:
                self.slots[i].page_fp[p] = float(fps[i, p])
        for i, _rid in active:
            self._maybe_complete(i, now=now)
        self.reg.counter("serve_decode_steps").inc()
        self.reg.histogram("serve_batch_occupancy").observe(len(active))

    def _decode_spec(self) -> None:
        """One speculative iteration over the in-flight batch: ONE round
        (draft propose, one verify window, greedy accept, rollback) emits
        1..spec_k tokens per active slot. Same retry and poison-localization
        contract as :meth:`_decode`: a retry re-runs the round from the
        pre-round caches, whose frontiers no attempt moved."""
        active = [
            (i, s.rid) for i, s in enumerate(self.slots) if s.rid is not None
        ]
        if not active:
            return
        self._worked = True
        t_dec = self.clock()
        spec_k = self.cfg.spec.spec_k
        prev_cache, prev_draft = self.cache, self.draft_cache
        toks = torch.as_tensor(self.last_tok, device=self.device)[:, None]
        remaining = np.zeros((self.cfg.slots,), np.int32)
        for i, rid in active:
            remaining[i] = max(self._eff_max_new[rid] - len(self.results[rid].tokens), 0)
        rem = torch.as_tensor(remaining, device=self.device)  # 0 freezes idle slots
        last_fin = np.ones((self.cfg.slots,), bool)

        def attempt():
            nonlocal last_fin
            tcache, dcache, _tok, emit, n_emit, fin = spec_round(
                self.model, self.draft, spec_k, prev_cache, prev_draft, toks, rem,
            )
            emit = emit.cpu().numpy()
            n_emit, fin = torch.stack([n_emit, fin.to(torch.int32)]).cpu().numpy()
            last_fin = fin.astype(bool)
            if self.chaos is not None and self.chaos.serve_poison_logits(self._it):
                last_fin[:] = False  # as if the logits had read back NaN
            if not all(bool(last_fin[i]) for i, _ in active):
                raise TransientStepError(
                    f"non-finite logits in spec verify (iteration {self._it})"
                )
            return tcache, dcache, emit, n_emit

        r = self.cfg.retry
        self._retry_scope = [rid for _, rid in active]
        try:
            tcache, dcache, emit, n_emit = retry_call(
                attempt, transient=(TransientStepError,),
                max_attempts=r.max_attempts, backoff_s=r.backoff_s,
                backoff_max_s=r.backoff_max_s, jitter=r.jitter,
                max_elapsed_s=r.max_elapsed_s, on_event=self._on_retry_event,
                sleep=self.sleep, clock=self.clock,
            )
        except TransientStepError as e:
            for i, rid in active:
                if bool(last_fin[i]):
                    continue
                self._release_slot(rid)
                err = RequestFailedError(
                    f"request {rid}: spec verify retries exhausted"
                )
                err.__cause__ = e
                self._finish(rid, RequestState.FAILED, err)
            return
        finally:
            self._retry_scope = []
            self._fps_memo = None  # the verify window wrote in place
        self.cache, self.draft_cache = tcache, dcache
        now = self.clock()
        n_active = len(active)
        emitted = int(sum(int(n_emit[i]) for i, _ in active))
        # The round's seconds split by the share of the verify window that
        # emitted: the rest is draft work the target rejected, billed as
        # its own badput class (a decode_step span and a spec_reject one).
        dur = now - t_dec
        frac = emitted / float(max(n_active * spec_k, 1))
        t_split = t_dec + dur * frac
        self.tracer.emit_span("decode_step", self._ts(t_dec), self._ts(t_split), cat="serve",
                              tid="sched", iteration=self._it, batch=n_active,
                              spec_k=spec_k, emitted=emitted)
        if dur * (1.0 - frac) > 0.0:
            self.tracer.emit_span("spec_reject", self._ts(t_split), self._ts(now),
                                  cat="serve", tid="sched", iteration=self._it,
                                  rejected=n_active * spec_k - emitted)
        if self.goodput is not None:
            self.goodput.note("productive_decode", dur * frac)
            self.goodput.note(SPEC_REJECTED_DRAFT, dur * (1.0 - frac))
            self._gp_work += dur
        completed_pages = []
        psize = self.cfg.page_size
        for i, rid in active:
            slot = self.slots[i]
            res = self.results[rid]
            ne = int(n_emit[i])
            new_toks = [int(t) for t in emit[i, :ne]]
            res.n_spec_proposed += spec_k - 1
            res.n_spec_accepted += max(ne - 1, 0)
            eos = self.requests[rid].eos_id
            if eos is not None and eos in new_toks:
                # Plain decode stops AT the eos: truncate the emission there.
                new_toks = new_toks[: new_toks.index(eos) + 1]
            res.tokens.extend(new_toks)
            if new_toks:
                self.last_tok[i] = new_toks[-1]
            old_pages = slot.frontier // psize
            slot.frontier += ne
            if self._track_pages:
                completed_pages.extend(
                    (i, p) for p in range(old_pages, slot.frontier // psize)
                )
            self.reg.histogram("serve_accepted_per_launch").observe(ne)
        if completed_pages:
            fps = self._page_fps()
            for i, p in completed_pages:
                self.slots[i].page_fp[p] = float(fps[i, p])
        for i, _rid in active:
            self._maybe_complete(i, now=now)
        self._spec_emitted_since += emitted
        self._spec_rounds_since += 1
        self.reg.counter("serve_decode_steps").inc()
        self.reg.counter("serve_spec_rounds").inc()
        self.reg.counter("serve_spec_proposed").inc(n_active * (spec_k - 1))
        self.reg.counter("serve_spec_accepted").inc(emitted - n_active)
        self.reg.counter("serve_spec_rejected").inc(
            n_active * (spec_k - 1) - (emitted - n_active))
        self.reg.histogram("serve_batch_occupancy").observe(n_active)

    # ------------------------------------------------------------------
    # recovery paths
    # ------------------------------------------------------------------
    def _evict(self, rid: str, *, reason: str) -> None:
        """Free one active request's pages and slot and requeue it at the
        head with its generated tokens; re-admission re-prefills prompt +
        generated and resumes."""
        self._release_slot(rid)
        res = self.results[rid]
        res.state = RequestState.EVICTED
        res.n_evictions += 1
        res.requeued_t = self.clock()  # the next req.queued span starts here
        self.queue.insert(0, self.requests[rid])
        self.reg.counter("serve_evictions").inc()
        self.reg.counter(f"serve_evictions.{reason}").inc()
        self.reg.emit("serve_evict", rid=rid, reason=reason, iteration=self._it,
                      generated=len(res.tokens))

    def _preempt_newest(self) -> None:
        """Chaos: evict the most recently admitted active request."""
        active = [s.rid for s in self.slots if s.rid is not None]
        if not active:
            return
        victim = max(active, key=lambda r: self.results[r].admitted_t or 0.0)
        self.reg.counter("serve_preemptions").inc()
        self._evict(victim, reason="preempted")

    def _corruption_candidates(self) -> list:
        """Slots with a completed (checksummed) page: what chaos corruption
        and the verifier can act on."""
        return [(i, s) for i, s in enumerate(self.slots) if s.rid is not None and s.page_fp]

    @torch.no_grad()
    def _inject_corruption(self) -> None:
        """Chaos: overwrite the first completed page of the oldest active
        request with 123.25 in the first KV leaf (``k``: every layer, every
        feature), on the device and in place. The value is finite, so the
        logits' check cannot see it: only the checksum verifier can."""
        cands = self._corruption_candidates()
        if not cands:
            return
        i, slot = min(cands, key=lambda t: self.results[t[1].rid].admitted_t or 0.0)
        start = min(slot.page_fp) * self.cfg.page_size
        self.cache["k"][:, i, start:start + self.cfg.page_size] = 123.25
        self._fps_memo = None

    def _verify_pages(self) -> None:
        """Recompute completed-page checksums; a mismatch is cache-block
        corruption and evicts the request for bit-exact re-prefill."""
        if not any(s.rid is not None and s.page_fp for s in self.slots):
            return
        fps = self._page_fps()
        for i, slot in enumerate(self.slots):
            if slot.rid is None:
                continue
            for p, fp in slot.page_fp.items():
                if float(fps[i, p]) != fp:
                    self.reg.counter("serve_corruptions").inc()
                    self.reg.emit("serve_corruption", rid=slot.rid, slot=i, page=p,
                                  iteration=self._it)
                    rid = slot.rid
                    self._evict(rid, reason="corruption")
                    self.dump_flight("serve_corruption", rid=rid, iteration=self._it)
                    break

    # ------------------------------------------------------------------
    # bookkeeping
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _fingerprints(self) -> torch.Tensor:
        """Integrity checksums of every page of every slot in one pass: a
        ``(slots, n_pages)`` fp32 table of position-weighted SIGNED sums
        over layers, positions and features (sign flips and permutations
        within a page change it). Deterministic for identical bytes."""
        psize = self.cfg.page_size
        total = None
        for key in ("k", "k_scale", "v", "v_scale"):
            leaf = self.cache.get(key)
            if leaf is None:
                continue
            l, b, s, x = leaf.shape
            n_pages = s // psize
            blk = leaf[:, :, : n_pages * psize].reshape(l, b, n_pages, psize, x).float()
            dev = leaf.device
            w_l = 1.0 + 0.127 * torch.arange(l, dtype=torch.float32, device=dev)
            w_p = 1.0 + 0.3183 * torch.arange(psize, dtype=torch.float32, device=dev)
            w_f = 1.0 + 0.0721 * torch.arange(x, dtype=torch.float32, device=dev)
            w = w_l[:, None, None, None, None] * w_p[:, None] * w_f
            fp = (blk * w).sum(dim=(0, 3, 4))
            total = fp if total is None else total + fp
        return total

    def _page_fps(self) -> np.ndarray:
        """The checksum table, one transfer, memoized per cache version."""
        if self._fps_memo is None:
            self._fps_memo = self._fingerprints().cpu().numpy()
        return self._fps_memo

    def _maybe_complete(self, slot_i: int, now: float | None = None) -> None:
        slot = self.slots[slot_i]
        rid = slot.rid
        if rid is None:
            return
        req = self.requests[rid]
        res = self.results[rid]
        done = len(res.tokens) >= self._eff_max_new[rid] or (
            req.eos_id is not None and res.tokens and res.tokens[-1] == req.eos_id
        )
        if done:
            self._release_slot(rid)
            self._finish(rid, RequestState.DONE, None, now=now)

    def _release_slot(self, rid: str) -> None:
        for i, slot in enumerate(self.slots):
            if slot.rid == rid:
                slot.rid = None
                slot.frontier = 0
                slot.page_fp = {}
                if self.lora_on:
                    self.slot_adapter[i] = BASE_SLOT
        self.alloc.free(rid)

    def _finish(
        self, rid: str, state: RequestState, error, now: float | None = None
    ) -> None:
        res = self.results[rid]
        res.state = state
        res.error = error
        res.finished_t = self.clock() if now is None else now
        self._deadline.pop(rid, None)
        self._eff_max_new.pop(rid, None)
        req = self.requests.pop(rid, None)
        if self.lora_on and req is not None and req.adapter is not None:
            self.adapter_store.release(req.adapter)  # unpinned at terminal
        self.reg.counter(f"serve_{state.value}").inc()
        if state is RequestState.DONE and res.ms_per_token is not None:
            self.reg.histogram("serve_ms_per_token").observe(res.ms_per_token)
            if self.lora_on:
                self.reg.histogram(f"serve_ms_per_token.{res.adapter or 'base'}").observe(
                    res.ms_per_token)
            if self.slo is not None:
                self.slo.observe("serve_ms_per_token", res.ms_per_token)
        if res.accept_rate is not None:
            # Every terminal outcome: a shed request's acceptance is still
            # telemetry about the draft's fit.
            self.reg.histogram("serve_accept_rate").observe(res.accept_rate)
        if self.slo is not None:
            self.slo.observe_outcome("serve_outcome_shed", state is RequestState.SHED)
        # Close the request's span chain: its decode (first token to
        # terminal, across any eviction gaps) and a terminal instant.
        if res.first_token_t is not None:
            self.tracer.emit_span("req.decode", self._ts(res.first_token_t),
                                  self._ts(res.finished_t), cat="serve", tid=rid, rid=rid,
                                  n_tokens=len(res.tokens))
        self.tracer.instant(f"req.{state.value}", cat="serve", tid=rid,
                            t=self._ts(res.finished_t), rid=rid,
                            error=type(error).__name__ if error else None)
        self.reg.emit("serve_request", iteration=self._it, **res.summary())
        if state is RequestState.FAILED and not self._in_shutdown:
            self.dump_flight(f"request_failed: {rid}", rid=rid)

    def _on_retry_event(self, etype: str, **fields: Any) -> None:
        self.reg.counter("serve_retries").inc()
        for rid in self._retry_scope:
            self.results[rid].n_retries += 1
        self.bus.post(etype, **fields)

    def _ts(self, t: float) -> float:
        """Scheduler-clock time on the emission (wall-clock) timebase."""
        return t + self._epoch0

    def dump_flight(self, reason: str, **meta: Any) -> str | None:
        """Dump the flight-recorder ring (the telemetry owns the file; a
        bare engine keeps the ring in memory)."""
        if self.telemetry is not None:
            return self.telemetry.dump_flight(reason, **meta)
        return None

    def _drain_bus(self) -> None:
        """Move the bus's chaos and recovery records into the event stream;
        every chaos record also dumps the flight recorder."""
        drain_bus(self.bus, self.reg, "iteration", self._it,
                  on_chaos=lambda f: self.dump_flight(f"chaos: {f.get('kind', '?')}",
                                                      iteration=self._it))
