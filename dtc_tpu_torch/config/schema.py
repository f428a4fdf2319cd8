"""Typed configuration schema for the PyTorch port.

The port keeps its own copy of the dataclasses the serving and training
paths read (``ModelConfig``, ``AdapterConfig``, ``ServeConfig``,
``RouterConfig``, ``OptimConfig``, ``TrainConfig`` and their
sub-configs): every field, default and validator is the same as in the
JAX package, so one set of YAML files under ``configs/`` loads unchanged
into either. Fields that only
the JAX package acts on (Pallas block sizes, collectives, PRNG impl) are
kept so the YAMLs stay valid; the port ignores them, and refuses with
``NotImplementedError`` the ones that name a feature it has not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field

#: Bytes per element of every dtype a config knob can name.
DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}

#: Parallel strategies a TrainConfig can name.
VALID_PARALLEL = ("none", "dp", "tp", "pp", "3d", "fsdp")

#: Dense layers a LoRA adapter can target.
ADAPTER_TARGETS = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")


@dataclass(frozen=True)
class AdapterConfig:
    """LoRA adapter knobs. ``rank == 0`` (the default) disables adapters
    and leaves the model bitwise as without them; ``rank > 0`` gives every
    targeted dense layer a low-rank delta ``(alpha / rank) * B (A x)`` whose
    factors are passed per call (``dtc_tpu_torch.adapters``). ``dropout``
    applies to the adapter's input in training (the finetune) only."""

    rank: int = 0
    alpha: float = 16.0
    dropout: float = 0.0
    target_modules: tuple = ADAPTER_TARGETS

    def __post_init__(self) -> None:
        # YAML gives a list; keep the config hashable.
        if not isinstance(self.target_modules, tuple):
            object.__setattr__(
                self, "target_modules", tuple(self.target_modules)
            )
        if self.rank < 0:
            raise ValueError(f"adapter rank must be >= 0, got {self.rank}")
        if self.rank > 0 and self.alpha <= 0:
            raise ValueError(f"adapter alpha must be > 0, got {self.alpha}")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(
                f"adapter dropout must be in [0, 1), got {self.dropout}"
            )
        unknown = [t for t in self.target_modules if t not in ADAPTER_TARGETS]
        if unknown:
            raise ValueError(
                f"unknown adapter target_modules {unknown}; valid: "
                f"{list(ADAPTER_TARGETS)}"
            )
        if self.rank > 0 and not self.target_modules:
            raise ValueError("adapter rank > 0 with empty target_modules")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank if self.rank > 0 else 0.0


@dataclass(frozen=True)
class ModelConfig:
    """GPT model hyperparameters (decoder-only, pre-LN, learned positions)."""

    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    d_ff: int
    max_seq_len: int
    dropout: float = 0.0
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    attention: str = "auto"          # auto | dense | flash | ring | ulysses
    attention_block_q: int = 512
    attention_block_kv: int = 512
    attention_block_q_bwd: int = 0
    attention_block_kv_bwd: int = 0
    remat: bool | str = False
    vocab_pad_multiple: int = 128    # padded vocab; pad logits masked to -1e9
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01
    moe_dispatch: str = "einsum"
    # Single-token decode attention: "fused" = the hand-written decode
    # kernel (ops/decode_attention.py), "xla" = the plain masked softmax
    # (ops/attention.py), "fused_layers" = the layer-fused decode
    # megakernel (ops/decode_fused.py, one launch for all layers).
    decode_attention: str = "fused"
    # KV-cache storage dtype: auto (= compute_dtype) | float32 | bfloat16
    # (aliases fp32/bf16) | int8 (per-(position, head) scales).
    kv_cache_dtype: str = "auto"
    collectives: str = "xla"
    debug_checks: bool = False
    adapter: AdapterConfig = field(default_factory=AdapterConfig)

    def __post_init__(self) -> None:
        if self.d_model % self.n_heads != 0:
            raise ValueError(
                f"d_model={self.d_model} not divisible by n_heads={self.n_heads}"
            )
        if self.attention not in ("auto", "dense", "flash", "ring", "ulysses"):
            raise ValueError(f"unknown attention impl {self.attention!r}")
        if self.moe_experts < 0:
            raise ValueError("moe_experts must be >= 0")
        if self.moe_experts > 0 and not 1 <= self.moe_top_k <= self.moe_experts:
            raise ValueError(
                f"moe_top_k={self.moe_top_k} must be in [1, moe_experts="
                f"{self.moe_experts}]"
            )
        if self.moe_experts > 0 and self.moe_capacity_factor <= 0:
            raise ValueError(
                f"moe_capacity_factor must be > 0, got {self.moe_capacity_factor}"
            )
        if self.moe_dispatch not in ("einsum", "sort"):
            raise ValueError(
                f"unknown moe_dispatch {self.moe_dispatch!r}; "
                "expected 'einsum' or 'sort'"
            )
        if self.decode_attention not in ("fused_layers", "fused", "xla"):
            raise ValueError(
                f"unknown decode_attention {self.decode_attention!r}; "
                "expected 'fused_layers', 'fused' or 'xla'"
            )
        if self.collectives not in ("xla", "overlapped"):
            raise ValueError(
                f"unknown collectives {self.collectives!r}; expected "
                "'xla' or 'overlapped'"
            )
        aliases = {"fp32": "float32", "bf16": "bfloat16"}
        if self.kv_cache_dtype in aliases:
            object.__setattr__(
                self, "kv_cache_dtype", aliases[self.kv_cache_dtype]
            )
        if self.kv_cache_dtype not in ("auto", "float32", "bfloat16", "int8"):
            raise ValueError(
                f"unknown kv_cache_dtype {self.kv_cache_dtype!r}; expected "
                "'auto' (= compute_dtype), 'fp32'/'float32', "
                "'bf16'/'bfloat16' or 'int8'"
            )
        if (
            self.moe_experts > 0
            and self.adapter.rank > 0
            and not any(
                t not in ("fc1", "fc2") for t in self.adapter.target_modules
            )
        ):
            raise ValueError(
                "adapter.target_modules contains only fc1/fc2, but "
                f"moe_experts={self.moe_experts} replaces the dense MLP — "
                "no adapter site would exist; target at least one attention "
                "projection (q_proj/k_proj/v_proj/out_proj)"
            )
        if self.attention_block_q <= 0 or self.attention_block_kv <= 0:
            raise ValueError(
                f"attention_block_q/kv must be > 0, got "
                f"{self.attention_block_q}/{self.attention_block_kv}"
            )
        if self.attention_block_q_bwd < 0 or self.attention_block_kv_bwd < 0:
            raise ValueError(
                f"attention_block_{{q,kv}}_bwd must be >= 0 (0 = same as "
                f"forward), got {self.attention_block_q_bwd}/"
                f"{self.attention_block_kv_bwd}"
            )
        if self.remat_mode not in ("none", "block", "block_save_flash", "mlp"):
            raise ValueError(
                f"unknown remat {self.remat!r}; expected bool, 'none', 'block', "
                "'block_save_flash' or 'mlp'"
            )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_store_dtype(self) -> str:
        """``kv_cache_dtype`` resolved: "auto" means the compute dtype."""
        if self.kv_cache_dtype == "auto":
            return self.compute_dtype
        return self.kv_cache_dtype

    @property
    def kv_quantized(self) -> bool:
        return self.kv_store_dtype == "int8"

    @property
    def remat_mode(self) -> str:
        if isinstance(self.remat, bool):
            return "block" if self.remat else "none"
        return self.remat

    @property
    def padded_vocab_size(self) -> int:
        m = max(self.vocab_pad_multiple, 1)
        return ((self.vocab_size + m - 1) // m) * m


@dataclass(frozen=True)
class SloConfig:
    """Online SLO objectives (0 = off). The trainer's telemetry evaluates
    the training objectives (``step_time_p99_s``, ``data_wait_p99_s``,
    ``goodput_min_pct``); the serving engine the serving ones (TTFT,
    queue wait, ms per token, shed rate, accepted tokens/s), where a
    breaching latency objective caps admissions at
    ``degrade_max_new_tokens``."""

    enabled: bool = True
    window: int = 64
    min_samples: int = 4
    check_every: int = 8
    ttft_p99_s: float = 0.0
    ms_per_token_p99: float = 0.0
    queue_wait_p99_s: float = 0.0
    shed_rate: float = 0.0
    accepted_tokens_per_s_min: float = 0.0
    step_time_p99_s: float = 0.0
    data_wait_p99_s: float = 0.0
    goodput_min_pct: float = 0.0

    def __post_init__(self) -> None:
        if self.window < 2:
            raise ValueError("slo window must be >= 2")
        if self.min_samples < 1:
            raise ValueError("slo min_samples must be >= 1")
        if self.check_every < 1:
            raise ValueError("slo check_every must be >= 1")
        for f in ("ttft_p99_s", "ms_per_token_p99", "queue_wait_p99_s",
                  "step_time_p99_s", "data_wait_p99_s",
                  "accepted_tokens_per_s_min"):
            if getattr(self, f) < 0:
                raise ValueError(f"slo {f} must be >= 0 (0 = off)")
        if not 0.0 <= self.shed_rate <= 1.0:
            raise ValueError("slo shed_rate must be in [0, 1] (0 = off)")
        if not 0.0 <= self.goodput_min_pct <= 100.0:
            raise ValueError("slo goodput_min_pct must be in [0, 100] (0 = off)")

    @property
    def any_objective(self) -> bool:
        return any(
            getattr(self, f) > 0 for f in (
                "ttft_p99_s", "ms_per_token_p99", "queue_wait_p99_s",
                "shed_rate", "accepted_tokens_per_s_min", "step_time_p99_s",
                "data_wait_p99_s", "goodput_min_pct",
            )
        )


@dataclass(frozen=True)
class WatchdogConfig:
    """Hung-step watchdog: flags steps longer than ``factor`` x the
    trailing median; ``hard_timeout_s > 0`` aborts steps that never end."""

    enabled: bool = False
    factor: float = 8.0
    min_samples: int = 5
    hard_timeout_s: float = 0.0
    profile_on_flag: bool = False

    def __post_init__(self) -> None:
        if self.factor <= 1.0:
            raise ValueError(f"watchdog factor must be > 1.0, got {self.factor}")
        if self.hard_timeout_s < 0:
            raise ValueError("hard_timeout_s must be >= 0")


@dataclass(frozen=True)
class StreamRetryConfig:
    """Retry knobs: bounded attempts, exponential backoff with jitter, and
    an optional wall-clock cap on one fault episode (0 = unbounded)."""

    enabled: bool = True
    max_attempts: int = 5
    backoff_s: float = 1.0
    backoff_max_s: float = 30.0
    jitter: float = 0.1
    max_elapsed_s: float = 0.0

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.backoff_s < 0 or self.backoff_max_s < 0 or self.jitter < 0:
            raise ValueError("backoff/jitter values must be >= 0")
        if self.max_elapsed_s < 0:
            raise ValueError("max_elapsed_s must be >= 0 (0 = unbounded)")


@dataclass(frozen=True)
class ChaosConfig:
    """Deterministic fault injection (dev/test), read by
    :class:`dtc_tpu_torch.resilience.chaos.ChaosInjector`: the trainer
    consults the data, NaN, checkpoint and SIGTERM faults, the serving
    engine the ``serve_*`` ones. The elastic kinds need
    ``resilience.elastic``, which the trainer refuses."""

    enabled: bool = False
    data_error_at_doc: int = 0
    data_stall_at_doc: int = 0
    stall_s: float = 0.0
    corrupt_ckpt_at_step: int = 0
    corrupt_mode: str = "truncate"
    nan_at_step: int = 0
    sigterm_at_step: int = 0
    serve_preempt_at_step: int = 0
    serve_corrupt_page_at_step: int = 0
    serve_stall_at_step: int = 0
    serve_poison_logits_at_step: int = 0
    fleet_kill_replica_at_step: int = 0
    fleet_stall_replica_at_step: int = 0
    fleet_partition_at_step: int = 0
    fleet_partition_iters: int = 2
    fleet_target_replica: int = 0
    kill_host_at_step: int = 0
    slow_host_at_step: int = 0
    slow_host_iters: int = 1
    lose_snapshot_at_step: int = 0
    torn_cold_spill_at_step: int = 0
    elastic_target_host: int = 0
    pool_spike_mid_grow_at: int = 0
    pool_spike_requests: int = 8
    pool_kill_mid_shrink_at: int = 0
    pool_kill_draining_replica_at: int = 0

    def __post_init__(self) -> None:
        if self.corrupt_mode not in ("truncate", "flip"):
            raise ValueError(f"unknown corrupt_mode {self.corrupt_mode!r}")
        if self.stall_s < 0:
            raise ValueError("stall_s must be >= 0")
        if self.fleet_partition_iters < 1:
            raise ValueError("fleet_partition_iters must be >= 1")
        if self.fleet_target_replica < 0:
            raise ValueError("fleet_target_replica must be >= 0")
        if self.slow_host_iters < 1:
            raise ValueError("slow_host_iters must be >= 1")
        if self.elastic_target_host < 0:
            raise ValueError("elastic_target_host must be >= 0")
        if self.pool_spike_requests < 1:
            raise ValueError("pool_spike_requests must be >= 1")


@dataclass(frozen=True)
class SpecConfig:
    """Speculative decoding (0 = off): ``spec_k >= 2`` serves through a
    draft rung of the target's bottom ``draft_layers`` blocks and one
    verify window of ``spec_k`` tokens per iteration
    (:mod:`dtc_tpu_torch.spec`). The serving engine takes greedy
    acceptance only and needs ``decode_attention`` ``fused_layers`` or
    ``xla``."""

    spec_k: int = 0
    draft_layers: int = 0
    acceptance: str = "greedy"

    def __post_init__(self) -> None:
        if self.spec_k != 0 and not 2 <= self.spec_k <= 8:
            raise ValueError(
                f"spec_k must be 0 (off) or in [2, 8], got {self.spec_k}"
            )
        if self.spec_k > 0 and self.draft_layers < 1:
            raise ValueError(
                "draft_layers must be >= 1 when speculation is on "
                f"(spec_k={self.spec_k})"
            )
        if self.draft_layers < 0:
            raise ValueError("draft_layers must be >= 0")
        if self.acceptance not in ("greedy", "sampled"):
            raise ValueError(
                f"unknown spec acceptance {self.acceptance!r}; expected "
                "'greedy' or 'sampled'"
            )

    @property
    def enabled(self) -> bool:
        return self.spec_k >= 2


@dataclass(frozen=True)
class ServeConfig:
    """Serving-runtime configuration: continuous batching over ``slots``
    fixed batch slots and a paged KV budget, with admission control,
    deadlines, shedding, degradation, retry, page checksums and a
    hung-step watchdog. See ``configs/serve_config.yaml`` for the knobs."""

    slots: int = 4
    page_size: int = 16
    total_pages: int = 0
    pool_hbm_bytes: int = 0
    queue_depth: int = 64
    max_new_tokens: int = 64
    deadline_s: float = 0.0
    prefill_bucket: int = 32
    shed_watermark: float = 0.75
    shed_policy: str = "priority"
    degrade_watermark: float = 0.0
    degrade_max_new_tokens: int = 16
    max_adapters: int = 8
    verify_pages_every: int = 0
    retry: StreamRetryConfig = field(default_factory=lambda: StreamRetryConfig(
        max_attempts=3, backoff_s=0.05, backoff_max_s=1.0, jitter=0.0,
        max_elapsed_s=10.0,
    ))
    watchdog: WatchdogConfig = field(
        default_factory=lambda: WatchdogConfig(enabled=True)
    )
    chaos: ChaosConfig = field(default_factory=ChaosConfig)
    slo: SloConfig = field(default_factory=SloConfig)
    spec: SpecConfig = field(default_factory=SpecConfig)

    def __post_init__(self) -> None:
        if self.slots < 1:
            raise ValueError("slots must be >= 1")
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")
        if self.total_pages < 0:
            raise ValueError("total_pages must be >= 0 (0 = auto)")
        if self.pool_hbm_bytes < 0:
            raise ValueError("pool_hbm_bytes must be >= 0 (0 = off)")
        if self.pool_hbm_bytes > 0 and self.total_pages > 0:
            raise ValueError(
                "total_pages and pool_hbm_bytes are mutually exclusive pool "
                "sizings — set one (pages) or the other (bytes), not both"
            )
        if self.queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.prefill_bucket < 1:
            raise ValueError("prefill_bucket must be >= 1")
        if not 0.0 <= self.shed_watermark <= 1.0:
            raise ValueError("shed_watermark must be in [0, 1]")
        if not 0.0 <= self.degrade_watermark <= 1.0:
            raise ValueError("degrade_watermark must be in [0, 1] (0 = off)")
        if self.shed_policy not in ("priority", "longest_queued"):
            raise ValueError(
                f"unknown shed_policy {self.shed_policy!r}; expected "
                "'priority' or 'longest_queued'"
            )
        if self.deadline_s < 0 or self.verify_pages_every < 0:
            raise ValueError("deadline_s/verify_pages_every must be >= 0")
        if self.max_adapters < 2:
            raise ValueError(
                "max_adapters must be >= 2 (slot 0 is the pinned base "
                "adapter; at least one tenant slot must remain)"
            )
        if (
            self.chaos.enabled
            and self.chaos.serve_corrupt_page_at_step > 0
            and self.verify_pages_every <= 0
        ):
            raise ValueError(
                "chaos.serve_corrupt_page_at_step requires "
                "verify_pages_every >= 1: injected cache-block corruption "
                "would otherwise never be detected"
            )
        if self.spec.enabled and self.spec.acceptance != "greedy":
            raise ValueError(
                "serving speculation supports acceptance='greedy' only"
            )


@dataclass(frozen=True)
class RouterConfig:
    """The serving fleet (:mod:`dtc_tpu_torch.serve.router`): a front-end
    router over ``n_replicas`` serving engines with cache-affinity
    placement, fleet backpressure, health-state routing and failover. See
    ``configs/router_config.yaml`` for the knobs."""

    n_replicas: int = 2
    # "affinity": a tenant's adapter residency first, then the shared
    # prefix's, then least loaded; "least_loaded" skips the affinities;
    # "round_robin" is the control.
    placement: str = "affinity"
    # Missed heartbeats before an unreachable replica is declared dead and
    # its requests fail over; shorter partitions heal in place.
    heartbeat_miss_limit: int = 3
    # Iterations without a fresh bad-health signal (a hung-step flag, an
    # SLO degrade) before a DEGRADED replica attracts new work again.
    degraded_hold_iters: int = 16
    # Failover hops a request may take before it ends typed
    # (RequestFailedError).
    failover_max_hops: int = 3
    # Step budget of each replica's drain (router drain or SIGTERM).
    drain_max_steps: int = 512
    # Each replica's engine config.
    serve: ServeConfig = field(default_factory=ServeConfig)
    # Retries of a momentarily unreachable replica before the router
    # routes around it.
    retry: StreamRetryConfig = field(default_factory=lambda: StreamRetryConfig(
        max_attempts=3, backoff_s=0.02, backoff_max_s=0.5, jitter=0.0,
        max_elapsed_s=5.0,
    ))
    # The replica-level hung-step watchdog over whole replica steps (a
    # stall outside the engine's timed iteration); less twitchy than the
    # engine's own (factor 16, 8 samples), since its flag degrades the
    # replica.
    watchdog: WatchdogConfig = field(
        default_factory=lambda: WatchdogConfig(
            enabled=True, factor=16.0, min_samples=8,
        )
    )
    # Fleet-level faults (fleet_kill_replica / fleet_stall_replica /
    # fleet_partition); serve-level ones go on serve.chaos, once a replica.
    chaos: ChaosConfig = field(default_factory=ChaosConfig)

    def __post_init__(self) -> None:
        if self.n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        if self.placement not in ("affinity", "least_loaded", "round_robin"):
            raise ValueError(
                f"unknown placement {self.placement!r}; expected 'affinity', "
                "'least_loaded' or 'round_robin'"
            )
        if self.heartbeat_miss_limit < 1:
            raise ValueError("heartbeat_miss_limit must be >= 1")
        if self.degraded_hold_iters < 1:
            raise ValueError("degraded_hold_iters must be >= 1")
        if self.failover_max_hops < 0:
            raise ValueError("failover_max_hops must be >= 0")
        if self.drain_max_steps < 1:
            raise ValueError("drain_max_steps must be >= 1")
        # fleet_target_replica is judged when the fault fires (the replica
        # set changes under spawn and retire), not here.


@dataclass(frozen=True)
class PoolConfig:
    """The resource pool (:mod:`dtc_tpu_torch.pool`): one fixed set of
    virtual hosts arbitrated between the serving fleet and the elastic
    trainer, each host leased to one tenant at a time (a serving host runs
    one replica, a training host adds its devices to the train mesh). A
    GROW moves hosts serve -> train, a SHRINK train -> serve. See
    ``configs/pool_config.yaml`` for the knobs."""

    # Virtual hosts the pool's devices split into (8 virtual devices / 4
    # hosts = 2 a host).
    n_hosts: int = 4
    # Hosts first leased to the trainer (the high ids); every other host
    # runs one serving replica.
    train_hosts: int = 2
    # Floors on each tenant's lease.
    min_serve_hosts: int = 1
    min_train_hosts: int = 1
    # The train mesh's model axis; every legal lease must divide by it.
    model_axis: int = 1
    # The global train batch, kept across every resize.
    global_batch: int = 8
    # The training budget the pool completes.
    train_steps: int = 12
    # The train tenant's hot-tier snapshot cadence and retention.
    snapshot_every: int = 1
    snapshot_keep: int = 4
    # Missed heartbeats before the train tenant's monitor declares a host lost.
    heartbeat_miss_limit: int = 2
    # Ticks with an empty fleet queue before the pool asks a GROW of idle
    # serving hosts.
    grow_after_idle_ticks: int = 2
    # Pending requests per accepting replica above which the pool takes
    # capacity back for serving (a SHRINK, then a replica on the freed host).
    spike_queue_depth: int = 3
    # The fleet front-end; n_replicas is set from the leases.
    router: RouterConfig = field(default_factory=RouterConfig)
    # Pool-level faults (pool_spike_mid_grow / pool_kill_mid_shrink /
    # pool_kill_draining_replica).
    chaos: ChaosConfig = field(default_factory=ChaosConfig)

    def __post_init__(self) -> None:
        if self.n_hosts < 2:
            raise ValueError("pool.n_hosts must be >= 2")
        # min_serve_hosts 0 is legal: a full grow leases every host to the
        # trainer and arriving requests park in the pool.
        if self.min_serve_hosts < 0 or self.min_train_hosts < 1:
            raise ValueError(
                "pool.min_serve_hosts must be >= 0 and pool.min_train_hosts >= 1"
            )
        if not (self.min_train_hosts <= self.train_hosts
                <= self.n_hosts - self.min_serve_hosts):
            raise ValueError(
                f"pool.train_hosts {self.train_hosts} violates the lease "
                f"floors (min_train_hosts={self.min_train_hosts}, "
                f"min_serve_hosts={self.min_serve_hosts}, "
                f"n_hosts={self.n_hosts})"
            )
        if self.model_axis < 1:
            raise ValueError("pool.model_axis must be >= 1")
        if self.global_batch < 1 or self.train_steps < 1:
            raise ValueError("pool.global_batch/train_steps must be >= 1")
        if self.snapshot_every < 1:
            raise ValueError("pool.snapshot_every must be >= 1")
        if self.snapshot_keep < 2:
            raise ValueError("pool.snapshot_keep must be >= 2")
        if self.heartbeat_miss_limit < 1:
            raise ValueError("pool.heartbeat_miss_limit must be >= 1")
        if self.grow_after_idle_ticks < 1:
            raise ValueError("pool.grow_after_idle_ticks must be >= 1")
        if self.spike_queue_depth < 1:
            raise ValueError("pool.spike_queue_depth must be >= 1")
        if (self.chaos.enabled and self.chaos.pool_kill_mid_shrink_at > 0
                and self.chaos.elastic_target_host >= self.n_hosts):
            raise ValueError(
                f"chaos.elastic_target_host {self.chaos.elastic_target_host} "
                f"outside the pool (n_hosts={self.n_hosts})"
            )


@dataclass(frozen=True)
class OptimConfig:
    """Optimizer: global-norm clip, then AdamW, with a constant or
    linear-warmup + cosine-decay learning rate. ``precision`` is ``fp32``
    or ``bf16_mixed`` (bf16 model, fp32 master weights and moments)."""

    lr: float
    weight_decay: float
    grad_clip: float
    b1: float = 0.9
    b2: float = 0.999
    schedule: str = "constant"  # constant | warmup_cosine
    warmup_steps: int = 0
    min_lr_ratio: float = 0.1
    precision: str = "fp32"

    def __post_init__(self) -> None:
        if self.schedule not in ("constant", "warmup_cosine"):
            raise ValueError(f"unknown schedule {self.schedule!r}")
        if self.precision not in ("fp32", "bf16_mixed"):
            raise ValueError(
                f"unknown precision {self.precision!r}; expected 'fp32' "
                "(all-float32 state) or 'bf16_mixed' (bf16 params/compute "
                "+ fp32 master weights and moments)"
            )


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh axis sizes (0 = auto) plus inter-slice factors."""

    pipe: int = 0
    data: int = 0
    model: int = 0
    dcn_pipe: int = 1
    dcn_data: int = 1
    dcn_model: int = 1


@dataclass(frozen=True)
class ObsConfig:
    """Telemetry knobs (JSONL events, spans, flight recorder, device
    profiles, goodput) of the trainer (:mod:`dtc_tpu_torch.obs`); the
    serving engine has none yet."""

    enabled: bool = True
    jsonl: bool = True
    dir: str = ""
    memory_sample_every: int = 50
    straggler_threshold: float = 1.5
    profile_start: int = 0
    profile_stop: int = 0
    trace: bool = True
    flight_recorder: int = 256
    rotate_mb: float = 0.0
    devprof_every: int = 0
    devprof_steps: int = 2
    devprof_on_trigger: bool = True
    goodput: bool = True
    goodput_counter_every: int = 8

    def __post_init__(self) -> None:
        if self.memory_sample_every < 0:
            raise ValueError("memory_sample_every must be >= 0")
        if self.straggler_threshold < 1.0:
            raise ValueError(
                f"straggler_threshold must be >= 1.0, got {self.straggler_threshold}"
            )
        if self.flight_recorder < 0:
            raise ValueError("flight_recorder must be >= 0 (0 = off)")
        if self.rotate_mb < 0:
            raise ValueError("rotate_mb must be >= 0 (0 = no rotation)")
        if self.devprof_every < 0:
            raise ValueError("devprof_every must be >= 0 (0 = no cadence)")
        if self.devprof_steps < 1:
            raise ValueError("devprof_steps must be >= 1")
        if self.goodput_counter_every < 0:
            raise ValueError(
                "goodput_counter_every must be >= 0 (0 = no counter track)"
            )


@dataclass(frozen=True)
class GuardConfig:
    """Anomaly guard: loss-health checks at log boundaries. With no
    checkpoint to roll back to it only reports."""

    enabled: bool = True
    spike_factor: float = 0.0
    spike_window: int = 32
    max_rollbacks: int = 3
    clean_steps_to_forgive: int = 0
    skip_nonfinite_updates: bool = False
    max_consecutive_skips: int = 10

    def __post_init__(self) -> None:
        if self.spike_factor < 0:
            raise ValueError("spike_factor must be >= 0 (0 = disabled)")
        if self.max_rollbacks < 0:
            raise ValueError("max_rollbacks must be >= 0")
        if self.clean_steps_to_forgive < 0:
            raise ValueError(
                "clean_steps_to_forgive must be >= 0 (0 = lifetime budget)"
            )


@dataclass(frozen=True)
class ElasticConfig:
    """Elastic training (:mod:`dtc_tpu_torch.resilience.elastic`): in-memory
    snapshots with peer redundancy, heartbeat host-loss detection and
    shrink-and-continue over virtual hosts in one process (synthetic data,
    pipe 1, no LoRA)."""

    enabled: bool = False
    snapshot_every: int = 1
    keep: int = 4
    n_virtual_hosts: int = 2
    heartbeat_miss_limit: int = 2
    cold_every: int = 0
    spill_on_resize: bool = True
    dead_hosts: tuple = ()

    def __post_init__(self) -> None:
        if not isinstance(self.dead_hosts, tuple):  # YAML list coercion
            object.__setattr__(self, "dead_hosts", tuple(self.dead_hosts))
        if self.snapshot_every < 1:
            raise ValueError("elastic.snapshot_every must be >= 1")
        if self.keep < 2:
            raise ValueError("elastic.keep must be >= 2 (double buffer)")
        if self.n_virtual_hosts < 2:
            raise ValueError("elastic.n_virtual_hosts must be >= 2")
        if self.heartbeat_miss_limit < 1:
            raise ValueError("elastic.heartbeat_miss_limit must be >= 1")
        if self.cold_every < 0:
            raise ValueError("elastic.cold_every must be >= 0 (0 = keep)")
        if any(h < 0 for h in self.dead_hosts):
            raise ValueError("elastic.dead_hosts entries must be >= 0")
        if any(h >= self.n_virtual_hosts for h in self.dead_hosts):
            raise ValueError(
                f"elastic.dead_hosts {self.dead_hosts} outside "
                f"n_virtual_hosts={self.n_virtual_hosts}"
            )
        if len(self.dead_hosts) >= self.n_virtual_hosts:
            raise ValueError("elastic.dead_hosts names every host dead")


@dataclass(frozen=True)
class ResilienceConfig:
    """Fault-tolerance knobs: anomaly guard, watchdog, stream retry, chaos,
    elastic training and checkpoint verification/retention."""

    guard: GuardConfig = field(default_factory=GuardConfig)
    watchdog: WatchdogConfig = field(default_factory=WatchdogConfig)
    stream_retry: StreamRetryConfig = field(default_factory=StreamRetryConfig)
    chaos: ChaosConfig = field(default_factory=ChaosConfig)
    elastic: ElasticConfig = field(default_factory=ElasticConfig)
    verify_checkpoints: bool = True
    checkpoint_keep_n: int = 3

    def __post_init__(self) -> None:
        if self.checkpoint_keep_n < 1:
            raise ValueError("checkpoint_keep_n must be >= 1")
        if (
            self.chaos.enabled
            and not self.elastic.enabled
            and (
                self.chaos.kill_host_at_step
                or self.chaos.slow_host_at_step
                or self.chaos.lose_snapshot_at_step
            )
        ):
            raise ValueError(
                "chaos elastic faults (kill_host_at_step / slow_host_at_step"
                " / lose_snapshot_at_step) require resilience.elastic.enabled"
                " — without the elastic layer they would silently never fire"
            )
        if (
            self.elastic.enabled
            and self.chaos.enabled
            and self.chaos.elastic_target_host >= self.elastic.n_virtual_hosts
        ):
            raise ValueError(
                f"chaos.elastic_target_host {self.chaos.elastic_target_host} "
                f"outside n_virtual_hosts={self.elastic.n_virtual_hosts}"
            )


@dataclass(frozen=True)
class TrainConfig:
    """Training-run configuration (``configs/train_config_*.yaml``).
    ``sync_every_step: None`` means a device sync every step whenever a
    ``log.csv`` is written (``output_dir`` set), so each logged
    ``elapsed_time`` is a completed step."""

    seed: int
    parallel: str
    batch: int
    steps: int
    log_every: int
    output_dir: str
    pp_microbatches: int = 1
    pp_schedule: str = "gpipe"
    pp_virtual_stages: int = 1
    collectives: str = "xla"
    mesh: MeshConfig = field(default_factory=MeshConfig)
    dataset: str = "fineweb"     # fineweb | synthetic
    warmup_steps: int = 5        # untimed warmup steps (real updates)
    prefetch: int = 2            # host->device prefetch depth; 0 = synchronous
    sync_every_step: bool | None = None
    checkpoint_every: int = 0
    checkpoint_dir: str = ""
    eval_every: int = 0
    eval_batches: int = 8
    eval_holdout_every: int = 10
    resume: bool = True
    # Refuse to truncate an existing <output_dir>/log.csv unless set.
    overwrite: bool = False
    profile_start: int = 0
    profile_stop: int = 0
    obs: ObsConfig = field(default_factory=ObsConfig)
    slo: SloConfig = field(default_factory=SloConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    multihost: bool = False
    coordinator_timeout_s: int = 0
    prng_impl: str = "threefry2x32"
    debug_nans: bool = False

    def __post_init__(self) -> None:
        if self.parallel not in VALID_PARALLEL:
            raise ValueError(
                f"unknown parallel strategy {self.parallel!r}; expected one of {VALID_PARALLEL}"
            )
        if self.dataset not in ("fineweb", "synthetic"):
            raise ValueError(f"unknown dataset {self.dataset!r}")
        if self.pp_microbatches < 1:
            raise ValueError("pp_microbatches must be >= 1")
        if self.pp_schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"unknown pp_schedule {self.pp_schedule!r}")
        if self.pp_virtual_stages < 1:
            raise ValueError("pp_virtual_stages must be >= 1")
        if self.pp_virtual_stages > 1 and self.pp_schedule != "1f1b":
            raise ValueError(
                "pp_virtual_stages > 1 (interleaved scheduling) requires "
                "pp_schedule: 1f1b"
            )
        if self.collectives not in ("xla", "overlapped"):
            raise ValueError(
                f"unknown collectives {self.collectives!r}; expected "
                "'xla' or 'overlapped'"
            )
        if self.eval_holdout_every < 1:
            raise ValueError("eval_holdout_every must be >= 1")
        if self.prng_impl not in ("threefry2x32", "rbg", "unsafe_rbg"):
            raise ValueError(f"unknown prng_impl {self.prng_impl!r}")
        if self.coordinator_timeout_s < 0:
            raise ValueError("coordinator_timeout_s must be >= 0 (0 = default)")
        if self.batch % self.pp_microbatches != 0:
            raise ValueError(
                f"batch={self.batch} not divisible by pp_microbatches={self.pp_microbatches}"
            )
