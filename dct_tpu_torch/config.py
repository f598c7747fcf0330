"""Configuration (copied from ``dct_tpu/config.py``).

``ModelConfig`` is the reference's model configuration field for field
(``dct_tpu/config.py:62-160``), so a package's ``model_meta.json`` builds
the same architecture here. The other sections keep the fields the port's
code reads, with the reference's defaults and ``DCT_*`` environment names
(and its unprefixed ``WORLD_SIZE``/``NODE_RANK``/``MASTER_ADDR``/
``MASTER_PORT``/``MLFLOW_TRACKING_URI``): ``DataConfig`` (``:34-60``),
``TrainConfig`` (``:164-282``), ``MeshConfig`` (``:286-308``),
``DistributedConfig`` (``:311-346``),
``TrackingConfig`` (``:348-369``), ``ObservabilityConfig`` (the event
log, spans, heartbeats and health policy of ``:413-470`` and the metrics
plane's ``metrics_dir`` and ``metrics_publish_s``, ``:468-471``),
``ResilienceConfig`` (the supervisor, preemption and fault-plan knobs of
``:606-660``), ``EvaluationConfig`` (``:672-766``), ``ServingConfig``
(``:768-915``, every field), ``LoopConfig`` (``:918-976``),
``StreamConfig`` (its ``mode``, ``:979``), ``SchedulerConfig`` (``:1040-1083``),
``MpmdConfig`` (``:1086-1130``) and the ``RunConfig`` bundle the trainer,
the loop and the scheduler take.
``EvaluationConfig`` stays out of the bundle: the gate reads it from
the environment where it is used, as the reference's does.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Callable


def _env(name: str, default: Any, cast: Callable = str) -> Any:
    raw = os.environ.get(name)
    if raw is None:
        return default
    if cast is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    return cast(raw)


@dataclass
class DataConfig:
    """Where the raw CSV is read, the processed parquet written and read
    and checkpoints written, the feature/label columns, and the validation
    fraction."""

    processed_dir: str = "data/processed"
    raw_csv: str = "data/raw/weather.csv"
    models_dir: str = "data/models"
    val_fraction: float = 0.2
    feature_suffix: str = "_norm"
    label_column: str = "label_encoded"

    @classmethod
    def from_env(cls) -> "DataConfig":
        c = cls()
        c.processed_dir = _env("DCT_PROCESSED_DIR", c.processed_dir, str)
        c.raw_csv = _env("DCT_RAW_CSV", c.raw_csv, str)
        c.models_dir = _env("DCT_MODELS_DIR", c.models_dir, str)
        c.val_fraction = _env("DCT_VAL_FRACTION", c.val_fraction, float)
        return c


@dataclass
class ModelConfig:
    """Model architecture; the fields and defaults of the reference's
    ``ModelConfig`` (the transformer families read ``seq_len`` through
    ``pos_embed``; the others are kept so a package's meta maps 1:1)."""

    name: str = "weather_mlp"
    input_dim: int | None = None
    hidden_dim: int = 64
    num_classes: int = 2
    dropout: float = 0.2
    seq_len: int = 32
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 256
    n_experts: int = 4
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_dispatch: str = "auto"
    moe_auto_threshold: int = 1 << 21
    router_top_k: int = 1
    n_stages: int = 2
    n_microbatches: int | None = None
    # Causal family: forecast horizon (H > 1 = direct multi-horizon head).
    horizon: int = 1
    remat: bool = False
    # Causal family: sliding-window attention (0 = full causal).
    attn_window: int = 0
    # Grouped-query attention: K/V heads (0 = n_heads).
    n_kv_heads: int = 0
    # "sincos" (additive table) or "rope" (rotary q/k).
    pos_embed: str = "sincos"

    @classmethod
    def from_env(cls) -> "ModelConfig":
        c = cls()
        c.name = _env("DCT_MODEL", c.name, str)
        c.hidden_dim = _env("DCT_HIDDEN_DIM", c.hidden_dim, int)
        c.num_classes = _env("DCT_NUM_CLASSES", c.num_classes, int)
        c.dropout = _env("DCT_DROPOUT", c.dropout, float)
        c.seq_len = _env("DCT_SEQ_LEN", c.seq_len, int)
        c.d_model = _env("DCT_D_MODEL", c.d_model, int)
        c.n_heads = _env("DCT_N_HEADS", c.n_heads, int)
        c.n_layers = _env("DCT_N_LAYERS", c.n_layers, int)
        c.d_ff = _env("DCT_D_FF", c.d_ff, int)
        c.n_experts = _env("DCT_N_EXPERTS", c.n_experts, int)
        c.capacity_factor = _env("DCT_CAPACITY_FACTOR", c.capacity_factor, float)
        c.router_aux_weight = _env(
            "DCT_ROUTER_AUX_WEIGHT", c.router_aux_weight, float
        )
        c.moe_dispatch = _env("DCT_MOE_DISPATCH", c.moe_dispatch, str)
        c.moe_auto_threshold = _env(
            "DCT_MOE_AUTO_THRESHOLD", c.moe_auto_threshold, int
        )
        c.router_top_k = _env("DCT_ROUTER_TOP_K", c.router_top_k, int)
        c.n_stages = _env("DCT_N_STAGES", c.n_stages, int)
        mb = os.environ.get("DCT_N_MICROBATCHES")
        c.n_microbatches = int(mb) if mb else c.n_microbatches
        c.horizon = _env("DCT_HORIZON", c.horizon, int)
        c.remat = _env("DCT_REMAT", c.remat, bool)
        c.attn_window = _env("DCT_ATTN_WINDOW", c.attn_window, int)
        c.n_kv_heads = _env("DCT_N_KV_HEADS", c.n_kv_heads, int)
        c.pos_embed = _env("DCT_POS_EMBED", c.pos_embed, str).strip().lower()
        return c


@dataclass
class ServingConfig:
    """The serving tier's knobs, with the reference's names, defaults and
    ``DCT_SERVE_*`` variables (``dct_tpu/config.py:768-915``): the
    micro-batcher (a flush takes up to ``max_batch`` rows, waiting at most
    ``batch_window_ms`` past the oldest queued request, 0 = opportunistic;
    ``workers`` scoring threads, 0 = inline), the pool's ``processes``,
    the engine, the envelope fast parse, the load generator, admission
    control, the autoscaler and the pool's restart budget.

    ``engine`` is the one stated divergence: the port's engines are
    ``torch`` (the default: the registry model on the card, the
    counterpart of the reference's opt-in ``jax``) and ``numpy`` (the
    reference's default, bit-identical to it). ``DCT_SERVE_ENGINE=jax``
    raises, naming ``torch``."""

    max_batch: int = 64
    batch_window_ms: float = 0.0
    workers: int = 2
    # Serving processes sharing one port through SO_REUSEPORT (ServerPool).
    processes: int = 1
    engine: str = "torch"
    fast_parse: bool = True
    # Load generator: open-loop qps (0 = closed loop), the per-level wall
    # budget, requests per level, the sweep's levels.
    loadgen_qps: float = 0.0
    loadgen_duration_s: float = 2.0
    loadgen_requests: int = 300
    loadgen_concurrency: str = "1,4,16"
    # Admission control (serving/admission.py): off by default.
    admit: bool = False
    priority_header: str = "x-dct-priority"
    admit_max_queue: int = 256
    admit_wait_ms: float = 500.0
    retry_after_s: float = 0.25
    # The autoscaler (serving/autoscale.py): pool processes, or batcher
    # worker threads in one process.
    autoscale: bool = False
    scale_min: int = 1
    scale_max: int = 4
    scale_up_queue: float = 32.0
    scale_down_queue: float = 2.0
    scale_poll_s: float = 1.0
    scale_hysteresis: int = 2
    scale_cooldown_s: float = 5.0
    # The pool's respawn budget before its circuit breaks.
    max_restarts: int = 3

    def __post_init__(self):
        self.engine = check_engine(self.engine)

    @classmethod
    def from_env(cls) -> "ServingConfig":
        c = cls()
        c.max_batch = _env("DCT_SERVE_MAX_BATCH", c.max_batch, int)
        c.batch_window_ms = _env(
            "DCT_SERVE_BATCH_WINDOW_MS", c.batch_window_ms, float
        )
        c.workers = _env("DCT_SERVE_WORKERS", c.workers, int)
        c.processes = _env("DCT_SERVE_PROCS", c.processes, int)
        c.engine = check_engine(_env("DCT_SERVE_ENGINE", c.engine, str))
        c.fast_parse = _env("DCT_SERVE_FAST_PARSE", c.fast_parse, bool)
        c.loadgen_qps = _env("DCT_SERVE_LOADGEN_QPS", c.loadgen_qps, float)
        c.loadgen_duration_s = _env(
            "DCT_SERVE_LOADGEN_DURATION_S", c.loadgen_duration_s, float
        )
        c.loadgen_requests = _env(
            "DCT_SERVE_LOADGEN_REQUESTS", c.loadgen_requests, int
        )
        c.loadgen_concurrency = _env(
            "DCT_SERVE_LOADGEN_CONCURRENCY", c.loadgen_concurrency, str
        )
        c.admit = _env("DCT_SERVE_ADMIT", c.admit, bool)
        c.priority_header = _env(
            "DCT_SERVE_PRIORITY_HEADER", c.priority_header, str
        ).strip().lower()
        c.admit_max_queue = _env(
            "DCT_SERVE_ADMIT_MAX_QUEUE", c.admit_max_queue, int
        )
        c.admit_wait_ms = _env(
            "DCT_SERVE_ADMIT_WAIT_MS", c.admit_wait_ms, float
        )
        c.retry_after_s = _env(
            "DCT_SERVE_RETRY_AFTER_S", c.retry_after_s, float
        )
        c.autoscale = _env("DCT_SERVE_AUTOSCALE", c.autoscale, bool)
        c.scale_min = _env("DCT_SERVE_SCALE_MIN", c.scale_min, int)
        c.scale_max = _env("DCT_SERVE_SCALE_MAX", c.scale_max, int)
        c.scale_up_queue = _env(
            "DCT_SERVE_SCALE_UP_Q", c.scale_up_queue, float
        )
        c.scale_down_queue = _env(
            "DCT_SERVE_SCALE_DOWN_Q", c.scale_down_queue, float
        )
        c.scale_poll_s = _env("DCT_SERVE_SCALE_POLL_S", c.scale_poll_s, float)
        c.scale_hysteresis = _env(
            "DCT_SERVE_SCALE_HYSTERESIS", c.scale_hysteresis, int
        )
        c.scale_cooldown_s = _env(
            "DCT_SERVE_SCALE_COOLDOWN_S", c.scale_cooldown_s, float
        )
        c.max_restarts = _env("DCT_SERVE_MAX_RESTARTS", c.max_restarts, int)
        return c

    def concurrency_levels(self) -> list[int]:
        """The loadgen sweep's concurrency levels, parsed and sanitized
        (bad tokens dropped; at least level 1)."""
        levels = []
        for tok in str(self.loadgen_concurrency).split(","):
            tok = tok.strip()
            if tok.isdigit() and int(tok) > 0:
                levels.append(int(tok))
        return sorted(set(levels)) or [1]


SERVE_ENGINES = ("torch", "numpy")


def check_engine(engine: str) -> str:
    """A serving engine name, normalized; ``jax`` and unknown names raise."""
    engine = str(engine or "torch").strip().lower()
    if engine == "jax":
        raise ValueError(
            "DCT_SERVE_ENGINE=jax is the reference's engine; the port's "
            "counterpart is 'torch' (the registry model on the card), "
            "beside 'numpy'"
        )
    if engine not in SERVE_ENGINES:
        raise ValueError(
            f"DCT_SERVE_ENGINE={engine!r} must be one of {SERVE_ENGINES}"
        )
    return engine


@dataclass
class TrainConfig:
    """The optimization loop: Adam at lr 0.01, batch 4 per process, 10
    epochs, seed 42 (the reference's parity defaults). ``batch_size`` is
    per process: the global batch is ``batch_size`` x the number of
    processes. ``epoch_chunk`` fuses that many epochs per span of the scan
    path; ``use_scan=False`` runs the per-batch loop."""

    epochs: int = 10
    batch_size: int = 4
    lr: float = 0.01
    optimizer: str = "adam"
    momentum: float = 0.0
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    decay_steps: int = 0
    end_lr_fraction: float = 0.0
    weight_decay: float = 0.0
    grad_clip_norm: float = 0.0
    seed: int = 42
    log_every_n_steps: int = 5
    resume: bool = False
    bf16_compute: bool = True
    use_scan: bool = True
    grad_accum_steps: int = 1
    early_stop_patience: int = 0
    early_stop_min_delta: float = 0.0
    epoch_chunk: int = 1
    # ZeRO-1 (the optimizer state) and FSDP (the parameters and their
    # moments) over the data axis (parallel/sharding_rules.py).
    shard_opt_state: bool = False
    shard_params: bool = False

    @classmethod
    def from_env(cls) -> "TrainConfig":
        c = cls()
        c.epochs = _env("DCT_EPOCHS", c.epochs, int)
        c.batch_size = _env("DCT_BATCH_SIZE", c.batch_size, int)
        c.lr = _env("DCT_LR", c.lr, float)
        c.optimizer = _env("DCT_OPTIMIZER", c.optimizer, str)
        c.momentum = _env("DCT_MOMENTUM", c.momentum, float)
        c.lr_schedule = _env("DCT_LR_SCHEDULE", c.lr_schedule, str)
        c.warmup_steps = _env("DCT_WARMUP_STEPS", c.warmup_steps, int)
        c.decay_steps = _env("DCT_DECAY_STEPS", c.decay_steps, int)
        c.end_lr_fraction = _env("DCT_END_LR_FRACTION", c.end_lr_fraction,
                                 float)
        c.weight_decay = _env("DCT_WEIGHT_DECAY", c.weight_decay, float)
        c.grad_clip_norm = _env("DCT_GRAD_CLIP_NORM", c.grad_clip_norm, float)
        c.seed = _env("DCT_SEED", c.seed, int)
        c.log_every_n_steps = _env("DCT_LOG_EVERY_N_STEPS",
                                   c.log_every_n_steps, int)
        c.resume = _env("DCT_RESUME", c.resume, bool)
        c.bf16_compute = _env("DCT_BF16_COMPUTE", c.bf16_compute, bool)
        c.use_scan = _env("DCT_USE_SCAN", c.use_scan, bool)
        c.grad_accum_steps = _env("DCT_GRAD_ACCUM_STEPS", c.grad_accum_steps,
                                  int)
        c.early_stop_patience = _env("DCT_EARLY_STOP_PATIENCE",
                                     c.early_stop_patience, int)
        c.early_stop_min_delta = _env("DCT_EARLY_STOP_MIN_DELTA",
                                      c.early_stop_min_delta, float)
        c.epoch_chunk = _env("DCT_EPOCH_CHUNK", c.epoch_chunk, int)
        c.shard_opt_state = _env("DCT_SHARD_OPT_STATE", c.shard_opt_state,
                                 bool)
        c.shard_params = _env("DCT_SHARD_PARAMS", c.shard_params, bool)
        return c


@dataclass
class MeshConfig:
    """The process grid: ``data`` (the batch axis), ``model`` (tensor and
    expert parallelism), ``seq`` and ``pipe``; one process per card. A size
    of -1 absorbs every remaining process."""

    data: int = -1
    model: int = 1
    seq: int = 1
    pipe: int = 1

    @classmethod
    def from_env(cls) -> "MeshConfig":
        c = cls()
        c.data = _env("DCT_MESH_DATA", c.data, int)
        c.model = _env("DCT_MESH_MODEL", c.model, int)
        c.seq = _env("DCT_MESH_SEQ", c.seq, int)
        c.pipe = _env("DCT_MESH_PIPE", c.pipe, int)
        return c


@dataclass
class SeqParallelConfig:
    """The sequence-parallel engines' knobs, the reference's
    (``dct_tpu/config.py:1258-1259``), read where the engines are picked
    (:mod:`dct_tpu_torch.ops.attention`): ``DCT_SP_ENGINE`` ``ring``
    (default: the KV shards rotate round the seq ranks) or ``a2a`` (two
    all-to-all exchanges around a full-length call), and
    ``DCT_RING_STRIPED`` ``auto`` (default: the causal ring stripes where
    its flash path takes the half shard), ``on`` or ``off`` (also ``1``,
    ``true``, ``yes`` / ``0``, ``false``, ``no``)."""

    engine: str = "ring"
    ring_striped: str = "auto"

    @classmethod
    def from_env(cls) -> "SeqParallelConfig":
        c = cls()
        c.engine = _env("DCT_SP_ENGINE", c.engine).strip().lower()
        if c.engine not in ("ring", "a2a"):
            raise ValueError(
                f"DCT_SP_ENGINE={c.engine!r} must be 'ring' or 'a2a'")
        mode = _env("DCT_RING_STRIPED", c.ring_striped).strip().lower()
        c.ring_striped = ("off" if mode in ("0", "off", "false", "no")
                          else "on" if mode in ("1", "on", "true", "yes")
                          else "auto")
        return c


@dataclass
class DistributedConfig:
    """The rendezvous: ``DCT_NUM_PROCESSES``/``WORLD_SIZE``,
    ``DCT_PROCESS_ID``/``NODE_RANK`` and ``DCT_COORDINATOR_ADDRESS`` or
    ``MASTER_ADDR`` + ``MASTER_PORT`` (default 29500); the native names
    win and an empty value counts as unset."""

    coordinator_address: str | None = None
    num_processes: int = 1
    process_id: int = 0

    @classmethod
    def from_env(cls) -> "DistributedConfig":
        c = cls()
        world = os.environ.get("DCT_NUM_PROCESSES") or os.environ.get(
            "WORLD_SIZE")
        rank = os.environ.get("DCT_PROCESS_ID") or os.environ.get("NODE_RANK")
        coord = os.environ.get("DCT_COORDINATOR_ADDRESS") or None
        if coord is None:
            master_addr = os.environ.get("MASTER_ADDR")
            master_port = os.environ.get("MASTER_PORT", "29500")
            if master_addr:
                coord = f"{master_addr}:{master_port}"
        c.coordinator_address = coord
        c.num_processes = int(world) if world else 1
        c.process_id = int(rank) if rank else 0
        return c


@dataclass
class TrackingConfig:
    """Experiment ``weather_forecasting``; an MLflow server when
    ``MLFLOW_TRACKING_URI`` is set and mlflow importable, else the local
    file store; the best checkpoint goes under ``best_checkpoints``."""

    experiment: str = "weather_forecasting"
    tracking_uri: str | None = None
    artifact_path: str = "best_checkpoints"

    @classmethod
    def from_env(cls) -> "TrackingConfig":
        c = cls()
        c.experiment = _env("DCT_EXPERIMENT", c.experiment, str)
        c.tracking_uri = os.environ.get("MLFLOW_TRACKING_URI", c.tracking_uri)
        return c


@dataclass
class ObservabilityConfig:
    """The operator plane of a training world
    (:mod:`dct_tpu_torch.observability`): the structured event log, spans,
    rank heartbeats and the training-health policy, on by default; every
    writer degrades to a no-op on OS errors. ``run_id`` is the
    run-correlation ID stamped on every record, normally minted by the
    launcher and delivered through ``DCT_RUN_ID``. ``metrics_dir`` arms
    the cross-process metrics plane
    (:mod:`dct_tpu_torch.observability.aggregate`). The reference's
    Prometheus dump, telemetry batching, SLO, time-series, anomaly and
    incident planes are ROADMAP Queue A item 27."""

    enabled: bool = True
    events_dir: str = "logs/events"
    run_id: str | None = None
    heartbeat_dir: str = "logs/heartbeats"
    # Same-phase heartbeats inside this window are throttled.
    heartbeat_interval: float = 5.0
    # A heartbeat older than this marks its rank stalled to the monitor.
    heartbeat_stall_seconds: float = 120.0
    # Span files; "" = <events_dir>/spans.
    spans_dir: str = ""
    # Training-health policy (observability/health.py): halt on a
    # non-finite loss / on a loss-or-grad-norm spike, or (default) warn
    # through health.* events and keep training.
    halt_on_nan: bool = False
    halt_on_spike: bool = False
    spike_zscore: float = 8.0
    spike_window: int = 16
    # Cross-process metrics plane: processes publish atomic registry
    # snapshots under this dir and a scrape merges the live siblings into
    # fleet totals. "" = plane off.
    metrics_dir: str = ""
    # Min seconds between snapshot publishes per process (the hot-path
    # throttle; an idle process's timer republishes on the same cadence).
    metrics_publish_s: float = 2.0
    # A sibling snapshot older than this drops out of a fleet scrape.
    metrics_stale_s: float = 30.0

    @classmethod
    def from_env(cls) -> "ObservabilityConfig":
        c = cls()
        c.enabled = _env("DCT_OBSERVABILITY", c.enabled, bool)
        c.events_dir = _env("DCT_EVENTS_DIR", c.events_dir, str)
        c.run_id = os.environ.get("DCT_RUN_ID") or c.run_id
        c.heartbeat_dir = _env("DCT_HEARTBEAT_DIR", c.heartbeat_dir, str)
        c.heartbeat_interval = _env(
            "DCT_HEARTBEAT_INTERVAL", c.heartbeat_interval, float)
        c.heartbeat_stall_seconds = _env(
            "DCT_HEARTBEAT_STALL_SECONDS", c.heartbeat_stall_seconds, float)
        c.spans_dir = _env("DCT_SPANS_DIR", c.spans_dir, str)
        c.halt_on_nan = _env("DCT_HALT_ON_NAN", c.halt_on_nan, bool)
        c.halt_on_spike = _env("DCT_HALT_ON_SPIKE", c.halt_on_spike, bool)
        c.spike_zscore = _env("DCT_SPIKE_ZSCORE", c.spike_zscore, float)
        c.spike_window = _env("DCT_SPIKE_WINDOW", c.spike_window, int)
        c.metrics_dir = _env("DCT_METRICS_DIR", c.metrics_dir, str)
        c.metrics_publish_s = _env(
            "DCT_METRICS_PUBLISH_S", c.metrics_publish_s, float)
        c.metrics_stale_s = _env(
            "DCT_METRICS_STALE_S", c.metrics_stale_s, float)
        return c


@dataclass
class ResilienceConfig:
    """Self-healing knobs (:mod:`dct_tpu_torch.resilience`). The
    supervisor-side ones (``max_restarts``, the backoff, the grace window)
    govern whoever watches the world: the loop's supervised rounds or the
    ``python -m dct_tpu_torch.resilience.supervise`` CLI; the rank-side
    ones (``graceful_preemption``, the fault plan) govern the trainer."""

    max_restarts: int = 2
    restart_backoff_s: float = 5.0
    restart_backoff_factor: float = 2.0
    restart_jitter: float = 0.1
    preempt_grace_s: float = 30.0
    # Honor SIGTERM cooperatively: finish the span in flight, make the
    # resume checkpoint durable, exit EXIT_PREEMPTED (75).
    graceful_preemption: bool = True
    # Deterministic fault plan (resilience/faults.py grammar), e.g.
    # "crash@rank1:epoch2,slow_save". Empty = no faults.
    fault_spec: str = ""
    fault_sleep_s: float = 3.0

    @classmethod
    def from_env(cls) -> "ResilienceConfig":
        c = cls()
        c.max_restarts = _env("DCT_MAX_RESTARTS", c.max_restarts, int)
        c.restart_backoff_s = _env(
            "DCT_RESTART_BACKOFF_S", c.restart_backoff_s, float)
        c.restart_backoff_factor = _env(
            "DCT_RESTART_BACKOFF_FACTOR", c.restart_backoff_factor, float)
        c.restart_jitter = _env("DCT_RESTART_JITTER", c.restart_jitter,
                                float)
        c.preempt_grace_s = _env("DCT_PREEMPT_GRACE_S", c.preempt_grace_s,
                                 float)
        c.graceful_preemption = _env(
            "DCT_GRACEFUL_PREEMPTION", c.graceful_preemption, bool)
        c.fault_spec = _env("DCT_FAULT_SPEC", c.fault_spec, str)
        c.fault_sleep_s = _env("DCT_FAULT_SLEEP_S", c.fault_sleep_s, float)
        return c


@dataclass
class EvaluationConfig:
    """Continuous-evaluation knobs (dct_tpu_torch.evaluation):
    the champion/challenger offline eval harness, the statistical
    promotion gates between rollout stages, and the drift detectors.

    The gate's null hypothesis is "the challenger is NOT worse": by
    default a cycle promotes unless the evidence says it regressed
    (``require_improvement`` flips that to "promote only on proven
    improvement"). All stochastic machinery (the paired bootstrap) is
    seeded from ``seed`` so a gate decision is reproducible from its
    evidence. ``DCT_DRIFT_THRESHOLD`` (the ETL-side stats gate in
    etl/preprocess.py) is a different, older knob; the deploy-side
    detectors here use PSI/KS against the snapshot stamped into the
    deploy package.
    """

    # Consult a PromotionGate between rollout stages (shadow -> canary
    # -> full). Off = the reference's timer-only walk.
    gate_enabled: bool = True
    # Mean per-example loss delta (champion - challenger) the challenger
    # must exceed to count as an improvement.
    min_improvement: float = 0.0
    # Mean regression tolerated before the gate blocks (challenger mean
    # loss may exceed champion's by at most this).
    max_regression: float = 0.0
    # One-sided confidence required of the paired bootstrap before a
    # delta counts as evidence (0.95 = the regression must be outside
    # the bootstrap's 95% band).
    confidence: float = 0.95
    bootstrap_samples: int = 1000
    # Bootstrap RNG seed: gate decisions must be deterministic.
    seed: int = 42
    # Worst tolerated per-slice loss regression (e.g. the rain slice may
    # not get this much worse even if the aggregate improved).
    max_slice_regression: float = 0.25
    # Promote only on statistically-significant improvement (default:
    # promote unless significantly worse — continuous-training default).
    require_improvement: bool = False
    # Examples per forward pass in the offline harness.
    eval_batch: int = 1024
    # 'numpy' = the serving twin (identical math to the deployed
    # score.py); 'torch' = the registry model on the device, f32, chunked
    # (the reference's 'jax' engine, which names this engine here too).
    engine: str = "numpy"
    # Missing prerequisites (no champion, no eval data, unreadable
    # package): promote with a warning (True) or hold (False). A real
    # failing evaluation always blocks regardless.
    fail_open: bool = True
    # Gate-decision ledger; "" = <events_dir>/gate_ledger.json.
    ledger_path: str = ""
    # Drift detectors: PSI above this flags a feature (industry rule of
    # thumb: 0.1 moderate, 0.2 major); KS D-statistic threshold; bins
    # for the stamped quantile snapshot; shadow-stage prediction
    # disagreement rate above which the shadow->canary gate holds.
    psi_threshold: float = 0.2
    ks_threshold: float = 0.15
    drift_bins: int = 10
    max_disagreement: float = 0.25

    @classmethod
    def from_env(cls) -> "EvaluationConfig":
        c = cls()
        c.gate_enabled = _env("DCT_GATE", c.gate_enabled, bool)
        c.min_improvement = _env(
            "DCT_GATE_MIN_IMPROVEMENT", c.min_improvement, float
        )
        c.max_regression = _env(
            "DCT_GATE_MAX_REGRESSION", c.max_regression, float
        )
        c.confidence = _env("DCT_GATE_CONFIDENCE", c.confidence, float)
        c.bootstrap_samples = _env(
            "DCT_GATE_BOOTSTRAP", c.bootstrap_samples, int
        )
        c.seed = _env("DCT_GATE_SEED", c.seed, int)
        c.max_slice_regression = _env(
            "DCT_GATE_MAX_SLICE_REGRESSION", c.max_slice_regression, float
        )
        c.require_improvement = _env(
            "DCT_GATE_REQUIRE_IMPROVEMENT", c.require_improvement, bool
        )
        c.eval_batch = _env("DCT_GATE_EVAL_BATCH", c.eval_batch, int)
        c.engine = _env("DCT_GATE_ENGINE", c.engine, str).strip().lower()
        c.fail_open = _env("DCT_GATE_FAIL_OPEN", c.fail_open, bool)
        c.ledger_path = _env("DCT_GATE_LEDGER", c.ledger_path, str)
        c.psi_threshold = _env("DCT_DRIFT_PSI", c.psi_threshold, float)
        c.ks_threshold = _env("DCT_DRIFT_KS", c.ks_threshold, float)
        c.drift_bins = _env("DCT_DRIFT_BINS", c.drift_bins, int)
        c.max_disagreement = _env(
            "DCT_DRIFT_MAX_DISAGREEMENT", c.max_disagreement, float
        )
        return c


@dataclass
class LoopConfig:
    """Always-on overlapped cycles (dct_tpu_torch.continuous): ingest
    watcher, continuous training rounds, and the concurrent evaluator
    that promotes mid-run.

    The loop replaces the episodic DAG clock (ROADMAP item 3): ETL,
    training, gating and deploy overlap instead of serializing, so
    data-arrival -> deployed-model freshness is bounded by stage
    latency, not cycle latency. Budgets (``max_*``) exist for smokes
    and benches; production leaves them 0 (run until SIGTERM).
    """

    # Ingest watcher poll cadence over the raw staging CSV (stat-based
    # pre-check; content digest decides no-op vs delta vs rebuild).
    poll_s: float = 2.0
    # Evaluator poll cadence over the deploy-tier best checkpoint.
    eval_poll_s: float = 2.0
    # Epochs per training round — the loop's train quantum. Small keeps
    # fresh data's wait-for-round short; each round EXTENDS the same
    # optimizer trajectory (DCT_RESUME semantics).
    epochs_per_round: int = 2
    # 'supervised' = each round is a training world under the supervisor
    # (launch/launcher.py); 'inline' = Trainer.fit in-process.
    train_mode: str = "supervised"
    # Rollout soak per stage (shadow/canary dwell) for mid-run
    # promotions — the loop's evaluator overlaps these with training.
    soak_s: float = 5.0
    # Local endpoint name the loop promotes into.
    endpoint: str = "weather-loop"
    # Challenger package root (one package dir per promotion attempt;
    # slot-referenced packages are retained, stale ones pruned).
    packages_dir: str = "data/loop_packages"
    # Stop budgets: 0 = unbounded (production always-on).
    max_rounds: int = 0
    max_wall_s: float = 0.0
    max_promotions: int = 0

    @classmethod
    def from_env(cls) -> "LoopConfig":
        c = cls()
        c.poll_s = _env("DCT_LOOP_POLL_S", c.poll_s, float)
        c.eval_poll_s = _env("DCT_LOOP_EVAL_POLL_S", c.eval_poll_s, float)
        c.epochs_per_round = _env(
            "DCT_LOOP_EPOCHS_PER_ROUND", c.epochs_per_round, int
        )
        c.train_mode = _env(
            "DCT_LOOP_TRAIN_MODE", c.train_mode, str
        ).strip().lower()
        c.soak_s = _env("DCT_LOOP_SOAK_S", c.soak_s, float)
        c.endpoint = _env("DCT_LOOP_ENDPOINT", c.endpoint, str)
        c.packages_dir = _env("DCT_LOOP_PACKAGES_DIR", c.packages_dir, str)
        c.max_rounds = _env("DCT_LOOP_MAX_ROUNDS", c.max_rounds, int)
        c.max_wall_s = _env("DCT_LOOP_MAX_WALL_S", c.max_wall_s, float)
        c.max_promotions = _env(
            "DCT_LOOP_MAX_PROMOTIONS", c.max_promotions, int
        )
        return c


@dataclass
class StreamConfig:
    """The loop's ingest source, ``DCT_INGEST_MODE``: ``poll`` (the CSV
    digest-polling watcher) or ``stream`` (the partitioned event log,
    ROADMAP Queue A item 24, which raises until ported)."""

    mode: str = "poll"

    @classmethod
    def from_env(cls) -> "StreamConfig":
        c = cls()
        c.mode = _env("DCT_INGEST_MODE", c.mode, str).strip().lower()
        return c


@dataclass
class SchedulerConfig:
    """The multi-tenant scheduler (:mod:`dct_tpu_torch.scheduler`): N
    always-on tenants sharing one card with chip-time quota, priority
    classes and fault isolation.

    ``spec`` is the tenant roster, inline JSON or a ``tenants.json`` path
    (grammar in ``scheduler/spec.py``). Training rounds time-share the
    card through round leases granted by strict priority class, then
    weighted deficit; ``concurrent`` leases may run at once. A starved
    higher-class waiter preempts a running lower-class round gracefully
    after ``preempt_wait_s`` (0 = never preempt). ``shared_cache``: every
    tenant loads the one kernel build under ``build/dct_tpu_torch/`` (the
    reference pins one compile/AOT store here; the port has none, ROADMAP
    Queue A item 18). Budgets (``max_*``) exist for smokes and benches;
    production leaves them 0.
    """

    spec: str = ""
    root: str = "data/tenants"
    concurrent: int = 1
    poll_s: float = 0.5
    preempt_wait_s: float = 0.0
    shared_cache: bool = True
    max_wall_s: float = 0.0
    max_rounds: int = 0

    @classmethod
    def from_env(cls) -> "SchedulerConfig":
        c = cls()
        c.spec = _env("DCT_TENANTS", c.spec, str)
        c.root = _env("DCT_SCHED_ROOT", c.root, str)
        c.concurrent = max(1, _env("DCT_SCHED_CONCURRENT", c.concurrent, int))
        c.poll_s = _env("DCT_SCHED_POLL_S", c.poll_s, float)
        c.preempt_wait_s = _env(
            "DCT_SCHED_PREEMPT_WAIT_S", c.preempt_wait_s, float)
        c.shared_cache = _env("DCT_SCHED_SHARED_CACHE", c.shared_cache, bool)
        c.max_wall_s = _env("DCT_SCHED_MAX_WALL_S", c.max_wall_s, float)
        c.max_rounds = _env("DCT_SCHED_MAX_ROUNDS", c.max_rounds, int)
        return c


@dataclass
class MpmdConfig:
    """The MPMD pipeline trainer's knobs (``dct_tpu/config.py:1086-1130``;
    :mod:`dct_tpu_torch.parallel.mpmd`): ``DCT_MPMD_STAGES`` (the stage
    map: a stage count, or per-stage device counts such as ``"1,1"``),
    ``DCT_MPMD_MICROBATCHES`` (0 = 2x the stage count),
    ``DCT_MPMD_SCHEDULE`` (``1f1b`` | ``gpipe``),
    ``DCT_MPMD_TRANSFER_TIMEOUT_S`` (the inter-stage wait before a loud
    failure) and ``DCT_MPMD_PORT_BASE`` (the multi-process transfer
    plane: stage k listens on base + k). ``DCT_MPMD_STAGE_ID`` (a
    worker's stage, else ``NODE_RANK``) is read by the worker."""

    stages: str = "2"
    microbatches: int = 0
    schedule: str = "1f1b"
    transfer_timeout_s: float = 120.0
    port_base: int = 29600

    @classmethod
    def from_env(cls) -> "MpmdConfig":
        c = cls()
        c.stages = _env("DCT_MPMD_STAGES", c.stages, str)
        c.microbatches = _env("DCT_MPMD_MICROBATCHES", c.microbatches, int)
        c.schedule = _env(
            "DCT_MPMD_SCHEDULE", c.schedule, str
        ).strip().lower()
        c.transfer_timeout_s = _env(
            "DCT_MPMD_TRANSFER_TIMEOUT_S", c.transfer_timeout_s, float
        )
        c.port_base = _env("DCT_MPMD_PORT_BASE", c.port_base, int)
        return c

    def to_spec(self, *, n_devices: int | None = None):
        """Parse and validate into an :class:`dct_tpu_torch.parallel.mpmd.
        MpmdSpec`; every malformed clause raises ``MpmdSpecError`` naming
        the knob."""
        from dct_tpu_torch.parallel.mpmd import spec_from_env_values

        return spec_from_env_values(
            self.stages, self.microbatches, self.schedule,
            self.transfer_timeout_s, self.port_base, n_devices=n_devices,
        )


@dataclass
class RunConfig:
    """The bundle passed to the trainer, the loop and the scheduler."""

    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    dist: DistributedConfig = field(default_factory=DistributedConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    obs: ObservabilityConfig = field(default_factory=ObservabilityConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    stream: StreamConfig = field(default_factory=StreamConfig)
    sched: SchedulerConfig = field(default_factory=SchedulerConfig)
    mpmd: MpmdConfig = field(default_factory=MpmdConfig)

    @classmethod
    def from_env(cls) -> "RunConfig":
        return cls(data=DataConfig.from_env(), model=ModelConfig.from_env(),
                   train=TrainConfig.from_env(),
                   mesh=MeshConfig.from_env(),
                   dist=DistributedConfig.from_env(),
                   tracking=TrackingConfig.from_env(),
                   obs=ObservabilityConfig.from_env(),
                   resilience=ResilienceConfig.from_env(),
                   loop=LoopConfig.from_env(),
                   stream=StreamConfig.from_env(),
                   sched=SchedulerConfig.from_env(),
                   mpmd=MpmdConfig.from_env())

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
