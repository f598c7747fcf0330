"""The training engine: the epoch loop with tracking and checkpoints
(counterpart of ``dct_tpu/train/trainer.py``).

``Trainer(cfg, device=...).fit(data=None)`` loads the processed parquet
(or takes ``data``), splits it (the seeded 80/20 row split for
``weather_mlp``; sliding windows and a gapped contiguous split for the
sequence families), gives this process its block of every global batch,
builds the model and the train state on the trainer's device, resumes
from the per-process resume tier when ``DCT_RESUME`` asks for it, and
trains ``cfg.train.epochs`` epochs:

- the scan path (``use_scan``, the default): an epoch's batches are staged
  as ``[S, B, ...]`` stacks and trained and evaluated in one call of the
  fused epoch step, ``epoch_chunk`` epochs per span;
- the per-batch path (``use_scan=False``): the batch iterator and the
  per-batch train and eval steps.

After each span: per-epoch history and tracker metrics, early stopping on
val_loss, the deploy checkpoints (``BestLastCheckpointer``, on the
coordinator only) and the resume snapshot (every process, written on a
worker thread). The device is resolved once (``cuda:0`` unless the caller
passes ``device="cpu"``); every tensor, generator and restored leaf lives
there.

The rank-side resilience contract rides on the span boundaries, from the
values each span already brings to the host (its stacked losses and grad
norms), so no step gains a host sync:

- events (``trainer.*``, ``fault.injected``, ``health.*``) and spans
  (``trainer.fit`` parented by the launcher's ``DCT_SPAN_ID``, then
  ``trainer.startup``, ``trainer.epoch``, ``trainer.checkpoint``);
- this rank's heartbeat at startup, before and after each span, and at
  the end (``done``, ``preempted`` or ``failed``);
- the health monitor over each span's per-step losses and grad norms,
  raising :class:`~dct_tpu_torch.observability.health.TrainingHealthError`
  under a halting policy before the span is checkpointed;
- the fault plan (the process default, so the checkpoint tiers share its
  save ordinals) at each epoch start, span end and staged epoch;
- the :class:`~dct_tpu_torch.resilience.preempt.PreemptionGuard`: after a
  SIGTERM the span in flight finishes and is checkpointed, the resume
  write is joined, ``preempt.signal_received`` and
  ``preempt.checkpoint_saved`` go on the record, and
  :class:`~dct_tpu_torch.resilience.preempt.PreemptedError` is raised
  (``train_job`` exits 75 on it). A caller may pass its own guard
  (``Trainer(cfg, preempt_guard=...)``): another thread's
  :meth:`~dct_tpu_torch.resilience.preempt.PreemptionGuard.request` then
  stops a fit running off the main thread, where no SIGTERM arrives (the
  multi-tenant scheduler's lease revocation);
- with ``DCT_METRICS_DIR`` set, the coordinator publishes per-epoch
  gauges (:class:`~dct_tpu_torch.observability.dump.LiveTrainMetrics`) on
  the metrics plane.

The per-batch path (``use_scan=False``) reads each step's loss anyway, so
there the hooks run per step, as the reference's eager path does.

The process grid comes from ``cfg.mesh`` (:func:`dct_tpu_torch.parallel.
mesh.make_mesh`; ``data=-1`` absorbs every process, the reference's
default): the model and seq ranks of a data row load the same block of
every batch (the seq ranks of a transformer or the MoE then keep their
positions of it; the MLP and the GRU are replicated over ``seq``), the
state is placed by the family's partition rules with
``shard_opt_state`` (ZeRO-1) and ``shard_params`` (FSDP; both split over
``data`` and replicated over ``seq``)
(:func:`dct_tpu_torch.parallel.sharding_rules.shard_state_with_rules`),
checked against the declared layout, and the deploy checkpoints are
gathered dense on every process before the coordinator writes them. The
``trainer.layout`` event gives each process's parameter and optimizer
bytes. A resume reads this process's ``p<rank>`` directory, re-mapping a
shard-saved state from another grid or process count through its sibling
ranks' directories (:class:`~dct_tpu_torch.checkpoint.manager.
TrainStateCheckpointer`), so a grown world's new ranks resume with the
others.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from dct_tpu_torch.checkpoint.manager import (
    BestLastCheckpointer,
    TrainStateCheckpointer,
)
from dct_tpu_torch.config import RunConfig
from dct_tpu_torch.data.dataset import WeatherArrays, load_processed_dataset
from dct_tpu_torch.data.pipeline import (
    BatchLoader,
    contiguous_split,
    train_val_split,
)
from dct_tpu_torch.device import resolve_device
from dct_tpu_torch.models.mlp import set_data_block
from dct_tpu_torch.models.registry import (
    get_model,
    is_causal_model,
    is_sequence_model,
)
from dct_tpu_torch.observability.dump import (
    LiveTrainMetrics,
    live_train_metrics,
)
from dct_tpu_torch.observability.events import EventLog, event_log_from_config
from dct_tpu_torch.observability.health import (
    HealthMonitor,
    TrainingHealthError,
)
from dct_tpu_torch.observability.heartbeat import HeartbeatWriter
from dct_tpu_torch.observability.spans import (
    Span,
    SpanRecorder,
    recorder_from_config,
)
from dct_tpu_torch.ops.losses import precision_recall_f1
from dct_tpu_torch.parallel.distributed import (
    is_coordinator,
    process_count,
    process_index,
)
from dct_tpu_torch.resilience import faults
from dct_tpu_torch.resilience.preempt import PreemptedError, PreemptionGuard
from dct_tpu_torch.parallel.mesh import (
    all_gather_ints,
    all_reduce_sum,
    make_mesh,
    process_data_block,
    set_mesh,
)
from dct_tpu_torch.parallel.sharding_rules import (
    gather_tree,
    layout_mismatches,
    state_shardings,
)
from dct_tpu_torch.tracking.client import get_tracker
from dct_tpu_torch.train import steps
from dct_tpu_torch.train.state import create_train_state, make_lr_schedule


def early_stop_update(val_loss: float, best: float | None, stale: int, *,
                      patience: int,
                      min_delta: float) -> tuple[float | None, int, bool]:
    """One early-stopping step (monitor val_loss, min mode): the updated
    ``(best, stale, stop)``. A NaN val_loss never counts as an
    improvement, not even as the first ``best``."""
    improved = not math.isnan(val_loss) and (
        best is None or val_loss < best - min_delta
    )
    if improved:
        return val_loss, 0, False
    return best, stale + 1, stale + 1 >= patience


def optimizer_identity(train_cfg) -> dict:
    """The knobs that select the optimizer chain, and so the shape of its
    state: the name (adam with a positive weight decay is adamw, adamw at
    0 is adam), the momentum and the weight decay. Saved in the resume
    tier's meta and compared exactly on resume, because two chains can
    have states of the same leaf count and shapes (adam and adamw)."""
    name = str(train_cfg.optimizer).strip().lower()
    wd = float(train_cfg.weight_decay)
    if name == "adam" and wd > 0:
        name = "adamw"
    elif name == "adamw" and wd == 0:
        name = "adam"
    return {"name": name, "momentum": float(train_cfg.momentum),
            "weight_decay": wd}


@dataclass
class TrainResult:
    val_loss: float
    val_acc: float
    best_model_path: str
    last_model_path: str
    history: list = field(default_factory=list)
    samples_per_sec: float = 0.0
    # Mean rate over the epochs after the first (which pays the kernels'
    # first load and the allocator's warm-up).
    steady_samples_per_sec: float = 0.0
    epoch_seconds: list = field(default_factory=list)
    run_id: str | None = None
    state: object | None = None
    # This process's parameter and optimizer-state bytes, and the mesh.
    layout: dict = field(default_factory=dict)


def _gathered_bytes(state) -> dict:
    """The most gathered parameter bytes this process held at once (its
    resharded units', :mod:`dct_tpu_torch.parallel.reshard`), the largest
    per-unit gather's, all of them together, and the small units' held
    for the step (with the per-unit ones, what one gather of the whole
    model would hold)."""
    from dct_tpu_torch.parallel import reshard

    units = reshard.unit_bytes(state)
    return {"gathered_peak_bytes": reshard.gathered_bytes()["peak"],
            "unit_bytes_max": max(units, default=0),
            "unit_bytes_sum": sum(units),
            "step_unit_bytes": reshard.step_bytes(state)}


def _state_bytes(state) -> dict:
    """The bytes this process stores of the parameters and of the
    optimizer state."""

    def nbytes(t):
        return t.numel() * t.element_size()

    param = sum(nbytes(state.stored_param(i))
                for i in range(len(state.params)))
    opt = 0
    stack = [state.opt_state]
    while stack:
        node = stack.pop()
        if isinstance(node, torch.Tensor):
            opt += nbytes(node)
        elif isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
    return {"param_bytes": int(param), "opt_bytes": int(opt)}


def _local_heads(model) -> list | None:
    """(q heads, KV heads) of this process's attention (``H/M``,
    ``G/M`` under tensor parallelism); None for a family without one."""
    blocks = model.blocks() if hasattr(model, "blocks") else []
    attn = getattr(blocks[0], "attn", None) if blocks else None
    return list(attn.local[:2]) if attn is not None else None


def _epoch_metrics(sums) -> tuple[float, float, tuple]:
    """(val_loss, val_acc, (tp, fp, fn)) from the six global sums."""
    ls, accs, c, tp, fp, fn = (float(v) for v in sums)
    if c == 0:
        return float("nan"), float("nan"), (0.0, 0.0, 0.0)
    return ls / c, accs / c, (tp, fp, fn)


@dataclass
class _Planes:
    """One fit's observability and resilience planes, and the spans in
    flight (closed by the failure path)."""

    events: EventLog
    tracer: SpanRecorder
    fit_span: Span
    health: HealthMonitor
    plan: faults.FaultPlan
    guard: PreemptionGuard
    heartbeat: HeartbeatWriter | None
    live_metrics: LiveTrainMetrics | None = None
    epoch_span: Span | None = None
    ckpt_span: Span | None = None
    epochs_run: int = 0
    # Seconds of the epochs this fit completed (a preempted fit's
    # PreemptedError carries them as ``epoch_seconds``).
    epoch_seconds: float = 0.0

    def beat(self, **kw) -> None:
        if self.heartbeat is not None:
            self.heartbeat.beat(**kw)


class Trainer:
    def __init__(self, cfg: RunConfig, *, device=None, tracker=None,
                 preempt_guard: PreemptionGuard | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # A caller-owned guard (the scheduler's revocation channel): fit()
        # consults it instead of building its own.
        self._preempt_guard = preempt_guard
        self.coordinator = is_coordinator()
        self.tracker = tracker if tracker is not None else get_tracker(
            tracking_uri=cfg.tracking.tracking_uri,
            experiment=cfg.tracking.experiment,
            coordinator=self.coordinator,
        )

    # ------------------------------------------------------------------
    def fit(self, data: WeatherArrays | None = None) -> TrainResult:
        # Not ported here, each a ROADMAP Queue A item: the compile cache
        # (item 18; the port's kernels are built once by ops/build.py and
        # a relaunch loads them from disk); profiling (item 19); the
        # goodput ledger, its startup-recovery debt and the end-of-run
        # metrics dump (item 27); lineage (item 29); pipelined spans
        # (item 30).
        cfg = self.cfg
        rank = process_index()
        events = event_log_from_config(cfg.obs, rank=rank)
        tracer = recorder_from_config(cfg.obs, rank=rank)
        fit_span = tracer.open(
            "trainer.fit", component="trainer", model=cfg.model.name,
            epochs=cfg.train.epochs, world_size=process_count())
        health = HealthMonitor.from_config(cfg.obs, emit=events.emit)
        plan = faults.FaultPlan.parse(cfg.resilience.fault_spec, rank=rank,
                                      sleep_s=cfg.resilience.fault_sleep_s)
        faults.set_default(plan)
        guard = (self._preempt_guard if self._preempt_guard is not None
                 else PreemptionGuard())
        if cfg.resilience.graceful_preemption:
            guard.install()
        heartbeat = None
        if cfg.obs.enabled and cfg.obs.heartbeat_dir:
            heartbeat = HeartbeatWriter(
                cfg.obs.heartbeat_dir, rank, run_id=events.run_id,
                min_interval=cfg.obs.heartbeat_interval)
            heartbeat.beat(phase="startup", force=True)
        events.emit("trainer", "fit_start", model=cfg.model.name,
                    epochs=cfg.train.epochs, resume=cfg.train.resume,
                    world_size=process_count())
        planes = _Planes(events, tracer, fit_span, health, plan, guard,
                         heartbeat, live_train_metrics(
                             cfg.obs, run_id=events.run_id, rank=rank))
        completed = preempted = False
        result = None
        try:
            result = self._fit(data, planes)
            completed = True
        except PreemptedError as e:
            preempted = True
            e.epoch_seconds = planes.epoch_seconds
            self._end_tracking_quietly("KILLED")
            raise
        except TrainingHealthError:
            self._end_tracking_quietly("FAILED")
            raise
        finally:
            guard.uninstall()
            if planes.live_metrics is not None:
                planes.live_metrics.close()
            # "done" stops the monitor ageing this rank; "preempted" and
            # "failed" name ends an exit code alone cannot.
            planes.beat(phase="done" if completed else (
                "preempted" if preempted else "failed"), force=True)
            if preempted:
                events.emit("trainer", "fit_preempted",
                            epochs_run=planes.epochs_run)
            elif not completed:
                events.emit("trainer", "fit_failed",
                            health=health.summary()["events"])
                for sp in (planes.ckpt_span, planes.epoch_span):
                    if sp is not None:
                        sp.end(error=True)
            fit_span.end(completed=completed, preempted=preempted,
                         epochs_run=planes.epochs_run,
                         val_loss=result.val_loss if result else None)
        events.emit("trainer", "fit_end", val_loss=result.val_loss,
                    val_acc=result.val_acc, epochs_run=planes.epochs_run,
                    health=health.summary()["events"])
        return result

    def _end_tracking_quietly(self, status: str) -> None:
        """Close the tracking run on a controlled exit (preemption, health
        halt) without masking it."""
        try:
            self.tracker.end_run(status)
        except Exception:  # noqa: BLE001 — the exit itself must surface
            pass

    @staticmethod
    def _preempt_exit(planes: _Planes, ckptr, *, epochs_completed: int,
                      state=None, meta: dict | None = None):
        """Honor a SIGTERM: make the resume checkpoint durable (join the
        span boundary's write, or save ``state`` now on the per-batch
        path), put the preemption on the record and raise
        :class:`PreemptedError`."""
        if state is not None:
            ckptr.save(state, meta=meta)
        else:
            ckptr.wait()
        planes.events.emit("trainer", "preempt.signal_received",
                           signal_time=planes.guard.signal_time)
        planes.events.emit("trainer", "preempt.checkpoint_saved",
                           epochs_completed=int(epochs_completed),
                           dir=ckptr.dirpath)
        raise PreemptedError(
            f"SIGTERM honored: resume checkpoint durable at "
            f"epochs_completed={int(epochs_completed)}")

    def _fit(self, data: WeatherArrays | None,
             planes: _Planes) -> TrainResult:
        cfg = self.cfg
        dev = self.device
        events, tracer, health = planes.events, planes.tracer, planes.health
        plan, guard = planes.plan, planes.guard
        startup_span = tracer.start("trainer.startup", component="trainer")
        data_provenance: dict = {}
        if data is None:
            from dct_tpu_torch.etl.preprocess import read_etl_state

            etl_state = read_etl_state(cfg.data.processed_dir)
            if etl_state.get("generation"):
                data_provenance = {
                    "data_generation": int(etl_state["generation"]),
                    "data_arrival_ts": float(
                        etl_state.get("arrival_ts") or 0.0),
                }
                if etl_state.get("stream_offsets") is not None:
                    data_provenance["stream_offsets"] = [
                        int(o) for o in etl_state["stream_offsets"]]
            data = load_processed_dataset(
                cfg.data.processed_dir,
                feature_suffix=cfg.data.feature_suffix,
                label_column=cfg.data.label_column,
            )

        sequence = is_sequence_model(cfg.model.name)
        if sequence:
            from dct_tpu_torch.data.windows import make_windows

            causal = is_causal_model(cfg.model.name)
            data = make_windows(
                data, cfg.model.seq_len, per_position_labels=causal,
                horizon=cfg.model.horizon if causal else 1,
            )
            # Hold out the tail, gapped so that no val window shares a
            # feature or label row with a train window.
            gap = cfg.model.seq_len + (cfg.model.horizon - 1 if causal else 0)
            train_idx, val_idx = contiguous_split(
                len(data), val_fraction=cfg.data.val_fraction, gap=gap)
        else:
            train_idx, val_idx = train_val_split(
                len(data), val_fraction=cfg.data.val_fraction,
                seed=cfg.train.seed)
        # batch_size is per data row; the model ranks of a row share
        # its block.
        mesh = make_mesh(cfg.mesh)
        set_mesh(mesh)
        n_blocks, block_id = process_data_block()
        global_batch = cfg.train.batch_size * n_blocks
        train_loader = BatchLoader(
            data, train_idx, global_batch=global_batch, shuffle=True,
            seed=cfg.train.seed, num_processes=n_blocks, process_id=block_id)
        val_loader = BatchLoader(
            data, val_idx, global_batch=global_batch, shuffle=False,
            seed=cfg.train.seed, num_processes=n_blocks, process_id=block_id)

        compute_dtype = (torch.bfloat16 if cfg.train.bf16_compute
                         else torch.float32)
        model = get_model(cfg.model, input_dim=data.input_dim, device=dev,
                          compute_dtype=compute_dtype, mesh=mesh)
        # Dropout draws the global batch's masks and keeps this block's.
        set_data_block(model, n_blocks, block_id)
        example_shape = ((1, cfg.model.seq_len, data.input_dim) if sequence
                         else None)
        state_ckptr = TrainStateCheckpointer(os.path.join(
            cfg.data.models_dir, "train_state", f"p{process_index()}"))
        accum = max(1, cfg.train.grad_accum_steps)
        updates_per_epoch = train_loader.num_batches // accum
        if accum > 1 and updates_per_epoch == 0:
            raise ValueError(
                f"grad_accum_steps={accum} exceeds the "
                f"{train_loader.num_batches} batches per epoch: every epoch "
                "would run zero optimizer updates")

        lr_schedule = None
        if cfg.train.lr_schedule != "constant" or cfg.train.warmup_steps > 0:
            decay = cfg.train.decay_steps
            if cfg.train.lr_schedule == "cosine" and decay <= 0:
                # Auto: decay over the whole trajectory, a resumed run's
                # earlier epochs included.
                prior = 0
                if cfg.train.resume and state_ckptr.exists():
                    prior = int(state_ckptr.load_meta().get(
                        "epochs_completed", 0))
                decay = max(1, (prior + cfg.train.epochs) * updates_per_epoch
                            - cfg.train.warmup_steps)
            lr_schedule = make_lr_schedule(
                cfg.train.lr, schedule=cfg.train.lr_schedule,
                warmup_steps=cfg.train.warmup_steps, decay_steps=decay,
                end_lr_fraction=cfg.train.end_lr_fraction)
        shard_kw = dict(shard_opt=cfg.train.shard_opt_state,
                        shard_params=cfg.train.shard_params,
                        family=cfg.model.name)
        state = create_train_state(
            model, input_dim=data.input_dim, lr=cfg.train.lr,
            seed=cfg.train.seed, example_shape=example_shape,
            lr_schedule=lr_schedule, weight_decay=cfg.train.weight_decay,
            grad_clip_norm=cfg.train.grad_clip_norm,
            optimizer=cfg.train.optimizer, momentum=cfg.train.momentum,
            mesh=mesh, **shard_kw)
        # The placement must be the declared one (the reference reconciles
        # its step's output drift here; the port's placement is explicit).
        drift = layout_mismatches(state, state_shardings(state, mesh,
                                                         **shard_kw))
        if drift:
            events.emit("trainer", "shard.layout_mismatch",
                        leaves=len(drift), reconciled=False)
            raise RuntimeError(f"state placed off its declared layout: "
                               f"{drift[:4]}")
        events.emit("trainer", "layout", mesh=dict(mesh.shape),
                    **_state_bytes(state))

        # Continuous training: no checkpoint trains [0, epochs); an
        # interrupted run finishes to its saved target; a completed run
        # continues for `epochs` more on the (possibly refreshed) data.
        start_epoch, target_epochs = 0, cfg.train.epochs
        opt_identity = optimizer_identity(cfg.train)
        if cfg.train.resume and state_ckptr.exists():
            saved = state_ckptr.load_meta()
            saved_opt = saved.get("optimizer")
            if saved_opt is not None and saved_opt != opt_identity:
                raise RuntimeError(
                    f"Resume refused: the checkpoint under "
                    f"{state_ckptr.dirpath} was written by optimizer "
                    f"{saved_opt} but this run configures {opt_identity}. "
                    "Restore the original DCT_OPTIMIZER / DCT_MOMENTUM / "
                    "DCT_WEIGHT_DECAY, or clear the train_state dir to "
                    "restart the trajectory.")
            state = state_ckptr.restore(state)
            if "epochs_completed" in saved:
                start_epoch = int(saved["epochs_completed"])
            else:
                start_epoch = state.step // max(train_loader.num_batches, 1)
            saved_target = int(saved.get("target_epochs", cfg.train.epochs))
            target_epochs = (start_epoch + cfg.train.epochs
                             if start_epoch >= saved_target else saved_target)
        if cfg.train.resume:
            seen = all_gather_ints(start_epoch)
            if min(seen) != max(seen):
                raise RuntimeError(
                    f"Resume divergence: per-process start epochs {seen} "
                    f"differ. Sync or clear "
                    f"{os.path.join(cfg.data.models_dir, 'train_state')} "
                    "on every host.")
        if start_epoch >= target_epochs:
            raise RuntimeError(
                f"Nothing to train: start_epoch={start_epoch} >= "
                f"target_epochs={target_epochs} (DCT_EPOCHS="
                f"{cfg.train.epochs}). Set a positive epoch budget.")
        ckptr = BestLastCheckpointer(cfg.data.models_dir)

        use_scan = cfg.train.use_scan
        chunk = max(1, cfg.train.epoch_chunk) if use_scan else 1
        # Spans run serially: the reference's pipelined consume (span e+1
        # dispatched before span e's bookkeeping, DCT_PREFETCH_SPANS) is
        # ROADMAP Queue A item 30.
        multi_fused = steps.make_multi_epoch_train_eval_step(
            accum_steps=accum, with_grad_norms=True)
        train_step = steps.make_train_step(accum_steps=accum,
                                           with_grad_norm=True)

        meta = {**dataclasses.asdict(cfg.model), "model": cfg.model.name,
                "input_dim": data.input_dim,
                "feature_names": list(data.feature_names),
                **data_provenance}
        meta.pop("name", None)
        run_id = self.tracker.start_run(params={
            **meta, "lr": cfg.train.lr, "batch_size": cfg.train.batch_size,
            "epochs": cfg.train.epochs, "seed": cfg.train.seed,
            "val_fraction": cfg.data.val_fraction,
            "global_batch": global_batch,
        })

        def to_dev(*arrays):
            return [torch.as_tensor(a, device=dev) for a in arrays]

        if use_scan:
            val_stacks = to_dev(*val_loader.epoch_stacked(0))

        history: list[dict] = []
        epoch_seconds: list[float] = []
        epoch_samples: list[int] = []
        global_step = state.step
        es_best, es_stale = None, 0
        span_end_vl_min = float("inf")

        def log_steps(losses: np.ndarray) -> None:
            nonlocal global_step
            n_log = max(1, cfg.train.log_every_n_steps)
            for i in range((-(global_step + 1)) % n_log, losses.size, n_log):
                self.tracker.log_metrics({"train_loss": float(losses[i])},
                                         step=global_step + i + 1)
            global_step += losses.size

        def bookkeep(e0, sub_epochs, seconds, samples, span_updates):
            """History, tracker, early stop and both checkpoint tiers
            for a finished span. Returns ``stop_early``."""
            nonlocal es_best, es_stale, span_end_vl_min
            k = len(sub_epochs)
            planes.beat(step=global_step, epoch=e0 + k - 1, phase="train")
            per_epoch_updates = span_updates // k if k else 0
            epoch_updates = samples // (global_batch * accum * k)
            stop_early = False
            last_rec = None
            for i, (epoch_loss, val_loss, val_acc, (tp, fp, fn)) in (
                    enumerate(sub_epochs)):
                rec = {"epoch": e0 + i,
                       "train_loss": (epoch_loss if epoch_loss is not None
                                      else float("nan")),
                       "val_loss": val_loss, "val_acc": val_acc}
                metrics = {"train_loss_epoch": rec["train_loss"],
                           "val_loss": val_loss, "val_acc": val_acc,
                           "epoch_time": seconds / k,
                           "samples_per_sec": samples / seconds}
                if cfg.model.num_classes == 2:
                    p, r, f1 = precision_recall_f1(tp, fp, fn)
                    rec["val_f1"] = f1
                    metrics.update(val_precision=p, val_recall=r, val_f1=f1)
                history.append(rec)
                step = (global_step - span_updates
                        + (i + 1) * per_epoch_updates if use_scan
                        else global_step)
                self.tracker.log_metrics(metrics, step=step)
                events.emit("trainer", "epoch_end", epoch=e0 + i,
                            train_loss=rec["train_loss"],
                            val_loss=val_loss, val_acc=val_acc)
                if planes.live_metrics is not None:
                    planes.live_metrics.epoch_end(
                        val_loss=val_loss, samples_per_sec=samples / seconds,
                        step_seconds=seconds / k / max(1, epoch_updates),
                        grad_norm=health.last_grad_norm)
                last_rec = rec
                if cfg.train.early_stop_patience > 0 and not stop_early:
                    es_best, es_stale, stop_early = early_stop_update(
                        val_loss, es_best, es_stale,
                        patience=cfg.train.early_stop_patience,
                        min_delta=cfg.train.early_stop_min_delta)
            if not math.isnan(sub_epochs[-1][1]):
                span_end_vl_min = min(span_end_vl_min, sub_epochs[-1][1])
            done = e0 + k
            planes.epochs_run += k
            planes.ckpt_span = tracer.open(
                "trainer.checkpoint", component="trainer", epoch=done - 1,
                parent_id=planes.epoch_span.span_id)
            # Dense on every process (a collective when the state is
            # split); only the coordinator writes.
            dense = (gather_tree(state) if self.coordinator
                     or state.layout.sharded else None)
            if self.coordinator:
                ckpt_metrics = {"val_loss": last_rec["val_loss"],
                                "val_acc": last_rec["val_acc"]}
                if "val_f1" in last_rec:
                    ckpt_metrics["val_f1"] = last_rec["val_f1"]
                ckptr.update(epoch=done - 1, metrics=ckpt_metrics,
                             params=dense, meta=meta)
            # Every process keeps its own resume state; an early stop marks
            # the run complete at the stop point.
            state_ckptr.save_async(state, meta={
                "epochs_completed": done,
                "target_epochs": done if stop_early else target_epochs,
                "optimizer": opt_identity,
            })
            planes.ckpt_span.end()
            planes.epoch_span.end(val_loss=sub_epochs[-1][1])
            return stop_early

        def staged(e: int):
            """Epoch ``e``'s [S, B, ...] stacks; a ``nan`` clause of the
            fault plan poisons the first batch's features, so the loss goes
            non-finite through the real compute path."""
            xs, ys, ws = train_loader.epoch_stacked(e)
            if plan.enabled and plan.check("data", epoch=e):
                xs = np.array(xs, copy=True)
                xs[0, ...] = np.nan
            return xs, ys, ws

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        startup_span.end(resumed=start_epoch > 0, start_epoch=start_epoch)
        try:
            epoch = start_epoch
            while epoch < target_epochs:
                # Epoch-boundary faults (crash / hang / slow_epoch); a
                # crash first joins the resume write in flight, so it
                # leaves a deterministic resume point.
                if plan.enabled:
                    plan.maybe_fire("epoch", epoch=epoch,
                                    pre_exit=state_ckptr.wait)
                k = min(chunk, target_epochs - epoch) if use_scan else 1
                planes.epoch_span = tracer.start(
                    "trainer.epoch", component="trainer", epoch=epoch, k=k,
                    parent_id=planes.fit_span.span_id)
                # Beat before the span: it runs for a whole epoch chunk.
                planes.beat(step=global_step, epoch=epoch, phase="train")
                t0 = time.perf_counter()
                if use_scan:
                    per = []
                    for e in range(epoch, epoch + k):
                        xs, ys, ws = staged(e)
                        # Whole accumulation groups only.
                        s_eff = (xs.shape[0] // accum) * accum
                        per.append(to_dev(xs[:s_eff], ys[:s_eff],
                                          ws[:s_eff]))
                    n_steps = per[0][0].shape[0]
                    state, losses, sums, gnorms = multi_fused(
                        state, *zip(*per), *val_stacks)
                    losses = losses.cpu().numpy()
                    gnorms = gnorms.cpu().numpy()
                    val_host = torch.stack(list(sums), dim=1).double().cpu()
                    sync()
                    seconds = time.perf_counter() - t0
                    flat = losses.reshape(-1)
                    log_steps(flat)
                    # Step-trigger faults fire at the span boundary: the
                    # steps inside a span are not interruptible from here.
                    if plan.enabled:
                        plan.maybe_fire("step", step=global_step,
                                        pre_exit=state_ckptr.wait)
                    # Health before any bookkeeping: a halt leaves no
                    # epoch_end and no checkpoint of the diverged state.
                    halt = health.observe_span(
                        flat, gnorms.reshape(-1),
                        start_step=global_step - flat.size, epoch=epoch,
                        steps_per_epoch=max(1, flat.size // k))
                    if halt is not None:
                        planes.epoch_span.end(halted=halt.kind)
                    HealthMonitor.raise_on(halt)
                    sub_epochs = [
                        (float(losses[i].mean()) if losses[i].size else None,
                         *_epoch_metrics(val_host[i]))
                        for i in range(k)
                    ]
                    samples = k * n_steps * global_batch
                    stop_early = bookkeep(epoch, sub_epochs, seconds,
                                          samples, losses.size)
                else:
                    loss_sum, n_steps, n_updates = 0.0, 0, 0
                    poison = plan.enabled and bool(
                        plan.check("data", epoch=epoch))
                    group = []
                    for batch in train_loader.epoch(epoch):
                        group.append(batch)
                        if len(group) < accum:
                            continue
                        bx, by, bw = (np.concatenate([getattr(b, f)
                                                      for b in group])
                                      for f in ("x", "y", "weight"))
                        group = []
                        if poison:
                            poison = False
                            bx = np.array(bx, copy=True)
                            bx[0, ...] = np.nan
                        state, m = train_step(state, *to_dev(bx, by, bw))
                        loss_host = float(m["train_loss"])
                        log_steps(np.asarray([loss_host]))
                        # This path reads each step's loss anyway: the
                        # hooks run per step.
                        if plan.enabled:
                            plan.maybe_fire("step", step=global_step,
                                            pre_exit=state_ckptr.wait)
                        finding = health.observe_step(
                            loss_host, grad_norm=float(m["grad_norm"]),
                            step=global_step, epoch=epoch)
                        if finding is not None and finding.halt:
                            planes.epoch_span.end(halted=finding.kind)
                        HealthMonitor.raise_on(finding)
                        n_steps += accum
                        n_updates += 1
                        loss_sum += loss_host
                        planes.beat(step=global_step, epoch=epoch,
                                    phase="train")
                        if guard.requested:
                            # Save the live state now; the resume restarts
                            # this epoch, losing under one epoch.
                            planes.epoch_span.end(preempted=True)
                            self._preempt_exit(
                                planes, state_ckptr, epochs_completed=epoch,
                                state=state, meta={
                                    "epochs_completed": epoch,
                                    "target_epochs": target_epochs,
                                    "optimizer": opt_identity})
                    sync()
                    seconds = time.perf_counter() - t0
                    epoch_loss = loss_sum / n_updates if n_updates else None
                    samples = n_steps * global_batch
                    with tracer.span("trainer.eval", component="trainer",
                                     epoch=epoch,
                                     parent_id=planes.epoch_span.span_id):
                        metrics = self._evaluate(state, val_loader)
                    stop_early = bookkeep(
                        epoch, [(epoch_loss, *metrics)], seconds, samples, 0)
                epoch_seconds.append(seconds)
                planes.epoch_seconds += seconds
                epoch_samples.append(samples)
                epoch += k
                # Graceful preemption at the span boundary: the span's
                # resume snapshot was just submitted; join it and exit.
                if guard.requested:
                    self._preempt_exit(planes, state_ckptr,
                                       epochs_completed=epoch)
                if stop_early:
                    break
        finally:
            state_ckptr.wait()

        best_path = ckptr.best_model_path
        if self.coordinator:
            if not os.path.exists(best_path):
                best_path = ckptr.last_path
            if os.path.exists(best_path):
                self._log_model(best_path, meta)
        self.tracker.end_run()
        if self.coordinator and chunk > 1 and history:
            valid = [h["val_loss"] for h in history
                     if not math.isnan(h["val_loss"])]
            if valid and min(valid) < span_end_vl_min - 1e-12:
                print(f"[dct_tpu_torch] epoch_chunk={chunk}: the run's best "
                      f"val_loss {min(valid):.6f} occurred mid-span; the "
                      "deploy 'best' checkpoint holds the best span-end "
                      f"epoch ({span_end_vl_min:.6f}). Lower "
                      "DCT_EPOCH_CHUNK if it must capture the optimum.",
                      file=sys.stderr, flush=True)
        final = history[-1] if history else {"val_loss": float("nan"),
                                             "val_acc": float("nan")}
        steady = list(zip(epoch_samples, epoch_seconds))[1:] or list(
            zip(epoch_samples, epoch_seconds))
        return TrainResult(
            val_loss=final["val_loss"], val_acc=final["val_acc"],
            best_model_path=best_path, last_model_path=ckptr.last_path,
            history=history,
            samples_per_sec=sum(epoch_samples) / max(sum(epoch_seconds),
                                                     1e-12),
            steady_samples_per_sec=(sum(n / s for n, s in steady)
                                    / max(len(steady), 1)),
            epoch_seconds=epoch_seconds, run_id=run_id, state=state,
            layout={"mesh": dict(mesh.shape), **_state_bytes(state),
                    **_gathered_bytes(state),
                    "local_heads": _local_heads(state.model)},
        )

    # ------------------------------------------------------------------
    def _log_model(self, best_path: str, meta: dict) -> None:
        """The best checkpoint under the tracking artifact path, and under
        ``model`` beside an ``MLmodel.json`` that describes it."""
        self.tracker.log_artifact(
            best_path, artifact_path=self.cfg.tracking.artifact_path)
        with tempfile.TemporaryDirectory() as td:
            mlmodel = os.path.join(td, "MLmodel.json")
            with open(mlmodel, "w") as f:
                json.dump({"flavor": "dct_tpu",
                           "checkpoint": os.path.basename(best_path),
                           "serving": "dct_tpu.serving.runtime", **meta},
                          f, indent=2)
            self.tracker.log_artifact(mlmodel, artifact_path="model")
            self.tracker.log_artifact(best_path, artifact_path="model")

    def _evaluate(self, state, val_loader) -> tuple[float, float, tuple]:
        """(val_loss, val_acc, (tp, fp, fn)) of the per-batch path."""
        eval_step = steps.make_eval_step()
        sums = [torch.zeros((), device=self.device) for _ in range(6)]
        for batch in val_loader.epoch(0):
            x, y, w = (torch.as_tensor(a, device=self.device)
                       for a in (batch.x, batch.y, batch.weight))
            sums = [a + b for a, b in zip(sums, eval_step(state, x, y, w))]
        return _epoch_metrics(all_reduce_sum(sums))
