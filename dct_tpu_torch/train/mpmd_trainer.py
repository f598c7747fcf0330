"""The MPMD pipeline trainer (counterpart of
``dct_tpu/train/mpmd_trainer.py``): ``weather_transformer_pp`` trained as
P stage programs, one card each (:mod:`dct_tpu_torch.parallel.mpmd`),
through the same data and checkpoint machinery as ``Trainer.fit``:

- **data**: the windows, split and batch order of ``Trainer.fit``
  (:func:`build_loaders`), so a stage process and the sequential run see
  the same batches; ``DCT_BATCH_SIZE`` is the global batch and must tile
  ``DCT_MPMD_MICROBATCHES``;
- **init**: the full model and train state are built as ``Trainer.fit``
  builds them (:func:`build_full_state`) and split per stage, so the
  stages start bitwise from the sequential run's init;
- **telemetry**: ``mpmd.step_report`` (the last step's bubble and each
  stage's busy, transfer-wait, fill, steady and drain seconds and flash
  launches), ``mpmd.pivot`` and ``mpmd.fit_end`` events, and an
  ``mpmd.epoch`` span an epoch under ``mpmd.fit``;
- **checkpoint**: each stage owns a resume tier,
  ``<models>/train_state_mpmd/stage<k>/p0``, under one ``manifest.json``
  naming the stage map. :func:`adopt_mpmd_checkpoint` merges them into a
  plain ``train_state/p<rank>`` (the MPMD -> SPMD pivot, which
  ``Trainer.fit`` runs on resume), and a fit resumed over a plain
  ``train_state`` splits it (SPMD -> MPMD); both are bitwise.

MPMD mode requires the pipeline family with dropout 0, the constant lr
schedule and no clipping (:func:`_validate_cfg`, the reference's
messages). Not ported here, each a ROADMAP item: the per-stage AOT store
(``stage_store``, item 18: the port's kernels are built once by
``ops/build.py``); the per-stage roofline and MFU records
(``stage_mfu_record``, ``_stage_roofline``, item 19); the goodput
ledger's billing of steps, eval, checkpoints and start-up (item 27).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np
import torch

from dct_tpu_torch.config import RunConfig
from dct_tpu_torch.observability import events as _events
from dct_tpu_torch.observability import spans as _spans
from dct_tpu_torch.parallel import mpmd

MPMD_FAMILY = "weather_transformer_pp"
MPMD_STATE_DIRNAME = "train_state_mpmd"


# ----------------------------------------------------------------------
# Stage functions: the PP family's forward cut at its stage boundaries.


def build_stage_fns(model_cfg) -> dict:
    """The model-level stage callables for :func:`mpmd.
    make_stage_programs`, each taking a :class:`mpmd.StageModel`:
    ``first_fwd`` = ``in_proj`` + positions + the stage's blocks;
    ``mid_fwd`` = the blocks; ``last_fwd`` = the blocks + ``ln_out`` +
    the pooled head + the masked cross entropy ``(loss_sum, count)``;
    ``last_eval`` = the six eval sums. The same modules and math as
    ``WeatherTransformerPP.forward`` at dropout 0, each stage's blocks run
    by its ``StageStack`` from its own parameters."""
    from dct_tpu_torch.models.transformer import embed_positions
    from dct_tpu_torch.ops.losses import (
        masked_accuracy,
        masked_binary_counts,
        masked_cross_entropy,
    )

    mpmd.stage_layers(model_cfg.n_layers, int(model_cfg.n_stages))

    def first_fwd(m, x):
        h, rope, _ = embed_positions(m, x)
        return m.stage.run(h, 0, rope)

    def mid_fwd(m, a):
        return m.stage.run(a, 0, m.rope(a.shape[1]))

    def _logits(m, a):
        h = m.ln_out(m.stage.run(a, 0, m.rope(a.shape[1])))
        return m.head(h.mean(dim=1)).float()

    def last_fwd(m, a, y, w):
        return masked_cross_entropy(_logits(m, a), y, w)

    def last_eval(m, a, y, w):
        logits = _logits(m, a)
        loss_sum, count = masked_cross_entropy(logits, y, w)
        acc_sum, _ = masked_accuracy(logits, y, w)
        tp, fp, fn = masked_binary_counts(logits, y, w)
        return loss_sum, acc_sum, count, tp, fp, fn

    return {"first_fwd": first_fwd, "mid_fwd": mid_fwd,
            "last_fwd": last_fwd, "last_eval": last_eval}


# ----------------------------------------------------------------------
# Checkpoint layout + cross-topology pivots.


def mpmd_state_root(models_dir: str) -> str:
    return os.path.join(models_dir, MPMD_STATE_DIRNAME)


def _manifest_path(models_dir: str) -> str:
    return os.path.join(mpmd_state_root(models_dir), "manifest.json")


def read_manifest(models_dir: str) -> dict:
    try:
        with open(_manifest_path(models_dir)) as f:
            return dict(json.load(f))
    except (OSError, ValueError):
        return {}


def write_manifest(models_dir: str, manifest: dict) -> None:
    """Publish the manifest (stage 0 alone writes it; a pid-suffixed
    temp file and ``os.replace`` keep it whole under concurrent
    writers)."""
    root = mpmd_state_root(models_dir)
    os.makedirs(root, exist_ok=True)
    final = _manifest_path(models_dir)
    tmp = f"{final}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(tmp, final)


def stage_checkpointer(models_dir: str, k: int):
    from dct_tpu_torch.checkpoint.manager import TrainStateCheckpointer

    return TrainStateCheckpointer(
        os.path.join(mpmd_state_root(models_dir), f"stage{k}", "p0")
    )


def mpmd_checkpoint_present(models_dir: str) -> bool:
    return bool(read_manifest(models_dir))


def _spmd_checkpointer(models_dir: str):
    from dct_tpu_torch.checkpoint.manager import TrainStateCheckpointer
    from dct_tpu_torch.parallel.distributed import process_index

    return TrainStateCheckpointer(
        os.path.join(models_dir, "train_state", f"p{process_index()}"))


def adopt_mpmd_checkpoint(models_dir: str, template_state) -> dict:
    """The MPMD -> SPMD pivot: restore every stage of the checkpoint set
    into ``template_state``'s stage slices (an unplaced full state of the
    pipeline family), merge them (bitwise) and publish a plain
    ``train_state/p<rank>`` that ``Trainer.fit`` restores like any other.
    Returns the meta written; raises when the template cannot tile the
    saved stage count or a stage file is missing."""
    manifest = read_manifest(models_dir)
    if not manifest:
        raise FileNotFoundError(
            f"no MPMD manifest under {mpmd_state_root(models_dir)}"
        )
    n_stages = int(manifest["n_stages"])
    stage_states = []
    for k in range(n_stages):
        tmpl_k = mpmd.split_state(template_state, k, n_stages)
        ckptr = stage_checkpointer(models_dir, k)
        if not ckptr.exists():
            raise FileNotFoundError(
                f"MPMD manifest names {n_stages} stages but stage {k} "
                f"has no checkpoint under {ckptr.dirpath}"
            )
        stage_states.append(ckptr.restore(tmpl_k))
    merged = mpmd.merge_stage_states(stage_states, template_state)
    meta = dict(stage_checkpointer(models_dir, 0).load_meta())
    meta.pop("stage", None)
    _spmd_checkpointer(models_dir).save(merged, meta)
    _events.get_default().emit(
        "mpmd", "mpmd.pivot", direction="mpmd_to_spmd",
        n_stages=n_stages, epochs_completed=meta.get("epochs_completed"),
        digest=state_digest(merged),
    )
    return meta


def state_digest(state) -> str:
    """sha256 over ``state``'s resume-tier leaves in order (flax layout):
    equal digests are equal leaves, bitwise. The pivot events carry it,
    so a caller can hold a pivot to the files it read."""
    from dct_tpu_torch.checkpoint.manager import state_leaves

    h = hashlib.sha256()
    for a in state_leaves(state):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _opt_identity(train_cfg) -> dict:
    from dct_tpu_torch.train.trainer import optimizer_identity

    return optimizer_identity(train_cfg)


def _check_opt_identity(saved_meta: dict, train_cfg, where: str) -> None:
    """The Trainer's exact-compare resume refusal, applied to the MPMD
    paths: optimizer states of different configs can have the same
    shapes, so a restore refuses BEFORE training from mismatched
    moments."""
    saved_opt = saved_meta.get("optimizer")
    want = _opt_identity(train_cfg)
    if saved_opt is not None and saved_opt != want:
        raise RuntimeError(
            f"Resume refused: {where} was written by optimizer "
            f"{saved_opt} but this run configures {want}. Restore the "
            "original DCT_OPTIMIZER / DCT_MOMENTUM / DCT_WEIGHT_DECAY, "
            "or clear the checkpoint dir to restart the trajectory."
        )


def _restore_from_spmd(models_dir: str, full_template):
    """The SPMD -> MPMD pivot source: a plain ``train_state/p<rank>``
    restored into the full-model template, ready to split per stage;
    ``(None, {})`` when there is none."""
    ckptr = _spmd_checkpointer(models_dir)
    if not ckptr.exists():
        return None, {}
    return ckptr.restore(full_template), ckptr.load_meta()


def continue_target(meta: dict, epochs: int) -> tuple[int, int]:
    """``(start_epoch, target_epochs)`` of a resume: an interrupted run
    finishes to its saved target; a completed one extends by this run's
    ``epochs``."""
    start = int(meta.get("epochs_completed", 0))
    saved_target = int(meta.get("target_epochs", epochs))
    return start, (start + epochs if start >= saved_target
                   else saved_target)


def stage_meta(cfg: RunConfig, epochs_done: int, target: int, **extra):
    """A stage file's meta (the Trainer's optimizer-refusal key
    included, so an SPMD resume of this trajectory refuses a change)."""
    return {"epochs_completed": epochs_done, "target_epochs": target,
            "family": cfg.model.name,
            "optimizer": _opt_identity(cfg.train), **extra}


def manifest_of(cfg: RunConfig, spec, epochs_done: int) -> dict:
    return {"version": 1, "n_stages": spec.n_stages,
            "device_counts": list(spec.device_counts),
            "schedule": spec.schedule,
            "n_microbatches": spec.n_microbatches,
            "family": cfg.model.name, "n_layers": cfg.model.n_layers,
            "epochs_completed": epochs_done}


# ----------------------------------------------------------------------
# The trainer.


@dataclasses.dataclass
class MpmdResult:
    """``step_losses`` and ``step_seconds``: every train step's loss and
    wall in order; ``stage_launches``: each stage's flash launches over
    the fit, by ``train`` and ``eval``."""

    train_losses: list
    val_losses: list
    epochs_completed: int
    bubble: dict
    step_losses: list
    step_seconds: list
    stage_launches: list


def _validate_cfg(cfg: RunConfig) -> None:
    if cfg.model.name != MPMD_FAMILY:
        raise mpmd.MpmdSpecError(
            f"MPMD mode trains the pipeline-parallel family only "
            f"(DCT_MODEL={cfg.model.name!r}; expected {MPMD_FAMILY!r})"
        )
    if cfg.model.dropout != 0.0:
        raise mpmd.MpmdSpecError(
            f"MPMD stage programs are deterministic: set DCT_DROPOUT=0 "
            f"(got {cfg.model.dropout}) — the PP family already applies "
            "dropout outside the pipelined region"
        )
    if cfg.train.grad_clip_norm > 0:
        raise mpmd.MpmdSpecError(
            "DCT_GRAD_CLIP_NORM > 0 needs a cross-stage global-norm "
            "reduction the MPMD transfer plane does not carry; disable "
            "clipping for MPMD mode"
        )
    if cfg.train.lr_schedule != "constant" or cfg.train.warmup_steps:
        raise mpmd.MpmdSpecError(
            "MPMD mode supports the constant lr schedule only "
            f"(DCT_LR_SCHEDULE={cfg.train.lr_schedule!r})"
        )


def build_full_state(cfg: RunConfig, input_dim: int, *, device="cpu",
                     compute_dtype=None):
    """The full pipeline-family TrainState, initialized as
    ``Trainer.fit`` initializes it (same seed, optimizer and values), on
    ``device`` and unplaced: the stages are splits of it."""
    from dct_tpu_torch.models.registry import get_model
    from dct_tpu_torch.train.state import create_train_state

    ct = compute_dtype or (
        torch.bfloat16 if cfg.train.bf16_compute else torch.float32
    )
    model = get_model(cfg.model, input_dim=input_dim, device=device,
                      compute_dtype=ct)
    return create_train_state(
        model, input_dim=input_dim, lr=cfg.train.lr, seed=cfg.train.seed,
        example_shape=(1, cfg.model.seq_len, input_dim),
        weight_decay=cfg.train.weight_decay,
        optimizer=cfg.train.optimizer, momentum=cfg.train.momentum,
    )


def build_loaders(cfg: RunConfig, spec, data=None):
    """``Trainer.fit``'s windows, split and loaders for the sequence
    families (same seed, same order): every stage process and the
    sequential run see the same batches. ``DCT_BATCH_SIZE`` is the
    global batch and must tile the microbatch count."""
    from dct_tpu_torch.data.dataset import load_processed_dataset
    from dct_tpu_torch.data.pipeline import BatchLoader, contiguous_split
    from dct_tpu_torch.data.windows import make_windows

    if data is None:
        data = load_processed_dataset(
            cfg.data.processed_dir,
            feature_suffix=cfg.data.feature_suffix,
            label_column=cfg.data.label_column,
        )
    data = make_windows(data, cfg.model.seq_len)
    train_idx, val_idx = contiguous_split(
        len(data), val_fraction=cfg.data.val_fraction,
        gap=cfg.model.seq_len,
    )
    global_batch = cfg.train.batch_size
    if global_batch % spec.n_microbatches:
        raise mpmd.MpmdSpecError(
            f"DCT_BATCH_SIZE={global_batch} (the global batch in MPMD "
            f"mode) does not tile DCT_MPMD_MICROBATCHES="
            f"{spec.n_microbatches}"
        )
    train_loader = BatchLoader(
        data, train_idx, global_batch=global_batch, shuffle=True,
        seed=cfg.train.seed,
    )
    val_loader = BatchLoader(
        data, val_idx, global_batch=global_batch, shuffle=False,
        seed=cfg.train.seed,
    )
    return data, train_loader, val_loader


def _add(total: dict, counts: dict) -> None:
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


class MpmdTrainer:
    """The in-process MPMD trainer: one thread per stage, each on its
    card (:class:`mpmd.MpmdRunner`). The per-stage-process form is
    :mod:`dct_tpu_torch.train.mpmd_worker`, with the same schedule,
    executor and checkpoint layout. ``device`` (default ``DCT_DEVICE``)
    puts every stage on one device (``cpu`` for the CPU); without it
    stage ``k`` takes card ``sum(counts[:k])``."""

    def __init__(self, cfg: RunConfig | None = None, *, device=None):
        self.cfg = cfg or RunConfig.from_env()
        self.device = device

    def _resume(self, spec, full_state, devices, events):
        """``(stage states or None, start_epoch, target_epochs)`` from the
        stage files, else a plain SPMD ``train_state`` (pivoted), each
        stage on its device."""
        cfg = self.cfg
        models_dir = cfg.data.models_dir
        target = cfg.train.epochs
        if not cfg.train.resume:
            return None, 0, target
        ckptrs = [stage_checkpointer(models_dir, k)
                  for k in range(spec.n_stages)]
        manifest = read_manifest(models_dir)
        if manifest:
            if int(manifest.get("n_stages", spec.n_stages)) != spec.n_stages:
                raise mpmd.MpmdSpecError(
                    f"checkpoint manifest holds "
                    f"{manifest.get('n_stages')} stages but the run "
                    f"configures {spec.n_stages} — an untileable stage "
                    "map; restore the saving DCT_MPMD_STAGES or clear "
                    f"{mpmd_state_root(models_dir)}"
                )
            # A manifest with missing stage files is a TORN set: a silent
            # fresh start would overwrite the surviving stages' progress.
            missing = [k for k, c in enumerate(ckptrs) if not c.exists()]
            if missing:
                raise FileNotFoundError(
                    f"MPMD manifest names {spec.n_stages} stages but "
                    f"stage(s) {missing} have no checkpoint under "
                    f"{mpmd_state_root(models_dir)} — a torn "
                    "checkpoint set; restore the files or clear the "
                    "dir to restart the trajectory"
                )
            saved = ckptrs[0].load_meta()
            _check_opt_identity(
                saved, cfg.train,
                f"the MPMD checkpoint set under {mpmd_state_root(models_dir)}",
            )
            states = [ckptrs[k].restore(mpmd.split_state(
                full_state, k, spec.n_stages, device=devices[k]))
                for k in range(spec.n_stages)]
            return (states, *continue_target(saved, cfg.train.epochs))
        restored, meta = _restore_from_spmd(models_dir, full_state)
        if restored is None:
            return None, 0, target
        _check_opt_identity(meta, cfg.train,
                            "the SPMD train_state checkpoint")
        states = [mpmd.split_state(restored, k, spec.n_stages,
                                   device=devices[k])
                  for k in range(spec.n_stages)]
        start, target = continue_target(meta, cfg.train.epochs)
        events.emit("mpmd", "mpmd.pivot", direction="spmd_to_mpmd",
                    n_stages=spec.n_stages, epochs_completed=start,
                    digests=[state_digest(s) for s in states])
        return states, start, target

    def fit(self, data=None) -> MpmdResult:
        cfg = self.cfg
        _validate_cfg(cfg)
        # Config-built sinks, installed as the process defaults (the
        # Trainer's pattern): the checkpoint tiers stamp the same run ID.
        events = _events.event_log_from_config(cfg.obs)
        tracer = _spans.recorder_from_config(cfg.obs)
        device = (self.device if self.device is not None
                  else os.environ.get("DCT_DEVICE") or None)
        spec = cfg.mpmd.to_spec(
            n_devices=None if device is not None
            else torch.cuda.device_count())
        devices = mpmd.carve_stage_meshes(
            spec.device_counts, model=max(1, cfg.mesh.model), device=device)
        data, train_loader, val_loader = build_loaders(cfg, spec, data)
        # The full state is built where the first stage runs, from
        # Trainer.fit's seed and optimizer, then split onto each card.
        full_state = build_full_state(cfg, data.input_dim,
                                      device=devices[0])
        stage_states, start_epoch, target_epochs = self._resume(
            spec, full_state, devices, events)
        if stage_states is None:
            stage_states = [mpmd.split_state(full_state, k, spec.n_stages,
                                             device=devices[k])
                            for k in range(spec.n_stages)]
        del full_state
        stage_fns = build_stage_fns(cfg.model)
        programs = [mpmd.make_stage_programs(k, spec.n_stages, stage_fns)
                    for k in range(spec.n_stages)]
        runner = mpmd.MpmdRunner(spec, stage_states, programs, devices)
        ckptrs = [stage_checkpointer(cfg.data.models_dir, k)
                  for k in range(spec.n_stages)]

        train_losses: list[float] = []
        val_losses: list[float] = []
        step_losses: list[float] = []
        step_seconds: list[float] = []
        launches = [{"train": {}, "eval": {}} for _ in range(spec.n_stages)]
        bubble: dict = {}
        fit_span = tracer.open(
            "mpmd.fit", component="mpmd", n_stages=spec.n_stages,
            schedule=spec.schedule,
        )
        try:
            for epoch in range(start_epoch, target_epochs):
                ep_span = tracer.start(
                    "mpmd.epoch", component="mpmd", epoch=epoch,
                    parent_id=fit_span.span_id,
                )
                losses, last_wall = [], 0.0
                for batch in train_loader.epoch(epoch):
                    loss, last_wall = runner.train_step(
                        batch.x, batch.y, batch.weight)
                    losses.append(loss)
                    step_seconds.append(last_wall)
                    for k, rep in enumerate(runner.last_reports):
                        _add(launches[k]["train"], rep.launches)
                sums = np.zeros(6, np.float64)
                for batch in val_loader.epoch(epoch):
                    sums += np.asarray(runner.eval_pass(
                        batch.x, batch.y, batch.weight), np.float64)
                    for k, rep in enumerate(runner.last_eval_reports):
                        _add(launches[k]["eval"], rep.launches)
                val_loss = float(sums[0] / max(sums[2], 1.0))
                step_losses += losses
                train_losses.append(float(np.mean(losses)))
                val_losses.append(val_loss)
                bubble = runner.step_bubble(last_wall)
                events.emit("mpmd", "mpmd.step_report", epoch=epoch,
                            train_loss=train_losses[-1], val_loss=val_loss,
                            **bubble)
                agg = {f: round(sum(s[f] for s in bubble["stages"]), 6)
                       for f in ("busy_s", "transfer_wait_s", "fill_s",
                                 "steady_s", "drain_s")}
                meta = stage_meta(cfg, epoch + 1, target_epochs,
                                  val_loss=val_loss)
                for k in range(spec.n_stages):
                    ckptrs[k].save(runner.states[k], dict(meta, stage=k))
                write_manifest(cfg.data.models_dir,
                               manifest_of(cfg, spec, epoch + 1))
                ep_span.end(
                    train_loss=train_losses[-1], val_loss=val_loss,
                    steady_bubble=bubble.get("steady_bubble"),
                    step_bubble=bubble.get("step_bubble"), **agg,
                )
        finally:
            fit_span.end(epochs=len(train_losses))
        events.emit(
            "mpmd", "mpmd.fit_end", epochs_completed=target_epochs,
            steady_bubble=bubble.get("steady_bubble"),
            step_bubble=bubble.get("step_bubble"),
        )
        return MpmdResult(
            train_losses=train_losses, val_losses=val_losses,
            epochs_completed=target_epochs, bubble=bubble,
            step_losses=step_losses, step_seconds=step_seconds,
            stage_launches=launches,
        )

