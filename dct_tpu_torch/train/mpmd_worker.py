"""``python -m dct_tpu_torch.train.mpmd_worker``: one MPMD stage, one
process (counterpart of ``dct_tpu/train/mpmd_worker.py``).

The multi-process deployment of the MPMD trainer: the supervised launcher
(``python -m dct_tpu_torch.resilience.supervise --world-size P -- python
-m dct_tpu_torch.train.mpmd_worker``) runs P of these. Each process owns
ONE stage and its card, builds only its stage's programs, and exchanges
activations and gradients with its neighbours over the TCP transfer
plane (:mod:`dct_tpu_torch.parallel.mpmd_transfer`); no process joins a
collective world. The stage id comes from ``DCT_MPMD_STAGE_ID`` (or the
launcher's ``NODE_RANK``), so heartbeats, the stall monitor, the exit-code
classifier and relaunch-with-resume apply unchanged:

- stage ``k`` runs on card ``sum(counts[:k])``, refused when this host
  has no such card (two stages never share one) unless ``DCT_DEVICE``
  names the device every stage takes (``cpu`` for the CPU, ``cuda:0`` to
  run ``1,1`` on one card);
- SIGTERM: finish the epoch in flight (the stages stop at one
  boundary), save the stage's resume checkpoint, emit ``mpmd.stage_done
  preempted=true`` and exit ``EXIT_PREEMPTED`` (75): the world classifies
  "preempted" and relaunches resumed;
- on resume every stage first checks the set is whole (every stage's
  ``epochs_completed`` equal, none missing while others or the manifest
  show progress) and refuses a torn set; a plain SPMD ``train_state``
  with no stage files pivots in (``mpmd.pivot``);
- each epoch ends with the validation batches pipelined forward, as in
  the in-process trainer (the reference's worker trains only), so the
  last stage's ``mpmd.step_report`` carries the epoch's ``val_loss``;
- a wedged neighbour: the transfer plane's timeout
  (``DCT_MPMD_TRANSFER_TIMEOUT_S``) emits ``mpmd.transfer_timeout`` and
  exits 1, which the classifier can heal.

Every stage builds the same loader stream (same seed and order; stage 0
reads the features, the last stage the labels and weights), so
microbatches line up across processes with no data plane beyond the
activation wire. The last stage emits ``mpmd.step_report`` an epoch;
stage 0 writes the manifest. Each process prints ``[mpmd_worker s<k>]
launches {...}``, its flash launches, when it ends (and on a card
``[mpmd_worker s<k>] memory {...}``, its peak allocated bytes).
"""

from __future__ import annotations

import json
import os
import signal
import sys


def stage_id() -> int:
    return int(os.environ.get("DCT_MPMD_STAGE_ID")
               or os.environ.get("NODE_RANK") or "0")


def main() -> int:
    stage = stage_id()
    # The worker is a world of its own: drop the launcher's rendezvous
    # env so nothing tries to join a collective.
    n_stages_env = int(os.environ.get("WORLD_SIZE")
                       or os.environ.get("DCT_NUM_PROCESSES") or "0")
    for k in ("DCT_NUM_PROCESSES", "DCT_PROCESS_ID", "WORLD_SIZE"):
        os.environ.pop(k, None)
    os.environ["DCT_MPMD_STAGE_ID"] = str(stage)

    from dct_tpu_torch.config import RunConfig
    from dct_tpu_torch.ops import flash_attention as fa
    from dct_tpu_torch.parallel import mpmd

    cfg = RunConfig.from_env()
    from dct_tpu_torch.train import mpmd_trainer as mt

    mt._validate_cfg(cfg)
    if "," not in (cfg.mpmd.stages or "").strip():
        # A bare stage count splits "the pool" evenly, which a stage
        # process cannot see: multi-process mode needs explicit counts.
        raise mpmd.MpmdSpecError(
            f"DCT_MPMD_STAGES={cfg.mpmd.stages!r}: multi-process MPMD "
            "needs EXPLICIT per-stage device counts (e.g. '1,1'), not "
            "a bare stage count — each stage process sizes its own "
            "device world from its entry"
        )
    spec = cfg.mpmd.to_spec()
    if n_stages_env and n_stages_env != spec.n_stages:
        raise mpmd.MpmdSpecError(
            f"launcher world size {n_stages_env} != "
            f"{spec.n_stages} stages in DCT_MPMD_STAGES"
        )
    if not (0 <= stage < spec.n_stages):
        raise mpmd.MpmdSpecError(
            f"stage id {stage} out of range for {spec.n_stages} stages"
        )
    try:
        rc = _run(cfg, spec, stage)
        # Saved and leaving: a late SIGTERM (the launcher tearing down the
        # world once a peer has exited) must not turn this exit into a
        # signal death, interpreter shutdown included.
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        return rc
    finally:
        print(f"[mpmd_worker s{stage}] launches "
              f"{json.dumps(fa.launch_counts())}", flush=True)
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            print(f"[mpmd_worker s{stage}] memory " + json.dumps(
                {"max_memory_allocated": torch.cuda.max_memory_allocated()}),
                flush=True)


def stage_device(spec, stage: int, model: int = 1, override=None):
    """Stage ``stage``'s device by :func:`~dct_tpu_torch.device.
    process_device`'s rule: card ``sum(counts[:stage])``, refused when
    this host has no such card, unless ``override`` (``DCT_DEVICE``)
    names the device."""
    from dct_tpu_torch.device import process_device
    from dct_tpu_torch.parallel.mpmd import check_stage_slices

    check_stage_slices(spec.device_counts, model=model)
    first_card = int(sum(spec.device_counts[:stage]))
    return process_device(first_card, spec.total_devices, override)


def _run(cfg, spec, stage: int) -> int:
    import numpy as np
    import torch

    from dct_tpu_torch.observability import events as _events
    from dct_tpu_torch.observability.heartbeat import HeartbeatWriter
    from dct_tpu_torch.parallel import mpmd, mpmd_transfer
    from dct_tpu_torch.resilience.preempt import PreemptionGuard
    from dct_tpu_torch.resilience.supervisor import EXIT_PREEMPTED
    from dct_tpu_torch.train import mpmd_trainer as mt

    device = stage_device(spec, stage, max(1, cfg.mesh.model),
                          os.environ.get("DCT_DEVICE") or None)
    events = _events.event_log_from_config(cfg.obs, rank=stage)
    hb = None
    if cfg.obs.enabled and cfg.obs.heartbeat_dir:
        hb = HeartbeatWriter(cfg.obs.heartbeat_dir, stage,
                             run_id=events.run_id,
                             min_interval=cfg.obs.heartbeat_interval)
    guard = PreemptionGuard().install()

    def beat(**kw):
        if hb is not None:
            hb.beat(**kw)

    data, train_loader, val_loader = mt.build_loaders(cfg, spec)
    full_state = mt.build_full_state(cfg, data.input_dim, device=device)
    state = mpmd.split_state(full_state, stage, spec.n_stages)
    ckptr = mt.stage_checkpointer(cfg.data.models_dir, stage)
    start_epoch, target_epochs = 0, cfg.train.epochs

    if cfg.train.resume:
        # Cross-stage agreement BEFORE resolving this stage's path (the
        # SPMD trainer's start-epoch refusal, file-based): a teardown
        # between two stages' saves, or a stage missing its files while
        # its peers or the manifest show progress, is a TORN set;
        # resuming it would pair one epoch's features with another's
        # labels.
        epochs_seen = {}
        for k in range(spec.n_stages):
            peer = mt.stage_checkpointer(cfg.data.models_dir, k)
            if peer.exists():
                epochs_seen[k] = int(
                    peer.load_meta().get("epochs_completed", 0))
        manifest = mt.read_manifest(cfg.data.models_dir)
        torn = len(set(epochs_seen.values())) > 1 or (
            stage not in epochs_seen and bool(epochs_seen or manifest))
        if torn:
            raise RuntimeError(
                f"Resume divergence: stage {stage} sees per-stage "
                f"epochs_completed {epochs_seen} (manifest: "
                f"{manifest.get('epochs_completed')}) — a teardown "
                "tore the stage checkpoint set. Clear "
                f"{mt.mpmd_state_root(cfg.data.models_dir)} or restore "
                "matching generations on every stage."
            )
        if ckptr.exists():
            saved = ckptr.load_meta()
            mt._check_opt_identity(
                saved, cfg.train, f"stage {stage}'s MPMD checkpoint")
            state = ckptr.restore(state)
            start_epoch, target_epochs = mt.continue_target(
                saved, cfg.train.epochs)
        else:
            restored, meta = mt._restore_from_spmd(cfg.data.models_dir,
                                                   full_state)
            if restored is not None:
                mt._check_opt_identity(
                    meta, cfg.train, "the SPMD train_state checkpoint")
                state = mpmd.split_state(restored, stage, spec.n_stages)
                start_epoch, target_epochs = mt.continue_target(
                    meta, cfg.train.epochs)
                events.emit(
                    "mpmd", "mpmd.pivot", direction="spmd_to_mpmd",
                    n_stages=spec.n_stages, stage=stage,
                    epochs_completed=start_epoch,
                    digest=mt.state_digest(state),
                )
    del full_state

    programs = mpmd.make_stage_programs(
        stage, spec.n_stages, mt.build_stage_fns(cfg.model))
    events.emit(
        "mpmd", "mpmd.stage_start", stage=stage, n_stages=spec.n_stages,
        devices=spec.device_counts[stage], device=str(device),
        schedule=spec.schedule,
    )
    # Metrics plane (when DCT_METRICS_DIR arms it): this stage's transfer
    # byte/latency histograms, published on a timer and at exit.
    publisher = None
    if cfg.obs.enabled and cfg.obs.metrics_dir:
        from dct_tpu_torch.observability.aggregate import SnapshotPublisher
        from dct_tpu_torch.observability.metrics import MetricsRegistry

        registry = MetricsRegistry()
        mpmd_transfer.arm_transfer_metrics(registry)
        publisher = SnapshotPublisher(
            registry, cfg.obs.metrics_dir,
            proc=f"mpmd-stage{stage}-{os.getpid()}",
            interval_s=cfg.obs.metrics_publish_s,
        )
    beat(epoch=start_epoch, phase="startup", force=True)
    links = {}
    first, last = stage == 0, stage == spec.n_stages - 1
    m = spec.n_microbatches

    def microbatches(batch):
        if first:
            return [torch.as_tensor(a, dtype=torch.float32).to(device)
                    for a in mpmd.split_microbatches(batch.x, m)]
        if last:
            return [(torch.as_tensor(y).to(device),
                     torch.as_tensor(w, dtype=torch.float32).to(device))
                    for y, w in zip(mpmd.split_microbatches(batch.y, m),
                                    mpmd.split_microbatches(batch.weight,
                                                            m))]
        return [None] * m

    def save(epoch_done: int) -> None:
        ckptr.save(state, mt.stage_meta(cfg, epoch_done, target_epochs,
                                        stage=stage))
        if first:
            mt.write_manifest(cfg.data.models_dir,
                              mt.manifest_of(cfg, spec, epoch_done))

    rc = 0
    try:
        links = mpmd_transfer.connect_stage_links(
            stage, spec.n_stages, port_base=spec.port_base,
            timeout=spec.transfer_timeout_s,
        )
        executor = mpmd.StageExecutor(
            stage, spec.n_stages, programs, channels=links,
            transfer_timeout_s=spec.transfer_timeout_s,
            place_in=lambda a: torch.as_tensor(a).to(device),
            device=device,
        )
        ops = mpmd.build_schedule(spec.n_stages, m, spec.schedule)[stage]
        for epoch in range(start_epoch, target_epochs):
            losses = []
            for step_i, batch in enumerate(train_loader.epoch(epoch)):
                # The same normalizer as MpmdRunner.train_step, so the two
                # deployments stay equal.
                total = mpmd.step_total(batch.y, batch.weight)
                state, rep, loss_sums = executor.run_step(
                    ops, state, microbatches(batch), total)
                if last and loss_sums:
                    losses.append(sum(float(s) for s, _ in loss_sums)
                                  / total)
                beat(step=step_i, epoch=epoch, phase="train")
            sums = np.zeros(6, np.float64)
            for batch in val_loader.epoch(epoch):
                out, _ = executor.run_eval(state, microbatches(batch))
                if last:
                    sums += np.asarray([float(v) for v in out])
            if last:
                events.emit(
                    "mpmd", "mpmd.step_report", epoch=epoch,
                    schedule=spec.schedule, n_stages=spec.n_stages,
                    n_microbatches=m, stages=[mpmd.stage_row(rep)],
                    train_loss=float(np.mean(losses)) if losses else None,
                    val_loss=float(sums[0] / max(sums[2], 1.0)),
                )
            save(epoch + 1)
            beat(epoch=epoch + 1, phase="checkpoint", force=True)
            if guard.requested:
                events.emit("mpmd", "mpmd.stage_done", stage=stage,
                            preempted=True, epochs_completed=epoch + 1)
                return EXIT_PREEMPTED
        events.emit("mpmd", "mpmd.stage_done", stage=stage,
                    preempted=False, epochs_completed=target_epochs)
    except mpmd.MpmdTransferTimeout as e:
        events.emit("mpmd", "mpmd.transfer_timeout", stage=stage,
                    error=str(e))
        print(f"[mpmd_worker s{stage}] {e}", file=sys.stderr, flush=True)
        rc = 1
    finally:
        mpmd_transfer.close_links(links)
        if publisher is not None:
            publisher.close(final=True)
            mpmd_transfer.disarm_transfer_metrics()
        beat(phase="exit", force=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
