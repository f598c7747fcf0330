"""The per-process training entry point (counterpart of
``jobs/train_tpu.py``).

    DCT_PROCESSED_DIR=<dir with data.parquet> DCT_MODELS_DIR=<dir> \\
        python -m dct_tpu_torch.train_job

Every process of a run starts this same command, by hand or under the
supervisor (``python -m dct_tpu_torch.resilience.supervise -- python -m
dct_tpu_torch.train_job``). Environment:
  WORLD_SIZE / NODE_RANK / MASTER_ADDR / MASTER_PORT (or DCT_NUM_PROCESSES,
  DCT_PROCESS_ID, DCT_COORDINATOR_ADDRESS)  the rendezvous: at a world
      size above 1 the processes join one ``torch.distributed`` group (NCCL
      on the cards, gloo on the CPU) and train data-parallel
  DCT_DEVICE  ``cpu`` to train on the CPU; by default process ``r`` trains
      on ``cuda:r``, and the job refuses to start without CUDA or when
      ``r`` has no card of its own (two ranks never share one)
  DCT_RUN_ID  the run-correlation ID (the launcher mints it; an unlaunched
      run mints its own), logged first
  DCT_MESH_DATA / DCT_MESH_MODEL / DCT_MESH_SEQ  the process grid
      (``data=-1`` absorbs every process; WORLD_SIZE must equal data x
      model x seq): the model axis runs the transformers tensor-parallel
      and the MoE expert-parallel; the seq axis runs the two transformer
      families and the MoE sequence-parallel (``DCT_SP_ENGINE`` ring or
      a2a, ``DCT_RING_STRIPED``), the MoE routing over data x seq, and
      replicates the MLP and the GRU over it; ZeRO-1 and FSDP split over
      ``data`` and replicate over ``seq``; ``DCT_RESUME=1`` resumes a
      shard-saved state on another grid or process count (re-mapped
      from the sibling ranks' files)
  DCT_SHARD_OPT_STATE / DCT_SHARD_PARAMS / DCT_SHARD_RULES  ZeRO-1, FSDP
      and the partition-rule overrides
      (:mod:`dct_tpu_torch.parallel.sharding_rules`)
  DCT_* training, model, data, tracking, observability and resilience
      settings (:class:`dct_tpu_torch.config.RunConfig`); the pipeline
      axis and the stream ingest are refused with the ROADMAP item that
      ports them

Prints ``[train_job] launches {...}``, this process's flash-kernel launch
counts, when training ends (done, preempted or halted), so a supervisor's
caller can count launches across the process boundary, and at the end of
a completed fit ``[train_job] fit {...}``: the val_loss, samples/s (all
epochs, and the epochs after the first), the epoch seconds, the mesh, this
process's parameter and optimizer-state bytes, the most gathered
parameter bytes it held at once (``gathered_peak_bytes``, beside its
largest unit's, all its units' together and its small units' held for the
step), its attention's local heads
and, on a card, its peak allocated bytes.

Exit 0 only when training completed and, on the coordinator (rank 0), its
best checkpoint exists (the other ranks write no ``*.ckpt``); 75
(``EXIT_PREEMPTED``) when a SIGTERM was honored with a durable resume
checkpoint; 76 (``EXIT_HEALTH_HALT``) when a halting health policy stopped
the run; 1 when no model file was produced; an exception (missing data, no
CUDA) exits 1 with its traceback. A ``crash`` fault exits 117.
"""

from __future__ import annotations

import json
import os
import sys

#: (environment variable, what the port does not have yet, the ROADMAP
#: Queue A item that ports it).
_UNPORTED = (
    ("DCT_MESH_PIPE", "a pipeline axis", 17),
)


def refuse_unported_env(env=None) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item when the
    environment asks for a pipeline axis or the stream ingest, neither of
    which the port has."""
    env = os.environ if env is None else env
    for var, what, item in _UNPORTED:
        raw = (env.get(var) or "").strip()
        if raw and int(raw) > 1:
            raise NotImplementedError(
                f"{var}={raw} asks for {what}; the port has the data, "
                f"model and seq axes only: ROADMAP Queue A item {item}")
    mode = (env.get("DCT_INGEST_MODE") or "poll").strip().lower()
    if mode != "poll":
        raise NotImplementedError(
            f"DCT_INGEST_MODE={mode}: the stream ingest is not ported: "
            "ROADMAP Queue A item 24")


def main() -> int:
    from dct_tpu_torch.config import RunConfig
    from dct_tpu_torch.device import process_device
    from dct_tpu_torch.observability.events import current_run_id
    from dct_tpu_torch.parallel.distributed import initialize_from_env

    refuse_unported_env()
    cfg = RunConfig.from_env()
    # Logged first, so one grep leads from this log into the event log.
    run_id = cfg.obs.run_id or current_run_id()
    cfg.obs.run_id = run_id
    print(f"[train_job] run_id={run_id}", flush=True)
    device = process_device(cfg.dist.process_id, cfg.dist.num_processes,
                            os.environ.get("DCT_DEVICE") or None)
    if device.type == "cuda":
        import torch

        free, total = torch.cuda.mem_get_info(device)
        print(f"[train_job] {device}: {free / 2**30:.2f} of "
              f"{total / 2**30:.2f} GiB free at start", flush=True)
    initialize_from_env(cfg.dist, device=device)
    try:
        return _train(cfg, device)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def _train(cfg, device) -> int:
    from dct_tpu_torch.observability.health import TrainingHealthError
    from dct_tpu_torch.ops import flash_attention
    from dct_tpu_torch.parallel.distributed import process_index
    from dct_tpu_torch.resilience.preempt import PreemptedError
    from dct_tpu_torch.resilience.supervisor import (
        EXIT_HEALTH_HALT,
        EXIT_PREEMPTED,
    )
    from dct_tpu_torch.train.trainer import Trainer

    print(f"[train_job] processes={cfg.dist.num_processes} "
          f"process_index={process_index()} device={device} "
          f"model={cfg.model.name}", flush=True)
    try:
        result = Trainer(cfg, device=device).fit()
    except PreemptedError as e:
        # Resumable, not failed: the supervisor relaunches with
        # DCT_RESUME=1 and consumes no restart budget.
        print(f"[train_job] preempted: {e}", file=sys.stderr, flush=True)
        return EXIT_PREEMPTED
    except TrainingHealthError as e:
        # Deterministic: a relaunch from the same checkpoint re-diverges,
        # so the supervisor gives up.
        print(f"[train_job] training-health halt: {e}", file=sys.stderr,
              flush=True)
        return EXIT_HEALTH_HALT
    finally:
        print(f"[train_job] launches "
              f"{json.dumps(flash_attention.launch_counts())}", flush=True)
    fit = {"val_loss": result.val_loss,
           "samples_per_sec": result.samples_per_sec,
           "steady_samples_per_sec": result.steady_samples_per_sec,
           "epoch_seconds": result.epoch_seconds, **result.layout}
    if device.type == "cuda":
        import torch

        fit["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    print(f"[train_job] fit {json.dumps(fit)}", flush=True)
    print(f"[train_job] done: val_loss={result.val_loss:.4f} "
          f"val_acc={result.val_acc:.4f} "
          f"samples/sec={result.samples_per_sec:.1f} "
          f"best={result.best_model_path}", flush=True)
    if process_index() == 0 and not (
            result.best_model_path
            and os.path.exists(result.best_model_path)):
        print("[train_job] CRITICAL: no model file produced",
              file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
