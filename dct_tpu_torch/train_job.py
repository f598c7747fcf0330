"""The per-process training entry point (counterpart of
``jobs/train_tpu.py``).

    DCT_PROCESSED_DIR=<dir with data.parquet> DCT_MODELS_DIR=<dir> \\
        python -m dct_tpu_torch.train_job

Every process of a run starts this same command. Environment:
  WORLD_SIZE / NODE_RANK / MASTER_ADDR / MASTER_PORT (or DCT_NUM_PROCESSES,
  DCT_PROCESS_ID, DCT_COORDINATOR_ADDRESS)  the rendezvous: at a world
      size above 1 the processes join one ``torch.distributed`` group (NCCL
      on the cards, gloo on the CPU) and train data-parallel
  DCT_DEVICE  ``cpu`` to train on the CPU; by default process ``r`` trains
      on ``cuda:r``, and the job refuses to start without CUDA or when
      ``r`` has no card of its own (two ranks never share one)
  DCT_* training, model, data and tracking settings
      (:class:`dct_tpu_torch.config.RunConfig`)

Exit 0 only when training completed and, on the coordinator (rank 0), its
best checkpoint exists (the other ranks write no ``*.ckpt``); 1 when no
model file was produced; an exception (missing data, no CUDA) exits 1 with
its traceback.
"""

from __future__ import annotations

import os
import sys


def main() -> int:
    from dct_tpu_torch.config import RunConfig
    from dct_tpu_torch.device import resolve_device
    from dct_tpu_torch.parallel.distributed import initialize_from_env

    cfg = RunConfig.from_env()
    device = os.environ.get("DCT_DEVICE") or None
    if device is None:
        import torch

        n, rank = torch.cuda.device_count(), cfg.dist.process_id
        if n and rank >= n:
            raise RuntimeError(
                f"process {rank} has no card of its own: {n} CUDA "
                f"device(s) for {cfg.dist.num_processes} processes. Start "
                "one process per card, or set DCT_DEVICE.")
        device = f"cuda:{rank}" if n else "cuda"
    device = resolve_device(device)
    if device.type == "cuda":
        import torch

        torch.cuda.set_device(device)
    initialize_from_env(cfg.dist, device=device)
    try:
        return _train(cfg, device)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def _train(cfg, device) -> int:
    from dct_tpu_torch.parallel.distributed import process_index
    from dct_tpu_torch.train.trainer import Trainer

    print(f"[train_job] processes={cfg.dist.num_processes} "
          f"process_index={process_index()} device={device} "
          f"model={cfg.model.name}", flush=True)
    result = Trainer(cfg, device=device).fit()
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
