"""Multi-process rendezvous on ``torch.distributed`` (counterpart of
``dct_tpu/parallel/distributed.py``).

The same environment contract as the reference (``MASTER_ADDR``,
``MASTER_PORT``, ``NODE_RANK``, ``WORLD_SIZE``, or their ``DCT_*`` names,
:class:`~dct_tpu_torch.config.DistributedConfig`): at a world size above 1
:func:`initialize_from_env` joins the process group over a TCP store at
the coordinator's address, with NCCL for a CUDA device and gloo on the
CPU. At world size 1 it does nothing, and the helpers below answer for a
single process.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from dct_tpu_torch.config import DistributedConfig


def initialize_from_env(cfg: DistributedConfig | None = None, *,
                        device: str | torch.device = "cuda"
                        ) -> DistributedConfig:
    """Join the process group when the world size is above 1 (a no-op
    otherwise, and when this process has joined already). ``device``
    picks the backend: NCCL for CUDA, gloo for the CPU."""
    cfg = cfg or DistributedConfig.from_env()
    if cfg.num_processes <= 1 or dist.is_initialized():
        return cfg
    if cfg.coordinator_address is None:
        raise ValueError(
            "WORLD_SIZE > 1 but no coordinator address: set MASTER_ADDR "
            "(+ MASTER_PORT) or DCT_COORDINATOR_ADDRESS"
        )
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{cfg.coordinator_address}",
        world_size=cfg.num_processes, rank=cfg.process_id,
    )
    return cfg


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    """The rank-0 gate for side effects (deploy checkpoints, tracking)."""
    return process_index() == 0
