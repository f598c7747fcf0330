"""The data axis of the reference's device mesh, on ``torch.distributed``
(counterpart of ``dct_tpu/parallel/mesh.py:134-226``; the model, sequence
and pipeline axes wait for ROADMAP Queue A items 15-17).

One process drives one device, so the data axis is the process group:
process ``p`` of ``W`` takes block ``p`` of every global batch
(:func:`process_data_block`). The reference's step is one program over
the global batch, whose gradient all-reduce XLA inserts; here each process
divides its block's weighted loss sum by the global row count and
:func:`all_reduce_sum` adds the gradients and the losses over the
processes in one flat buffer (:mod:`dct_tpu_torch.train.steps`). That is
the reference's global weighted mean, the zero-weight padding of the last
batch included, which a mean of per-process means is not.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from dct_tpu_torch.parallel.distributed import process_count, process_index


def process_data_block() -> tuple[int, int]:
    """``(num_blocks, my_block)`` of each global batch: pure data
    parallelism, one block per process."""
    return process_count(), process_index()


def data_parallel() -> bool:
    """Whether gradients and metrics are reduced over processes."""
    return process_count() > 1


def all_reduce_sum(tensors) -> list[torch.Tensor]:
    """The elementwise sums of ``tensors`` over all processes, through one
    f32 all-reduce of a flat buffer; the tensors themselves come back
    (as f32 values in their own dtypes) when there is one process."""
    tensors = list(tensors)
    if not data_parallel():
        return tensors
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    out, i = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[i:i + n].view(t.shape).to(t.dtype))
        i += n
    return out


def all_gather_ints(value: int) -> list[int]:
    """``value`` of every process, in rank order."""
    if not data_parallel():
        return [int(value)]
    out = [None] * process_count()
    dist.all_gather_object(out, int(value))
    return [int(v) for v in out]


def all_gather_rows(tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` of every process stacked in rank order, ``[W, ...]``
    (on its own device: NCCL for CUDA tensors, gloo on the CPU); with one
    process, ``tensor[None]``. Carries no gradient."""
    tensor = tensor.detach()
    if not data_parallel():
        return tensor[None]
    out = [torch.empty_like(tensor) for _ in range(process_count())]
    dist.all_gather(out, tensor.contiguous())
    return torch.stack(out)
