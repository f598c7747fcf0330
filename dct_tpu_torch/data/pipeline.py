"""Deterministic splits and fixed-shape batching (counterpart of
``dct_tpu/data/pipeline.py``).

Batches have a fixed shape: the last one is padded by wrapping and its
padding rows carry weight 0, so a weighted mean over a batch is the mean
over its real rows. A process takes a contiguous block of every global
batch. Indices, order and weights are the reference's; gathers are numpy
indexing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


def train_val_split(n: int, *, val_fraction: float = 0.2,
                    seed: int = 42) -> tuple[np.ndarray, np.ndarray]:
    """Seeded permutation split; train gets ``int((1-val_fraction)*n)``."""
    train_size = int((1.0 - val_fraction) * n)
    perm = np.random.default_rng(seed).permutation(n)
    return perm[:train_size], perm[train_size:]


def contiguous_split(n: int, *, val_fraction: float = 0.2,
                     gap: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Time-ordered split for overlapping windows: train is the leading
    block, val the trailing block, ``gap`` indices dropped between them
    (``gap >= seq_len`` keeps val windows off every train window's rows)."""
    train_size = int((1.0 - val_fraction) * n)
    val_start = min(n, train_size + gap)
    return np.arange(train_size), np.arange(val_start, n)


@dataclass
class Batch:
    """One fixed-shape batch (this process's block of a global batch);
    ``weight`` is 1 for real rows and 0 for padding."""

    x: np.ndarray  # [B_local, ...] float32
    y: np.ndarray  # [B_local, ...] int32
    weight: np.ndarray  # [B_local] float32


class BatchLoader:
    """Fixed-shape, process-sharded batch stream over host arrays.

    ``global_batch`` spans all processes; :meth:`epoch` and
    :meth:`epoch_stacked` give this process's contiguous block
    ``[p*B_local, (p+1)*B_local)`` of every (optionally shuffled,
    wrap-padded) global batch, ``B_local = global_batch // num_processes``.
    Concatenating the W blocks gives the 1-process batch in its row order,
    and every process sees the same number of batches."""

    def __init__(self, data, indices: np.ndarray, *, global_batch: int,
                 shuffle: bool, seed: int = 42, num_processes: int = 1,
                 process_id: int = 0):
        if global_batch % num_processes != 0:
            raise ValueError(
                f"global_batch {global_batch} not divisible by "
                f"num_processes {num_processes}"
            )
        self.data = data
        self.indices = np.asarray(indices)
        self.global_batch = int(global_batch)
        self.local_batch = self.global_batch // num_processes
        self.shuffle = shuffle
        self.seed = seed
        self.num_processes = num_processes
        self.process_id = process_id

    @property
    def num_batches(self) -> int:
        n = len(self.indices)
        return max(1, -(-n // self.global_batch)) if n else 0

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = self.indices
        if self.shuffle:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch])
            )
            idx = idx[rng.permutation(len(idx))]
        return idx

    def epoch_stacked(self, epoch: int):
        """The whole epoch as ``(xs [S, B_local, ...], ys [S, B_local,
        ...], ws [S, B_local])``; padding rows have weight 0."""
        idx = self._epoch_indices(epoch)
        n = len(idx)
        lb, gb = self.local_batch, self.global_batch
        if n == 0:
            return (
                np.zeros((0, lb, *self.data.features.shape[1:]), np.float32),
                np.zeros((0, lb, *self.data.labels.shape[1:]), np.int32),
                np.zeros((0, lb), np.float32),
            )
        steps = -(-n // gb)
        padded = np.resize(idx, steps * gb)  # wrap-pad
        weights = np.zeros(steps * gb, np.float32)
        weights[:n] = 1.0
        block = slice(self.process_id * lb, (self.process_id + 1) * lb)
        mat = padded.reshape(steps, gb)[:, block]
        return (
            self.data.take(mat),
            np.asarray(self.data.labels)[mat].astype(np.int32),
            weights.reshape(steps, gb)[:, block],
        )

    def epoch(self, epoch: int) -> Iterator[Batch]:
        """The epoch batch by batch, with the indices and weights of
        :meth:`epoch_stacked`."""
        idx = self._epoch_indices(epoch)
        n = len(idx)
        lb, gb = self.local_batch, self.global_batch
        block = slice(self.process_id * lb, (self.process_id + 1) * lb)
        for start in range(0, n, gb):
            chunk = idx[start:start + gb]
            real = len(chunk)
            if real < gb:  # pad by wrapping; padded rows get weight 0
                chunk = np.concatenate([chunk, np.resize(idx, gb - real)])
            weight = np.zeros(gb, np.float32)
            weight[:real] = 1.0
            rows = chunk[block]
            yield Batch(
                x=self.data.take(rows),
                y=np.asarray(self.data.labels)[rows].astype(np.int32),
                weight=weight[block],
            )
