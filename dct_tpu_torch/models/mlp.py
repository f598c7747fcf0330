"""The rain-classifier MLP and the layers the port's models share
(counterpart of ``dct_tpu/models/mlp.py``).

``TorchStyleDense`` is ``nn.Linear`` with torch's default init, which the
reference re-creates in flax (weight and bias U(-1/sqrt(fan_in),
1/sqrt(fan_in))). A flax kernel is ``[in, out]``, an ``nn.Linear`` weight
``[out, in]``; :mod:`dct_tpu_torch.convert` transposes. As in the flax
layer (``dct_tpu/models/mlp.py:55-58``) the forward casts x, the weight and
the bias to ``compute_dtype`` (x's own dtype when None): parameters stay
f32 masters in training.

``WeatherMLP`` is ``dct_tpu/models/mlp.py:62-77``: Dense(hidden) -> ReLU ->
Dropout -> Dense(classes), f32 logits, its layers named after the flax
param paths ``TorchStyleDense_0`` and ``TorchStyleDense_1``.

``Dropout`` is flax's ``nn.Dropout`` with the port's seeding: each mask
comes from a generator seeded by the caller's dropout key (the train
state's dropout seed and step, then layer and site), never from the
global generator. Under data parallelism a process holds a contiguous
block of each global batch; :func:`set_data_block` tells every dropout
layer of a model which, and the layer draws the mask of the whole global
batch and keeps its block's rows, so a W-process run draws the masks of
the 1-process run.
"""

from __future__ import annotations

import hashlib

import torch
import torch.nn.functional as F
from torch import nn


class TorchStyleDense(nn.Linear):
    """``nn.Linear(in_features, features)`` with torch's default init.

    Split over the model axis (:meth:`split_output`, :meth:`split_input`)
    it is a Megatron layer: column-parallel (this rank's block of the
    output features; the input enters through
    :func:`~dct_tpu_torch.parallel.mesh.copy_to_model`) or row-parallel
    (this rank's block of the input features; the partial products are
    summed over the model group, then the replicated bias is added once)."""

    def __init__(self, in_features: int, features: int, *, device=None,
                 dtype=None, compute_dtype: torch.dtype | None = None):
        super().__init__(in_features, features, device=device, dtype=dtype)
        self.compute_dtype = compute_dtype
        self.tp: tuple | None = None  # ("column" | "row", ModelShard)

    def split_output(self, shard) -> None:
        """Keep this rank's contiguous block of the output features."""
        n = self.out_features // shard.size
        rows = slice(shard.index * n, (shard.index + 1) * n)
        self.weight = nn.Parameter(self.weight.data[rows].clone())
        self.bias = nn.Parameter(self.bias.data[rows].clone())
        self.out_features, self.tp = n, ("column", shard)

    def split_input(self, shard) -> None:
        """Keep this rank's contiguous block of the input features."""
        n = self.in_features // shard.size
        cols = slice(shard.index * n, (shard.index + 1) * n)
        self.weight = nn.Parameter(self.weight.data[:, cols].clone())
        self.in_features, self.tp = n, ("row", shard)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype or x.dtype
        x, w, b = x.to(dtype), self.weight.to(dtype), self.bias.to(dtype)
        if self.tp is None:
            return F.linear(x, w, b)
        from dct_tpu_torch.parallel.mesh import (
            copy_to_model,
            reduce_from_model,
        )

        kind, shard = self.tp
        if kind == "column":
            return F.linear(copy_to_model(x, shard), w, b)
        return reduce_from_model(F.linear(x, w), shard) + b


def mask_seed(key: tuple) -> int:
    """A 63-bit generator seed from a tuple of ints (dropout seed, step,
    [microbatch,] layer, site): stable across processes and devices."""
    digest = hashlib.blake2b(repr(tuple(int(k) for k in key)).encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


class Dropout(nn.Module):
    """flax ``nn.Dropout``: keep with probability ``1 - rate``, kept values
    divided by ``1 - rate``; the identity in eval mode or at rate 0. The
    mask comes from ``key`` (see :func:`mask_seed`). ``block = (W, p)``:
    the input is block ``p`` of ``W`` equal row blocks of the global batch
    (see :func:`set_data_block`)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.block = (1, 0)
        self._gen: torch.Generator | None = None

    def forward(self, x: torch.Tensor, key: tuple | None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        if key is None:
            raise ValueError(
                "dropout in training mode needs a dropout_key (the train "
                "state's seed and step)"
            )
        if self._gen is None or self._gen.device != x.device:
            self._gen = torch.Generator(device=x.device)
        self._gen.manual_seed(mask_seed(key))
        n, p = self.block
        b = x.shape[0]
        draw = torch.rand((b * n, *x.shape[1:]), generator=self._gen,
                          device=x.device)
        keep = draw[p * b:(p + 1) * b] < (1.0 - self.rate)
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


def set_data_block(model: nn.Module, num_blocks: int, block: int) -> None:
    """Tell every :class:`Dropout` of ``model``, and every module that
    routes over the global batch (``takes_data_block``: the MoE layers),
    that its inputs are row block ``block`` of ``num_blocks`` of the
    global batch."""
    if not 0 <= block < num_blocks:
        raise ValueError(f"block {block} outside 0..{num_blocks - 1}")
    for mod in model.modules():
        if isinstance(mod, Dropout) or getattr(mod, "takes_data_block",
                                               False):
            mod.block = (int(num_blocks), int(block))


class WeatherMLP(nn.Module):
    """MLP rain classifier: ``[B, F]`` rows -> ``[B, num_classes]`` f32
    logits."""

    def __init__(self, input_dim: int, *, hidden_dim: int = 64,
                 num_classes: int = 2, dropout: float = 0.2, device=None,
                 dtype=torch.float32, compute_dtype=None):
        super().__init__()
        self.input_dim = input_dim
        self.compute_dtype = compute_dtype or dtype
        kw = {"device": device, "dtype": dtype,
              "compute_dtype": self.compute_dtype}
        self.TorchStyleDense_0 = TorchStyleDense(input_dim, hidden_dim, **kw)
        self.drop = Dropout(dropout)
        self.TorchStyleDense_1 = TorchStyleDense(hidden_dim, num_classes,
                                                 **kw)

    def forward(self, x: torch.Tensor,
                dropout_key: tuple | None = None) -> torch.Tensor:
        h = F.relu(self.TorchStyleDense_0(x.to(self.compute_dtype)))
        h = self.drop(h, None if dropout_key is None
                      else tuple(dropout_key) + (0,))
        return self.TorchStyleDense_1(h).float()
