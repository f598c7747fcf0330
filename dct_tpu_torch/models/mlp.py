"""Dense layer with torch's default initialization (counterpart of
``dct_tpu/models/mlp.py``'s ``TorchStyleDense``).

The reference re-creates ``nn.Linear``'s default init in flax: weight and
bias both U(-1/sqrt(fan_in), 1/sqrt(fan_in)). Here that is ``nn.Linear``
itself. The one layout difference: a flax kernel is ``[in, out]``, an
``nn.Linear`` weight is ``[out, in]`` (:mod:`dct_tpu_torch.convert`
transposes). ``WeatherMLP`` is a later slice.

As in the flax layer (``dct_tpu/models/mlp.py:55-58``), the compute dtype
is apart from the parameter dtype: the forward casts x, the weight and the
bias to ``compute_dtype`` (x's own dtype when None). Parameters stay f32
masters in training; a bf16 package's parameters are bf16 already and the
casts are no-ops.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class TorchStyleDense(nn.Linear):
    """``nn.Linear(in_features, features)`` with torch's default init."""

    def __init__(self, in_features: int, features: int, *, device=None,
                 dtype=None, compute_dtype: torch.dtype | None = None):
        super().__init__(in_features, features, device=device, dtype=dtype)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype or x.dtype
        return F.linear(x.to(dtype), self.weight.to(dtype),
                        self.bias.to(dtype))
