"""Dense layer with torch's default initialization (counterpart of
``dct_tpu/models/mlp.py``'s ``TorchStyleDense``).

The reference re-creates ``nn.Linear``'s default init in flax: weight and
bias both U(-1/sqrt(fan_in), 1/sqrt(fan_in)). Here that is ``nn.Linear``
itself. The one layout difference: a flax kernel is ``[in, out]``, an
``nn.Linear`` weight is ``[out, in]`` (:mod:`dct_tpu_torch.convert`
transposes). ``WeatherMLP`` is a later slice.
"""

from __future__ import annotations

from torch import nn


class TorchStyleDense(nn.Linear):
    """``nn.Linear(in_features, features)`` with torch's default init."""

    def __init__(self, in_features: int, features: int, *, device=None,
                 dtype=None):
        super().__init__(in_features, features, device=device, dtype=dtype)
