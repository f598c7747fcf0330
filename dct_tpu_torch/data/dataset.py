"""Host arrays of the processed row stream (counterpart of the
``WeatherArrays`` container of ``dct_tpu/data/dataset.py``; reading the
processed parquet is a later slice)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class WeatherArrays:
    """Row arrays for the whole dataset."""

    features: np.ndarray  # [N, F] float32
    labels: np.ndarray  # [N] int32
    feature_names: list[str]

    def __len__(self) -> int:
        return int(self.features.shape[0])

    @property
    def input_dim(self) -> int:
        return int(self.features.shape[1])
