"""Sliding-window view over the row stream for the sequence families
(counterpart of ``dct_tpu/data/windows.py:30-121``).

Window ``i`` is rows ``[i, i+seq_len)``; its label is row ``i+seq_len``'s
label, or with ``per_position_labels`` row ``i+t+1``'s label at every
position ``t`` (and ``[.., horizon]`` of them with ``horizon > 1``).
Construction is a zero-copy ``sliding_window_view``; :meth:`WindowArrays.take`
gathers windows with numpy indexing (the reference's native gather is the
same copy).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view


@dataclass
class WindowArrays:
    """Windowed host arrays; drop-in for :class:`WeatherArrays` downstream."""

    features: np.ndarray  # [N, S, F] float32 (a strided view)
    labels: np.ndarray  # [N], [N, S] or [N, S, H] int32
    feature_names: list[str]
    seq_len: int

    def __len__(self) -> int:
        return int(self.features.shape[0])

    @property
    def input_dim(self) -> int:
        return int(self.features.shape[2])

    def take(self, indices: np.ndarray) -> np.ndarray:
        """Gather windows: [*indices.shape, S, F] float32."""
        return np.ascontiguousarray(self.features[np.asarray(indices)])


def make_windows(data, seq_len: int, *, per_position_labels: bool = False,
                 horizon: int = 1) -> WindowArrays:
    """[N, F] rows -> [N_w, seq_len, F] windows with next-step labels;
    ``N_w = N - seq_len - horizon + 1``. ``data`` has ``features`` [N, F],
    ``labels`` [N] and ``feature_names``."""
    n = len(data.features)
    if seq_len < 1:
        raise ValueError(f"seq_len must be >= 1, got {seq_len}")
    if horizon < 1:
        raise ValueError(f"horizon must be >= 1, got {horizon}")
    if horizon > 1 and not per_position_labels:
        raise ValueError(
            "horizon > 1 requires per_position_labels=True (the causal "
            "family's training signal)"
        )
    n_w = n - seq_len - horizon + 1
    if n_w < 1:
        raise ValueError(
            f"Need more than seq_len+horizon-1={seq_len + horizon - 1} "
            f"rows to build windows; dataset has {n}."
        )
    base = np.ascontiguousarray(data.features, dtype=np.float32)
    windows = np.moveaxis(sliding_window_view(base, seq_len, axis=0), -1, 1)
    lab = np.asarray(data.labels).astype(np.int32)
    if per_position_labels and horizon > 1:
        # (i, t, h) = label of row i+t+1+h.
        lh = sliding_window_view(lab, horizon)  # [N-H+1, H]
        labels = np.ascontiguousarray(
            sliding_window_view(lh, seq_len, axis=0)[1 : 1 + n_w]
            .transpose(0, 2, 1)
        )
    elif per_position_labels:
        # Row i, column t = label of row i+t+1.
        labels = np.ascontiguousarray(
            sliding_window_view(lab[1:], seq_len, axis=0)[:n_w]
        )
    else:
        labels = lab[seq_len:]
    return WindowArrays(
        features=windows[:n_w], labels=labels,
        feature_names=list(data.feature_names), seq_len=int(seq_len),
    )
