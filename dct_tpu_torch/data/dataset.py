"""Processed-dataset loading (counterpart of ``dct_tpu/data/dataset.py``).

The ETL writes a parquet file or directory ``data.parquet`` into the
processed dir; loading hard-fails with the reference's messages when it is
missing, when no ``_norm`` feature column exists, or when the label column
is absent. Features load as float32, labels as int32. The parquet is read
by the port's own codec (:mod:`dct_tpu_torch.etl.parquet`), which reads
both what the port's ETL writes and what the reference's pyarrow writes.
Gathers are numpy indexing (the reference's native C++ data plane is
ROADMAP Queue A item 25).
"""

from __future__ import annotations

import os
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

    def take(self, indices: np.ndarray) -> np.ndarray:
        """Gather feature rows: [*indices.shape, F] float32."""
        return np.ascontiguousarray(
            self.features[np.asarray(indices)], dtype=np.float32
        )


def load_processed_dataset(
    processed_dir: str,
    *,
    feature_suffix: str = "_norm",
    label_column: str = "label_encoded",
    parquet_name: str = "data.parquet",
) -> WeatherArrays:
    """Load the ETL output (a parquet file or a Spark-style directory of
    part files) into host arrays; feature columns are the ones ending in
    ``feature_suffix``, in file order."""
    parquet_path = os.path.join(processed_dir, parquet_name)
    if not os.path.exists(parquet_path):
        raise FileNotFoundError(
            f"CRITICAL ERROR: Data not found at {parquet_path}. "
            "Did the preprocessing step finish successfully?"
        )

    from dct_tpu_torch.etl import parquet

    try:
        table = parquet.read_table(parquet_path)
    except (OSError, parquet.ParquetError) as e:
        raise RuntimeError(f"Failed to read Parquet file: {e}") from e

    names = list(table)
    feature_cols = [c for c in names if c.endswith(feature_suffix)]
    if not feature_cols:
        raise ValueError(
            f"CRITICAL ERROR: No columns ending with '{feature_suffix}' found. "
            "Check the preprocessing logic."
        )
    if label_column not in names:
        raise ValueError(
            f"CRITICAL ERROR: Label column '{label_column}' not found in "
            f"columns {names}."
        )
    feats = np.stack([table[c] for c in feature_cols], axis=1).astype(
        np.float32)
    labels = table[label_column].astype(np.int32)
    return WeatherArrays(features=feats, labels=labels,
                         feature_names=feature_cols)


# Snapshot-keyed load cache: an evaluator that re-reads the same processed
# snapshot gets the same arrays back. Keyed by the part files' (name,
# mtime_ns, size), so a new delta part or a rebuilt snapshot misses.
_LOAD_CACHE: dict[tuple, tuple[tuple, WeatherArrays]] = {}
_LOAD_CACHE_SLOTS = 4


def _snapshot_key(parquet_path: str) -> tuple | None:
    """Stat-derived identity of a parquet file or directory; None when it
    cannot be stat'd (the caller falls through to the loud loader)."""
    try:
        if os.path.isdir(parquet_path):
            entries = []
            for name in sorted(os.listdir(parquet_path)):
                if not name.endswith(".parquet"):
                    continue
                st = os.stat(os.path.join(parquet_path, name))
                entries.append((name, st.st_mtime_ns, st.st_size))
            return tuple(entries) or None
        st = os.stat(parquet_path)
        return ((os.path.basename(parquet_path), st.st_mtime_ns, st.st_size),)
    except OSError:
        return None


def load_processed_dataset_cached(
    processed_dir: str,
    *,
    feature_suffix: str = "_norm",
    label_column: str = "label_encoded",
    parquet_name: str = "data.parquet",
) -> WeatherArrays:
    """:func:`load_processed_dataset` behind the snapshot-keyed cache:
    the same :class:`WeatherArrays` object for an unchanged snapshot
    (treat it as immutable); at most ``_LOAD_CACHE_SLOTS`` snapshots,
    the oldest inserted evicted first."""
    cache_id = (os.path.abspath(processed_dir), feature_suffix, label_column,
                parquet_name)
    key = _snapshot_key(os.path.join(processed_dir, parquet_name))
    if key is not None:
        hit = _LOAD_CACHE.get(cache_id)
        if hit is not None and hit[0] == key:
            return hit[1]
    data = load_processed_dataset(
        processed_dir, feature_suffix=feature_suffix,
        label_column=label_column, parquet_name=parquet_name,
    )
    if key is not None:
        _LOAD_CACHE[cache_id] = (key, data)
        while len(_LOAD_CACHE) > _LOAD_CACHE_SLOTS:
            _LOAD_CACHE.pop(next(iter(_LOAD_CACHE)))
    return data
