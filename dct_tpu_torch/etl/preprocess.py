"""The incremental-ETL state file, as the trainer reads it (counterpart of
``read_etl_state`` in ``dct_tpu/etl/preprocess.py:205``; the ETL that
writes it is ROADMAP Queue A item 22)."""

from __future__ import annotations

import json
import os

ETL_STATE_VERSION = 1
ETL_STATE_NAME = "etl_state.json"


def read_etl_state(output_dir: str) -> dict:
    """The ETL state snapshot of ``output_dir`` ({} when absent, torn or
    of another version): the data generation and arrival time the trainer
    stamps into its checkpoints' meta. Read before the parquet, so a
    stamped generation never claims rows published after the snapshot."""
    path = os.path.join(output_dir, ETL_STATE_NAME)
    try:
        with open(path) as f:
            state = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(state, dict) or state.get("version") != ETL_STATE_VERSION:
        return {}
    return state
