"""ETL entry point: ``python -m dct_tpu_torch.preprocess_job`` (counterpart
of ``jobs/preprocess.py``).

Reads ``DCT_RAW_CSV`` (default ``data/raw/weather.csv``) and writes the
normalized parquet directory, stats and drift report under
``DCT_PROCESSED_DIR`` (default ``data/processed``). ``DCT_ETL_ENGINE``:
``auto`` (the default) runs the Spark job when ``pyspark`` imports and the
native transform otherwise; ``native`` always runs the native transform;
``spark`` runs the Spark job, and raises when ``pyspark`` is absent. The
native transform is incremental unless ``DCT_ETL_INCREMENTAL=0``. Exit 0
on success; a missing input raises ``FileNotFoundError``.
"""

from __future__ import annotations

import importlib.util
import os
import sys


def main() -> int:
    input_csv = os.environ.get("DCT_RAW_CSV", "data/raw/weather.csv")
    output_dir = os.environ.get("DCT_PROCESSED_DIR", "data/processed")
    engine = os.environ.get("DCT_ETL_ENGINE", "auto")

    print("=" * 80)
    print("Step 1: Weather Data Preprocessing (dct_tpu_torch)")
    print("=" * 80)

    spark = importlib.util.find_spec("pyspark") is not None
    if engine == "spark" or (engine == "auto" and spark):
        from dct_tpu_torch.etl.spark_job import preprocess_with_spark

        out = preprocess_with_spark(input_csv, output_dir)
    else:
        from dct_tpu_torch.etl.preprocess import preprocess_csv_to_parquet

        out = preprocess_csv_to_parquet(input_csv, output_dir)

    print(f"✓ Preprocessing complete: {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
