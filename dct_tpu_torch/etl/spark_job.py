"""Spark variant of the ETL transform (import-gated; cluster-side only;
a copy of ``dct_tpu/etl/spark_job.py``).

Same semantics as :mod:`dct_tpu_torch.etl.preprocess` and as the reference job
(jobs/preprocess.py:18-51): header+inferSchema CSV read, ``Rain=="rain"->1``
label encoding, per-column mean/sample-stddev z-score with zero-std guard,
output restricted to ``[*_norm, label_encoded]`` written overwrite-mode to
``<out>/data.parquet``. Used when the platform runs the real Spark cluster
(docker-compose topology, SURVEY §2.1); tests cover the native path and the
transform parity between the two.
"""

from __future__ import annotations

import os

from dct_tpu_torch.etl.preprocess import (
    DEFAULT_FEATURES,
    persist_stats_and_drift,
    read_previous_stats,
)


def preprocess_with_spark(
    input_csv: str,
    output_dir: str,
    *,
    feature_cols: list[str] | None = None,
    label_col: str = "Rain",
    positive_label: str = "rain",
    parquet_name: str = "data.parquet",
) -> str:
    from pyspark.sql import SparkSession
    from pyspark.sql.functions import col, count, mean, stddev, when

    feature_cols = feature_cols or DEFAULT_FEATURES
    spark = SparkSession.builder.appName("WeatherPreprocessingTPU").getOrCreate()
    try:
        df = spark.read.csv(input_csv, header=True, inferSchema=True)
        df = df.withColumn(
            "label_encoded", when(col(label_col) == positive_label, 1).otherwise(0)
        )
        # ONE aggregation pass for every statistic (row count, label
        # rate, per-feature mean/stddev) instead of 2 + N actions over
        # the un-cached DataFrame.
        aggs = [count("*").alias("__rows"), mean(col("label_encoded")).alias("__rate")]
        for name in feature_cols:
            aggs.append(mean(col(name)).alias(f"__m_{name}"))
            aggs.append(stddev(col(name)).alias(f"__s_{name}"))
        row = df.select(*aggs).first()

        def _stat(v):
            # Spark returns None for all-null columns: record NaN (like
            # the native path) so detect_drift's non-finite branch flags
            # the broken data instead of seeing a fabricated clean 0.0.
            return float(v) if v is not None else float("nan")

        run_stats: dict = {
            "rows": int(row["__rows"]),
            "label_rate": _stat(row["__rate"]),
            "features": {},
        }
        for name in feature_cols:
            m, s = row[f"__m_{name}"], row[f"__s_{name}"]
            run_stats["features"][name] = {"mean": _stat(m), "std": _stat(s)}
            std_val = s if s else 1.0
            df = df.withColumn(
                f"{name}_norm", (col(name) - (m or 0.0)) / std_val
            )
        final_cols = [f"{c}_norm" for c in feature_cols] + ["label_encoded"]
        # Baseline read BEFORE the overwrite, like the native path.
        prev_stats = read_previous_stats(output_dir)
        out_path = os.path.join(output_dir, parquet_name)
        df.select(final_cols).write.mode("overwrite").parquet(out_path)
        # Same drift machinery as the native engine (driver-side write:
        # output_dir is the shared ./data volume in the compose topology).
        persist_stats_and_drift(output_dir, run_stats, prev_stats)
        return out_path
    finally:
        spark.stop()
