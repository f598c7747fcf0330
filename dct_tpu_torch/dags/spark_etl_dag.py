"""DAG 1: ``spark_etl_pipeline`` — daily ETL, then trigger training
(counterpart of ``dags/spark_etl_dag.py``).

Same DAG id, @daily schedule, retries=1 with a 5-min delay, and the task
chain banner -> runtime healthcheck -> preprocess -> verify output ->
trigger ``pytorch_training_pipeline`` without waiting.

``DCT_ETL_ENGINE=spark`` keeps the ``docker exec spark-master
spark-submit`` path; the default runs the port's native ETL job
(``python3 -m dct_tpu_torch.preprocess_job``) in place. Host access is
templated so the same DAG drives compose containers or GPU hosts.
"""

from __future__ import annotations

import os
import sys
from datetime import datetime, timedelta

_REPO = os.environ.get(
    "DCT_REPO_ROOT",
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
)
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from dct_tpu_torch.launch.launcher import remote_command  # noqa: E402
from dct_tpu_torch.orchestration.compat import (  # noqa: E402
    DAG,
    BashOperator,
    TriggerDagRunOperator,
)


def _abs(p: str) -> str:
    """Anchor relative paths at the repo root: Airflow BashOperators run
    in a per-task temp cwd, so bare relative defaults would never resolve."""
    return p if os.path.isabs(p) else os.path.join(_REPO, p)


ENGINE = os.environ.get("DCT_ETL_ENGINE", "native")
SPARK_MASTER = os.environ.get("DCT_SPARK_MASTER_HOST", "spark-master")
EXEC = os.environ.get("DCT_EXEC_TEMPLATE", "docker exec {host} bash -c {cmd}")
RAW = _abs(os.environ.get("DCT_RAW_CSV", "data/raw/weather.csv"))
PROCESSED = _abs(os.environ.get("DCT_PROCESSED_DIR", "data/processed"))

default_args = {
    "owner": "dct-tpu",
    "retries": 1,
    "retry_delay": timedelta(minutes=5),
}

with DAG(
    dag_id="spark_etl_pipeline",
    default_args=default_args,
    description="Weather ETL: raw CSV -> normalized parquet handoff",
    schedule="@daily",
    start_date=datetime(2024, 1, 1),
    catchup=False,
    tags=["etl", "gpu-pipeline"],
) as dag:
    start = BashOperator(
        task_id="start_banner",
        bash_command="echo '=== ETL PIPELINE START ==='",
    )

    if ENGINE == "spark":
        health = BashOperator(
            task_id="check_spark_cluster",
            bash_command=remote_command(
                EXEC,
                SPARK_MASTER,
                "curl -sf http://localhost:8080 > /dev/null && echo 'Spark master healthy'",
            ),
        )
        preprocess = BashOperator(
            task_id="spark_preprocessing",
            bash_command=remote_command(
                EXEC,
                SPARK_MASTER,
                "spark-submit --master spark://spark-master:7077 "
                "--deploy-mode client --conf spark.executor.memory=1g "
                "/opt/spark/jobs/preprocess.py",
            ),
            execution_timeout=timedelta(minutes=30),
        )
    else:
        health = BashOperator(
            task_id="check_etl_runtime",
            # The port's ETL writes parquet with its own codec: numpy is
            # all it needs.
            bash_command=(
                f"python3 -c 'import numpy' && test -f {RAW} "
                "&& echo 'ETL runtime healthy'"
            ),
        )
        preprocess = BashOperator(
            task_id="native_preprocessing",
            bash_command=(
                f"cd {_REPO} && DCT_RAW_CSV={RAW} DCT_PROCESSED_DIR={PROCESSED} "
                "python3 -m dct_tpu_torch.preprocess_job"
            ),
            execution_timeout=timedelta(minutes=30),
        )

    verify = BashOperator(
        task_id="verify_output",
        bash_command=(
            f"test -d {PROCESSED}/data.parquet "
            f"&& echo 'Processed output present' || (echo 'ETL output missing'; exit 1)"
        ),
    )

    trigger_training = TriggerDagRunOperator(
        task_id="trigger_training_pipeline",
        trigger_dag_id="pytorch_training_pipeline",
        wait_for_completion=False,
    )

    start >> health >> preprocess >> verify >> trigger_training
