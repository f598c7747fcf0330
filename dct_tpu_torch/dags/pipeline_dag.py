"""DAG 3: ``distributed_data_pipeline`` — the monolithic ETL+training DAG
(counterpart of ``dags/pipeline_dag.py``).

Same DAG id: one @daily graph that supersets DAGs 1+2 — ETL, output verify
with size report, per-host runtime version check, data-visibility check,
the launch, model verify, logs check (warn-only), summary report,
retention cleanup, end banner, deploy trigger — with commands that run the
port (``python3 -m dct_tpu_torch.preprocess_job``, ``train_job`` under the
supervisor). The launch scripts in script mode are the port's builders,
byte-equal to the reference's for the same arguments.
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

from dct_tpu_torch.launch.launcher import (  # noqa: E402
    build_healthcheck_script,
    build_spmd_launch_script,
    build_zombie_cleanup_script,
)
from dct_tpu_torch.orchestration.compat import (  # noqa: E402
    DAG,
    BashOperator,
    PythonOperator,
    TriggerDagRunOperator,
)


def _abs(p: str) -> str:
    """Anchor relative paths at the repo root: Airflow BashOperators run
    in a per-task temp cwd, so bare relative defaults would never resolve."""
    return p if os.path.isabs(p) else os.path.join(_REPO, p)


HOSTS = os.environ.get("DCT_TRAIN_HOSTS", "local").split(",")
EXEC = os.environ.get("DCT_EXEC_TEMPLATE", "ssh {host} {cmd}")
TRAIN_CMD = os.environ.get(
    "DCT_TRAIN_COMMAND",
    f"env PYTHONPATH={_REPO} python3 -m dct_tpu_torch.train_job",
)
# Continuous training: resume the optimizer trajectory each run (see
# training_dag.py).
RESUME = os.environ.get("DCT_RESUME", "1")
# Supervised relaunch-and-resume budget (see training_dag.py). 0 = bare
# launch.
MAX_RESTARTS = os.environ.get("DCT_MAX_RESTARTS", "2")
RAW = _abs(os.environ.get("DCT_RAW_CSV", "data/raw/weather.csv"))
PROCESSED = _abs(os.environ.get("DCT_PROCESSED_DIR", "data/processed"))
MODELS_DIR = _abs(os.environ.get("DCT_MODELS_DIR", "data/models"))
KEEP_CHECKPOINTS = int(os.environ.get("DCT_KEEP_CHECKPOINTS", "3"))
LOCAL_MODE = HOSTS == ["local"]

default_args = {
    "owner": "dct-tpu",
    "retries": 1,
    "retry_delay": timedelta(minutes=5),
}


def print_training_summary(**context):
    """Run-metadata report. (The reference wraps it in a ``dag.*`` span;
    the port's DAG-side spans are ROADMAP Queue A item 27.)"""
    print("=" * 80)
    print("DISTRIBUTED PIPELINE SUMMARY")
    print(f"  execution date: {context.get('ds', 'n/a')}")
    print(f"  run id:         {context.get('run_id', 'n/a')}")
    print(f"  hosts:          {HOSTS}")
    print(f"  models dir:     {MODELS_DIR}")
    print("=" * 80)
    return "summary-complete"


with DAG(
    dag_id="distributed_data_pipeline",
    default_args=default_args,
    description="Full ETL -> GPU training -> verification pipeline",
    schedule="@daily",
    start_date=datetime(2024, 1, 1),
    catchup=False,
    tags=["etl", "training", "gpu-pipeline"],
) as dag:
    start = BashOperator(
        task_id="start_banner",
        bash_command="echo '=== DISTRIBUTED DATA PIPELINE START ==='",
    )
    etl = BashOperator(
        task_id="run_preprocessing",
        bash_command=(
            f"cd {_REPO} && DCT_RAW_CSV={RAW} DCT_PROCESSED_DIR={PROCESSED} "
            "python3 -m dct_tpu_torch.preprocess_job"
        ),
        execution_timeout=timedelta(minutes=30),
    )
    verify_etl = BashOperator(
        task_id="verify_processed_output",
        bash_command=(
            f"test -d {PROCESSED}/data.parquet && ls {PROCESSED}/data.parquet "
            f"&& du -sh {PROCESSED}/data.parquet || (echo 'ETL output missing'; exit 1)"
        ),
    )
    if LOCAL_MODE:
        check_versions = BashOperator(
            task_id="check_runtime_versions",
            bash_command=(
                "python3 -c 'import torch, numpy; "
                "print(f\"torch={torch.__version__} cuda={torch.version.cuda} "
                "numpy={numpy.__version__} devices={torch.cuda.device_count()}\")'"
            ),
        )
        check_data_visible = BashOperator(
            task_id="check_data_visibility",
            bash_command=f"test -d {PROCESSED} && echo 'Data visible'",
        )
        cleanup = BashOperator(
            task_id="cleanup_zombies",
            bash_command="pkill -9 -f '[d]ct_tpu_torch.train_job' || true; sleep 2",
        )
        launch = BashOperator(
            task_id="tpu_spmd_training",
            # Run-correlation ID minted at task runtime (fresh per DAG
            # run); an externally exported DCT_RUN_ID wins.
            bash_command=(
                f"cd {_REPO} && "
                'DCT_RUN_ID="${DCT_RUN_ID:-dct-$(date +%s)-$$}" '
                f"DCT_RESUME={RESUME} "
                + (
                    f"python3 -m dct_tpu_torch.resilience.supervise "
                    f"--max-restarts {MAX_RESTARTS} -- {TRAIN_CMD}"
                    if MAX_RESTARTS != "0"
                    else TRAIN_CMD
                )
            ),
            execution_timeout=timedelta(hours=3),
        )
    else:
        check_versions = BashOperator(
            task_id="check_runtime_versions",
            bash_command=build_healthcheck_script(
                HOSTS,
                exec_template=EXEC,
                check_command="python3 -c 'import torch; print(torch.__version__)'",
            ),
        )
        check_data_visible = BashOperator(
            task_id="check_data_visibility",
            bash_command=build_healthcheck_script(
                HOSTS, exec_template=EXEC, check_command=f"test -d {PROCESSED}"
            ),
        )
        cleanup = BashOperator(
            task_id="cleanup_zombies",
            bash_command=build_zombie_cleanup_script(HOSTS, exec_template=EXEC),
        )
        launch = BashOperator(
            task_id="tpu_spmd_training",
            bash_command=build_spmd_launch_script(
                HOSTS, TRAIN_CMD, exec_template=EXEC,
                extra_env={"DCT_RESUME": RESUME},
            ),
            execution_timeout=timedelta(hours=3),
        )
    verify_model = BashOperator(
        task_id="verify_model",
        bash_command=(
            f"ls {MODELS_DIR}/weather-best-*.ckpt > /dev/null 2>&1 "
            f"|| ls {MODELS_DIR}/*.ckpt > /dev/null 2>&1 "
            "&& echo 'Checkpoint present' || (echo 'No checkpoint'; exit 1)"
        ),
    )
    check_logs = BashOperator(
        task_id="check_tracking_logs",
        bash_command=(
            f"test -d {_abs('mlruns_local')} && echo 'Local tracking runs present' "
            "|| echo 'WARNING: no local tracking dir (MLflow server mode?)'"
        ),
    )
    summary = PythonOperator(
        task_id="training_summary",
        python_callable=print_training_summary,
    )
    cleanup_old = BashOperator(
        task_id="cleanup_old_checkpoints",
        # Keep the newest N best checkpoints.
        bash_command=(
            f"ls -t {MODELS_DIR}/weather-best-*.ckpt 2>/dev/null "
            f"| tail -n +{KEEP_CHECKPOINTS + 1} | xargs -r rm -v; "
            "echo 'Retention cleanup done'"
        ),
    )
    end = BashOperator(
        task_id="end_banner",
        bash_command="echo '=== DISTRIBUTED DATA PIPELINE COMPLETE ==='",
    )
    trigger_deploy = TriggerDagRunOperator(
        task_id="trigger_deploy",
        trigger_dag_id="azure_automated_rollout",
        wait_for_completion=False,
    )
    (
        start >> etl >> verify_etl >> check_versions >> check_data_visible
        >> cleanup >> launch >> verify_model >> check_logs >> summary
        >> cleanup_old >> end >> trigger_deploy
    )
