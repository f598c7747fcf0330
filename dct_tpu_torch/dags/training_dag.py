"""DAG 2: ``pytorch_training_pipeline`` — the distributed training launch
(counterpart of ``dags/training_dag.py``).

Same DAG id: externally triggered, retries=1/5min, and the task chain
banner -> zombie cleanup -> host healthcheck -> launch -> checkpoint
verification -> trigger ``azure_automated_rollout``.

The launch block is the reference's (identical script on every host,
staggered start, fail-fast join, exit-code conjunction; the port's script
builders give the same bytes for the same arguments), the hosts are GPU
hosts reached through a templated exec mechanism (``ssh {host} {cmd}`` by
default), and the program is ``python3 -m dct_tpu_torch.train_job`` with a
``torch.distributed`` rendezvous on ``MASTER_ADDR`` / ``MASTER_PORT``.
``DCT_TRAIN_HOSTS=local`` runs one in-place world under the supervisor
(``python3 -m dct_tpu_torch.resilience.supervise``).
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
    TriggerDagRunOperator,
)


def _abs(p: str) -> str:
    """Anchor relative paths at the repo root: Airflow BashOperators run
    in a per-task temp cwd, so bare relative defaults would never resolve."""
    return p if os.path.isabs(p) else os.path.join(_REPO, p)


HOSTS = os.environ.get("DCT_TRAIN_HOSTS", "local").split(",")
EXEC = os.environ.get("DCT_EXEC_TEMPLATE", "ssh {host} {cmd}")
# ``env`` sets the import path in both places the command runs: as the
# supervisor's argv and after the launch script's per-rank variables.
TRAIN_CMD = os.environ.get(
    "DCT_TRAIN_COMMAND",
    f"env PYTHONPATH={_REPO} python3 -m dct_tpu_torch.train_job",
)
MODELS_DIR = _abs(os.environ.get("DCT_MODELS_DIR", "data/models"))
LOCAL_MODE = HOSTS == ["local"]
# Continuous training: each run RESUMES the optimizer trajectory from the
# previous run's train state and extends it by DCT_EPOCHS more epochs on
# the refreshed data. DCT_RESUME=0 trains from scratch.
RESUME = os.environ.get("DCT_RESUME", "1")
# Supervised relaunch-and-resume in local mode (crash / hang / preempted /
# health-halt classification, SIGTERM -> SIGKILL escalation, relaunch with
# resume and backoff up to DCT_MAX_RESTARTS); 0 = the bare launch. In
# script mode Airflow's retries heal: the launch script exits 75 for a
# graceful preemption and the cleanup/healthcheck tasks 22/21 for infra
# faults.
MAX_RESTARTS = os.environ.get("DCT_MAX_RESTARTS", "2")
# Chaos drills: an exported fault plan reaches the ranks in both modes.
_RANK_EXTRA_ENV = {"DCT_RESUME": RESUME}
if os.environ.get("DCT_FAULT_SPEC"):
    _RANK_EXTRA_ENV["DCT_FAULT_SPEC"] = os.environ["DCT_FAULT_SPEC"]

default_args = {
    "owner": "dct-tpu",
    "retries": 1,
    "retry_delay": timedelta(minutes=5),
}

with DAG(
    dag_id="pytorch_training_pipeline",
    default_args=default_args,
    description="GPU training (PyTorch, hand-written CUDA kernels) on the processed weather data",
    schedule=None,  # externally triggered by the ETL DAG
    start_date=datetime(2024, 1, 1),
    catchup=False,
    tags=["training", "gpu-pipeline"],
) as dag:
    start = BashOperator(
        task_id="start_banner",
        bash_command="echo '=== GPU DISTRIBUTED TRAINING START ==='",
    )

    if LOCAL_MODE:
        cleanup = BashOperator(
            task_id="cleanup_zombies",
            bash_command=(
                "pkill -9 -f '[d]ct_tpu_torch.train_job' || true; sleep 2; "
                "echo 'Cleanup complete'"
            ),
        )
        health = BashOperator(
            task_id="check_tpu_hosts",
            bash_command=(
                "python3 -c 'import torch; assert torch.cuda.is_available(); "
                "print(torch.cuda.device_count())'"
            ),
        )
        launch = BashOperator(
            task_id="tpu_spmd_training",
            # Run-correlation ID minted at TASK runtime (fresh per DAG
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
        cleanup = BashOperator(
            task_id="cleanup_zombies",
            bash_command=build_zombie_cleanup_script(HOSTS, exec_template=EXEC),
        )
        health = BashOperator(
            task_id="check_tpu_hosts",
            bash_command=build_healthcheck_script(HOSTS, exec_template=EXEC),
        )
        launch = BashOperator(
            task_id="tpu_spmd_training",
            bash_command=build_spmd_launch_script(
                HOSTS, TRAIN_CMD, exec_template=EXEC,
                extra_env=_RANK_EXTRA_ENV,
            ),
            execution_timeout=timedelta(hours=3),
        )

    verify = BashOperator(
        task_id="verify_model",
        bash_command=(
            f"ls {MODELS_DIR}/*.ckpt > /dev/null 2>&1 "
            "&& echo 'Model checkpoint present' "
            "|| (echo 'No checkpoint produced'; exit 1)"
        ),
    )

    trigger_deploy = TriggerDagRunOperator(
        task_id="trigger_azure_rollout",
        trigger_dag_id="azure_automated_rollout",
        wait_for_completion=False,
    )

    start >> cleanup >> health >> launch >> verify >> trigger_deploy
