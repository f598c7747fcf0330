"""DAG 6: ``continuous_always_on_loop`` — the always-on entry point
(counterpart of ``dags/continuous_loop_dag.py``).

The episodic DAGs (1-5) are one ETL -> train -> gate -> deploy pass per
trigger. This DAG is ONE manually-triggered task that runs ``python3 -m
dct_tpu_torch.loop_job`` (ingest watcher, continuous training rounds under
the supervisor, and mid-run gated promotion, all overlapped) until the
task's execution timeout (or an external SIGTERM) drains it cleanly.
Airflow's task-level SIGTERM on timeout IS the loop's drain signal: the
round in flight checkpoints, the evaluator finishes its pass, exit 0, so
a re-trigger resumes the same trajectory and champion.

``schedule=None``: an always-on loop is started deliberately, not on a
clock. ``DCT_LOOP_MAX_WALL_S`` bounds one task occupancy when operators
prefer rolling restarts over an unbounded task.
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

from dct_tpu_torch.orchestration.compat import DAG, BashOperator  # noqa: E402

#: One task occupancy (hours); the loop drains cleanly at the timeout's
#: SIGTERM and the next trigger resumes.
LOOP_HOURS = int(os.environ.get("DCT_LOOP_DAG_HOURS", "3"))

default_args = {
    "owner": "dct-tpu",
    # A loop that exited 1 needs an operator (the supervisor already
    # healed everything healable).
    "retries": 0,
}

with DAG(
    dag_id="continuous_always_on_loop",
    default_args=default_args,
    description=(
        "Always-on overlapped cycles: ingest -> incremental ETL -> "
        "continuous training -> mid-run gated promotion (dct_tpu_torch)"
    ),
    schedule=None,
    start_date=datetime(2024, 1, 1),
    catchup=False,
    tags=["continuous", "always-on", "gpu-pipeline"],
) as dag:
    run_loop = BashOperator(
        task_id="run_always_on_loop",
        # Run-correlation ID minted at task runtime (one per loop
        # session); an externally exported DCT_RUN_ID wins.
        bash_command=(
            f"cd {_REPO} && "
            'DCT_RUN_ID="${DCT_RUN_ID:-dct-loop-$(date +%s)-$$}" '
            "python3 -m dct_tpu_torch.loop_job"
        ),
        execution_timeout=timedelta(hours=LOOP_HOURS),
    )
