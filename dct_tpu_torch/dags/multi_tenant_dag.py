"""DAG 7: ``multi_tenant_scheduler`` — N always-on tenants, one task
(counterpart of ``dags/multi_tenant_dag.py``).

DAG 6 (``continuous_always_on_loop``) runs ONE always-on workload per
card; this DAG is its multi-tenant successor: one manually-triggered task
running ``python3 -m dct_tpu_torch.scheduler_job`` (the tenant roster from
``DCT_TENANTS``, each tenant a full always-on loop with its own run dirs,
registry and endpoints, training rounds time-sharing the card through
quota- and priority-arbitrated round leases) until the task's execution
timeout (or an external SIGTERM) drains every tenant cleanly. One tenant
parking (restart budget exhausted, health halt) does NOT end the task:
its peers keep their supervisors, and the task's exit code 1 at drain time
tells the operator which roster entry needs attention.

``schedule=None`` for the same reason as DAG 6: an always-on session is
started deliberately. ``DCT_SCHED_MAX_WALL_S`` bounds one occupancy when
operators prefer rolling restarts.
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

#: One task occupancy (hours), matching DAG 6's budget shape.
SCHED_HOURS = int(os.environ.get("DCT_SCHED_DAG_HOURS", "3"))

default_args = {
    "owner": "dct-tpu",
    # A scheduler that exited nonzero has a PARKED tenant on record:
    # retrying the task would re-park it; an operator resolves it.
    "retries": 0,
}

with DAG(
    dag_id="multi_tenant_scheduler",
    default_args=default_args,
    description=(
        "N always-on tenants sharing one card: quota + priority round "
        "leases, per-tenant fault isolation (dct_tpu_torch.scheduler)"
    ),
    schedule=None,
    start_date=datetime(2024, 1, 1),
    catchup=False,
    tags=["continuous", "multi-tenant", "gpu-pipeline"],
) as dag:
    run_scheduler = BashOperator(
        task_id="run_multi_tenant_scheduler",
        # Run-correlation ID minted at task runtime (one per session; each
        # tenant namespaces it as <run_id>-<tenant>); an external
        # DCT_RUN_ID wins, same contract as the other DAGs.
        bash_command=(
            f"cd {_REPO} && "
            'DCT_RUN_ID="${DCT_RUN_ID:-dct-sched-$(date +%s)-$$}" '
            "python3 -m dct_tpu_torch.scheduler_job"
        ),
        execution_timeout=timedelta(hours=SCHED_HOURS),
    )
