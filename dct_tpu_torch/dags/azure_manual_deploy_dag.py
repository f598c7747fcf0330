"""DAG 4: ``azure_manual_deploy`` — force-deploy the best model at 100%
(counterpart of ``dags/azure_manual_deploy_dag.py``).

Same DAG id: unscheduled, two tasks — ``prepare_package`` (best-run query
-> deploy package, :mod:`dct_tpu_torch.deploy.rollout`) and
``force_deploy`` (get-or-recreate the endpoint, deploy ``blue``, 100%
traffic). The endpoint comes from a client factory
(``DCT_DEPLOY_TARGET=azure`` -> Azure ML, anything else -> the local
endpoint for smoke runs). The reference stamps the package's
run-correlation ID on the rollout's events; that adoption is ROADMAP
Queue A item 27.
"""

from __future__ import annotations

import os
import sys
from datetime import datetime

_REPO = os.environ.get(
    "DCT_REPO_ROOT",
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
)
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from dct_tpu_torch.orchestration.compat import DAG, PythonOperator  # noqa: E402

DEPLOY_DIR = os.environ.get("DEPLOY_DIR", "/tmp/dct_deploy_package")
ENDPOINT_NAME = os.environ.get("ENDPOINT_NAME", "weather-endpoint")
EXPERIMENT = os.environ.get("DCT_EXPERIMENT", "weather_forecasting")


def _tracker():
    from dct_tpu_torch.tracking.client import get_tracker

    return get_tracker(
        tracking_uri=os.environ.get("MLFLOW_TRACKING_URI"), experiment=EXPERIMENT
    )


def _client():
    if os.environ.get("DCT_DEPLOY_TARGET", "azure") == "azure":
        from dct_tpu_torch.deploy.azure import AzureEndpointClient

        return AzureEndpointClient()
    from dct_tpu_torch.deploy.local import LocalEndpointClient

    # File-backed so deploy state survives per-task processes; lives BESIDE
    # the package dir (prepare_package wipes DEPLOY_DIR).
    return LocalEndpointClient(
        state_path=DEPLOY_DIR.rstrip("/") + "_endpoint_state.json"
    )


def prepare_package(**context):
    from dct_tpu_torch.deploy.rollout import prepare_package as prep

    info = prep(_tracker(), DEPLOY_DIR)
    print(f"Package ready: run {info['run_id']} val_loss={info['val_loss']}")
    return info["run_id"]


def force_deploy(**context):
    from dct_tpu_torch.deploy.rollout import RolloutOrchestrator

    ro = RolloutOrchestrator(_client(), ENDPOINT_NAME)
    ro.ensure_endpoint()
    ro.client.deploy(ENDPOINT_NAME, "blue", DEPLOY_DIR)
    ro.client.set_traffic(ENDPOINT_NAME, {"blue": 100})
    print(f"Deployed 'blue' at 100% on {ENDPOINT_NAME}")


with DAG(
    dag_id="azure_manual_deploy",
    description="Manual force-deploy of the best tracked model",
    schedule=None,
    start_date=datetime(2024, 1, 1),
    catchup=False,
    tags=["deploy", "gpu-pipeline"],
) as dag:
    t_prepare = PythonOperator(task_id="prepare_package", python_callable=prepare_package)
    t_deploy = PythonOperator(task_id="force_deploy", python_callable=force_deploy)
    t_prepare >> t_deploy
