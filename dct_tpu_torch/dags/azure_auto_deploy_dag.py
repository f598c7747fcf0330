"""DAG 5: ``azure_automated_rollout`` — blue/green + shadow + canary
(counterpart of ``dags/azure_auto_deploy_dag.py``).

Same DAG id: unscheduled; chain prepare_package -> evaluate_challenger ->
deploy_new_slot -> start_shadow -> soak -> start_canary -> soak ->
full_rollout, with the reference's stage parameters (mirror 20%, canary
10%, 30 s soaks). Slot state flows between tasks via XCom under real
Airflow; the compat layer passes a shared ``ti``.

``evaluate_challenger`` runs the champion/challenger offline eval harness
(:mod:`dct_tpu_torch.evaluation`, on ``cuda:0`` unless ``DCT_DEVICE`` says
otherwise) and the stage transitions consult the statistical
:class:`~dct_tpu_torch.evaluation.gates.PromotionGate`: a challenger that
regresses against the deployed champion is blocked and the endpoint
reverts. The state machine is :mod:`dct_tpu_torch.deploy.rollout`. The
reference's ``dag.*`` task spans and its adoption of the shipped package's
run-correlation ID are ROADMAP Queue A item 27.
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

from dct_tpu_torch.orchestration.compat import (  # noqa: E402
    DAG,
    BashOperator,
    PythonOperator,
)

DEPLOY_DIR = os.environ.get("DEPLOY_DIR", "/tmp/dct_deploy_package")
ENDPOINT_NAME = os.environ.get("ENDPOINT_NAME", "weather-endpoint")
EXPERIMENT = os.environ.get("DCT_EXPERIMENT", "weather_forecasting")
SOAK_SECONDS = int(os.environ.get("DCT_SOAK_SECONDS", "30"))


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

    # File-backed state: each stage runs in its own Airflow task process,
    # so the slot/traffic state must outlive any single _client() instance.
    # DCT_LOCAL_ENDPOINT_STATE pins it explicitly (needed when cycles use
    # versioned DEPLOY_DIRs, or each cycle would derive a fresh empty
    # endpoint and the gate would never see a champion). Default: beside
    # the package dir (prepare_package wipes DEPLOY_DIR itself).
    return LocalEndpointClient(
        state_path=os.environ.get("DCT_LOCAL_ENDPOINT_STATE")
        or DEPLOY_DIR.rstrip("/") + "_endpoint_state.json"
    )


def _gate():
    """Promotion gate for the rollout stages (DCT_GATE=0 restores the
    ungated timer walk). Built fresh per task process like the client:
    all state lives in the package dir and the ledger."""
    from dct_tpu_torch.evaluation.gates import PromotionGate

    return PromotionGate.from_env(device=os.environ.get("DCT_DEVICE") or None)


def _orchestrator():
    from dct_tpu_torch.deploy.rollout import RolloutOrchestrator

    return RolloutOrchestrator(
        _client(), ENDPOINT_NAME, soak_seconds=SOAK_SECONDS, gate=_gate(),
    )


def prepare_package(**context):
    from dct_tpu_torch.deploy.rollout import prepare_package as prep

    info = prep(_tracker(), DEPLOY_DIR)
    print(f"Package ready: run {info['run_id']} val_loss={info['val_loss']}")


def evaluate_challenger(**context):
    """Offline champion/challenger evaluation: run the harness ONCE here
    (the per-stage gate consults reuse the report cached in the package)
    and log the eval report to tracking as an artifact."""
    gate = _gate()
    if gate is None:
        print("Promotion gate disabled (DCT_GATE=0) — skipping eval")
        return
    champion = None
    client = _client()
    try:
        if client.endpoint_exists(ENDPOINT_NAME):
            traffic = client.get_traffic(ENDPOINT_NAME)
            live = {k: v for k, v in traffic.items() if v > 0}
            if live:
                resolver = getattr(client, "deployment_package_dir", None)
                if resolver is not None:
                    champion = resolver(ENDPOINT_NAME, max(live, key=live.get))
    except Exception as e:  # noqa: BLE001 — champion resolution is
        print(f"Champion resolution failed: {e}")  # best-effort here;
        # the per-stage gates re-resolve and fail closed themselves.
    if not champion or os.path.abspath(champion) == os.path.abspath(
        DEPLOY_DIR
    ):
        print("No distinct deployed champion — first rollout is ungated")
        return
    from dct_tpu_torch.evaluation.harness import EvalError

    try:
        report = gate.offline_eval(DEPLOY_DIR, champion)
    except EvalError as e:
        print(f"Offline eval unavailable: {e}")
        return
    print(
        f"Eval: champion loss={report['champion']['loss_mean']:.4f} "
        f"challenger loss={report['challenger']['loss_mean']:.4f} "
        f"mean_delta={report['mean_delta']:.4f}"
    )
    from dct_tpu_torch.evaluation.gates import log_eval_report

    log_eval_report(
        _tracker(), report, os.path.join(DEPLOY_DIR, "eval_report.json")
    )


def deploy_new_slot(ti=None, **context):
    new_slot, old_slot = _orchestrator().deploy_new_slot(DEPLOY_DIR)
    if ti is not None:
        ti.xcom_push(key="new_slot", value=new_slot)
        ti.xcom_push(key="old_slot", value=old_slot or "")
    print(f"Deployed to slot {new_slot} (old: {old_slot})")


def _slots(ti):
    new_slot = ti.xcom_pull(task_ids="deploy_new_slot", key="new_slot")
    old_slot = ti.xcom_pull(task_ids="deploy_new_slot", key="old_slot") or None
    return new_slot, old_slot


def start_shadow(ti=None, **context):
    new_slot, old_slot = _slots(ti)
    if old_slot is None:
        print("First deployment — skipping shadow, going straight to 100%")
        _orchestrator().full_rollout(new_slot, None)
        return
    _orchestrator().start_shadow(new_slot, old_slot)
    print(f"Shadow: {old_slot} 100% live, {new_slot} mirroring 20%")


def start_canary(ti=None, **context):
    new_slot, old_slot = _slots(ti)
    if old_slot is None:
        return
    _orchestrator().start_canary(new_slot, old_slot)
    print(f"Canary: {old_slot} 90% / {new_slot} 10%")


def full_rollout(ti=None, **context):
    new_slot, old_slot = _slots(ti)
    _orchestrator().full_rollout(new_slot, old_slot)
    print(f"Full rollout: {new_slot} at 100%, old slot removed")


with DAG(
    dag_id="azure_automated_rollout",
    description="Automated blue/green rollout with shadow + canary stages",
    schedule=None,
    start_date=datetime(2024, 1, 1),
    catchup=False,
    tags=["deploy", "gpu-pipeline"],
) as dag:
    t_prepare = PythonOperator(task_id="prepare_package", python_callable=prepare_package)
    t_eval = PythonOperator(
        task_id="evaluate_challenger", python_callable=evaluate_challenger
    )
    t_deploy = PythonOperator(task_id="deploy_new_slot", python_callable=deploy_new_slot)
    t_shadow = PythonOperator(task_id="start_shadow", python_callable=start_shadow)
    t_soak1 = BashOperator(task_id="shadow_soak", bash_command=f"sleep {SOAK_SECONDS}")
    t_canary = PythonOperator(task_id="start_canary", python_callable=start_canary)
    t_soak2 = BashOperator(task_id="canary_soak", bash_command=f"sleep {SOAK_SECONDS}")
    t_full = PythonOperator(task_id="full_rollout", python_callable=full_rollout)

    t_prepare >> t_eval >> t_deploy >> t_shadow >> t_soak1 >> t_canary >> t_soak2 >> t_full
