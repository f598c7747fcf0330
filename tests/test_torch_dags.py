"""The port's DAG files (``dct_tpu_torch/dags``) against the reference's
(``dags/``), through each package's Airflow compat layer (CPU).

- Every reference DAG has a port DAG with the same ``dag_id``, task ids,
  edges, trigger targets, schedule and operator settings, in the local and
  the multi-host launch modes; the port's commands run the port's entry
  points (``python3 -m dct_tpu_torch.<job>``) and name nothing of the JAX
  package; the multi-host launch script is byte-equal to the reference's
  for the same training command.
- The compat layer refuses the same kwargs with the same messages, and
  keeps its own DAG registry.
- The multi-tenant and loop DAGs' commands reach the port's jobs; the
  deploy DAG's python chain deploys and upgrades a locally tracked model
  trained by the port.
"""

import importlib
import importlib.util
import os
import re
import warnings

import pytest

from dct_tpu.orchestration import compat as ref_compat
from dct_tpu_torch.orchestration import compat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DAG_FILES = ["spark_etl_dag", "training_dag", "pipeline_dag",
             "azure_manual_deploy_dag", "azure_auto_deploy_dag",
             "continuous_loop_dag", "multi_tenant_dag"]
#: What each port DAG's commands must run (the reference's job -> the
#: port's entry point).
ENTRY_POINTS = {
    "spark_etl_pipeline": ["python3 -m dct_tpu_torch.preprocess_job"],
    "pytorch_training_pipeline": [
        "python3 -m dct_tpu_torch.resilience.supervise",
        "python3 -m dct_tpu_torch.train_job"],
    "distributed_data_pipeline": [
        "python3 -m dct_tpu_torch.preprocess_job",
        "python3 -m dct_tpu_torch.resilience.supervise",
        "python3 -m dct_tpu_torch.train_job"],
    "continuous_always_on_loop": ["python3 -m dct_tpu_torch.loop_job"],
    "multi_tenant_scheduler": ["python3 -m dct_tpu_torch.scheduler_job"],
}
_JAX_WORDS = re.compile(r"jobs/|\bjax\b|\bflax\b|\boptax\b|\bdct_tpu\.")

pytestmark = pytest.mark.skipif(
    compat.AIRFLOW_AVAILABLE or ref_compat.AIRFLOW_AVAILABLE,
    reason="structural tests target the compat layer",
)


def _load(side: str, name: str):
    """Execute one DAG file afresh (its module-level settings are read
    from the environment at import) and return its DAG."""
    if side == "port":
        path = os.path.join(REPO, "dct_tpu_torch", "dags", f"{name}.py")
        registry = compat.DAG.registry
    else:
        path = os.path.join(REPO, "dags", f"{name}.py")
        registry = ref_compat.DAG.registry
    spec = importlib.util.spec_from_file_location(f"_{side}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        spec.loader.exec_module(mod)
    return mod, registry()[mod.dag.dag_id]


def _graph(dag):
    tasks = {}
    for tid, t in dag.tasks.items():
        kw = dict(t.kwargs)
        tasks[tid] = (type(t).__name__, kw,
                      getattr(t, "trigger_dag_id", None),
                      sorted(d.task_id for d in t.downstream))
    # The description and tags name the platform (TPU, GPU); the rest of
    # the DAG's settings are the reference's.
    kwargs = {k: v for k, v in dag.kwargs.items()
              if k not in ("description", "tags")}
    return dag.dag_id, kwargs, tasks, dag.topological_order()


def _commands(dag):
    return [t.bash_command for t in dag.tasks.values()
            if hasattr(t, "bash_command")]


@pytest.mark.parametrize("hosts", [None, "h1,h2"])
@pytest.mark.parametrize("name", DAG_FILES)
def test_port_dag_graph_matches_reference(name, hosts, monkeypatch):
    if hosts is None:
        monkeypatch.delenv("DCT_TRAIN_HOSTS", raising=False)
    else:
        monkeypatch.setenv("DCT_TRAIN_HOSTS", hosts)
    monkeypatch.delenv("DCT_TRAIN_COMMAND", raising=False)
    _, port = _load("port", name)
    _, ref = _load("ref", name)
    assert _graph(port) == _graph(ref)
    for cmd in _commands(port):
        assert not _JAX_WORDS.search(cmd), cmd
    joined = "\n".join(_commands(port))
    for entry in ENTRY_POINTS.get(port.dag_id, []):
        if hosts and "supervise" in entry:
            continue  # the multi-host launch runs the ranks directly
        assert entry in joined, (port.dag_id, entry)


def test_multi_host_launch_script_is_byte_equal(monkeypatch):
    monkeypatch.setenv("DCT_TRAIN_HOSTS", "h1,h2,h3")
    monkeypatch.setenv("DCT_TRAIN_COMMAND", "python3 train.py")
    monkeypatch.setenv("DCT_FAULT_SPEC", "crash@rank1:epoch1")
    for name, task in (("training_dag", "tpu_spmd_training"),
                       ("pipeline_dag", "tpu_spmd_training")):
        _, port = _load("port", name)
        _, ref = _load("ref", name)
        assert (port.tasks[task].bash_command
                == ref.tasks[task].bash_command)
        assert "[d]ct_tpu_torch.train_job" in port.tasks[
            "cleanup_zombies"].bash_command
        assert "import torch" in port.tasks[
            "check_runtime_versions" if name == "pipeline_dag"
            else "check_tpu_hosts"].bash_command


def test_trigger_targets_are_port_dags():
    dags = {}
    for name in DAG_FILES:
        _, dag = _load("port", name)
        dags[dag.dag_id] = dag
    assert set(dags) == {"spark_etl_pipeline", "pytorch_training_pipeline",
                         "distributed_data_pipeline", "azure_manual_deploy",
                         "azure_automated_rollout",
                         "continuous_always_on_loop",
                         "multi_tenant_scheduler"}
    for dag in dags.values():
        for task in dag.tasks.values():
            if isinstance(task, compat.TriggerDagRunOperator):
                assert task.trigger_dag_id in dags
    # The port's stand-ins keep their own registry.
    assert compat.DAG.registry() is not ref_compat.DAG.registry()
    for dag_id in dags:
        assert compat.DAG.registry()[dag_id] is dags[dag_id]


BAD_KWARGS = [
    ("DAG", {"dag_id": "x", "schedulee": "@daily"}),
    ("DAG", {"dag_id": "x", "default_args": {"retriez": 1}}),
    ("BashOperator", {"task_id": "t", "bash_command": "true",
                      "bash_cmd": "oops"}),
    ("PythonOperator", {"task_id": "t", "python_callable": print,
                        "op_kwarg": {}}),
    ("TriggerDagRunOperator", {"task_id": "t", "trigger_dag_id": "d",
                               "wait": True}),
]


@pytest.mark.parametrize("ctor,kwargs", BAD_KWARGS)
def test_compat_rejects_as_reference(ctor, kwargs):
    errors = []
    for mod in (compat, ref_compat):
        with mod.DAG(dag_id="x_scope"):
            with pytest.raises(TypeError) as err:
                getattr(mod, ctor)(**kwargs)
        errors.append(str(err.value))
    assert errors[0] == errors[1] and "Airflow 2.7" in errors[0]


def test_compat_warnings_and_defaults_as_reference():
    for mod in (compat, ref_compat):
        with pytest.warns(DeprecationWarning, match="schedule_interval"):
            mod.DAG(dag_id="x_sched", schedule_interval="@daily")
        mod.DAG(dag_id="x_defaults", default_args={"retries": 1,
                                                   "env": {"A": "1"}})


def test_scheduler_and_loop_dags_run_the_port_jobs(monkeypatch):
    """The commands reach the port's entry points: a rejected roster exits
    2 and a refused ingest mode exits 1, each failing its task."""
    _, sched = _load("port", "multi_tenant_dag")
    _, loop = _load("port", "continuous_loop_dag")
    monkeypatch.setenv("DCT_TENANTS", "[]")
    monkeypatch.setenv("DCT_DEVICE", "cpu")
    with pytest.raises(RuntimeError, match="exit 2"):
        sched.tasks["run_multi_tenant_scheduler"].execute()
    monkeypatch.setenv("DCT_INGEST_MODE", "stream")
    with pytest.raises(RuntimeError, match="exit 1"):
        loop.tasks["run_always_on_loop"].execute()


class _FakeTI:
    def __init__(self):
        self.store = {}

    def xcom_push(self, key, value):
        self.store[key] = value

    def xcom_pull(self, task_ids=None, key=None):
        return self.store.get(key)


def test_auto_deploy_dag_executes_against_local_endpoint(tmp_path,
                                                         monkeypatch):
    """The deploy DAG's python tasks in order, twice (a first rollout,
    then an upgrade), against one local endpoint, on models the port
    built and tracked."""
    import torch

    from dct_tpu_torch.checkpoint.manager import param_tree, save_checkpoint
    from dct_tpu_torch.config import ModelConfig
    from dct_tpu_torch.deploy.local import LocalEndpointClient
    from dct_tpu_torch.models.registry import get_model
    from dct_tpu_torch.tracking.client import LocalTracking

    monkeypatch.setenv("DCT_DEPLOY_TARGET", "local")
    monkeypatch.setenv("DEPLOY_DIR", str(tmp_path / "pkg"))
    monkeypatch.setenv("DCT_TRACKING_DIR", str(tmp_path / "runs"))
    monkeypatch.setenv("DCT_SOAK_SECONDS", "0")
    monkeypatch.setenv("DCT_DEVICE", "cpu")
    mod, _ = _load("port", "azure_auto_deploy_dag")
    client = LocalEndpointClient()
    monkeypatch.setattr(mod, "_client", lambda: client)
    store = LocalTracking(root=str(tmp_path / "runs"),
                          experiment="weather_forecasting")

    def track_model(val_loss, seed):
        torch.manual_seed(seed)
        model = get_model(ModelConfig(), input_dim=5, device="cpu")
        meta = {"model": "weather_mlp", "input_dim": 5, "hidden_dim": 64,
                "num_classes": 2, "dropout": 0.2, "feature_names": ["a"] * 5}
        ckpt = save_checkpoint(
            str(tmp_path / f"c{seed}" / "weather-best-00-0.50.ckpt"),
            param_tree(model), meta)
        store.start_run()
        store.log_metrics({"val_loss": val_loss}, step=1)
        store.log_artifact(ckpt, "best_checkpoints")
        store.end_run()

    def run_dag_once():
        ti = _FakeTI()
        mod.prepare_package()
        # One package dir for both runs: no distinct champion, so the
        # second rollout is ungated (as in the reference's test).
        mod.evaluate_challenger()
        mod.deploy_new_slot(ti=ti)
        mod.start_shadow(ti=ti)
        mod.start_canary(ti=ti)
        mod.full_rollout(ti=ti)

    track_model(0.5, seed=1)
    run_dag_once()
    assert client.get_traffic("weather-endpoint") == {"blue": 100}
    track_model(0.3, seed=2)
    run_dag_once()
    assert client.get_traffic("weather-endpoint") == {"green": 100}
    assert client.list_deployments("weather-endpoint") == ["green"]
    assert "probabilities" in client.score("weather-endpoint",
                                           {"data": [[0.0] * 5]})
