"""Experiment tracking (counterpart of ``dct_tpu/tracking/client.py``).

The deploy side selects the model to ship by querying the tracking store
for the best run by ``metrics.val_loss``, so the tracking surface is shaped
around that query:

- :class:`LocalTracking` is a dependency-free file store,
  ``<root>/<experiment>/<run_id>/{meta.json, metrics.jsonl, artifacts/}``,
  in the reference's layout, so the reference's ``search_best_run`` reads
  the port's runs and the other way round;
- :class:`MlflowTracking` talks to an MLflow server (import-gated: mlflow
  is not a dependency, and without it :func:`get_tracker` falls back to
  the file store);
- :class:`NullTracking` is what non-coordinator processes get.

The reference's event-log and lineage hooks (run correlation IDs,
checkpoint lineage nodes) and its retrying MLflow calls arrive with their
planes (ROADMAP Queue A items 19 and 20).
"""

from __future__ import annotations

import json
import os
import shutil
import time
import uuid
from dataclasses import dataclass, field
from typing import Protocol



@dataclass
class RunInfo:
    run_id: str
    experiment: str
    metrics: dict = field(default_factory=dict)  # final value per key
    params: dict = field(default_factory=dict)
    artifact_dir: str | None = None
    # The platform event log's run-correlation ID stamped at start_run
    # time (None for pre-observability runs): lets the deploy side join
    # the model it ships back to the training cycle that produced it.
    run_correlation_id: str | None = None


class TrackingClient(Protocol):
    def start_run(self, params: dict | None = None) -> str: ...
    def log_metrics(self, metrics: dict, step: int) -> None: ...
    def log_artifact(self, local_path: str, artifact_path: str) -> None: ...
    def end_run(self, status: str = "FINISHED") -> None: ...
    def search_best_run(self, metric: str = "val_loss", mode: str = "min") -> RunInfo | None: ...
    def download_artifacts(self, run_id: str, artifact_path: str, dst: str) -> str: ...


def _publish_json(path: str, obj: dict) -> None:
    """Atomic JSON publish (tmp + ``os.replace``): the deploy DAG's
    ``search_best_run`` reads ``meta.json`` from a different process
    while the trainer's ``end_run`` rewrites it — a torn read there
    would silently drop the run from model selection."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2)
    os.replace(tmp, path)


class LocalTracking:
    """File-backed store: <root>/<experiment>/<run_id>/{meta.json,
    metrics.jsonl, artifacts/...}."""

    def __init__(self, root: str | None = None, experiment: str = "weather_forecasting"):
        self.root = root or os.environ.get("DCT_TRACKING_DIR", "mlruns_local")
        self.experiment = experiment
        self._run_id: str | None = None
        self._active = False
        # Persistent metrics.jsonl handle for the active run: the
        # trainer logs thousands of per-step records per run, and an
        # open()/close() pair per record was a measurable slice of the
        # fit() dispatch gap. Each write is still flushed (per-record
        # durability unchanged); the handle closes with the run.
        self._metrics_fh = None

    # -- write surface -------------------------------------------------
    def _run_dir(self, run_id: str) -> str:
        return os.path.join(self.root, self.experiment, run_id)

    def start_run(self, params: dict | None = None) -> str:
        self._close_metrics_fh()
        self._run_id = uuid.uuid4().hex[:16]
        d = self._run_dir(self._run_id)
        os.makedirs(os.path.join(d, "artifacts"), exist_ok=True)
        meta = {
            "run_id": self._run_id,
            "experiment": self.experiment,
            "run_correlation_id": None,
            "start_time": time.time(),
            "params": params or {},
            "status": "RUNNING",
        }
        _publish_json(os.path.join(d, "meta.json"), meta)
        self._active = True
        return self._run_id

    def _close_metrics_fh(self) -> None:
        if self._metrics_fh is not None:
            try:
                self._metrics_fh.close()
            except OSError:
                pass
            self._metrics_fh = None

    def log_metrics(self, metrics: dict, step: int) -> None:
        if not self._active:
            return
        if self._metrics_fh is None:
            d = self._run_dir(self._run_id)
            self._metrics_fh = open(
                os.path.join(d, "metrics.jsonl"), "a"
            )
        self._metrics_fh.write(
            json.dumps(
                {"step": int(step), "time": time.time(),
                 **{k: float(v) for k, v in metrics.items()}}
            )
            + "\n"
        )
        self._metrics_fh.flush()

    def log_artifact(self, local_path: str, artifact_path: str) -> None:
        if not self._active:
            return
        d = os.path.join(self._run_dir(self._run_id), "artifacts", artifact_path)
        os.makedirs(d, exist_ok=True)
        # Atomic: the deploy DAG downloads from this dir; a checkpoint
        # must appear complete or not at all.
        dst = os.path.join(d, os.path.basename(local_path))
        tmp = f"{dst}.tmp.{os.getpid()}"
        shutil.copy2(local_path, tmp)
        os.replace(tmp, dst)

    def end_run(self, status: str = "FINISHED") -> None:
        if not self._active:
            return
        self._close_metrics_fh()
        d = self._run_dir(self._run_id)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        meta["status"] = status
        meta["end_time"] = time.time()
        _publish_json(os.path.join(d, "meta.json"), meta)
        self._active = False

    # -- query surface (the deploy DAGs' selection query) --------------
    def _final_metrics(self, run_dir: str) -> dict:
        path = os.path.join(run_dir, "metrics.jsonl")
        out: dict = {}
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    rec = json.loads(line)
                    out.update(
                        {k: v for k, v in rec.items() if k not in ("step", "time")}
                    )
        return out

    def search_best_run(self, metric: str = "val_loss", mode: str = "min") -> RunInfo | None:
        """The analog of mlflow ``search_runs(order_by=["metrics.val_loss
        ASC"], max_results=1)`` (dags/azure_auto_deploy.py:32-35)."""
        exp_dir = os.path.join(self.root, self.experiment)
        if not os.path.isdir(exp_dir):
            return None
        best: RunInfo | None = None
        sign = 1.0 if mode == "min" else -1.0
        for run_id in os.listdir(exp_dir):
            run_dir = os.path.join(exp_dir, run_id)
            meta_path = os.path.join(run_dir, "meta.json")
            if not os.path.isfile(meta_path):
                continue
            with open(meta_path) as f:
                meta = json.load(f)
            if meta.get("status") != "FINISHED":
                continue
            metrics = self._final_metrics(run_dir)
            if metric not in metrics:
                continue
            if best is None or sign * metrics[metric] < sign * best.metrics[metric]:
                best = RunInfo(
                    run_id=run_id,
                    experiment=self.experiment,
                    metrics=metrics,
                    params=meta.get("params", {}),
                    artifact_dir=os.path.join(run_dir, "artifacts"),
                    run_correlation_id=meta.get("run_correlation_id"),
                )
        return best

    def download_artifacts(self, run_id: str, artifact_path: str, dst: str) -> str:
        src = os.path.join(self._run_dir(run_id), "artifacts", artifact_path)
        if not os.path.isdir(src):
            raise FileNotFoundError(f"No artifacts at {src}")
        out = os.path.join(dst, artifact_path)
        os.makedirs(dst, exist_ok=True)
        if os.path.isdir(out):
            shutil.rmtree(out)
        # Stage the tree beside the destination, then rename: a crash
        # mid-copy leaves only .tmp debris, never a partial artifact
        # dir that a later prepare_package would mistake for complete.
        tmp_out = f"{out}.tmp.{os.getpid()}"
        if os.path.isdir(tmp_out):
            shutil.rmtree(tmp_out)
        shutil.copytree(src, tmp_out)
        os.replace(tmp_out, out)
        return out


class MlflowTracking:
    """Thin adapter over a real MLflow server (import-gated)."""

    def __init__(self, tracking_uri: str, experiment: str = "weather_forecasting"):
        import mlflow  # gated: not a dependency of the port

        self._mlflow = mlflow
        mlflow.set_tracking_uri(tracking_uri)
        mlflow.set_experiment(experiment)
        self.experiment = experiment
        self._run = None

    def start_run(self, params: dict | None = None) -> str:
        self._run = self._mlflow.start_run()
        if params:
            self._mlflow.log_params(
                {k: v for k, v in params.items() if v is not None}
            )
        return self._run.info.run_id

    def log_metrics(self, metrics: dict, step: int) -> None:
        self._mlflow.log_metrics(
            {k: float(v) for k, v in metrics.items()}, step=step
        )

    def log_artifact(self, local_path: str, artifact_path: str) -> None:
        self._mlflow.log_artifact(local_path, artifact_path=artifact_path)

    def end_run(self, status: str = "FINISHED") -> None:
        self._mlflow.end_run(status=status)

    def search_best_run(self, metric: str = "val_loss", mode: str = "min") -> RunInfo | None:
        order = "ASC" if mode == "min" else "DESC"
        exp = self._mlflow.get_experiment_by_name(self.experiment)
        if exp is None:
            return None
        runs = self._mlflow.search_runs(
            experiment_ids=[exp.experiment_id],
            order_by=[f"metrics.{metric} {order}"],
            max_results=1,
        )
        if len(runs) == 0:
            return None
        row = runs.iloc[0]
        return RunInfo(
            run_id=row["run_id"],
            experiment=self.experiment,
            metrics={metric: float(row[f"metrics.{metric}"])},
        )

    def download_artifacts(self, run_id: str, artifact_path: str, dst: str) -> str:
        from mlflow import artifacts

        return artifacts.download_artifacts(
            run_id=run_id, artifact_path=artifact_path, dst_path=dst
        )


class NullTracking:
    """No-op client for non-coordinator processes."""

    def start_run(self, params=None):
        return "null"

    def log_metrics(self, metrics, step):
        pass

    def log_artifact(self, local_path, artifact_path):
        pass

    def end_run(self, status="FINISHED"):
        pass

    def search_best_run(self, metric="val_loss", mode="min"):
        return None

    def download_artifacts(self, run_id, artifact_path, dst):
        raise FileNotFoundError("NullTracking has no artifacts")


def get_tracker(
    *, tracking_uri: str | None, experiment: str, coordinator: bool = True
):
    """MLflow if configured + importable, else local file store; Null on
    non-coordinator ranks (explicit version of Lightning's rank dedup)."""
    if not coordinator:
        return NullTracking()
    if tracking_uri:
        try:
            return MlflowTracking(tracking_uri, experiment)
        except Exception:
            pass  # server down or mlflow absent -> degrade to local store
    return LocalTracking(experiment=experiment)
