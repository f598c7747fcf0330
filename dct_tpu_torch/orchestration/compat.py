"""Airflow compatibility layer (a copy of ``dct_tpu/orchestration/compat.py``).

The port's DAG files under ``dct_tpu_torch/dags/`` define the same control
plane as the reference's (``dags/``), with commands that run the port's
entry points. On a real Airflow deployment they import the real
operators; in hermetic environments (no Airflow installed) they fall back
to these structural stand-ins, which record the task graph, commands, and
callables so tests can validate DAG wiring and execute Python tasks
without an Airflow installation. The surface covered is exactly what the
DAGs use: DAG (context manager), BashOperator, PythonOperator,
TriggerDagRunOperator, and ``>>`` chaining. The stand-ins keep their own
``DAG.registry()``, apart from the reference's.

The stand-ins are STRICT about the API surface: constructor kwargs (and
``default_args`` keys) are validated against the Airflow 2.7 signatures
(the version the Dockerfile pins), and the
pre-2.4 ``schedule_interval`` parameter raises the same deprecation
warning the real scheduler logs — so a DAG file that would trip on a real
2.7 DagBag import fails HERE, in tests, not on the production scheduler.
Airflow cannot be installed in hermetic rigs; this validation is the
strongest available stand-in for a real ``airflow dags list`` check (the
Airflow image itself still exists for deployments that can build it).
"""

from __future__ import annotations

import inspect
import subprocess
import warnings
from typing import Any, Callable

# Airflow 2.7 API surfaces (airflow.models.dag.DAG and BaseOperator
# keyword parameters, trimmed to realistic DAG-file usage; an unknown
# kwarg raises TypeError exactly like the real constructors).
_DAG_PARAMS = frozenset({
    "description", "schedule", "schedule_interval", "timetable",
    "start_date", "end_date", "full_filepath", "template_searchpath",
    "template_undefined", "user_defined_macros", "user_defined_filters",
    "default_args", "concurrency", "max_active_tasks", "max_active_runs",
    "dagrun_timeout", "sla_miss_callback", "default_view", "orientation",
    "catchup", "on_success_callback", "on_failure_callback", "doc_md",
    "params", "access_control", "is_paused_upon_creation", "jinja_environment_kwargs",
    "render_template_as_native_obj", "tags", "owner_links", "auto_register",
    "fail_stop",
})
_BASE_OPERATOR_PARAMS = frozenset({
    "owner", "email", "email_on_retry", "email_on_failure", "retries",
    "retry_delay", "retry_exponential_backoff", "max_retry_delay",
    "start_date", "end_date", "depends_on_past", "ignore_first_depends_on_past",
    "wait_for_past_depends_before_skipping", "wait_for_downstream",
    "dag", "params", "default_args", "priority_weight", "weight_rule",
    "queue", "pool", "pool_slots", "sla", "execution_timeout",
    "on_execute_callback", "on_failure_callback", "on_success_callback",
    "on_retry_callback", "pre_execute", "post_execute", "trigger_rule",
    "resources", "run_as_user", "task_concurrency", "max_active_tis_per_dag",
    "max_active_tis_per_dagrun", "executor_config", "do_xcom_push",
    "multiple_outputs", "inlets", "outlets", "task_group", "doc", "doc_md",
    "doc_json", "doc_yaml", "doc_rst",
})
_OPERATOR_EXTRA_PARAMS = {
    "BashOperator": frozenset({
        "env", "append_env", "output_encoding", "skip_on_exit_code", "cwd",
    }),
    "PythonOperator": frozenset({
        "op_args", "op_kwargs", "templates_dict", "templates_exts",
        "show_return_value_in_logs",
    }),
    "TriggerDagRunOperator": frozenset({
        "trigger_run_id", "conf", "logical_date", "execution_date",
        "reset_dag_run", "wait_for_completion", "poke_interval",
        "allowed_states", "failed_states", "deferrable",
    }),
}


def _validate_kwargs(ctor: str, kwargs: dict, allowed: frozenset) -> None:
    unknown = set(kwargs) - allowed
    if unknown:
        raise TypeError(
            f"{ctor}() got unexpected keyword argument(s) "
            f"{sorted(unknown)} — not part of the Airflow 2.7 API"
        )

try:  # pragma: no cover - exercised only on real Airflow images
    from airflow import DAG  # type: ignore
    from airflow.operators.bash import BashOperator  # type: ignore
    from airflow.operators.python import PythonOperator  # type: ignore
    from airflow.operators.trigger_dagrun import TriggerDagRunOperator  # type: ignore

    AIRFLOW_AVAILABLE = True
except ImportError:
    AIRFLOW_AVAILABLE = False

    _DAG_REGISTRY: dict[str, "DAG"] = {}
    _CURRENT: list["DAG"] = []

    class _TaskInstance:
        """Stand-in for Airflow's ``ti``: XCom push/pull against the DAG's
        shared per-run store, so task-to-task state flow (e.g. the rollout
        DAG's slot handoff) works when DAGs execute through this layer."""

        def __init__(self, store: dict, task_id: str):
            self._store = store
            self.task_id = task_id

        def xcom_push(self, key: str, value: Any) -> None:
            self._store[(self.task_id, key)] = value

        def xcom_pull(self, task_ids: str | None = None, key: str = "return_value"):
            return self._store.get((task_ids or self.task_id, key))

    class _Task:
        def __init__(self, task_id: str, **kwargs: Any):
            extra = _OPERATOR_EXTRA_PARAMS.get(type(self).__name__, frozenset())
            _validate_kwargs(
                type(self).__name__, kwargs, _BASE_OPERATOR_PARAMS | extra
            )
            self.task_id = task_id
            self.kwargs = kwargs
            self.downstream: list[_Task] = []
            self.upstream: list[_Task] = []
            self.dag = _CURRENT[-1] if _CURRENT else None
            if _CURRENT:
                _CURRENT[-1].tasks[task_id] = self

        def __rshift__(self, other):
            others = other if isinstance(other, (list, tuple)) else [other]
            for o in others:
                self.downstream.append(o)
                o.upstream.append(self)
            return other

        def __rrshift__(self, other):
            other.__rshift__(self)
            return self

    class BashOperator(_Task):
        def __init__(self, task_id: str, bash_command: str, **kwargs: Any):
            super().__init__(task_id, **kwargs)
            self.bash_command = bash_command

        def execute(self, context: dict | None = None) -> int:
            """Run the command like Airflow's BashOperator (bash -c)."""
            proc = subprocess.run(["bash", "-c", self.bash_command])
            if proc.returncode != 0:
                raise RuntimeError(
                    f"Task {self.task_id} failed with exit {proc.returncode}"
                )
            return proc.returncode

    class PythonOperator(_Task):
        def __init__(
            self, task_id: str, python_callable: Callable, **kwargs: Any
        ):
            super().__init__(task_id, **kwargs)
            self.python_callable = python_callable

        def execute(self, context: dict | None = None):
            """Call like Airflow: supply ``ti`` (backed by the DAG's shared
            XCom store) and pass only the kwargs the callable accepts."""
            ctx = dict(context or {})
            if "ti" not in ctx and self.dag is not None:
                ctx["ti"] = _TaskInstance(self.dag.xcom_store, self.task_id)
            sig = inspect.signature(self.python_callable)
            accepts_var_kw = any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in sig.parameters.values()
            )
            if not accepts_var_kw:
                ctx = {k: v for k, v in ctx.items() if k in sig.parameters}
            return self.python_callable(**ctx)

    class TriggerDagRunOperator(_Task):
        def __init__(self, task_id: str, trigger_dag_id: str, **kwargs: Any):
            super().__init__(task_id, **kwargs)
            self.trigger_dag_id = trigger_dag_id

    class DAG:
        def __init__(self, dag_id: str, **kwargs: Any):
            _validate_kwargs("DAG", kwargs, _DAG_PARAMS)
            if "schedule_interval" in kwargs:
                # Airflow 2.7 still accepts it but logs RemovedInAirflow3;
                # surfacing it as a warning keeps DAG files honest before
                # they meet a real scheduler.
                warnings.warn(
                    "schedule_interval is deprecated since Airflow 2.4; "
                    "use schedule=",
                    DeprecationWarning,
                    stacklevel=2,
                )
            # Real Airflow forwards default_args to EACH operator ctor, so
            # operator-specific keys (env, op_kwargs, conf, ...) are legal
            # there — validate against the union, not BaseOperator alone.
            allowed_defaults = _BASE_OPERATOR_PARAMS.union(
                *_OPERATOR_EXTRA_PARAMS.values()
            )
            bad = set(kwargs.get("default_args") or {}) - allowed_defaults
            if bad:
                raise TypeError(
                    f"DAG default_args contain non-operator key(s) "
                    f"{sorted(bad)} — not part of the Airflow 2.7 "
                    "operator APIs"
                )
            self.dag_id = dag_id
            self.kwargs = kwargs
            self.tasks: dict[str, _Task] = {}
            # Shared XCom store for tasks executed through this layer
            # ((task_id, key) -> value); one logical "run" per process.
            self.xcom_store: dict = {}
            _DAG_REGISTRY[dag_id] = self

        def __enter__(self):
            _CURRENT.append(self)
            return self

        def __exit__(self, *exc):
            _CURRENT.pop()
            return False

        @staticmethod
        def registry() -> dict[str, "DAG"]:
            return _DAG_REGISTRY

        def topological_order(self) -> list[str]:
            order: list[str] = []
            seen: set[str] = set()

            def visit(t):
                if t.task_id in seen:
                    return
                for up in t.upstream:
                    visit(up)
                seen.add(t.task_id)
                order.append(t.task_id)

            for t in self.tasks.values():
                visit(t)
            return order
