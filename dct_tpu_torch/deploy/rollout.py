"""Deployment: packaging + blue/green + shadow + canary rollout
(counterpart of ``dct_tpu/deploy/rollout.py``).

The reference's two deploy DAGs as a state machine:

- ``prepare_package`` (dags/azure_auto_deploy.py:26-115): query the
  tracking store for the best run by ``val_loss ASC``, download its
  ``best_checkpoints`` artifact, stage ``model.ckpt`` and the generated
  serving files into a deploy dir, with a ``run_info.json`` manifest (the
  run's metrics, the validation split, a training-data snapshot for the
  drift detectors);
- ``deploy_new_slot`` (:118-149): read live traffic, pick the idle slot (no
  traffic -> ``blue``; else the opposite of the max-traffic slot);
- ``start_shadow`` (:152-161): 100/0 live traffic + 20% mirror to the new
  slot; ``start_canary`` (:163-172): clear mirror, 90/10 live;
  ``full_rollout`` (:174-185): 100% new, delete old deployment; with a
  :class:`~dct_tpu_torch.evaluation.gates.PromotionGate` consulted before
  canary and before full, and ``rollback`` on anything but promote.

The cloud surface is the small :class:`EndpointClient` protocol (Azure in
:mod:`dct_tpu_torch.deploy.azure`, in-process in
:mod:`dct_tpu_torch.deploy.local`). The reference's stage spans and
``deploy.*`` events are ROADMAP Queue A item 27, its lineage nodes and
edges (packages, gate verdicts, slot flips) item 29; the stage record
(:attr:`RolloutOrchestrator.events`) is kept.
"""

from __future__ import annotations

import glob
import os
import shutil
import time
from dataclasses import dataclass, field
from typing import Protocol

BLUE, GREEN = "blue", "green"
# The reference's stage parameters (dags/azure_auto_deploy.py:152-172).
MIRROR_PERCENT, CANARY_PERCENT = 20, 10


class EndpointClient(Protocol):
    """Minimal control surface of a managed online endpoint."""

    def endpoint_exists(self, endpoint: str) -> bool: ...
    def create_endpoint(self, endpoint: str) -> None: ...
    def delete_endpoint(self, endpoint: str) -> None: ...
    def provisioning_state(self, endpoint: str) -> str: ...
    def get_traffic(self, endpoint: str) -> dict[str, int]: ...
    def set_traffic(self, endpoint: str, traffic: dict[str, int]) -> None: ...
    def get_mirror_traffic(self, endpoint: str) -> dict[str, int]: ...
    def set_mirror_traffic(self, endpoint: str, traffic: dict[str, int]) -> None: ...
    def deploy(self, endpoint: str, slot: str, package_dir: str) -> None: ...
    def delete_deployment(self, endpoint: str, slot: str) -> None: ...
    def list_deployments(self, endpoint: str) -> list[str]: ...


def prepare_package(
    tracker, deploy_dir: str, *, data_dir: str | None = None
) -> dict:
    """Best-run query -> deploy package. Returns package info.

    Mirrors the reference flow (wipe deploy dir, find best run, download
    ``best_checkpoints``, take the first .ckpt, generate serving files) and
    adds the numpy weight export so serving needs no ML framework.
    """
    from dct_tpu_torch.serving.score_gen import generate_score_package

    if os.path.isdir(deploy_dir):
        shutil.rmtree(deploy_dir)
    os.makedirs(deploy_dir, exist_ok=True)

    best = tracker.search_best_run("val_loss", "min")
    if best is None:
        raise RuntimeError(
            "No finished runs with val_loss found in the tracking store — "
            "did the training pipeline run?"
        )
    art_dir = tracker.download_artifacts(
        best.run_id, "best_checkpoints", os.path.join(deploy_dir, "_dl")
    )
    ckpts = sorted(glob.glob(os.path.join(art_dir, "*.ckpt")))
    if not ckpts:
        raise FileNotFoundError(f"No .ckpt in artifact dir {art_dir}")
    model_ckpt = os.path.join(deploy_dir, "model.ckpt")
    # The download already staged the bytes under _dl/ on the same
    # filesystem: publish by atomic rename, so model.ckpt either holds
    # the complete checkpoint or does not exist — never a torn copy.
    os.replace(ckpts[0], model_ckpt)
    shutil.rmtree(os.path.join(deploy_dir, "_dl"))

    meta = generate_score_package(model_ckpt, deploy_dir)
    # Persist the shipped model's provenance INSIDE the package: each
    # rollout stage runs in its own Airflow task process with no env
    # inheritance from the training launch, and the package dir is the
    # one artifact every stage shares — so it carries the training
    # cycle's run-correlation ID, the selected run's FULL final metrics (what the promotion gates — and
    # humans — compare the next challenger against), and a
    # training-data snapshot for the deploy-side drift detectors.
    import json

    info_path = os.path.join(deploy_dir, "run_info.json")
    info_tmp = f"{info_path}.tmp.{os.getpid()}"
    with open(info_tmp, "w") as f:
        json.dump(
            {
                "tracking_run_id": best.run_id,
                "run_correlation_id": best.run_correlation_id,
                "val_loss": best.metrics.get("val_loss"),
                "metrics": {
                    k: v for k, v in best.metrics.items()
                    if isinstance(v, (int, float))
                },
                "data_snapshot": _training_data_snapshot(data_dir),
                # The split the shipped model was validated on. The
                # eval harness must rebuild EXACTLY this split, and the
                # gate runs in a DAG task process with no env
                # inheritance from the training launch — so the split
                # parameters travel in the artifact. The seed comes
                # from the training run's OWN logged params when
                # available (authoritative), env otherwise.
                "split": _split_params(best.params),  # dct: noqa[gather-on-publish] — tracking-run hyperparameter dict (tracking.client.Run.params), not a TrainState; nothing here is a device array
            },
            f,
            indent=2,
        )
    # The manifest gates every later stage's eval/drift decisions; a
    # half-written one must be unobservable (the gate would fail open
    # on a torn read as "pre-observability package").
    os.replace(info_tmp, info_path)
    return {
        "run_id": best.run_id,
        "run_correlation_id": best.run_correlation_id,
        "val_loss": best.metrics.get("val_loss"),
        "metrics": dict(best.metrics),
        "deploy_dir": deploy_dir,
        "model_meta": meta,
    }


def _split_params(run_params: dict | None) -> dict:
    """The validation-split parameters to stamp into the manifest: both
    from the training run's OWN logged params when present
    (authoritative — the packaging process's env need not match the
    training launch's), env fallback for runs logged before the trainer
    recorded them."""
    from dct_tpu_torch.config import DataConfig, TrainConfig

    params = run_params or {}
    try:
        seed = int(params["seed"])
    except (KeyError, TypeError, ValueError):
        seed = TrainConfig.from_env().seed
    try:
        val_fraction = float(params["val_fraction"])
    except (KeyError, TypeError, ValueError):
        val_fraction = DataConfig.from_env().val_fraction
    return {"seed": seed, "val_fraction": val_fraction}


def _training_data_snapshot(data_dir: str | None) -> dict | None:
    """Quantile snapshot of the processed training data, stamped into
    the package manifest so the NEXT cycle's drift detectors can
    compare their ETL output against what THIS model learned from.
    Best-effort: a packaging host without the data ships None, never a
    failed deploy."""
    from dct_tpu_torch.config import EvaluationConfig

    data_dir = data_dir or os.environ.get("DCT_PROCESSED_DIR", "data/processed")
    try:
        # Cached by snapshot identity: the always-on loop packages a
        # challenger per promotion against the same processed snapshot —
        # the quantile stamp must not re-pay the parquet IO each time.
        from dct_tpu_torch.data.dataset import load_processed_dataset_cached
        from dct_tpu_torch.evaluation.drift import snapshot_features

        data = load_processed_dataset_cached(data_dir)
        return snapshot_features(
            data.features, data.feature_names,
            bins=EvaluationConfig.from_env().drift_bins,
        )
    except Exception:  # noqa: BLE001 — snapshotting is provenance, not a gate
        return None


def package_manifest(package_dir: str) -> dict:
    """The full ``run_info.json`` manifest of a deploy package ({} for
    pre-observability packages or any read failure)."""
    import json

    try:
        with open(os.path.join(package_dir, "run_info.json")) as f:
            manifest = json.load(f)
        return manifest if isinstance(manifest, dict) else {}
    except (OSError, ValueError):
        return {}


def choose_slot(traffic: dict[str, int]) -> tuple[str, str | None]:
    """(new_slot, old_slot) from the live traffic map.

    Reference logic (dags/azure_auto_deploy.py:124-129): empty/zero traffic
    -> deploy ``blue`` with no old slot; otherwise the slot currently
    holding the most traffic is old, and new is its blue/green opposite.
    """
    live = {k: v for k, v in traffic.items() if v > 0}
    if not live:
        return BLUE, None
    old = max(live, key=live.get)
    return (GREEN if old == BLUE else BLUE), old


@dataclass
class RolloutEvent:
    stage: str
    traffic: dict = field(default_factory=dict)
    mirror: dict = field(default_factory=dict)


class RolloutOrchestrator:
    """The blue/green + shadow + canary state machine.

    ``run()`` executes: deploy_new_slot -> shadow (soak) -> canary (soak)
    -> full rollout, with the reference's stage parameters (mirror 20%,
    canary 10%, 30 s soaks — dags/azure_auto_deploy.py:152-185,189-197).
    Each stage is also callable individually (the DAGs map one task per
    stage).
    """

    def __init__(
        self,
        client: EndpointClient,
        endpoint: str,
        *,
        soak_seconds: float = 30.0,
        sleep_fn=time.sleep,
        gate=None,
    ):
        from dct_tpu_torch.resilience.retry import Retrier

        self.client = client
        self.endpoint = endpoint
        self.soak_seconds = soak_seconds
        self.sleep_fn = sleep_fn
        self.events: list[RolloutEvent] = []
        # Promotion gate (evaluation.gates.PromotionGate, or any
        # object with its evaluate() signature): consulted between
        # stages — shadow -> canary and canary -> full rollout. None =
        # the reference's ungated timer walk.
        self.gate = gate
        # Transient control-plane flakes retry with backoff instead of
        # aborting the rollout; when retries exhaust mid-canary the
        # stage auto-reverts to the prior deployment (`rollback`).
        # The policy comes from the DCT_RETRY_* environment.
        self._retry = Retrier.from_env(sleep_fn=sleep_fn)

    def _call(self, fn, *args, op: str):
        """One endpoint-control call under the retry policy."""
        return self._retry(lambda: fn(*args), op=f"deploy.{op}")

    # -- stages --------------------------------------------------------
    def ensure_endpoint(self) -> None:
        """Get-or-recreate, deleting a failed endpoint first
        (dags/azure_manual_deploy.py:141-150)."""
        c = self.client
        if self._call(c.endpoint_exists, self.endpoint, op="endpoint_exists"):
            state = self._call(
                c.provisioning_state, self.endpoint, op="provisioning_state"
            )
            if state.lower() == "failed":
                self._call(c.delete_endpoint, self.endpoint, op="delete_endpoint")
                self._call(c.create_endpoint, self.endpoint, op="create_endpoint")
        else:
            self._call(c.create_endpoint, self.endpoint, op="create_endpoint")

    def deploy_new_slot(self, package_dir: str) -> tuple[str, str | None]:
        self.ensure_endpoint()
        new_slot, old_slot = choose_slot(
            self._call(self.client.get_traffic, self.endpoint,
                       op="get_traffic")
        )
        self._call(self.client.deploy, self.endpoint, new_slot,
                   package_dir, op="deploy")
        if old_slot is None:
            # First deployment: take 100% immediately (manual-deploy
            # path, dags/azure_manual_deploy.py:164-167).
            self._call(self.client.set_traffic, self.endpoint,
                       {new_slot: 100}, op="set_traffic")
        self._record("deploy_new_slot")
        return new_slot, old_slot

    def start_shadow(self, new_slot: str, old_slot: str) -> None:
        # Fresh evidence window: the capture file carries the PREVIOUS
        # cycle's mirrored pairs (a held challenger's disagreements, a
        # promoted one's agreements) — either would contaminate THIS
        # challenger's shadow->canary disagreement score. The gate also
        # filters by shadow slot, but a blocked cycle's record must not
        # keep punishing (or excusing) every cycle after it.
        capture = getattr(self.client, "mirror_capture_path", None)
        if capture:
            try:
                os.remove(capture)
            except OSError:
                pass
        try:
            self._call(self.client.set_traffic, self.endpoint,
                       {old_slot: 100, new_slot: 0}, op="set_traffic")
            self._call(self.client.set_mirror_traffic, self.endpoint,
                       {new_slot: MIRROR_PERCENT},
                       op="set_mirror_traffic")
            # _record is inside the guard: its traffic reads can
            # flake too, and by now the mirror is live.
            self._record("shadow")
        except Exception:
            self.rollback(new_slot, old_slot, stage="shadow")
            raise

    # -- promotion gates ----------------------------------------------
    def _slot_package_dir(self, slot: str | None) -> str | None:
        """The package dir backing a deployed slot, when the client can
        say (the local client exposes ``deployment_package_dir``; cloud
        clients that cannot resolve it return None and the gate treats
        the champion as unresolvable)."""
        if slot is None:
            return None
        resolver = getattr(self.client, "deployment_package_dir", None)
        if resolver is None:
            return None
        try:
            return resolver(self.endpoint, slot)
        except Exception:  # noqa: BLE001 — unresolvable, not fatal
            return None

    def _consult_gate(self, to_stage: str, new_slot: str, old_slot: str | None) -> None:
        """Gatekeeper between stages: evaluate the challenger (new
        slot's package) against the champion (old slot's), put the
        decision on the record (the gate ledger), and on anything but
        promote revert traffic to the
        champion and raise :class:`GateRejection`.

        A gate CONSULT failure (the gate itself crashing) blocks the
        rollout too — a safety mechanism that breaks must fail closed.
        """
        if self.gate is None or old_slot is None:
            return
        from dct_tpu_torch.evaluation.gates import (
            GateDecision,
            GateRejection,
            record_decision,
        )

        challenger_dir = self._slot_package_dir(new_slot)
        champion_dir = self._slot_package_dir(old_slot)
        mirror_capture = getattr(self.client, "mirror_capture_path", None)
        if challenger_dir is None:
            # Cannot even locate what we'd be promoting: fail open
            # only if the gate says so.
            decision = GateDecision(
                "promote" if self.gate.cfg.fail_open else "hold",
                to_stage, "no_challenger_package",
            )
        else:
            try:
                decision = self.gate.evaluate(
                    challenger_dir=challenger_dir,
                    champion_dir=champion_dir,
                    stage=to_stage,
                    mirror_capture=mirror_capture,
                    shadow_slot=new_slot,
                )
            except Exception as e:  # noqa: BLE001 — fail closed
                decision = GateDecision(
                    "hold", to_stage, f"gate_error: {type(e).__name__}: {e}"
                )
        self.events.append(RolloutEvent(stage=f"gate_{to_stage}"))
        record_decision(
            decision, ledger_path=getattr(self.gate.cfg, "ledger_path", ""),
        )
        if not decision.promoted:
            self.rollback(new_slot, old_slot, stage=f"gate:{to_stage}")
            raise GateRejection(decision)

    def start_canary(self, new_slot: str, old_slot: str) -> None:
        # Shadow -> canary is the first gated transition: offline
        # champion/challenger eval + drift + shadow-traffic
        # disagreement. A failing gate reverts BEFORE any live traffic
        # reaches the challenger.
        self._consult_gate("canary", new_slot, old_slot)
        try:
            self._call(self.client.set_mirror_traffic, self.endpoint,
                       {}, op="set_mirror_traffic")
            self._call(
                self.client.set_traffic, self.endpoint,
                {
                    old_slot: 100 - CANARY_PERCENT,
                    new_slot: CANARY_PERCENT,
                },
                op="set_traffic",
            )
            # Inside the guard: a flake here would otherwise abort
            # the rollout with canary traffic still live.
            self._record("canary")
        except Exception:
            # Retries exhausted mid-canary: auto-revert to the prior
            # deployment, THEN surface the failure (the task goes
            # red, the endpoint stays safe on the old model).
            self.rollback(new_slot, old_slot, stage="canary")
            raise

    def full_rollout(self, new_slot: str, old_slot: str | None) -> None:
        # Canary -> full is the second gated transition (old_slot=None —
        # a first deployment — has no champion and passes ungated).
        self._consult_gate("full_rollout", new_slot, old_slot)
        try:
            self._call(self.client.set_traffic, self.endpoint,
                       {new_slot: 100}, op="set_traffic")
        except Exception:
            # The flip itself failed: revert. (A failure AFTER the
            # flip — old-slot deletion — does not revert: the new
            # model is live and healthy; the lingering old slot is
            # an operator cleanup, not a rollback.)
            self.rollback(new_slot, old_slot, stage="full_rollout")
            raise
        if old_slot and old_slot in self._call(
            self.client.list_deployments, self.endpoint,
            op="list_deployments",
        ):
            self._call(self.client.delete_deployment, self.endpoint,
                       old_slot, op="delete_deployment")
        self._record("full_rollout")

    def rollback(self, new_slot: str, old_slot: str | None, *, stage: str) -> None:
        """Auto-revert to the prior deployment: old slot back to 100%
        live, mirror cleared. Best-effort single-shot calls (no retry
        loop: the control plane just proved flaky, and every failed
        revert attempt is more time the canary serves traffic); the
        caller re-raises the failure either way. ``stage`` names the stage
        that failed (the reference's ``deploy.rollback`` event carries it:
        ROADMAP Queue A item 27)."""
        if old_slot:
            try:
                self.client.set_mirror_traffic(self.endpoint, {})
                self.client.set_traffic(self.endpoint, {old_slot: 100})
            except Exception:  # noqa: BLE001 — the caller re-raises its failure
                pass
        self.events.append(RolloutEvent(stage="rollback"))

    # -- the full machine ---------------------------------------------
    def run(self, package_dir: str) -> list[RolloutEvent]:
        new_slot, old_slot = self.deploy_new_slot(package_dir)
        if old_slot is not None:
            self.start_shadow(new_slot, old_slot)
            self.sleep_fn(self.soak_seconds)
            self.start_canary(new_slot, old_slot)
            self.sleep_fn(self.soak_seconds)
        self.full_rollout(new_slot, old_slot)
        return self.events

    def _record(self, stage: str) -> None:
        ev = RolloutEvent(
            stage=stage,
            traffic=dict(self._call(self.client.get_traffic, self.endpoint,
                                    op="get_traffic")),
            mirror=dict(self._call(self.client.get_mirror_traffic,
                                   self.endpoint, op="get_mirror_traffic")),
        )
        self.events.append(ev)
