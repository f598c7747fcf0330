"""Statistical promotion gates: paired bootstrap + sign test over the
harness's per-example loss deltas, thresholds, and a typed decision
(counterpart of ``dct_tpu/evaluation/gates.py``).

- **paired bootstrap**: resample the per-example loss deltas (champion -
  challenger) ``bootstrap_samples`` times and measure how often the
  challenger wins on the mean; seeded, so a decision is reproducible from
  its inputs;
- **sign test**: the per-example win count (exact binomial up to n = 200,
  normal approximation above), robust to heavy-tailed per-example NLLs;
- **thresholds**: ``min_improvement`` / ``max_regression`` on the mean
  delta, ``max_slice_regression`` on the worst per-slice regression,
  PSI/KS drift flags and the shadow stage's prediction disagreement.

The product is a :class:`GateDecision` (``promote`` / ``hold`` /
``rollback`` plus the evidence), which
:class:`~dct_tpu_torch.deploy.rollout.RolloutOrchestrator` consults between
stages and maps to ``rollback()`` on anything but promote. Every decision
is folded into a JSON ledger (:func:`record_decision`), rendered on the
serving tier's ``GET /metrics`` (:func:`render_gate_metrics`) and as a
``deploy_gate.prom`` textfile beside it, as the reference does
(``:525-601``). The ``eval.start`` / ``eval.report`` events are ROADMAP
Queue A item 27.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field

import numpy as np

PROMOTE, HOLD, ROLLBACK = "promote", "hold", "rollback"


class GateRejection(RuntimeError):
    """A promotion gate blocked the rollout; carries the decision."""

    def __init__(self, decision: "GateDecision"):
        self.decision = decision
        super().__init__(
            f"Promotion gate {decision.decision} at {decision.stage}: "
            f"{decision.reason}"
        )


@dataclass
class GateDecision:
    """Typed gate outcome with its evidence.

    ``promote``  — advance the rollout stage;
    ``hold``     — do not advance (insufficient/negative evidence that
                   is not a proven regression: drift, disagreement,
                   missing improvement under ``require_improvement``);
    ``rollback`` — the challenger demonstrably regresses; revert.

    The orchestrator treats hold and rollback identically for traffic
    safety (revert to the champion); the distinction is the operator's
    triage signal.
    """

    decision: str
    stage: str
    reason: str
    evidence: dict = field(default_factory=dict)

    @property
    def promoted(self) -> bool:
        return self.decision == PROMOTE

    def to_dict(self) -> dict:
        return {
            "decision": self.decision,
            "stage": self.stage,
            "reason": self.reason,
            "evidence": self.evidence,
        }


# ----------------------------------------------------------------------
# Statistics (pure, deterministic).

def paired_bootstrap(
    deltas: np.ndarray, *, n_boot: int = 1000, seed: int = 42
) -> dict:
    """Bootstrap distribution of the mean paired delta.

    Returns mean_delta, p_better (fraction of resample means > 0 — the
    challenger's win probability on the mean), and the central 90% band.
    Deterministic: seeded generator, vectorized resampling.
    """
    d = np.asarray(deltas, np.float64)
    n = len(d)
    if n == 0:
        return {"mean_delta": 0.0, "p_better": 0.5,
                "ci_low": 0.0, "ci_high": 0.0, "n": 0}
    rng = np.random.default_rng(seed)
    n_boot = int(n_boot)
    # Chunked resampling: one (n_boot, n) index matrix is multi-GB at
    # dataset-scale splits (100k examples x 1000 resamples), and an
    # OOM-killed gate reads as a fail-closed hold. Consecutive
    # generator draws consume the same stream as a single big one, so
    # the result is bit-identical for a given seed at any chunking.
    chunk = max(1, min(n_boot, 4_000_000 // max(n, 1) or 1))
    means = np.empty(n_boot, np.float64)
    done = 0
    while done < n_boot:
        k = min(chunk, n_boot - done)
        idx = rng.integers(0, n, size=(k, n))
        means[done:done + k] = d[idx].mean(axis=1)
        done += k
    lo, hi = np.quantile(means, [0.05, 0.95])
    return {
        "mean_delta": float(d.mean()),
        "p_better": float((means > 0.0).mean()),
        "ci_low": float(lo),
        "ci_high": float(hi),
        "n": int(n),
    }


def sign_test(deltas: np.ndarray) -> dict:
    """Sign test over the per-example win counts, both tails.

    Distribution-free companion to the bootstrap: per-example NLLs are
    heavy-tailed, and a handful of outliers can drag the mean either
    way; the win COUNT cannot be. ``p_value`` is the challenger-better
    tail P(wins >= observed | fair coin); ``p_worse`` the
    challenger-worse tail P(losses >= observed). Exact binomial for
    n <= 200 (math.comb — no scipy on serving images), normal
    approximation with continuity correction above.
    """
    d = np.asarray(deltas, np.float64)
    wins = int((d > 0).sum())
    losses = int((d < 0).sum())
    n = wins + losses  # ties carry no sign information
    if n == 0:
        return {"wins": 0, "losses": 0, "p_value": 1.0, "p_worse": 1.0}

    def tail(k: int) -> float:
        if n <= 200:
            p = sum(math.comb(n, j) for j in range(k, n + 1)) / 2.0 ** n
        else:
            z = (k - 0.5 - n / 2.0) / math.sqrt(n / 4.0)
            p = 0.5 * math.erfc(z / math.sqrt(2.0))
        return float(min(1.0, p))

    return {
        "wins": wins, "losses": losses,
        "p_value": tail(wins), "p_worse": tail(losses),
    }


# ----------------------------------------------------------------------
# The gate.

class PromotionGate:
    """Consulted by the rollout orchestrator between stages.

    Stateless over rollouts: every :meth:`evaluate` loads both models,
    runs the harness over the held-out split, applies the drift and
    disagreement detectors, and returns a :class:`GateDecision`. The
    heavy offline eval is cached in the challenger package
    (``eval_report.json``), so the DAG's ``evaluate_challenger`` task
    pays it once and the per-stage consults reuse it.
    """

    def __init__(self, cfg=None, *, processed_dir: str | None = None,
                 device=None):
        from dct_tpu_torch.config import (
            DataConfig,
            EvaluationConfig,
            TrainConfig,
        )

        self.cfg = cfg or EvaluationConfig.from_env()
        self.processed_dir = processed_dir or os.environ.get(
            "DCT_PROCESSED_DIR", "data/processed"
        )
        # The harness must rebuild the TRAINER's validation split, not
        # a default one: a rig trained under DCT_SEED=7 splits on a
        # different permutation, and scoring the challenger on rows it
        # trained on would bias the whole comparison optimistic. These
        # env-derived values are the FALLBACK; a challenger package
        # whose manifest stamps its split (prepare_package does) wins —
        # the gate process has no env inheritance from the training
        # launch.
        self.val_fraction = DataConfig.from_env().val_fraction
        self.split_seed = TrainConfig.from_env().seed
        # The device of the accelerator engine (``cuda:0`` when None).
        self.device = device

    def _split_for(self, challenger_dir: str) -> tuple[float, int]:
        """(val_fraction, seed) for the harness split: the challenger
        manifest's stamped values when present, env fallback."""
        from dct_tpu_torch.deploy.rollout import package_manifest

        split = package_manifest(challenger_dir).get("split") or {}
        try:
            vf = float(split["val_fraction"])
            seed = int(split["seed"])
            return vf, seed
        except (KeyError, TypeError, ValueError):
            return self.val_fraction, self.split_seed

    @classmethod
    def from_env(cls, *, device=None) -> "PromotionGate | None":
        from dct_tpu_torch.config import EvaluationConfig

        cfg = EvaluationConfig.from_env()
        return cls(cfg, device=device) if cfg.gate_enabled else None

    # -- evidence collection -------------------------------------------
    def offline_eval(
        self, challenger_dir: str, champion_dir: str | None,
    ) -> dict:
        """The offline harness pass: paired per-example losses + sliced
        metrics + bootstrap/sign statistics + drift vs the champion
        package's stamped data snapshot. Cached as
        ``eval_report.json`` inside the challenger package. Raises
        :class:`~dct_tpu_torch.evaluation.harness.EvalError` on missing
        prerequisites."""
        from dct_tpu_torch.evaluation import harness

        cache = os.path.join(challenger_dir, "eval_report.json")
        cached = self._read_cached_report(cache, champion_dir)
        if cached is not None:
            return cached

        champion = harness.load_model(champion_dir)
        challenger = harness.load_model(challenger_dir)
        val_fraction, split_seed = self._split_for(challenger_dir)
        data = self._load_data()
        pair = harness.evaluate_pair(
            champion, challenger, self.processed_dir,
            batch_size=self.cfg.eval_batch, engine=self.cfg.engine,
            val_fraction=val_fraction, seed=split_seed,
            data=data, device=self.device,
        )
        report = pair.to_dict()
        report["champion_dir"] = champion_dir
        if pair.paired:
            report["bootstrap"] = paired_bootstrap(
                pair.deltas,
                n_boot=self.cfg.bootstrap_samples, seed=self.cfg.seed,
            )
            report["sign_test"] = sign_test(pair.deltas)
        report["drift"] = self._drift_report(champion_dir, data=data)
        self._write_cached_report(cache, report)
        return report

    def _load_data(self):
        """One parquet load per evaluation, shared by the harness split
        and the drift report (dataset-scale splits must not pay the IO
        twice) — and cached across CONSECUTIVE evaluations by snapshot
        identity (dataset._snapshot_key: part-file name/mtime/size), so
        the always-on loop's repeated evals against one processed
        snapshot pay the parquet IO once. None when unavailable —
        callers degrade."""
        from dct_tpu_torch.data.dataset import load_processed_dataset_cached

        try:
            return load_processed_dataset_cached(self.processed_dir)
        except Exception:  # noqa: BLE001 — harness raises its own
            return None  # typed EvalError; drift just has no evidence

    def _drift_report(self, champion_dir: str | None, *, data=None) -> dict | None:
        """New ETL output vs the data snapshot stamped into the CHAMPION
        package (what the deployed model was trained on)."""
        from dct_tpu_torch.evaluation import drift as _drift

        if not champion_dir:
            return None
        snapshot = None
        try:
            with open(os.path.join(champion_dir, "run_info.json")) as f:
                snapshot = json.load(f).get("data_snapshot")
        except (OSError, ValueError):
            pass
        if not snapshot:
            return None
        if data is None:
            data = self._load_data()
        if data is None:
            return None
        # Align strictly BY NAME (the snapshot was taken from the same
        # loader, so names match on a healthy pipeline): a positional
        # fallback would compare renamed columns against the wrong
        # snapshot entries and silence exactly the schema drift the
        # detector exists to flag.
        return _drift.feature_drift(
            snapshot, data.features, list(data.feature_names),
            psi_threshold=self.cfg.psi_threshold,
            ks_threshold=self.cfg.ks_threshold,
        )

    def _read_cached_report(
        self, path: str, champion_dir: str | None
    ) -> dict | None:
        try:
            with open(path) as f:
                report = json.load(f)
        except (OSError, ValueError):
            return None
        # The cache is only valid against the same champion.
        if report.get("champion_dir") != champion_dir:
            return None
        return report

    @staticmethod
    def _write_cached_report(path: str, report: dict) -> None:
        try:
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(report, f, indent=2)
            os.replace(tmp, path)
        except (OSError, TypeError):
            pass  # caching is an optimization, never a blocker

    # -- decision ------------------------------------------------------
    def evaluate(
        self,
        *,
        challenger_dir: str,
        champion_dir: str | None,
        stage: str,
        mirror_capture: str | None = None,
        shadow_slot: str | None = None,
    ) -> GateDecision:
        """Full gate consult for one stage transition. Never raises:
        missing prerequisites resolve per ``fail_open``.
        ``shadow_slot`` scopes the mirror capture to pairs whose shadow
        really was this rollout's challenger slot."""
        from dct_tpu_torch.evaluation import drift as _drift
        from dct_tpu_torch.evaluation.harness import EvalError

        if not champion_dir or not os.path.exists(
            os.path.join(champion_dir, "model.npz")
        ) or os.path.abspath(champion_dir) == os.path.abspath(challenger_dir):
            # First deployment, a retired/wiped champion package, or a
            # reused package dir: nothing to compare against.
            return GateDecision(PROMOTE, stage, "no_champion")
        try:
            report = self.offline_eval(challenger_dir, champion_dir)
        except EvalError as e:
            dec = PROMOTE if self.cfg.fail_open else HOLD
            return GateDecision(
                dec, stage, f"no_eval_evidence: {e}",
                evidence={"fail_open": self.cfg.fail_open},
            )
        disagreement = None
        if stage == "canary":  # the shadow -> canary transition
            disagreement = _drift.disagreement_report(
                mirror_capture, max_disagreement=self.cfg.max_disagreement,
                shadow_slot=shadow_slot,
            )
        return self.decide(
            report, stage=stage, disagreement=disagreement
        )

    def decide(
        self, report: dict, *, stage: str, disagreement: dict | None = None
    ) -> GateDecision:
        """Pure decision over collected evidence (unit-testable without
        packages or data)."""
        cfg = self.cfg
        evidence = {
            "mean_delta": report.get("mean_delta", 0.0),
            "paired": report.get("paired", False),
            "champion_loss": report["champion"]["loss_mean"],
            "challenger_loss": report["challenger"]["loss_mean"],
            "slice_regressions": report.get("slice_regressions", {}),
        }
        boot = report.get("bootstrap")
        sign = report.get("sign_test")
        if boot:
            evidence["bootstrap"] = boot
        if sign:
            evidence["sign_test"] = sign
        drift_rep = report.get("drift")
        if drift_rep:
            evidence["drift"] = {
                "max_psi": drift_rep.get("max_psi", 0.0),
                "any_drift": drift_rep.get("any_drift", False),
            }
        if disagreement:
            evidence["disagreement"] = disagreement

        mean_delta = evidence["mean_delta"]
        alpha = 1.0 - cfg.confidence
        sig_boot_worse = boot is not None and boot["p_better"] <= alpha
        sig_sign_worse = (
            sign is not None and sign.get("p_worse", 1.0) <= alpha
        )
        # 1. Proven regression -> rollback. Paired evidence requires
        # either test (bootstrap mean OR per-example win count — the
        # sign test catches what a few champion outlier losses can hide
        # from the mean) to call the regression significant; unpaired
        # (family upgrade) falls back to the raw mean threshold.
        if boot is not None or sign is not None:
            significantly_worse = (
                mean_delta < -cfg.max_regression
                and (sig_boot_worse or sig_sign_worse)
            )
        else:
            significantly_worse = mean_delta < -max(
                cfg.max_regression, 1e-9
            )
        if significantly_worse:
            return GateDecision(
                ROLLBACK, stage, "challenger_regression", evidence
            )
        # 2. Slice regression beyond tolerance -> rollback (an aggregate
        # win must not hide the rain slice getting worse).
        worst = max(
            evidence["slice_regressions"].values(), default=0.0
        )
        if worst > cfg.max_slice_regression:
            return GateDecision(
                ROLLBACK, stage, "slice_regression", evidence
            )
        # 2b. Per-example regression the mean hides -> hold: the
        # challenger loses on a significant majority of examples while
        # the mean improvement is NOT significant (a handful of champion
        # outlier losses dragging the mean positive must not promote).
        if sig_sign_worse and not (
            boot is not None and boot["p_better"] >= cfg.confidence
        ):
            return GateDecision(
                HOLD, stage, "per_example_regression", evidence
            )
        # 3. Shadow disagreement over real mirrored traffic -> hold.
        if disagreement and disagreement.get("exceeded"):
            return GateDecision(
                HOLD, stage, "shadow_disagreement", evidence
            )
        # 4. Feature drift vs the champion's training snapshot -> hold
        # (the data moved; the offline comparison may not transfer).
        if drift_rep and drift_rep.get("any_drift"):
            return GateDecision(HOLD, stage, "data_drift", evidence)
        # 5. Optional improvement requirement.
        if cfg.require_improvement or cfg.min_improvement > 0:
            improved = mean_delta >= cfg.min_improvement and (
                boot is None or boot["p_better"] >= cfg.confidence
            )
            if not improved:
                return GateDecision(
                    HOLD, stage, "insufficient_improvement", evidence
                )
            return GateDecision(PROMOTE, stage, "improvement", evidence)
        return GateDecision(PROMOTE, stage, "no_regression", evidence)


def log_eval_report(tracker, report: dict, report_path: str) -> str | None:
    """Log an offline eval report to the tracking store as an artifact.

    Opens a short-lived run of its own (params kind=evaluation) holding
    the headline metrics plus the report file under artifact path
    ``evaluation``. It logs no ``val_loss``, so the deploy DAGs'
    best-run selection query can never pick it up. Returns the run id,
    or None when the report file is missing (nothing to log).
    """
    if not report_path or not os.path.exists(report_path):
        return None
    run_id = tracker.start_run(params={"kind": "evaluation"})
    try:
        tracker.log_metrics(
            {
                "eval_champion_loss": report["champion"]["loss_mean"],
                "eval_challenger_loss": report["challenger"]["loss_mean"],
                "eval_mean_delta": report["mean_delta"],
            },
            step=0,
        )
        tracker.log_artifact(report_path, "evaluation")
    except Exception:
        # Close the books before surfacing: a half-logged evaluation
        # must not linger as a phantom RUNNING run in the store (the
        # same leak class the trainer closes for preempt/health exits).
        try:
            tracker.end_run(status="FAILED")
        except Exception:  # noqa: BLE001 — bookkeeping must not mask
            pass
        raise
    tracker.end_run()
    return run_id


# ----------------------------------------------------------------------
# Decision ledger. The gate runs in the loop's evaluator (or a DAG task);
# a small JSON ledger keeps its counters for whoever reads them.

def gate_ledger_path(explicit: str = "") -> str:
    if explicit:
        return explicit
    if os.environ.get("DCT_GATE_LEDGER"):
        return os.environ["DCT_GATE_LEDGER"]
    from dct_tpu_torch.config import ObservabilityConfig

    return os.path.join(ObservabilityConfig.from_env().events_dir,
                        "gate_ledger.json")


def record_decision(
    decision: GateDecision, *, ledger_path: str = ""
) -> None:
    """Fold one decision into the ledger (decision counters + last
    decision + last drift PSI) and refresh the ``deploy_gate.prom``
    textfile beside it. Best-effort: telemetry never blocks a rollout."""
    path = gate_ledger_path(ledger_path)
    try:
        try:
            with open(path) as f:
                ledger = json.load(f)
        except (OSError, ValueError):
            ledger = {}
        counts = ledger.setdefault("decisions", {})
        counts[decision.decision] = int(counts.get(decision.decision, 0)) + 1
        ledger["last"] = {
            "decision": decision.decision,
            "stage": decision.stage,
            "reason": decision.reason,
        }
        drift = (decision.evidence or {}).get("drift")
        if drift is not None:
            ledger["max_psi"] = float(drift.get("max_psi", 0.0))
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(ledger, f, indent=2)
        os.replace(tmp, path)
        _write_gate_prom(ledger, os.path.join(
            os.path.dirname(path) or ".", "deploy_gate.prom"
        ))
    except OSError:
        pass


def render_gate_metrics(ledger_path: str = "") -> str:
    """Exposition-format text of the gate counters, appended to the
    serving server's ``GET /metrics`` body ("" when no ledger exists)."""
    try:
        with open(gate_ledger_path(ledger_path)) as f:
            ledger = json.load(f)
    except (OSError, ValueError):
        return ""
    return _gate_families_text(ledger)


def _gate_families_text(ledger: dict) -> str:
    from dct_tpu_torch.observability.prometheus import MetricFamily, render

    decisions = MetricFamily(
        "dct_deploy_gate_decisions_total", "counter",
        "Promotion-gate decisions by outcome (promote/hold/rollback).",
    )
    for name in (PROMOTE, HOLD, ROLLBACK):
        n = int((ledger.get("decisions") or {}).get(name, 0))
        decisions.add(n, {"decision": name})
    fams = [decisions]
    if "max_psi" in ledger:
        fams.append(
            MetricFamily(
                "dct_drift_psi", "gauge",
                "Max per-feature PSI of the latest gated evaluation "
                "(new ETL output vs the champion's training snapshot).",
            ).add(float(ledger["max_psi"]))
        )
    return render(fams)


def _write_gate_prom(ledger: dict, path: str) -> None:
    """The textfile-collector twin of the ``/metrics`` surface."""
    try:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(_gate_families_text(ledger))
        os.replace(tmp, path)
    except OSError:
        pass
