"""Deploy-side drift detection: PSI/KS against the package's stamped
training-data snapshot, plus shadow-stage prediction disagreement (a copy
of ``dct_tpu/evaluation/drift.py``).

Two detectors feed the promotion gates:

1. **Feature-distribution drift** — ``prepare_package`` stamps a
   quantile snapshot of the training data (per-feature bin edges +
   counts + moments) into the deploy package's manifest; before a new
   cycle's challenger advances, the NEW ETL output is compared against
   the snapshot the deployed champion was trained on. Per feature:
   PSI (population stability index over the snapshot's quantile bins —
   the industry drift metric: ~0.1 moderate, ~0.2 major shift) and the
   two-sample KS D-statistic (bin-free, catches shape changes PSI's
   binning can smear). This is a different, later gate than the
   ETL-side run-over-run stats compare in :mod:`dct_tpu_torch.etl.preprocess`
   — that one compares consecutive ETL runs, this one compares the
   serving-time world against what the champion actually learned from.

2. **Prediction disagreement** — during the shadow stage the endpoint
   mirrors a fraction of live traffic to the challenger;
   :class:`~dct_tpu_torch.deploy.local.LocalEndpointClient` (and the HTTP
   endpoint server) capture each mirrored pair of responses to a JSONL
   file. The disagreement rate (argmax mismatch) and mean total
   variation between the two models' probabilities over REAL traffic is
   the signal a held-out file cannot give — it feeds the shadow->canary
   gate.

Everything is plain numpy + stdlib (no scipy on the serving images).
"""

from __future__ import annotations

import json
import os

import numpy as np


# ----------------------------------------------------------------------
# Snapshot: what prepare_package stamps into the deploy manifest.

def snapshot_features(
    features: np.ndarray, names: list[str], *, bins: int = 10
) -> dict:
    """JSON-able training-data snapshot: per-feature quantile bin edges
    + counts + moments. Quantile (not uniform) edges: every bin holds
    ~1/bins of the training mass, which is what makes PSI's expected
    fractions well-conditioned."""
    out: dict = {"rows": int(len(features)), "bins": int(bins), "features": {}}
    for j, name in enumerate(names):
        col = np.asarray(features[:, j], np.float64)
        qs = np.quantile(col, np.linspace(0.0, 1.0, bins + 1))
        # Strictly-increasing edges (ties collapse bins for discrete or
        # constant features); outermost edges widen to +-inf at use.
        edges = np.unique(qs)
        if len(edges) <= 3:
            # Heavy collapse = a discrete feature: per-VALUE bins
            # (midpoint boundaries) keep PSI sensitive to e.g. a binary
            # rate shift that a single quantile bin would swallow. A
            # constant feature stays degenerate; the drift comparison
            # falls back to a moment check for it.
            vals = np.unique(col)
            if 2 <= len(vals) <= 16:
                edges = np.concatenate(
                    [[vals[0]], (vals[:-1] + vals[1:]) / 2.0, [vals[-1]]]
                )
        counts, _ = np.histogram(col, _open_edges(edges))
        out["features"][name] = {
            "mean": float(col.mean()),
            "std": float(col.std(ddof=1)) if len(col) > 1 else 0.0,
            "edges": [float(e) for e in edges],
            "counts": [int(c) for c in counts],
            # Point-mass features: the KS leg's bin-uniform CDF
            # reconstruction misstates them, so the detector runs PSI
            # only (the per-value bins keep PSI sharp there).
            "discrete": bool(len(np.unique(col)) <= 16),
        }
    return out


def _open_edges(edges: np.ndarray) -> np.ndarray:
    """Histogram edges with open outer bins so out-of-range serving
    values still land in a bin instead of silently dropping."""
    e = np.asarray(edges, np.float64).copy()
    if len(e) < 2:
        return np.array([-np.inf, np.inf])
    e[0], e[-1] = -np.inf, np.inf
    return e


def psi(expected_counts, actual_counts) -> float:
    """Population stability index between two binned distributions
    (epsilon-smoothed: an empty bin must not blow the sum to inf)."""
    e = np.asarray(expected_counts, np.float64)
    a = np.asarray(actual_counts, np.float64)
    e = np.maximum(e / max(e.sum(), 1.0), 1e-6)
    a = np.maximum(a / max(a.sum(), 1.0), 1e-6)
    return float(np.sum((a - e) * np.log(a / e)))


def ks_statistic(a: np.ndarray, b: np.ndarray) -> float:
    """Two-sample Kolmogorov-Smirnov D-statistic (max CDF gap)."""
    a = np.sort(np.asarray(a, np.float64))
    b = np.sort(np.asarray(b, np.float64))
    allv = np.concatenate([a, b])
    cdf_a = np.searchsorted(a, allv, side="right") / max(len(a), 1)
    cdf_b = np.searchsorted(b, allv, side="right") / max(len(b), 1)
    return float(np.abs(cdf_a - cdf_b).max()) if len(allv) else 0.0


def feature_drift(
    snapshot: dict,
    features: np.ndarray,
    names: list[str],
    *,
    psi_threshold: float = 0.2,
    ks_threshold: float = 0.15,
) -> dict:
    """Compare the new ETL output against the package's stamped
    training-data snapshot. Returns a JSON-able report with per-feature
    PSI/KS, ``max_psi`` (the /metrics gauge), and ``any_drift``.

    The KS leg compares the new sample against a synthetic sample drawn
    deterministically from the snapshot's binned distribution (the raw
    training column is not shipped in the manifest); with quantile bins
    the bin-uniform reconstruction is exact enough for a D-statistic
    threshold test.
    """
    feats: dict = {}
    any_drift = False
    snap_feats = (snapshot or {}).get("features", {})
    for j, name in enumerate(names):
        snap = snap_feats.get(name)
        col = np.asarray(features[:, j], np.float64)
        if snap is None:
            # Schema drift (feature added/renamed) IS drift.
            any_drift = True
            feats[name] = {"drifted": True, "missing_in_snapshot": True}
            continue
        edges = np.asarray(snap["edges"], np.float64)
        counts, _ = np.histogram(col, _open_edges(edges))
        p = psi(snap["counts"], counts)
        # The KS leg needs a faithful CDF reconstruction: the
        # bin-uniform sample misstates point masses — an i.i.d.
        # resample of a binary feature would read D ~ 0.5. PSI handles
        # discrete bins fine (per-value bins in the snapshot), so KS
        # only runs where the snapshot has real continuous support.
        continuous = len(edges) >= 4 and not snap.get("discrete")
        sample = _snapshot_sample(snap) if continuous else np.zeros(0)
        ks = ks_statistic(sample, col) if len(sample) else 0.0
        if len(edges) < 2 or (len(edges) == 2 and edges[0] == edges[-1]):
            # A feature that was CONSTANT at training time has one
            # degenerate bin, which blinds both PSI and KS: any value
            # change at all is drift by definition.
            drifted = bool(
                abs(col.mean() - snap["mean"]) > 1e-9 or col.std() > 1e-9
            )
        else:
            drifted = bool(p > psi_threshold or ks > ks_threshold)
        any_drift |= drifted
        feats[name] = {
            "psi": round(p, 4), "ks": round(ks, 4), "drifted": drifted,
        }
    # Features the champion trained on that the new ETL no longer
    # produces are schema drift too (the name-aligned loop above only
    # sees the CURRENT columns).
    for name in sorted(set(snap_feats) - set(names)):
        any_drift = True
        feats[name] = {"drifted": True, "missing_in_current": True}
    psis = [v["psi"] for v in feats.values() if "psi" in v]
    return {
        "psi_threshold": psi_threshold,
        "ks_threshold": ks_threshold,
        "features": feats,
        "max_psi": max(psis) if psis else 0.0,
        "any_drift": any_drift,
    }


def _snapshot_sample(snap: dict, per_bin: int = 32) -> np.ndarray:
    """Deterministic sample from a snapshot's binned distribution:
    ``per_bin`` evenly-spaced points per bin, weighted by repeating
    proportional to the bin count — enough support for a KS D test."""
    edges = np.asarray(snap["edges"], np.float64)
    counts = np.asarray(snap["counts"], np.float64)
    if len(edges) < 2 or counts.sum() <= 0:
        return np.zeros(0)
    total = counts.sum()
    parts = []
    for i in range(len(counts)):
        lo, hi = edges[i], edges[i + 1]
        if not (np.isfinite(lo) and np.isfinite(hi)):
            lo = edges[1] if not np.isfinite(lo) else lo
            hi = edges[-2] if not np.isfinite(hi) else hi
        reps = int(round(per_bin * len(counts) * counts[i] / total))
        if reps:
            parts.append(np.linspace(lo, hi, reps, endpoint=False))
    return np.concatenate(parts) if parts else np.zeros(0)


# ----------------------------------------------------------------------
# Prediction disagreement over mirrored shadow traffic.

def prediction_disagreement(
    live_probs: np.ndarray, shadow_probs: np.ndarray
) -> dict:
    """Disagreement between the champion's live responses and the
    challenger's mirrored ones: argmax mismatch rate + mean total
    variation distance."""
    live = np.asarray(live_probs, np.float64)
    shadow = np.asarray(shadow_probs, np.float64)
    n = min(len(live), len(shadow))
    if n == 0:
        return {"n": 0, "rate": 0.0, "mean_tv": 0.0}
    live, shadow = live[:n], shadow[:n]
    rate = float(
        (np.argmax(live, axis=-1) != np.argmax(shadow, axis=-1)).mean()
    )
    tv = float(0.5 * np.abs(live - shadow).sum(axis=-1).mean())
    return {"n": int(n), "rate": rate, "mean_tv": round(tv, 6)}


def read_mirror_capture(
    path: str, *, shadow_slot: str | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Parse a mirror-capture JSONL (LocalEndpointClient / endpoint
    server writers) into (live_probs, shadow_probs) row-aligned arrays.
    ``shadow_slot`` keeps only pairs mirrored to that slot (the gate
    must score THIS rollout's challenger, not every shadow ever
    captured). Torn trailing lines are skipped — capture is append-only
    telemetry."""
    live, shadow = [], []
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError:
        return np.zeros((0, 0)), np.zeros((0, 0))
    for line in lines:
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if shadow_slot is not None and rec.get("shadow_slot") != shadow_slot:
            continue
        lp, sp = rec.get("live_probs"), rec.get("shadow_probs")
        if lp and sp:
            # One capture record may carry a batch of rows.
            live.extend(lp)
            shadow.extend(sp)
    if not live:
        return np.zeros((0, 0)), np.zeros((0, 0))
    return np.asarray(live, np.float64), np.asarray(shadow, np.float64)


def disagreement_report(
    capture_path: str | None,
    *,
    max_disagreement: float = 0.25,
    shadow_slot: str | None = None,
) -> dict | None:
    """Shadow-stage disagreement report from a mirror capture file, or
    None when no capture exists (the gate treats that as no evidence,
    not as agreement)."""
    if not capture_path or not os.path.exists(capture_path):
        return None
    live, shadow = read_mirror_capture(capture_path, shadow_slot=shadow_slot)
    if len(live) == 0:
        return None
    rep = prediction_disagreement(live, shadow)
    rep["max_disagreement"] = max_disagreement
    if shadow_slot is not None:
        rep["shadow_slot"] = shadow_slot
    rep["exceeded"] = bool(rep["rate"] > max_disagreement)
    return rep
