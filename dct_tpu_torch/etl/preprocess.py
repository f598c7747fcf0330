"""Native ETL: weather.csv -> normalized parquet, Spark-output-compatible
(counterpart of ``dct_tpu/etl/preprocess.py``).

The transform is the reference's: ``Rain == "rain" -> 1`` into
``label_encoded``; each feature z-scored with its mean and sample stddev
(ddof=1, Spark's ``stddev``) into ``<name>_norm``, a zero std divided as
1; the output, ``[*_norm, label_encoded]``, written as a Spark-style
directory ``<out>/data.parquet`` of part files with a ``_SUCCESS`` marker.
Beside it: ``stats.json`` (raw per-feature mean/std, rows, label rate),
``drift_report.json`` against the previous run's stats
(:func:`detect_drift`, ``DCT_DRIFT_THRESHOLD``), and in incremental mode
(``DCT_ETL_INCREMENTAL``, default on) ``etl_state.json``: the input's
content digest, cumulative Chan-merged moments, the frozen normalization
basis, the generation and the arrival time. An unchanged CSV is a no-op;
an append-only grown CSV transforms only the new rows into one new part
under the frozen basis; anything else (a rewrite, a truncation, a basis
stretched past ``DCT_ETL_REBUILD_TOL``) rebuilds in full, published by an
atomic directory swap.

What differs from the reference is the I/O, none of it in the results:
the CSV is parsed by the standard ``csv`` module into float64 (Python's
``float`` and pyarrow's double parser both round correctly, so the values
are the same bits; pyarrow's null tokens read as NaN, as pyarrow's nulls
do), and the parts are written by the port's own codec
(:mod:`dct_tpu_torch.etl.parquet`: PLAIN, uncompressed) instead of
``pyarrow``, which the port does not depend on. The lineage ledger
entries of each generation are ROADMAP Queue A item 29.
"""

from __future__ import annotations

import csv
import hashlib
import io
import json
import os
import shutil

import numpy as np

from dct_tpu_torch.etl import parquet

DEFAULT_FEATURES = ["Temperature", "Humidity", "Wind_Speed", "Cloud_Cover", "Pressure"]

#: Incremental-state schema version (bump on layout change: readers
#: treat an unknown version as "no state" and fall back to a full run).
ETL_STATE_VERSION = 1
ETL_STATE_NAME = "etl_state.json"

#: pyarrow's default CSV null tokens (``ConvertOptions.null_values``): a
#: numeric column reads them as NaN, as pyarrow's nulls become NaN there.
_NULL_TOKENS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "N/A", "NA", "NULL", "NaN", "n/a", "nan", "null",
})


def detect_drift(
    prev: dict, new: dict, *, threshold: float | None = None
) -> dict:
    """Compare two runs' raw-data statistics.

    Per feature: ``mean_shift`` = |mean_new - mean_prev| / max(σ_prev,
    1e-12) (standardized, so 'moved by half a previous-σ' means the same
    for every feature) and ``std_ratio`` = σ_new/σ_prev; plus the label
    positive-rate shift. A feature drifts when mean_shift > threshold or
    std_ratio is outside [1/(1+t), 1+t]; the label drifts when its rate
    moves by more than t/2 absolute. Returns a JSON-able report with
    ``any_drift`` for pipeline gates."""
    if threshold is None:
        threshold = float(os.environ.get("DCT_DRIFT_THRESHOLD", "0.5"))
    feats = {}
    any_drift = False
    prev_feats = prev.get("features", {})
    new_feats = new.get("features", {})
    for name in sorted(set(prev_feats) | set(new_feats)):
        p, n = prev_feats.get(name), new_feats.get(name)
        if p is None or n is None:
            # Schema drift (column added/renamed/dropped) IS drift — the
            # exact silently-shifted-data event this detector exists for.
            any_drift = True
            feats[name] = {
                "drifted": True,
                "missing_in": "previous" if p is None else "current",
            }
            continue
        values = (p["mean"], p["std"], n["mean"], n["std"])
        if not all(np.isfinite(v) for v in values):
            # NaN stats (nulls in the raw CSV) would make every
            # comparison False; broken data must read as drifted.
            any_drift = True
            feats[name] = {"drifted": True, "non_finite_stats": True}
            continue
        sigma = max(abs(p["std"]), 1e-12)
        mean_shift = abs(n["mean"] - p["mean"]) / sigma
        std_ratio = (abs(n["std"]) + 1e-12) / sigma
        drifted = bool(
            mean_shift > threshold
            or std_ratio > 1.0 + threshold
            or std_ratio < 1.0 / (1.0 + threshold)
        )
        any_drift |= drifted
        feats[name] = {
            "mean_shift": round(mean_shift, 4),
            "std_ratio": round(std_ratio, 4),
            "drifted": drifted,
        }
    label_shift = abs(
        new.get("label_rate", 0.0) - prev.get("label_rate", 0.0)
    )
    # Label rates live in [0, 1]: clamp the derived threshold so a large
    # sigma-unit knob cannot silently disable label-drift detection.
    label_drifted = bool(label_shift > min(threshold / 2, 0.25))
    any_drift |= label_drifted
    return {
        "threshold": threshold,
        "features": feats,
        "label_rate_shift": round(label_shift, 4),
        "label_drifted": label_drifted,
        "rows_prev": int(prev.get("rows", 0)),
        "rows_new": int(new.get("rows", 0)),
        "any_drift": any_drift,
    }


def _effective_size(path: str) -> int:
    """Bytes through the LAST newline — the prefix of the file that is
    complete rows. A concurrent appender (the always-on loop's staging
    writer) can be mid-write when we poll; an unterminated final line
    would otherwise parse as a silently-truncated-but-valid row. The
    dangling bytes are simply not this generation's data: the next poll
    picks them up once their newline lands."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        pos = size
        while pos > 0:
            step = min(pos, 1 << 14)
            f.seek(pos - step)
            chunk = f.read(step)
            nl = chunk.rfind(b"\n")
            if nl >= 0:
                return pos - step + nl + 1
            pos -= step
    return 0


def _digest_input(
    path: str, prefix_at: int | None = None, limit: int | None = None
) -> dict:
    """Streaming content digest of the raw input (first ``limit`` bytes;
    None = whole file): sha256 + size + whether the content ends in a
    newline, plus (when ``prefix_at`` falls inside) the sha256 of the
    FIRST ``prefix_at`` bytes — one read pass serves both the no-op
    check (full digest) and the append-only check (prefix digest vs the
    previous run's full digest)."""
    h = hashlib.sha256()
    prefix_hex = None
    seen = 0
    last_byte = b""
    remaining = limit
    with open(path, "rb") as f:
        while True:
            want = 1 << 20 if remaining is None else min(1 << 20, remaining)
            if want == 0:
                break
            chunk = f.read(want)
            if not chunk:
                break
            if remaining is not None:
                remaining -= len(chunk)
            if (
                prefix_at is not None
                and seen < prefix_at <= seen + len(chunk)
            ):
                h.update(chunk[: prefix_at - seen])
                prefix_hex = h.hexdigest()
                h.update(chunk[prefix_at - seen:])
            else:
                h.update(chunk)
            seen += len(chunk)
            last_byte = chunk[-1:]
    if prefix_at is not None and prefix_at == seen:
        prefix_hex = h.hexdigest()
    return {
        "size": seen,
        "sha256": h.hexdigest(),
        "prefix_sha256": prefix_hex,
        "newline_end": last_byte == b"\n",
    }


def read_etl_state(output_dir: str) -> dict:
    """The incremental-ETL state snapshot ({} when absent/torn/foreign
    version) — also the loop's source for ``generation``/``arrival_ts``
    freshness accounting. Readers consult this BEFORE loading the
    parquet, so a stamped generation never claims data the concurrent
    writer had not yet published."""
    path = os.path.join(output_dir, ETL_STATE_NAME)
    try:
        with open(path) as f:
            state = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(state, dict) or state.get("version") != ETL_STATE_VERSION:
        return {}
    return state


def _write_etl_state(output_dir: str, state: dict) -> None:
    path = os.path.join(output_dir, ETL_STATE_NAME)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(state, f, indent=2)
    os.replace(tmp, path)


def _chan_merge(a: dict, b: dict) -> dict:
    """Chan's parallel combine of two {n, mean, m2} moment sets — the
    numerically-stable way to merge the previous cumulative stats with a
    delta chunk's (naive sum/sumsq cancels catastrophically at weather
    magnitudes like pressure ~1013)."""
    n = a["n"] + b["n"]
    if n == 0:
        return {"n": 0, "mean": 0.0, "m2": 0.0}
    delta = b["mean"] - a["mean"]
    mean = a["mean"] + delta * (b["n"] / n)
    m2 = a["m2"] + b["m2"] + delta * delta * (a["n"] * b["n"] / n)
    return {"n": n, "mean": mean, "m2": m2}


def _moments(col: np.ndarray) -> dict:
    n = int(len(col))
    if n == 0:
        return {"n": 0, "mean": 0.0, "m2": 0.0}
    mean = float(np.mean(col))
    return {"n": n, "mean": mean, "m2": float(np.sum((col - mean) ** 2))}


def _moments_stats(m: dict) -> dict:
    """{mean, std(ddof=1)} from a moment set (the stats.json schema the
    drift detector compares)."""
    std = (m["m2"] / (m["n"] - 1)) ** 0.5 if m["n"] > 1 else 0.0
    return {"mean": float(m["mean"]), "std": float(std)}


def _rebuild_tolerance() -> float:
    return float(os.environ.get("DCT_ETL_REBUILD_TOL", "0.5"))


def _basis_stale(basis: dict, merged: dict, tol: float) -> bool:
    """True when the merged full-distribution stats have shifted far
    enough from the frozen normalization basis that appending more
    basis-normalized rows would misrepresent the data (same standardized
    thresholds as :func:`detect_drift`)."""
    for name, b in basis.items():
        m = merged.get(name)
        if m is None:
            return True
        sigma = max(abs(b["std"]), 1e-12)
        if abs(m["mean"] - b["mean"]) / sigma > tol:
            return True
        ratio = (abs(m["std"]) + 1e-12) / sigma
        if ratio > 1.0 + tol or ratio < 1.0 / (1.0 + tol):
            return True
    return False


def _parse_csv(data: bytes) -> dict[str, tuple]:
    """CSV bytes (a header line, then rows) -> ``{column: tuple of str}``."""
    rows = csv.reader(io.StringIO(data.decode("utf-8")))
    header = next(rows, None)
    if header is None:
        raise ValueError("CSV has no header line")
    columns = list(zip(*rows))
    if not columns:
        return {name: () for name in header}
    if len(columns) != len(header):
        raise ValueError(f"CSV rows have {len(columns)} fields, the header "
                         f"{len(header)}")
    return dict(zip(header, columns))


def _float_column(values: tuple) -> np.ndarray:
    """Column strings -> float64, correctly rounded; null tokens -> NaN."""
    try:
        return np.fromiter(map(float, values), np.float64, count=len(values))
    except ValueError:
        return np.fromiter(
            (np.nan if v in _NULL_TOKENS else float(v) for v in values),
            np.float64, count=len(values))


def _transform_columns(
    table: dict,
    feature_cols: list[str],
    label_col: str,
    positive_label: str,
    *,
    basis: dict | None = None,
) -> tuple[dict, dict, dict, np.ndarray]:
    """One chunk's transform: (out_cols, per-feature moments,
    norm basis used, label_encoded). ``basis=None`` derives the z-score
    basis from this chunk (the full-run path, reference semantics);
    a provided basis normalizes against frozen stats (the delta path)."""
    labels_raw = table[label_col]
    label_encoded = np.fromiter(
        (v == positive_label for v in labels_raw), np.bool_,
        count=len(labels_raw)).astype(np.int64)
    out_cols: dict[str, np.ndarray] = {}
    moments: dict[str, dict] = {}
    used_basis: dict[str, dict] = {}
    for name in feature_cols:
        col = _float_column(table[name])
        moments[name] = _moments(col)
        if basis is None:
            # Spark's stddev is the sample stddev (ddof=1).
            mean = float(np.mean(col))
            std = float(np.std(col, ddof=1)) if len(col) > 1 else 0.0
        else:
            mean = float(basis[name]["mean"])
            std = float(basis[name]["std"])
        used_basis[name] = {"mean": mean, "std": std}
        std = std if std != 0.0 else 1.0
        out_cols[f"{name}_norm"] = (col - mean) / std
    out_cols["label_encoded"] = label_encoded
    return out_cols, moments, used_basis, label_encoded


def _publish_part(parquet_dir: str, part_name: str, out_cols: dict) -> None:
    # Atomic (parquet.write_table writes a ``.tmp.<pid>`` sibling, then
    # os.replace): a concurrent reader's listing only ever sees complete
    # ``*.parquet`` files.
    parquet.write_table(os.path.join(parquet_dir, part_name), out_cols)


def _read_delta_table(input_csv: str, header: str, offset: int, end: int):
    """Parse only the appended tail: the stored header line + the bytes
    in ``[offset, end)`` (end = last complete line), through the same
    reader as the full path."""
    with open(input_csv, "rb") as f:
        f.seek(offset)
        tail = f.read(end - offset)
    return _parse_csv(header.encode() + tail)


def _read_csv_limited(input_csv: str, limit: int | None):
    """Parse the input, bounded to the first ``limit`` bytes (complete
    lines only: the incremental mode's concurrent-appender guard);
    ``limit=None`` reads the whole file."""
    with open(input_csv, "rb") as f:
        return _parse_csv(f.read() if limit is None else f.read(limit))


def _incremental_enabled(explicit: bool | None) -> bool:
    if explicit is not None:
        return explicit
    return os.environ.get("DCT_ETL_INCREMENTAL", "1").strip().lower() not in (
        "0", "false", "no",
    )


def preprocess_csv_to_parquet(
    input_csv: str,
    output_dir: str,
    *,
    feature_cols: list[str] | None = None,
    label_col: str = "Rain",
    positive_label: str = "rain",
    parquet_name: str = "data.parquet",
    incremental: bool | None = None,
) -> str:
    """Run the ETL transform; returns the parquet directory path.

    ``incremental=None`` reads ``DCT_ETL_INCREMENTAL`` (default on):
    unchanged input short-circuits to a no-op, append-only growth
    processes only the delta rows (module docstring); anything else —
    including ``incremental=False`` — runs the full transform.
    """
    feature_cols = feature_cols or DEFAULT_FEATURES
    if not os.path.exists(input_csv):
        raise FileNotFoundError(f"Raw data not found at {input_csv}")

    parquet_dir = os.path.join(output_dir, parquet_name)
    inc = _incremental_enabled(incremental)
    state = read_etl_state(output_dir) if inc else {}
    # Incremental mode only ever reads COMPLETE lines: a concurrent
    # appender's unterminated tail waits for the next poll.
    eff = _effective_size(input_csv) if inc else None
    prev_input = state.get("input") or {}
    prev_size = int(prev_input.get("size") or 0)
    digest = None
    if state and os.path.isdir(parquet_dir):
        digest = _digest_input(
            input_csv, prefix_at=prev_size if prev_size else None,
            limit=eff,
        )
        if (
            digest["size"] == prev_size
            and digest["sha256"] == prev_input.get("sha256")
            # A torn/hand-edited stats.json means the published snapshot
            # is not coherent: rebuild rather than no-op over it.
            and read_previous_stats(output_dir) is not None
        ):
            # Unchanged input: the published snapshot is already this
            # content's transform — nothing to parse, nothing to write.
            return parquet_dir
        if (
            digest["size"] > prev_size
            and prev_size > 0
            and digest["prefix_sha256"] == prev_input.get("sha256")
            and prev_input.get("newline_end")
            and state.get("header")
            and state.get("accum")
        ):
            delta_dir = _process_delta(
                input_csv, output_dir, parquet_dir, state, digest,
                feature_cols, label_col, positive_label,
            )
            if delta_dir is not None:
                return delta_dir
    return _process_full(
        input_csv, output_dir, parquet_dir, state, digest,
        feature_cols, label_col, positive_label,
        track_state=inc, limit=eff,
    )


def _header_line(input_csv: str) -> str:
    with open(input_csv, "rb") as f:
        return f.readline().decode()


def _accum_from(moments: dict, label_encoded: np.ndarray) -> dict:
    return {
        "features": moments,
        "label_pos": int(label_encoded.sum()),
        "rows": int(len(label_encoded)),
    }


def _stats_from_accum(accum: dict) -> dict:
    rows = int(accum["rows"])
    return {
        "rows": rows,
        "features": {
            name: _moments_stats(m) for name, m in accum["features"].items()
        },
        "label_rate": (accum["label_pos"] / rows) if rows else 0.0,
    }


def _process_full(
    input_csv: str,
    output_dir: str,
    parquet_dir: str,
    state: dict,
    digest: dict | None,
    feature_cols: list[str],
    label_col: str,
    positive_label: str,
    *,
    track_state: bool,
    limit: int | None = None,
) -> str:
    """The reference-semantics full transform (z-score basis = this
    content's own stats), published with an atomic directory swap so a
    concurrent reader never sees a partial snapshot."""
    table = _read_csv_limited(input_csv, limit)
    out_cols, moments, basis, label_encoded = _transform_columns(
        table, feature_cols, label_col, positive_label
    )
    accum = _accum_from(moments, label_encoded)
    stats = _stats_from_accum(accum)

    # Previous run's raw stats (read BEFORE anything is overwritten):
    # the drift baseline for continuous training's daily re-run.
    prev_stats = read_previous_stats(output_dir)

    # Build the new snapshot beside the live one, then swap: readers of
    # the live directory race only against two renames, never against
    # the parquet write itself (mode("overwrite") semantics preserved —
    # the previous output is gone when this returns).
    build_dir = f"{parquet_dir}.build.{os.getpid()}"
    if os.path.isdir(build_dir):
        shutil.rmtree(build_dir)
    os.makedirs(build_dir)
    _publish_part(build_dir, "part-00000.parquet", out_cols)
    # Spark writes a _SUCCESS marker on commit; downstream checks may rely on it.
    open(os.path.join(build_dir, "_SUCCESS"), "w").close()
    trash_dir = f"{parquet_dir}.old.{os.getpid()}"
    if os.path.isdir(trash_dir):
        shutil.rmtree(trash_dir)
    if os.path.isdir(parquet_dir):
        os.rename(parquet_dir, trash_dir)
    os.rename(build_dir, parquet_dir)
    if os.path.isdir(trash_dir):
        shutil.rmtree(trash_dir)

    persist_stats_and_drift(output_dir, stats, prev_stats)
    if not track_state:
        # A forced non-incremental rebuild rewrote the snapshot under a
        # NEW normalization basis; any earlier incremental state is now
        # a lie — a later incremental call trusting its prefix digest
        # would append delta rows that the rebuild already transformed
        # (duplicated rows under a mixed basis). Invalidate it so the
        # next incremental run starts from a fresh full pass.
        try:
            os.remove(os.path.join(output_dir, ETL_STATE_NAME))
        except OSError:
            pass
        return parquet_dir
    if digest is None:
        digest = _digest_input(input_csv, limit=limit)
    generation = int(state.get("generation") or 0) + 1
    _write_etl_state(output_dir, {
        "version": ETL_STATE_VERSION,
        "generation": generation,
        "mode": "full",
        "input": {
            "size": digest["size"],
            "sha256": digest["sha256"],
            "newline_end": digest["newline_end"],
        },
        "header": _header_line(input_csv),
        "arrival_ts": os.path.getmtime(input_csv),
        "parts": 1,
        "rows": stats["rows"],
        "norm_basis": basis,
        "accum": accum,
        # The snapshot's lineage node (the reference's _record_lineage,
        # dct_tpu/etl/preprocess.py:542) is ROADMAP Queue A item 29.
        "lineage_node": None,
    })
    return parquet_dir


def _process_delta(
    input_csv: str,
    output_dir: str,
    parquet_dir: str,
    state: dict,
    digest: dict,
    feature_cols: list[str],
    label_col: str,
    positive_label: str,
) -> str | None:
    """Append-only growth: transform only the tail rows into a new part
    file under the frozen normalization basis. Returns None when the
    delta would stretch the basis past ``DCT_ETL_REBUILD_TOL`` (the
    caller then runs the full rebuild) — correctness over speed."""
    basis = state.get("norm_basis") or {}
    prev_accum = state.get("accum") or {}
    if set(basis) != set(feature_cols) or set(
        prev_accum.get("features") or {}
    ) != set(feature_cols):
        return None  # schema changed under the state: rebuild
    table = _read_delta_table(
        input_csv, state["header"], int(state["input"]["size"]),
        int(digest["size"]),
    )
    out_cols, delta_moments, _, delta_labels = _transform_columns(
        table, feature_cols, label_col, positive_label, basis=basis
    )
    merged_features = {
        name: _chan_merge(prev_accum["features"][name], delta_moments[name])
        for name in feature_cols
    }
    merged_stats_by_name = {
        name: _moments_stats(m) for name, m in merged_features.items()
    }
    if _basis_stale(basis, merged_stats_by_name, _rebuild_tolerance()):
        return None
    accum = {
        "features": merged_features,
        "label_pos": int(prev_accum["label_pos"]) + int(delta_labels.sum()),
        "rows": int(prev_accum["rows"]) + int(len(delta_labels)),
    }
    stats = _stats_from_accum(accum)
    prev_stats = read_previous_stats(output_dir)

    part_index = int(state.get("parts") or 1)
    _publish_part(parquet_dir, f"part-{part_index:05d}.parquet", out_cols)
    # Ordering: part published BEFORE stats/state, so a reader that saw
    # generation N in the state can always load generation N's rows.
    persist_stats_and_drift(output_dir, stats, prev_stats)
    generation = int(state.get("generation") or 0) + 1
    _write_etl_state(output_dir, {
        "version": ETL_STATE_VERSION,
        "generation": generation,
        "mode": "delta",
        "input": {
            "size": digest["size"],
            "sha256": digest["sha256"],
            "newline_end": digest["newline_end"],
        },
        "header": state["header"],
        "arrival_ts": os.path.getmtime(input_csv),
        "parts": part_index + 1,
        "rows": stats["rows"],
        "rows_delta": int(len(delta_labels)),
        "norm_basis": basis,
        "accum": accum,
        # The snapshot's lineage node (the reference's _record_lineage,
        # dct_tpu/etl/preprocess.py:542) is ROADMAP Queue A item 29.
        "lineage_node": None,
    })
    return parquet_dir


def read_previous_stats(output_dir: str) -> dict | None:
    """The previous run's stats.json, or None when absent/torn — a torn
    baseline (killed mid-write before atomic writes, or hand-edited)
    must not brick the daily ETL over an observability feature."""
    stats_path = os.path.join(output_dir, "stats.json")
    if not os.path.exists(stats_path):
        return None
    try:
        with open(stats_path) as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError):
        return None


def persist_stats_and_drift(
    output_dir: str, stats: dict, prev_stats: dict | None
) -> dict | None:
    """Atomically write stats.json and (when a baseline exists) the
    drift_report.json + console warning. Shared by the native and Spark
    ETL paths — both engines compute the same per-feature mean/std, so
    the drift logic lives once. Returns the report (or None)."""
    stats_path = os.path.join(output_dir, "stats.json")
    # Atomic: a run killed mid-write must not leave a torn baseline.
    tmp_stats = stats_path + ".tmp"
    with open(tmp_stats, "w") as f:
        json.dump(stats, f, indent=2)
    os.replace(tmp_stats, stats_path)
    if prev_stats is None:
        return None
    report = detect_drift(prev_stats, stats)
    report_path = os.path.join(output_dir, "drift_report.json")
    tmp_report = report_path + ".tmp"
    with open(tmp_report, "w") as f:
        json.dump(report, f, indent=2)
    os.replace(tmp_report, report_path)
    if report["any_drift"]:
        drifted = [k for k, v in report["features"].items() if v["drifted"]]
        if report["label_drifted"]:
            drifted.append("label_rate")
        print(
            f"⚠ DATA DRIFT vs previous run (threshold "
            f"{report['threshold']}): {', '.join(drifted)} — see "
            f"{report_path}",
            flush=True,
        )
    return report
