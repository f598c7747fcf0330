"""The port's ETL against the reference's (CPU), on the same CSVs.

The cases of ``tests/test_etl.py``: a full run, an unchanged input (no-op),
an append (only the delta, as a new part), a rewrite and a basis-stretching
append (full rebuilds), a forced full run (the incremental state dies), and
the drift report. After each step both processed dirs hold the same part
files with bit-equal columns and dtypes, and ``etl_state.json``,
``stats.json`` and ``drift_report.json`` equal (no field of them is a
clock reading; ``arrival_ts`` is the CSV's mtime, the same file for both).
Then the job entry point, ``python -m dct_tpu_torch.preprocess_job``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pyarrow.parquet as pq
import pytest

from dct_tpu.data.synthetic import append_weather_rows, generate_weather_csv
from dct_tpu.etl import preprocess as ref_etl
from dct_tpu.observability import lineage as ref_lineage
from dct_tpu_torch.etl import preprocess as etl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JSONS = ("etl_state.json", "stats.json", "drift_report.json")


@pytest.fixture(autouse=True)
def _no_reference_lineage(monkeypatch):
    # The reference's lineage ledger (default on) would write under the
    # working directory and stamp a node id into its state; the port's
    # lineage is not ported (its state holds None), so both run without.
    # A ledger an earlier test installed as the process default would
    # override the env switch.
    monkeypatch.setenv("DCT_LINEAGE", "0")
    monkeypatch.setattr(ref_lineage, "_explicit", None)


def _both(csv, base, **kwargs) -> tuple[str, str]:
    ref, port = str(base / "ref"), str(base / "port")
    ref_etl.preprocess_csv_to_parquet(csv, ref, **kwargs)
    etl.preprocess_csv_to_parquet(csv, port, **kwargs)
    return ref, port


def _assert_same(ref: str, port: str) -> dict:
    rd, pd = (os.path.join(d, "data.parquet") for d in (ref, port))
    names = sorted(os.listdir(rd))
    assert sorted(os.listdir(pd)) == names
    for name in names:
        if not name.endswith(".parquet"):
            continue
        a, b = pq.read_table(os.path.join(rd, name)), pq.read_table(
            os.path.join(pd, name))
        assert a.column_names == b.column_names
        for col in a.column_names:
            x, y = a.column(col).to_numpy(), b.column(col).to_numpy()
            assert x.dtype == y.dtype and np.array_equal(
                x.view(np.uint8), y.view(np.uint8)), (name, col)
    docs = {}
    for name in JSONS:
        exists = os.path.exists(os.path.join(ref, name))
        assert os.path.exists(os.path.join(port, name)) == exists, name
        if exists:
            with open(os.path.join(ref, name)) as f:
                want = json.load(f)
            with open(os.path.join(port, name)) as f:
                got = json.load(f)
            assert got == want, name
            docs[name] = got
    return docs


def test_full_noop_append_rebuild_forced_equal_reference(tmp_path):
    csv = generate_weather_csv(str(tmp_path / "raw.csv"), rows=700, seed=3)
    ref, port = _both(csv, tmp_path)
    docs = _assert_same(ref, port)
    state = docs["etl_state.json"]
    assert state["generation"] == 1 and state["mode"] == "full"
    assert state["lineage_node"] is None

    # An mtime touch: the content digest says no-op, nothing is rewritten.
    part0 = os.path.join(port, "data.parquet", "part-00000.parquet")
    before = os.stat(part0).st_mtime_ns
    os.utime(csv)
    _both(csv, tmp_path)
    assert etl.read_etl_state(port)["generation"] == 1
    assert os.stat(part0).st_mtime_ns == before
    _assert_same(ref, port)

    # Append-only growth: one new part under the frozen basis; part 0's
    # bytes are untouched.
    part0_bytes = open(part0, "rb").read()
    append_weather_rows(csv, rows=250, seed=4)
    _both(csv, tmp_path)
    docs = _assert_same(ref, port)
    state = docs["etl_state.json"]
    assert (state["mode"], state["generation"], state["rows"],
            state["rows_delta"], state["parts"]) == ("delta", 2, 950, 250, 2)
    assert open(part0, "rb").read() == part0_bytes
    assert not docs["drift_report.json"]["any_drift"]

    # A rewrite (not append-only): a full rebuild to a single part.
    with open(csv) as f:
        lines = f.readlines()
    lines[1] = lines[1].replace(lines[1].split(",")[0], "99.0", 1)
    with open(csv, "w") as f:
        f.writelines(lines)
    _both(csv, tmp_path)
    state = _assert_same(ref, port)["etl_state.json"]
    assert (state["mode"], state["generation"]) == ("full", 3)
    assert os.listdir(os.path.join(port, "data.parquet")).count(
        "part-00001.parquet") == 0

    # An append shifted by many sigma: append-only in bytes, but the
    # merged stats leave DCT_ETL_REBUILD_TOL, so a full rebuild.
    header, *rows = lines
    shifted = []
    for line in rows[:300]:
        vals = line.rstrip("\n").split(",")
        vals[0] = f"{float(vals[0]) + 200.0:.4f}"
        shifted.append(",".join(vals) + "\n")
    with open(csv, "a") as f:
        f.writelines(shifted)
    _both(csv, tmp_path)
    docs = _assert_same(ref, port)
    assert docs["etl_state.json"]["mode"] == "full"
    assert docs["etl_state.json"]["generation"] == 4
    assert docs["drift_report.json"]["features"]["Temperature"]["drifted"]

    # A forced full run invalidates the incremental state on both sides.
    append_weather_rows(csv, rows=100, seed=5)
    _both(csv, tmp_path, incremental=False)
    _assert_same(ref, port)
    assert etl.read_etl_state(port) == ref_etl.read_etl_state(ref) == {}
    append_weather_rows(csv, rows=50, seed=6)
    _both(csv, tmp_path, incremental=True)
    docs = _assert_same(ref, port)
    assert docs["etl_state.json"]["generation"] == 1


def test_drift_report_between_runs_equals_reference(tmp_path):
    csv1 = generate_weather_csv(str(tmp_path / "raw1.csv"), rows=600, seed=1)
    ref, port = _both(csv1, tmp_path)
    assert not os.path.exists(os.path.join(port, "drift_report.json"))
    _both(csv1, tmp_path, incremental=False)
    assert not _assert_same(ref, port)["drift_report.json"]["any_drift"]
    # Temperature shifted by several sigma.
    with open(csv1) as f:
        header, *rows = f.readlines()
    out = [header]
    for line in rows:
        vals = line.rstrip("\n").split(",")
        vals[0] = f"{float(vals[0]) + 40.0:.4f}"
        out.append(",".join(vals) + "\n")
    csv2 = str(tmp_path / "raw2.csv")
    with open(csv2, "w") as f:
        f.writelines(out)
    _both(csv2, tmp_path)
    rep = _assert_same(ref, port)["drift_report.json"]
    assert rep["any_drift"] and rep["features"]["Temperature"]["drifted"]
    assert not rep["features"]["Humidity"]["drifted"]


def test_detect_drift_and_edge_cases_equal_reference(tmp_path):
    prev = {"rows": 100, "label_rate": 0.3,
            "features": {"a": {"mean": 0.0, "std": 1.0}}}
    cases = [
        {"rows": 100, "label_rate": 0.3,
         "features": {"a": {"mean": 0.0, "std": 2.0}}},
        {"rows": 100, "label_rate": 0.6,
         "features": {"a": {"mean": 0.0, "std": 1.0}}},
        {"rows": 10, "label_rate": 0.3,
         "features": {"b": {"mean": 0.0, "std": 1.0}}},
        {"rows": 10, "label_rate": 0.3,
         "features": {"a": {"mean": float("nan"), "std": 1.0}}},
    ]
    for new in cases:
        for t in (0.5, 10.0):
            assert etl.detect_drift(prev, new, threshold=t) == \
                ref_etl.detect_drift(prev, new, threshold=t)
    # A torn baseline does not brick the ETL (both sides).
    csv = generate_weather_csv(str(tmp_path / "raw.csv"), rows=300, seed=2)
    ref, port = _both(csv, tmp_path)
    for d in (ref, port):
        with open(os.path.join(d, "stats.json"), "w") as f:
            f.write('{"rows": 3')
    _both(csv, tmp_path)
    assert _assert_same(ref, port)["stats.json"]["rows"] == 300
    with pytest.raises(FileNotFoundError):
        etl.preprocess_csv_to_parquet(str(tmp_path / "nope.csv"),
                                      str(tmp_path / "o"))


def test_csv_null_tokens_read_as_nan_like_pyarrow(tmp_path):
    csv = str(tmp_path / "nulls.csv")
    with open(csv, "w") as f:
        f.write("Temperature,Humidity,Wind_Speed,Cloud_Cover,Pressure,Rain\n")
        f.write("1.5,NA,3,4,1013.25,rain\n")
        f.write(",2.0,3,4,1012,no rain\n")
        f.write("2.5,3.0,3,4,1011,rain\n")
    ref, port = _both(csv, tmp_path, incremental=False)
    _assert_same(ref, port)


def test_preprocess_job_runs_native_and_refuses_spark(tmp_path):
    csv = generate_weather_csv(str(tmp_path / "raw.csv"), rows=400, seed=8)
    env = {k: v for k, v in os.environ.items() if not k.startswith("DCT_")}
    env.update(PYTHONPATH=REPO, DCT_RAW_CSV=csv, DCT_LINEAGE="0",
               DCT_PROCESSED_DIR=str(tmp_path / "port"))
    r = subprocess.run([sys.executable, "-m", "dct_tpu_torch.preprocess_job"],
                       env=env, cwd=str(tmp_path), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "Preprocessing complete" in r.stdout
    ref_etl.preprocess_csv_to_parquet(csv, str(tmp_path / "ref"))
    _assert_same(str(tmp_path / "ref"), str(tmp_path / "port"))
    env["DCT_ETL_ENGINE"] = "spark"
    r = subprocess.run([sys.executable, "-m", "dct_tpu_torch.preprocess_job"],
                       env=env, cwd=str(tmp_path), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0 and "pyspark" in r.stderr
