"""The port's batch predict job against the reference's ``jobs/predict.py``
(CPU): on the same checkpoint and processed dir, the port's numpy engine
writes the reference job's columns with equal values; the torch engine is
within 1e-5 of them. The port writes through its own parquet codec.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dct_tpu_torch import predict_job
from dct_tpu_torch.checkpoint.manager import save_checkpoint
from dct_tpu_torch.data.synthetic import generate_weather_csv
from dct_tpu_torch.etl.parquet import read_table
from dct_tpu_torch.etl.preprocess import preprocess_csv_to_parquet
from dct_tpu_torch.models.registry import config_from_meta, get_model
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 256


@pytest.fixture(scope="module")
def processed_dir(tmp_path_factory):
    base = tmp_path_factory.mktemp("predict")
    raw = str(base / "raw" / "weather.csv")
    generate_weather_csv(raw, rows=520, seed=3)
    out = str(base / "processed")
    preprocess_csv_to_parquet(raw, out)
    return out


def _meta(family, horizon=1):
    if family == "weather_mlp":
        return {"model": family, "name": family, "input_dim": 5,
                "hidden_dim": 64, "num_classes": 2}
    return dict(model=family, name=family, input_dim=5, seq_len=S,
                d_model=32, n_heads=2, n_layers=2, d_ff=64, num_classes=2,
                horizon=horizon)


def _checkpoint(tmp_path, family, horizon=1, name="last.ckpt"):
    meta = _meta(family, horizon)
    torch.manual_seed(horizon + len(family))
    model = get_model(config_from_meta(meta), device="cpu")
    models = tmp_path / "models"
    return save_checkpoint(str(models / name), model, meta), str(models)


def _reference_job():
    spec = importlib.util.spec_from_file_location(
        "ref_predict_job", os.path.join(REPO, "jobs", "predict.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, monkeypatch, out, **env):
    for k in list(os.environ):
        if k.startswith("DCT_"):
            monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("DCT_PREDICTIONS", out)
    main()
    return read_table(out)


CASES = [("weather_mlp", 1), ("weather_transformer", 1),
         ("weather_transformer_causal", 2)]


@pytest.mark.parametrize("family,horizon", CASES)
def test_numpy_engine_equals_reference_job(family, horizon, processed_dir,
                                           tmp_path, monkeypatch):
    _, models = _checkpoint(tmp_path, family, horizon)
    env = dict(DCT_MODELS_DIR=models, DCT_PROCESSED_DIR=processed_dir,
               DCT_PREDICT_CHUNK="100")
    ref = _run(_reference_job().main, monkeypatch,
               str(tmp_path / "ref.parquet"), **env)
    ours = _run(predict_job.main, monkeypatch, str(tmp_path / "ours.parquet"),
                DCT_PREDICT_ENGINE="numpy", **env)
    assert list(ours) == list(ref)
    for col in ref:
        assert ours[col].dtype == ref[col].dtype, col
        assert np.array_equal(ours[col], ref[col]), col
    if horizon > 1:
        assert {"prob_h2_0", "pred_h2"} <= set(ours)
    torch_out = _run(predict_job.main, monkeypatch,
                     str(tmp_path / "torch.parquet"), DCT_DEVICE="cpu",
                     DCT_PREDICT_ENGINE="torch", **env)
    assert list(torch_out) == list(ref)
    for col in ref:
        if col.startswith("prob"):
            np.testing.assert_allclose(torch_out[col], ref[col], atol=1e-5)
    n = len(ref["row"])
    assert n == (520 - S if family != "weather_mlp" else 520)


def test_chunking_does_not_change_the_answer(processed_dir, tmp_path,
                                             monkeypatch):
    ckpt, _ = _checkpoint(tmp_path, "weather_transformer")
    runs = [_run(predict_job.main, monkeypatch,
                 str(tmp_path / f"c{chunk}.parquet"), DCT_CKPT=ckpt,
                 DCT_PROCESSED_DIR=processed_dir, DCT_PREDICT_ENGINE=engine,
                 DCT_DEVICE="cpu", DCT_PREDICT_CHUNK=str(chunk))
            for engine in ("numpy", "torch") for chunk in (37, 4096)]
    assert all(np.array_equal(runs[0][c], runs[1][c]) for c in runs[0])
    np.testing.assert_allclose(runs[2]["prob_1"], runs[3]["prob_1"],
                               atol=1e-6)


def test_checkpoint_choice_and_errors(processed_dir, tmp_path, monkeypatch):
    models = tmp_path / "models"
    monkeypatch.delenv("DCT_CKPT", raising=False)
    with pytest.raises(FileNotFoundError, match="No checkpoint"):
        predict_job.find_checkpoint(str(models))
    last, _ = _checkpoint(tmp_path, "weather_mlp")
    assert predict_job.find_checkpoint(str(models)) == last
    a, _ = _checkpoint(tmp_path, "weather_mlp", name="weather-best-0.1.ckpt")
    b, _ = _checkpoint(tmp_path, "weather_mlp", name="weather-best-0.9.ckpt")
    os.utime(a, (2e9, 2e9))  # newest by mtime, not by name
    assert predict_job.find_checkpoint(str(models)) == a
    monkeypatch.setenv("DCT_CKPT", str(tmp_path / "missing.ckpt"))
    with pytest.raises(FileNotFoundError, match="DCT_CKPT"):
        predict_job.find_checkpoint(str(models))
    env = {k: v for k, v in os.environ.items() if not k.startswith("DCT_")}
    env.update(PYTHONPATH=REPO, DCT_CKPT=b, DCT_PROCESSED_DIR=processed_dir,
               DCT_PREDICT_ENGINE="jax",
               DCT_PREDICTIONS=str(tmp_path / "x.parquet"))
    r = subprocess.run([sys.executable, "-m", "dct_tpu_torch.predict_job"],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "('torch', 'numpy')" in r.stderr
    env["DCT_PREDICT_ENGINE"] = "numpy"
    r = subprocess.run([sys.executable, "-m", "dct_tpu_torch.predict_job"],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "Wrote 520 predictions" in r.stdout
    table = read_table(str(tmp_path / "x.parquet"))
    assert set(table) == {"row", "predicted", "prob_0", "prob_1", "label"}
