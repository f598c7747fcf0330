"""The port's ``Trainer.fit`` against the JAX package's (CPU).

The same processed parquet (written by the reference's ETL) goes through
``dct_tpu.train.trainer.Trainer.fit`` on a one-device mesh and through
``dct_tpu_torch.train.trainer.Trainer.fit`` with ``device="cpu"``, from the
same initial weights (the reference's flax init, carried into the port by
patching ``init_flax_weights``), with dropout 0 so both draw the same
trajectory: per-epoch val_loss and the final parameters within 1e-5 of the
reference's (relative), on the scan path, the per-batch path and under
``epoch_chunk``; the small transformer within 1e-4 over one epoch; early
stopping at the reference's epoch. The data front, the config, the
tracking store, the entry point and the MLP model are held to their
counterparts too. The full 10-epoch val-parity protocol is the ``slow``
test at the end.
"""

import csv
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dct_tpu.config import DataConfig as JaxDataConfig
from dct_tpu.config import MeshConfig as JaxMeshConfig
from dct_tpu.config import ModelConfig as JaxModelConfig
from dct_tpu.config import ObservabilityConfig as JaxObsConfig
from dct_tpu.config import RunConfig as JaxRunConfig
from dct_tpu.config import TrainConfig as JaxTrainConfig
from dct_tpu.data import dataset as jax_dataset
from dct_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from dct_tpu.models.registry import get_model as jax_get_model
from dct_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dct_tpu.serving.score_gen import _flatten_params
from dct_tpu.tracking.client import LocalTracking as JaxLocalTracking
from dct_tpu.train import state as jax_state
from dct_tpu.train import trainer as jax_trainer
from dct_tpu_torch import convert
from dct_tpu_torch.config import DataConfig, ModelConfig, RunConfig
from dct_tpu_torch.config import TrainConfig
from dct_tpu_torch.data import dataset
from dct_tpu_torch.data.pipeline import BatchLoader
from dct_tpu_torch.models.registry import get_model
from dct_tpu_torch.tracking.client import LocalTracking
from dct_tpu_torch.train import steps
from dct_tpu_torch.train import trainer
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_TF = dict(seq_len=256, d_model=32, n_heads=2, n_layers=2, d_ff=64)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _jax_init(model_cfg: JaxModelConfig, input_dim: int, seed: int):
    """The reference's initial weights as a flat flax-path dict."""
    model = jax_get_model(model_cfg, input_dim=input_dim,
                          compute_dtype=jax.numpy.float32)
    shape = ((1, model_cfg.seq_len, input_dim)
             if model_cfg.name != "weather_mlp" else None)
    st = jax_state.create_train_state(model, input_dim=input_dim, lr=0.01,
                                      seed=seed, example_shape=shape)
    return _flatten_params(jax.device_get(st.params["params"]))


def _fit_both(tmp_path, monkeypatch, *, model: dict, train: dict,
              processed_dir=None, data=None, tag=""):
    """(port result, reference result) of one configuration."""
    jcfg = JaxRunConfig(
        data=JaxDataConfig(processed_dir=processed_dir or "",
                           models_dir=str(tmp_path / f"jm{tag}")),
        model=JaxModelConfig(**model),
        train=JaxTrainConfig(bf16_compute=False, **train),
        obs=JaxObsConfig(enabled=False),
    )
    mesh = jax_make_mesh(JaxMeshConfig(data=1), devices=jax.devices()[:1],
                         allow_subset=True)
    jdata = (jax_dataset.WeatherArrays(data.features, data.labels,
                                       data.feature_names)
             if data is not None else None)
    ref = jax_trainer.Trainer(
        jcfg, mesh=mesh,
        tracker=JaxLocalTracking(root=str(tmp_path / f"jr{tag}")),
    ).fit(jdata)
    input_dim = (data.input_dim if data is not None else
                 dataset.load_processed_dataset(processed_dir).input_dim)
    init = _jax_init(jcfg.model, input_dim, jcfg.train.seed)
    monkeypatch.setattr(convert, "init_flax_weights",
                        lambda model, seed: init)
    cfg = RunConfig(
        data=DataConfig(processed_dir=processed_dir or "",
                        models_dir=str(tmp_path / f"pm{tag}")),
        model=ModelConfig(**model),
        train=TrainConfig(bf16_compute=False, **train),
    )
    got = trainer.Trainer(
        cfg, device="cpu",
        tracker=LocalTracking(root=str(tmp_path / f"pr{tag}")),
    ).fit(data)
    return got, ref


def _params_rel(got, ref) -> dict:
    flat = convert.flax_weights(got.state.model)
    want = _flatten_params(jax.device_get(ref.state.params["params"]))
    assert sorted(flat) == sorted(want)
    return {k: _rel(flat[k], want[k]) for k in want}


MLP = dict(name="weather_mlp", dropout=0.0)


@pytest.mark.parametrize("path", [
    dict(use_scan=True),
    dict(use_scan=False),
    dict(use_scan=True, epoch_chunk=2),
])
def test_fit_mlp_matches_reference(processed_dir, tmp_path, monkeypatch,
                                   path):
    got, ref = _fit_both(tmp_path, monkeypatch, model=MLP,
                         train=dict(epochs=3, batch_size=8, **path),
                         processed_dir=processed_dir)
    assert [h["epoch"] for h in got.history] == [0, 1, 2]
    for g, r in zip(got.history, ref.history):
        for key in ("val_loss", "val_acc", "train_loss", "val_f1"):
            assert g[key] == pytest.approx(r[key], rel=1e-5, abs=1e-7), key
    errs = _params_rel(got, ref)
    assert max(errs.values()) <= 1e-5, errs
    assert os.path.basename(got.best_model_path) == os.path.basename(
        ref.best_model_path)
    assert got.samples_per_sec > 0


def _ar1_rows(n: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, 5), np.float32)
    noise = rng.standard_normal(rows.shape).astype(np.float32)
    for i in range(1, n):
        rows[i] = 0.9 * rows[i - 1] + 0.44 * noise[i]
    labels = (rows[:, 0] > 0).astype(np.int32)
    return dataset.WeatherArrays(rows, labels, [f"f{i}_norm" for i in range(5)])


def _k_bias_columns(n_heads, head_dim):
    """Columns of the fused qkv bias that belong to k (one KV group per
    head: q, k, v heads in turn)."""
    return np.concatenate([np.arange(head_dim) + (3 * h + 1) * head_dim
                           for h in range(n_heads)])


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_fit_transformer_one_epoch_matches_reference(tmp_path, monkeypatch,
                                                     optimizer):
    """One epoch of the small transformer (T=256, the flash path on both
    sides). The k bias of every qkv_proj has an analytically zero gradient
    (a constant added to every key shifts a score row uniformly, which
    softmax ignores): both sides' gradients there are rounding noise, which
    Adam turns into lr-sized steps of independent signs. Under Adam those
    columns are held to noise-level moves (within 2 lr per step of each
    other) and everything else to 1e-4; under SGD, whose update is
    linear in the gradient, every parameter is held to 1e-4."""
    data = _ar1_rows(1700)
    lr = 1e-3 if optimizer == "adam" else 0.05
    got, ref = _fit_both(
        tmp_path, monkeypatch,
        model=dict(name="weather_transformer", dropout=0.0, **SMALL_TF),
        train=dict(epochs=1, batch_size=64, lr=lr, optimizer=optimizer),
        data=data)
    g, r = got.history[0], ref.history[0]
    assert g["val_loss"] == pytest.approx(r["val_loss"], rel=1e-4)
    assert g["train_loss"] == pytest.approx(r["train_loss"], rel=1e-4)
    flat = convert.flax_weights(got.state.model)
    want = _flatten_params(jax.device_get(ref.state.params["params"]))
    kcols = _k_bias_columns(SMALL_TF["n_heads"],
                            SMALL_TF["d_model"] // SMALL_TF["n_heads"])
    for key, value in flat.items():
        ref_v = np.asarray(want[key])
        if optimizer == "adam" and key.endswith("qkv_proj/bias"):
            assert np.abs(value[kcols] - ref_v[kcols]).max() <= (
                2 * lr * got.state.step)
            value, ref_v = np.delete(value, kcols), np.delete(ref_v, kcols)
        assert _rel(value, ref_v) <= 1e-4, key


def test_early_stopping_stops_at_the_reference_epoch(processed_dir,
                                                      tmp_path, monkeypatch):
    got, ref = _fit_both(
        tmp_path, monkeypatch, model=MLP,
        train=dict(epochs=10, batch_size=16, early_stop_patience=1,
                   early_stop_min_delta=0.01),
        processed_dir=processed_dir)
    assert len(ref.history) < 10
    assert [h["epoch"] for h in got.history] == [
        h["epoch"] for h in ref.history]


def test_early_stop_update_and_optimizer_identity_match_reference():
    seq = [float("nan"), 0.5, 0.49, 0.495, 0.2, 0.3, 0.3, 0.3]
    a = b = (None, 0, False)
    for v in seq:
        a = trainer.early_stop_update(v, a[0], a[1], patience=2,
                                      min_delta=0.005)
        b = jax_trainer.early_stop_update(v, b[0], b[1], patience=2,
                                          min_delta=0.005)
        assert a == b
    for opt, wd, mom in (("Adam", 0.0, 0.0), ("adam", 0.1, 0.0),
                         ("adamw", 0.0, 0.0), ("sgd", 0.0, 0.9),
                         (" lion", 0.01, 0.0)):
        kw = dict(optimizer=opt, weight_decay=wd, momentum=mom)
        assert trainer.optimizer_identity(TrainConfig(**kw)) == \
            jax_trainer.optimizer_identity(JaxTrainConfig(**kw))


def test_multi_epoch_step_is_k_epoch_steps(processed_dir):
    data = dataset.load_processed_dataset(processed_dir)
    model_cfg = ModelConfig(name="weather_mlp", dropout=0.2)
    states = []
    for _ in range(2):
        model = get_model(model_cfg, input_dim=5, device="cpu")
        from dct_tpu_torch.train.state import create_train_state

        states.append(create_train_state(model, input_dim=5, lr=0.01,
                                         seed=1))
    loader = BatchLoader(data, np.arange(64), global_batch=8, shuffle=True)
    val = BatchLoader(data, np.arange(64, 90), global_batch=8,
                      shuffle=False).epoch_stacked(0)
    epochs = [loader.epoch_stacked(e) for e in range(2)]
    multi = steps.make_multi_epoch_train_eval_step(with_grad_norms=True)
    stacked = [np.stack([e[j] for e in epochs]) for j in range(3)]
    s0, losses, sums, gnorms = multi(states[0], *stacked, *val)
    assert losses.shape == (2, 8) and gnorms.shape == (2, 8)
    assert all(s.shape == (2,) for s in sums)
    one = steps.make_epoch_train_eval_step()
    for e in range(2):
        states[1], ls, sm = one(states[1], *epochs[e], *val)
        assert torch.equal(ls, losses[e])
        assert torch.equal(torch.stack(sm), torch.stack([s[e] for s in sums]))
    evals = steps.make_epoch_eval_step()(states[1], *val)
    assert torch.equal(torch.stack(evals), torch.stack([s[1] for s in sums]))
    for a, b in zip(s0.params, states[1].params):
        assert torch.equal(a, b)


# ------------------------------------------------------------ data front


def test_dataset_loader_matches_reference(processed_dir, tmp_path):
    got = dataset.load_processed_dataset(processed_dir)
    ref = jax_dataset.load_processed_dataset(processed_dir)
    assert got.feature_names == ref.feature_names
    np.testing.assert_array_equal(got.features, ref.features)
    np.testing.assert_array_equal(got.labels, ref.labels)
    idx = np.array([[3, 1], [7, 0]])
    np.testing.assert_array_equal(got.take(idx), ref.take(idx))
    cached = dataset.load_processed_dataset_cached(processed_dir)
    assert dataset.load_processed_dataset_cached(processed_dir) is cached
    with pytest.raises(FileNotFoundError, match="Data not found"):
        dataset.load_processed_dataset(str(tmp_path))


def test_batch_loader_epoch_matches_reference(weather_data):
    data = dataset.WeatherArrays(weather_data.features, weather_data.labels,
                                 list(weather_data.feature_names))
    idx = np.arange(3, 41)  # 38 rows: the last global batch is padded
    for pid in (0, 1):
        kw = dict(global_batch=8, shuffle=True, seed=5, num_processes=2,
                  process_id=pid)
        got = list(BatchLoader(data, idx, **kw).epoch(2))
        ref = list(JaxBatchLoader(weather_data, idx, **kw).epoch(2))
        assert len(got) == len(ref) == 5
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.x, r.x)
            np.testing.assert_array_equal(g.y, r.y)
            np.testing.assert_array_equal(g.weight, r.weight)
        xs, ys, ws = BatchLoader(data, idx, **kw).epoch_stacked(2)
        np.testing.assert_array_equal(xs, np.stack([g.x for g in got]))
        np.testing.assert_array_equal(ws, np.stack([g.weight for g in got]))


def test_synthetic_generator_is_a_verbatim_copy():
    with open(os.path.join(REPO, "dct_tpu", "data", "synthetic.py")) as f:
        ref = f.read()
    with open(os.path.join(REPO, "dct_tpu_torch", "data",
                           "synthetic.py")) as f:
        assert f.read() == ref


def test_read_etl_state_matches_reference(tmp_path):
    from dct_tpu.etl.preprocess import read_etl_state as ref
    from dct_tpu_torch.etl.preprocess import read_etl_state as got

    assert got(str(tmp_path)) == ref(str(tmp_path)) == {}
    for body in ('{"version": 1, "generation": 4, "arrival_ts": 2.5}',
                 '{"version": 2, "generation": 4}', "{torn"):
        (tmp_path / "etl_state.json").write_text(body)
        assert got(str(tmp_path)) == ref(str(tmp_path))


def test_run_config_reads_the_reference_environment(monkeypatch):
    env = {"DCT_EPOCHS": "7", "DCT_BATCH_SIZE": "16", "DCT_LR": "0.003",
           "DCT_OPTIMIZER": "sgd", "DCT_MOMENTUM": "0.9", "DCT_RESUME": "1",
           "DCT_BF16_COMPUTE": "0", "DCT_USE_SCAN": "false",
           "DCT_EPOCH_CHUNK": "3", "DCT_EARLY_STOP_PATIENCE": "2",
           "DCT_VAL_FRACTION": "0.25", "DCT_MODELS_DIR": "/m",
           "WORLD_SIZE": "2", "NODE_RANK": "1", "MASTER_ADDR": "10.0.0.2",
           "MLFLOW_TRACKING_URI": "http://x:5000", "DCT_MODEL": "weather_mlp"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, ref = RunConfig.from_env(), JaxRunConfig.from_env()
    import dataclasses

    for section in ("data", "model", "train", "dist", "tracking"):
        mine = dataclasses.asdict(getattr(got, section))
        theirs = dataclasses.asdict(getattr(ref, section))
        assert mine == {k: theirs[k] for k in mine}, section
    assert got.dist.coordinator_address == "10.0.0.2:29500"


def test_local_tracking_store_is_the_reference_layout(tmp_path):
    port = LocalTracking(root=str(tmp_path))
    for val in (0.4, 0.3):
        port.start_run(params={"lr": 0.01})
        port.log_metrics({"val_loss": val}, step=1)
        port.end_run()
    best = JaxLocalTracking(root=str(tmp_path)).search_best_run()
    assert best.metrics["val_loss"] == 0.3
    mine = port.search_best_run()
    assert (mine.run_id, mine.metrics) == (best.run_id, best.metrics)


def test_registry_builds_weather_mlp_with_the_flax_layout():
    from flax.traverse_util import flatten_dict

    from dct_tpu.models.mlp import WeatherMLP as JaxWeatherMLP

    model = get_model(ModelConfig(name="weather_mlp", hidden_dim=16),
                      input_dim=5, device="cpu")
    assert model.input_dim == 5 and not model.training
    ref = JaxWeatherMLP(input_dim=5, hidden_dim=16, dropout=0.2)
    x = np.random.default_rng(0).standard_normal((6, 5)).astype(np.float32)
    variables = ref.init(jax.random.PRNGKey(0), x)
    flat = {"/".join(k): np.asarray(v) for k, v in
            flatten_dict(variables["params"]).items()}
    convert.load_flax_weights(model, flat)
    assert sorted(convert.flax_weights(model)) == sorted(flat)
    want = np.asarray(ref.apply(variables, x))
    got = model(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_train_job_refuses_without_card_and_trains_on_cpu(processed_dir,
                                                          tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("DCT_")}
    env.update(PYTHONPATH=REPO, DCT_PROCESSED_DIR=processed_dir,
               DCT_MODELS_DIR=str(tmp_path / "m"),
               DCT_TRACKING_DIR=str(tmp_path / "r"), DCT_EPOCHS="1",
               DCT_BATCH_SIZE="32")
    cmd = [sys.executable, "-m", "dct_tpu_torch.train_job"]
    if not torch.cuda.is_available():
        r = subprocess.run(cmd, env=env, cwd=str(tmp_path),
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0 and "CUDA is not available" in r.stderr
    env["DCT_DEVICE"] = "cpu"
    r = subprocess.run(cmd, env=env, cwd=str(tmp_path), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "done: val_loss=" in r.stdout
    names = sorted(os.listdir(tmp_path / "m"))
    assert "last.ckpt" in names and any(n.startswith("weather-best-00-")
                                        for n in names)
    env["DCT_PROCESSED_DIR"] = str(tmp_path / "nope")
    r = subprocess.run(cmd, env=env, cwd=str(tmp_path), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 1 and "Data not found" in r.stderr


def test_train_job_refuses_a_rank_without_a_card(monkeypatch):
    """Rank r takes cuda:r; a rank past the last card is refused before
    any rendezvous, never wrapped onto a card another rank holds."""
    from dct_tpu_torch import train_job

    for k in list(os.environ):
        if k.startswith("DCT_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("NODE_RANK", "1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="process 1 has no card of its "
                       r"own: 1 CUDA device\(s\) for 2 processes"):
        train_job.main()


# ------------------------------------------------- the val-parity protocol


def _etl_like(csv_path: str) -> dataset.WeatherArrays:
    """The ETL's transform in numpy: per-column z-score with the sample
    std, ``Rain == "rain"`` -> 1."""
    with open(csv_path) as f:
        rows = list(csv.reader(f))[1:]
    x = np.array([[float(v) for v in r[:5]] for r in rows])
    x = ((x - x.mean(0)) / x.std(0, ddof=1)).astype(np.float32)
    y = np.array([r[5] == "rain" for r in rows], np.int32)
    return dataset.WeatherArrays(x, y, [f"c{i}_norm" for i in range(5)])


@pytest.mark.slow
def test_val_parity_protocol_against_reference(tmp_path, monkeypatch):
    """tests/test_val_parity.py's protocol (4000 rows, 10 epochs, batch 4,
    Adam lr 0.01, dropout 0.2, the seeded 80/20 split): both trainers
    learn the task and land in the 0.03 val_loss band of each other. The
    dropout streams differ across the frameworks, so the band is the
    claim."""
    from dct_tpu_torch.data.synthetic import generate_weather_csv

    data = _etl_like(generate_weather_csv(str(tmp_path / "w.csv"),
                                          rows=4000, seed=0))
    got, ref = _fit_both(tmp_path, monkeypatch,
                         model=dict(name="weather_mlp", dropout=0.2),
                         train=dict(epochs=10, batch_size=4), data=data)
    assert got.val_acc > 0.8 and ref.val_acc > 0.8
    assert abs(got.val_loss - ref.val_loss) < 0.03
