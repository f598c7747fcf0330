"""The port's GRU family against the JAX package's (CPU).

``dct_tpu_torch.models.gru`` is held to ``dct_tpu.models.gru`` on the same
numpy inputs from a flax init carried across with ``load_flax_weights``:
the forward in f32 (1e-5) and bf16 compute (2e-2), the train objective's
gradients (1e-4 of each one's max), three Adam steps of the train body
against ``dct_tpu.train.steps``; ``torch.nn.GRU`` loaded with the same
weights is a second oracle. Then the family's path through the entry
points: the converter both ways, ``train_job``, the package written by the
port's ``score_gen`` served by the port's HTTP server (torch engine) and
scored by ``predict_job``, each against the port's numpy runtime.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_tpu.config import ModelConfig as JaxModelConfig
from dct_tpu.models.registry import get_model as jax_get_model
from dct_tpu.ops import losses as jax_losses
from dct_tpu.serving.score_gen import _flatten_params
from dct_tpu.train import state as jax_state
from dct_tpu.train import steps as jax_steps
from dct_tpu_torch.config import ModelConfig
from dct_tpu_torch.convert import (
    flax_shapes,
    flax_weights,
    init_flax_weights,
    load_flax_weights,
)
from dct_tpu_torch.models.gru import WeatherGRU
from dct_tpu_torch.models.registry import get_model
from dct_tpu_torch.train import state as port_state
from dct_tpu_torch.train import steps
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(name="weather_gru", seq_len=24, hidden_dim=16, n_layers=2)
F_IN = 5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel(got, ref) -> float:
    got, ref = _np(got), _np(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _pair(*, compute=None, dropout=0.0, lr=1e-3, seed=0):
    fields = dict(SMALL, dropout=dropout)
    jmodel = jax_get_model(JaxModelConfig(**fields), input_dim=F_IN,
                           compute_dtype=compute and jnp.bfloat16)
    jst = jax_state.create_train_state(
        jmodel, input_dim=F_IN, lr=lr, seed=seed,
        example_shape=(1, SMALL["seq_len"], F_IN))
    tmodel = get_model(ModelConfig(**fields), input_dim=F_IN, device="cpu",
                       compute_dtype=compute and torch.bfloat16)
    tst = port_state.create_train_state(tmodel, input_dim=F_IN, lr=lr,
                                        seed=seed)
    load_flax_weights(tmodel, _flatten_params(jst.params["params"]))
    return jst, tst


def _batch(seed=3, b=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, SMALL["seq_len"], F_IN)).astype(np.float32)
    y = rng.integers(0, 2, (b,)).astype(np.int32)
    w = np.ones(b, np.float32)
    w[-1] = 0.0
    return x, y, w


@pytest.mark.parametrize("compute,tol", [(None, 1e-5), ("bf16", 2e-2)])
def test_forward_matches_jax(compute, tol):
    jst, tst = _pair(compute=compute)
    x, _, _ = _batch(b=5)
    want = np.asarray(jst.apply_fn(jst.params, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tst.model(torch.from_numpy(x))
    assert got.dtype == torch.float32
    if compute:
        assert tst.model.gru_1.compute_dtype == torch.bfloat16
    assert np.abs(_np(got) - want).max() <= tol


def test_gradients_and_three_adam_steps_match_jax():
    jst, tst = _pair()
    x, y, w = _batch()

    def loss_fn(params):
        logits = jst.apply_fn(params, x, train=True,
                              rngs={"dropout": jst.rng})
        loss_sum, count = jax_losses.masked_cross_entropy(logits, y, w)
        return loss_sum / jnp.maximum(count, 1.0)

    jloss, jgrads = jax.value_and_grad(loss_fn)(jst.params)
    jgrads = _flatten_params(jgrads["params"])
    tloss, tgrads = steps.loss_and_grads(tst, x, y, w)
    for p, g in zip(tst.params, tgrads):
        p.grad = g
    tgrads = flax_weights(tst.model, grads=True)
    for p in tst.params:
        p.grad = None
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    assert set(tgrads) == set(jgrads)
    for key in jgrads:
        assert _rel(tgrads[key], jgrads[key]) <= 1e-4, key
    jstep = jax_steps.make_train_step(donate=False, with_grad_norm=True)
    tstep = steps.make_train_step(with_grad_norm=True)
    for i in range(3):
        xi, yi, wi = _batch(seed=10 + i)
        jst, jm = jstep(jst, jnp.asarray(xi), jnp.asarray(yi),
                        jnp.asarray(wi))
        tst, tm = tstep(tst, xi, yi, wi)
        assert float(tm["train_loss"]) == pytest.approx(
            float(jm["train_loss"]), rel=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-4)
    want = _flatten_params(jst.params["params"])
    for key, value in flax_weights(tst.model).items():
        np.testing.assert_allclose(value, np.asarray(want[key]), atol=1e-4,
                                   err_msg=key)


def test_torch_nn_gru_is_a_second_oracle():
    """``torch.nn.GRU`` with the same weights (weight_ih = x_gates kernel
    transposed, weight_hh = h_kernel transposed) gives the layers' last
    state."""
    model = WeatherGRU(F_IN, SMALL["seq_len"], hidden_dim=16, n_layers=2)
    load_flax_weights(model, init_flax_weights(model, 5))
    ref = torch.nn.GRU(F_IN, 16, num_layers=2, batch_first=True)
    with torch.no_grad():
        for i in range(2):
            layer = getattr(model, f"gru_{i}")
            getattr(ref, f"weight_ih_l{i}").copy_(layer.x_gates.weight)
            getattr(ref, f"bias_ih_l{i}").copy_(layer.x_gates.bias)
            getattr(ref, f"weight_hh_l{i}").copy_(layer.h_kernel.T)
            getattr(ref, f"bias_hh_l{i}").copy_(layer.h_bias)
        x = torch.from_numpy(_batch(b=3)[0])
        outs, last = model.gru_1(model.gru_0(x)[0])
        want, h_n = ref(x)
    np.testing.assert_allclose(_np(outs), _np(want), atol=1e-5)
    np.testing.assert_allclose(_np(last), _np(h_n[-1]), atol=1e-5)


def test_converter_round_trip_and_init_distributions():
    jmodel = jax_get_model(JaxModelConfig(**SMALL), input_dim=F_IN)
    jparams = _flatten_params(jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SMALL["seq_len"], F_IN)),
        train=False)["params"])
    model = get_model(ModelConfig(**SMALL), input_dim=F_IN, device="cpu")
    assert flax_shapes(model) == {k: v.shape for k, v in jparams.items()}
    load_flax_weights(model, jparams)
    back = flax_weights(model)
    for key, value in jparams.items():
        np.testing.assert_array_equal(back[key], np.asarray(value))
    big = WeatherGRU(F_IN, 8, hidden_dim=256, n_layers=1)
    drawn = init_flax_weights(big, 0)
    hk = drawn["gru_0/h_kernel"]
    assert hk.shape == (256, 768)
    # lecun_normal: variance 1/fan_in, nothing past 2 cut-normal stds.
    assert hk.std() == pytest.approx(1 / 16, rel=0.02)
    assert np.abs(hk).max() <= 2 * (1 / 16) / 0.87962566103423978 + 1e-7
    assert not drawn["gru_0/h_bias"].any()
    assert np.abs(drawn["gru_0/x_gates/kernel"]).max() <= 1 / np.sqrt(F_IN)
    with pytest.raises(KeyError):
        load_flax_weights(model, {k: v for k, v in jparams.items()
                                  if k != "gru_1/h_kernel"})


def _post(port, payload):
    import json
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/score",
                                 data=json.dumps(payload).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("DCT_")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", DCT_DEVICE="cpu")
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``train_job`` for weather_gru on 600 synthetic rows: the family
    needs nothing of the entry point beyond the registry."""
    from dct_tpu_torch.data.synthetic import generate_weather_csv
    from dct_tpu_torch.etl.preprocess import preprocess_csv_to_parquet

    root = tmp_path_factory.mktemp("gru")
    generate_weather_csv(str(root / "w.csv"), rows=600, seed=3)
    preprocess_csv_to_parquet(str(root / "w.csv"), str(root / "processed"))
    r = subprocess.run(
        [sys.executable, "-m", "dct_tpu_torch.train_job"],
        env=_env(DCT_MODEL="weather_gru", DCT_SEQ_LEN="16",
                 DCT_HIDDEN_DIM="16", DCT_EPOCHS="2", DCT_BATCH_SIZE="16",
                 DCT_PROCESSED_DIR=str(root / "processed"),
                 DCT_MODELS_DIR=str(root / "models"),
                 DCT_TRACKING_DIR=str(root / "mlruns")),
        cwd=str(root), capture_output=True, text=True, timeout=150)
    assert r.returncode == 0, r.stderr[-3000:]
    return root, r.stdout


def test_train_job_trains_the_gru(trained):
    root, out = trained
    assert "model=weather_gru" in out
    done = [line for line in out.splitlines() if "done: val_loss=" in line]
    assert done and np.isfinite(float(done[0].split("val_loss=")[1].split()[0]))
    assert (root / "models" / "last.ckpt").exists()
    assert list((root / "models").glob("weather-best-*.ckpt"))


def test_package_served_and_predicted_equal_numpy(trained, tmp_path):
    """The port's package of the trained GRU, served by the port's HTTP
    server (torch engine, CPU) at 1, 3 and 8 windows and scored by
    ``predict_job``, equals the port's numpy runtime within 1e-5."""
    from dct_tpu_torch import predict_job
    from dct_tpu_torch.config import ServingConfig
    from dct_tpu_torch.serving.numpy_runtime import forward_numpy, softmax_numpy
    from dct_tpu_torch.serving.score_gen import (
        generate_score_package,
        weights_from_checkpoint,
    )
    from dct_tpu_torch.serving.server import make_server

    root, _ = trained
    ckpt = str(root / "models" / "last.ckpt")
    pkg = str(tmp_path / "pkg")
    generate_score_package(ckpt, pkg)
    weights, meta = weights_from_checkpoint(ckpt)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, meta["seq_len"], meta["input_dim"])).astype(
        np.float32)
    server = make_server(pkg, device="cpu",
                         serving=ServingConfig(workers=1, engine="torch"))
    import threading

    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        warm = server.scorer.forwards
        for n in (1, 3, 8):
            code, got = _post(server.server_address[1],
                              {"data": x[:n].tolist()})
            assert code == 200, got
            want = softmax_numpy(forward_numpy(weights, meta, x[:n]))
            assert np.abs(np.asarray(got["probabilities"]) - want).max() <= 1e-5
        assert server.scorer.forwards - warm == 3
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)
    xs = rng.standard_normal((21, meta["seq_len"], meta["input_dim"])).astype(
        np.float32)
    got = predict_job.score(weights, meta, xs, 8, "torch", "cpu")
    want = predict_job.score(weights, meta, xs, 8, "numpy")
    assert got.shape == (21, 2)
    assert np.abs(got - want).max() <= 1e-5
