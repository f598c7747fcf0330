"""The port's MoE family on its serving and batch-scoring paths (CPU).

The scorer answers an MoE request at its true shape, as the reference's
does, and the accelerator engines (``predict_job``'s torch engine, the
harness's) pad a partial last chunk as the reference's jax engines do;
``train_job`` trains the family, and the package of its checkpoint is
served by the port's HTTP server and scored by ``predict_job``, each
against the port's numpy runtime.
"""

import os
import subprocess
import sys
import threading

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 256
F_IN = 5


def _meta(**extra):
    return dict(model="weather_moe", name="weather_moe", input_dim=F_IN,
                seq_len=S, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                n_experts=4, capacity_factor=0.5, router_top_k=1,
                moe_dispatch="einsum", num_classes=2, **extra)


def test_scorer_answers_an_moe_request_at_its_true_shape():
    """The reference's scorer never pads an MoE request
    (``dct_tpu/serving/batching.py:217-223``): capacity depends on the
    token count, so padding 3 windows to 4 would change the drops. The
    port's scorer equals the numpy runtime on 3 windows within 1e-5, and
    the padded forward would not."""
    from dct_tpu_torch.serving.batching import TorchScorer
    from dct_tpu_torch.serving.numpy_runtime import forward_numpy, softmax_numpy
    from dct_tpu_torch.serving.package import init_package_weights

    meta = _meta()
    weights = init_package_weights(meta, 3)
    scorer = TorchScorer(weights, meta, "cpu")
    seen = []
    real = scorer.model.forward
    scorer.model.forward = lambda xb: seen.append(xb.shape[0]) or real(xb)
    x = np.random.default_rng(12).standard_normal((3, S, F_IN)).astype(
        np.float32)
    got = scorer(x)
    want = softmax_numpy(forward_numpy(weights, meta, x))
    assert seen == [3]
    assert np.abs(got - want).max() <= 1e-5
    padded = np.concatenate([x, x[-1:]])
    wrong = softmax_numpy(forward_numpy(weights, meta, padded))[:3]
    assert np.abs(wrong - want).max() > 1e-4


def test_accelerator_engines_pad_the_last_partial_chunk_as_the_reference():
    """``len(x) > chunk`` with a partial last chunk: the reference's jax
    engines pad it to ``chunk`` with repeats of its last row, which for
    the MoE changes the last chunk's drops. The port's harness torch
    engine equals the reference's harness jax engine (1e-5), and
    ``predict_job``'s torch engine equals it too; scoring the last chunk
    unpadded would not."""
    from dct_tpu.evaluation import harness as ref_harness
    from dct_tpu_torch import predict_job
    from dct_tpu_torch.evaluation import harness
    from dct_tpu_torch.serving.numpy_runtime import forward_numpy, softmax_numpy
    from dct_tpu_torch.serving.package import init_package_weights

    meta = _meta()
    weights = init_package_weights(meta, 4)
    x = np.random.default_rng(13).standard_normal((19, S, F_IN)).astype(
        np.float32)
    want = ref_harness.batched_probs(weights, meta, x, batch_size=8,
                                     engine="jax")
    got = harness.batched_probs(weights, meta, x, batch_size=8,
                                engine="torch", device="cpu")
    assert got.shape == want.shape == (19, 2)
    assert np.abs(got - want).max() <= 1e-5
    pred = predict_job.score(weights, meta, x, 8, "torch", "cpu")
    assert np.abs(pred - want).max() <= 1e-5
    unpadded = softmax_numpy(forward_numpy(weights, meta, x[16:]))
    assert np.abs(unpadded - want[16:]).max() > 1e-4
    # The full chunks are what the numpy engine gives.
    full = predict_job.score(weights, meta, x[:16], 8, "numpy")
    assert np.abs(pred[:16] - full).max() <= 1e-5


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("DCT_")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", DCT_DEVICE="cpu")
    env.update(extra)
    return env


def _post(port, payload):
    import json
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/score",
                                 data=json.dumps(payload).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_train_job_package_server_and_predict_end_to_end(tmp_path):
    """``train_job`` trains weather_moe (nothing family-specific beyond the
    registry); the port's package of its checkpoint, served by the port's
    HTTP server (torch engine) at 1, 3 and 8 windows and scored by
    ``predict_job`` on full chunks, equals the numpy runtime within 1e-5."""
    from dct_tpu_torch import predict_job
    from dct_tpu_torch.config import ServingConfig
    from dct_tpu_torch.data.synthetic import generate_weather_csv
    from dct_tpu_torch.etl.preprocess import preprocess_csv_to_parquet
    from dct_tpu_torch.serving.numpy_runtime import forward_numpy, softmax_numpy
    from dct_tpu_torch.serving.score_gen import (
        generate_score_package,
        weights_from_checkpoint,
    )
    from dct_tpu_torch.serving.server import make_server

    generate_weather_csv(str(tmp_path / "w.csv"), rows=400, seed=3)
    preprocess_csv_to_parquet(str(tmp_path / "w.csv"),
                              str(tmp_path / "processed"))
    r = subprocess.run(
        [sys.executable, "-m", "dct_tpu_torch.train_job"],
        env=_env(DCT_MODEL="weather_moe", DCT_SEQ_LEN="16",
                 DCT_D_MODEL="16", DCT_N_HEADS="2", DCT_D_FF="32",
                 DCT_CAPACITY_FACTOR="0.5", DCT_ROUTER_TOP_K="2",
                 DCT_EPOCHS="2", DCT_BATCH_SIZE="16",
                 DCT_PROCESSED_DIR=str(tmp_path / "processed"),
                 DCT_MODELS_DIR=str(tmp_path / "models"),
                 DCT_TRACKING_DIR=str(tmp_path / "mlruns")),
        cwd=str(tmp_path), capture_output=True, text=True, timeout=150)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "model=weather_moe" in r.stdout
    ckpt = str(tmp_path / "models" / "last.ckpt")
    assert list((tmp_path / "models").glob("weather-best-*.ckpt"))
    pkg = str(tmp_path / "pkg")
    generate_score_package(ckpt, pkg)
    weights, meta = weights_from_checkpoint(ckpt)
    assert meta["router_top_k"] == 2
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 16, meta["input_dim"])).astype(np.float32)
    server = make_server(pkg, device="cpu",
                         serving=ServingConfig(workers=1, engine="torch"))
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
    xs = rng.standard_normal((24, 16, meta["input_dim"])).astype(np.float32)
    got = predict_job.score(weights, meta, xs, 8, "torch", "cpu")
    want = predict_job.score(weights, meta, xs, 8, "numpy")
    assert np.abs(got - want).max() <= 1e-5
