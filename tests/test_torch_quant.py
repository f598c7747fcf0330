"""int8 packages in the port against the reference (CPU).

The port's int8 arrays and package files are the reference's exactly. An
int8 package served by the port's torch engine (``TorchScorer`` on the
CPU: q8 and scales resident, dequantized inside the forward at f32) is
within 1e-5 of the reference's jitted scorer (``_build_jax_scorer``),
which dequantizes the same way; the port's numpy engine equals the
reference's numpy engine bit for bit. The numpy engine also quantizes the
activations (``QuantTensor.matmul``), so the two engines of either package
differ by about 3e-3 at these sizes; they are held to the package's
``prob_bound`` (0.05) against each other.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from dct_tpu.serving.batching import _build_jax_scorer
from dct_tpu.serving.quant import quantize_array_int8 as ref_q8
from dct_tpu.serving.quant import quantize_package as ref_quantize_package
from dct_tpu.serving.quant import quantize_weights as ref_quantize
from dct_tpu.serving.runtime import assemble_weights as ref_assemble
from dct_tpu.serving.runtime import score_payload
from dct_tpu_torch.serving import quant
from dct_tpu_torch.serving.batching import (
    Int8Dense,
    TorchScorer,
    score_rows_invariant,
)
from dct_tpu_torch.serving.package import init_package_weights, write_package
from dct_tpu_torch.serving.runtime import QuantTensor, assemble_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 256


def _meta(family, horizon=1, **kw):
    return dict(model=family, name=family, input_dim=5, seq_len=S,
                d_model=32, n_heads=2, n_layers=2, d_ff=64, num_classes=2,
                horizon=horizon, feature_names=list("abcde"), **kw)


def _mlp():
    rng = np.random.default_rng(4)
    weights = {"w0": rng.standard_normal((5, 64)).astype(np.float32),
               "b0": rng.standard_normal(64).astype(np.float32) * 0.1,
               "w1": rng.standard_normal((64, 2)).astype(np.float32),
               "b1": rng.standard_normal(2).astype(np.float32) * 0.1}
    meta = {"model": "weather_mlp", "name": "weather_mlp", "input_dim": 5,
            "hidden_dim": 64, "num_classes": 2,
            "feature_names": list("abcde")}
    return weights, meta


FAMILIES = [
    ("weather_transformer", 1, {}),
    ("weather_transformer_causal", 3, {"n_kv_heads": 1}),
]


@pytest.mark.parametrize("shape", [(5, 64), (32, 96), (64, 2), (1, 7)])
def test_int8_arrays_equal_reference(shape):
    rng = np.random.default_rng(shape[0] * 31 + shape[1])
    a = (rng.standard_normal(shape) * rng.uniform(0.01, 3.0, shape[1])
         ).astype(np.float32)
    a[:, 0] = 0.0  # an all-zero channel keeps scale 0
    q, s = quant.quantize_array_int8(a)
    rq, rs = ref_q8(a)
    assert q.dtype == rq.dtype == np.int8 and s.dtype == rs.dtype
    assert np.array_equal(q, rq) and np.array_equal(s, rs)
    assert s[0] == 0 and (q[:, 0] == 0).all()


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
@pytest.mark.parametrize("which", ["mlp", "transformer"])
def test_quantize_weights_equals_reference(dtype, which, monkeypatch):
    monkeypatch.delenv("DCT_QUANT_PROB_BOUND", raising=False)
    if which == "mlp":
        weights, meta = _mlp()
    else:
        meta = _meta("weather_transformer")
        weights = init_package_weights(meta, seed=9)
    flat, qmeta = quant.quantize_weights(weights, meta, dtype)
    rflat, rmeta = ref_quantize(weights, meta, dtype)
    assert qmeta == rmeta and qmeta["quant"]["dtype"] == dtype
    assert sorted(flat) == sorted(rflat)
    for k in rflat:
        assert flat[k].dtype == rflat[k].dtype, k
        assert np.array_equal(flat[k], rflat[k]), k
    if dtype == "int8":
        # Every 2D kernel quantized, everything else f32 as it was.
        q8 = sorted(k[:-4] for k in flat if k.endswith("::q8"))
        assert q8 == sorted(k for k, v in weights.items()
                            if quant.is_matmul_kernel(k, np.asarray(v)))
        assert q8


def test_quantize_package_files_equal_reference(tmp_path, monkeypatch):
    monkeypatch.delenv("DCT_QUANT_PROB_BOUND", raising=False)
    monkeypatch.delenv("DCT_QUANT_DTYPE", raising=False)
    meta = _meta("weather_transformer_causal", 3)
    src = str(tmp_path / "f32")
    write_package(src, init_package_weights(meta, 1), meta)
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    assert quant.quantize_package(src, ours) == ref_quantize_package(
        src, theirs)
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs)) == [
        "conda.yaml", "model.npz", "model_meta.json", "score.py"]
    for name in ("conda.yaml", "model_meta.json", "score.py"):
        with open(os.path.join(ours, name), "rb") as a, open(
                os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read(), name
    with np.load(os.path.join(ours, "model.npz")) as a, np.load(
            os.path.join(theirs, "model.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="already quantized"):
        quant.quantize_package(ours, str(tmp_path / "again"))


@pytest.mark.parametrize("family,horizon,extra", FAMILIES)
def test_int8_package_served_by_both_packages_scorers(family, horizon, extra):
    """The same int8 package (made by each package's quantizer, which
    agree) through the port's torch engine, the reference's jax engine,
    and both numpy engines."""
    meta = _meta(family, horizon, **extra)
    weights = init_package_weights(meta, seed=3)
    flat, qmeta = quant.quantize_weights(weights, meta, "int8")
    rflat, _ = ref_quantize(weights, meta, "int8")
    served = assemble_weights(flat)
    assert any(isinstance(v, QuantTensor) for v in served.values())
    x = np.random.default_rng(1).standard_normal((3, S, 5)).astype(np.float32)
    ours = TorchScorer(served, qmeta, "cpu")(x)
    jax_ref = np.asarray(_build_jax_scorer(ref_assemble(rflat), qmeta)(x))
    np_ref = np.asarray(score_payload(ref_assemble(rflat), qmeta,
                                      x.tolist())["probabilities"])
    assert ours.shape == jax_ref.shape == np_ref.shape
    np.testing.assert_allclose(ours, jax_ref, atol=1e-5)
    ours_np = score_rows_invariant(served, qmeta, [x])[0]
    assert np.array_equal(ours_np, score_rows_invariant(
        ref_assemble(rflat), qmeta, [x])[0])
    assert np.abs(ours - np_ref).max() < qmeta["quant"]["prob_bound"]
    f32 = TorchScorer(weights, meta, "cpu")(x)
    assert np.abs(ours - f32).max() < qmeta["quant"]["prob_bound"]


def test_int8_scorer_keeps_q8_resident():
    meta = _meta("weather_transformer")
    weights = init_package_weights(meta, seed=2)
    flat, qmeta = quant.quantize_weights(weights, meta, "int8")
    q8 = TorchScorer(assemble_weights(flat), qmeta, "cpu")
    f32 = TorchScorer(weights, meta, "cpu")
    layers = [m for m in q8.model.modules() if isinstance(m, Int8Dense)]
    n_kernels = sum(k.endswith("::q8") for k in flat)
    assert len(layers) == n_kernels
    for m in layers:
        assert m.q8.dtype.is_floating_point is False and m.q8.element_size() == 1
        assert m.scale.shape == (m.q8.shape[0],)
    kernel_bytes = sum(np.asarray(v).size for k, v in weights.items()
                       if k.endswith("kernel"))
    # Each kernel goes from 4 bytes an entry to 1 (plus its scales).
    saved = f32.resident_bytes() - q8.resident_bytes()
    assert saved >= 3 * kernel_bytes - 4 * sum(
        flat[k].size for k in flat if k.endswith("::scale"))


def test_mlp_int8_package_served(tmp_path):
    """The MLP's ``w<i>`` kernels quantize and serve through the port."""
    weights, meta = _mlp()
    flat, qmeta = quant.quantize_weights(weights, meta, "int8")
    assert sorted(flat) == ["b0", "b1", "w0::q8", "w0::scale", "w1::q8",
                            "w1::scale"]
    x = np.random.default_rng(3).standard_normal((9, 5)).astype(np.float32)
    ours = TorchScorer(assemble_weights(flat), qmeta, "cpu")(x)
    ref = np.asarray(_build_jax_scorer(ref_assemble(flat), qmeta)(x))
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_quant_cli_writes_a_servable_package(tmp_path):
    from dct_tpu_torch.config import ServingConfig
    from dct_tpu_torch.serving.server import make_server

    meta = _meta("weather_transformer")
    src, out = str(tmp_path / "f32"), str(tmp_path / "int8")
    write_package(src, init_package_weights(meta, 5), meta)
    env = {k: v for k, v in os.environ.items() if not k.startswith("DCT_")}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-m", "dct_tpu_torch.serving.quant",
                        src, out], env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == {
        "dtype": "int8", "prob_bound": 0.05}
    server = make_server(out, device="cpu",
                         serving=ServingConfig(workers=0))
    try:
        assert server.scorer.quant == "int8"
        x = np.random.default_rng(0).standard_normal((2, S, 5)).astype(
            np.float32)
        probs = server.batcher.score(server.model_weights,
                                     server.model_meta, x)
        assert probs.shape == (2, 2)
        np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-6)
    finally:
        server.server_close()
