"""The port's serving path against the reference's numpy scorer (CPU).

A package written by the port is scored by ``dct_tpu.serving.runtime.
score_payload`` and by the port's HTTP server on ``device="cpu"``; f32
packages agree at 1e-5, ``::bf16`` packages (which the port runs at bf16
compute and the numpy runtime widens to f32) at 2e-2. Also pinned: the
HTTP contract, the micro-batcher, device resolution, and that the port
imports nothing of JAX or of the JAX package.
"""

import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dct_tpu.serving.quant import quantize_weights
from dct_tpu.serving.runtime import assemble_weights as ref_assemble
from dct_tpu.serving.runtime import score_payload
from dct_tpu_torch.config import ServingConfig
from dct_tpu_torch.device import DeviceError, resolve_device
from dct_tpu_torch.serving.batching import MicroBatcher, ScoringError, TorchScorer
from dct_tpu_torch.serving.package import (
    init_package_weights,
    load_package,
    write_package,
)
from dct_tpu_torch.serving.quant import quantize_weights as port_quantize
from dct_tpu_torch.serving.runtime import assemble_weights
from dct_tpu_torch.serving.server import make_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 256


def _meta(family, horizon=1, **kw):
    return dict(
        model=family, name=family, input_dim=5, seq_len=S, d_model=32,
        n_heads=2, n_layers=2, d_ff=64, num_classes=2, horizon=horizon,
        feature_names=["a", "b", "c", "d", "e"], **kw,
    )


def _post(port, payload, path="/score"):
    body = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class _Serving:
    def __init__(self, package_dir, **serving):
        cfg = ServingConfig(**serving) if serving else ServingConfig(workers=2)
        self.server = make_server(package_dir, device="cpu", serving=cfg)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(10)
        assert not self.thread.is_alive()


PACKAGES = [
    ("weather_transformer", 1, {}),
    ("weather_transformer_causal", 1, {}),
    ("weather_transformer_causal", 2, {"n_kv_heads": 1, "attn_window": 64}),
    ("weather_transformer", 1, {"pos_embed": "rope"}),
]


@pytest.mark.parametrize("family,horizon,extra", PACKAGES)
@pytest.mark.parametrize("quant", [None, "bf16"])
def test_http_scores_match_reference_numpy(family, horizon, extra, quant,
                                           tmp_path):
    meta = _meta(family, horizon, **extra)
    weights = init_package_weights(meta, seed=3)
    flat, pmeta = (
        (weights, meta) if quant is None
        else quantize_weights(weights, meta, dtype=quant)
    )
    write_package(str(tmp_path), flat, pmeta)
    x = np.random.default_rng(11).standard_normal((3, S, 5)).astype(np.float32)
    ref = np.asarray(
        score_payload(ref_assemble(flat), pmeta, x.tolist())["probabilities"]
    )
    with _Serving(str(tmp_path)) as srv:
        assert srv.server.scorer.dtype == (
            torch.bfloat16 if quant else torch.float32
        )
        code, got = _post(srv.port, {"data": x.tolist()})
        assert code == 200
        one_code, one = _post(srv.port, {"data": x[1].tolist()})
        assert one_code == 200
    got = np.asarray(got["probabilities"])
    assert got.shape == ref.shape
    assert np.allclose(got.sum(axis=-1), 1.0, atol=1e-5)
    tol = 1e-5 if quant is None else 2e-2
    np.testing.assert_allclose(got, ref, atol=tol)
    np.testing.assert_allclose(np.asarray(one["probabilities"]), ref[1:2],
                               atol=tol)


def test_bf16_twin_matches_reference_quantizer(monkeypatch):
    """The port's bf16 writer gives the reference's package bit for bit."""
    monkeypatch.delenv("DCT_QUANT_PROB_BOUND", raising=False)
    meta = _meta("weather_transformer_causal", 2)
    weights = init_package_weights(meta, seed=7)
    # Ties and extremes of the round-to-nearest-even rule, as f32 bits.
    weights["edge"] = np.array(
        [0x3F808000, 0x3F818000, 0x3F817FFF, 0x7F7FFFFF, 0x00000001],
        np.uint32,
    ).view(np.float32)
    flat, qmeta = port_quantize(weights, meta)
    ref_flat, ref_meta = quantize_weights(weights, meta, dtype="bf16")
    assert qmeta == ref_meta and qmeta["quant"]["dtype"] == "bf16"
    assert set(flat) == set(ref_flat)
    for k in ref_flat:
        assert flat[k].dtype == ref_flat[k].dtype == np.uint16
        assert np.array_equal(flat[k], ref_flat[k]), k
    with pytest.raises(NotImplementedError, match="int8"):
        port_quantize(weights, meta, dtype="int8")


def test_package_round_trip(tmp_path):
    meta = _meta("weather_transformer_causal")
    weights = init_package_weights(meta, seed=5)
    write_package(str(tmp_path), weights, meta)
    loaded, lmeta = load_package(str(tmp_path))
    assert lmeta == meta
    assert set(loaded) == set(weights)
    for k in weights:
        assert np.array_equal(loaded[k], weights[k])
    assert sorted(os.listdir(tmp_path)) == ["model.npz", "model_meta.json"]
    # Same seed, same weights; U(+-1/sqrt(fan_in)) kernels, unit LN.
    again = init_package_weights(meta, seed=5)
    assert all(np.array_equal(again[k], weights[k]) for k in weights)
    k = weights["block_0/ffn_in/kernel"]
    assert k.shape == (32, 64) and np.abs(k).max() <= 1 / np.sqrt(32)
    assert np.abs(weights["block_0/ffn_out/bias"]).max() <= 1 / np.sqrt(64)
    assert (weights["ln_out/scale"] == 1).all()
    assert (weights["ln_out/bias"] == 0).all()


def test_reference_flax_package_loads_and_matches(tmp_path):
    """A package exported from a flax model by the reference's flattening
    serves in the port with the reference numpy runtime's answers."""
    import jax
    import jax.numpy as jnp

    from dct_tpu.config import ModelConfig as JaxModelConfig
    from dct_tpu.models.registry import get_model as jax_get_model
    from dct_tpu.serving.score_gen import _flatten_params

    meta = _meta("weather_transformer")
    cfg = JaxModelConfig(name=meta["model"], seq_len=S, d_model=32,
                         n_heads=2, n_layers=2, d_ff=64)
    params = jax_get_model(cfg, input_dim=5).init(
        jax.random.PRNGKey(1), jnp.zeros((1, S, 5))
    )["params"]
    weights = _flatten_params(params)
    write_package(str(tmp_path), weights, meta)
    x = np.random.default_rng(4).standard_normal((2, S, 5)).astype(np.float32)
    ref = np.asarray(score_payload(weights, meta, x.tolist())["probabilities"])
    with _Serving(str(tmp_path)) as srv:
        code, got = _post(srv.port, {"data": x.tolist()})
    assert code == 200
    np.testing.assert_allclose(np.asarray(got["probabilities"]), ref,
                               atol=1e-5)


def test_http_contract(tmp_path):
    meta = _meta("weather_transformer_causal", 2)
    write_package(str(tmp_path), init_package_weights(meta, 0), meta)
    with _Serving(str(tmp_path)) as srv:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/healthz", timeout=10
        ) as r:
            health = json.loads(r.read())
        assert health == {"status": "ok", "model": meta["model"],
                          "input_dim": 5, "horizon": 2, "device": "cpu"}
        assert _post(srv.port, b"not json")[0] == 400
        assert _post(srv.port, {"rows": []})[0] == 400
        code, err = _post(srv.port, {"data": [[1.0] * 5] * 7})
        assert code == 400 and "Expected shape" in err["error"]
        assert _post(srv.port, {"data": [[[1e39] * 5] * S]})[0] == 400
        assert _post(srv.port, {"data": []}, path="/nope")[0] == 404

        def boom(x):
            raise RuntimeError("device fault")

        srv.server.batcher.scorer = boom
        code, err = _post(srv.port, {"data": [[[0.5] * 5] * S]})
        assert code == 500 and "device fault" in err["error"]
        srv.server.batcher.scorer = lambda x: np.full((len(x), 2), np.nan)
        code, err = _post(srv.port, {"data": [[[0.5] * 5] * S]})
        assert code == 500 and "non-finite" in err["error"]


def test_scorer_pads_to_power_of_two_and_answers_last_position():
    meta = _meta("weather_transformer_causal", 2)
    scorer = TorchScorer(init_package_weights(meta, 2), meta, "cpu")
    seen = []
    real = scorer.model.forward
    scorer.model.forward = lambda xb: seen.append(xb.shape[0]) or real(xb)
    x = np.random.default_rng(3).standard_normal((3, S, 5)).astype(np.float32)
    probs = scorer(x)
    assert seen == [4] and scorer.forwards == 1
    assert probs.shape == (3, 2, 2)
    alone = scorer(x[2:3])
    assert seen == [4, 1]
    np.testing.assert_allclose(probs[2:3], alone, atol=1e-6)


def test_microbatcher_merges_and_caps():
    sizes = []

    def scorer(x):
        sizes.append(len(x))
        return np.tile([[0.25, 0.75]], (len(x), 1))

    b = MicroBatcher(scorer, max_batch=4, window_ms=300, workers=1)
    try:
        out = {}

        def send(i, n):
            out[i] = b.score(np.zeros((n, 2), np.float32))

        threads = [threading.Thread(target=send, args=(i, n))
                   for i, n in enumerate((1, 1, 3))]
        for t in threads:
            t.start()
            time.sleep(0.02)
        for t in threads:
            t.join(10)
            assert not t.is_alive()
    finally:
        b.close()
    # 1 + 1 merged; the 3-row request would pass the cap of 4 rows.
    assert sorted(sizes) == [2, 3] and b.flushes == 2
    assert [out[i].shape for i in range(3)] == [(1, 2), (1, 2), (3, 2)]
    assert b.scored_requests == 3


def test_microbatcher_inline_and_faults():
    b = MicroBatcher(lambda x: np.full((len(x), 2), np.inf), workers=0)
    with pytest.raises(ScoringError, match="non-finite"):
        b.score(np.zeros((2, 2), np.float32))
    b.close()
    b = MicroBatcher(lambda x: x[:, :2] * 0 + 0.5, workers=1)
    assert b.score(np.ones((3, 4), np.float32)).shape == (3, 2)
    b.close()
    with pytest.raises(ScoringError, match="closed"):
        b.score(np.ones((1, 4), np.float32))


def test_int8_packages_are_refused(tmp_path):
    meta = _meta("weather_transformer")
    flat, qmeta = quantize_weights(init_package_weights(meta, 0), meta,
                                   dtype="int8")
    with pytest.raises(NotImplementedError, match="int8"):
        assemble_weights(flat)
    with pytest.raises(NotImplementedError, match="int8"):
        TorchScorer({}, qmeta, "cpu")


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(DeviceError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(DeviceError):
        resolve_device("cuda:0")


def test_serve_cli_refuses_without_package_or_card(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("DCT_")}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-m", "dct_tpu_torch.serve"],
                       env=env, cwd=str(tmp_path), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 2 and "DCT_PACKAGE_DIR" in r.stderr
    if torch.cuda.is_available():
        return
    meta = _meta("weather_transformer")
    write_package(str(tmp_path / "pkg"), init_package_weights(meta, 0), meta)
    env["DCT_PACKAGE_DIR"] = str(tmp_path / "pkg")
    r = subprocess.run([sys.executable, "-m", "dct_tpu_torch.serve"],
                       env=env, cwd=str(tmp_path), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0 and "CUDA is not available" in r.stderr


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|dct_tpu)\b")


def test_port_imports_nothing_of_jax_or_the_jax_package():
    script = (
        "import sys, pkgutil, importlib\n"
        "before = set(sys.modules)\n"
        "import dct_tpu_torch\n"
        "for m in pkgutil.walk_packages(dct_tpu_torch.__path__, 'dct_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in set(sys.modules) - before\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'dct_tpu'))\n"
        "print(len([n for n in sys.modules if n.startswith('dct_tpu_torch.')]))\n"
        "print(bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("DCT_")}
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    n_modules, bad = r.stdout.strip().splitlines()
    assert int(n_modules) >= 15 and bad == "[]"

    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "dct_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = []
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if _FORBIDDEN.match(line):
                    offenders.append(f"{os.path.relpath(path, REPO)}:{i}")
    assert offenders == []
    assert _FORBIDDEN.match("import dct_tpu_torch.ops") is None
    assert _FORBIDDEN.match("from dct_tpu.ops import x") is not None
