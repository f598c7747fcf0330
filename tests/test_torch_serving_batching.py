"""The port's micro-batcher against the reference's (CPU).

``engine="numpy"`` flushes equal the reference's ``score_rows_invariant``
bit for bit, and a request's answer never depends on its batch-mates. The
torch engine answers within 1e-5 of the reference numpy runtime. Also
pinned as in ``tests/test_serving_batching.py`` and
``tests/test_serving_elastic.py``: concurrent merging, the deadline
window, the row cap, slot-flip isolation (the batch key holds the weights
object), the bounded torch scorer cache, faults per request, the
``score`` fault point, the flush events, ``set_workers`` and the queue
statistics.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from dct_tpu.serving.batching import score_rows_invariant as ref_rows
from dct_tpu.serving.runtime import score_payload
from dct_tpu_torch.config import ServingConfig
from dct_tpu_torch.observability import events as _events
from dct_tpu_torch.resilience import faults
from dct_tpu_torch.serving.batching import (
    MicroBatcher,
    ScoringError,
    TorchScorer,
    batcher_from_env,
    score_rows_invariant,
)
from dct_tpu_torch.serving.loadgen import synthetic_mlp
from dct_tpu_torch.serving.package import init_package_weights
from dct_tpu_torch.serving.server import _SlotMetrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 256


def _family(name):
    if name == "weather_mlp":
        return synthetic_mlp(seed=2)
    meta = dict(model=name, name=name, input_dim=5, seq_len=S, d_model=32,
                n_heads=2, n_layers=2, d_ff=64, num_classes=2,
                horizon=3 if name == "weather_transformer_causal" else 1)
    return init_package_weights(meta, seed=4), meta


def _rows(meta, n, seed):
    shape = ((n, meta["seq_len"], 5) if "seq_len" in meta
             else (n, meta["input_dim"]))
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


FAMILIES = ("weather_mlp", "weather_transformer", "weather_transformer_causal")


@pytest.fixture
def no_default_fault_plan():
    yield
    faults.set_default(None)


@pytest.fixture
def env_event_log():
    """Events go to the log built from ``DCT_EVENTS_DIR``: a ``Trainer``
    run earlier in the same process installs its own log as the process
    default, and that would take this test's events."""
    _events.set_default(None)
    yield
    _events.set_default(None)


def _concurrently(fn, n):
    threads = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()


@pytest.mark.parametrize("family", FAMILIES)
def test_numpy_engine_flushes_equal_reference_bitwise(family):
    weights, meta = _family(family)
    arrays = [_rows(meta, n, seed) for seed, n in enumerate((1, 3, 2))]
    ours = score_rows_invariant(weights, meta, arrays)
    theirs = ref_rows(weights, meta, arrays)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # Each request's answer is the one it gets alone, whatever else
    # shares its flush.
    for i, a in enumerate(arrays):
        assert np.array_equal(score_rows_invariant(weights, meta, [a])[0],
                              ours[i])


@pytest.mark.parametrize("engine", ["numpy", "torch"])
def test_concurrent_requests_merge_and_answer_as_alone(engine):
    weights, meta = _family("weather_transformer")
    rows = _rows(meta, 6, seed=7)
    b = MicroBatcher(max_batch=64, window_ms=300.0, workers=1,
                     engine=engine, device="cpu")
    out: list = [None] * 6
    try:
        _concurrently(lambda i: out.__setitem__(
            i, b.score(weights, meta, rows[i:i + 1])), 6)
        assert b.flushes <= 2, b.flushes
    finally:
        b.close()
    for i in range(6):
        ref = np.asarray(score_payload(weights, meta, rows[i:i + 1].tolist())
                         ["probabilities"], np.float32)
        if engine == "numpy":
            assert np.array_equal(out[i].astype(np.float32), ref)
        else:
            np.testing.assert_allclose(out[i], ref, atol=1e-5)


def test_deadline_window_flush_under_trickle():
    weights, meta = synthetic_mlp()
    b = MicroBatcher(max_batch=64, window_ms=50.0, workers=1, engine="numpy")
    try:
        t0 = time.perf_counter()
        probs = b.score(weights, meta, _rows(meta, 1, 0))
        dt = time.perf_counter() - t0
        assert probs.shape == (1, 2) and 0.04 <= dt < 5.0
        assert b.flushes == 1
    finally:
        b.close()


def test_max_batch_caps_flush_rows():
    weights, meta = synthetic_mlp()
    metrics = _SlotMetrics()
    b = MicroBatcher(max_batch=4, window_ms=100.0, workers=2,
                     engine="numpy", metrics=metrics)
    rows = _rows(meta, 24, 0)
    try:
        _concurrently(lambda i: b.score(weights, meta, rows[i:i + 1]), 24)
    finally:
        b.close()
    hist = metrics._batch_rows
    assert hist.count >= 6
    assert hist.counts[hist.buckets.index(4.0)] == hist.count


def test_slot_flip_never_merges_two_packages():
    """Two weights objects of one family and shape (a blue/green flip)
    stay in separate flushes: the batch key holds ``id(weights)``."""
    (w_a, meta), (w_b, _) = synthetic_mlp(seed=1), synthetic_mlp(seed=2)
    seen = []
    b = MicroBatcher(max_batch=64, window_ms=200.0, workers=1,
                     engine="numpy")
    real = b._dispatch

    def spy(weights, m, arrays):
        seen.append((id(weights), len(arrays)))
        return real(weights, m, arrays)

    b._dispatch = spy
    rows = _rows(meta, 8, 3)
    out: list = [None] * 8
    try:
        _concurrently(lambda i: out.__setitem__(i, b.score(
            w_a if i % 2 else w_b, meta, rows[i:i + 1])), 8)
    finally:
        b.close()
    assert {w for w, _ in seen} == {id(w_a), id(w_b)}
    assert sum(n for _, n in seen) == 8
    for i in range(8):
        w = w_a if i % 2 else w_b
        ref = np.asarray(score_payload(w, meta, rows[i:i + 1].tolist())
                         ["probabilities"], np.float32)
        assert np.array_equal(out[i].astype(np.float32), ref)


def test_torch_scorer_cache_bounded_and_pins_weights():
    b = MicroBatcher(workers=0, engine="torch", device="cpu")
    b._TORCH_SCORER_CAP = 3
    kept = []
    for seed in range(5):
        weights, meta = synthetic_mlp(seed=seed)
        kept.append(weights)
        first = b.scorer_for(weights, meta)
        assert b.scorer_for(weights, meta) is first
        assert isinstance(first, TorchScorer)
    assert len(b._scorers) == 3
    assert all(entry[0] is kept[i + 2]
               for i, entry in enumerate(b._scorers.values()))
    b.close()


def test_faults_per_request_and_batcher_survives():
    weights, meta = synthetic_mlp()
    broken = {k: v for k, v in weights.items() if k != "w0"}
    for engine in ("numpy", "torch"):
        b = MicroBatcher(max_batch=8, workers=1, engine=engine, device="cpu")
        try:
            with pytest.raises(ScoringError):
                b.score(broken, meta, np.zeros((1, 5), np.float32))
            assert b.score(weights, meta,
                           np.zeros((1, 5), np.float32)).shape == (1, 2)
        finally:
            b.close()
    poisoned = dict(weights, w0=np.full_like(weights["w0"], np.nan))
    inline = MicroBatcher(workers=0, engine="numpy")
    with pytest.raises(ScoringError, match="non-finite"):
        inline.score(poisoned, meta, np.zeros((1, 5), np.float32))


def test_engine_knob(monkeypatch):
    monkeypatch.setenv("DCT_SERVE_ENGINE", "jax")
    with pytest.raises(ValueError, match="torch"):
        ServingConfig.from_env()
    with pytest.raises(ValueError, match="torch"):
        MicroBatcher(engine="jax", workers=0)
    monkeypatch.setenv("DCT_SERVE_ENGINE", " NumPy ")
    monkeypatch.setenv("DCT_SERVE_WORKERS", "0")
    monkeypatch.setenv("DCT_SERVE_MAX_BATCH", "5")
    b = batcher_from_env()
    assert (b.engine, b.workers, b.max_batch) == ("numpy", 0, 5)
    assert ServingConfig().engine == "torch"


def test_serving_config_matches_reference(monkeypatch):
    """Every reference field, with its default and variable."""
    import dataclasses

    from dct_tpu.config import ServingConfig as RefServing

    ours = {f.name: f.default for f in dataclasses.fields(ServingConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(RefServing)}
    assert set(ours) == set(theirs)
    assert {k: v for k, v in ours.items() if k != "engine"} == {
        k: v for k, v in theirs.items() if k != "engine"}
    env = {"DCT_SERVE_PROCS": "3", "DCT_SERVE_ADMIT": "1",
           "DCT_SERVE_PRIORITY_HEADER": "X-P", "DCT_SERVE_ADMIT_MAX_QUEUE":
           "9", "DCT_SERVE_ADMIT_WAIT_MS": "12.5",
           "DCT_SERVE_RETRY_AFTER_S": "0.5", "DCT_SERVE_AUTOSCALE": "yes",
           "DCT_SERVE_SCALE_MIN": "2", "DCT_SERVE_SCALE_MAX": "6",
           "DCT_SERVE_SCALE_UP_Q": "40", "DCT_SERVE_SCALE_DOWN_Q": "3",
           "DCT_SERVE_SCALE_POLL_S": "0.3", "DCT_SERVE_SCALE_HYSTERESIS": "4",
           "DCT_SERVE_SCALE_COOLDOWN_S": "7", "DCT_SERVE_MAX_RESTARTS": "5",
           "DCT_SERVE_LOADGEN_QPS": "50", "DCT_SERVE_LOADGEN_REQUESTS": "20",
           "DCT_SERVE_LOADGEN_DURATION_S": "1.5",
           "DCT_SERVE_LOADGEN_CONCURRENCY": "8,x,2,2"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    a, b = ServingConfig.from_env(), RefServing.from_env()
    for f in dataclasses.fields(ServingConfig):
        if f.name != "engine":
            assert getattr(a, f.name) == getattr(b, f.name), f.name
    assert a.concurrency_levels() == b.concurrency_levels() == [2, 8]


def test_slow_score_fault_and_flush_events(tmp_path, monkeypatch,
                                           no_default_fault_plan,
                                           env_event_log):
    monkeypatch.setenv("DCT_EVENTS_DIR", str(tmp_path / "events"))
    monkeypatch.setenv("DCT_SERVE_TRACE", "1")
    faults.set_default(faults.FaultPlan.parse("slow_score:ms60"))
    weights, meta = synthetic_mlp()
    b = MicroBatcher(max_batch=4, workers=1, engine="numpy")
    try:
        t0 = time.perf_counter()
        b.score(weights, meta, np.zeros((1, 5), np.float32))
        b.score(weights, meta, np.zeros((1, 5), np.float32))
        assert time.perf_counter() - t0 >= 0.12
        with pytest.raises(ScoringError):
            b.score({"w0": np.zeros((5, 1), np.float32)}, meta,
                    np.zeros((1, 5), np.float32))
    finally:
        b.close()
    with open(tmp_path / "events" / "events.jsonl") as f:
        names = [json.loads(line)["event"] for line in f]
    assert names.count("serve.batch_flush") == 3
    assert names.count("serve.batch_error") == 1
    assert names.count("fault.injected") == 1  # a repeating clause logs once


def test_crash_worker_exits_the_process_at_its_request(tmp_path):
    script = (
        "import numpy as np\n"
        "from dct_tpu_torch.serving.batching import MicroBatcher\n"
        "from dct_tpu_torch.serving.loadgen import synthetic_mlp\n"
        "w, m = synthetic_mlp()\n"
        "b = MicroBatcher(workers=0, engine='numpy')\n"
        "for i in range(5):\n"
        "    b.score(w, m, np.zeros((1, 5), np.float32))\n"
        "    print('scored', i + 1, flush=True)\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("DCT_")}
    env.update(PYTHONPATH=REPO, DCT_FAULT_SPEC="crash_worker:req3",
               DCT_EVENTS_DIR=str(tmp_path / "events"))
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == faults.FAULT_CRASH_EXIT, r.stderr
    assert r.stdout.split() == ["scored", "1", "scored", "2"]


def test_set_workers_serves_through_resize():
    weights, meta = synthetic_mlp()
    b = MicroBatcher(max_batch=4, workers=1, engine="numpy")
    x = np.zeros((1, 5), np.float32)
    try:
        b.set_workers(3)
        assert b.workers == 3
        assert b.score(weights, meta, x).shape == (1, 2)
        b.set_workers(1)
        deadline = time.time() + 5
        while len(b._threads) != 1 and time.time() < deadline:
            b.score(weights, meta, x)
            time.sleep(0.01)
        assert b.workers == 1 and len(b._threads) == 1
        assert b.score(weights, meta, x).shape == (1, 2)
    finally:
        b.close()


def test_queue_statistics():
    weights, meta = synthetic_mlp()
    inline = MicroBatcher(max_batch=4, workers=0, engine="numpy")
    assert inline.queued_rows() == 0
    assert inline.service_rate() is None and inline.saturation() == (0, None)
    inline.close()
    # One worker held inside a flush: rows queue behind it, and the rate
    # appears once two flushes completed.
    gate = threading.Event()
    b = MicroBatcher(max_batch=2, workers=1, engine="numpy")
    real = b._dispatch

    def held(w, m, arrays):
        gate.wait(10)
        return real(w, m, arrays)

    b._dispatch = held
    try:
        threads = [threading.Thread(target=b.score, args=(
            weights, meta, np.zeros((2, 5), np.float32))) for _ in range(3)]
        for t in threads:
            t.start()
        deadline = time.time() + 5
        while b.queued_rows() != 4 and time.time() < deadline:
            time.sleep(0.01)
        assert b.saturation() == (4, None)
        gate.set()
        for t in threads:
            t.join(10)
        assert b.queued_rows() == 0
        rate = b.service_rate()
        assert rate is not None and rate > 0
        assert b.saturation()[1] == 0.0
    finally:
        gate.set()
        b.close()


@pytest.mark.parametrize("device,ok", [("cpu", True), (None, False)])
def test_loadgen_selftest_torch_engine_runs_on_dct_device(device, ok):
    """``--selftest --engine torch`` serves on ``DCT_DEVICE``: ``cpu``
    passes; unset it is ``cuda:0``, which raises on a host without a card
    instead of serving on the CPU (and passes on a host with one)."""
    import torch

    ok = ok or torch.cuda.is_available()
    env = {k: v for k, v in os.environ.items() if not k.startswith("DCT_")}
    env["PYTHONPATH"] = REPO
    if device:
        env["DCT_DEVICE"] = device
    r = subprocess.run([sys.executable, "-m", "dct_tpu_torch.serving.loadgen",
                        "--selftest", "--engine", "torch"], env=env,
                       capture_output=True, text=True, timeout=180)
    if ok:
        assert r.returncode == 0, r.stderr
        out = json.loads(r.stdout.splitlines()[-1])
        assert out["ok"] and out["parity"] and out["engine"] == "torch"
    else:
        assert r.returncode != 0
        assert "DeviceError" in r.stderr and "cuda:0" in r.stderr
