"""``weather_transformer_pp`` through ``train_job`` on gloo worlds (CPU):
the fits, the shard-saved resume re-mapped onto another grid, and the
package.

- ``DCT_MESH_PIPE=2`` worlds (``pipe=2``, ``data=2 pipe=2``, ``model=2
  pipe=2``; dropout 0.2, drawn once before the stages) end one epoch on
  the one-process run's val_loss within 1e-5, on every rank.
- A shard-saved resume re-maps: ``data=2 pipe=2`` onto ``model=2
  pipe=2`` (``n_stages`` must equal ``pipe``, as the reference's, so a
  checkpoint of two stages resumes on two-stage grids), and ``pipe=2``
  onto one process, each within 1e-5 of the one-process control
  continuation, every rank logging ``shard.topology_remap``.
- The deploy checkpoint holds the dense stacked ``pp_stages`` leaves
  (gathered over ``pipe`` by rank 0), so its package is the reference's:
  ``dct_tpu/serving/runtime.py`` scores it, and the port's torch scorer
  (the sequential stack on the flash route) agrees within 1e-5 in f32
  and int8 (its kernels dequantized) and within 2e-2 in bf16; the HTTP
  server and ``predict_job``'s engine answer with it.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIT = dict(DCT_MODEL="weather_transformer_pp", DCT_SEQ_LEN="16",
           DCT_D_MODEL="16", DCT_N_HEADS="2", DCT_N_LAYERS="4",
           DCT_D_FF="32", DCT_N_STAGES="2", DCT_DROPOUT="0.2",
           DCT_BF16_COMPUTE="0", DCT_OPTIMIZER="sgd", DCT_LR="0.01",
           DCT_MOMENTUM="0.9", DCT_EPOCHS="1")
GLOBAL_BATCH = 16


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _world(processed, models_dir, tmp, *, data=1, model=1, pipe=1,
           resume=False):
    world, port = data * model * pipe, _free_port()
    procs = []
    for r in range(world):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("DCT_") and k not in (
                   "WORLD_SIZE", "NODE_RANK", "MASTER_ADDR", "MASTER_PORT")}
        env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", DCT_DEVICE="cpu",
                   DCT_PROCESSED_DIR=processed, DCT_MODELS_DIR=models_dir,
                   DCT_BATCH_SIZE=str(GLOBAL_BATCH // data),
                   DCT_RESUME="1" if resume else "0",
                   DCT_TRACKING_DIR=str(tmp / "mlruns"),
                   DCT_EVENTS_DIR=os.path.join(models_dir, "events"),
                   DCT_MESH_DATA=str(data), DCT_MESH_MODEL=str(model),
                   DCT_MESH_PIPE=str(pipe), **FIT)
        if world > 1:
            env.update(WORLD_SIZE=str(world), NODE_RANK=str(r),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dct_tpu_torch.train_job"], env=env,
            cwd=str(tmp), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    return procs


def _wait(procs, timeout=240):
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    return [o[1] for o in outs]


def _fit(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("[train_job] fit ")][-1][16:])


MESHES = {"w1": {}, "pipe2": dict(pipe=2), "data2pipe2": dict(data=2, pipe=2),
          "model2pipe2": dict(model=2, pipe=2)}


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """Epoch 1 on one process and on the three pipe worlds, side by side;
    then the control continuation and the two pivots, side by side."""
    from dct_tpu_torch.data.synthetic import generate_weather_csv
    from dct_tpu_torch.etl.preprocess import preprocess_csv_to_parquet

    tmp = tmp_path_factory.mktemp("pp_fit")
    generate_weather_csv(str(tmp / "w.csv"), rows=240, seed=5)
    processed = str(tmp / "processed")
    preprocess_csv_to_parquet(str(tmp / "w.csv"), processed)
    d = {k: str(tmp / k) for k in MESHES}
    started = {k: _world(processed, d[k], tmp, **mesh)
               for k, mesh in MESHES.items()}
    first = {k: _wait(v) for k, v in started.items()}
    for src, dst in (("data2pipe2", "pivot"), ("pipe2", "to_one")):
        d[dst] = str(tmp / dst)
        shutil.copytree(d[src], d[dst])
    started = {
        "control": _world(processed, d["w1"], tmp, resume=True),
        "pivot": _world(processed, d["pivot"], tmp, model=2, pipe=2,
                        resume=True),
        "to_one": _world(processed, d["to_one"], tmp, resume=True),
    }
    second = {k: _wait(v) for k, v in started.items()}
    return d, first, second


@pytest.mark.parametrize("name", ["pipe2", "data2pipe2", "model2pipe2"])
def test_train_job_on_a_pipe_axis_equals_one_process(fits, name):
    _, first, _ = fits
    one = _fit(first["w1"][0])
    assert one["mesh"] == {"data": 1, "model": 1, "seq": 1, "pipe": 1}
    want = {"data": 1, "model": 1, "seq": 1,
            **{k: v for k, v in MESHES[name].items()}}
    want.setdefault("pipe", 1)
    for out in first[name]:
        fit = _fit(out)
        assert fit["mesh"] == want
        assert fit["val_loss"] == pytest.approx(one["val_loss"], abs=1e-5)


@pytest.mark.parametrize("run,saved", [
    ("pivot", {"data": 2, "model": 1, "seq": 1, "pipe": 2}),
    ("to_one", {"data": 1, "model": 1, "seq": 1, "pipe": 2}),
])
def test_a_pivoted_resume_tracks_the_control(fits, run, saved):
    dirs, _, second = fits
    control = _fit(second["control"][0])
    for out in second[run]:
        assert abs(_fit(out)["val_loss"] - control["val_loss"]) <= 1e-5
    with open(os.path.join(dirs[run], "events", "events.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    remaps = [r for r in recs if r["event"] == "shard.topology_remap"]
    assert len(remaps) == len(second[run])
    assert all(r["from_mesh"] == saved for r in remaps)


def _post(port, windows):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/score",
        data=json.dumps({"data": windows.tolist()}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_the_package_is_the_references_and_the_port_serves_it(
        fits, tmp_path):
    from dct_tpu.serving import runtime as ref_runtime
    from dct_tpu_torch.checkpoint.manager import load_checkpoint
    from dct_tpu_torch.config import ServingConfig
    from dct_tpu_torch.serving.batching import TorchScorer
    from dct_tpu_torch.serving.package import load_package
    from dct_tpu_torch.serving.quant import quantize_package
    from dct_tpu_torch.serving.score_gen import generate_score_package
    from dct_tpu_torch.serving.server import make_server

    dirs, _, _ = fits
    # The pivot's last epoch ran on model=2 pipe=2: rank 0's checkpoint
    # is gathered over both, and equals the control continuation's.
    ckpt = os.path.join(dirs["pivot"], "last.ckpt")
    params, meta = load_checkpoint(ckpt)
    stage = params["params"]["pp_stages"]["block_0"]["ffn_in"]["kernel"]
    assert np.shape(stage) == (2, 16, 32)  # dense: both stages, gathered
    one, _ = load_checkpoint(os.path.join(dirs["w1"], "last.ckpt"))
    np.testing.assert_allclose(stage, one["params"]["pp_stages"]["block_0"][
        "ffn_in"]["kernel"], atol=1e-5)
    pkg = str(tmp_path / "pkg")
    generate_score_package(ckpt, pkg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 16, meta["input_dim"])).astype(np.float32)
    for quant, tol in ((None, 1e-5), ("int8", 1e-5), ("bf16", 2e-2)):
        d = pkg
        if quant:
            d = str(tmp_path / f"pkg-{quant}")
            quantize_package(pkg, d, quant)
        weights, pmeta = load_package(d)
        flat = dict(np.load(os.path.join(d, "model.npz")))
        ref_w = ref_runtime.assemble_weights(flat)
        got = TorchScorer(weights, pmeta, "cpu")(x)
        if quant == "int8":
            # The numpy runtime's int8 matmul also quantizes the
            # activation rows: within the package's bound. The torch
            # engine, like the reference's accelerator scorers, computes
            # with the dequantized kernels: those, on the numpy runtime.
            want = ref_runtime.softmax_numpy(
                ref_runtime.forward_numpy(ref_w, pmeta, x))
            assert np.abs(got - want).max() <= pmeta["quant"]["prob_bound"]
            ref_w = {k: v.dequantize() if hasattr(v, "dequantize") else v
                     for k, v in ref_w.items()}
        want = ref_runtime.softmax_numpy(
            ref_runtime.forward_numpy(ref_w, pmeta, x))
        assert np.abs(got - want).max() <= tol, quant
    # predict_job's engine (the mesh engine, one process here).
    from dct_tpu_torch import predict_job

    weights, pmeta = load_package(pkg)
    xs = rng.standard_normal((20, 16, meta["input_dim"])).astype(np.float32)
    got = predict_job.score(weights, pmeta, xs, 8, "torch", "cpu")
    want = ref_runtime.softmax_numpy(ref_runtime.forward_numpy(
        ref_runtime.assemble_weights(dict(np.load(
            os.path.join(pkg, "model.npz")))), pmeta, xs))
    assert np.abs(got - want).max() <= 1e-5
    server = make_server(pkg, device="cpu",
                         serving=ServingConfig(workers=1, engine="torch"))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        got = _post(server.server_address[1], x[:3])["probabilities"]
        weights, pmeta = load_package(pkg)
        want = ref_runtime.softmax_numpy(ref_runtime.forward_numpy(
            ref_runtime.assemble_weights(dict(np.load(
                os.path.join(pkg, "model.npz")))), pmeta, x[:3]))
        assert np.abs(np.asarray(got) - want).max() <= 1e-5
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)
