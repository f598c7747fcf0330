"""The port's topology re-map of a shard-saved resume (CPU), held to the
JAX package's ``TrainStateCheckpointer``.

- The reference's own drills (``tests/test_sharded_loop.py:423-540``) on
  the port's resume tier: a leaf saved as blocks that no longer match
  this run's placement restores bit for bit, logs
  ``shard.topology_remap`` and sets ``last_remap``, and the reference's
  checkpointer restores the same file to the same values; blocks that do
  not tile are refused; a rank with no file of its own restores from its
  siblings (``exists``, ``load_meta``, the values); a sibling one
  generation behind is refused.
- ``train_job`` gloo worlds: one epoch at ``data=2, model=2`` (ZeRO-1)
  resumed for a second at ``data=4``, and one epoch by 2 processes at
  ``data=2`` resumed by 4 (the new ranks from their siblings' files), each
  within 1e-5 of the val_loss of the control continuation on the saving
  grid, with every rank's re-map on the event log.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F_IN = 5


def _port_state():
    from dct_tpu_torch.config import ModelConfig
    from dct_tpu_torch.models.registry import get_model
    from dct_tpu_torch.train.state import create_train_state

    model = get_model(ModelConfig(name="weather_mlp", hidden_dim=16),
                      input_dim=F_IN, device="cpu")
    st = create_train_state(model, input_dim=F_IN, lr=1e-3, seed=0)
    # Move off the initial values, so a wrong restore cannot pass.
    for p in st.params:
        p.data.add_(0.25)
    st.step = 3
    return st


def _jax_state():
    from dct_tpu.config import ModelConfig
    from dct_tpu.models.registry import get_model
    from dct_tpu.train.state import create_train_state

    model = get_model(ModelConfig(name="weather_mlp", hidden_dim=16),
                      input_dim=F_IN)
    return create_train_state(model, input_dim=F_IN, lr=1e-3, seed=1)


def _split_leaf_into_shards(npz_path: str, parts: int = 2) -> str:
    """The reference's helper: one whole 2-D leaf rewritten as
    offset-keyed blocks, the file another saving topology writes."""
    with np.load(npz_path) as npz:
        entries = {k: npz[k] for k in npz.files}
    key = next(k for k in entries if "_s" not in k
               and entries[k].ndim == 2 and entries[k].shape[0] % parts == 0)
    arr = entries.pop(key)
    h = arr.shape[0] // parts
    for p in range(parts):
        entries[f"{key}_s{p * h}x0"] = arr[p * h:(p + 1) * h]
    with open(npz_path, "wb") as f:
        np.savez(f, **entries)
    return key


def _save(tmp_path, rank=0, epochs=3):
    from dct_tpu_torch.checkpoint.manager import TrainStateCheckpointer

    st = _port_state()
    ck = TrainStateCheckpointer(str(tmp_path / "ts" / f"p{rank}"))
    ck.save(st, meta={"epochs_completed": epochs})
    return st, ck


def _leaves(state):
    from dct_tpu_torch.checkpoint.manager import state_leaves

    return [np.asarray(a) for a in state_leaves(state)]


def _npz(ck):
    return os.path.join(ck.dirpath, "state", "state.npz")


def test_remap_restores_bitwise_logs_the_event_and_matches_the_reference(
        tmp_path):
    import jax

    from dct_tpu.checkpoint.manager import TrainStateCheckpointer as RefCk
    from dct_tpu.observability import events as ref_events
    from dct_tpu_torch.observability import events

    st, ck = _save(tmp_path)
    _split_leaf_into_shards(_npz(ck))
    log = str(tmp_path / "events.jsonl")
    events.set_default(events.EventLog(log, run_id="remap"))
    try:
        restored = ck.restore(_port_state_fresh())
    finally:
        events.set_default(None)
    for a, b in zip(_leaves(st), _leaves(restored)):
        assert np.array_equal(a, b)
    assert ck.last_remap["leaves"] == 1
    assert ck.last_remap["from_mesh"]["data"] == 1
    assert ck.last_remap["from_processes"] == 1
    with open(log) as f:
        recs = [json.loads(line) for line in f]
    assert [r["leaves"] for r in recs
            if r["event"] == "shard.topology_remap"] == [1]
    # The reference restores the port's re-keyed file alike.
    ref_log = str(tmp_path / "ref_events.jsonl")
    prev = ref_events.get_default()
    ref_events.set_default(ref_events.EventLog(ref_log, run_id="r"))
    try:
        ref_ck = RefCk(ck.dirpath)
        theirs = ref_ck.restore(_jax_state())
    finally:
        ref_events.set_default(prev)
    tree = {"opt_state": theirs.opt_state, "params": theirs.params,
            "rng": theirs.rng, "step": theirs.step}
    ref_leaves = [np.asarray(jax.device_get(a))
                  for a in jax.tree.leaves(tree)]
    assert ref_ck.last_remap["leaves"] == ck.last_remap["leaves"]
    for a, b in zip(_leaves(restored), ref_leaves):
        assert np.array_equal(a, b.astype(a.dtype))


def _port_state_fresh():
    from dct_tpu_torch.config import ModelConfig
    from dct_tpu_torch.models.registry import get_model
    from dct_tpu_torch.train.state import create_train_state

    model = get_model(ModelConfig(name="weather_mlp", hidden_dim=16),
                      input_dim=F_IN, device="cpu")
    return create_train_state(model, input_dim=F_IN, lr=1e-3, seed=9)


def test_remap_refuses_blocks_that_do_not_tile(tmp_path):
    _, ck = _save(tmp_path)
    key = _split_leaf_into_shards(_npz(ck))
    with np.load(_npz(ck)) as npz:
        entries = {k: npz[k] for k in npz.files}
    entries.pop(next(k for k in entries if k.startswith(f"{key}_s0")))
    with open(_npz(ck), "wb") as f:
        np.savez(f, **entries)
    with pytest.raises(ValueError, match="do not tile") as e:
        ck.restore(_port_state_fresh())
    assert "shared filesystem" in str(e.value)
    assert "clear the train_state dir" in str(e.value)


def _move_shard_to_sibling(tmp_path, ck, key, epochs):
    with np.load(_npz(ck)) as npz:
        entries = {k: npz[k] for k in npz.files}
    shard = next(k for k in entries if k.startswith(f"{key}_s0"))
    p1 = tmp_path / "ts" / "p1" / "state"
    os.makedirs(p1)
    with open(p1 / "state.npz", "wb") as f:
        np.savez(f, **{shard: entries.pop(shard)})
    with open(p1 / "meta.json", "w") as f:
        json.dump({"epochs_completed": epochs}, f)
    with open(_npz(ck), "wb") as f:
        np.savez(f, **entries)


def test_growth_restores_from_siblings(tmp_path):
    from dct_tpu_torch.checkpoint.manager import TrainStateCheckpointer

    st, ck = _save(tmp_path, epochs=5)
    key = _split_leaf_into_shards(_npz(ck))
    _move_shard_to_sibling(tmp_path, ck, key, epochs=5)
    # Rank 0 needs its sibling's block now ...
    for a, b in zip(_leaves(st), _leaves(ck.restore(_port_state_fresh()))):
        assert np.array_equal(a, b)
    # ... and a new rank with no directory restores from siblings alone.
    ck2 = TrainStateCheckpointer(str(tmp_path / "ts" / "p2"))
    assert ck2.exists()
    assert ck2.load_meta()["epochs_completed"] == 5
    for a, b in zip(_leaves(st), _leaves(ck2.restore(_port_state_fresh()))):
        assert np.array_equal(a, b)
    assert ck2.last_remap["leaves"] == 1


def test_a_stale_sibling_is_refused(tmp_path):
    st, ck = _save(tmp_path, epochs=5)
    key = _split_leaf_into_shards(_npz(ck))
    _move_shard_to_sibling(tmp_path, ck, key, epochs=4)
    with pytest.raises(ValueError, match="do not tile"):
        ck.restore(_port_state_fresh())


# ------------------------------------------------------ train_job worlds


FIT = dict(DCT_MODEL="weather_transformer", DCT_SEQ_LEN="16",
           DCT_D_MODEL="16", DCT_N_HEADS="2", DCT_N_LAYERS="1",
           DCT_D_FF="32", DCT_DROPOUT="0.2", DCT_BF16_COMPUTE="0",
           DCT_OPTIMIZER="sgd", DCT_LR="0.01", DCT_MOMENTUM="0.9")
GLOBAL_BATCH = 8


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _world(processed, models_dir, tmp, *, data, model, epochs,
           resume=False, **extra):
    world, port = data * model, _free_port()
    procs = []
    for r in range(world):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("DCT_") and k not in (
                   "WORLD_SIZE", "NODE_RANK", "MASTER_ADDR", "MASTER_PORT")}
        env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", DCT_DEVICE="cpu",
                   DCT_PROCESSED_DIR=processed, DCT_MODELS_DIR=models_dir,
                   DCT_EPOCHS=str(epochs),
                   DCT_BATCH_SIZE=str(GLOBAL_BATCH // data),
                   DCT_RESUME="1" if resume else "0",
                   DCT_TRACKING_DIR=str(tmp / "mlruns"),
                   DCT_EVENTS_DIR=os.path.join(models_dir, "events"),
                   DCT_MESH_DATA=str(data), DCT_MESH_MODEL=str(model),
                   **FIT, **extra)
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


@pytest.fixture(scope="module")
def pivots(tmp_path_factory):
    """Epoch 1 at data=2 model=2 and at data=2 (2 processes), ZeRO-1;
    then the control continuation on the saving grid, the pivot to
    data=4 and the growth to 4 processes, side by side."""
    from dct_tpu_torch.data.synthetic import generate_weather_csv
    from dct_tpu_torch.etl.preprocess import preprocess_csv_to_parquet

    tmp = tmp_path_factory.mktemp("remap_worlds")
    generate_weather_csv(str(tmp / "w.csv"), rows=240, seed=5)
    processed = str(tmp / "processed")
    preprocess_csv_to_parquet(str(tmp / "w.csv"), processed)
    d = {k: str(tmp / k) for k in ("grid", "two")}
    zero1 = {"DCT_SHARD_OPT_STATE": "1"}
    _wait(_world(processed, d["grid"], tmp, data=2, model=2, epochs=1,
                 **zero1)
          + _world(processed, d["two"], tmp, data=2, model=1, epochs=1,
                   **zero1))
    for src, dst in (("grid", "pivot"), ("two", "grown")):
        d[dst] = str(tmp / dst)
        shutil.copytree(d[src], d[dst])
    procs = {
        "control": _world(processed, d["grid"], tmp, data=2, model=2,
                          epochs=1, resume=True, **zero1),
        "pivot": _world(processed, d["pivot"], tmp, data=4, model=1,
                        epochs=1, resume=True, **zero1),
        "grown": _world(processed, d["grown"], tmp, data=4, model=1,
                        epochs=1, resume=True, **zero1),
    }
    outs = {k: _wait(v) for k, v in procs.items()}
    return d, outs


@pytest.mark.parametrize("run", ["pivot", "grown"])
def test_a_pivoted_resume_tracks_the_control_continuation(pivots, run):
    dirs, outs = pivots
    control = _fit(outs["control"][0])
    fits = [_fit(o) for o in outs[run]]
    assert len({f["val_loss"] for f in fits}) == 1
    assert fits[0]["mesh"] == {"data": 4, "model": 1, "seq": 1, "pipe": 1}
    assert abs(fits[0]["val_loss"] - control["val_loss"]) <= 1e-5
    # Every rank re-mapped (the new ranks from their siblings), and
    # resumed at epoch 1 of 2.
    with open(os.path.join(dirs[run], "events", "events.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    remaps = [r for r in recs if r["event"] == "shard.topology_remap"]
    assert sorted(r["rank"] for r in remaps) == [0, 1, 2, 3]
    want = ({"data": 2, "model": 2, "seq": 1, "pipe": 1} if run == "pivot"
            else {"data": 2, "model": 1, "seq": 1, "pipe": 1})
    assert all(r["from_mesh"] == want and r["to_processes"] == 4
               for r in remaps)
    # The log holds the saving run's epoch 0 (4 or 2 ranks) and this
    # run's epoch 1, on each of its 4 ranks, once.
    ends = [r["epoch"] for r in recs if r["event"] == "epoch_end"]
    assert (ends.count(0), ends.count(1)) == (4 if run == "pivot" else 2, 4)
