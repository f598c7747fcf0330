"""The port's data-parallel training on ``torch.distributed`` (CPU, gloo).

A 2-process run of ``python -m dct_tpu_torch.train_job`` (gloo, the
reference's ``MASTER_ADDR``/``MASTER_PORT``/``NODE_RANK``/``WORLD_SIZE``
contract, per-process batch 2) against a 1-process run of the same global
batch (4), with dropout 0.2 and a row count that pads the last train and
val batches: after one epoch the parameters agree within 1e-6, as the
reference's block sharding promises (a W-process run is the 1-process
program). Only the coordinator writes ``*.ckpt``; every rank writes its
``train_state/p<rank>`` resume directory. The reduction and the dropout
block draw are pinned in-process.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from dct_tpu_torch.config import DistributedConfig
from dct_tpu_torch.models.mlp import Dropout, set_data_block
from dct_tpu_torch.parallel import distributed, mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def padded_parquet(tmp_path_factory):
    """203 rows: 162 train rows (the last batch of 4 holds 2), 41 val."""
    from dct_tpu.data.synthetic import generate_weather_csv
    from dct_tpu.etl.preprocess import preprocess_csv_to_parquet

    root = tmp_path_factory.mktemp("dp")
    csv = generate_weather_csv(str(root / "w.csv"), rows=203, seed=11)
    preprocess_csv_to_parquet(csv, str(root / "processed"))
    return str(root / "processed")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(processed, models_dir, tmp_path, *, world, rank, batch, port,
            use_scan):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DCT_") and k not in (
               "WORLD_SIZE", "NODE_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=REPO, DCT_DEVICE="cpu", DCT_PROCESSED_DIR=processed,
               DCT_MODELS_DIR=models_dir, DCT_EPOCHS="1",
               DCT_BATCH_SIZE=str(batch), DCT_DROPOUT="0.2",
               DCT_BF16_COMPUTE="0", DCT_USE_SCAN="1" if use_scan else "0",
               DCT_TRACKING_DIR=str(tmp_path / "mlruns"),
               OMP_NUM_THREADS="1")
    if world > 1:
        env.update(WORLD_SIZE=str(world), NODE_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    return subprocess.Popen(
        [sys.executable, "-m", "dct_tpu_torch.train_job"], env=env,
        cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


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
    for rc, out, err in outs:
        assert rc == 0, err[-3000:]
    return outs


def _leaves(models_dir, rank):
    path = os.path.join(models_dir, "train_state", f"p{rank}", "state",
                        "state.npz")
    with np.load(path) as npz:
        return [npz[str(i)] for i in range(len(npz.files))]


@pytest.mark.parametrize("use_scan", [True, False], ids=["scan", "per_batch"])
def test_two_process_gloo_run_matches_one_process(padded_parquet, tmp_path,
                                                  use_scan):
    port = _free_port()
    one = str(tmp_path / "one")
    two = [str(tmp_path / "two_r0"), str(tmp_path / "two_r1")]
    procs = [_launch(padded_parquet, one, tmp_path, world=1, rank=0,
                     batch=4, port=0, use_scan=use_scan)]
    procs += [_launch(padded_parquet, two[r], tmp_path, world=2, rank=r,
                      batch=2, port=port, use_scan=use_scan)
              for r in (0, 1)]
    outs = _wait(procs)
    assert "processes=2 process_index=1" in outs[2][1]
    ref = _leaves(one, 0)
    ranks = [_leaves(two[r], r) for r in (0, 1)]
    assert len(ranks[0]) == len(ref)
    for a, b in zip(ranks[0], ranks[1]):  # replicated state
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ranks[0], ref):
        if a.dtype == np.float32:
            err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
            assert err <= 1e-6, err
        else:  # counts, the step and the dropout key
            np.testing.assert_array_equal(a, b)
    # Deploy checkpoints on the coordinator only; resume dirs on every rank.
    r0, r1 = (sorted(os.listdir(d)) for d in two)
    assert "last.ckpt" in r0 and any(n.startswith("weather-best-00-")
                                     for n in r0)
    assert not any(n.endswith(".ckpt") for n in r1)
    assert os.listdir(os.path.join(two[0], "train_state")) == ["p0"]
    assert os.listdir(os.path.join(two[1], "train_state")) == ["p1"]
    with open(os.path.join(two[0], "last.ckpt"), "rb") as f, \
            open(os.path.join(one, "last.ckpt"), "rb") as g:
        assert len(f.read()) == len(g.read())


def test_initialize_from_env_contract(monkeypatch):
    for k in ("WORLD_SIZE", "NODE_RANK", "MASTER_ADDR", "MASTER_PORT",
              "DCT_NUM_PROCESSES", "DCT_PROCESS_ID",
              "DCT_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    cfg = distributed.initialize_from_env(device="cpu")
    assert (cfg.num_processes, cfg.process_id) == (1, 0)
    assert distributed.process_count() == 1 and distributed.is_coordinator()
    assert mesh.process_data_block() == (1, 0) and not mesh.data_parallel()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        distributed.initialize_from_env(device="cpu")
    from dct_tpu.config import DistributedConfig as JaxDistributedConfig

    monkeypatch.setenv("NODE_RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "pytorch-master")
    assert vars(DistributedConfig.from_env()) == vars(
        JaxDistributedConfig.from_env())


def test_single_process_reduction_is_the_identity():
    ts = [torch.arange(6.0).view(2, 3), torch.tensor(2.5)]
    out = mesh.all_reduce_sum(ts)
    assert all(torch.equal(a, b) for a, b in zip(out, ts))
    assert mesh.all_gather_ints(7) == [7]


def test_dropout_blocks_tile_the_global_mask():
    """Block p of W draws the global batch's mask and keeps its rows, so
    the W blocks' outputs are the 1-process output, row for row."""
    x = torch.randn(8, 3, 4)
    whole = Dropout(0.3).train()
    parts = []
    for p in range(4):
        drop = Dropout(0.3).train()
        drop.block = (4, p)
        parts.append(drop(x[2 * p:2 * p + 2], (5, 9, 0)))
    assert torch.equal(torch.cat(parts), whole(x, (5, 9, 0)))
    model = torch.nn.Sequential(Dropout(0.1), Dropout(0.2))
    set_data_block(model, 2, 1)
    assert [m.block for m in model] == [(2, 1), (2, 1)]
    with pytest.raises(ValueError):
        set_data_block(model, 2, 2)
