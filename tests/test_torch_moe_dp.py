"""The port's MoE routing under data parallelism (CPU, two gloo processes).

The reference runs one program over the global batch on a ``data=2``
mesh: its ``einsum`` engine routes over the global batch (global capacity,
global choice-major order), its ``sorted`` engine routes each data shard
alone with the shard's capacity (``_sorted_sharded`` at ep=1), and its
load-balance loss takes global means. The port gives each process one
block of the batch and sums the gradients; its MoE layers all-gather the
choice counts so that the same routing and the same loss come out. Two
gloo processes are held to the JAX package on a ``data=2`` mesh (loss
within 1e-5, gradients within 1e-4 of each one's max) for both engines at
top-1 and top-2 with drops, and ``train_job`` at W=2 for the einsum engine
to the 1-process run (the same model within 1e-5). Every subprocess has a
bound that holds on a loaded machine.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dct_tpu.config import MeshConfig
from dct_tpu.config import ModelConfig as JaxModelConfig
from dct_tpu.models.registry import get_model as jax_get_model
from dct_tpu.ops import losses as jax_losses
from dct_tpu.parallel.mesh import batch_sharding, make_mesh
from dct_tpu.serving.score_gen import _flatten_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F_IN = 5
T = 32
SMALL = dict(name="weather_moe", seq_len=T, d_model=32, n_heads=2,
             n_layers=2, d_ff=64, n_experts=4, capacity_factor=0.5,
             dropout=0.0)
CASES = [("einsum", 1), ("sorted", 1), ("einsum", 2), ("sorted", 2)]

_WORKER = r'''
import json, sys
import numpy as np, torch, torch.distributed as dist
from dct_tpu_torch.config import ModelConfig
from dct_tpu_torch.convert import flax_weights, load_flax_weights
from dct_tpu_torch.models.mlp import set_data_block
from dct_tpu_torch.models.registry import get_model
from dct_tpu_torch.train import state as port_state
from dct_tpu_torch.train import steps

rank, world, port, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)
spec = json.load(open(inp + ".json"))
data = np.load(inp)
x, y, w = data["x"], data["y"], data["w"]
b = len(x) // world
rows = slice(rank * b, (rank + 1) * b)
results = {}
for engine, k in spec["cases"]:
    cfg = ModelConfig(**dict(spec["cfg"], moe_dispatch=engine,
                             router_top_k=k))
    model = get_model(cfg, input_dim=x.shape[-1], device="cpu")
    st = port_state.create_train_state(model, input_dim=x.shape[-1],
                                       lr=1e-3, seed=0)
    load_flax_weights(model, {key[2:]: data[key] for key in data.files
                              if key.startswith("p/")})
    set_data_block(model, world, rank)
    loss, grads = steps.loss_and_grads(st, x[rows], y[rows], w[rows])
    engines = [blk.moe.last_engine for blk in model.blocks()]
    for p, g in zip(st.params, grads):
        p.grad = g
    tag = f"{engine}{k}"
    results[f"{tag}/loss"] = np.float32(float(loss))
    results[f"{tag}/engines"] = np.array(engines)
    for key, value in flax_weights(model, grads=True).items():
        results[f"{tag}/g/{key}"] = value
if rank == 0:
    np.savez(out, **results)
dist.barrier()
dist.destroy_process_group()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DCT_") and k not in (
               "WORLD_SIZE", "NODE_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.update(extra)
    return env


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
    return outs


def _jax_reference(params, x, y, w, engine, k):
    """Loss (CE mean plus the sown load-balance terms) and gradients of
    the reference's MoE on a ``data=2`` mesh, the batch sharded over it."""
    mesh = make_mesh(MeshConfig(data=2), devices=jax.devices()[:2])
    cfg = JaxModelConfig(**dict(SMALL, moe_dispatch=engine, router_top_k=k))
    model = jax_get_model(cfg, input_dim=F_IN, mesh=mesh)

    def loss_fn(p, xb, yb, wb):
        logits, sown = model.apply(p, xb, train=True,
                                   rngs={"dropout": jax.random.PRNGKey(0)},
                                   mutable=["aux_loss"])
        loss_sum, count = jax_losses.masked_cross_entropy(logits, yb, wb)
        return loss_sum / jnp.maximum(count, 1.0) + sum(
            jax.tree.leaves(sown))

    shard = batch_sharding(mesh)
    args = [jax.device_put(jnp.asarray(a), shard) for a in (x, y, w)]
    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, *args)
    return float(loss), _flatten_params(grads["params"])


def test_two_gloo_processes_route_as_the_reference_on_a_data2_mesh(tmp_path):
    jmodel = jax_get_model(JaxModelConfig(**SMALL), input_dim=F_IN)
    params = {"params": jmodel.init(jax.random.PRNGKey(3),
                                    jnp.zeros((1, T, F_IN)),
                                    train=False)["params"]}
    rng = np.random.default_rng(17)
    x = rng.standard_normal((4, T, F_IN)).astype(np.float32)
    y = rng.integers(0, 2, (4,)).astype(np.int32)
    w = np.array([1, 1, 1, 0], np.float32)
    inp = str(tmp_path / "inp.npz")
    np.savez(inp, x=x, y=y, w=w, **{f"p/{k}": np.asarray(v) for k, v in
                                    _flatten_params(params["params"]).items()})
    with open(inp + ".json", "w") as f:
        json.dump({"cfg": SMALL, "cases": CASES}, f)
    out = str(tmp_path / "out.npz")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), "2", str(port), inp, out],
        env=_env(), cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in (0, 1)]
    _wait(procs)
    got = np.load(out)
    losses = {}
    for engine, k in CASES:
        tag = f"{engine}{k}"
        jloss, jgrads = _jax_reference(params, x, y, w, engine, k)
        losses[tag] = jloss
        assert list(got[f"{tag}/engines"]) == [engine] * SMALL["n_layers"]
        assert float(got[f"{tag}/loss"]) == pytest.approx(jloss, rel=1e-5)
        for key, ref in jgrads.items():
            g = got[f"{tag}/g/{key}"]
            ref = np.asarray(ref)
            err = np.abs(g - ref).max() / max(np.abs(ref).max(), 1e-30)
            assert err <= 1e-4, (tag, key, err)
    # The data drop tokens, so global and per-shard routing differ: the
    # two engines' losses are not the same function here.
    for k in (1, 2):
        assert abs(losses[f"einsum{k}"] - losses[f"sorted{k}"]) > 1e-6


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    from dct_tpu_torch.data.synthetic import generate_weather_csv
    from dct_tpu_torch.etl.preprocess import preprocess_csv_to_parquet

    root = tmp_path_factory.mktemp("moe_dp")
    generate_weather_csv(str(root / "w.csv"), rows=203, seed=11)
    preprocess_csv_to_parquet(str(root / "w.csv"), str(root / "processed"))
    return str(root / "processed")


def _train_job(processed, models_dir, tmp_path, *, world, rank, batch, port):
    env = _env(DCT_DEVICE="cpu", DCT_PROCESSED_DIR=processed,
               DCT_MODELS_DIR=models_dir, DCT_EPOCHS="1",
               DCT_BATCH_SIZE=str(batch), DCT_MODEL="weather_moe",
               DCT_SEQ_LEN="16", DCT_D_MODEL="16", DCT_N_HEADS="2",
               DCT_D_FF="32", DCT_CAPACITY_FACTOR="0.5",
               DCT_MOE_DISPATCH="einsum", DCT_DROPOUT="0.2",
               DCT_BF16_COMPUTE="0",
               DCT_TRACKING_DIR=str(tmp_path / "mlruns"))
    if world > 1:
        env.update(WORLD_SIZE=str(world), NODE_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    return subprocess.Popen(
        [sys.executable, "-m", "dct_tpu_torch.train_job"], env=env,
        cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def test_train_job_at_two_processes_equals_one_process(processed, tmp_path):
    """Global routing makes the W=2 world the 1-process program: after an
    epoch (f32 compute, dropout 0.2, a padded last batch) both worlds'
    checkpoints give the same logits within 1e-5 and the same val_loss."""
    import torch

    from dct_tpu_torch.checkpoint.manager import load_checkpoint
    from dct_tpu_torch.convert import load_flax_weights
    from dct_tpu_torch.models.registry import config_from_meta, get_model
    from dct_tpu_torch.serving.score_gen import _serving_weights

    port = _free_port()
    one = str(tmp_path / "one")
    two = [str(tmp_path / "two_r0"), str(tmp_path / "two_r1")]
    procs = [_train_job(processed, one, tmp_path, world=1, rank=0, batch=8,
                        port=0)]
    procs += [_train_job(processed, two[r], tmp_path, world=2, rank=r,
                         batch=4, port=port) for r in (0, 1)]
    outs = _wait(procs)
    assert "processes=2 process_index=1" in outs[2][1]

    def val_loss(out):
        line = [ln for ln in out.splitlines() if "done: val_loss=" in ln][0]
        return float(line.split("val_loss=")[1].split()[0])

    assert val_loss(outs[1][1]) == val_loss(outs[0][1])
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (6, 16, 5)).astype(np.float32))
    logits = []
    for models_dir in (one, two[0]):
        params, meta = load_checkpoint(os.path.join(models_dir, "last.ckpt"))
        model = get_model(config_from_meta(meta), device="cpu")
        load_flax_weights(model, _serving_weights(params["params"],
                                                  "weather_moe"))
        with torch.no_grad():
            logits.append(model(x).numpy())
    assert np.abs(logits[0] - logits[1]).max() <= 1e-5
