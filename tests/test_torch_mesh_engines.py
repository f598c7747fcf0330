"""The port's engines on a mesh (CPU, gloo worlds), held to the JAX
package's multi-device mesh runs on the same numpy inputs.

- ``python -m dct_tpu_torch.predict_job`` on worlds of two processes at
  ``data=2`` (the transformer and the MoE, whose partial last chunk pads
  to the whole chunk), ``model=2`` (tensor-parallel) and ``seq=2`` (the
  ring), T=256: the coordinator's parquet is within 1e-5 of the
  reference's ``_score_jax`` under the same ``DCT_MESH_*``, and the other
  rank writes nothing; ``DCT_PREDICT_DTYPE=bfloat16`` at ``data=2`` and on
  one process is within 2e-2 of the reference's bf16 engine.
- The harness's torch engine on the ``data=2`` and ``model=2`` worlds:
  ``batched_probs`` within 1e-5 of the reference's ``_batched_probs_jax``
  on the same mesh, and ``evaluate_pair`` the same as one process's.
- Per-layer FSDP at ``data=2`` (the units replicated by rules, so every
  leaf splits): three Adam steps equal data parallelism's
  within 1e-5, and no process holds more gathered parameter bytes at once
  than one unit's (no prefetch), against the whole model's that a single
  all-gather held; with units under 1 MiB (all of them at this width)
  held together for the step, one all-gather and
  one reduce-scatter a step, the same steps. Under remat the blocks run
  again in the backward, gathering again, and the forward leaves what
  remat leaves without FSDP.
- Moments stored apart from their parameter by ``DCT_SHARD_RULES``
  (over ``data`` on a kernel's second dim; replicated beside a kernel
  stored over ``data``): three Adam steps equal data parallelism's.
- ``DCT_SHARD_RULES`` layouts outside the family tables (a unit split in
  part and a head on ``model`` at ``model=2``, an input projection on
  ``seq`` at ``seq=2``): logits within 1e-5 and gradients within 1e-4 of
  the reference's mesh run.

All worlds run side by side; every subprocess has a bound that holds on a
loaded machine.
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
import torch

from dct_tpu.config import MeshConfig as JaxMeshConfig
from dct_tpu.config import ModelConfig as JaxModelConfig
from dct_tpu.models.registry import get_model as jax_get_model
from dct_tpu.ops import losses as jax_losses
from dct_tpu.ops.attention import make_attention_fn as jax_attention_fn
from dct_tpu.parallel import mesh as jax_mesh
from dct_tpu.parallel.sharding_rules import (
    match_partition_rules,
    rules_for_family,
)
from dct_tpu.serving.score_gen import _flatten_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 256
F_IN = 5  # the processed weather data's features
F_RULES = 6  # the rule worlds' input, split over seq=2 by one clause
CHUNK = 16
WINDOWS = 300  # 19 chunks, the last of 12 windows
VAL_FRACTION = 0.9  # 14 held-out windows past the T-window gap
TRANSFORMER = dict(name="weather_transformer", seq_len=T, d_model=32,
                   n_heads=4, n_kv_heads=2, n_layers=2, d_ff=64,
                   dropout=0.0)
REMAT = dict(TRANSFORMER, remat=True)
# Moments stored apart from their parameter: over data on a dim ZeRO-1
# does not take, and replicated beside a parameter stored over data.
MOMENTS_APART = ("(mu|nu)/params/block_0/ffn_in/kernel$=-,data;"
                 "(mu|nu)/params/block_1/ffn_out/kernel$=;"
                 "block_1/ffn_out/kernel$=data")
MOE = dict(name="weather_moe", seq_len=32, d_model=32, n_heads=2,
           n_layers=1, d_ff=64, n_experts=4, capacity_factor=1.0,
           dropout=0.0)
# (clause, mesh, the leaves it reshards: both layers' qkv kernels, the
# head kernel, the input projection's kernel).
# The units replicated, so FSDP splits every leaf whose leading dim divides.
REPLICATE_UNITS = "(qkv_proj|o_proj|ffn_in|ffn_out).*="
RULES = {"unit_in_part": ("qkv_proj.*/kernel$=", {"model": 2}, 2),
         "head_on_model": ("head/kernel$=-,model", {"model": 2}, 1),
         "in_proj_on_seq": ("in_proj/kernel$=seq", {"seq": 2}, 1)}

_WORKER = r'''
import json, os, sys
import numpy as np, torch, torch.distributed as dist
from dct_tpu_torch.config import MeshConfig, ModelConfig
from dct_tpu_torch.convert import load_flax_weights
from dct_tpu_torch.models.mlp import set_data_block
from dct_tpu_torch.models.registry import get_model
from dct_tpu_torch.parallel import reshard
from dct_tpu_torch.parallel.mesh import make_mesh, set_mesh
from dct_tpu_torch.parallel.sharding_rules import (
    gather_tree, make_shard_and_gather_fns, shard_state_with_rules)
from dct_tpu_torch.train import state as port_state
from dct_tpu_torch.train import steps
from dct_tpu_torch.checkpoint.manager import _param_order, flatten_tree
from dct_tpu_torch.models.transformer import TransformerBlock

block_calls = [0]
block_forward = TransformerBlock.forward


def counted_forward(self, *args, **kwargs):
    block_calls[0] += 1
    return block_forward(self, *args, **kwargs)


TransformerBlock.forward = counted_forward
collectives = {"gather": 0, "scatter": 0}
all_gather = reshard.all_gather_dims
reduce_scatter = reshard.reduce_scatter_dims


def counted_gather(*args, **kwargs):
    collectives["gather"] += 1
    return all_gather(*args, **kwargs)


def counted_scatter(*args, **kwargs):
    collectives["scatter"] += 1
    return reduce_scatter(*args, **kwargs)


reshard.all_gather_dims = counted_gather
reshard.reduce_scatter_dims = counted_scatter

rank, world, port, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)
spec = json.load(open(inp + ".json"))
data = np.load(inp)
mesh = make_mesh(MeshConfig(**spec["mesh"]))
set_mesh(mesh)
res = {}
for case in spec["cases"]:
    tag = case["tag"]
    if case["kind"] == "eval":
        from dct_tpu_torch.evaluation import harness
        from dct_tpu_torch.serving.score_gen import weights_from_checkpoint
        champ = weights_from_checkpoint(case["champion"])
        chall = weights_from_checkpoint(case["challenger"])
        res[tag + "/probs"] = harness.batched_probs(
            *chall, data["x_eval"], batch_size=case["chunk"],
            engine="torch", device="cpu")
        pair = harness.evaluate_pair(champ, chall, case["processed"],
                                     batch_size=case["chunk"],
                                     val_fraction=case["val_fraction"],
                                     engine="torch", device="cpu")
        res[tag + "/pair"] = np.array(json.dumps(pair.to_dict()))
        res[tag + "/deltas"] = pair.deltas
        continue
    os.environ.pop("DCT_SHARD_RULES", None)
    if case.get("rules"):
        os.environ["DCT_SHARD_RULES"] = case["rules"]
    reshard.UNIT_MIN_BYTES = case.get("unit_min_bytes", 1 << 20)
    cfg = ModelConfig(**case["cfg"])
    x, y, w = (data[f"{a}_t"] for a in "xyw")
    model = get_model(cfg, input_dim=x.shape[-1], device="cpu", mesh=mesh)
    st = port_state.create_train_state(model, input_dim=model.input_dim,
                                       lr=spec["lr"], seed=0)
    load_flax_weights(model, {k[3:]: data[k] for k in data.files
                              if k.startswith("tp/")})
    shard_state_with_rules(st, mesh, family=cfg.name,
                           shard_params=case.get("shard_params", False))
    set_data_block(model, mesh.data_size, mesh.data_index)
    n = len(x) // mesh.data_size
    rows = slice(mesh.data_index * n, (mesh.data_index + 1) * n)
    x, y, w = x[rows], y[rows], w[rows]
    model.eval()
    with torch.no_grad():
        res[tag + "/logits"] = model(torch.from_numpy(x)).numpy()
    gather = make_shard_and_gather_fns(st.layout)[1]
    if case.get("retained"):
        # The bytes a training forward leaves for its backward.
        from torch.profiler import ProfilerActivity, profile
        model.train()
        with profile(activities=[ProfilerActivity.CPU],
                     profile_memory=True) as prof:
            kept = model(torch.from_numpy(x))
        res[tag + "/retained"] = np.array(sum(
            e.self_cpu_memory_usage for e in prof.events()))
        del kept
    reshard.reset_peak()
    block_calls[0] = 0
    collectives.update(gather=0, scatter=0)
    for step in range(case.get("steps", 1)):
        loss, grads = steps.loss_and_grads(st, x, y, w)
        res[f"{tag}/loss{step}"] = np.float32(float(loss))
        if step == 0:
            before = dict(collectives)  # the step's alone are counted
            for i, key, _ in _param_order(model):
                res[f"{tag}/g/{key}"] = gather[i](grads[i])
            collectives.update(before)
        st.apply_gradients(grads, st.grad_norm(grads))
    res[tag + "/block_calls"] = np.array(block_calls[0])
    res[tag + "/collectives"] = np.array([collectives["gather"],
                                          collectives["scatter"]])
    counts = reshard.gathered_bytes()
    units = reshard.unit_bytes(st)
    res[tag + "/gathered"] = np.array([counts["peak"], counts["live"],
                                       max(units or [0]), sum(units),
                                       reshard.step_bytes(st), len(units)])
    res[tag + "/resharded"] = np.array(len(st.layout.resharded()))
    for key, v in flatten_tree(gather_tree(st)["params"]).items():
        res[f"{tag}/p/{key}"] = v
np.savez(out + f".{rank}.npz", **res)
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
    return [o[1] for o in outs]


def _start_worker(tmp, name, mesh, cases, arrays, lr=1e-3):
    inp = str(tmp / f"{name}.npz")
    np.savez(inp, **arrays)
    with open(inp + ".json", "w") as f:
        json.dump({"mesh": mesh, "cases": cases, "lr": lr}, f)
    port, out = _free_port(), str(tmp / f"{name}.out")
    return out, [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), "2", str(port), inp, out],
        env=_env(), cwd=str(tmp), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]


def _start_predict(tmp, name, models, processed, mesh, dtype="float32"):
    port = _free_port()
    procs = []
    for r in range(2):
        env = _env(DCT_DEVICE="cpu", DCT_MODELS_DIR=models,
                   DCT_PROCESSED_DIR=processed, DCT_PREDICT_CHUNK=str(CHUNK),
                   DCT_PREDICT_DTYPE=dtype,
                   DCT_PREDICTIONS=str(tmp / f"{name}.{r}.parquet"),
                   WORLD_SIZE="2", NODE_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   **{f"DCT_MESH_{k.upper()}": str(v)
                      for k, v in mesh.items()})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dct_tpu_torch.predict_job"], env=env,
            cwd=str(tmp), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    return procs


def _checkpoint(root, name, cfg, input_dim=F_IN):
    from dct_tpu_torch.checkpoint.manager import save_checkpoint
    from dct_tpu_torch.models.registry import config_from_meta, get_model

    meta = dict(cfg, model=cfg["name"], input_dim=input_dim, num_classes=2)
    torch.manual_seed(len(name))
    model = get_model(config_from_meta(meta), device="cpu")
    models = os.path.join(root, name)
    save_checkpoint(os.path.join(models, "last.ckpt"), model, meta)
    return models


def _jax_init(cfg, f_in):
    model = jax_get_model(JaxModelConfig(**cfg), input_dim=f_in)
    return model.init(jax.random.PRNGKey(3),
                      jnp.zeros((1, cfg["seq_len"], f_in)),
                      train=False)["params"]


def _batch(seed, b, f_in):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, T, f_in)).astype(np.float32),
            rng.integers(0, 2, (b,)).astype(np.int32),
            np.array([1] * (b - 1) + [0], np.float32))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world of this file, started together."""
    from dct_tpu_torch.data.synthetic import generate_weather_csv
    from dct_tpu_torch.data.windows import make_windows
    from dct_tpu_torch.etl.preprocess import preprocess_csv_to_parquet

    tmp = tmp_path_factory.mktemp("mesh_engines")
    generate_weather_csv(str(tmp / "w.csv"), rows=T + WINDOWS, seed=4)
    processed = str(tmp / "processed")
    preprocess_csv_to_parquet(str(tmp / "w.csv"), processed)
    ckpts = {"tf": _checkpoint(str(tmp), "tf", TRANSFORMER),
             "moe": _checkpoint(str(tmp), "moe", MOE),
             "champ": _checkpoint(str(tmp), "champion", TRANSFORMER)}
    predicts = {
        "data2": ("tf", {"data": 2}, "float32"),
        "moe_data2": ("moe", {"data": 2}, "float32"),
        "model2": ("tf", {"model": 2}, "float32"),
        "seq2": ("tf", {"seq": 2}, "float32"),
        "bf16_data2": ("tf", {"data": 2}, "bfloat16"),
    }
    started = {name: _start_predict(tmp, name, ckpts[c], processed, mesh,
                                    dtype)
               for name, (c, mesh, dtype) in predicts.items()}

    from dct_tpu_torch.data.dataset import load_processed_dataset

    x_eval = make_windows(load_processed_dataset(processed), T).features
    eval_case = dict(kind="eval", tag="eval", chunk=CHUNK,
                     processed=processed, val_fraction=VAL_FRACTION,
                     champion=os.path.join(ckpts["champ"], "last.ckpt"),
                     challenger=os.path.join(ckpts["tf"], "last.ckpt"))
    params = _jax_init(TRANSFORMER, F_RULES)
    x, y, w = _batch(23, 4, F_RULES)
    arrays = {"x_t": x, "y_t": y, "w_t": w,
              "x_eval": np.ascontiguousarray(x_eval, np.float32)}
    arrays.update({f"tp/{k}": np.asarray(v) for k, v in
                   _flatten_params(params).items()})
    workers = {
        "data2": _start_worker(tmp, "w_data2", {"data": 2}, [
            eval_case,
            dict(kind="train", tag="dp", cfg=TRANSFORMER, steps=3),
            dict(kind="train", tag="fsdp", cfg=TRANSFORMER, steps=3,
                 shard_params=True, rules=REPLICATE_UNITS, retained=True,
                 unit_min_bytes=0),
            dict(kind="train", tag="fsdp_step", cfg=TRANSFORMER, steps=3,
                 shard_params=True, rules=REPLICATE_UNITS),
            dict(kind="train", tag="dp_remat", cfg=REMAT, steps=3,
                 retained=True),
            dict(kind="train", tag="fsdp_remat", cfg=REMAT, steps=3,
                 shard_params=True, rules=REPLICATE_UNITS, retained=True,
                 unit_min_bytes=0),
            dict(kind="train", tag="moments_apart", cfg=TRANSFORMER,
                 steps=3, rules=MOMENTS_APART)], arrays),
        "model2": _start_worker(tmp, "w_model2", {"data": 1, "model": 2}, [
            eval_case] + [dict(kind="train", tag=tag, cfg=TRANSFORMER,
                               rules=RULES[tag][0])
                          for tag in ("unit_in_part", "head_on_model")],
            arrays),
        "seq2": _start_worker(tmp, "w_seq2", {"data": 1, "seq": 2}, [
            dict(kind="train", tag="in_proj_on_seq", cfg=TRANSFORMER,
                 rules=RULES["in_proj_on_seq"][0])], arrays),
    }
    predict_out = {name: _wait(p) for name, p in started.items()}
    got = {}
    for name, (out, procs) in workers.items():
        _wait(procs)
        got[name] = [dict(np.load(f"{out}.{r}.npz")) for r in range(2)]
    return dict(tmp=tmp, processed=processed, ckpts=ckpts, got=got,
                predict_out=predict_out, predicts=predicts, params=params,
                arrays=arrays)


def _ref_predict():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "ref_predict_job", os.path.join(REPO, "jobs", "predict.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _use_mesh(monkeypatch, mesh: dict):
    """The reference's entry points under ``DCT_MESH_*``, on as many of
    the 8 virtual devices as the grid has."""
    for k in list(os.environ):
        if k.startswith("DCT_"):
            monkeypatch.delenv(k)
    for k, v in mesh.items():
        monkeypatch.setenv(f"DCT_MESH_{k.upper()}", str(v))
    n = int(np.prod(list(mesh.values())))
    real = jax_mesh.make_mesh
    monkeypatch.setattr(jax_mesh, "make_mesh", lambda cfg=None, **kw: real(
        cfg, devices=jax.devices()[:n]))


def _windows(processed, seq_len):
    from dct_tpu.data.dataset import load_processed_dataset
    from dct_tpu.data.windows import make_windows

    return make_windows(load_processed_dataset(processed), seq_len).features


@pytest.mark.parametrize("name", ["data2", "moe_data2", "model2", "seq2",
                                  "bf16_data2"])
def test_predict_on_a_world_matches_the_reference_mesh_engine(
        worlds, name, monkeypatch):
    from dct_tpu.checkpoint.manager import load_checkpoint
    from dct_tpu_torch.etl.parquet import read_table

    ckpt, mesh, dtype = worlds["predicts"][name]
    tmp = worlds["tmp"]
    # Only the coordinator writes.
    assert not os.path.exists(tmp / f"{name}.1.parquet")
    got = read_table(str(tmp / f"{name}.0.parquet"))
    _use_mesh(monkeypatch, mesh)
    monkeypatch.setenv("DCT_PREDICT_DTYPE", dtype)
    params, meta = load_checkpoint(os.path.join(worlds["ckpts"][ckpt],
                                                "last.ckpt"))
    x = _windows(worlds["processed"], int(meta["seq_len"]))
    want = _ref_predict()._score_jax(params, meta, x, CHUNK)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    for c in range(2):
        assert got[f"prob_{c}"].dtype == np.float32
        np.testing.assert_allclose(got[f"prob_{c}"], want[:, c], atol=tol,
                                   rtol=0, err_msg=name)
    assert list(got) == ["row", "predicted", "prob_0", "prob_1", "label"]
    for out in worlds["predict_out"][name]:
        line = [ln for ln in out.splitlines()
                if ln.startswith("[predict_job] scored ")][0]
        assert f"{dtype}, chunk {CHUNK}" in line


def test_bf16_predict_on_one_process_matches_the_reference(worlds,
                                                           monkeypatch):
    from dct_tpu.checkpoint.manager import load_checkpoint
    from dct_tpu_torch import predict_job
    from dct_tpu_torch.serving.score_gen import weights_from_checkpoint

    path = os.path.join(worlds["ckpts"]["tf"], "last.ckpt")
    x = _windows(worlds["processed"], T)
    weights, meta = weights_from_checkpoint(path)
    got = predict_job.score(weights, meta, x, CHUNK, "torch", "cpu",
                            "bfloat16")
    f32 = predict_job.score(weights, meta, x, CHUNK, "torch", "cpu")
    _use_mesh(monkeypatch, {"data": 1})
    monkeypatch.setenv("DCT_PREDICT_DTYPE", "bfloat16")
    params, meta = load_checkpoint(path)
    want = _ref_predict()._score_jax(params, meta, x, CHUNK)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
    assert np.abs(got - f32).max() > 0  # it did compute in bf16
    with pytest.raises(ValueError, match="DCT_PREDICT_DTYPE"):
        predict_job.score(weights, meta, x, CHUNK, "torch", "cpu", "f16")


@pytest.mark.parametrize("world", ["data2", "model2"])
def test_the_harness_torch_engine_on_a_world(worlds, world, monkeypatch):
    from dct_tpu.evaluation import harness as ref_harness
    from dct_tpu_torch.evaluation import harness
    from dct_tpu_torch.serving.score_gen import weights_from_checkpoint

    mesh = {"data": 2} if world == "data2" else {"data": 1, "model": 2}
    chall = weights_from_checkpoint(os.path.join(worlds["ckpts"]["tf"],
                                                 "last.ckpt"))
    champ = weights_from_checkpoint(os.path.join(worlds["ckpts"]["champ"],
                                                 "last.ckpt"))
    ranks = worlds["got"][world]
    _use_mesh(monkeypatch, mesh)
    want = ref_harness._batched_probs_jax(*chall,
                                          worlds["arrays"]["x_eval"], CHUNK)
    one = harness.evaluate_pair(champ, chall, worlds["processed"],
                                batch_size=CHUNK, engine="torch",
                                val_fraction=VAL_FRACTION, device="cpu")
    for r in ranks:
        np.testing.assert_allclose(r["eval/probs"], want, atol=1e-5, rtol=0)
        pair = json.loads(str(r["eval/pair"]))
        assert pair["paired"] == one.paired
        for side in ("champion", "challenger"):
            mine, theirs = pair[side], one.to_dict()[side]
            assert mine["n"] == theirs["n"]
            assert mine["loss_mean"] == pytest.approx(theirs["loss_mean"],
                                                      abs=1e-6)
            assert mine["accuracy"] == theirs["accuracy"]
        np.testing.assert_allclose(r["eval/deltas"], one.deltas, atol=1e-5)


def test_per_layer_fsdp_equals_dp_and_holds_one_unit_at_a_time(worlds):
    for r in worlds["got"]["data2"]:
        for step in range(3):
            assert float(r[f"fsdp/loss{step}"]) == pytest.approx(
                float(r[f"dp/loss{step}"]), rel=1e-5)
        keys = [k for k in r if k.startswith("dp/p/")]
        assert keys
        for k in keys:
            np.testing.assert_allclose(r[k.replace("dp/", "fsdp/")], r[k],
                                       atol=1e-5, rtol=0, err_msg=k)
        peak, live, unit, whole, step, n = (int(v)
                                            for v in r["fsdp/gathered"])
        # One unit's gathered parameters at most (nothing is prefetched),
        # all released after the steps; the whole model's is what one
        # all-gather of every FSDP leaf held.
        assert 0 < peak <= unit < whole
        assert live == 0 and step == 0
        assert int(r["fsdp/resharded"]) > 0
        assert int(r["dp/gathered"][0]) == 0
        # Each unit a step: gathered for its forward and, where its
        # backward needs its parameters, again; its gradients
        # reduce-scattered once.
        gathers, scatters = r["fsdp/collectives"].tolist()
        assert scatters == 3 * n and 3 * n < gathers <= 2 * 3 * n


def test_small_units_are_gathered_once_a_step_and_equal_dp(worlds):
    for r in worlds["got"]["data2"]:
        for step in range(3):
            assert float(r[f"fsdp_step/loss{step}"]) == pytest.approx(
                float(r[f"dp/loss{step}"]), rel=1e-5)
        for k in (k for k in r if k.startswith("dp/p/")):
            np.testing.assert_allclose(r[k.replace("dp/", "fsdp_step/")],
                                       r[k], atol=1e-5, rtol=0, err_msg=k)
        # Every unit is below the default 1 MiB: all held together for
        # the step, one all-gather and one reduce-scatter a step.
        peak, live, unit, whole, step, n = (
            int(v) for v in r["fsdp_step/gathered"])
        assert (unit, whole, n, live) == (0, 0, 0, 0)
        assert peak == step == int(r["fsdp/gathered"][3])
        assert r["fsdp_step/collectives"].tolist() == [3, 3]


def test_per_layer_fsdp_under_remat_recomputes_and_equals_dp(worlds):
    for r in worlds["got"]["data2"]:
        for step in range(3):
            assert float(r[f"fsdp_remat/loss{step}"]) == pytest.approx(
                float(r[f"dp/loss{step}"]), rel=1e-5)
        for k in (k for k in r if k.startswith("dp/p/")):
            np.testing.assert_allclose(r[k.replace("dp/", "fsdp_remat/")],
                                       r[k], atol=1e-5, rtol=0, err_msg=k)
        # Each block ran again in its backward (remat's rerun), gathering
        # its parameters again, held one unit at a time.
        n = TRANSFORMER["n_layers"] * 3
        assert int(r["fsdp/block_calls"]) == n
        assert int(r["dp_remat/block_calls"]) == 2 * n
        assert int(r["fsdp_remat/block_calls"]) == 2 * n
        peak, live, unit, whole, _, _ = (
            int(v) for v in r["fsdp_remat/gathered"])
        assert 0 < peak <= unit and live == 0
        # The forward leaves what remat leaves without FSDP, far less
        # than FSDP without remat. The profiler may also count the
        # all-gathers' flat buffers (inputs and outputs, under twice the
        # whole model's) as kept: when gloo's thread drops them last, it
        # frees them out of the profiler's view.
        kept = {t: int(r[f"{t}/retained"])
                for t in ("fsdp", "dp_remat", "fsdp_remat")}
        assert kept["fsdp_remat"] <= kept["dp_remat"] + 2 * whole, kept
        assert kept["fsdp_remat"] < 0.2 * kept["fsdp"], kept


def test_moments_stored_apart_train_as_data_parallelism(worlds):
    for r in worlds["got"]["data2"]:
        assert int(r["moments_apart/resharded"]) == 1
        for step in range(3):
            assert float(r[f"moments_apart/loss{step}"]) == pytest.approx(
                float(r[f"dp/loss{step}"]), rel=1e-5)
        for k in (k for k in r if k.startswith("dp/p/")):
            np.testing.assert_allclose(
                r[k.replace("dp/", "moments_apart/")], r[k], atol=1e-5,
                rtol=0, err_msg=k)


def _jax_loss_and_grads(cfg, params, x, y, w, mesh):
    model = jax_get_model(JaxModelConfig(**cfg), input_dim=x.shape[-1],
                          attn_fn=jax_attention_fn(mesh), mesh=mesh)
    shard = jax.tree.map(
        lambda s: jax.sharding.NamedSharding(mesh, s),
        match_partition_rules(rules_for_family(cfg["name"]),
                              {"params": params}))
    placed = jax.device_put({"params": params}, shard)

    def loss_fn(p):
        logits = model.apply(p, jnp.asarray(x), train=True,
                             rngs={"dropout": jax.random.PRNGKey(0)})
        loss_sum, count = jax_losses.masked_cross_entropy(
            logits, jnp.asarray(y), jnp.asarray(w))
        return loss_sum / jnp.maximum(count, 1.0)

    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(placed)
        logits = jax.jit(lambda p: model.apply(p, jnp.asarray(x)))(placed)
    return (float(loss), _flatten_params(jax.device_get(grads)["params"]),
            np.asarray(logits))


@pytest.mark.parametrize("tag", sorted(RULES))
def test_rule_layouts_match_the_reference_mesh_run(worlds, tag,
                                                   monkeypatch):
    rules, mesh, resharded = RULES[tag]
    world = "seq2" if "seq" in mesh else "model2"
    monkeypatch.setenv("DCT_SHARD_RULES", rules)
    jmesh = jax_mesh.make_mesh(JaxMeshConfig(**mesh),
                               devices=jax.devices()[:2])
    a = worlds["arrays"]
    loss, grads, logits = _jax_loss_and_grads(
        TRANSFORMER, worlds["params"], a["x_t"], a["y_t"], a["w_t"], jmesh)
    for r in worlds["got"][world]:
        assert int(r[f"{tag}/resharded"]) == resharded
        np.testing.assert_allclose(r[f"{tag}/logits"], logits, atol=1e-5,
                                   rtol=0)
        assert float(r[f"{tag}/loss0"]) == pytest.approx(loss, rel=1e-5)
        for key, ref in grads.items():
            g, ref = r[f"{tag}/g/{key}"], np.asarray(ref)
            assert g.shape == ref.shape, (tag, key)
            err = np.abs(g - ref).max() / max(np.abs(ref).max(), 1e-30)
            assert err <= 1e-4, (tag, key, err)
