"""The MoE, the GRU and ZeRO-1/FSDP on the port's seq axis (CPU, gloo
worlds), held to the JAX package's multi-device mesh run.

- ``weather_moe`` on ``seq=2`` (ring), ``seq=2`` (a2a, GQA), ``data=2,
  seq=2`` and ``model=2, seq=2`` (experts split): each rank's logits, its
  share of the load-balance term and every layer's MoE output at its
  positions equal the reference's (its ring or a2a attention and its
  routing over the global tokens on 8 virtual devices) within 1e-5, with
  a capacity tight enough that tokens drop (each rank drops the tokens
  the reference drops, and some do); the first step's loss within 1e-5
  and gradients within 1e-4 of each leaf's max; 3 SGD steps (momentum
  0.9) within 1e-5. ``einsum`` and ``sorted``, top-1 and top-2 are spread
  over the grids.
- The sorted engine's tiling test: on a ``model=2, seq=2`` world whose
  shards do not tile, ``sorted`` raises the reference's message on every
  rank and ``auto`` takes ``einsum``; the batch-1 escape.
- ``weather_gru`` at ``seq=2`` (replicated over seq): loss and gradients
  equal one process's and the reference's (1e-5 / 1e-4), not twice them.
- ZeRO-1 and FSDP at ``data=2, seq=2``: each rank's state specs equal the
  reference's ``state_shardings`` on that mesh, 3 steps equal data
  parallelism on the same grid within 1e-6, and a shard-saved resume on
  the saving topology continues bitwise.

All worlds start at once in one module fixture, and the reference runs
while they do; every subprocess has a bound that holds on a loaded
machine.
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

from dct_tpu.config import MeshConfig as JaxMeshConfig
from dct_tpu.config import ModelConfig as JaxModelConfig
from dct_tpu.models.moe import MoEFFN as JaxMoEFFN
from dct_tpu.models.registry import get_model as jax_get_model
from dct_tpu.ops import losses as jax_losses
from dct_tpu.ops.attention import make_attention_fn as jax_attention_fn
from dct_tpu.parallel import sharding_rules as ref_rules
from dct_tpu.parallel.mesh import batch_sharding
from dct_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dct_tpu.serving.score_gen import _flatten_params
from dct_tpu.train.state import create_train_state as jax_create_state
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F_IN = 5
T = 256
BATCH = 4
LR, MOMENTUM, STEPS = 0.01, 0.9, 3
MOE = dict(name="weather_moe", seq_len=T, d_model=64, n_heads=4,
           n_layers=2, d_ff=128, n_experts=4, capacity_factor=0.5,
           dropout=0.0)
GRU = dict(name="weather_gru", seq_len=32, hidden_dim=32, n_layers=2,
           dropout=0.0)
POOLED = dict(name="weather_transformer", seq_len=T, d_model=32, n_heads=4,
              n_layers=2, d_ff=64, dropout=0.0)
ZERO_FLAGS = {"dp": {}, "zero1": {"shard_opt": True},
              "fsdp": {"shard_params": True}}
TILING_T = 6  # seq=2 shards of 3 tokens: no two model chunks

# Per world: the mesh, DCT_SP_ENGINE, the MoE cases (engine, top-k and
# config changes), whether it runs the GRU, ZeRO-1/FSDP and the tiling
# drill.
WORLDS = {
    "seq2_ring": (dict(data=1, model=1, seq=2), "ring",
                  [("einsum", 1, {}), ("sorted", 2, {})],
                  dict(gru=True)),
    "seq2_a2a": (dict(data=1, model=1, seq=2), "a2a",
                 [("sorted", 1, dict(n_kv_heads=2, pos_embed="rope")),
                  ("einsum", 2, dict(n_kv_heads=2))], {}),
    "data2seq2": (dict(data=2, model=1, seq=2), "ring",
                  [("einsum", 2, {}), ("sorted", 1, {})],
                  dict(zero=True)),
    "model2seq2": (dict(data=1, model=2, seq=2), "ring",
                   [("sorted", 1, {}), ("einsum", 2, {})],
                   dict(tiling=True)),
}

_WORKER = r'''
import json, os, sys
import numpy as np, torch, torch.distributed as dist
from dct_tpu_torch.checkpoint.manager import (TrainStateCheckpointer,
                                              flatten_tree)
from dct_tpu_torch.config import MeshConfig, ModelConfig
from dct_tpu_torch.convert import load_flax_weights
from dct_tpu_torch.models.mlp import set_data_block
from dct_tpu_torch.models.registry import get_model
from dct_tpu_torch.parallel.mesh import make_mesh, set_mesh
from dct_tpu_torch.parallel.sharding_rules import (
    gather_tree, layout_mismatches, shard_state_with_rules, state_shardings)
from dct_tpu_torch.train import state as port_state
from dct_tpu_torch.train import steps

rank, world, port, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)
spec = json.load(open(inp + ".json"))
data = np.load(inp)
mesh = make_mesh(MeshConfig(**spec["mesh"]))
set_mesh(mesh)
res = {"seq_index": np.int64(mesh.seq_index),
       "data_index": np.int64(mesh.data_index)}
specs = {}


def block(a):
    n = len(a) // mesh.data_size
    return a[mesh.data_index * n:(mesh.data_index + 1) * n]


def state(cfg, **kw):
    model = get_model(ModelConfig(**cfg), input_dim=5, device="cpu",
                      mesh=mesh)
    st = port_state.create_train_state(
        model, input_dim=5, lr=spec["lr"], seed=0, optimizer="sgd",
        momentum=spec["momentum"], mesh=mesh, family=cfg["name"], **kw)
    set_data_block(model, mesh.data_size, mesh.data_index)
    return st


def weights(st, tag, family):
    pre = tag + "/params/"
    load_flax_weights(st.model, {k[len(pre):]: data[k] for k in data.files
                                 if k.startswith(pre)})
    shard_state_with_rules(st, mesh, family=family)


def dense_grads(st, grads):
    """The update-space gradients gathered dense (no ZeRO leaves)."""
    params = st.params
    saved = [p.data for p in params]
    for p, g in zip(params, grads):
        p.data = g
    flat = flatten_tree(gather_tree(st)["params"])
    for p, s in zip(params, saved):
        p.data = s
    return flat


def batch(tag, i):
    return [block(data[f"{tag}/{n}{i}"]) for n in "xyw"]


def run_steps(st, tag, n, start=0):
    step = steps.make_train_step()
    losses = []
    for i in range(start, start + n):
        st, m = step(st, *batch(tag, i))
        losses.append(float(m["train_loss"]))
    return losses


for case in spec["moe"]:
    tag, cfg = case["tag"], case["cfg"]
    model = get_model(ModelConfig(**cfg), input_dim=5, device="cpu",
                      mesh=mesh)
    st = port_state.create_train_state(
        model, input_dim=5, lr=spec["lr"], seed=0, optimizer="sgd",
        momentum=spec["momentum"])
    weights(st, tag, cfg["name"])
    set_data_block(model, mesh.data_size, mesh.data_index)
    outs = []
    hooks = [blk.moe.register_forward_hook(
        lambda m, i, o: outs.append(o.detach().numpy())) for blk in
        model.blocks()]
    model.train()
    x, y, w = batch(tag, 0)
    with torch.no_grad():
        res[f"{tag}/logits"] = model(torch.from_numpy(x)).numpy()
    res[f"{tag}/aux"] = np.float32(float(model.aux_loss()))
    for h in hooks:
        h.remove()
    for i, o in enumerate(outs):
        res[f"{tag}/moe{i}"] = o
    res[f"{tag}/engines"] = np.array([b.moe.last_engine
                                      for b in model.blocks()])
    loss, grads = steps.loss_and_grads(st, x, y, w)
    res[f"{tag}/loss0"] = np.float32(float(loss))
    for k, v in dense_grads(st, grads).items():
        res[f"{tag}/g/{k}"] = v
    res[f"{tag}/losses"] = np.array(run_steps(st, tag, spec["steps"]))
    for k, v in flatten_tree(gather_tree(st)["params"]).items():
        res[f"{tag}/p/{k}"] = v

if spec.get("tiling"):
    for dispatch in ("sorted", "auto"):
        cfg = dict(spec["moe_cfg"], seq_len=spec["tiling_t"],
                   moe_dispatch=dispatch, moe_auto_threshold=0)
        st = state(cfg)
        x = torch.from_numpy(data["tiling/x"])
        try:
            with torch.no_grad():
                st.model(x)
            res[f"tiling/{dispatch}"] = np.array(
                [b.moe.last_engine for b in st.model.blocks()])
        except ValueError as e:
            res[f"tiling/{dispatch}"] = np.array([str(e)])

if spec.get("gru"):
    cfg = spec["gru_cfg"]
    model = get_model(ModelConfig(**cfg), input_dim=5, device="cpu",
                      mesh=mesh)
    st = port_state.create_train_state(model, input_dim=5, lr=spec["lr"],
                                       seed=0, optimizer="sgd",
                                       momentum=spec["momentum"])
    weights(st, "gru", "weather_gru")
    loss, grads = steps.loss_and_grads(st, *batch("gru", 0))
    res["gru/loss0"] = np.float32(float(loss))
    for k, v in dense_grads(st, grads).items():
        res[f"gru/g/{k}"] = v

if spec.get("zero"):
    for mode, kw in spec["zero_flags"].items():
        st = state(spec["pooled_cfg"], **kw)
        declared = state_shardings(st, mesh, family="weather_transformer",
                                   **kw)
        specs[mode] = {k: list(v) for k, v in declared.items()}
        res[f"{mode}/drift"] = np.int64(len(layout_mismatches(st,
                                                              declared)))
        res[f"{mode}/param_elems"] = np.int64(sum(
            st.stored_param(i).numel() for i in range(len(st.params))))
        res[f"{mode}/losses"] = np.array(run_steps(st, "pooled", 2))
        if mode != "dp":
            ck = TrainStateCheckpointer(os.path.join(
                os.path.dirname(out), mode, f"p{rank}"))
            ck.save(st, {"epochs_completed": 1})
        res[f"{mode}/last"] = np.array(run_steps(st, "pooled", 1, 2))
        for k, v in flatten_tree(gather_tree(st)["params"]).items():
            res[f"{mode}/p/{k}"] = v
        if mode != "dp":
            fresh = state(spec["pooled_cfg"], **kw)
            ck.restore(fresh)
            res[f"{mode}/resumed_last"] = np.array(
                run_steps(fresh, "pooled", 1, 2))
            for k, v in flatten_tree(gather_tree(fresh)["params"]).items():
                res[f"{mode}/resumed/{k}"] = v

np.savez(f"{out}.{rank}.npz", **res)
with open(f"{out}.{rank}.json", "w") as f:
    json.dump(specs, f)
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
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", **extra)
    return env


def _jax_params(cfg, seed):
    """A flax init of ``cfg`` (its own seed) as flat numpy arrays."""
    model = jax_get_model(JaxModelConfig(**cfg), input_dim=F_IN)
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, cfg["seq_len"], F_IN)),
                        train=False)["params"]
    return {k: np.asarray(v) for k, v in _flatten_params(params).items()}


def _batches(arrays, tag, seed, t, n=STEPS):
    rng = np.random.default_rng(seed)
    for i in range(n):
        arrays[f"{tag}/x{i}"] = rng.standard_normal(
            (BATCH, t, F_IN)).astype(np.float32)
        arrays[f"{tag}/y{i}"] = rng.integers(0, 2, BATCH).astype(np.int32)
        arrays[f"{tag}/w{i}"] = np.array([1, 1, 1, 0], np.float32)


def _moe_cfg(engine, k, extra):
    return dict(MOE, moe_dispatch=engine, router_top_k=k, **extra)


def _start(tmp, name):
    mesh, engine, cases, extra = WORLDS[name]
    world = mesh["data"] * mesh["model"] * mesh["seq"]
    arrays, moe = {}, []
    for i, (dispatch, k, changes) in enumerate(cases):
        tag = f"moe_{dispatch}{k}"
        cfg = _moe_cfg(dispatch, k, changes)
        for key, v in _jax_params(cfg, 10 + i).items():
            arrays[f"{tag}/params/{key}"] = v
        _batches(arrays, tag, 20 + i, T)
        moe.append(dict(tag=tag, cfg=cfg))
    spec = {"mesh": mesh, "moe": moe, "lr": LR, "momentum": MOMENTUM,
            "steps": STEPS, **extra}
    if extra.get("gru"):
        for key, v in _jax_params(GRU, 30).items():
            arrays[f"gru/params/{key}"] = v
        _batches(arrays, "gru", 31, GRU["seq_len"], 1)
        spec["gru_cfg"] = GRU
    if extra.get("zero"):
        _batches(arrays, "pooled", 40, T)
        spec.update(pooled_cfg=POOLED, zero_flags=ZERO_FLAGS)
    if extra.get("tiling"):
        arrays["tiling/x"] = np.random.default_rng(50).standard_normal(
            (1, TILING_T, F_IN)).astype(np.float32)
        spec.update(moe_cfg=MOE, tiling_t=TILING_T)
    inp = str(tmp / "inp.npz")
    np.savez(inp, **arrays)
    with open(inp + ".json", "w") as f:
        json.dump(spec, f)
    out = str(tmp / "out")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world), str(port), inp,
         out], env=_env(DCT_SP_ENGINE=engine), cwd=str(tmp),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    return dict(name=name, procs=procs, out=out, arrays=arrays, spec=spec,
                world=world)


def _finish(started, timeout=300):
    outs = []
    try:
        for p in started["procs"]:
            _, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, err))
    finally:
        for p in started["procs"]:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, err in outs:
        assert rc == 0, err[-3000:]
    out = started["out"]
    ranks = []
    for r in range(started["world"]):
        got = dict(np.load(f"{out}.{r}.npz"))
        with open(f"{out}.{r}.json") as f:
            got["specs"] = json.load(f)
        ranks.append(got)
    return ranks


def _jax_mesh(mesh):
    n = mesh["data"] * mesh["model"] * mesh["seq"]
    return jax_make_mesh(JaxMeshConfig(**mesh), devices=jax.devices()[:n])


def _tree(flat):
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *path, last = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = jnp.asarray(v)
    return {"params": tree}


def _is_moe(mdl, name):
    return isinstance(mdl, JaxMoEFFN) and name == "__call__"


def _reference_moe(jmesh, engine, cfg, arrays, tag, monkeypatch):
    """The reference's mesh run of one case: the first forward's logits,
    sown load-balance terms and MoE outputs, then ``STEPS`` SGD steps
    (optax's ``trace`` then the rate, in numpy) with each step's loss and
    the first step's gradients."""
    monkeypatch.setenv("DCT_SP_ENGINE", engine)
    model = jax_get_model(JaxModelConfig(**cfg), input_dim=F_IN,
                          mesh=jmesh, attn_fn=jax_attention_fn(jmesh))

    def loss_fn(p, xb, yb, wb):
        logits, state = model.apply(
            p, xb, train=True, rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["aux_loss", "intermediates"],
            capture_intermediates=_is_moe)
        loss_sum, count = jax_losses.masked_cross_entropy(logits, yb, wb)
        aux = sum(jax.tree.leaves(state["aux_loss"]))
        moe = [state["intermediates"][f"block_{i}"]["moe"]["__call__"][0]
               for i in range(cfg["n_layers"])]
        return loss_sum / jnp.maximum(count, 1.0) + aux, (logits, aux, moe)

    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    pre = f"{tag}/params/"
    params = {k[len(pre):]: arrays[k] for k in arrays if k.startswith(pre)}
    trace = {k: np.zeros_like(v) for k, v in params.items()}
    shard = batch_sharding(jmesh)
    out = {"losses": []}
    with jmesh:
        for i in range(STEPS):
            batch = [jax.device_put(jnp.asarray(arrays[f"{tag}/{n}{i}"]),
                                    shard) for n in "xyw"]
            (loss, aux_out), grads = fn(_tree(params), *batch)
            grads = {k: np.asarray(v) for k, v in
                     _flatten_params(grads["params"]).items()}
            if i == 0:
                logits, aux, moe = aux_out
                out.update(logits=np.asarray(logits), aux=float(aux),
                           moe=[np.asarray(m) for m in moe], grads=grads)
            out["losses"].append(float(loss))
            for k in params:
                trace[k] = grads[k] + np.float32(MOMENTUM) * trace[k]
                params[k] = params[k] + np.float32(-LR) * trace[k]
    out["params"] = params
    return out


@pytest.fixture(scope="module")
def sp_families(tmp_path_factory):
    """Every world started at once; then each world's results with the
    reference's mesh run of its MoE cases."""
    started = [_start(tmp_path_factory.mktemp(name), name)
               for name in WORLDS]
    refs = {}
    with pytest.MonkeyPatch.context() as mp:
        for st in started:
            mesh, engine = WORLDS[st["name"]][:2]
            jmesh = _jax_mesh(mesh)
            for case in st["spec"]["moe"]:
                refs[(st["name"], case["tag"])] = _reference_moe(
                    jmesh, engine, case["cfg"], st["arrays"], case["tag"],
                    mp)
    return {st["name"]: (st, _finish(st)) for st in started}, refs


def _positions(r, mesh):
    s = mesh["seq"]
    my = int(r["seq_index"])
    return slice(my * T // s, (my + 1) * T // s)


def _rows(r, mesh, n=BATCH):
    b = n // mesh["data"]
    d = int(r["data_index"])
    return slice(d * b, (d + 1) * b)


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("name", list(WORLDS))
def test_moe_forward_matches_the_reference_mesh_and_drops_its_tokens(
        sp_families, name):
    worlds, refs = sp_families
    st, ranks = worlds[name]
    mesh = WORLDS[name][0]
    for case in st["spec"]["moe"]:
        tag = case["tag"]
        ref = refs[(name, tag)]
        engine = case["cfg"]["moe_dispatch"]
        # Each rank's share of the load-balance term sums to the
        # reference's over the gradient group (one model column).
        shares = [float(r[f"{tag}/aux"]) for r in ranks]
        per_column = sum(shares) / mesh["model"]
        assert per_column == pytest.approx(ref["aux"], abs=1e-5), tag
        dropped = 0
        for r in ranks:
            rows, pos = _rows(r, mesh), _positions(r, mesh)
            assert list(r[f"{tag}/engines"]) == [engine] * MOE["n_layers"]
            np.testing.assert_allclose(r[f"{tag}/logits"],
                                       ref["logits"][rows], atol=1e-5,
                                       rtol=0, err_msg=f"{name} {tag}")
            for i, want in enumerate(ref["moe"]):
                got = r[f"{tag}/moe{i}"]
                want = want[rows, pos]
                np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                           err_msg=f"{name} {tag} {i}")
                # The same tokens dropped (every choice of them).
                gone = np.all(got == 0, axis=-1)
                np.testing.assert_array_equal(
                    gone, np.all(want == 0, axis=-1),
                    err_msg=f"{name} {tag} layer {i}")
                dropped += int(gone.sum())
        assert dropped > 0, (name, tag)


@pytest.mark.parametrize("name", list(WORLDS))
def test_moe_gradients_and_three_sgd_steps_match_the_reference(sp_families,
                                                               name):
    worlds, refs = sp_families
    st, ranks = worlds[name]
    for case in st["spec"]["moe"]:
        tag = case["tag"]
        ref = refs[(name, tag)]
        for r in ranks:  # every rank holds the global loss and state
            assert float(r[f"{tag}/loss0"]) == pytest.approx(
                ref["losses"][0], abs=1e-5)
            for key, want in ref["grads"].items():
                assert _rel(r[f"{tag}/g/{key}"], want) <= 1e-4, (tag, key)
            np.testing.assert_allclose(r[f"{tag}/losses"], ref["losses"],
                                       atol=1e-5, rtol=0, err_msg=tag)
            for key, want in ref["params"].items():
                np.testing.assert_allclose(r[f"{tag}/p/{key}"], want,
                                           atol=1e-5, rtol=0,
                                           err_msg=f"{name} {tag} {key}")


def test_sorted_tiling_raises_or_falls_back_as_the_reference(sp_families):
    """A ``model=2, seq=2`` world whose shards hold 3 tokens: ``sorted``
    raises the reference's message on every rank, ``auto`` takes einsum;
    the pure rule (with the batch-1 escape) equals the reference's."""
    from dct_tpu_torch.models.moe import sorted_tiling

    worlds, _ = sp_families
    _, ranks = worlds["model2seq2"]
    jmesh = _jax_mesh(WORLDS["model2seq2"][0])
    x = jnp.zeros((1, TILING_T, 8))

    def reference(dispatch, mesh, xs):
        moe = JaxMoEFFN(8, 16, 4, dispatch=dispatch, mesh=mesh,
                        auto_threshold=0)
        with mesh:
            moe.init(jax.random.PRNGKey(0), xs)

    with pytest.raises(ValueError) as theirs:
        reference("sorted", jmesh, x)
    reference("auto", jmesh, x)  # falls back, no raise
    for r in ranks:
        assert list(r["tiling/sorted"]) == [str(theirs.value)]
        assert list(r["tiling/auto"]) == ["einsum"] * MOE["n_layers"]
    kw = dict(dp=1, sp=2, ep=2)
    with pytest.raises(ValueError) as ours:
        sorted_tiling(1, TILING_T, 4, dispatch="sorted", **kw)
    assert str(ours.value) == str(theirs.value)
    assert sorted_tiling(1, TILING_T, 4, dispatch="auto", **kw) == "einsum"
    # The batch-1 escape: fewer rows than data blocks route by einsum.
    data2 = _jax_mesh(dict(data=2, model=2, seq=1))
    reference("sorted", data2, jnp.zeros((1, 8, 8)))
    assert sorted_tiling(1, 8, 4, dp=2, sp=1, ep=2,
                         dispatch="sorted") == "einsum"
    assert sorted_tiling(2, 8, 4, dp=2, sp=1, ep=2,
                         dispatch="sorted") == "sorted"


def test_gru_on_a_seq_axis_equals_one_process_and_the_reference(
        sp_families):
    """The GRU is replicated over seq: each rank's reduced loss and
    gradients equal one process's and the reference's, not twice them."""
    import torch

    from dct_tpu_torch.config import ModelConfig
    from dct_tpu_torch.convert import load_flax_weights
    from dct_tpu_torch.models.registry import get_model
    from dct_tpu_torch.train import state as port_state
    from dct_tpu_torch.train import steps

    worlds, _ = sp_families
    st, ranks = worlds["seq2_ring"]
    arrays = st["arrays"]
    params = {k[len("gru/params/"):]: arrays[k] for k in arrays
              if k.startswith("gru/params/")}
    x, y, w = (arrays[f"gru/{n}0"] for n in "xyw")
    model = get_model(ModelConfig(**GRU), input_dim=F_IN, device="cpu")
    one = port_state.create_train_state(model, input_dim=F_IN, lr=LR,
                                        seed=0, optimizer="sgd",
                                        momentum=MOMENTUM)
    load_flax_weights(model, params)
    loss1, grads1 = steps.loss_and_grads(one, x, y, w)
    from dct_tpu_torch.convert import flax_weights

    for p, g in zip(one.params, grads1):
        p.grad = g
    g1 = flax_weights(model, grads=True)
    jmodel = jax_get_model(JaxModelConfig(**GRU), input_dim=F_IN)

    def loss_fn(p):
        logits = jmodel.apply(p, jnp.asarray(x), train=False)
        s, c = jax_losses.masked_cross_entropy(logits, jnp.asarray(y),
                                               jnp.asarray(w))
        return s / jnp.maximum(c, 1.0)

    jloss, jgrads = jax.value_and_grad(loss_fn)(_tree(params))
    jgrads = _flatten_params(jgrads["params"])
    assert float(loss1) == pytest.approx(float(jloss), abs=1e-5)
    for r in ranks:
        assert float(r["gru/loss0"]) == pytest.approx(float(loss1),
                                                      abs=1e-5)
        for key, want in jgrads.items():
            got = r[f"gru/g/{key}"]
            assert _rel(got, np.asarray(want)) <= 1e-4, key
            assert _rel(got, g1[key]) <= 1e-4, key
            assert _rel(got, 2 * g1[key]) > 0.4, key  # not S times
    assert torch.is_tensor(grads1[0])


def test_zero1_and_fsdp_specs_match_the_reference_on_data2_seq2(
        sp_families):
    worlds, _ = sp_families
    _, ranks = worlds["data2seq2"]
    jmodel = jax_get_model(JaxModelConfig(**POOLED), input_dim=F_IN)
    jst = jax_create_state(jmodel, input_dim=F_IN, lr=LR, seed=0,
                           optimizer="sgd", momentum=MOMENTUM,
                           example_shape=(1, T, F_IN))
    jmesh = _jax_mesh(WORLDS["data2seq2"][0])
    for mode, flags in ZERO_FLAGS.items():
        theirs = {ref_rules.path_str(path): list(getattr(s, "spec", s))
                  for path, s in jax.tree_util.tree_flatten_with_path(
                      ref_rules.state_shardings(
                          jst, jmesh, family="weather_transformer",
                          **flags))[0]}
        for r in ranks:
            assert r["specs"][mode] == theirs, mode
            assert int(r[f"{mode}/drift"]) == 0
    # FSDP stores a data row's half of each split leaf; its seq ranks
    # store the same.
    full = int(ranks[0]["dp/param_elems"])
    stored = [int(r["fsdp/param_elems"]) for r in ranks]
    assert max(stored) < full and len(set(stored)) == 1


@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_zero1_and_fsdp_on_data2_seq2_equal_data_parallelism(sp_families,
                                                             mode):
    worlds, _ = sp_families
    _, ranks = worlds["data2seq2"]
    for r in ranks:
        np.testing.assert_allclose(r[f"{mode}/losses"], r["dp/losses"],
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(r[f"{mode}/last"], r["dp/last"],
                                   atol=1e-6, rtol=0)
        keys = [k for k in r if k.startswith("dp/p/")]
        assert keys
        for k in keys:
            np.testing.assert_allclose(r[f"{mode}/p/{k[5:]}"], r[k],
                                       atol=1e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_shard_saved_resume_under_seq_continues_bitwise(sp_families, mode):
    worlds, _ = sp_families
    _, ranks = worlds["data2seq2"]
    for r in ranks:
        np.testing.assert_array_equal(r[f"{mode}/resumed_last"],
                                      r[f"{mode}/last"])
        pre = f"{mode}/p/"
        for k in (k for k in r if k.startswith(pre)):
            np.testing.assert_array_equal(
                r[f"{mode}/resumed/{k[len(pre):]}"], r[k], err_msg=k)
