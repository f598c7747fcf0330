"""The port's model axis on gloo worlds (CPU), held to the JAX package's
multi-device mesh.

- At W=2 (``model=2``) the tensor-parallel transformer (f32, T=256, so the
  flash path runs at ``H/2`` local heads) gives the reference's logits on a
  ``model=2`` mesh within 1e-5 and its gradients within 1e-4 (of each
  leaf's max), and one Adam step the same parameters; the expert-parallel
  MoE's sorted engine at tight capacity (factor 0.5: tokens drop, and
  other tokens than in the one-shard engine) gives the reference's
  ``_sorted_sharded`` loss within 1e-5 and gradients within 1e-4, top-1
  and top-2, and its einsum engine the reference's global routing; rules
  that replicate every unit give the same numbers.
- At W=2 (``data=2``) ZeRO-1 and FSDP follow data parallelism's three
  Adam steps within 1e-6 while holding less per rank.
- ``train_job`` at W=4 (``data=2, model=2``, ZeRO-1) tracks the W=1 fit
  within 1e-3 on val_loss, publishes dense checkpoints, and a shard-saved
  resume continues its run exactly, with the keys and ``layout.json`` the
  reference's ``_index_key`` and ``spec_to_json`` give; one process on
  ``model=1`` re-maps the same shard-saved state bit for bit.

The worlds are few and each serves several tests; every subprocess has a
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

from dct_tpu.config import MeshConfig as JaxMeshConfig
from dct_tpu.config import ModelConfig as JaxModelConfig
from dct_tpu.models.registry import get_model as jax_get_model
from dct_tpu.ops import losses as jax_losses
from dct_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dct_tpu.parallel.sharding_rules import (
    match_partition_rules,
    rules_for_family,
)
from dct_tpu.serving.score_gen import _flatten_params
from dct_tpu.train.steps import _position_weight

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F_IN = 5
T = 256
TRANSFORMER = dict(name="weather_transformer", seq_len=T, d_model=32,
                   n_heads=4, n_kv_heads=2, n_layers=2, d_ff=64, dropout=0.0)
CAUSAL = dict(TRANSFORMER, name="weather_transformer_causal", horizon=2)
MOE = dict(name="weather_moe", seq_len=32, d_model=32, n_heads=2,
           n_layers=2, d_ff=64, n_experts=4, capacity_factor=0.5,
           dropout=0.0)
MOE_CASES = [("sorted", 1), ("sorted", 2), ("einsum", 1)]
LR = 1e-3
REPLICATE_ALL = "(qkv_proj|o_proj|ffn_in|ffn_out).*=;experts_.*="

_WORKER = r'''
import json, os, sys
import numpy as np, torch, torch.distributed as dist
from dct_tpu_torch.config import MeshConfig, ModelConfig
from dct_tpu_torch.convert import load_flax_weights
from dct_tpu_torch.models.mlp import set_data_block
from dct_tpu_torch.models.registry import get_model
from dct_tpu_torch.ops import flash_attention as fa
from dct_tpu_torch.parallel.mesh import make_mesh, set_mesh
from dct_tpu_torch.parallel.sharding_rules import (
    gather_tree, make_shard_and_gather_fns, shard_state_with_rules)
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
results = {}
# The q and k/v head counts of every flash call.
heads, _real = [], fa.flash_attention
fa.flash_attention = lambda q, k, v, **kw: (
    heads.append((q.shape[1], k.shape[1])) or _real(q, k, v, **kw))


def build(case):
    cfg = ModelConfig(**case["cfg"])
    model = get_model(cfg, input_dim=data["x_" + case["x"]].shape[-1],
                      device="cpu")
    st = port_state.create_train_state(
        model, input_dim=model.input_dim, lr=spec["lr"], seed=0,
        optimizer=case.get("optimizer", "adam"))
    pre = case["params"] + "/"
    load_flax_weights(model, {k[len(pre):]: data[k] for k in data.files
                              if k.startswith(pre)})
    os.environ.pop("DCT_SHARD_RULES", None)
    if case.get("rules"):
        os.environ["DCT_SHARD_RULES"] = case["rules"]
    shard_state_with_rules(st, mesh, family=cfg.name,
                           shard_opt=case.get("shard_opt", False),
                           shard_params=case.get("shard_params", False))
    set_data_block(model, mesh.data_size, mesh.data_index)
    return model, st


def dense(st, grads):
    gather = make_shard_and_gather_fns(st.layout)[1]
    from dct_tpu_torch.checkpoint.manager import _param_order
    return {key: gather[i](grads[i]) for i, key, _ in
            _param_order(st.model)}


for case in spec["cases"]:
    tag = case["tag"]
    model, st = build(case)
    x, y, w = (data[f"{a}_{case['x']}"] for a in "xyw")
    n = len(x) // mesh.data_size
    rows = slice(mesh.data_index * n, (mesh.data_index + 1) * n)
    x, y, w = x[rows], y[rows], w[rows]
    results[f"{tag}/bytes"] = np.array([
        sum(st.stored_param(i).numel() for i in range(len(st.params))),
        sum(t.numel() for s in st.opt_state if isinstance(s, dict)
            for t in s.get("mu", []))])
    if case.get("logits"):
        model.eval()
        heads.clear()
        with torch.no_grad():
            results[f"{tag}/logits"] = model(torch.from_numpy(x)).numpy()
        results[f"{tag}/flash_heads"] = np.array(heads)
        results[f"{tag}/local_heads"] = np.array(
            [model.block_0.attn.local[0], model.block_0.attn.local[1]])
    for step in range(case.get("steps", 1)):
        loss, grads = steps.loss_and_grads(st, x, y, w)
        if step == 0:
            results[f"{tag}/loss"] = np.float32(float(loss))
            for key, g in dense(st, grads).items():
                results[f"{tag}/g/{key}"] = g
            engines = [getattr(getattr(b, "moe", None), "last_engine", "")
                       for b in model.blocks()]
            results[f"{tag}/engines"] = np.array(engines)
        results[f"{tag}/loss{step}"] = np.float32(float(loss))
        st.apply_gradients(grads, st.grad_norm(grads))
    if case.get("logits"):
        model.eval()
        with torch.no_grad():
            results[f"{tag}/logits_after"] = model(
                torch.from_numpy(x)).numpy()
    from dct_tpu_torch.checkpoint.manager import flatten_tree
    for key, v in flatten_tree(gather_tree(st)["params"]).items():
        results[f"{tag}/p/{key}"] = v
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


def _wait(procs, timeout=300):
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


def _world(tmp, world, mesh, cases, arrays):
    inp = str(tmp / "inp.npz")
    np.savez(inp, **arrays)
    with open(inp + ".json", "w") as f:
        json.dump({"mesh": mesh, "cases": cases, "lr": LR}, f)
    out = str(tmp / "out.npz")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world), str(port), inp,
         out], env=_env(), cwd=str(tmp), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    _wait(procs)
    return dict(np.load(out))


def _init(cfg, shape):
    model = jax_get_model(JaxModelConfig(**cfg), input_dim=F_IN)
    return {"params": model.init(jax.random.PRNGKey(3), jnp.zeros(shape),
                                 train=False)["params"]}


def _batch(seed, b, t):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, F_IN)).astype(np.float32),
            rng.integers(0, 2, (b,)).astype(np.int32),
            np.array([1] * (b - 1) + [0], np.float32))


@pytest.fixture(scope="module")
def model2(tmp_path_factory):
    """One W=2 ``model=2`` world: the transformer (TP, and every unit
    replicated by rules) and the MoE engines, each from the same numpy
    parameters as the reference."""
    tp = _init(TRANSFORMER, (1, T, F_IN))
    causal = _init(CAUSAL, (1, T, F_IN))
    moe = _init(MOE, (1, MOE["seq_len"], F_IN))
    xt, yt, wt = _batch(17, 4, T)
    xm, ym, wm = _batch(19, 4, MOE["seq_len"])
    # The causal family's labels are per position and horizon step.
    yc = np.random.default_rng(21).integers(0, 2, (4, T, 2)).astype(
        np.int32)
    arrays = {"x_t": xt, "y_t": yt, "w_t": wt, "x_m": xm, "y_m": ym,
              "w_m": wm, "x_c": xt, "y_c": yc, "w_c": wt}
    for tag, params in (("tp", tp), ("causal", causal), ("moe", moe)):
        arrays.update({f"{tag}/{k}": np.asarray(v) for k, v in
                       _flatten_params(params["params"]).items()})
    cases = [dict(tag="tp", cfg=TRANSFORMER, x="t", params="tp",
                  logits=True),
             dict(tag="tp_rep", cfg=TRANSFORMER, x="t", params="tp",
                  logits=True, rules=REPLICATE_ALL),
             dict(tag="causal", cfg=CAUSAL, x="c", params="causal",
                  logits=True)]
    for engine, k in MOE_CASES:
        cases.append(dict(tag=f"{engine}{k}", x="m", params="moe",
                          cfg=dict(MOE, moe_dispatch=engine,
                                   router_top_k=k)))
    cases.append(dict(tag="sorted_rep1", x="m", params="moe",
                      rules=REPLICATE_ALL,
                      cfg=dict(MOE, moe_dispatch="sorted", router_top_k=1)))
    got = _world(tmp_path_factory.mktemp("model2"), 2,
                 {"data": 1, "model": 2}, cases, arrays)
    return got, {"tp": tp, "causal": causal, "moe": moe}, arrays


def _jax_mesh2():
    return jax_make_mesh(JaxMeshConfig(data=1, model=2),
                         devices=jax.devices()[:2])


def _jax_loss_and_grads(cfg, params, x, y, w, mesh):
    model = jax_get_model(JaxModelConfig(**cfg), input_dim=F_IN, mesh=mesh)
    shard = jax.tree.map(
        lambda s: jax.sharding.NamedSharding(mesh, s),
        match_partition_rules(rules_for_family(cfg["name"]), params))
    params = jax.device_put(params, shard)

    def loss_fn(p):
        logits, sown = model.apply(p, jnp.asarray(x), train=True,
                                   rngs={"dropout": jax.random.PRNGKey(0)},
                                   mutable=["aux_loss"])
        yj = jnp.asarray(y)
        loss_sum, count = jax_losses.masked_cross_entropy(
            logits, yj, _position_weight(logits, yj, jnp.asarray(w)))
        return loss_sum / jnp.maximum(count, 1.0) + sum(
            jax.tree.leaves(sown))

    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        logits = jax.jit(lambda p: model.apply(p, jnp.asarray(x)))(params)
    return (float(loss), _flatten_params(jax.device_get(grads)["params"]),
            np.asarray(logits), model)


def _close_grads(got, tag, ref, tol=1e-4):
    for key, r in ref.items():
        g = got[f"{tag}/g/{key}"]
        r = np.asarray(r)
        assert g.shape == r.shape, (tag, key)
        err = np.abs(g - r).max() / max(np.abs(r).max(), 1e-30)
        assert err <= tol, (tag, key, err)


@pytest.mark.parametrize("tag", ["tp", "tp_rep", "causal"])
def test_tensor_parallel_transformer_matches_the_model2_mesh(model2, tag,
                                                            monkeypatch):
    got, params, arrays = model2
    monkeypatch.setenv("DCT_FLASH", "interpret")
    cfg, key, x = ((CAUSAL, "causal", "c") if tag == "causal"
                   else (TRANSFORMER, "tp", "t"))
    loss, grads, logits, _ = _jax_loss_and_grads(
        cfg, params[key], arrays[f"x_{x}"], arrays[f"y_{x}"],
        arrays[f"w_{x}"], _jax_mesh2())
    np.testing.assert_allclose(got[f"{tag}/logits"], logits, atol=1e-5,
                               rtol=0)
    assert float(got[f"{tag}/loss"]) == pytest.approx(loss, rel=1e-5)
    _close_grads(got, tag, grads)
    # H/M and G/M local heads under TP, through the flash path once per
    # layer.
    want = [4, 2] if tag == "tp_rep" else [2, 1]
    assert list(got[f"{tag}/local_heads"]) == want
    assert got[f"{tag}/flash_heads"].tolist() == [want] * TRANSFORMER[
        "n_layers"]
    # The published parameters are dense, not one shard.
    assert got[f"{tag}/p/block_0/attn/qkv_proj/kernel"].shape == (32, 64)


def test_one_adam_step_matches_the_reference_step(model2, monkeypatch):
    """One optax Adam step (lr 1e-3) of the reference on the ``model=2``
    mesh, from its own gradients, gives the port's logits after its TP
    step within 1e-5. (The parameters themselves are compared through the
    forward: Adam's first step is ``lr * g / (|g| + eps)``, ill-conditioned
    for the gradients that are zero up to rounding, such as the k bias's,
    which the softmax ignores.)"""
    import optax

    got, params, arrays = model2
    monkeypatch.setenv("DCT_FLASH", "interpret")
    mesh = _jax_mesh2()
    _, grads, _, model = _jax_loss_and_grads(
        TRANSFORMER, params["tp"], arrays["x_t"], arrays["y_t"],
        arrays["w_t"], mesh)
    tx = optax.adam(LR)
    p = jax.device_get(params["tp"])
    g = {"params": jax.tree.map(jnp.asarray, _unflatten(grads))}
    upd, _ = tx.update(g, tx.init(p), p)
    stepped = optax.apply_updates(p, upd)
    with mesh:
        logits = np.asarray(jax.jit(lambda q: model.apply(
            q, jnp.asarray(arrays["x_t"])))(stepped))
    np.testing.assert_allclose(got["tp/logits_after"], logits, atol=1e-5,
                               rtol=0)
    assert np.abs(logits - got["tp/logits"]).max() > 1e-4  # it moved


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *path, last = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = v
    return tree


@pytest.mark.parametrize("engine,k", MOE_CASES + [("sorted_rep", 1)])
def test_expert_parallel_moe_matches_the_reference_drops_included(
        model2, engine, k):
    got, params, arrays = model2
    tag = f"{engine}{k}"
    eng = engine.split("_")[0]
    cfg = dict(MOE, moe_dispatch=eng, router_top_k=k)
    args = (arrays["x_m"], arrays["y_m"], arrays["w_m"])
    loss, grads, _, _ = _jax_loss_and_grads(cfg, params["moe"], *args,
                                            _jax_mesh2())
    assert list(got[f"{tag}/engines"]) == [eng] * MOE["n_layers"]
    assert float(got[f"{tag}/loss"]) == pytest.approx(loss, rel=1e-5)
    _close_grads(got, tag, grads)
    if eng == "sorted":
        # Chunk capacity drops other tokens than the one-shard engine.
        one, _, _, _ = _jax_loss_and_grads(
            cfg, params["moe"], *args,
            jax_make_mesh(JaxMeshConfig(data=1), devices=jax.devices()[:1]))
        assert abs(one - loss) > 1e-6
    # Expert stacks split over the model axis: half the parameters each.
    if tag == "sorted1":
        dense = sum(np.asarray(v).size for v in
                    _flatten_params(params["moe"]["params"]).values())
        assert got[f"{tag}/bytes"][0] < dense


@pytest.fixture(scope="module")
def data2(tmp_path_factory):
    """One W=2 ``data=2`` world: DP, ZeRO-1 and FSDP, three Adam steps each
    (grad clip on, so the norm over the blocks is exercised)."""
    tp = _init(TRANSFORMER, (1, T, F_IN))
    x, y, w = _batch(23, 4, T)
    arrays = {"x_t": x, "y_t": y, "w_t": w}
    arrays.update({f"tp/{k}": np.asarray(v) for k, v in
                   _flatten_params(tp["params"]).items()})
    cases = [dict(tag=tag, cfg=TRANSFORMER, x="t", params="tp", steps=3,
                  **kw)
             for tag, kw in (("dp", {}), ("zero1", {"shard_opt": True}),
                             ("fsdp", {"shard_params": True}))]
    return _world(tmp_path_factory.mktemp("data2"), 2,
                  {"data": 2, "model": 1}, cases, arrays)


@pytest.mark.parametrize("tag", ["zero1", "fsdp"])
def test_zero1_and_fsdp_equal_data_parallelism(data2, tag):
    for step in range(3):
        assert float(data2[f"{tag}/loss{step}"]) == pytest.approx(
            float(data2[f"dp/loss{step}"]), rel=1e-6)
    keys = [k for k in data2 if k.startswith("dp/p/")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(data2[k.replace("dp/", f"{tag}/")],
                                   data2[k], atol=1e-6, rtol=0, err_msg=k)
    # Less held per rank: the moments (ZeRO-1), the parameters too (FSDP).
    dp_params, dp_moments = data2["dp/bytes"]
    params, moments = data2[f"{tag}/bytes"]
    assert moments < dp_moments
    assert (params < dp_params) == (tag == "fsdp")


# ------------------------------------------------------------ train_job


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    from dct_tpu_torch.data.synthetic import generate_weather_csv
    from dct_tpu_torch.etl.preprocess import preprocess_csv_to_parquet

    root = tmp_path_factory.mktemp("tp_fit")
    generate_weather_csv(str(root / "w.csv"), rows=240, seed=5)
    preprocess_csv_to_parquet(str(root / "w.csv"), str(root / "processed"))
    return str(root / "processed")


FIT = dict(DCT_MODEL="weather_transformer", DCT_SEQ_LEN="16",
           DCT_D_MODEL="16", DCT_N_HEADS="2", DCT_N_LAYERS="1",
           DCT_D_FF="32", DCT_DROPOUT="0.2", DCT_BF16_COMPUTE="0",
           DCT_LR="0.001")


def _train_job(processed, models_dir, tmp, *, world, rank, batch, port,
               epochs, resume=False, **extra):
    env = _env(DCT_DEVICE="cpu", DCT_PROCESSED_DIR=processed,
               DCT_MODELS_DIR=models_dir, DCT_EPOCHS=str(epochs),
               DCT_BATCH_SIZE=str(batch), DCT_RESUME="1" if resume else "0",
               DCT_TRACKING_DIR=str(tmp / "mlruns"), **FIT, **extra)
    if world > 1:
        env.update(WORLD_SIZE=str(world), NODE_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    return subprocess.Popen(
        [sys.executable, "-m", "dct_tpu_torch.train_job"], env=env,
        cwd=str(tmp), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _w4(processed, models_dir, tmp, *, epochs, resume=False):
    port = _free_port()
    return [_train_job(processed, models_dir, tmp, world=4, rank=r,
                       batch=8, port=port, epochs=epochs, resume=resume,
                       DCT_MESH_DATA="2", DCT_MESH_MODEL="2",
                       DCT_SHARD_OPT_STATE="1")
            for r in range(4)]


def _val_losses(out):
    return [float(ln.split("val_loss=")[1].split()[0]) for ln in
            out.splitlines() if "done: val_loss=" in ln]


def _resume_files(models_dir, rank):
    d = os.path.join(models_dir, "train_state", f"p{rank}", "state")
    with np.load(os.path.join(d, "state.npz")) as npz:
        entries = {k: npz[k] for k in npz.files}
    with open(os.path.join(d, "layout.json")) as f:
        return entries, json.load(f)


@pytest.fixture(scope="module")
def fits(processed, tmp_path_factory):
    """W=1 for two epochs; W=4 (data=2, model=2, ZeRO-1) for two epochs
    straight, and for one epoch then a resumed one."""
    tmp = tmp_path_factory.mktemp("fits")
    dirs = {k: str(tmp / k) for k in ("one", "four", "split")}
    procs = [_train_job(processed, dirs["one"], tmp, world=1, rank=0,
                        batch=16, port=0, epochs=2)]
    procs += _w4(processed, dirs["four"], tmp, epochs=2)
    procs += _w4(processed, dirs["split"], tmp, epochs=1)
    outs = _wait(procs)
    first = outs[5:]
    split_states = [_resume_files(dirs["split"], r) for r in range(4)]
    second = _wait(_w4(processed, dirs["split"], tmp, epochs=1,
                       resume=True))
    return dict(dirs=dirs, one=outs[0][1], four=[o[1] for o in outs[1:5]],
                first=[o[1] for o in first], second=[o[1] for o in second],
                split_states=split_states)


def test_w4_fit_tracks_w1_and_publishes_dense(fits):
    from dct_tpu_torch.checkpoint.manager import (
        flatten_tree,
        load_checkpoint,
    )

    one, four = _val_losses(fits["one"]), _val_losses(fits["four"][0])
    assert len(one) == len(four) == 1
    assert abs(one[0] - four[0]) <= 1e-3
    # Every rank ends on the same val_loss; only rank 0 writes *.ckpt.
    assert len({_val_losses(o)[0] for o in fits["four"]}) == 1
    fit = json.loads(next(ln for ln in fits["four"][0].splitlines()
                          if ln.startswith("[train_job] fit "))
                     [len("[train_job] fit "):])
    assert fit["mesh"] == {"data": 2, "model": 2, "seq": 1, "pipe": 1}
    assert fit["local_heads"] == [1, 1]
    assert fit["val_loss"] == pytest.approx(four[0], abs=1e-4)
    d = fits["dirs"]["four"]
    params, _ = load_checkpoint(os.path.join(d, "last.ckpt"))
    ref, _ = load_checkpoint(os.path.join(fits["dirs"]["one"], "last.ckpt"))
    flat, flat_ref = flatten_tree(params["params"]), flatten_tree(
        ref["params"])
    assert sorted(flat) == sorted(flat_ref)
    for k, v in flat.items():
        assert v.shape == flat_ref[k].shape, k
    assert flat["block_0/attn/qkv_proj/kernel"].shape == (16, 48)
    best = [n for n in os.listdir(d) if n.startswith("weather-best-")]
    assert best
    # The package published from the best checkpoint is dense too.
    from dct_tpu_torch.continuous.evaluator import package_checkpoint

    pkg = os.path.join(d, "pkg")
    package_checkpoint(os.path.join(d, best[0]), pkg)
    with np.load(os.path.join(pkg, "model.npz")) as npz:
        assert npz["block_0/attn/qkv_proj/kernel"].shape == (16, 48)
        assert npz["block_0/ffn_out/kernel"].shape == (32, 16)


def test_shard_saved_resume_continues_the_run_exactly(fits):
    straight = _val_losses(fits["four"][0])
    resumed = _val_losses(fits["second"][0])
    assert resumed == straight
    for r in range(4):
        a, _ = _resume_files(fits["dirs"]["four"], r)
        b, _ = _resume_files(fits["dirs"]["split"], r)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=(r, k))


def test_shard_keys_and_layout_are_the_reference_ones(fits):
    """Each rank's keys are the reference's ``_index_key`` of its device
    on a data=2, model=2 mesh, and each leaf's spec its ``spec_to_json``
    of the reference's ``state_shardings`` (ZeRO-1 on)."""
    from dct_tpu.checkpoint.manager import TrainStateCheckpointer
    from dct_tpu.parallel.sharding_rules import (
        spec_to_json,
        state_shardings,
    )
    from dct_tpu.train.state import create_train_state

    cfg = JaxModelConfig(name="weather_transformer", seq_len=16,
                         d_model=16, n_heads=2, n_layers=1, d_ff=32)
    model = jax_get_model(cfg, input_dim=F_IN)
    st = create_train_state(model, input_dim=F_IN, lr=1e-3, seed=0,
                            example_shape=(1, 16, F_IN))
    mesh = jax_make_mesh(JaxMeshConfig(data=2, model=2),
                         devices=jax.devices()[:4])
    shardings = state_shardings(st, mesh, shard_opt=True,
                                family="weather_transformer")
    by_path = {
        "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                 for k in path): s
        for path, s in jax.tree_util.tree_flatten_with_path(shardings)[0]}
    tree = {"opt_state": st.opt_state, "params": st.params, "rng": st.rng,
            "step": st.step}
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    for rank in range(4):
        entries, layout = fits["split_states"][rank]
        assert layout["version"] == 1
        assert layout["process_index"] == rank
        assert layout["process_count"] == 4
        assert layout["mesh"] == {"data": 2, "model": 2, "seq": 1,
                                  "pipe": 1}
        device = mesh.devices.reshape(-1)[rank]
        want_keys = []
        for n, (path, leaf) in enumerate(flat):
            name = "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                            for k in path)
            sh = by_path[name]
            rec = layout["leaves"][n]
            assert rec["spec"] == spec_to_json(sh.spec), name
            assert rec["shape"] == list(np.shape(leaf)), name
            index = sh.devices_indices_map(np.shape(leaf))[device]
            split = any(sl.start not in (None, 0) or
                        (sl.stop is not None and sl.stop != dim)
                        for sl, dim in zip(index, np.shape(leaf)))
            if split:
                off = "x".join(
                    map(str, TrainStateCheckpointer._index_key(index)))
                want_keys.append(f"{n}_s{off}")
                assert rec["saved"] == "shards", name
            else:
                want_keys.append(str(n))
                assert rec["saved"] == "whole", name
        assert sorted(entries) == sorted(want_keys)


def test_a_changed_topology_re_maps_onto_model1(fits, tmp_path):
    """The W=4 (data=2, model=2, ZeRO-1) shard-saved state, restored by
    one process on model=1 from rank 0's directory: every split leaf is
    assembled from the four ranks' files (siblings on one filesystem),
    bit for bit, the parameters equal the dense last.ckpt written at the
    same step, and ``shard.topology_remap`` is on the event log."""
    from dct_tpu_torch.checkpoint.manager import (
        TrainStateCheckpointer,
        flatten_tree,
        load_checkpoint,
        state_leaves,
    )
    from dct_tpu_torch.config import ModelConfig
    from dct_tpu_torch.models.registry import get_model
    from dct_tpu_torch.observability import events
    from dct_tpu_torch.parallel.mesh import ProcessMesh
    from dct_tpu_torch.train.state import create_train_state

    cfg = ModelConfig(name="weather_transformer", seq_len=16, d_model=16,
                      n_heads=2, n_layers=1, d_ff=32)
    model = get_model(cfg, input_dim=F_IN, device="cpu")
    st = create_train_state(model, input_dim=F_IN, lr=1e-3, seed=0,
                            mesh=ProcessMesh(1, 1, rank=0, world=1),
                            family="weather_transformer")
    d = fits["dirs"]["four"]
    ck = TrainStateCheckpointer(os.path.join(d, "train_state", "p0"))
    log = str(tmp_path / "events.jsonl")
    events.set_default(events.EventLog(log, run_id="remap"))
    try:
        ck.restore(st)
    finally:
        events.set_default(None)
    # The dense value of every leaf, tiled from the ranks' blocks.
    ranks = [_resume_files(d, r)[0] for r in range(4)]
    got = state_leaves(st)
    split = 0
    for n, leaf in enumerate(got):
        dense = np.zeros(np.shape(leaf), np.asarray(leaf).dtype)
        for entries in ranks:
            for k, v in entries.items():
                if k == str(n):
                    dense[...] = v
                elif k.startswith(f"{n}_s"):
                    split += 1
                    off = [int(o) for o in k[len(f"{n}_s"):].split("x")]
                    dense[tuple(slice(o, o + s) for o, s in
                                zip(off, v.shape))] = v
        np.testing.assert_array_equal(np.asarray(leaf), dense, err_msg=n)
    assert split
    params, _ = load_checkpoint(os.path.join(d, "last.ckpt"))
    from dct_tpu_torch.checkpoint.manager import param_tree

    mine = flatten_tree(param_tree(st.model)["params"])
    for k, v in flatten_tree(params["params"]).items():
        np.testing.assert_array_equal(mine[k], v, err_msg=k)
    assert ck.last_remap["from_mesh"] == {"data": 2, "model": 2, "seq": 1,
                                          "pipe": 1}
    assert ck.last_remap["to_mesh"]["model"] == 1
    assert (ck.last_remap["from_processes"], ck.last_remap["to_processes"]
            ) == (4, 1)
    assert ck.last_remap["leaves"] > 0
    with open(log) as f:
        recs = [json.loads(line) for line in f]
    remaps = [r for r in recs if r["event"] == "shard.topology_remap"]
    assert remaps and remaps[0]["leaves"] == ck.last_remap["leaves"]
