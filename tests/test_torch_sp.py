"""The port's seq axis on gloo worlds (CPU), held to the JAX package's
multi-device mesh.

- The engines: ``ring_attention`` (contiguous, striped, windowed; with the
  flash bodies where the shards are kernel-aligned and the plain
  online-softmax body where not) and ``a2a_attention`` on worlds of
  ``seq=2``, ``seq=4``, ``data=2, seq=2`` and ``model=2, seq=2``: each
  rank's shard ``[B/D, H/M, T/S, D]`` of the outputs and of the gradients
  of q, k and v (from a seeded cotangent) equals the reference's
  ``ring_attention`` / ``a2a_attention`` on its 8 virtual devices at the
  same positions, within 1e-5 on outputs and 1e-4 on gradients; each rank
  ran the engine's count of flash calls (``sp_forward_calls`` of
  ``chip_smoke.py``: the non-causal ring S, the contiguous causal ring
  ``1 + my``, the striped ring ``3 + (S - 1)``, the windowed ring ``1 +
  min(my, n_steps - 1)``, a2a 1).
- Training: 3 SGD steps (momentum 0.9) of ``weather_transformer`` and
  ``weather_transformer_causal`` on a seq grid equal the reference's mesh
  run (``tests/test_transformer.py:149``, ``tests/test_causal_family.py
  :123``): every loss within 1e-5, the parameters within 1e-5.
- ``train_job`` takes ``DCT_MESH_SEQ``: the transformers, the MoE and
  ZeRO-1 on a seq axis end on one process's val_loss.

The worlds are few, each serves several tests, and every subprocess has a
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
from dct_tpu.ops.attention import a2a_attention as jax_a2a
from dct_tpu.ops.attention import ring_attention as jax_ring
from dct_tpu.parallel.mesh import batch_sharding
from dct_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dct_tpu.parallel.sharding_rules import shard_state_with_rules
from dct_tpu.serving.score_gen import _flatten_params
from dct_tpu.train.state import create_train_state as jax_create_state
from dct_tpu.train.steps import make_train_step as jax_make_step
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import sp_forward_calls  # noqa: E402

F_IN = 5
D_HEAD = 8
TRAIN = dict(seq_len=256, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
             d_ff=64, dropout=0.0)
LR, MOMENTUM, STEPS, BATCH = 0.01, 0.9, 3, 4

_WORKER = r'''
import json, sys
import numpy as np, torch, torch.distributed as dist
from dct_tpu_torch.config import MeshConfig, ModelConfig
from dct_tpu_torch.convert import load_flax_weights
from dct_tpu_torch.models.mlp import set_data_block
from dct_tpu_torch.models.registry import get_model
from dct_tpu_torch.ops import attention as att
from dct_tpu_torch.ops import flash_attention as fa
from dct_tpu_torch.parallel.mesh import make_mesh, set_mesh
from dct_tpu_torch.parallel.sharding_rules import shard_state_with_rules
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
shard = mesh.seq_shard()
s, my = shard.size, shard.index
results = {"seq_index": np.int64(my), "data_index": np.int64(
    mesh.data_index), "model_index": np.int64(mesh.model_index)}
# The flash path's calls (forward; each one's backward runs under grad).
calls, _real = [], fa.flash_attention
fa.flash_attention = lambda *a, **kw: (calls.append(1) or _real(*a, **kw))

for case in spec["attn"]:
    tag = case["tag"]
    q, k, v, do = (data[f"{tag}/{n}"] for n in ("q", "k", "v", "do"))
    b, h, t, _ = q.shape
    g = k.shape[1]
    dn, mn = b // mesh.data_size, h // mesh.model_size
    gn = g // mesh.model_size
    rows = slice(mesh.data_index * dn, (mesh.data_index + 1) * dn)
    heads = slice(mesh.model_index * mn, (mesh.model_index + 1) * mn)
    kvh = slice(mesh.model_index * gn, (mesh.model_index + 1) * gn)
    kw = dict(causal=case["causal"], window=case["window"])
    if case["engine"] == "ring":
        striped = att.ring_striped(t, s, device="cpu",
                                   striped=case["striped"], **kw)
        order = (att.striped_layout(t, s)[0] if striped else np.arange(t))
    else:
        order = np.arange(t)
    pos = order[my * (t // s):(my + 1) * (t // s)]
    local = [torch.from_numpy(np.ascontiguousarray(a[rows][:, hs][:, :, pos]))
             .requires_grad_() for a, hs in ((q, heads), (k, kvh), (v, kvh))]
    calls.clear()
    if case["engine"] == "ring":
        o = att.ring_attention(*local, mesh=mesh, striped=case["striped"],
                               **kw)
    else:
        o = att.a2a_attention(*local, mesh=mesh, **kw)
    dlocal = torch.from_numpy(np.ascontiguousarray(
        do[rows][:, heads][:, :, pos]))
    grads = torch.autograd.grad(o, local, dlocal)
    results[f"{tag}/calls"] = np.int64(len(calls))
    results[f"{tag}/pos"] = pos
    for n, x in zip(("o", "dq", "dk", "dv"), (o, *grads)):
        results[f"{tag}/{n}"] = x.detach().numpy()

for case in spec["train"]:
    tag = case["tag"]
    cfg = ModelConfig(**case["cfg"])
    f_in = data[f"{tag}/x0"].shape[-1]
    model = get_model(cfg, input_dim=f_in, device="cpu", mesh=mesh)
    st = port_state.create_train_state(model, input_dim=f_in, lr=spec["lr"],
                                       seed=0, optimizer="sgd",
                                       momentum=spec["momentum"])
    pre = tag + "/params/"
    load_flax_weights(model, {k[len(pre):]: data[k] for k in data.files
                              if k.startswith(pre)})
    shard_state_with_rules(st, mesh, family=cfg.name)
    set_data_block(model, mesh.data_size, mesh.data_index)
    step = steps.make_train_step()
    losses = []
    for i in range(spec["steps"]):
        x, y, w = (data[f"{tag}/{n}{i}"] for n in "xyw")
        n = len(x) // mesh.data_size
        blk = slice(mesh.data_index * n, (mesh.data_index + 1) * n)
        calls.clear()
        st, m = step(st, x[blk], y[blk], w[blk])
        losses.append(float(m["train_loss"]))
    results[f"{tag}/calls"] = np.int64(len(calls))
    results[f"{tag}/losses"] = np.array(losses)
    from dct_tpu_torch.parallel.sharding_rules import gather_tree
    from dct_tpu_torch.checkpoint.manager import flatten_tree
    for key, value in flatten_tree(gather_tree(st)["params"]).items():
        results[f"{tag}/p/{key}"] = value
np.savez(f"{out}.{rank}.npz", **results)
dist.barrier()
dist.destroy_process_group()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DCT_") and k not in (
               "WORLD_SIZE", "NODE_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return env


def _world(tmp, mesh, attn, train, arrays, timeout=300):
    world = mesh["data"] * mesh["model"] * mesh["seq"]
    inp = str(tmp / "inp.npz")
    np.savez(inp, **arrays)
    with open(inp + ".json", "w") as f:
        json.dump({"mesh": mesh, "attn": attn, "train": train, "lr": LR,
                   "momentum": MOMENTUM, "steps": STEPS}, f)
    out = str(tmp / "out")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world), str(port), inp,
         out], env=_env(), cwd=str(tmp), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, err in outs:
        assert rc == 0, err[-3000:]
    return [dict(np.load(f"{out}.{r}.npz")) for r in range(world)]


# ------------------------------------------------------------- engines

def _case(tag, engine, t, *, b=2, h=4, g=4, causal=False, window=None,
          striped=None, seed=0):
    rng = np.random.default_rng(seed)
    arrays = {f"{tag}/{n}": rng.standard_normal(shape).astype(np.float32)
              for n, shape in (("q", (b, h, t, D_HEAD)),
                               ("k", (b, g, t, D_HEAD)),
                               ("v", (b, g, t, D_HEAD)),
                               ("do", (b, h, t, D_HEAD)))}
    return dict(tag=tag, engine=engine, causal=causal, window=window,
                striped=striped), arrays


# Per world: (mesh, cases, the layout each case's call count follows).
# T/S = 128 is kernel-aligned (the flash bodies, the striped one on half
# shards of 64); T/S = 32 takes the plain online-softmax body.
WORLDS = {
    "seq2": ({"data": 1, "model": 1, "seq": 2}, [
        ("ring", "ring", 256, {}),
        ("contiguous", "contiguous", 256, dict(causal=True, striped=False)),
        ("striped", "striped", 256, dict(causal=True, striped=True)),
        ("windowed", "windowed", 256, dict(causal=True, window=96,
                                           striped=False)),
        ("plain_striped_window", None, 64, dict(causal=True, window=20,
                                                striped=True)),
        ("plain_contiguous", None, 64, dict(causal=True, striped=False)),
        ("a2a", "a2a", 256, dict(causal=True)),
        ("a2a_window", None, 64, dict(causal=True, window=20)),
    ]),
    "seq4": ({"data": 1, "model": 1, "seq": 4}, [
        ("ring", "ring", 512, dict(h=2, g=2)),
        ("contiguous", "contiguous", 512, dict(h=2, g=2, causal=True,
                                               striped=False)),
        ("striped", "striped", 512, dict(h=2, g=2, causal=True)),
        ("windowed", "windowed", 512, dict(h=2, g=2, causal=True,
                                           window=200, striped=False)),
        ("a2a", "a2a", 512, dict(causal=True)),
    ]),
    "data2seq2": ({"data": 2, "model": 1, "seq": 2}, [
        ("ring", "ring", 256, dict(g=2)),
        ("striped", "striped", 256, dict(g=2, causal=True)),
        ("a2a", "a2a", 256, dict(g=2)),
    ]),
    "model2seq2": ({"data": 1, "model": 2, "seq": 2}, [
        ("striped", "striped", 256, dict(h=8, g=4, causal=True)),
        ("windowed", "windowed", 256, dict(h=8, g=4, causal=True, window=96,
                                           striped=False)),
        ("a2a", "a2a", 256, dict(h=8, g=4, causal=True)),
    ]),
}


def _jax_mesh(mesh):
    n = mesh["data"] * mesh["model"] * mesh["seq"]
    return jax_make_mesh(JaxMeshConfig(**mesh), devices=jax.devices()[:n])


def _reference_attention(mesh, spec, arrays):
    tag, kw = spec["tag"], dict(causal=spec["causal"],
                                window=spec["window"])
    q, k, v, do = (jnp.asarray(arrays[f"{tag}/{n}"])
                   for n in ("q", "k", "v", "do"))
    if spec["engine"] == "ring":
        def f(q_, k_, v_):
            return jax_ring(q_, k_, v_, mesh=mesh, striped=spec["striped"],
                            **kw)
    else:
        def f(q_, k_, v_):
            return jax_a2a(q_, k_, v_, mesh=mesh, **kw)
    def both(q_, k_, v_, do_):
        o, vjp = jax.vjp(f, q_, k_, v_)
        return (o, *vjp(do_))

    return [np.asarray(a) for a in jax.jit(both)(q, k, v, do)]


@pytest.fixture(scope="module", params=list(WORLDS))
def sp_world(request, tmp_path_factory):
    """One gloo world of the engines and, on the seq2 and model2seq2
    worlds, 3 train steps of both families."""
    name = request.param
    mesh, cases = WORLDS[name]
    attn, arrays = [], {}
    for i, (tag, _, t, kw) in enumerate(cases):
        engine = "a2a" if tag.startswith("a2a") else "ring"
        spec, arr = _case(tag, engine, t, seed=i, **kw)
        attn.append(spec)
        arrays.update(arr)
    train = _train_cases(name, arrays)
    got = _world(tmp_path_factory.mktemp(name), mesh, attn, train, arrays)
    return name, mesh, cases, attn, arrays, train, got


def _assemble(got, mesh, tag, shape_q, shape_k):
    """The ranks' shards put back at their rows, heads and positions."""
    out = {n: np.full(shape_q if n in ("o", "dq") else shape_k, np.nan,
                      np.float32) for n in ("o", "dq", "dk", "dv")}
    for r in got:
        pos = r[f"{tag}/pos"]
        for n in out:
            x = r[f"{tag}/{n}"]
            b, h = x.shape[:2]
            di, mi = int(r["data_index"]), int(r["model_index"])
            out[n][di * b:(di + 1) * b, mi * h:(mi + 1) * h][:, :, pos] = x
    return [out[n] for n in ("o", "dq", "dk", "dv")]


def test_engines_match_the_reference_mesh(sp_world):
    name, mesh, cases, attn, arrays, _, got = sp_world
    jmesh = _jax_mesh(mesh)
    for spec in attn:
        tag = spec["tag"]
        ref = _reference_attention(jmesh, spec, arrays)
        port = _assemble(got, mesh, tag, arrays[f"{tag}/q"].shape,
                         arrays[f"{tag}/k"].shape)
        for n, a, b in zip(("o", "dq", "dk", "dv"), port, ref):
            assert not np.isnan(a).any(), (name, tag, n)
            np.testing.assert_allclose(a, b, atol=1e-5 if n == "o" else 1e-4,
                                       rtol=0, err_msg=f"{name} {tag} {n}")


def test_each_rank_runs_the_engines_count_of_flash_calls(sp_world):
    """The step structure: the flash calls of one layer on seq rank
    ``my`` (none where the plain body runs)."""
    name, mesh, cases, _, arrays, _, got = sp_world
    from dct_tpu_torch.ops.attention import _ring_window_steps

    s = mesh["seq"]
    for tag, layout, t, kw in cases:
        steps = _ring_window_steps(kw.get("window"), t // s, s)
        for r in got:
            my = int(r["seq_index"])
            want = 0 if layout is None else sp_forward_calls(layout, my, s,
                                                             steps)
            assert int(r[f"{tag}/calls"]) == want, (name, tag, my)


# -------------------------------------------------------------- training

def _train_cases(name, arrays):
    """3 SGD steps of both families on the seq2 and model2seq2 worlds
    (the causal family: rope, horizon 2, window 64 on seq2; striped at
    model2seq2), both sides from one seeded init (the port's, in flax
    layout)."""
    import torch

    from dct_tpu_torch.config import ModelConfig
    from dct_tpu_torch.convert import flax_weights
    from dct_tpu_torch.models.registry import get_model

    if name not in ("seq2", "model2seq2"):
        return []
    out = []
    for family, extra in (("weather_transformer", {}),
                          ("weather_transformer_causal", dict(
                              horizon=2, pos_embed="rope",
                              attn_window=64 if name == "seq2" else 0))):
        tag = family
        cfg = dict(TRAIN, name=family, **extra)
        torch.manual_seed(3)
        model = get_model(ModelConfig(**cfg), input_dim=F_IN, device="cpu")
        for k, v in flax_weights(model).items():
            arrays[f"{tag}/params/{k}"] = np.asarray(v)
        rng = np.random.default_rng(len(name))
        for i in range(STEPS):
            arrays[f"{tag}/x{i}"] = rng.standard_normal(
                (BATCH, TRAIN["seq_len"], F_IN)).astype(np.float32)
            shape = ((BATCH, TRAIN["seq_len"], 2) if extra else (BATCH,))
            arrays[f"{tag}/y{i}"] = rng.integers(0, 2, shape).astype(
                np.int32)
            arrays[f"{tag}/w{i}"] = np.array([1, 1, 1, 0], np.float32)
        out.append(dict(tag=tag, cfg=cfg))
    return out


def _reference_steps(mesh, cfg, arrays, tag):
    """The reference's mesh run: its ring attention over the mesh, the
    state placed by its rules, the batch sharded over data."""
    model = jax_get_model(JaxModelConfig(**cfg), input_dim=F_IN, mesh=mesh)
    st = jax_create_state(model, input_dim=F_IN, lr=LR, seed=0,
                          optimizer="sgd", momentum=MOMENTUM,
                          example_shape=(1, TRAIN["seq_len"], F_IN))
    pre = f"{tag}/params/"
    flat = {k[len(pre):]: jnp.asarray(arrays[k]) for k in arrays
            if k.startswith(pre)}
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *path, last = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = v
    st = st.replace(params={"params": tree},
                    opt_state=st.tx.init({"params": tree}))
    st = shard_state_with_rules(st, mesh)
    step = jax_make_step(donate=False)
    losses = []
    with mesh:
        for i in range(STEPS):
            batch = [jax.device_put(arrays[f"{tag}/{n}{i}"],
                                    batch_sharding(mesh)) for n in "xyw"]
            st, m = step(st, *batch)
            losses.append(float(m["train_loss"]))
    return losses, _flatten_params(jax.device_get(st.params)["params"])


@pytest.mark.parametrize("sp_world", ["seq2", "model2seq2"],
                         indirect=True)
def test_three_train_steps_match_the_reference_mesh_run(sp_world):
    name, mesh, _, _, arrays, train, got = sp_world
    jmesh = _jax_mesh(mesh)
    for case in train:
        tag = case["tag"]
        losses, params = _reference_steps(jmesh, case["cfg"], arrays, tag)
        for r in got:  # every rank holds the global loss and parameters
            np.testing.assert_allclose(r[f"{tag}/losses"], losses,
                                       rtol=1e-5, err_msg=f"{name} {tag}")
            for key, ref in params.items():
                np.testing.assert_allclose(r[f"{tag}/p/{key}"], ref,
                                           atol=1e-5, rtol=0,
                                           err_msg=f"{name} {tag} {key}")


# ------------------------------------------------------------ train_job

FIT = dict(DCT_SEQ_LEN="16", DCT_D_MODEL="16", DCT_N_HEADS="2",
           DCT_N_LAYERS="2", DCT_D_FF="32", DCT_DROPOUT="0.2",
           DCT_BF16_COMPUTE="0", DCT_OPTIMIZER="sgd", DCT_LR="0.01",
           DCT_MOMENTUM="0.9", DCT_EPOCHS="2", DCT_BATCH_SIZE="16")


def _train_job(processed, tmp, name, *, world, **extra):
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(_env(), DCT_DEVICE="cpu", DCT_PROCESSED_DIR=processed,
                   DCT_MODELS_DIR=str(tmp / name),
                   DCT_TRACKING_DIR=str(tmp / "mlruns"), **FIT, **extra)
        if world > 1:
            env.update(WORLD_SIZE=str(world), NODE_RANK=str(r),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dct_tpu_torch.train_job"], env=env,
            cwd=str(tmp), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    return procs


def _finish(procs, timeout=300):
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
    return outs


def _fit_line(out):
    return json.loads(next(ln for ln in out.splitlines()
                           if ln.startswith("[train_job] fit "))
                      [len("[train_job] fit "):])


@pytest.fixture(scope="module")
def sp_fits(tmp_path_factory):
    """train_job at W=1 and at ``seq=2`` (the causal family on the striped
    ring, the pooled family on the all-to-all engine, the MoE and ZeRO-1
    on the ring), dropout 0.2, all started at once."""
    from dct_tpu_torch.data.synthetic import generate_weather_csv
    from dct_tpu_torch.etl.preprocess import preprocess_csv_to_parquet

    tmp = tmp_path_factory.mktemp("sp_fit")
    generate_weather_csv(str(tmp / "w.csv"), rows=240, seed=5)
    processed = str(tmp / "processed")
    preprocess_csv_to_parquet(str(tmp / "w.csv"), processed)
    causal = dict(DCT_MODEL="weather_transformer_causal")
    pooled = dict(DCT_MODEL="weather_transformer")
    runs = {
        "causal1": _train_job(processed, tmp, "causal1", world=1, **causal),
        "causal2": _train_job(processed, tmp, "causal2", world=2,
                              DCT_MESH_SEQ="2", **causal),
        "pooled1": _train_job(processed, tmp, "pooled1", world=1, **pooled),
        "pooled2": _train_job(processed, tmp, "pooled2", world=2,
                              DCT_MESH_SEQ="2", DCT_SP_ENGINE="a2a",
                              **pooled),
        "moe1": _train_job(processed, tmp, "moe1", world=1,
                           DCT_MODEL="weather_moe", DCT_N_EXPERTS="2"),
        "moe": _train_job(processed, tmp, "moe", world=2, DCT_MESH_SEQ="2",
                          DCT_MODEL="weather_moe", DCT_N_EXPERTS="2"),
        "zero1": _train_job(processed, tmp, "zero1", world=2,
                            DCT_MESH_SEQ="2", DCT_SHARD_OPT_STATE="1",
                            **pooled),
    }
    return {k: _finish(v) for k, v in runs.items()}


@pytest.mark.parametrize("family", ["causal", "pooled"])
def test_train_job_on_a_seq_axis_equals_one_process(sp_fits, family):
    """Every rank of the ``seq=2`` world ends on the W=1 run's val_loss
    (dropout draws the W=1 masks at each rank's positions)."""
    (rc1, out1, err1), = sp_fits[f"{family}1"]
    assert rc1 == 0, err1[-2000:]
    one = _fit_line(out1)
    for rc, out, err in sp_fits[f"{family}2"]:
        assert rc == 0, err[-3000:]
        fit = _fit_line(out)
        assert fit["mesh"] == {"data": 1, "model": 1, "seq": 2, "pipe": 1}
        assert fit["val_loss"] == pytest.approx(one["val_loss"], abs=1e-5)


@pytest.mark.parametrize("run,one", [("moe", "moe1"), ("zero1", "pooled1")])
def test_train_job_refuses_what_item_16b_ports(sp_fits, run, one):
    """What item 16b refused until it was ported, the MoE and ZeRO-1 on a
    seq axis, now trains: every rank ends on the W=1 run's val_loss."""
    (rc1, out1, err1), = sp_fits[one]
    assert rc1 == 0, err1[-2000:]
    want = _fit_line(out1)["val_loss"]
    for rc, out, err in sp_fits[run]:
        assert rc == 0, err[-3000:]
        fit = _fit_line(out)
        assert fit["mesh"] == {"data": 1, "model": 1, "seq": 2, "pipe": 1}
        assert fit["val_loss"] == pytest.approx(want, abs=1e-5)


@pytest.mark.parametrize("t_local,striped,window,cpu,card", [
    (64, False, None, False, True),     # seq=4 at T=256: the card's kernel
    (64, True, None, True, True),       # its striped half shards of 32
    (128, False, 100, True, True),
    (192, False, None, False, "raise"),  # no whole number of 128-blocks
    (192, True, None, False, "raise"),
    (128, True, 64, False, "raise"),    # a windowed striped ring
])
def test_ring_block_compute_is_the_kernel_or_raises_on_the_card(
        monkeypatch, t_local, striped, window, cpu, card):
    """On a CUDA device the ring takes the flash bodies for every shard
    the kernel wrapper takes and raises for the rest; on the CPU the
    reference's rule picks the flash or the plain body."""
    from dct_tpu_torch.ops.attention import ring_flash

    monkeypatch.delenv("DCT_FLASH", raising=False)
    kw = dict(striped=striped, window=window)
    assert ring_flash(t_local, device="cpu", **kw) is cpu
    if card == "raise":
        with pytest.raises(ValueError, match="no flash kernel body"):
            ring_flash(t_local, device="cuda", **kw)
    else:
        assert ring_flash(t_local, device="cuda", **kw) is card


@pytest.mark.parametrize("t,cpu,card", [(256, True, True),
                                        (96, False, True),
                                        (192, False, "raise")])
def test_a2a_call_is_the_kernel_or_raises_on_the_card(monkeypatch, t, cpu,
                                                      card):
    """a2a's full-length call: the kernel for every T the wrapper takes
    on a CUDA device, a raise for the rest; the reference's rule on the
    CPU (flash at multiples of 128, else blockwise or dense)."""
    from dct_tpu_torch.ops.attention import a2a_flash

    monkeypatch.delenv("DCT_FLASH", raising=False)
    assert a2a_flash(t, "cpu") is cpu
    if card == "raise":
        with pytest.raises(ValueError, match="no flash kernel body"):
            a2a_flash(t, "cuda")
    else:
        assert a2a_flash(t, "cuda") is card
