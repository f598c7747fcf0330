"""The pipeline-parallel transformer on gloo worlds (CPU), held to the JAX
package's ``WeatherTransformerPP`` on its virtual devices.

- Worlds of ``pipe=2`` (``M`` 2 and 4), ``data=2, pipe=2`` and
  ``model=2, pipe=2`` of ``weather_transformer_pp`` at T=256 (the flash
  route), both sides from one seeded init: every rank's logits equal the
  reference's mesh forward (``pipeline_apply`` over its ``pipe`` axis)
  within 1e-5, and the gradients of the weighted cross entropy, each
  leaf gathered dense from the ranks' update-space blocks, equal
  ``jax.grad`` of the reference's within 1e-4: the stage leaves from
  their own stages, ``in_proj`` from stage 0's use alone, ``ln_out`` and
  ``head`` from the last stage's, each counted once.
- Each rank's flash calls are exact: ``(n_layers / P) x M`` a forward
  pass, as many under the train step's forward (each one's backward runs
  under grad), because the ramp ticks are skipped.
- The stored spec of every train-state leaf equals the reference's
  ``state_shardings`` on the world's mesh, plain, ZeRO-1 and FSDP: a
  stage leaf is ``P("pipe", <TP rule>, None...)`` and never data-split.
- Item 15b's remainder: a rule storing Adam's ``mu`` and ``nu`` of one
  leaf apart from each other places each by its own spec, equal to the
  reference's on a ``data=2, model=2`` mesh, and four Adam steps there
  (their losses: the last one the function after three updates) and the
  parameters after three equal one process's within 1e-6.
"""

import functools
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
from dct_tpu.ops.losses import masked_cross_entropy as jax_ce
from dct_tpu.parallel import sharding_rules as ref
from dct_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dct_tpu.train.state import create_train_state as jax_state
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F_IN, BATCH = 5, 8
CFG = dict(name="weather_transformer_pp", seq_len=256, d_model=32,
           n_heads=4, n_layers=4, d_ff=64, n_stages=2, dropout=0.0)
FLAGS = {"plain": {}, "zero1": {"shard_opt": True},
         "fsdp": {"shard_params": True}}
MU_NU_RULE = ("mu/params/head/kernel$=data;"
              "nu/params/head/kernel$=-,model")
ADAM_STEPS = 3

_WORKER = r'''
import json, os, sys
import numpy as np, torch, torch.distributed as dist
from dct_tpu_torch.checkpoint.manager import flatten_tree
from dct_tpu_torch.config import MeshConfig, ModelConfig
from dct_tpu_torch.convert import load_flax_weights
from dct_tpu_torch.models.mlp import set_data_block
from dct_tpu_torch.models.registry import get_model
from dct_tpu_torch.ops import flash_attention as fa
from dct_tpu_torch.parallel.mesh import make_mesh, set_mesh
from dct_tpu_torch.parallel import sharding_rules as sr
from dct_tpu_torch.train import state as port_state
from dct_tpu_torch.train import steps

rank, world, port, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)
spec = json.load(open(inp + ".json"))
data = np.load(inp)
flat = {k[2:]: data[k] for k in data.files if k.startswith("p/")}
mesh = make_mesh(MeshConfig(**spec["mesh"]))
set_mesh(mesh)
n = len(data["x"]) // mesh.data_size
rows = slice(mesh.data_index * n, (mesh.data_index + 1) * n)
x, y, w = (data[k][rows] for k in "xyw")
calls, _real = [], fa.flash_attention
fa.flash_attention = lambda *a, **kw: (calls.append(1) or _real(*a, **kw))
results = {"pipe_index": np.int64(mesh.pipe_index),
           "data_index": np.int64(mesh.data_index)}


def state(cfg, opt, **flags):
    model = get_model(ModelConfig(**cfg), input_dim=x.shape[-1],
                      device="cpu", mesh=mesh)
    st = port_state.create_train_state(model, input_dim=x.shape[-1],
                                       lr=1e-3, seed=0, **opt)
    load_flax_weights(model, flat)
    sr.shard_state_with_rules(st, mesh, family=cfg["name"], **flags)
    set_data_block(model, mesh.data_size, mesh.data_index)
    return st


def specs(st):
    return {sr.path_str(p): sr.spec_to_json(sr.leaf_spec(st, sr.path_str(p)))
            for _, p, _ in sr.state_leaf_paths(st)}


if spec["kind"] == "pp":
    layouts = {}
    for name, flags in spec["flags"].items():
        st = state(spec["cfg"], {"optimizer": "adam"}, **flags)
        layouts[name] = specs(st)
    results["layouts"] = np.array(json.dumps(layouts))
    for m in spec["microbatches"]:
        cfg = dict(spec["cfg"], n_microbatches=m)
        st = state(cfg, {"optimizer": "sgd"})
        calls.clear()
        with torch.no_grad():
            st.model.eval()
            logits = st.model(torch.from_numpy(x))
        results[f"{m}/eval_calls"] = np.int64(len(calls))
        results[f"{m}/logits"] = logits.numpy()
        calls.clear()
        loss, grads = steps.loss_and_grads(st, x, y, w)
        results[f"{m}/train_calls"] = np.int64(len(calls))
        results[f"{m}/loss"] = np.float64(loss)
        for i, lf in enumerate(st.layout.leaves):
            results[f"{m}/g/{lf.key}"] = sr.gather_leaf(grads[i], lf,
                                                        lf.moment_spec)
else:  # the mu/nu rule: Adam steps
    os.environ["DCT_SHARD_RULES"] = spec["rules"]
    st = state(spec["cfg"], {"optimizer": "adam"})
    results["layouts"] = np.array(json.dumps({"rule": specs(st)}))
    step = steps.make_train_step()
    losses = []
    for i in range(spec["steps"] + 1):
        if i == spec["steps"]:  # the params after the last update
            for key, value in flatten_tree(
                    sr.gather_tree(st)["params"]).items():
                results[f"p/{key}"] = value
        st, mt = step(st, x, y, w)
        losses.append(float(mt["train_loss"]))
    results["losses"] = np.array(losses)
np.savez(f"{out}.{rank}.npz", **results)
dist.barrier()
dist.destroy_process_group()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _inputs(cfg):
    """One seeded init (the port's, flax layout) and one batch."""
    import torch

    from dct_tpu_torch.config import ModelConfig
    from dct_tpu_torch.convert import flax_weights
    from dct_tpu_torch.models.registry import get_model

    torch.manual_seed(7)
    model = get_model(ModelConfig(**cfg), input_dim=F_IN, device="cpu")
    arrays = {f"p/{k}": np.asarray(v) for k, v in flax_weights(model).items()}
    rng = np.random.default_rng(11)
    arrays["x"] = rng.standard_normal(
        (BATCH, cfg["seq_len"], F_IN)).astype(np.float32)
    arrays["y"] = rng.integers(0, 2, BATCH).astype(np.int32)
    arrays["w"] = np.array([1, 1, 0, 1, 1, 1, 1, 0], np.float32)
    return arrays


def _launch(tmp, mesh, spec, arrays):
    world = int(np.prod(list(mesh.values())))
    inp = str(tmp / "inp.npz")
    np.savez(inp, **arrays)
    with open(inp + ".json", "w") as f:
        json.dump(dict(spec, mesh=mesh), f)
    out, port = str(tmp / "out"), _free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith("DCT_")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world), str(port), inp,
         out], env=env, cwd=str(tmp), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    return procs, out, world


def _collect(started, timeout=240):
    procs, out, world = started
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            errs.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, err in errs:
        assert rc == 0, err[-3000:]
    return [dict(np.load(f"{out}.{r}.npz")) for r in range(world)]


WORLDS = {
    "pipe2": ({"data": 1, "model": 1, "seq": 1, "pipe": 2}, [2, 4]),
    "data2pipe2": ({"data": 2, "model": 1, "seq": 1, "pipe": 2}, [2]),
    "model2pipe2": ({"data": 1, "model": 2, "seq": 1, "pipe": 2}, [2]),
}
MU_NU_MESH = {"data": 2, "model": 2, "seq": 1, "pipe": 1}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The three pipe worlds and the mu/nu world, started at once."""
    arrays = _inputs(CFG)
    started = {}
    for name, (mesh, ms) in WORLDS.items():
        started[name] = _launch(
            tmp_path_factory.mktemp(name), mesh,
            {"kind": "pp", "cfg": CFG, "microbatches": ms, "flags": FLAGS},
            arrays)
    started["mu_nu"] = _launch(
        tmp_path_factory.mktemp("mu_nu"), MU_NU_MESH,
        {"kind": "rule", "cfg": CFG, "rules": MU_NU_RULE,
         "steps": ADAM_STEPS}, arrays)
    return arrays, {k: _collect(v) for k, v in started.items()}


def _jax_mesh(mesh):
    n = int(np.prod(list(mesh.values())))
    return jax_make_mesh(JaxMeshConfig(**mesh), devices=jax.devices()[:n])


def _tree(arrays):
    tree: dict = {}
    for k, v in arrays.items():
        if not k.startswith("p/"):
            continue
        node = tree
        *path, last = k[2:].split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = jnp.asarray(v)
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _reference(mesh, arrays, m):
    """The reference's logits and gradients on its mesh."""
    jmesh = _jax_mesh(mesh)
    model = jax_get_model(JaxModelConfig(**dict(CFG, n_microbatches=m)),
                          input_dim=F_IN, mesh=jmesh)
    x, y, w = (jnp.asarray(arrays[k]) for k in "xyw")

    def loss(params):
        logits = model.apply({"params": params}, x)
        s, c = jax_ce(logits, y, w)
        return s / jnp.maximum(c, 1.0), logits

    with jmesh:
        (_, logits), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(_tree(arrays))
    return np.asarray(logits), {k: np.asarray(v)
                                for k, v in _flat(grads).items()}


@pytest.mark.parametrize("name,m", [("pipe2", 2), ("pipe2", 4),
                                    ("data2pipe2", 2),
                                    ("model2pipe2", 2)])
def test_logits_and_gradients_match_the_reference_mesh(worlds, name, m):
    arrays, got = worlds
    mesh = WORLDS[name][0]
    logits, grads = _reference(mesh, arrays, m)
    dp = mesh["data"]
    n = BATCH // dp
    for r in got[name]:
        # Each data row holds its block of the batch.
        di = int(r["data_index"])
        np.testing.assert_allclose(r[f"{m}/logits"],
                                   logits[di * n:(di + 1) * n], atol=1e-5,
                                   rtol=0, err_msg=f"{name} {m}")
        for key, ref_g in grads.items():
            np.testing.assert_allclose(r[f"{m}/g/{key}"], ref_g, atol=1e-4,
                                       rtol=0, err_msg=f"{name} {m} {key}")


@pytest.mark.parametrize("name,m", [("pipe2", 2), ("pipe2", 4),
                                    ("data2pipe2", 2),
                                    ("model2pipe2", 2)])
def test_each_rank_runs_the_schedule_count_of_flash_calls(worlds, name, m):
    _, got = worlds
    mesh = WORLDS[name][0]
    want = CFG["n_layers"] // mesh["pipe"] * m
    for r in got[name]:
        assert int(r[f"{m}/eval_calls"]) == want, (name, m)
        assert int(r[f"{m}/train_calls"]) == want, (name, m)


@functools.lru_cache(maxsize=None)
def _ref_state(mesh_items):
    """The reference's train state on a mesh (its init traces the model
    once, so it is built once a mesh)."""
    jmesh = _jax_mesh(dict(mesh_items))
    model = jax_get_model(JaxModelConfig(**CFG), input_dim=F_IN, mesh=jmesh)
    return jmesh, jax_state(model, input_dim=F_IN, lr=1e-3, seed=0,
                            example_shape=(1, CFG["seq_len"], F_IN))


def _ref_specs(mesh, flags, rules=None, monkeypatch=None):
    if rules:
        monkeypatch.setenv("DCT_SHARD_RULES", rules)
    jmesh, jst = _ref_state(tuple(mesh.items()))
    shardings = ref.state_shardings(jst, jmesh, family=CFG["name"], **flags)
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(shardings)[0]:
        dims = list(s.spec)
        while dims and dims[-1] is None:
            dims.pop()
        out[ref.path_str(path)] = dims
    return out


def _trim(specs):
    out = {}
    for k, v in specs.items():
        dims = list(v)
        while dims and dims[-1] is None:
            dims.pop()
        out[k] = dims
    return out


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("name", list(WORLDS))
def test_every_leaf_spec_matches_the_reference_state_shardings(worlds, name,
                                                               flags):
    _, got = worlds
    theirs = _ref_specs(WORLDS[name][0], FLAGS[flags])
    for r in got[name]:
        ours = _trim(json.loads(str(r["layouts"]))[flags])
        assert ours == theirs, (name, flags)
        stage = {k: v for k, v in ours.items() if "pp_stages" in k}
        assert stage and all(v[0] == "pipe" and "data" not in v
                             for v in stage.values())


def test_moments_stored_apart_from_each_other(worlds, monkeypatch):
    """Item 15b's remainder: ``mu`` and ``nu`` of the head kernel placed
    by their own specs (``data`` and ``model``), the reference's; Adam
    steps equal one process's."""
    arrays, got = worlds
    theirs = _ref_specs(MU_NU_MESH, {}, MU_NU_RULE, monkeypatch)
    mu = "opt_state/[0]/mu/params/head/kernel"
    nu = "opt_state/[0]/nu/params/head/kernel"
    assert (theirs[mu], theirs[nu]) == (["data"], [None, "model"])
    one = _one_process_adam(arrays, monkeypatch)
    for r in got["mu_nu"]:
        assert _trim(json.loads(str(r["layouts"]))["rule"]) == theirs
        np.testing.assert_allclose(r["losses"], one["losses"], atol=1e-6,
                                   rtol=0)
        for key, value in one["params"].items():
            got_v = r[f"p/{key}"]
            if key.endswith("qkv_proj/bias"):
                # A key bias's gradient is rounding noise (attention is
                # blind to a shift of every score), which Adam scales to
                # +-lr: its entries part on rounding. The q and v ones
                # are compared.
                hd = CFG["d_model"] // CFG["n_heads"]
                keep = lambda a: np.delete(a.reshape(
                    *a.shape[:-1], -1, 3, hd), 1, axis=-2)
                got_v, value = keep(got_v), keep(value)
            np.testing.assert_allclose(got_v, value, atol=1e-6, rtol=0,
                                       err_msg=key)


def _one_process_adam(arrays, monkeypatch):
    import torch

    from dct_tpu_torch.config import ModelConfig
    from dct_tpu_torch.convert import flax_weights, load_flax_weights
    from dct_tpu_torch.models.registry import get_model
    from dct_tpu_torch.parallel import mesh as port_mesh
    from dct_tpu_torch.train import state as port_state
    from dct_tpu_torch.train import steps

    monkeypatch.delenv("DCT_SHARD_RULES", raising=False)
    port_mesh.set_mesh(None)
    model = get_model(ModelConfig(**CFG), input_dim=F_IN, device="cpu")
    st = port_state.create_train_state(model, input_dim=F_IN, lr=1e-3,
                                       seed=0, optimizer="adam")
    load_flax_weights(model, {k[2:]: v for k, v in arrays.items()
                              if k.startswith("p/")})
    step = steps.make_train_step()
    losses, params = [], None
    for i in range(ADAM_STEPS + 1):
        if i == ADAM_STEPS:
            params = {k: np.array(v) for k, v in
                      flax_weights(model).items()}  # copies, not views
        st, mt = step(st, *(arrays[k] for k in "xyw"))
        losses.append(float(mt["train_loss"]))
    return {"losses": np.array(losses), "params": params}


@pytest.mark.parametrize("case", ["untileable_batch", "stages_not_pipe"])
def test_refusals_keep_the_references_messages(case):
    """A pipe world's batch that does not tile ``M`` and stacked stages
    that do not match the pipe size raise the reference's errors
    (``dct_tpu/models/transformer.py:289-298``,
    ``dct_tpu/parallel/pipeline.py:176-181``)."""
    import torch

    from dct_tpu_torch.config import ModelConfig
    from dct_tpu_torch.models.registry import get_model
    from dct_tpu_torch.parallel.mesh import PipeShard

    cfg = dict(CFG, seq_len=16, n_microbatches=2)
    model = get_model(ModelConfig(**cfg), input_dim=F_IN, device="cpu")
    if case == "stages_not_pipe":
        with pytest.raises(ValueError, match="stacked params have 2 stages "
                           "but mesh axis 'pipe' has 4 devices"):
            model.pp_stages.split_pipe_axis(PipeShard(4, 0))
        return
    model.pp_stages.split_pipe_axis(PipeShard(2, 0))
    with pytest.raises(ValueError, match="batch 3 does not tile "
                       "n_microbatches=2 x data=1 for the pipe=2 mesh"):
        model(torch.zeros(3, 16, F_IN))
