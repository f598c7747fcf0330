"""The port's GPipe schedule on gloo worlds (CPU), held to the JAX
package's ``pipeline_apply`` on its virtual devices.

- Worlds of ``pipe=2`` and ``pipe=4``, each stage a ``tanh(x W + b)``
  layer holding its own stage's slice of stacked ``[P, D, D]`` params,
  ``M`` in ``{P, 2P}`` microbatches: the outputs on every stage equal the
  reference's ``pipeline_apply`` within 1e-5, and the gradients (from a
  seeded cotangent: the input's on stage 0, each stage's of its own
  params) equal ``jax.vjp`` of it within 1e-4.
- Each stage runs its stage exactly ``M`` times a forward and ``M`` a
  backward: the ramp ticks of the ``M + P - 1`` tick schedule are
  skipped, where the reference computes and discards them.
- The sequential oracle equals the reference's ``gpipe_tick_apply``, and
  ``stack_stage_params``, ``ticks`` and ``bubble`` the reference's.
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
from dct_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dct_tpu.parallel.pipeline import gpipe_tick_apply, pipeline_apply
from dct_tpu.parallel.pipeline import stack_stage_params as jax_stack
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, ROWS = 16, 16

_WORKER = r'''
import json, sys
import numpy as np, torch, torch.distributed as dist
from dct_tpu_torch.config import MeshConfig
from dct_tpu_torch.parallel.mesh import make_mesh, set_mesh
from dct_tpu_torch.parallel.pipeline import pipeline_apply

rank, world, port, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4], sys.argv[5])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)
spec = json.load(open(inp + ".json"))
data = np.load(inp)
mesh = make_mesh(MeshConfig(data=1, pipe=world))
set_mesh(mesh)
shard = mesh.pipe_shard()
s = shard.index
results = {"stage": np.int64(s)}
for m in spec["microbatches"]:
    w = torch.from_numpy(data["w"][s].copy()).requires_grad_()
    b = torch.from_numpy(data["b"][s].copy()).requires_grad_()
    x = torch.from_numpy(data["x"]).requires_grad_()
    calls = []

    def stage(a):
        calls.append(1)
        return torch.tanh(a @ w + b)

    y = pipeline_apply(stage, x, shard=shard, n_microbatches=m,
                       params=[w, b])
    forwards = len(calls)
    gx, gw, gb = torch.autograd.grad(y, [x, w, b],
                                     torch.from_numpy(data["dy"]))
    results.update({f"{m}/y": y.detach().numpy(), f"{m}/gx": gx.numpy(),
                    f"{m}/gw": gw.numpy(), f"{m}/gb": gb.numpy(),
                    f"{m}/forwards": np.int64(forwards)})
np.savez(f"{out}.{rank}.npz", **results)
dist.barrier()
dist.destroy_process_group()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _arrays(p: int) -> dict:
    rng = np.random.default_rng(p)
    return {"w": (rng.standard_normal((p, D, D)) * 0.3).astype(np.float32),
            "b": (rng.standard_normal((p, D)) * 0.1).astype(np.float32),
            "x": rng.standard_normal((ROWS, D)).astype(np.float32),
            "dy": rng.standard_normal((ROWS, D)).astype(np.float32)}


@pytest.fixture(scope="module", params=[2, 4], ids=["pipe2", "pipe4"])
def pipe_world(request, tmp_path_factory):
    p = request.param
    tmp = tmp_path_factory.mktemp(f"pipe{p}")
    arrays = _arrays(p)
    inp = str(tmp / "inp.npz")
    np.savez(inp, **arrays)
    with open(inp + ".json", "w") as f:
        json.dump({"microbatches": [p, 2 * p]}, f)
    out, port = str(tmp / "out"), _free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith("DCT_")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(p), str(port), inp, out],
        env=env, cwd=str(tmp), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(p)]
    errs = []
    try:
        for proc in procs:
            _, err = proc.communicate(timeout=120)
            errs.append((proc.returncode, err))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rc, err in errs:
        assert rc == 0, err[-3000:]
    return p, arrays, [dict(np.load(f"{out}.{r}.npz")) for r in range(p)]


def _stage_fn(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _reference(p, arrays, m):
    mesh = jax_make_mesh(JaxMeshConfig(data=1, pipe=p),
                         devices=jax.devices()[:p])
    stacked = {"w": jnp.asarray(arrays["w"]), "b": jnp.asarray(arrays["b"])}

    def f(params, x):
        return pipeline_apply(_stage_fn, params, x, mesh=mesh,
                              n_microbatches=m)

    y, vjp = jax.vjp(f, stacked, jnp.asarray(arrays["x"]))
    gp, gx = vjp(jnp.asarray(arrays["dy"]))
    return (np.asarray(y), np.asarray(gx), np.asarray(gp["w"]),
            np.asarray(gp["b"]))


@pytest.mark.parametrize("mult", [1, 2], ids=["M=P", "M=2P"])
def test_schedule_matches_the_reference_pipeline(pipe_world, mult):
    p, arrays, got = pipe_world
    m = mult * p
    y, gx, gw, gb = _reference(p, arrays, m)
    for r in got:
        s = int(r["stage"])
        np.testing.assert_allclose(r[f"{m}/y"], y, atol=1e-5, rtol=0)
        np.testing.assert_allclose(r[f"{m}/gw"], gw[s], atol=1e-4, rtol=0)
        np.testing.assert_allclose(r[f"{m}/gb"], gb[s], atol=1e-4, rtol=0)
        if s == 0:
            np.testing.assert_allclose(r[f"{m}/gx"], gx, atol=1e-4, rtol=0)
        else:  # a later stage's input is never read
            assert not r[f"{m}/gx"].any()


@pytest.mark.parametrize("mult", [1, 2], ids=["M=P", "M=2P"])
def test_each_stage_runs_only_its_real_ticks(pipe_world, mult):
    p, _, got = pipe_world
    m = mult * p
    for r in got:
        assert int(r[f"{m}/forwards"]) == m


def test_sequential_oracle_and_helpers_match_the_reference():
    import torch

    from dct_tpu_torch.parallel import pipeline as port

    arrays = _arrays(4)
    stages = [{"w": arrays["w"][s], "b": arrays["b"][s]} for s in range(4)]
    stacked = port.stack_stage_params(stages)
    ref = jax_stack([{k: jnp.asarray(v) for k, v in st.items()}
                     for st in stages])
    for k in stacked:
        np.testing.assert_array_equal(stacked[k], np.asarray(ref[k]))
    x = torch.from_numpy(arrays["x"])
    got = port.sequential_apply(
        lambda s, h: torch.tanh(h @ torch.from_numpy(stacked["w"][s])
                                + torch.from_numpy(stacked["b"][s])), 4, x)
    want = gpipe_tick_apply(_stage_fn, ref, jnp.asarray(arrays["x"]),
                            n_microbatches=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert (port.ticks(4, 2), port.bubble(4, 2)) == (5, 1 / 5)
    with pytest.raises(ValueError, match="not divisible by n_microbatches"):
        port.pipeline_apply(lambda a: a, x[:6], shard=None,
                            n_microbatches=4)
