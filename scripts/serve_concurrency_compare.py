"""Serving past concurrency 1: the reference's server against the port's,
on one host's CPU, with the same model, request body and load.

    JAX_PLATFORMS=cpu python3 scripts/serve_concurrency_compare.py \
        [--requests 48] [--servers ref_numpy,port_torch] [--device cuda:0]

Part 1 times the fast request parse (``parse_envelope_array``) of one
8-window body (8 x 1024 rows of 5 features, the body of the port's
``serving.loadgen --rows 8 --seq-len 1024``) alone and in 4 threads at
once, each case in a fresh interpreter: the reference's runtime in one
that imports neither torch nor jax (``ref``), the port's copy in one that
imports no torch (``port``), the port's copy after torch has run one
op, so that its intra-op thread pool is up (``port_after_torch``), and,
where a card is present, after torch has also made its CUDA context
(``port_after_cuda``).

Part 2 starts each server in its own interpreter over the same narrow
``weather_transformer`` package (T=1024, d_model 32, 2 layers, seed 0;
narrow so that the forward stays small beside the parse and the JSON)
and drives it with the port's loadgen closed loop at concurrency 1, 4
and 16, ``--requests`` a level:

- ``ref_numpy``: ``dct_tpu.serving.server``, its numpy engine;
- ``port_numpy``: ``dct_tpu_torch.serving.server``, the numpy engine;
- ``ref_jax``: the reference's jax engine on the CPU;
- ``port_torch``: the port's torch engine (the jax engine's counterpart)
  on ``--device`` (default ``cpu``).

``--servers`` picks some of them (``ref_jax`` needs jax). Every server
keeps its config's defaults otherwise. One ``[compare]`` JSON line per
case: the host's parse and each server's rps and latency.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, WINDOWS, LEVELS = 1024, 8, (1, 4, 16)

PARSE = r'''
import json, sys, threading, time
import numpy as np
mode, body_path = sys.argv[1:3]
if mode == "ref":
    from dct_tpu.serving.runtime import parse_envelope_array
else:
    from dct_tpu_torch.serving.numpy_runtime import parse_envelope_array
if mode.startswith("port_after"):
    import torch
    torch.ones(512, 512) @ torch.ones(512, 512)
    if mode == "port_after_cuda":
        torch.ones(512, 512, device="cuda").sum().item()
body = open(body_path, "rb").read()
assert parse_envelope_array(body).shape == (%d, %d, 5)
out = {"case": mode, "torch_imported": "torch" in sys.modules,
       "jax_imported": "jax" in sys.modules}
for threads in (1, 4):
    def work():
        for _ in range(5):
            parse_envelope_array(body)
    pool = [threading.Thread(target=work) for _ in range(threads)]
    t0 = time.perf_counter()
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    out[f"ms_per_round_{threads}_threads"] = (time.perf_counter() - t0) / 5 * 1e3
print(json.dumps(out))
''' % (WINDOWS, SEQ)

SERVER = r'''
import json, sys
import numpy as np
side, engine, pkg, device = sys.argv[1:5]
with np.load(pkg + "/model.npz") as z:
    weights = {k: z[k] for k in z.files}
with open(pkg + "/model_meta.json") as f:
    meta = json.load(f)
if side == "ref":
    from dct_tpu.config import ServingConfig
    from dct_tpu.serving.server import make_server_from_weights
    kw = {}
else:
    from dct_tpu_torch.config import ServingConfig
    from dct_tpu_torch.serving.server import make_server_from_weights
    kw = {"device": device}
cfg = ServingConfig()
cfg.engine = engine
server = make_server_from_weights(weights, meta, serving=cfg, **kw)
print(server.server_address[1], flush=True)
server.serve_forever()
'''

SERVERS = {"ref_numpy": ("ref", "numpy"), "port_numpy": ("port", "numpy"),
           "ref_jax": ("ref", "jax"), "port_torch": ("port", "torch")}


def child_env() -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("DCT_")}
    env.update(PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    return env


def main() -> int:
    sys.path.insert(0, ROOT)
    from dct_tpu_torch.serving import loadgen
    from dct_tpu_torch.serving.package import (
        init_package_weights,
        write_package,
    )

    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--servers", default=",".join(SERVERS))
    ap.add_argument("--device", default="cpu",
                    help="the port's torch engine's device")
    args = ap.parse_args()
    import torch

    cases = ["ref", "port", "port_after_torch"]
    if torch.cuda.is_available():
        cases.append("port_after_cuda")
    root = tempfile.mkdtemp(prefix="serve_compare_")
    body = json.dumps({"data": np.random.default_rng(0).standard_normal(
        (WINDOWS, SEQ, 5)).round(4).tolist()}).encode()
    body_path = os.path.join(root, "body.json")
    with open(body_path, "wb") as f:
        f.write(body)
    for case in cases:
        r = subprocess.run([sys.executable, "-c", PARSE, case, body_path],
                           env=child_env(), capture_output=True, text=True,
                           timeout=600, check=True)
        print(f"[compare] parse {r.stdout.strip()}", flush=True)
    meta = dict(model="weather_transformer", name="weather_transformer",
                input_dim=5, seq_len=SEQ, d_model=32, n_heads=2, n_layers=2,
                d_ff=64, num_classes=2, horizon=1)
    pkg = os.path.join(root, "pkg")
    write_package(pkg, init_package_weights(meta, seed=0), meta)
    for name in args.servers.split(","):
        side, engine = SERVERS[name]
        proc = subprocess.Popen(
            [sys.executable, "-c", SERVER, side, engine, pkg, args.device],
            env=child_env(), stdout=subprocess.PIPE, text=True)
        try:
            port = int(proc.stdout.readline())
            levels = [loadgen.run_closed_loop(
                "127.0.0.1", port, body, concurrency=c,
                total_requests=args.requests, duration_s=300.0)
                for c in LEVELS]
        finally:
            proc.terminate()
            proc.wait(60)
        print(f"[compare] sweep {json.dumps({'server': name, 'levels': [{k: lv[k] for k in ('concurrency', 'requests', 'errors', 'qps', 'p50_ms', 'p99_ms')} for lv in levels]})}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
