"""Where a sequence-parallel train step spends its time, on cards.

    python3 scripts/sp_step_trace.py --seq 4 [--engine ring|a2a]
        [--family weather_transformer_causal] [--bf16] [--striped auto|on|off]

Starts ``--seq`` processes (rank r on cuda:r, NCCL, the grid ``seq=S``;
``--seq 1`` is one process without a grid) that build the bench's
transformer width (``bench.py:216-227``: d_model 512, 8 heads, 4 layers,
d_ff 2048, T=1024) from seed 0, with SGD lr 0.01 momentum 0.9, and train
on one seeded batch of 16 windows (5 features): 3 warm-up steps, then the
median of 5 steps timed on the host clock around ``make_train_step`` and a
``torch.cuda.synchronize()``, then one step under ``torch.profiler`` on
each rank (``chip_smoke.trace_step``: device ms by kernel kind, NCCL's
kernels as ``collective``, and the device's idle share between the step's
first and last kernel), and the flash launches of one step. Rank 0 prints
one ``[sp_trace] {...}`` JSON line with every rank's numbers, then the
card's name and power limit. Needs ``--seq`` cards; exits non-zero
without them.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

WIDTH = dict(seq_len=1024, d_model=512, n_heads=8, n_layers=4, d_ff=2048,
             dropout=0.0)
BATCH, F_IN, WARMUP, TIMED = 16, 5, 3, 5


def rank_main(args) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist

    from chip_smoke import trace_step
    from dct_tpu_torch.config import MeshConfig, ModelConfig
    from dct_tpu_torch.models.registry import get_model
    from dct_tpu_torch.ops import flash_attention as fa
    from dct_tpu_torch.parallel.mesh import make_mesh, set_mesh
    from dct_tpu_torch.train import state as port_state
    from dct_tpu_torch.train import steps

    device = torch.device(f"cuda:{args.rank}")
    torch.cuda.set_device(device)
    mesh = None
    if args.seq > 1:
        dist.init_process_group(
            "nccl", init_method=f"tcp://127.0.0.1:{args.port}",
            world_size=args.seq, rank=args.rank, device_id=device)
        mesh = make_mesh(MeshConfig(data=1, seq=args.seq))
        set_mesh(mesh)
    torch.manual_seed(0)
    model = get_model(ModelConfig(name=args.family, **WIDTH),
                      input_dim=F_IN, device=device, mesh=mesh,
                      compute_dtype=torch.bfloat16 if args.bf16 else None)
    st = port_state.create_train_state(model, input_dim=F_IN, lr=0.01,
                                       seed=0, optimizer="sgd",
                                       momentum=0.9)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH, WIDTH["seq_len"], F_IN)).astype(
        np.float32)
    causal = args.family == "weather_transformer_causal"
    y = rng.integers(0, 2, (BATCH, WIDTH["seq_len"]) if causal
                     else (BATCH,)).astype(np.int32)
    w = np.ones(BATCH, np.float32)
    step = steps.make_train_step()

    def one():
        steps_state, _ = step(st, x, y, w)
        return steps_state

    for _ in range(WARMUP):
        one()
    torch.cuda.synchronize()
    host = []
    for _ in range(TIMED):
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t0))
    fa.reset_launches()
    one()
    launches = fa.launch_counts()
    trace = trace_step(one)
    trace.pop("kernel_names_by_kind", None)
    out = {"rank": args.rank, "step_ms_median": statistics.median(host),
           "step_ms": host, "launches_per_step": launches,
           "max_memory_allocated": torch.cuda.max_memory_allocated(device),
           "trace": trace}
    if mesh is not None:
        gathered = [None] * args.seq
        dist.all_gather_object(gathered, out)
        dist.destroy_process_group()
        return {"ranks": gathered}
    return {"ranks": [out]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", type=int, default=4)
    ap.add_argument("--engine", choices=("ring", "a2a"), default="ring")
    ap.add_argument("--striped", choices=("auto", "on", "off"),
                    default="auto")
    ap.add_argument("--family", default="weather_transformer_causal",
                    choices=("weather_transformer",
                             "weather_transformer_causal"))
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args()
    import torch

    if args.rank is not None:
        result = rank_main(args)
        if args.rank == 0:
            print("[sp_trace] " + json.dumps(dict(
                seq=args.seq, engine=args.engine, striped=args.striped,
                family=args.family, bf16=args.bf16, **result)), flush=True)
        return 0
    if torch.cuda.device_count() < args.seq:
        print(f"sp_step_trace: needs {args.seq} CUDA cards, have "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, DCT_SP_ENGINE=args.engine,
               DCT_RING_STRIPED=args.striped)
    cmd = [sys.executable, os.path.abspath(__file__), "--seq",
           str(args.seq), "--engine", args.engine, "--striped", args.striped,
           "--family", args.family, "--port", str(port)]
    if args.bf16:
        cmd.append("--bf16")
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env)
             for r in range(args.seq)]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    from chip_smoke import card_line

    print(card_line(), flush=True)
    return max(codes)


if __name__ == "__main__":
    sys.exit(main())
