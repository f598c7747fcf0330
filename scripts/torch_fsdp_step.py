"""One train step of the port's transformer under data parallelism and
per-unit FSDP, timed and traced on a world of processes.

    python3 scripts/torch_fsdp_step.py [--base <dir of another checkout>]
        [--world 4] [--device cuda|cpu] [--out chiprun_out/fsdp_step.json]

Each run starts ``--world`` processes (rank r on ``cuda:r`` with NCCL, or
on the CPU with gloo), the data axis over all of them, and in each, for
every mode of ``--modes``, builds ``weather_transformer`` at the bench's
width (``bench.py:216-227``: d_model 512, 8 heads, 4 layers, d_ff 2048,
T=1024; ``--small`` for a CPU check) from seed 0, places its train state
(``dp``: replicated; ``fsdp``: ``DCT_SHARD_PARAMS`` under the family
tables, where at ``model=1`` only the leaves outside the tensor-parallel
units split; ``fsdp_rules``: the units replicated by ``DCT_SHARD_RULES``,
so every leaf whose leading dim divides splits), runs ``--warm`` steps of
(m)'s schedule (SGD lr 0.01, momentum 0.9, ``--batch`` windows a rank of
random rows from a seed), times ``--steps`` more (each ends on its loss
on the host), and traces one with ``torch.profiler``: the collectives a
step by name, the device's busy ms (the sum of its kernels' times) and
the host ops with the most self time, and each mode's last loss against
``dp``'s (the same steps on the same rows). With ``--base`` the runs go
base, head, head, base, each side's steps compared within the one call.
Prints one JSON line a run and the card's name and power limit; rank 0
writes every run to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = dict(seq_len=1024, d_model=512, n_heads=8, n_layers=4, d_ff=2048)
SMALL = dict(seq_len=256, d_model=64, n_heads=4, n_layers=2, d_ff=128)
REPLICATE_UNITS = "(qkv_proj|o_proj|ffn_in|ffn_out).*="
FEATURES = 5
COLLECTIVE = ("nccl", "gloo", "c10d", "all_gather", "reduce_scatter",
              "all_reduce", "allreduce", "allgather", "reduce_scatter")


def _device_us(e) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(e, name, None)
        if v is not None:
            return float(v)
    return 0.0


def worker(args) -> None:
    sys.path.insert(0, args.root)
    import numpy as np
    import torch
    import torch.distributed as dist

    from dct_tpu_torch.config import MeshConfig, ModelConfig
    from dct_tpu_torch.models.mlp import set_data_block
    from dct_tpu_torch.models.registry import get_model
    from dct_tpu_torch.parallel.mesh import make_mesh, set_mesh
    from dct_tpu_torch.train.state import create_train_state
    from dct_tpu_torch.train.steps import make_train_step

    rank, world = args.rank, args.world
    cuda = args.device == "cuda"
    dev = torch.device(f"cuda:{rank}" if cuda else "cpu")
    if cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://127.0.0.1:{args.port}",
                            world_size=world, rank=rank)
    mesh = make_mesh(MeshConfig(data=world))
    set_mesh(mesh)
    width = SMALL if args.small else WIDTH
    rng = np.random.default_rng(rank)
    x = rng.standard_normal((args.batch, width["seq_len"], FEATURES)).astype(
        np.float32)
    y = rng.integers(0, 2, (args.batch,)).astype(np.int32)
    w = np.ones((args.batch,), np.float32)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    runs = []
    for mode in args.modes.split(","):
        os.environ.pop("DCT_SHARD_RULES", None)
        if mode == "fsdp_rules":
            os.environ["DCT_SHARD_RULES"] = REPLICATE_UNITS
        model = get_model(ModelConfig(name="weather_transformer", **width),
                          input_dim=FEATURES, device=dev, mesh=mesh)
        state = create_train_state(
            model, input_dim=FEATURES, lr=0.01, seed=0, optimizer="sgd",
            momentum=0.9, mesh=mesh, shard_params=mode != "dp",
            family="weather_transformer")
        set_data_block(model, mesh.data_size, mesh.data_index)
        step = make_train_step()
        for _ in range(args.warm):
            state, m = step(state, x, y, w)
            float(m["train_loss"])
        sync()
        times = []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            state, m = step(state, x, y, w)
            float(m["train_loss"])
            times.append((time.perf_counter() - t0) * 1e3)
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        sync()
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            state, m = step(state, x, y, w)
            float(m["train_loss"])
            sync()
        traced_ms = (time.perf_counter() - t0) * 1e3
        ka = prof.key_averages()
        collectives = {e.key: e.count for e in ka
                       if any(c in e.key.lower() for c in COLLECTIVE)}
        busy_ms = sum(_device_us(e) for e in ka
                      if e.device_type.name == "CUDA") / 1e3 if cuda else None
        top = sorted(ka, key=lambda e: -e.self_cpu_time_total)[:12]
        runs.append({
            "mode": mode, "step_ms_median": statistics.median(times),
            "step_ms": times, "traced_step_ms": traced_ms,
            "device_busy_ms": busy_ms,
            "idle_share": None if busy_ms is None
            else max(0.0, 1 - busy_ms / traced_ms),
            "collectives": collectives,
            "host_top": [(e.key, e.count, e.self_cpu_time_total / 1e3)
                         for e in top],
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in state.grad_targets()),
            "loss": float(m["train_loss"])})
        del state, model
        if cuda:
            torch.cuda.empty_cache()
    if rank == 0:
        with open(args.result, "w") as f:
            json.dump(runs, f)
    dist.barrier()
    dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(checkout: str, label: str, args, k: int) -> list:
    port, result = _free_port(), os.path.join(
        ROOT, "build", "fsdp_step", f"{label}.{k}.json")
    os.makedirs(os.path.dirname(result), exist_ok=True)
    env = dict(os.environ, PYTHONPATH=checkout, OMP_NUM_THREADS="1")
    base = [sys.executable, os.path.abspath(__file__), "--worker",
            "--root", checkout, "--world", str(args.world), "--port",
            str(port), "--device", args.device, "--modes", args.modes,
            "--steps", str(args.steps), "--warm", str(args.warm),
            "--batch", str(args.batch), "--result", result]
    if args.small:
        base.append("--small")
    procs = [subprocess.Popen(base + ["--rank", str(r)], env=env,
                              cwd=checkout) for r in range(args.world)]
    try:
        codes = [p.wait(timeout=args.timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        raise SystemExit(f"{label}: ranks exited {codes}")
    with open(result) as f:
        runs = json.load(f)
    dp = {r["mode"]: r["loss"] for r in runs}.get("dp")
    for r in runs:
        r.update(side=label, round=k, loss_gap_vs_dp=None if dp is None
                 else abs(r["loss"] - dp))
        print(json.dumps({key: r[key] for key in (
            "side", "round", "mode", "step_ms_median", "traced_step_ms",
            "device_busy_ms", "idle_share", "collectives", "param_bytes",
            "loss", "loss_gap_vs_dp")}), flush=True)
    return runs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base")
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--modes", default="dp,fsdp,fsdp_rules")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--timeout", type=int, default=600)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "fsdp_step.json"))
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--result")
    args = ap.parse_args()
    if args.worker:
        worker(args)
        return 0
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available() or (
                torch.cuda.device_count() < args.world):
            print(f"needs {args.world} CUDA cards", file=sys.stderr)
            return 1
    order = [("head", ROOT)]
    if args.base:
        base = os.path.abspath(args.base)
        order = [("base", base), ("head", ROOT), ("head", ROOT),
                 ("base", base)]
    runs = [r for k, (label, checkout) in enumerate(order)
            for r in run(checkout, label, args, k)]
    card = "cpu"
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0]
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "runs": runs}, f, indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
