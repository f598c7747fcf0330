"""``train_job`` for ``weather_moe`` at W processes against W=1 on the same
rows: the data-parallel MoE world is the 1-process program.

    python scripts/moe_dp_compare.py [--world 2]   # rank r on cuda:r, NCCL

The einsum engine routes over the global batch (each rank all-gathers the
choice counts of every MoE layer), so a W-rank world and a 1-process run of
the same global batch train the same model up to the order of the
gradient sums. The script writes seeded synthetic rows through the port's
ETL, runs the W ranks, then one process on ``cuda:0``, each for
``--epochs`` at f32 compute with SGD, and prints one JSON line: each run's
val_loss, val_acc, samples/s, wall and flash launches, the largest
difference between the two checkpoints' logits and probabilities on 16
seeded windows, and whether the two runs agree within the bounds
(``TOL_VAL_LOSS`` on the val_loss, ``TOL_LOGITS`` on the logits; exit 1
when they do not); then the cards' names and power limits. It needs W cards
(the same comparison on gloo is
``tests/test_torch_moe_dp.py::test_train_job_at_two_processes_equals_one_process``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# bench.py:998-1003's MoE leg.
WIDTH = dict(seq_len=512, d_model=512, n_heads=8, n_layers=2, d_ff=1024,
             n_experts=32)
# W ranks and one process agree when they differ by no more than these:
# the order of gradient sums alone moves SGD by lr x rounding a step; a
# routing fault parts the drops from the first step.
TOL_VAL_LOSS = 1e-3
TOL_LOGITS = 1e-2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(args, models: str, processed: str, batch: int, **extra) -> dict:
    width = WIDTH
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DCT_") and k not in (
               "WORLD_SIZE", "NODE_RANK", "MASTER_ADDR", "MASTER_PORT")}
    # f32 and SGD: bf16 rounding of sums taken in another order, and
    # Adam's first update (about lr * sign(g), so a rounding-level
    # gradient steps by lr either way), would part the two runs for
    # reasons other than the routing this compares.
    env.update(
        PYTHONPATH=HERE, DCT_MODEL="weather_moe", DCT_MOE_DISPATCH="einsum",
        DCT_BF16_COMPUTE="0", DCT_OPTIMIZER="sgd", DCT_LR="0.05",
        DCT_EPOCHS=str(args.epochs),
        DCT_BATCH_SIZE=str(batch), DCT_PROCESSED_DIR=processed,
        DCT_MODELS_DIR=models,
        DCT_TRACKING_DIR=os.path.join(args.root, "mlruns"),
        DCT_SEQ_LEN=str(width["seq_len"]), DCT_D_MODEL=str(width["d_model"]),
        DCT_N_HEADS=str(width["n_heads"]),
        DCT_N_LAYERS=str(width["n_layers"]), DCT_D_FF=str(width["d_ff"]),
        DCT_N_EXPERTS=str(width["n_experts"]), **extra)
    return env


def _run(procs, timeout) -> list[dict]:
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(f"train_job exit {p.returncode}: "
                                   f"{err[-2000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    runs = []
    for out in outs:
        done = [x for x in out.splitlines() if "done: val_loss=" in x][-1]
        fields = dict(kv.split("=", 1) for kv in done.split("done: ")[1]
                      .split() if "=" in kv)
        launches = [json.loads(x[len("[train_job] launches "):])
                    for x in out.splitlines()
                    if x.startswith("[train_job] launches ")]
        runs.append({"val_loss": float(fields["val_loss"]),
                     "val_acc": float(fields["val_acc"]),
                     "samples_per_s": float(fields["samples/sec"]),
                     "launches": launches[-1] if launches else None})
    return runs


def _logits(ckpt: str, x: np.ndarray, device) -> np.ndarray:
    import torch

    from dct_tpu_torch.checkpoint.manager import load_checkpoint
    from dct_tpu_torch.convert import load_flax_weights
    from dct_tpu_torch.models.registry import config_from_meta, get_model
    from dct_tpu_torch.serving.score_gen import _serving_weights

    params, meta = load_checkpoint(ckpt)
    model = get_model(config_from_meta(meta), device=device)
    load_flax_weights(model, _serving_weights(params["params"],
                                              "weather_moe"))
    with torch.no_grad():
        return model(torch.from_numpy(x).to(device)).float().cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--rows", type=int, default=4000,
                    help="synthetic rows (4000: 2,790 train and 186 val "
                         "windows at T=512; val needs more than 3,072)")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batch", type=int, default=32,
                    help="global batch (each rank takes batch / world)")
    ap.add_argument("--root", default=os.path.join(HERE, "build",
                                                   "moe_dp_compare"))
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch

    from dct_tpu_torch.data.synthetic import generate_weather_csv
    from dct_tpu_torch.device import resolve_device
    from dct_tpu_torch.etl.preprocess import preprocess_csv_to_parquet

    args.device = resolve_device()  # cuda:0; raises without CUDA
    if torch.cuda.device_count() < args.world:
        print(f"moe_dp_compare: needs {args.world} cards, have "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    if args.batch % args.world:
        raise ValueError(f"--batch {args.batch} does not split over "
                         f"{args.world} ranks")
    shutil.rmtree(args.root, ignore_errors=True)
    os.makedirs(args.root)
    raw = os.path.join(args.root, "raw.csv")
    processed = os.path.join(args.root, "processed")
    generate_weather_csv(raw, rows=args.rows, seed=5)
    preprocess_csv_to_parquet(raw, processed)
    cmd = [sys.executable, "-m", "dct_tpu_torch.train_job"]
    port = _free_port()
    world_dirs = [os.path.join(args.root, f"w{args.world}_r{r}")
                  for r in range(args.world)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        cmd, env=_env(args, world_dirs[r], processed,
                      args.batch // args.world,
                      WORLD_SIZE=str(args.world), NODE_RANK=str(r),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
        cwd=args.root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(args.world)]
    world_runs = _run(procs, timeout=1800)
    world_wall = time.perf_counter() - t0
    one_dir = os.path.join(args.root, "w1")
    t0 = time.perf_counter()
    one_runs = _run([subprocess.Popen(
        cmd, env=_env(args, one_dir, processed, args.batch),
        cwd=args.root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)], timeout=1800)
    one_wall = time.perf_counter() - t0
    x = np.random.default_rng(9).standard_normal(
        (16, WIDTH["seq_len"], 5)).astype(np.float32)
    a = _logits(os.path.join(world_dirs[0], "last.ckpt"), x, args.device)
    b = _logits(os.path.join(one_dir, "last.ckpt"), x, args.device)
    pa = np.exp(a - a.max(-1, keepdims=True))
    pa /= pa.sum(-1, keepdims=True)
    pb = np.exp(b - b.max(-1, keepdims=True))
    pb /= pb.sum(-1, keepdims=True)
    out = {"world": args.world, "rows": args.rows, "epochs": args.epochs,
           "global_batch": args.batch,
           f"w{args.world}": dict(world_runs[0], wall_s=world_wall),
           "w1": dict(one_runs[0], wall_s=one_wall),
           "logits_max_abs_diff": float(np.abs(a - b).max()),
           "probs_max_abs_diff": float(np.abs(pa - pb).max()),
           "tol_val_loss": TOL_VAL_LOSS, "tol_logits": TOL_LOGITS}
    out["agree"] = bool(
        abs(world_runs[0]["val_loss"] - one_runs[0]["val_loss"])
        <= TOL_VAL_LOSS and out["logits_max_abs_diff"] <= TOL_LOGITS)
    print(json.dumps(out), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print("; ".join(card), flush=True)
    return 0 if out["agree"] else 1


if __name__ == "__main__":
    sys.exit(main())
