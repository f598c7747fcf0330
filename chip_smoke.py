"""Smoke run of the PyTorch port on one NVIDIA H100: kernels, then serving.

    python3 chip_smoke.py

Needs one CUDA card of compute capability 9.0 and ``nvcc``; exits non-zero
without them, and without the ``dct_tpu_torch`` package beside this file.

1. The card: name and power limit (``nvidia-smi``), torch and CUDA versions.
2. Builds every kernel of the serving path from the sources in the checkout
   (today: ``dct_tpu_torch/ops/csrc/flash_fwd.cu``) and prints the build time
   and ptxas's register and spill report.
3. Holds each kernel against its plain PyTorch version on the card at the
   serving shape (B=32 windows, H=8, T=1024, D=64), f32 and bf16, causal and
   not, with the log-sum-exp; tolerances f32 1e-4 (summation order only),
   bf16 2e-2. Times the kernel, the plain version and
   ``F.scaled_dot_product_attention`` (the library yardstick; the port never
   calls it): median of 20 runs after warm-up, each between
   ``torch.cuda.synchronize()`` calls. ``bound_ms`` is the larger of the
   compulsory bytes over 3.35 TB/s and the operations over the datasheet
   peak for the input type (67 TFLOP/s f32 without tensor cores, 989 TFLOP/s
   bf16 dense).
4. Serves three random packages (seed 0) of the repo's full-width transformer
   (d_model 512, 8 heads, 4 layers, d_ff 2048, seq_len 1024, 5 features):
   ``weather_transformer`` and ``weather_transformer_causal`` (horizon 1) in
   f32, and the bf16 twin of the first (``::bf16`` weights, served at bf16
   compute), through the port's HTTP server on ``cuda``. Posts 1, 3, 8 and 32
   windows to each with the kernels' launch counts set to 0 just before and
   read just after; checks that every answer is finite and sums to 1, that
   two windows match the port's f32 CPU path (plain attention) on the same
   weights within 1e-4 (f32) or 2e-2 (bf16), and that the flash kernel ran
   once per layer of every padded forward.

Prints the ``kernels`` JSON line, then the card line, then, last,
``{"ok": true, "device": {...}}``. Any failure raises.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # datasheet
PEAK_BYTES = 3.35e12  # datasheet HBM3 bandwidth
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SERVE_CFG = dict(seq_len=1024, d_model=512, n_heads=8, n_layers=4, d_ff=2048)
REQUEST_SIZES = (1, 3, 8, 32)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``runs``, each between
    synchronizes, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_bound(b, h, g, t, d, dtype, causal, window, lse):
    """Least time for the work: (ms, 'bytes' | 'operations')."""
    if causal:
        pos = np.arange(t)
        pairs = int(np.minimum(pos + 1, window or t).sum())
    else:
        pairs = t * t
    flops = 4.0 * b * h * d * pairs
    itemsize = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * h * t + 2 * b * g * t) * d * itemsize
    if lse:
        nbytes += b * h * t * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, (
        "operations" if t_ops >= t_bytes else "bytes"
    )


def check_flash_kernel(fa) -> list[dict]:
    """flash_fwd against its plain version at the serving shape."""
    b, h, g, t, d = 32, 8, 8, 1024, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    variants = []
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(b, h, t, d, generator=gen, device="cuda").to(dtype)
        k = torch.randn(b, g, t, d, generator=gen, device="cuda").to(dtype)
        v = torch.randn(b, g, t, d, generator=gen, device="cuda").to(dtype)
        for causal in (False, True):
            o, lse = fa.flash_attention(q, k, v, causal=causal,
                                        return_lse=True)
            torch.cuda.synchronize()
            po, plse = fa.flash_attention_plain(q, k, v, causal=causal)
            err = (o.float() - po.float()).abs().max().item()
            lse_err = (lse - plse).abs().max().item()
            if not (err <= TOL[dtype] and lse_err <= 1e-4):
                raise AssertionError(
                    f"flash_fwd {dtype} causal={causal}: max |o - plain| "
                    f"{err} (tol {TOL[dtype]}), max |lse - plain| {lse_err}"
                )
            bound_ms, bound_by = attention_bound(b, h, g, t, d, dtype, causal,
                                                 None, lse=True)
            variants.append({
                "dtype": str(dtype).replace("torch.", ""), "causal": causal,
                "shape": [b, h, t, d], "max_abs_err": err,
                "lse_max_abs_err": lse_err, "tol": TOL[dtype],
                "ms": time_ms(lambda: fa.flash_attention(
                    q, k, v, causal=causal, return_lse=True)),
                "plain_ms": time_ms(lambda: fa.flash_attention_plain(
                    q, k, v, causal=causal)),
                "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal)),
                "bound_ms": bound_ms, "bound_by": bound_by,
            })
            print(f"[smoke] flash_fwd {variants[-1]}", flush=True)
    return variants


def post(port: int, windows: np.ndarray) -> tuple[np.ndarray, float]:
    body = json.dumps({"data": windows.tolist()}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/score", data=body)
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        payload = json.loads(r.read())
    return np.asarray(payload["probabilities"]), (time.perf_counter() - t0) * 1e3


def serve_package(family: str, pkg_dir: str, fa, quant=None) -> dict:
    """Drive one package (f32, or its ``quant="bf16"`` twin) through the
    port's HTTP server on the card."""
    from dct_tpu_torch.config import ServingConfig
    from dct_tpu_torch.serving.batching import TorchScorer
    from dct_tpu_torch.serving.package import (
        init_package_weights,
        load_package,
        write_package,
    )
    from dct_tpu_torch.serving.quant import quantize_weights
    from dct_tpu_torch.serving.server import make_server

    meta = dict(model=family, name=family, input_dim=5, num_classes=2,
                horizon=1, **SERVE_CFG)
    weights = init_package_weights(meta, seed=0)
    if quant is not None:
        weights, meta = quantize_weights(weights, meta, dtype=quant)
    write_package(pkg_dir, weights, meta)
    server = make_server(pkg_dir, serving=ServingConfig(workers=2))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    rng = np.random.default_rng(1)
    answers, latencies = {}, {}
    try:
        port = server.server_address[1]
        fa.reset_launches()
        forwards0 = server.scorer.forwards
        for n in REQUEST_SIZES:
            x = rng.standard_normal((n, SERVE_CFG["seq_len"], 5)).astype(
                np.float32
            )
            probs, ms = post(port, x)
            answers[n] = (x, probs)
            latencies[n] = ms
        launches = fa.launches
        forwards = server.scorer.forwards - forwards0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
    dtype = torch.bfloat16 if quant == "bf16" else torch.float32
    if server.scorer.dtype != dtype:
        raise AssertionError(f"{family} {quant}: served at "
                             f"{server.scorer.dtype}, not {dtype}")
    if launches != SERVE_CFG["n_layers"] * forwards or forwards < 1:
        raise AssertionError(
            f"{family}: {launches} flash launches for {forwards} forwards of "
            f"{SERVE_CFG['n_layers']} layers"
        )
    for n, (x, probs) in answers.items():
        if probs.shape != (n, 2) or not np.isfinite(probs).all():
            raise AssertionError(f"{family}: bad answer {probs.shape} for {n}")
        if np.abs(probs.sum(axis=-1) - 1).max() > 1e-5:
            raise AssertionError(f"{family}: probabilities do not sum to 1")
    # Two windows against the port's f32 CPU path (plain attention) on the
    # package's own (for bf16: widened) weights.
    weights, meta = load_package(pkg_dir)
    meta.pop("quant", None)
    cpu = TorchScorer(weights, meta, "cpu")
    x, probs = answers[32]
    pick = [0, 31]
    ref = cpu(x[pick])
    err = float(np.abs(ref - probs[pick]).max())
    if err > TOL[dtype]:
        raise AssertionError(
            f"{family} {quant}: cuda vs cpu probabilities differ {err} "
            f"(tol {TOL[dtype]})"
        )
    result = {"family": family, "dtype": str(dtype).replace("torch.", ""),
              "forwards": forwards, "launches": launches,
              "cuda_vs_cpu_max_abs_err": err,
              "latency_ms": {str(n): latencies[n] for n in REQUEST_SIZES}}
    print(f"[smoke] serve {result}", flush=True)
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from dct_tpu_torch.device import resolve_device
    from dct_tpu_torch.ops import build
    from dct_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    device = resolve_device()  # raises unless capability 9.0
    cap = torch.cuda.get_device_capability(device)
    print(f"[smoke] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, capability {cap[0]}.{cap[1]}", flush=True)

    t0 = time.perf_counter()
    build.load_kernel("flash_fwd")
    info = build.build_info["flash_fwd"]
    print(f"[smoke] {'built' if info['built'] else 'reused'} flash_fwd in "
          f"{time.perf_counter() - t0:.1f} s: {info['path']}", flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"[smoke]   ptxas: {line.strip()}", flush=True)

    variants = check_flash_kernel(fa)

    pkg_root = os.path.join(HERE, "build", "chip_smoke_packages")
    served = [
        serve_package(family, os.path.join(pkg_root, f"{family}-{quant}"),
                      fa, quant)
        for family, quant in (("weather_transformer", None),
                              ("weather_transformer_causal", None),
                              ("weather_transformer", "bf16"))
    ]
    launches = sum(s["launches"] for s in served)
    forwards = sum(s["forwards"] for s in served)

    head = variants[0]  # f32, not causal: the first package's shape
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "dct_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "dct_tpu/ops/pallas_attention.py:81 (_flash_fwd_kernel; "
                    "pallas_call at :260)",
        "launches": launches,
        "max_abs_err": head["max_abs_err"], "ms": head["ms"],
        "kernel_ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "launches_per_forward": launches / forwards,
        "variants": variants,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
