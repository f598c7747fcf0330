"""Smoke run of the PyTorch port on one NVIDIA H100: kernels, serving, training.

    python3 chip_smoke.py

Needs one CUDA card of compute capability 9.0 and ``nvcc``; exits non-zero
without them, and without the ``dct_tpu_torch`` package beside this file.

1. The card: name and power limit (``nvidia-smi``), torch and CUDA versions.
2. Builds every kernel of the serving and training paths from the sources in
   the checkout (``dct_tpu_torch/ops/csrc/flash_fwd.cu`` and ``flash_bwd.cu``,
   both including ``sm90.cuh``; one ``nvcc`` each, in parallel) and prints
   the build time and ptxas's registers, spills and warnings per kernel
   instance (raises if a tensor-core kernel spills or ptxas warns of it,
   as it does when it serializes the wgmmas). Counts the tensor-core
   instructions (``HGMMA``, ``HMMA``) of each tensor-core kernel's instances
   in ``cuobjdump -sass`` of the built libraries (``flash_fwd``,
   ``flash_bwd_dkdv`` and ``flash_bwd_dq``, bf16 and f32 in 3xTF32); raises
   if one has none at some head dim.
3. Holds each kernel against its plain PyTorch version on the card at the
   serving shape (B=32 windows, H=8, T=1024, D=64), f32 and bf16, causal and
   not, with the log-sum-exp; tolerances on o f32 1e-5 (3xTF32 products
   lose about 2^-22 of their size; a single TF32 pass would miss it), bf16
   2e-2, and 1e-4 on lse. Times the kernel, the plain version and
   ``F.scaled_dot_product_attention`` (the library yardstick; the port never
   calls it) with CUDA events: after warm-up, the median of 5 runs of 10
   calls launched back to back, per call (``time_ms``). ``bound_ms`` is the
   larger of the compulsory bytes over 3.35 TB/s and the operations over
   the datasheet's tensor-core peak for the input type: bf16 at 989
   TFLOP/s dense; f32 at f32 accuracy, which the tensor cores give as
   3xTF32 (three TF32 products per product at 495 TFLOP/s), so 3 x the
   operations over 495 TFLOP/s (``bound_basis`` says which).
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

5. Holds the two backward kernels (dK/dV and dQ) against
   ``flash_attention_bwd_plain`` at the training shape (B=32, H=G=8, T=1024,
   D=64), f32 and bf16, causal and not, on o and lse from the forward kernel
   and a seeded dO. Error: max|kernel - plain| / max|plain| per output,
   tolerance 1e-4 (f32) and 1e-2 (bf16: about one bf16 step of the largest
   gradient; dropping a 64-row tile from a sum errs by some 1/16 of it).
   The absolute errors are printed beside. Times each kernel
   (``time_ms``), the plain version, and the backward of
   ``F.scaled_dot_product_attention`` alone (``library_ms``; it computes
   dq, dk and dv, so it stands on both rows and is compared with the sum of
   the two kernels). ``bound_ms``: compulsory bytes over 3.35 TB/s against
   8*D (dK/dV) or 6*D (dQ) flops per unmasked (q, k) pair over the peak
   (as in 3.).
6. Trains the same full-width configuration on ``cuda`` through the port's
   entry points (``make_windows``, ``contiguous_split``, ``BatchLoader`` at
   batch 32 over seeded AR(1) rows; ``create_train_state`` with adam, lr
   1e-3, seed 0; the step functions):
   (a) one train body with dropout 0, kernels against an injected plain
       attention (plain forward and backward) from identical parameters:
       loss and every gradient within 1e-4 (f32) or 2e-2 (bf16 compute) of
       that gradient's max;
   (b) 8 steps of ``make_epoch_train_eval_step`` with the default dropout
       0.2 for ``weather_transformer`` in bf16 compute (the trainer's
       default) and f32 and ``weather_transformer_causal`` (horizon 1) in
       f32 and bf16, with the launch counts set to 0 just before and read
       just after (4 forward launches per train step and per eval batch, 4
       dK/dV and 4 dQ per train step); every loss and eval sum finite;
       step time (median of 5 timed ``make_train_step`` calls), samples/s
       and tokens/s;
   (c) 8 steps on one fixed batch (bf16 compute, dropout 0) for both
       families at each lr of ``OVERFIT_LRS``, printing every loss; the
       check: ``weather_transformer_causal`` at ``OVERFIT_LR`` ends below
       ``OVERFIT_RATIO`` of its first loss. At lr 1e-3 Adam's first,
       near-sign update overshoots at this width, and the pooled family
       does not overfit 32 window labels in 8 steps at any of these lrs;
   (d) one step with ``remat=True``: 8 forward launches, gradients equal to
       the step without remat within (a)'s tolerance;
   (e) one step of each (b) configuration under ``torch.profiler``: the
       device time of every kernel, summed by kind (the three flash kernels,
       GEMMs, the optimizer's foreach passes, the rest), the distinct kernel
       names of each kind (which kernel of a dtype ran), and the device's
       idle share between the step's first and last kernel.

Prints the ``kernels`` JSON line (each kernel with its f32 numbers at the
top level, as earlier slices did, a ``bf16`` summary beside them, and its
``tensor_core_instructions`` by dtype), then the card line, then, last,
``{"ok": true, "device": {...}}``. Any failure raises.
"""

from __future__ import annotations

import json
import os
import re
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
# Datasheet peaks of the H100 SXM (dense): bf16 and TF32 on the tensor
# cores, HBM3 bandwidth. f32 accuracy on the tensor cores takes three TF32
# products per product (3xTF32), so an f32 bound counts 3 x its operations
# at the TF32 rate (165 TFLOP/s in effect, against 67 on the FMA units).
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
FWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}  # on o; lse 1e-4
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}  # of max|plain|
SERVE_CFG = dict(seq_len=1024, d_model=512, n_heads=8, n_layers=4, d_ff=2048)
REQUEST_SIZES = (1, 3, 8, 32)
DEVICE = "cuda"
BATCH = 32  # windows per train step (bench.py's scaled batch)
TRAIN_STEPS = 8
OVERFIT_LRS = (1e-3, 1e-4, 3e-5, 1e-5)
OVERFIT_LR = 3e-5
OVERFIT_RATIO = 0.7  # measured 0.470 on an H100
BWD_FLOPS_PER_PAIR = {"flash_bwd_dkdv": 8, "flash_bwd_dq": 6}  # x D


# The tensor-core kernels by (kernel, dtype): (library, name in the SASS).
# Each must hold HGMMA at every head dim.
TENSOR_CORE_SASS = {
    ("flash_fwd", "bf16"): ("flash_fwd", "flash_fwd_kernel_wgmma"),
    ("flash_fwd", "f32"): ("flash_fwd", "flash_fwd_kernel_tf32"),
    ("flash_bwd_dkdv", "bf16"): ("flash_bwd", "flash_bwd_dkdv_kernel_wgmma"),
    ("flash_bwd_dkdv", "f32"): ("flash_bwd", "flash_bwd_dkdv_kernel_tf32"),
    ("flash_bwd_dq", "bf16"): ("flash_bwd", "flash_bwd_dq_kernel_wgmma"),
    ("flash_bwd_dq", "f32"): ("flash_bwd", "flash_bwd_dq_kernel_tf32"),
}


def ptxas_report(log: str) -> dict[str, dict]:
    """Registers, spill bytes and any performance warning (such as wgmma
    serialization) per kernel instance from nvcc's ``-Xptxas -v``
    output."""
    report, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)", line)
        if m:
            fn = m.group(1)
            report.setdefault(fn, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            report[fn]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            report[fn]["registers"] = int(m.group(1))
        m = re.search(r"Potential Performance Loss: (.*) in the function "
                      r"'([\w$]+)'", line)
        if m:
            report.setdefault(m.group(2), {})["ptxas_warning"] = m.group(1)
    return report


def tensor_core_instructions(build) -> dict[str, dict]:
    """Per kernel and dtype: HGMMA and HMMA counts of each tensor-core
    instance (by head dim) in ``cuobjdump -sass`` of the built library."""
    sass = {lib: build.sass(lib) for lib in ("flash_fwd", "flash_bwd")}
    counts = {}
    for (name, dtype), (lib, tag) in TENSOR_CORE_SASS.items():
        by_dim, cur = {}, None
        for line in sass[lib].splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                cur = None
                if tag in m.group(1):
                    cur = int(re.search(r"Li(\d+)EE", m.group(1)).group(1))
                    by_dim[cur] = {"HGMMA": 0, "HMMA": 0}
            elif cur is not None:
                for op in ("HGMMA", "HMMA"):
                    if re.search(rf"\b{op}\.", line):
                        by_dim[cur][op] += 1
        if sorted(by_dim) != [16, 32, 64, 128]:
            raise AssertionError(f"{name} {dtype}: instances "
                                 f"{sorted(by_dim)} in the SASS, want head "
                                 "dims 16-128")
        if not all(c["HGMMA"] > 0 for c in by_dim.values()):
            raise AssertionError(f"{name} {dtype}: an instance without "
                                 f"HGMMA: {by_dim}")
        counts.setdefault(name, {})[dtype] = {
            "kernel": tag, "HGMMA": by_dim[64]["HGMMA"],
            "HMMA": by_dim[64]["HMMA"], "head_dim": 64, "by_head_dim": by_dim}
    return counts


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, runs: int = 5, per_run: int = 10, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: the median over ``runs`` of the
    CUDA-event time of ``per_run`` calls launched back to back, over
    ``per_run``. Back to back, the device runs one call while the host
    prepares the next, so the host's part of a call (the wrapper's checks,
    allocations and ctypes call) is not counted, as it is when two events
    bracket a single call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_run):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per_run)
    return statistics.median(times)


def _pairs(t, causal, window):
    """Unmasked (q, k) pairs of one head."""
    if not causal:
        return t * t
    return int(np.minimum(np.arange(t) + 1, window or t).sum())


def _bound(flops, nbytes, dtype):
    """(ms, 'bytes' | 'operations', basis): the basis names the peak, as
    'operations (3xTF32)' for f32 and 'operations (bf16)', or 'bytes'."""
    if dtype == torch.float32:
        t_ops, peak = 3 * flops / PEAK_TF32, "3xTF32"
    else:
        t_ops, peak = flops / PEAK_BF16, "bf16"
    t_bytes = nbytes / PEAK_BYTES
    by = "operations" if t_ops >= t_bytes else "bytes"
    return (max(t_ops, t_bytes) * 1e3, by,
            f"operations ({peak})" if by == "operations" else "bytes")


def attention_bound(b, h, g, t, d, dtype, causal, window, lse):
    """Least time for the work: ``_bound``'s (ms, by, basis)."""
    flops = 4.0 * b * h * d * _pairs(t, causal, window)
    itemsize = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * h * t + 2 * b * g * t) * d * itemsize
    if lse:
        nbytes += b * h * t * 4
    return _bound(flops, nbytes, dtype)


def bwd_bound(kernel, b, h, g, t, d, dtype, causal, window):
    """Least time of a backward kernel: it reads q, o, dO, k, v and the f32
    lse once and writes dk and dv (kernel 2) or dq (kernel 3) once."""
    flops = BWD_FLOPS_PER_PAIR[kernel] * d * b * h * _pairs(t, causal, window)
    itemsize = torch.tensor([], dtype=dtype).element_size()
    out = 2 * b * g * t if kernel == "flash_bwd_dkdv" else b * h * t
    nbytes = (3 * b * h * t + 2 * b * g * t + out) * d * itemsize + b * h * t * 4
    return _bound(flops, nbytes, dtype)


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
            if not (err <= FWD_TOL[dtype] and lse_err <= 1e-4):
                raise AssertionError(
                    f"flash_fwd {dtype} causal={causal}: max |o - plain| "
                    f"{err} (tol {FWD_TOL[dtype]}), max |lse - plain| "
                    f"{lse_err} (tol 1e-4)"
                )
            bound_ms, bound_by, basis = attention_bound(
                b, h, g, t, d, dtype, causal, None, lse=True)
            variants.append({
                "dtype": str(dtype).replace("torch.", ""), "causal": causal,
                "shape": [b, h, t, d], "max_abs_err": err,
                "lse_max_abs_err": lse_err, "tol": FWD_TOL[dtype],
                "ms": time_ms(lambda: fa.flash_attention(
                    q, k, v, causal=causal, return_lse=True)),
                "plain_ms": time_ms(lambda: fa.flash_attention_plain(
                    q, k, v, causal=causal)),
                "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal)),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_basis": basis,
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


def abs_rel_err(got, ref) -> tuple[float, float]:
    """(max|got - ref|, that over max|ref|)."""
    ref = ref.float()
    err = (got.float() - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-30)


def check_bwd_kernels(fa) -> dict[str, list[dict]]:
    """flash_bwd_dkdv and flash_bwd_dq against flash_attention_bwd_plain at
    the training shape."""
    b, h, g, t, d = BATCH, 8, 8, 1024, 64
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {"flash_bwd_dkdv": [], "flash_bwd_dq": []}
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(b, h, t, d, generator=gen, device="cuda").to(dtype)
        k = torch.randn(b, g, t, d, generator=gen, device="cuda").to(dtype)
        v = torch.randn(b, g, t, d, generator=gen, device="cuda").to(dtype)
        do = torch.randn(b, h, t, d, generator=gen, device="cuda").to(dtype)
        for causal in (False, True):
            o, lse = fa.flash_attention(q, k, v, causal=causal,
                                        return_lse=True)
            args = (q, k, v, o, lse, do)
            dk, dv = fa.flash_bwd_dkdv(*args, causal=causal)
            dq = fa.flash_bwd_dq(*args, causal=causal)
            torch.cuda.synchronize()
            pdq, pdk, pdv = fa.flash_attention_bwd_plain(*args, causal=causal)
            both = {"dq": abs_rel_err(dq, pdq), "dk": abs_rel_err(dk, pdk),
                    "dv": abs_rel_err(dv, pdv)}
            errs = {n: rel for n, (_, rel) in both.items()}
            abs_errs = {n: err for n, (err, _) in both.items()}
            bad = {n: e for n, e in errs.items() if not e <= BWD_TOL[dtype]}
            if bad:
                raise AssertionError(
                    f"flash backward {dtype} causal={causal}: relative "
                    f"errors {bad} above {BWD_TOL[dtype]}"
                )
            plain_ms = time_ms(lambda: fa.flash_attention_bwd_plain(
                *args, causal=causal), runs=3, per_run=2, warmup=1)
            qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
            o_sdpa = F.scaled_dot_product_attention(qg, kg, vg,
                                                    is_causal=causal)
            library_ms = time_ms(lambda: torch.autograd.grad(
                o_sdpa, (qg, kg, vg), do, retain_graph=True))
            del o_sdpa
            timed = {
                "flash_bwd_dkdv": (time_ms(lambda: fa.flash_bwd_dkdv(
                    *args, causal=causal)), ("dk", "dv")),
                "flash_bwd_dq": (time_ms(lambda: fa.flash_bwd_dq(
                    *args, causal=causal)), ("dq",)),
            }
            kernels_ms = sum(ms for ms, _ in timed.values())
            for name, (ms, outs) in timed.items():
                bound_ms, bound_by, basis = bwd_bound(name, b, h, g, t, d,
                                                      dtype, causal, None)
                out[name].append({
                    "dtype": str(dtype).replace("torch.", ""),
                    "causal": causal, "shape": [b, h, t, d],
                    "max_abs_err": max(abs_errs[n] for n in outs),
                    "max_rel_err": max(errs[n] for n in outs),
                    "errors": errs, "abs_errors": abs_errs,
                    "tol": BWD_TOL[dtype],
                    "ms": ms, "plain_ms": plain_ms,
                    "library_ms": library_ms,
                    "library_covers": "dq+dk+dv",
                    "kernels_sum_ms": kernels_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "bound_basis": basis,
                })
                print(f"[smoke] {name} {out[name][-1]}", flush=True)
    return out


class PlainAttention(torch.autograd.Function):
    """The flash path's plain versions, forward and backward, as an
    attention function for (a): the yardstick the kernels are held to."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        from dct_tpu_torch.ops import flash_attention as fa

        o, lse = fa.flash_attention_plain(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        from dct_tpu_torch.ops import flash_attention as fa

        q, k, v, o, lse = ctx.saved_tensors
        grads = fa.flash_attention_bwd_plain(q, k, v, o, lse, do.contiguous(),
                                             causal=ctx.causal)
        return (*grads, None)


def train_data(family: str):
    """Seeded AR(1) rows (5 features; the label is the sign of the next
    row's first feature, which the window's last rows predict) through the
    port's windows, split and loader: ``TRAIN_STEPS`` train batches and
    the validation batches, as ``[S, B, ...]`` stacks."""
    from dct_tpu_torch.data.dataset import WeatherArrays
    from dct_tpu_torch.data.pipeline import BatchLoader, contiguous_split
    from dct_tpu_torch.data.windows import make_windows
    from dct_tpu_torch.models.registry import is_causal_model

    seq = SERVE_CFG["seq_len"]
    causal = is_causal_model(family)
    # 132 train batches, a gap of seq_len, then one batch of val windows.
    n_windows = int((seq + BATCH) / 0.2)
    rng = np.random.default_rng(0)
    rows = np.zeros((n_windows + seq, 5), np.float32)
    noise = rng.standard_normal(rows.shape).astype(np.float32)
    for i in range(1, len(rows)):
        rows[i] = 0.9 * rows[i - 1] + 0.44 * noise[i]
    labels = (rows[:, 0] > 0).astype(np.int32)
    data = make_windows(
        WeatherArrays(rows, labels, [f"f{i}" for i in range(5)]), seq,
        per_position_labels=causal,
    )
    train_idx, val_idx = contiguous_split(len(data), val_fraction=0.2,
                                          gap=seq)
    train = BatchLoader(data, train_idx, global_batch=BATCH, shuffle=True,
                        seed=0).epoch_stacked(0)
    val = BatchLoader(data, val_idx, global_batch=BATCH,
                      shuffle=False).epoch_stacked(0)
    return [a[:TRAIN_STEPS] for a in train], val


def train_state(family, compute_dtype, *, dropout=0.2, remat=False,
                lr=1e-3):
    from dct_tpu_torch.config import ModelConfig
    from dct_tpu_torch.models.registry import get_model
    from dct_tpu_torch.train.state import create_train_state

    cfg = ModelConfig(name=family, dropout=dropout, remat=remat, horizon=1,
                      **SERVE_CFG)
    model = get_model(cfg, input_dim=5, device=DEVICE,
                      compute_dtype=compute_dtype)
    return create_train_state(model, input_dim=5, lr=lr, seed=0,
                              example_shape=(1, SERVE_CFG["seq_len"], 5))


def grads_close(ga, gb, tol) -> float:
    """Largest gradient error relative to that gradient's max."""
    worst = 0.0
    for a, b in zip(ga, gb):
        scale = b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item() / max(scale, 1e-30)
        worst = max(worst, err)
    if not worst <= tol:
        raise AssertionError(f"gradients differ by {worst} (tol {tol})")
    return worst


def _kernel_kind(name: str) -> str:
    low = name.lower()
    for kind in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
        if kind + "_kernel" in low:
            return kind
    # cuBLAS names its Hopper GEMMs nvjet_*, its older ones *gemm*.
    if any(tag in low for tag in ("gemm", "cutlass", "xmma", "nvjet")):
        return "gemm"
    if "multi_tensor_apply" in low:
        return "optimizer_foreach"
    if "memcpy" in low or "memset" in low:
        return "memcpy_memset"
    return "other"


def trace_step(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: device ms per kernel
    kind, the share of each in the device's busy time, the busiest kernels,
    the distinct kernel names of each kind, and the idle share between the
    first kernel's start and the last one's end. ``{"device_events": 0}``
    when the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events() if e.device_type == DeviceType.CUDA
    )
    if not spans:
        return {"device_events": 0}
    kinds, names, by_kind = {}, {}, {}
    busy, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    for start, end, name in spans:
        kind = _kernel_kind(name)
        kinds[kind] = kinds.get(kind, 0.0) + (end - start) / 1e3
        names[name] = names.get(name, 0.0) + (end - start) / 1e3
        by_kind.setdefault(kind, set()).add(name[:90])
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy = (busy + cur_end - cur_start) / 1e3
    span = (max(e for _, e, _ in spans) - spans[0][0]) / 1e3
    top = sorted(names.items(), key=lambda kv: -kv[1])[:10]
    return {"device_events": len(spans), "span_ms": span, "busy_ms": busy,
            "idle_share": 1 - busy / span if span > 0 else 0.0,
            "ms_by_kind": kinds,
            "share_by_kind": {k: v / busy for k, v in kinds.items()},
            "top_kernels_ms": [[n[:90], ms] for n, ms in top],
            "kernel_names_by_kind": {k: sorted(v)
                                     for k, v in by_kind.items()}}


def train_phase(fa) -> dict:
    """(a)-(e) of the module docstring; returns what the kernels line and
    the log need."""
    from dct_tpu_torch.train import steps

    n_layers = SERVE_CFG["n_layers"]
    data = {f: train_data(f) for f in ("weather_transformer",
                                       "weather_transformer_causal")}
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    results = {"a": [], "b": []}

    # (a) kernels against plain attention, one train body, dropout 0.
    for family, dname in (("weather_transformer", "f32"),
                          ("weather_transformer", "bf16"),
                          ("weather_transformer_causal", "f32")):
        (xs, ys, ws), _ = data[family]
        kern = train_state(family, dtypes[dname], dropout=0.0)
        plain = train_state(family, dtypes[dname], dropout=0.0)
        causal = family == "weather_transformer_causal"
        for block in plain.model.blocks():
            block.attn.attn_fn = (
                lambda q, k, v, c=causal: PlainAttention.apply(q, k, v, c))
        fa.reset_launches()
        loss_k, grads_k = steps.loss_and_grads(kern, xs[0], ys[0], ws[0])
        torch.cuda.synchronize()
        counts = fa.launch_counts()
        want = {"flash_fwd": n_layers, "flash_bwd_dkdv": n_layers,
                "flash_bwd_dq": n_layers}
        if counts != want:
            raise AssertionError(f"(a) {family} {dname}: launches {counts}, "
                                 f"want {want}")
        loss_p, grads_p = steps.loss_and_grads(plain, xs[0], ys[0], ws[0])
        if fa.launch_counts() != counts:
            raise AssertionError("(a) the plain path launched a kernel")
        tol = TOL[dtypes[dname]]
        loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
        if not loss_err <= tol:
            raise AssertionError(f"(a) {family} {dname}: loss {loss_k.item()}"
                                 f" vs plain {loss_p.item()}")
        res = {"family": family, "compute": dname, "loss": loss_k.item(),
               "loss_rel_err": loss_err,
               "grad_rel_err": grads_close(grads_k, grads_p, tol), "tol": tol}
        results["a"].append(res)
        print(f"[smoke] train (a) kernels vs plain {res}", flush=True)
        del kern, plain, grads_k, grads_p

    # (b) the default configuration, per family and compute dtype.
    for family, dname in (("weather_transformer", "bf16"),
                          ("weather_transformer", "f32"),
                          ("weather_transformer_causal", "f32"),
                          ("weather_transformer_causal", "bf16")):
        (xs, ys, ws), (vxs, vys, vws) = data[family]
        state = train_state(family, dtypes[dname])
        dev = [torch.as_tensor(a, device=DEVICE)
               for a in (xs, ys, ws, vxs, vys, vws)]
        epoch = steps.make_epoch_train_eval_step(with_grad_norms=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        t0 = time.perf_counter()
        state, losses, sums, gnorms = epoch(state, *dev)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        counts = fa.launch_counts()
        n_train, n_val = len(xs), len(vxs)
        want = {"flash_fwd": n_layers * (n_train + n_val),
                "flash_bwd_dkdv": n_layers * n_train,
                "flash_bwd_dq": n_layers * n_train}
        if counts != want:
            raise AssertionError(f"(b) {family} {dname}: launches {counts}, "
                                 f"want {want}")
        values = torch.cat([losses, gnorms, torch.stack(sums)])
        if not bool(torch.isfinite(values).all()):
            raise AssertionError(f"(b) {family} {dname}: non-finite "
                                 f"{values.tolist()}")
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        step = steps.make_train_step()
        step(state, dev[0][0], dev[1][0], dev[2][0])  # warm-up
        times = []
        for i in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            i %= n_train
            step(state, dev[0][i], dev[1][i], dev[2][i])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        step_ms = statistics.median(times)
        trace = trace_step(lambda: step(state, dev[0][0], dev[1][0],
                                        dev[2][0]))
        res = {"family": family, "compute": dname, "steps": n_train,
               "val_batches": n_val, "launches": counts,
               "losses": losses.tolist(), "grad_norms": gnorms.tolist(),
               "val_loss": (sums[0] / sums[2]).item(),
               "val_acc": (sums[1] / sums[2]).item(),
               "epoch_s": epoch_s, "step_ms": step_ms,
               "step_ms_runs": times,
               "samples_per_s": BATCH / step_ms * 1e3,
               "tokens_per_s": BATCH * SERVE_CFG["seq_len"] / step_ms * 1e3,
               "peak_mem_gib": peak_gib}
        results["b"].append(res)
        print(f"[smoke] train (b) {res}", flush=True)
        print(f"[smoke] train (e) trace {family} {dname} {trace}", flush=True)
        del state, dev

    # (c) overfit one fixed batch, for each family and lr of the sweep.
    results["c"] = []
    for family in ("weather_transformer", "weather_transformer_causal"):
        (xs, ys, ws), _ = data[family]
        for lr in OVERFIT_LRS:
            state = train_state(family, torch.bfloat16, dropout=0.0, lr=lr)
            step = steps.make_train_step()
            losses = []
            for _ in range(TRAIN_STEPS):
                state, metrics = step(state, xs[0], ys[0], ws[0])
                losses.append(metrics["train_loss"].item())
            res = {"family": family, "compute": "bf16", "lr": lr,
                   "losses": losses, "last_over_first": losses[-1] / losses[0]}
            results["c"].append(res)
            print(f"[smoke] train (c) overfit {res}", flush=True)
            del state
    checked = [r for r in results["c"]
               if r["family"] == "weather_transformer_causal"
               and r["lr"] == OVERFIT_LR][0]
    if not checked["last_over_first"] < OVERFIT_RATIO:
        raise AssertionError(f"(c) one batch did not overfit: {checked}")
    print(f"[smoke] train (c) check: weather_transformer_causal at lr "
          f"{OVERFIT_LR}: {checked['last_over_first']} < {OVERFIT_RATIO}",
          flush=True)

    # (d) remat: the recompute runs the forward kernel again and draws the
    # same dropout masks.
    (xs, ys, ws), _ = data["weather_transformer"]
    plain_state = train_state("weather_transformer", torch.float32)
    remat_state = train_state("weather_transformer", torch.float32,
                              remat=True)
    _, grads = steps.loss_and_grads(plain_state, xs[0], ys[0], ws[0])
    fa.reset_launches()
    _, grads_r = steps.loss_and_grads(remat_state, xs[0], ys[0], ws[0])
    torch.cuda.synchronize()
    counts = fa.launch_counts()
    want = {"flash_fwd": 2 * n_layers, "flash_bwd_dkdv": n_layers,
            "flash_bwd_dq": n_layers}
    if counts != want:
        raise AssertionError(f"(d) remat launches {counts}, want {want}")
    results["d"] = {"launches": counts,
                    "grad_rel_err": grads_close(grads_r, grads,
                                                TOL[torch.float32])}
    print(f"[smoke] train (d) remat {results['d']}", flush=True)
    return results


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
    build.load_kernels("flash_fwd", "flash_bwd")
    build_s = time.perf_counter() - t0
    for name in ("flash_fwd", "flash_bwd"):
        info = build.build_info[name]
        print(f"[smoke] {'built' if info['built'] else 'reused'} {name} "
              f"(parallel build {build_s:.1f} s): {info['path']}", flush=True)
        for fn, rep in ptxas_report(info["log"]).items():
            print(f"[smoke]   ptxas: {fn}: {rep}", flush=True)
            tensor_core = any(tag in fn
                              for _, tag in TENSOR_CORE_SASS.values())
            if tensor_core and (rep.get("spill_bytes", 0) > 0
                                or "ptxas_warning" in rep):
                raise AssertionError(f"tensor-core kernel {fn}: {rep}")
    tc_counts = tensor_core_instructions(build)
    print(f"[smoke] tensor-core instructions: {tc_counts}", flush=True)

    variants = check_flash_kernel(fa)
    bwd_variants = check_bwd_kernels(fa)

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

    trained = train_phase(fa)
    train_counts = {name: sum(r["launches"][name] for r in trained["b"])
                    for name in ("flash_fwd", "flash_bwd_dkdv",
                                 "flash_bwd_dq")}
    train_steps = sum(r["steps"] for r in trained["b"])

    def bf16_summary(rows):
        row = [r for r in rows
               if r["dtype"] == "bfloat16" and not r["causal"]][0]
        return {"ms": row["ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "bound_basis": row["bound_basis"],
                "library_ms": row["library_ms"],
                "plain_ms": row["plain_ms"], "max_err": row["max_abs_err"],
                "causal": False}

    head = variants[0]  # f32, not causal: the first package's shape
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "dct_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "dct_tpu/ops/pallas_attention.py:81 (_flash_fwd_kernel; "
                    "pallas_call at :260)",
        "launches": launches + train_counts["flash_fwd"],
        "launches_by_path": {"serve": launches,
                             "train": train_counts["flash_fwd"]},
        "max_abs_err": head["max_abs_err"], "ms": head["ms"],
        "kernel_ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "bound_basis": head["bound_basis"],
        "library_ms": head["library_ms"],
        "launches_per_forward": launches / forwards,
        "bf16": bf16_summary(variants),
        "tensor_core_instructions": tc_counts["flash_fwd"],
        "variants": variants,
    }]
    for name, line in (("flash_bwd_dkdv", 303), ("flash_bwd_dq", 373)):
        head = bwd_variants[name][0]  # f32, not causal
        call = 487 if name == "flash_bwd_dkdv" else 529
        kernels.append({
            "name": name, "route": "cuda",
            "source": "dct_tpu_torch/ops/csrc/flash_bwd.cu",
            "replaces": f"dct_tpu/ops/pallas_attention.py:{line} "
                        f"(_{name}_kernel; pallas_call at :{call})",
            "launches": train_counts[name],
            "launches_per_step": train_counts[name] / train_steps,
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "kernel_ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "bound_basis": head["bound_basis"],
            "library_ms": head["library_ms"],
            "library_covers": head["library_covers"],
            "bf16": bf16_summary(bwd_variants[name]),
            "tensor_core_instructions": tc_counts[name],
            "variants": bwd_variants[name],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
