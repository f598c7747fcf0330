"""A/B of the port's flash kernels between two checkouts, on one card.

    python3 scripts/torch_kernel_ab.py --base <dir of another checkout>

Builds ``dct_tpu_torch/ops/csrc/flash_fwd.cu`` and ``flash_bwd.cu`` of the
base checkout and of this one (``nvcc`` with the port's flags, into
``build/kernel_ab/``), loads both through their C entry points (a
checkout's entry points take one ``seq``, or ``tq, tk, q_offset`` and the
backward's ``g_lse`` pointer, as its ``flash_fwd.cu`` says) and times every kernel at the main path's shape
(B=32, H=G=8, T=1024, D=64), f32 and bf16, causal and not, in the order
base, head, head, base, ``--rounds`` times over, each reading by
``chip_smoke.time_ms``. Prints, per kernel and variant, both sides'
median and every reading, the head's share of the base's median, and both
sides' errors against the plain PyTorch version (forward: max abs over o;
dK/dV and dQ: max abs over max|plain|), then the card's name and power
limit. Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPE = (32, 8, 8, 1024, 64)  # B, H, G, T, D
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Tensor arguments of each C entry point (then B, H, G, T, D, scale,
# causal, window, dtype, stream; where the entry points take Tq, Tk and
# q_offset, the backward's take a g_lse pointer after lse, null here).
ENTRY = {"flash_fwd": ("flash_fwd", "dct_flash_fwd", 5),
         "flash_bwd_dkdv": ("flash_bwd", "dct_flash_bwd_dkdv", 8),
         "flash_bwd_dq": ("flash_bwd", "dct_flash_bwd_dq", 7)}


def takes_offset(checkout: str) -> bool:
    """Whether the checkout's entry points take ``tq, tk, q_offset``."""
    with open(os.path.join(checkout, "dct_tpu_torch", "ops", "csrc",
                           "flash_fwd.cu")) as f:
        return "int tq" in f.read()


def build(side: str, checkout: str) -> dict[str, ctypes.CDLL]:
    """Compile both kernel sources of ``checkout`` in parallel."""
    from dct_tpu_torch.ops.build import NVCC_FLAGS, _cuda_tool

    out_dir = os.path.join(ROOT, "build", "kernel_ab", side)
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for lib in ("flash_fwd", "flash_bwd"):
        src = os.path.join(checkout, "dct_tpu_torch", "ops", "csrc",
                           f"{lib}.cu")
        so = os.path.join(out_dir, f"lib{lib}.so")
        procs[lib] = (so, subprocess.Popen(
            [_cuda_tool("nvcc"), *NVCC_FLAGS, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for lib, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{side}: nvcc failed on {lib}:\n{log}")
        libs[lib] = ctypes.CDLL(so)
    return libs


def entry(libs, kernel, offset: bool):
    lib, symbol, n_ptrs = ENTRY[kernel]
    fn = getattr(libs[lib], symbol)
    if offset:
        n_ptrs += kernel != "flash_fwd"
    fn.argtypes = [P] * n_ptrs + [I] * (7 if offset else 5) + [F, I, I, I, P]
    fn.restype = I
    return fn


def call_args(tensors, kernel, offset: bool, b, h, g, t, d):
    """The pointers and sizes of one call: Tq = Tk = T, no offset, no
    lse cotangent."""
    ptrs = [x.data_ptr() for x in tensors]
    if not offset:
        return [*ptrs, b, h, g, t, d]
    if kernel != "flash_fwd":
        ptrs.insert(6, None)  # g_lse after lse
    return [*ptrs, b, h, g, t, t, 0, d]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--base", required=True,
                        help="root of the checkout to compare against")
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_ab: CUDA is not available", file=sys.stderr)
        return 1
    from chip_smoke import abs_rel_err, card_line, time_ms
    from dct_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    libs = {"base": build("base", os.path.abspath(args.base)),
            "head": build("head", ROOT)}
    offset = {"base": takes_offset(os.path.abspath(args.base)),
              "head": takes_offset(ROOT)}
    print(f"[ab] built both sides in {time.perf_counter() - t0:.1f} s",
          flush=True)
    b, h, g, t, d = SHAPE
    scale = d ** -0.5
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.randn(b, n, t, d, generator=gen, device="cuda")
                       .to(dtype) for n in (h, g, g, h))
        for causal in (False, True):
            po, plse = fa.flash_attention_plain(q, k, v, causal=causal)
            pdq, pdk, pdv = fa.flash_attention_bwd_plain(
                q, k, v, po, plse, do, causal=causal)
            o, lse = torch.empty_like(q), torch.empty_like(plse)
            dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
            outs = {"flash_fwd": ((q, k, v, o, lse), ((o, po),)),
                    "flash_bwd_dkdv": ((q, k, v, po, do, plse, dk, dv),
                                       ((dk, pdk), (dv, pdv))),
                    "flash_bwd_dq": ((q, k, v, po, do, plse, dq),
                                     ((dq, pdq),))}
            for kernel, (tensors, checks) in outs.items():
                calls = {}
                for side in ("base", "head"):
                    fn = entry(libs[side], kernel, offset[side])
                    head = call_args(tensors, kernel, offset[side], b, h, g,
                                     t, d)
                    calls[side] = (lambda fn=fn, head=head: fn(
                        *head, scale, int(causal), 0,
                        0 if dtype == torch.float32 else 1, stream))
                errors = {}
                for side, call in calls.items():
                    if call() != 0:
                        raise RuntimeError(f"{side} {kernel}: launch failed")
                    torch.cuda.synchronize()
                    errs = [abs_rel_err(got, ref) for got, ref in checks]
                    errors[side] = max(e[0] if kernel == "flash_fwd" else e[1]
                                       for e in errs)
                readings = {"base": [], "head": []}
                for _ in range(args.rounds):
                    for side in ("base", "head", "head", "base"):
                        readings[side].append(time_ms(calls[side]))
                med = {s: statistics.median(r) for s, r in readings.items()}
                rows.append({
                    "kernel": kernel, "dtype": str(dtype).replace("torch.", ""),
                    "causal": causal, "base_ms": med["base"],
                    "head_ms": med["head"],
                    "head_over_base": med["head"] / med["base"],
                    "base_readings": readings["base"],
                    "head_readings": readings["head"], "errors": errors})
                print(f"[ab] {json.dumps(rows[-1])}", flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
