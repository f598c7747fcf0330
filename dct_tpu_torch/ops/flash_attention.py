"""Flash attention: the hand-written CUDA kernels and their plain versions.

Counterpart of ``flash_attention`` and ``flash_attention_lse`` and their
``custom_vjp`` s in ``dct_tpu/ops/pallas_attention.py`` (:547-667).
:func:`flash_attention` is the one entry point:

- on a CUDA tensor it launches ``csrc/flash_fwd.cu`` (built at first use by
  :mod:`dct_tpu_torch.ops.build`) on the current stream, or raises; the C
  entry point picks the kernel by dtype (bf16: the tensor-core kernel,
  ``wgmma``; f32: the tensor cores in 3xTF32, f32-accurate products), as
  ``csrc/flash_bwd.cu`` does for dK/dV and dQ;
- on a CPU tensor it runs :func:`flash_attention_plain`, the same function
  written in PyTorch (online softmax over KV blocks, the same masks, the
  same ``(o, lse)``);
- with grad enabled and any of q/k/v requiring grad it returns the output
  of :class:`FlashAttention`, whose backward runs the two backward kernels
  of ``csrc/flash_bwd.cu`` (dK/dV, then dQ) on a CUDA tensor and
  :func:`flash_attention_bwd_plain` on a CPU tensor.

Nothing falls back: a kernel that does not build or launch raises.

Supported: ``causal``, a causal sliding ``window``, grouped-query K/V
(``[B, G, Tk, D]`` with ``H % G == 0``), the f32 log-sum-exp, f32 and bf16,
head dims up to 128. The kernels are instanced for D in 16/32/64/128: the
wrappers zero-pad D up to the next of those and slice the outputs back,
which is exact (zero columns add nothing to q.k and give zero columns of
o, dq, dk and dv); the scale stays ``1/sqrt(D)`` of the true D, on the CPU
path as on the card. D > 128 raises (ROADMAP Queue B, B2). The ring
engine's per-shard variants (:mod:`dct_tpu_torch.ops.attention`) are the
kernels' arguments too: rectangular ``Tq != Tk`` (not causal, as the
reference: the striped ring's half-chunk blocks), ``q_offset`` (causal:
q row ``r`` sits at position ``q_offset + r``, the windowed ring's
partial-band shards; a row no key reaches gets o = 0 and lse = -1e30),
and, under grad with ``return_lse=True``, the backward through the lse
output (the ring's merge weights: delta' = rowsum(dO o) - g_lse, folded
into the backward kernels). ``block_q``/``block_k`` keep the reference's
contract (Tq a multiple of ``min(block_q, Tq)``, Tk of ``min(block_k,
Tk)``) and set the plain versions' blocks; the CUDA kernels pick their
own tiles (64 rows a warpgroup, 16-64 in the streamed f32 tiles) and
their loops mask any ragged edge.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import os
import threading

import torch
import torch.nn.functional as F

from dct_tpu_torch.ops.attention import (
    _band_mask,
    _check_window,
    blockwise_attention_lse,
    expand_kv,
)

HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches since the counts were last reset (plain integers; each
#: wrapper adds one per launch of its kernel and nowhere else): the forward
#: (``flash_fwd``), the dK/dV backward (``flash_bwd_dkdv``) and the dQ
#: backward (``flash_bwd_dq``).
launches = 0
dkdv_launches = 0
dq_launches = 0
_count_lock = threading.Lock()


def reset_launches() -> None:
    """Set all three launch counts to 0."""
    global launches, dkdv_launches, dq_launches
    with _count_lock:
        launches = dkdv_launches = dq_launches = 0


def launch_counts() -> dict[str, int]:
    """The three counts by kernel name."""
    with _count_lock:
        return {"flash_fwd": launches, "flash_bwd_dkdv": dkdv_launches,
                "flash_bwd_dq": dq_launches}


#: The tally of the block this thread runs under (counted_launches).
_tally = threading.local()


@contextlib.contextmanager
def counted_launches(counts: dict | None = None):
    """Count the launches of this block into ``counts`` (a fresh dict by
    kernel name when None), beside the process-wide counts: the
    per-stage counts of an MPMD step, whose stages run side by side in
    threads of one process. A :class:`FlashAttention` backward counts
    into the tally its forward ran under, on whatever thread autograd
    runs it."""
    if counts is None:
        counts = dict.fromkeys(("flash_fwd", "flash_bwd_dkdv",
                                "flash_bwd_dq"), 0)
    prev = getattr(_tally, "counts", None)
    _tally.counts = counts
    try:
        yield counts
    finally:
        _tally.counts = prev


def _tally_launch(name: str) -> None:
    """Add one to the tally of this thread's block, if any (the caller
    holds ``_count_lock``)."""
    counts = getattr(_tally, "counts", None)
    if counts is not None:
        counts[name] += 1


def _validate(q, k, v, *, causal, window, block_q, block_k, q_offset):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash attention takes q, k, v of rank 4 [B, H, T, D]")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    b, h, t, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}"
        )
    if h % k.shape[1]:
        raise ValueError(
            f"GQA needs q heads ({h}) divisible by kv heads ({k.shape[1]})"
        )
    padded_head_dim(d)
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash attention takes f32 or bf16 q/k/v of one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    _check_window(window, causal)
    tk = k.shape[2]
    if causal and tk != t:
        raise ValueError(f"causal flash needs square Tq==Tk, got {t} vs {tk}")
    if q_offset and not causal:
        # The offset only shifts the causal position math; a non-causal
        # caller would silently get unshifted full attention.
        raise ValueError("flash q_offset requires causal attention")
    if q_offset < 0:
        raise ValueError(f"flash q_offset must be >= 0, got {q_offset}")
    bq, bk = min(block_q, t), min(block_k, tk)
    if t % bq or tk % bk:
        raise ValueError(
            f"seq lens q={t}, kv={tk} must be multiples of block_q={bq} "
            f"and block_k={bk} (pad upstream)"
        )


def padded_head_dim(d: int) -> int:
    """The kernel instance that computes head dim ``d``: the next of
    :data:`HEAD_DIMS` at or above it. Raises above 128."""
    for dp in HEAD_DIMS:
        if d <= dp:
            return dp
    raise ValueError(
        f"head dim {d} is above the kernels' widest instance "
        f"({HEAD_DIMS[-1]}); wider head dims need new kernel instances "
        "and their shared-memory budget: ROADMAP Queue B, B2"
    )


def _pad(d: int, *tensors):
    """Zero-pad the last dim of each tensor to ``padded_head_dim(d)``."""
    dp = padded_head_dim(d)
    if dp == d:
        return tensors
    return tuple(F.pad(t, (0, dp - d)) for t in tensors)


def flash_attention_plain(q, k, v, *, causal: bool = False,
                          scale: float | None = None,
                          window: int | None = None, block_k: int = 128,
                          q_offset: int = 0):
    """The kernel's function in plain PyTorch: online softmax over KV
    blocks of ``block_k``, f32 statistics and sums, P rounded to the
    input dtype before P.V, q row ``r`` at position ``q_offset + r``.
    Returns ``(o [B,H,Tq,D] in q's dtype, lse [B,H,Tq] f32)``."""
    return blockwise_attention_lse(
        q, k, v, block_size=min(block_k, k.shape[-2]), causal=causal,
        scale=scale, window=window, q_offset=q_offset,
    )


def _tile_needed(q0: int, bq: int, k0: int, bk: int, causal: bool,
                 window: int | None) -> bool:
    """Whether any (q, k) pair of the tile whose first q position is
    ``q0`` survives the mask: the tile skip of the kernels' loop bounds
    (``pallas_attention.py:152-157, 356-365``)."""
    if not causal:
        return True
    if q0 + bq - 1 < k0:  # the whole tile lies above the diagonal
        return False
    return window is None or q0 - (k0 + bk - 1) < window


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = False,
                              scale: float | None = None,
                              window: int | None = None, block_q: int = 128,
                              block_k: int = 128, q_offset: int = 0,
                              g_lse=None):
    """The backward kernels' function in plain PyTorch, blockwise over
    ``block_q`` x ``block_k`` tiles with the kernels' tile skip and
    roundings: P = exp(scale q.k - lse) (0 where masked, q row ``r`` at
    position ``q_offset + r``), dP = dO.v, delta = rowsum(dO * O) - g_lse
    (``g_lse`` ``[B,H,Tq]``, the cotangent of the lse output, or None),
    dS = P (dP - delta) scale, all f32; P is rounded to dO's dtype before
    P^T dO and dS to the input dtype before dS^T Q and dS K; sums in f32.
    A GQA group's q heads are summed into their KV head. Tq may differ
    from Tk. Returns ``(dq, dk, dv)`` in q's, k's and v's dtypes."""
    b, h, t, d = q.shape
    g, tk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    bq, bk = min(block_q, t), min(block_k, tk)
    kx, vx = expand_kv(q, k, v)
    qf, kf, vf, dof = q.float(), kx.float(), vx.float(), do.float()
    delta = (dof * o.float()).sum(-1)
    if g_lse is not None:
        delta = delta - g_lse.float()
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    q_pos = q_offset + torch.arange(t, device=q.device)
    k_pos = torch.arange(tk, device=q.device)
    for q0 in range(0, t, bq):
        qs = slice(q0, q0 + bq)
        qb, dob = qf[..., qs, :], dof[..., qs, :]
        lse_b, delta_b = lse[..., qs, None], delta[..., qs, None]
        for k0 in range(0, tk, bk):
            if not _tile_needed(q_offset + q0, bq, k0, bk, causal, window):
                continue
            ks = slice(k0, k0 + bk)
            kb, vb = kf[..., ks, :], vf[..., ks, :]
            p = torch.exp(torch.matmul(qb, kb.transpose(-1, -2)) * scale
                          - lse_b)
            if causal:
                p = torch.where(_band_mask(q_pos[qs], k_pos[ks], window), p,
                                0.0)
            dp = torch.matmul(dob, vb.transpose(-1, -2))
            ds = p * (dp - delta_b) * scale
            ds = ds.to(q.dtype).float()
            dv[..., ks, :] += torch.matmul(
                p.to(do.dtype).float().transpose(-1, -2), dob
            )
            dk[..., ks, :] += torch.matmul(ds.transpose(-1, -2), qb)
            dq[..., qs, :] += torch.matmul(ds, kb)
    if g != h:
        dk = dk.view(b, g, h // g, tk, d).sum(2)
        dv = dv.view(b, g, h // g, tk, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernel_fn(lib_name: str, symbol: str, n_ptrs: int):
    from dct_tpu_torch.ops.build import load_kernel

    fn = getattr(load_kernel(lib_name), symbol)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # n_ptrs tensors, then B, H, G, Tq, Tk, q_offset, D, scale, causal,
        # window, dtype, and the stream.
        fn.argtypes = [p] * n_ptrs + [i, i, i, i, i, i, i, ctypes.c_float,
                                      i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


_checked_devices: set = set()


def _check_cuda(q, named):
    from dct_tpu_torch.device import require_kernel_capability

    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash kernel needs a contiguous {name}")
    if q.device.index not in _checked_devices:
        require_kernel_capability(q.device)
        _checked_devices.add(q.device.index)


def _launch(kernel, fn, tensors, q, k, *, causal, scale, window, q_offset):
    b, h, t, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            *(x.data_ptr() if x is not None else None for x in tensors),
            b, h, k.shape[1], t, k.shape[2], int(q_offset), d, float(scale),
            int(causal), int(window or 0), _DTYPE_CODES[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{kernel} kernel launch failed: CUDA error {err} "
            f"(q {tuple(q.shape)}, k {tuple(k.shape)} {q.dtype}, "
            f"causal={causal}, window={window}, q_offset={q_offset})"
        )


def _flash_cuda(q, k, v, *, causal, scale, window, return_lse, q_offset=0):
    global launches
    _check_cuda(q, (("q", q), ("k", k), ("v", v)))
    b, h, t, _ = q.shape
    o = torch.empty_like(q)
    lse = (
        torch.empty((b, h, t), dtype=torch.float32, device=q.device)
        if return_lse else None
    )
    _launch("flash_fwd", _kernel_fn("flash_fwd", "dct_flash_fwd", 5),
            (q, k, v, o, lse), q, k, causal=causal, scale=scale,
            window=window, q_offset=q_offset)
    with _count_lock:
        launches += 1
        _tally_launch("flash_fwd")
    return o, lse


def _check_bwd(kernel, q, k, v, o, lse, do, g_lse):
    b, h, t, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(
            f"o {tuple(o.shape)} and dO {tuple(do.shape)} must match q "
            f"{tuple(q.shape)}"
        )
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise TypeError(
            f"o/dO dtypes {o.dtype}/{do.dtype} must be q's ({q.dtype})"
        )
    for name, x in (("lse", lse), ("g_lse", g_lse)):
        if x is not None and (x.shape != (b, h, t)
                              or x.dtype != torch.float32):
            raise ValueError(
                f"{name} must be f32 [B,H,Tq]={[b, h, t]}, got {x.dtype} "
                f"{list(x.shape)}"
            )
    if q.device.type != "cuda":
        raise ValueError(
            f"{kernel} launches its CUDA kernel and takes CUDA tensors, not "
            f"{q.device}; on the CPU the backward is FlashAttention's, "
            "through flash_attention_bwd_plain"
        )
    named = [("q", q), ("k", k), ("v", v), ("o", o), ("lse", lse),
             ("dO", do)]
    if g_lse is not None:
        named.append(("g_lse", g_lse))
    _check_cuda(q, named)


def flash_bwd_dkdv(q, k, v, o, lse, do, *, causal: bool = False,
                   scale: float | None = None, window: int | None = None,
                   q_offset: int = 0, g_lse=None):
    """Kernel 2 (``_flash_bwd_dkdv_kernel``): ``(dk, dv)`` ``[B,G,Tk,D]``
    from the forward's q, k, v, o, lse, the output cotangent dO and the
    lse cotangent ``g_lse`` (or None), all CUDA tensors; launches
    ``flash_bwd_dkdv`` or raises."""
    global dkdv_launches
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    # Padded copies are contiguous, whatever the (sliced) o passed in.
    q, k, v, o, do = _pad(d, q, k, v, o, do)
    _check_bwd("flash_bwd_dkdv", q, k, v, o, lse, do, g_lse)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd_dkdv",
            _kernel_fn("flash_bwd", "dct_flash_bwd_dkdv", 9),
            (q, k, v, o, do, lse, g_lse, dk, dv), q, k, causal=causal,
            scale=scale, window=window, q_offset=q_offset)
    with _count_lock:
        dkdv_launches += 1
        _tally_launch("flash_bwd_dkdv")
    if dk.shape[-1] != d:
        dk, dv = dk[..., :d].contiguous(), dv[..., :d].contiguous()
    return dk, dv


def flash_bwd_dq(q, k, v, o, lse, do, *, causal: bool = False,
                 scale: float | None = None, window: int | None = None,
                 q_offset: int = 0, g_lse=None):
    """Kernel 3 (``_flash_bwd_dq_kernel``): dq ``[B,H,Tq,D]`` from CUDA
    tensors (``g_lse`` as for kernel 2); launches ``flash_bwd_dq`` or
    raises."""
    global dq_launches
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    # Padded copies are contiguous, whatever the (sliced) o passed in.
    q, k, v, o, do = _pad(d, q, k, v, o, do)
    _check_bwd("flash_bwd_dq", q, k, v, o, lse, do, g_lse)
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", _kernel_fn("flash_bwd", "dct_flash_bwd_dq", 8),
            (q, k, v, o, do, lse, g_lse, dq), q, k, causal=causal,
            scale=scale, window=window, q_offset=q_offset)
    with _count_lock:
        dq_launches += 1
        _tally_launch("flash_bwd_dq")
    return dq[..., :d].contiguous() if dq.shape[-1] != d else dq


def bwd_mode(device="cpu") -> str:
    """``DCT_FLASH_BWD``: ``kernel`` (default) or ``remat``
    (``pallas_attention.py:572-590``), read at each backward. ``remat``
    differentiates a plain PyTorch path, so on a CUDA device it raises."""
    mode = os.environ.get("DCT_FLASH_BWD", "kernel").strip().lower()
    if mode not in ("kernel", "remat"):
        raise ValueError(f"DCT_FLASH_BWD={mode!r} must be 'kernel' or 'remat'")
    if mode == "remat" and torch.device(device).type == "cuda":
        raise ValueError(
            "DCT_FLASH_BWD=remat differentiates the plain blockwise path, "
            "which runs on CPU tensors only; on the card the backward "
            "launches kernels 2 and 3: unset DCT_FLASH_BWD or set it to kernel"
        )
    return mode


def _remat_bwd(q, k, v, do, g_lse, *, causal, scale, window, block_k,
               q_offset):
    """The ``remat`` escape hatch: differentiate the blockwise path (plain
    PyTorch, CPU tensors only) instead of the kernel's plain backward."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        o, lse = blockwise_attention_lse(
            *leaves, block_size=min(block_k, k.shape[-2]), causal=causal,
            scale=scale, window=window, q_offset=q_offset)
        outs, cots = [o], [do]
        if g_lse is not None:
            outs.append(lse)
            cots.append(g_lse)
        return torch.autograd.grad(outs, leaves, cots, allow_unused=True)


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward (the reference's ``custom_vjp``s,
    ``pallas_attention.py:547-667``): the forward returns (o, lse) and
    saves (q, k, v, o, lse) as ``_vjp_fwd`` does; the backward takes the
    cotangents of both outputs (None where an output is unused) and runs
    kernels 2 and 3 on a CUDA tensor, the lse cotangent folded into delta,
    and :func:`flash_attention_bwd_plain` on a CPU tensor, or under
    ``DCT_FLASH_BWD=remat`` the gradient of the blockwise path on a CPU
    tensor (on a CUDA tensor ``remat`` raises)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, block_q, block_k,
                q_offset):
        if q.device.type == "cuda":
            o, lse = _flash_cuda(q, k, v, causal=causal, scale=scale,
                                 window=window, return_lse=True,
                                 q_offset=q_offset)
        else:
            o, lse = flash_attention_plain(q, k, v, causal=causal,
                                           scale=scale, window=window,
                                           block_k=block_k,
                                           q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = (causal, scale, window, block_q, block_k, q_offset)
        ctx.tally = getattr(_tally, "counts", None)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale, window, block_q, block_k, q_offset = ctx.opts
        # dO arrives strided from o.transpose(1, 2).reshape(...) upstream.
        do = torch.zeros_like(o) if do is None else do.contiguous()
        if g_lse is not None:
            g_lse = g_lse.float().contiguous()
        none = (None,) * 6
        if bwd_mode(q.device) == "remat":
            return (*_remat_bwd(q, k, v, do, g_lse, causal=causal,
                                scale=scale, window=window, block_k=block_k,
                                q_offset=q_offset), *none)
        kw = dict(causal=causal, scale=scale, window=window,
                  q_offset=q_offset, g_lse=g_lse)
        if q.device.type == "cuda":
            with (counted_launches(ctx.tally) if ctx.tally is not None
                  else contextlib.nullcontext()):
                dk, dv = flash_bwd_dkdv(q, k, v, o, lse, do, **kw)
                dq = flash_bwd_dq(q, k, v, o, lse, do, **kw)
        else:
            dq, dk, dv = flash_attention_bwd_plain(
                q, k, v, o, lse, do, block_q=block_q, block_k=block_k, **kw)
        return (dq, dk, dv, *none)


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: float | None = None, window: int | None = None,
                    block_q: int = 128, block_k: int = 128,
                    return_lse: bool = False, q_offset: int = 0):
    """Flash attention; q ``[B,H,Tq,D]``, k/v ``[B,G,Tk,D]`` -> o
    ``[B,H,Tq,D]`` (and lse ``[B,H,Tq]`` f32 with ``return_lse``). With
    grad enabled and any input requiring grad, the outputs' ``grad_fn`` is
    :class:`FlashAttention`, and both carry gradients."""
    _validate(q, k, v, causal=causal, window=window, block_q=block_q,
              block_k=block_k, q_offset=q_offset)
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    # Pad outside FlashAttention: autograd slices the padded gradients.
    q, k, v = _pad(d, q, k, v)
    if torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    ):
        o, lse = FlashAttention.apply(q, k, v, causal, scale, window,
                                      block_q, block_k, q_offset)
    elif q.device.type == "cuda":
        o, lse = _flash_cuda(q, k, v, causal=causal, scale=scale,
                             window=window, return_lse=return_lse,
                             q_offset=q_offset)
    else:
        o, lse = flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                       window=window, block_k=block_k,
                                       q_offset=q_offset)
    if o.shape[-1] != d:
        o = o[..., :d]
    return (o, lse) if return_lse else o
