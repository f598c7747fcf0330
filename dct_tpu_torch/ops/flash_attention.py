"""Flash attention: the hand-written CUDA kernels and their plain versions.

Counterpart of ``flash_attention`` and its ``custom_vjp`` in
``dct_tpu/ops/pallas_attention.py`` (:547-596). :func:`flash_attention` is
the one entry point:

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
(``[B, G, T, D]`` with ``H % G == 0``), the f32 log-sum-exp, f32 and bf16,
head dims 16/32/64/128. Not yet ported (the wrapper raises): ``q_offset``
and rectangular ``Tq != Tk``, which only the ring engine's per-shard calls
use, and the backward through the lse output (the ring's merge weights).
``block_q``/``block_k`` keep the reference's contract (T must be a
multiple of each) and set the plain versions' blocks; the CUDA kernels
pick their own tiles (64 rows a warpgroup, 16-64 in the streamed f32
tiles) and their loops mask any ragged edge.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

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
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported (one of {HEAD_DIMS})")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash attention takes f32 or bf16 q/k/v of one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    _check_window(window, causal)
    if q_offset:
        raise NotImplementedError(
            "flash q_offset (the windowed ring's partial-band shards) is "
            "not ported yet: ROADMAP Queue B, kernel 1"
        )
    tk = k.shape[2]
    if tk != t:
        if causal:
            raise ValueError(f"causal flash needs square Tq==Tk, got {t} vs {tk}")
        raise NotImplementedError(
            f"rectangular flash Tq={t} != Tk={tk} (the striped ring's "
            "blocks) is not ported yet: ROADMAP Queue B, kernel 1"
        )
    bq, bk = min(block_q, t), min(block_k, t)
    if t % bq or t % bk:
        raise ValueError(
            f"seq len {t} must be a multiple of block_q={bq} and "
            f"block_k={bk} (pad upstream)"
        )


def flash_attention_plain(q, k, v, *, causal: bool = False,
                          scale: float | None = None,
                          window: int | None = None, block_k: int = 128):
    """The kernel's function in plain PyTorch: online softmax over KV
    blocks of ``block_k``, f32 statistics and sums, P rounded to the
    input dtype before P.V. Returns ``(o [B,H,T,D] in q's dtype,
    lse [B,H,T] f32)``."""
    return blockwise_attention_lse(
        q, k, v, block_size=min(block_k, k.shape[-2]), causal=causal,
        scale=scale, window=window,
    )


def _tile_needed(q0: int, bq: int, k0: int, bk: int, causal: bool,
                 window: int | None) -> bool:
    """Whether any (q, k) pair of the tile survives the mask: the tile skip
    of the kernels' loop bounds (``pallas_attention.py:356-365``)."""
    if not causal:
        return True
    if q0 + bq - 1 < k0:  # the whole tile lies above the diagonal
        return False
    return window is None or q0 - (k0 + bk - 1) < window


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = False,
                              scale: float | None = None,
                              window: int | None = None, block_q: int = 128,
                              block_k: int = 128):
    """The backward kernels' function in plain PyTorch, blockwise over
    ``block_q`` x ``block_k`` tiles with the kernels' tile skip and
    roundings: P = exp(scale q.k - lse) (0 where masked), dP = dO.v,
    delta = rowsum(dO * O), dS = P (dP - delta) scale, all f32; P is
    rounded to dO's dtype before P^T dO and dS to the input dtype before
    dS^T Q and dS K; sums in f32. A GQA group's q heads are summed into
    their KV head. Returns ``(dq, dk, dv)`` in q's, k's and v's dtypes."""
    b, h, t, d = q.shape
    g = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    bq, bk = min(block_q, t), min(block_k, t)
    kx, vx = expand_kv(q, k, v)
    qf, kf, vf, dof = q.float(), kx.float(), vx.float(), do.float()
    delta = (dof * o.float()).sum(-1)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(qf)
    dv = torch.zeros_like(qf)
    pos = torch.arange(t, device=q.device)
    for q0 in range(0, t, bq):
        qs = slice(q0, q0 + bq)
        qb, dob = qf[..., qs, :], dof[..., qs, :]
        lse_b, delta_b = lse[..., qs, None], delta[..., qs, None]
        for k0 in range(0, t, bk):
            if not _tile_needed(q0, bq, k0, bk, causal, window):
                continue
            ks = slice(k0, k0 + bk)
            kb, vb = kf[..., ks, :], vf[..., ks, :]
            p = torch.exp(torch.matmul(qb, kb.transpose(-1, -2)) * scale
                          - lse_b)
            if causal:
                p = torch.where(_band_mask(pos[qs], pos[ks], window), p, 0.0)
            dp = torch.matmul(dob, vb.transpose(-1, -2))
            ds = p * (dp - delta_b) * scale
            ds = ds.to(q.dtype).float()
            dv[..., ks, :] += torch.matmul(
                p.to(do.dtype).float().transpose(-1, -2), dob
            )
            dk[..., ks, :] += torch.matmul(ds.transpose(-1, -2), qb)
            dq[..., qs, :] += torch.matmul(ds, kb)
    if g != h:
        dk = dk.view(b, g, h // g, t, d).sum(2)
        dv = dv.view(b, g, h // g, t, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernel_fn(lib_name: str, symbol: str, n_ptrs: int):
    from dct_tpu_torch.ops.build import load_kernel

    fn = getattr(load_kernel(lib_name), symbol)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # n_ptrs tensors, then B, H, G, T, D, scale, causal, window, dtype,
        # and the stream.
        fn.argtypes = [p] * n_ptrs + [i, i, i, i, i, ctypes.c_float, i, i,
                                      i, p]
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
    if q.shape[0] * q.shape[1] > 65535:
        raise ValueError(
            f"B*H={q.shape[0] * q.shape[1]} exceeds the kernel's grid (65535)"
        )


def _launch(kernel, fn, tensors, q, k, *, causal, scale, window):
    b, h, t, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            *(x.data_ptr() if x is not None else None for x in tensors),
            b, h, k.shape[1], t, d, float(scale), int(causal),
            int(window or 0), _DTYPE_CODES[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{kernel} kernel launch failed: CUDA error {err} "
            f"(q {tuple(q.shape)} {q.dtype}, causal={causal}, "
            f"window={window})"
        )


def _flash_cuda(q, k, v, *, causal, scale, window, return_lse):
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
            window=window)
    with _count_lock:
        launches += 1
    return (o, lse) if return_lse else o


def _check_bwd(kernel, q, k, v, o, lse, do):
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
    if lse.shape != (b, h, t) or lse.dtype != torch.float32:
        raise ValueError(
            f"lse must be f32 [B,H,T]={[b, h, t]}, got {lse.dtype} "
            f"{list(lse.shape)}"
        )
    if q.device.type != "cuda":
        raise ValueError(
            f"{kernel} launches its CUDA kernel and takes CUDA tensors, not "
            f"{q.device}; on the CPU the backward is FlashAttention's, "
            "through flash_attention_bwd_plain"
        )
    _check_cuda(q, (("q", q), ("k", k), ("v", v), ("o", o), ("lse", lse),
                    ("dO", do)))


def flash_bwd_dkdv(q, k, v, o, lse, do, *, causal: bool = False,
                   scale: float | None = None, window: int | None = None):
    """Kernel 2 (``_flash_bwd_dkdv_kernel``): ``(dk, dv)`` ``[B,G,T,D]``
    from the forward's q, k, v, o, lse and the output cotangent dO, all
    CUDA tensors; launches ``flash_bwd_dkdv`` or raises."""
    global dkdv_launches
    _check_bwd("flash_bwd_dkdv", q, k, v, o, lse, do)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd_dkdv",
            _kernel_fn("flash_bwd", "dct_flash_bwd_dkdv", 8),
            (q, k, v, o, do, lse, dk, dv), q, k, causal=causal, scale=scale,
            window=window)
    with _count_lock:
        dkdv_launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, o, lse, do, *, causal: bool = False,
                 scale: float | None = None, window: int | None = None):
    """Kernel 3 (``_flash_bwd_dq_kernel``): dq ``[B,H,T,D]`` from CUDA
    tensors; launches ``flash_bwd_dq`` or raises."""
    global dq_launches
    _check_bwd("flash_bwd_dq", q, k, v, o, lse, do)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", _kernel_fn("flash_bwd", "dct_flash_bwd_dq", 7),
            (q, k, v, o, do, lse, dq), q, k, causal=causal, scale=scale,
            window=window)
    with _count_lock:
        dq_launches += 1
    return dq


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward (the reference's ``custom_vjp``,
    ``pallas_attention.py:547-596``): the forward saves (q, k, v, o, lse)
    as ``_vjp_fwd`` does; the backward runs kernels 2 and 3 on a CUDA
    tensor and :func:`flash_attention_bwd_plain` on a CPU tensor."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, block_q, block_k):
        if q.device.type == "cuda":
            o, lse = _flash_cuda(q, k, v, causal=causal, scale=scale,
                                 window=window, return_lse=True)
        else:
            o, lse = flash_attention_plain(q, k, v, causal=causal,
                                           scale=scale, window=window,
                                           block_k=block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = (causal, scale, window, block_q, block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale, window, block_q, block_k = ctx.opts
        # dO arrives strided from o.transpose(1, 2).reshape(...) upstream.
        do = do.contiguous()
        if q.device.type == "cuda":
            kw = dict(causal=causal, scale=scale, window=window)
            dk, dv = flash_bwd_dkdv(q, k, v, o, lse, do, **kw)
            dq = flash_bwd_dq(q, k, v, o, lse, do, **kw)
        else:
            dq, dk, dv = flash_attention_bwd_plain(
                q, k, v, o, lse, do, causal=causal, scale=scale,
                window=window, block_q=block_q, block_k=block_k,
            )
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: float | None = None, window: int | None = None,
                    block_q: int = 128, block_k: int = 128,
                    return_lse: bool = False, q_offset: int = 0):
    """Flash attention; q ``[B,H,T,D]``, k/v ``[B,G,T,D]`` -> o
    ``[B,H,T,D]`` (and lse ``[B,H,T]`` f32 with ``return_lse``). With
    grad enabled and any input requiring grad, the output's ``grad_fn`` is
    :class:`FlashAttention`."""
    _validate(q, k, v, causal=causal, window=window, block_q=block_q,
              block_k=block_k, q_offset=q_offset)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    if torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    ):
        if return_lse:
            raise NotImplementedError(
                "the backward through flash attention's lse output (the "
                "ring engine's merge weights, _vjp_lse_bwd) is not ported "
                "yet: ROADMAP Queue A item 16"
            )
        return FlashAttention.apply(q, k, v, causal, scale, window, block_q,
                                    block_k)
    if q.device.type == "cuda":
        return _flash_cuda(q, k, v, causal=causal, scale=scale,
                           window=window, return_lse=return_lse)
    o, lse = flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                   window=window, block_k=block_k)
    return (o, lse) if return_lse else o
