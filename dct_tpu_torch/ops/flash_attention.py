"""Flash-attention forward: the hand-written CUDA kernel and its plain version.

Counterpart of ``flash_attention``/``flash_attention_lse`` in
``dct_tpu/ops/pallas_attention.py`` (forward only; the backward kernels are
the next slice). :func:`flash_attention` is the one entry point:

- on a CUDA tensor it launches ``csrc/flash_fwd.cu`` (built at first use by
  :mod:`dct_tpu_torch.ops.build`) on the current stream, or raises;
- on a CPU tensor it runs :func:`flash_attention_plain`, the same function
  written in PyTorch (online softmax over KV blocks, the same masks, the
  same ``(o, lse)``).

Nothing falls back: a kernel that does not build or launch raises.

Supported: ``causal``, a causal sliding ``window``, grouped-query K/V
(``[B, G, T, D]`` with ``H % G == 0``), the f32 log-sum-exp, f32 and bf16,
head dims 16/32/64/128. Not yet ported (the wrapper raises): ``q_offset``
and rectangular ``Tq != Tk``, which only the ring engine's per-shard calls
use. ``block_q``/``block_k`` keep the reference's contract (T must be a
multiple of each); the CUDA kernel's own tiles are 64 x 64 and its loop
masks any ragged edge.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from dct_tpu_torch.ops.attention import _check_window, blockwise_attention_lse

HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches since the count was last reset (a plain integer; the
#: wrapper adds one per launch and nowhere else).
launches = 0
_count_lock = threading.Lock()


def reset_launches() -> None:
    global launches
    with _count_lock:
        launches = 0


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


def _kernel_fn():
    from dct_tpu_torch.ops.build import load_kernel

    lib = load_kernel("flash_fwd")
    fn = lib.dct_flash_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, ctypes.c_float, i, i,
                       i, p]
        fn.restype = ctypes.c_int
    return fn


_checked_devices: set = set()


def _flash_cuda(q, k, v, *, causal, scale, window, return_lse):
    from dct_tpu_torch.device import require_kernel_capability

    global launches
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash kernel needs a contiguous {name}")
    if q.device.index not in _checked_devices:
        require_kernel_capability(q.device)
        _checked_devices.add(q.device.index)
    b, h, t, d = q.shape
    if b * h > 65535:
        raise ValueError(f"B*H={b * h} exceeds the kernel's grid (65535)")
    o = torch.empty_like(q)
    lse = (
        torch.empty((b, h, t), dtype=torch.float32, device=q.device)
        if return_lse else None
    )
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            b, h, k.shape[1], t, d, float(scale), int(causal),
            int(window or 0), _DTYPE_CODES[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_fwd kernel launch failed: CUDA error {err} "
            f"(q {tuple(q.shape)} {q.dtype}, causal={causal}, "
            f"window={window})"
        )
    with _count_lock:
        launches += 1
    return (o, lse) if return_lse else o


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: float | None = None, window: int | None = None,
                    block_q: int = 128, block_k: int = 128,
                    return_lse: bool = False, q_offset: int = 0):
    """Flash attention; q ``[B,H,T,D]``, k/v ``[B,G,T,D]`` -> o
    ``[B,H,T,D]`` (and lse ``[B,H,T]`` f32 with ``return_lse``)."""
    _validate(q, k, v, causal=causal, window=window, block_q=block_q,
              block_k=block_k, q_offset=q_offset)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        return _flash_cuda(q, k, v, causal=causal, scale=scale,
                           window=window, return_lse=return_lse)
    if q.device.type != "cpu":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    o, lse = flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                   window=window, block_k=block_k)
    return (o, lse) if return_lse else o
