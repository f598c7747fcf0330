"""Single-shard attention paths (counterpart of ``dct_tpu/ops/attention.py``).

- :func:`dense_attention`: the full [Tq, Tk] score matrix, the reference
  numerics and the oracle the other paths are tested against;
- :func:`blockwise_attention`: online softmax over KV blocks, O(T) memory;
- the flash path, :func:`dct_tpu_torch.ops.flash_attention.flash_attention`:
  the hand-written CUDA kernel on a CUDA tensor, its plain PyTorch version
  on a CPU tensor.

:func:`make_attention_fn` picks one by :func:`select_attention_path`, the
same rule as the reference: flash when the ``DCT_FLASH`` policy allows it
(:func:`flash_mode`), ``T >= 256`` and ``T`` is a multiple of the flash
blocks, else blockwise for long sequences, else dense. The policy
(``dct_tpu/ops/attention.py:232-253``), by mode and the tensor's device:

- ``auto`` (the default) and ``on``: the flash path; on a CUDA tensor it
  launches the kernel, on a CPU tensor it runs the kernel's plain version;
- ``off``: never the flash path (blockwise or dense) on a CPU tensor;
- ``interpret``: the flash path on a CPU tensor (the plain version is the
  port's interpret mode).

``DCT_FLASH_BLOCK_Q`` / ``DCT_FLASH_BLOCK_K`` (default 128) drive the
selection as the reference's do (``:884-905``): on a CPU tensor, blocks
that do not divide ``T`` degrade the call to blockwise or dense, and
blocks that do set the plain version's blocks. The CUDA kernels do not
take them as tile sizes (they pick their own: 64 rows a warpgroup, 16-64
in the streamed f32 tiles).

On a CUDA tensor a setting that would select a plain path where the
kernel runs raises, naming it: ``off``, ``interpret``, and blocks that
do not divide ``T``. So none of them turns into a quiet plain path on
the card. The sequence-parallel engines (ring, all-to-all) are not
ported.

Layouts are the reference's: q ``[B, H, T, D]``, k/v ``[B, G, T, D]`` with
``H % G == 0`` (grouped-query attention, group-major heads).
"""

from __future__ import annotations

import math
import os

import torch

NEG = -1e30  # finite "minus infinity": keeps the online max/exp NaN-free


def _check_window(window: int | None, causal: bool) -> None:
    """``None`` is full attention; a window needs causal and must be >= 1
    (a 0 band would mask every position)."""
    if window is None:
        return
    if not causal:
        raise ValueError("window requires causal attention")
    if window < 1:
        raise ValueError(
            f"window must be >= 1 (got {window}); pass None for full "
            "causal attention"
        )


def expand_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Repeat the ``G`` KV heads to the ``H`` query heads: KV head ``g``
    serves query heads ``g*H/G .. (g+1)*H/G - 1`` (group-major)."""
    h, hkv = q.shape[-3], k.shape[-3]
    if h == hkv:
        return k, v
    if h % hkv:
        raise ValueError(
            f"GQA needs q heads ({h}) divisible by kv heads ({hkv})"
        )
    group = h // hkv
    return (
        k.repeat_interleave(group, dim=-3),
        v.repeat_interleave(group, dim=-3),
    )


def _band_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
               window: int | None) -> torch.Tensor:
    """True where query ``q_pos`` may attend key ``k_pos`` (causal, and
    within the sliding window when one is set)."""
    mask = q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    return mask


def dense_attention(q, k, v, *, causal: bool = False,
                    scale: float | None = None, window: int | None = None):
    """Reference numerics: full score matrix in f32 (bf16 products are
    exact in f32, so widening the inputs first is the reference's
    ``preferred_element_type=f32``), softmax, then P.V in f32."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    _check_window(window, causal)
    k, v = expand_kv(q, k, v)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        pos_q = torch.arange(s.shape[-2], device=s.device)
        pos_k = torch.arange(s.shape[-1], device=s.device)
        s = torch.where(_band_mask(pos_q, pos_k, window), s, NEG)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def _blockwise_stats(q, k, v, *, block_size: int, causal: bool,
                     scale: float | None, window: int | None = None):
    """Online softmax over KV blocks of ``block_size``: returns the raw
    state (m, l [..., Tq] f32; o [..., Tq, D] f32). P is rounded to V's
    dtype before P.V, as the kernels do; the sums stay f32."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    _check_window(window, causal)
    k, v = expand_kv(q, k, v)
    t = k.shape[-2]
    if t % block_size:
        raise ValueError(f"seq len {t} not a multiple of block {block_size}")
    tq = q.shape[-2]
    qf = q.float()
    q_pos = torch.arange(tq, device=q.device)
    m = torch.full(q.shape[:-1], NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for k0 in range(0, t, block_size):
        kb = k[..., k0:k0 + block_size, :].float()
        vb = v[..., k0:k0 + block_size, :]
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        mask = None
        if causal:
            k_pos = torch.arange(k0, k0 + block_size, device=q.device)
            mask = _band_mask(q_pos, k_pos, window)
            s = torch.where(mask, s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        if mask is not None:
            # A fully-masked row would otherwise get p = exp(0) = 1.
            p = torch.where(mask, p, 0.0)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.matmul(
            p.to(vb.dtype).float(), vb.float()
        )
        m = m_new
    return m, l, o


def _finalize(l, o, dtype):
    return (o / torch.clamp(l, min=1e-20)[..., None]).to(dtype)


def blockwise_attention(q, k, v, *, block_size: int = 512,
                        causal: bool = False, scale: float | None = None,
                        window: int | None = None):
    """O(T)-memory attention: KV in blocks of ``block_size`` through the
    online softmax; T must be a multiple of ``block_size``."""
    m, l, o = _blockwise_stats(
        q, k, v, block_size=block_size, causal=causal, scale=scale,
        window=window,
    )
    return _finalize(l, o, q.dtype)


def blockwise_attention_lse(q, k, v, *, block_size: int = 512,
                            causal: bool = False, scale: float | None = None,
                            window: int | None = None):
    """:func:`blockwise_attention` that also returns the per-row
    log-sum-exp ``lse [..., T]`` f32."""
    m, l, o = _blockwise_stats(
        q, k, v, block_size=block_size, causal=causal, scale=scale,
        window=window,
    )
    return _finalize(l, o, q.dtype), m + torch.log(torch.clamp(l, min=1e-20))


def flash_mode() -> str:
    """The ``DCT_FLASH`` policy: ``auto`` (default; unknown words too, as
    in the reference), ``on``, ``off`` or ``interpret``."""
    mode = os.environ.get("DCT_FLASH", "auto").strip().lower()
    if mode in ("off", "0", "false", "no"):
        return "off"
    if mode in ("on", "1", "true", "yes"):
        return "on"
    if mode == "interpret":
        return "interpret"
    return "auto"


def flash_allowed(device="cpu") -> bool:
    """Whether the policy lets a tensor on ``device`` take the flash path.
    ``off`` and ``interpret`` on a CUDA device raise: both select a plain
    path, which runs on CPU tensors only."""
    mode = flash_mode()
    if torch.device(device).type == "cuda" and mode in ("off", "interpret"):
        raise ValueError(
            f"DCT_FLASH={os.environ['DCT_FLASH'].strip()} selects a plain "
            "PyTorch path, which runs on CPU tensors only; on the card set "
            "DCT_FLASH=on (the kernel) or move the tensors to the CPU "
            "(DCT_DEVICE=cpu), where DCT_FLASH=off and interpret apply"
        )
    return mode != "off"


def flash_blocks() -> tuple[int, int]:
    """``(DCT_FLASH_BLOCK_Q, DCT_FLASH_BLOCK_K)``, default 128 each."""
    return (int(os.environ.get("DCT_FLASH_BLOCK_Q", "128")),
            int(os.environ.get("DCT_FLASH_BLOCK_K", "128")))


def select_attention_path(t: int, *, block_size: int = 512,
                          flash_block: int = 128,
                          flash_min_len: int = 256, device="cpu") -> str:
    """'flash' | 'blockwise' | 'dense' for a single-shard sequence of
    length ``t`` on ``device`` (the reference's rule without its mesh
    branch, under the ``DCT_FLASH`` policy)."""
    if (flash_allowed(device) and t >= flash_min_len
            and t % flash_block == 0):
        return "flash"
    if t > block_size and t % block_size == 0:
        return "blockwise"
    return "dense"


def _check_cuda_blocks(t: int, bq: int, bk: int, block_size: int) -> None:
    """On a CUDA tensor, raise where ``DCT_FLASH_BLOCK_Q/K`` would turn a
    call that the default blocks send to the kernel into a plain path."""
    if (select_attention_path(t, block_size=block_size, device="cuda")
            == "flash" and (t % bq or t % bk)):
        raise ValueError(
            f"DCT_FLASH_BLOCK_Q={bq} / DCT_FLASH_BLOCK_K={bk} do not divide "
            f"T={t}, which selects a plain PyTorch path on CPU tensors only; "
            "the CUDA kernels pick their own tiles, so unset them on the card"
        )


def make_attention_fn(*, causal: bool = False, block_size: int = 512,
                      window: int | None = None):
    """``attn(q, k, v) -> o`` by :func:`select_attention_path` with the
    ``DCT_FLASH_BLOCK_Q/K`` blocks, read at each call as the reference
    does. On the flash path a CUDA tensor runs the kernel (or raises, as
    under a knob that would select a plain path); a CPU tensor runs the
    kernel's plain PyTorch version."""
    _check_window(window, causal)

    def attn(q, k, v):
        t = q.shape[-2]
        bq, bk = flash_blocks()
        if q.device.type == "cuda":
            _check_cuda_blocks(t, bq, bk, block_size)
        path = select_attention_path(t, block_size=block_size,
                                     flash_block=max(bq, bk),
                                     device=q.device)
        if path == "flash" and t % bq == 0 and t % bk == 0:
            from dct_tpu_torch.ops import flash_attention as fa

            return fa.flash_attention(q, k, v, causal=causal, window=window,
                                      block_q=bq, block_k=bk)
        # A flash selection whose blocks do not divide t degrades here too.
        if t > block_size and t % block_size == 0:
            return blockwise_attention(
                q, k, v, block_size=block_size, causal=causal, window=window
            )
        return dense_attention(q, k, v, causal=causal, window=window)

    return attn
