"""Attention paths (counterpart of ``dct_tpu/ops/attention.py``).

- :func:`dense_attention`: the full [Tq, Tk] score matrix, the reference
  numerics and the oracle the other paths are tested against;
- :func:`blockwise_attention`: online softmax over KV blocks, O(T) memory;
- the flash path, :func:`dct_tpu_torch.ops.flash_attention.flash_attention`:
  the hand-written CUDA kernel on a CUDA tensor, its plain PyTorch version
  on a CPU tensor;
- the sequence-parallel engines over the grid's ``seq`` axis
  (:mod:`dct_tpu_torch.parallel.mesh`): :func:`ring_attention` (the KV
  shard rotates round the seq ranks, one :func:`~dct_tpu_torch.parallel.
  mesh.ring_shift` a step, and the per-step results merge by their lse)
  and :func:`a2a_attention` (two all-to-all exchanges trade the sequence
  shard for a head shard around one full-length call).

:func:`make_attention_fn` picks one by :func:`select_attention_path`, the
same rule as the reference: an engine (``DCT_SP_ENGINE``) when the grid's
``seq`` axis has more than one process, else flash when the ``DCT_FLASH``
policy allows it (:func:`flash_mode`), ``T >= 256`` and ``T`` is a
multiple of the flash blocks, else blockwise for long sequences, else
dense. The policy (``dct_tpu/ops/attention.py:232-253``), by mode and the
tensor's device:

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
the card.

The engines take the per-rank shards ``[B/D, H/M, T/S, D]`` (K/V at their
``G/M`` heads) and keep the reference's bodies (``:491-595``,
``:599-859``): the ring's block compute is the flash kernel with its
lse, per step -- contiguous (a causal step is the diagonal, fully visible
or invisible), windowed (partial-band steps shifted by ``q_offset``, the
ring cut after :func:`_ring_window_steps`) or striped
(:func:`striped_layout`: two half-chunk blocks a step, rectangular where
a half meets a whole shard). On a CUDA tensor every shard the kernel
wrapper takes runs there, and a layout it does not take (a windowed
striped ring, a shard that is no whole number of clamped 128-blocks)
raises. On a CPU tensor the reference's rules pick the flash path for a
kernel-aligned shard and the plain online-softmax :func:`_ring_body`
(the reference's JAX-level body) for the rest, and ``DCT_FLASH=off``
takes the plain body everywhere; a2a likewise runs the kernel at full
``T`` on the card and the reference's flash, blockwise or dense choice on
the CPU. A rank whose step is invisible computes nothing but still
sends and receives. The merge is :func:`_merge_lse` in PyTorch, so
autograd carries the lse's cotangent into the backward kernels. The
striped layout is the model's: its input is permuted once
(:class:`SequenceParallelAttention`), where the reference takes and
untakes the sequence around every call (``:728-733``); every op outside
attention acts per position or is order-free, so the two agree.

Layouts are the reference's: q ``[B, H, T, D]``, k/v ``[B, G, T, D]`` with
``H % G == 0`` (grouped-query attention, group-major heads).
"""

from __future__ import annotations

import math
import os

import numpy as np
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


def _online_block(q, k, v, scale, mask, m, l, o):
    """Fold one KV block into the running online-softmax state (m, l
    [..., Tq] f32; o [..., Tq, D] f32; ``dct_tpu/ops/attention.py:45-73``)
    under an optional boolean ``mask``: P is rounded to V's dtype before
    P.V, as the kernels do, and a fully-masked row keeps P = 0."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        s = torch.where(mask, s, NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha[..., None] + torch.matmul(p.to(v.dtype).float(),
                                               v.float())
    return m_new, l_new, o_new


def _blockwise_stats(q, k, v, *, block_size: int, causal: bool,
                     scale: float | None, window: int | None = None,
                     q_offset: int = 0):
    """Online softmax over KV blocks of ``block_size``
    (:func:`_online_block`): returns the raw state (m, l, o). ``q_offset``
    shifts the q positions against k's (the windowed ring's partial-band
    shards, ``dct_tpu/ops/attention.py:152-229``)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    _check_window(window, causal)
    k, v = expand_kv(q, k, v)
    t = k.shape[-2]
    if t % block_size:
        raise ValueError(f"seq len {t} not a multiple of block {block_size}")
    tq = q.shape[-2]
    q_pos = q_offset + torch.arange(tq, device=q.device)
    m = torch.full(q.shape[:-1], NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for k0 in range(0, t, block_size):
        mask = None
        if causal:
            k_pos = torch.arange(k0, k0 + block_size, device=q.device)
            mask = _band_mask(q_pos, k_pos, window)
        m, l, o = _online_block(q, k[..., k0:k0 + block_size, :],
                                v[..., k0:k0 + block_size, :], scale, mask,
                                m, l, o)
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
                            window: int | None = None, q_offset: int = 0):
    """:func:`blockwise_attention` that also returns the per-row
    log-sum-exp ``lse [..., Tq]`` f32, q row ``r`` at position
    ``q_offset + r``; the flash kernels' plain forward."""
    m, l, o = _blockwise_stats(
        q, k, v, block_size=block_size, causal=causal, scale=scale,
        window=window, q_offset=q_offset,
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


def select_attention_path(t: int, *, mesh=None, block_size: int = 512,
                          flash_block: int = 128,
                          flash_min_len: int = 256, device="cpu") -> str:
    """'ring' | 'a2a' | 'flash' | 'blockwise' | 'dense': an engine on a
    grid whose ``seq`` axis has more than one process, else the path of a
    single-shard sequence of length ``t`` on ``device`` under the
    ``DCT_FLASH`` policy (the reference's rule)."""
    if mesh is not None and mesh.shape.get("seq", 1) > 1:
        return sp_engine()
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


def make_attention_fn(mesh=None, *, causal: bool = False,
                      block_size: int = 512, window: int | None = None):
    """``attn(q, k, v) -> o`` by :func:`select_attention_path`: on a grid
    whose ``seq`` axis has more than one process, a
    :class:`SequenceParallelAttention` of the ``DCT_SP_ENGINE`` engine;
    otherwise the single-shard path with the ``DCT_FLASH_BLOCK_Q/K``
    blocks, read at each call as the reference does. On the flash path a
    CUDA tensor runs the kernel (or raises, as under a knob that would
    select a plain path); a CPU tensor runs the kernel's plain PyTorch
    version."""
    _check_window(window, causal)
    if mesh is not None and mesh.shape.get("seq", 1) > 1:
        return SequenceParallelAttention(mesh, causal=causal, window=window,
                                         block_size=block_size)

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


# ------------------------------------------------ sequence parallelism


def sp_engine() -> str:
    """The sequence-parallel engine policy (``DCT_SP_ENGINE``,
    :class:`~dct_tpu_torch.config.SeqParallelConfig`): ``ring`` (default:
    the KV shards rotate, O(T/S) memory) or ``a2a`` (the head<->sequence
    all-to-all exchange)."""
    from dct_tpu_torch.config import SeqParallelConfig

    return SeqParallelConfig.from_env().engine


def striped_layout(t: int, ring_size: int):
    """Striped ("zigzag") sequence layout for the balanced causal ring:
    ``t`` positions in ``2R`` chunks, rank ``i`` holding chunks ``(i,
    2R-1-i)``. Under a causal mask every rank's visible work is then two
    half-shard blocks at every ring step:

    - step 0 (src == my): diag(A_my) + full(B_my, A_my) + diag(B_my)
    - src < my:            full(A_my, A_src) + full(B_my, A_src)
    - src > my:            full(B_my, A_src) + full(B_my, B_src)

    (A_i = chunk i, B_i = chunk 2R-1-i.) Returns ``(perm, inv)`` int
    arrays: ``x[..., perm, :]`` is the striped order, ``o[..., inv, :]``
    undoes it."""
    if t % (2 * ring_size):
        raise ValueError(
            f"striped layout needs seq len {t} % {2 * ring_size} == 0"
        )
    c = t // (2 * ring_size)
    order = []
    for i in range(ring_size):
        order.extend(range(i * c, (i + 1) * c))
        j = 2 * ring_size - 1 - i
        order.extend(range(j * c, (j + 1) * c))
    perm = np.asarray(order, np.int32)
    inv = np.argsort(perm).astype(np.int32)
    return perm, inv


def _merge_lse(o, lse, o_j, lse_j):
    """Fold a finalized (o_j, lse_j) block into the running (o f32, lse)
    pair: the softmax-weighted combine, the online-softmax update
    factored across finished results."""
    lse_new = torch.logaddexp(lse, lse_j)
    w = torch.exp(lse - lse_new)[..., None]
    w_j = torch.exp(lse_j - lse_new)[..., None]
    return o * w + o_j.float() * w_j, lse_new


def _ring_window_steps(window: int | None, t_local: int,
                       ring_size: int) -> int:
    """The contiguous ring steps a causal window can see: step ``s >= 1``
    takes the shard ``s`` hops back, whose least q-k distance is
    ``(s-1) t_local + 1``; once that reaches ``window`` every later shard
    is out of band on every rank, so both the compute and the shifts
    stop."""
    if window is None:
        return ring_size
    return min(ring_size, (window - 1 + t_local - 1) // t_local + 1)


def _flash_aligned(*extents: int) -> bool:
    """Whether the flash wrapper takes every one of ``extents`` at its
    default blocks: a whole number of clamped blocks ``min(128, e)`` (the
    reference's interpret rule)."""
    return all(e >= 1 and e % min(128, e) == 0 for e in extents)


def _kernel_route(device, aligned: bool, what: str) -> bool:
    """Whether an engine's block compute is the flash path. On a CUDA
    tensor it is the kernel or a raise (the policy's ``off`` and
    ``interpret`` raise in :func:`flash_allowed`; a layout the wrapper
    does not take, ``what``, raises here), never a plain path. On a CPU
    tensor ``aligned`` (the reference's rule) and the policy decide."""
    on = flash_allowed(device)
    if torch.device(device).type != "cuda":
        return on and aligned
    if not aligned:
        raise ValueError(
            f"{what} has no flash kernel body, and the plain PyTorch path "
            "that the CPU takes there runs on CPU tensors only; pick a "
            "sequence length whose per-rank shards are whole numbers of "
            "min(128, shard) rows, or another DCT_RING_STRIPED/DCT_SP_ENGINE "
            "(ragged shards and the windowed striped band on the card: "
            "ROADMAP Queue A item 16b)"
        )
    return True


def ring_flash(t_local: int, *, striped: bool, window: int | None,
               device) -> bool:
    """Whether the ring's block compute on shards of ``t_local`` is the
    flash path (:func:`_kernel_route`). The striped body takes an
    unwindowed ring whose half and whole shards the wrapper takes; the
    contiguous one takes any shard the wrapper takes on the card, and a
    multiple of 128 on the CPU (the reference's rule)."""
    if striped:
        return _kernel_route(
            device, window is None and _flash_aligned(t_local // 2, t_local),
            f"the striped ring (T/S={t_local}, window={window})")
    aligned = (_flash_aligned(t_local)
               if torch.device(device).type == "cuda"
               else t_local % 128 == 0 and t_local >= 128)
    return _kernel_route(device, aligned,
                         f"the contiguous ring (T/S={t_local})")


def a2a_flash(t: int, device) -> bool:
    """Whether a2a's full-length call is the flash path
    (:func:`_kernel_route`): any ``T`` the wrapper takes on the card, a
    multiple of 128 on the CPU (the reference's rule)."""
    aligned = (_flash_aligned(t) if torch.device(device).type == "cuda"
               else t % 128 == 0 and t >= 128)
    return _kernel_route(device, aligned, f"a2a at T={t}")


def ring_striped(t: int, ring_size: int, *, causal: bool,
                 window: int | None, device,
                 striped: bool | None = None) -> bool:
    """Whether the ring runs the striped layout for a sequence of ``t``
    over ``ring_size`` ranks: ``striped`` when given (True needs causal
    and an even shard), else ``DCT_RING_STRIPED``: ``auto`` (default)
    stripes a causal, unwindowed ring whose half shard is kernel-aligned
    on the flash path; ``on`` stripes every causal ring; ``off`` keeps
    the contiguous layout (``dct_tpu/ops/attention.py:663-711``)."""
    t_local = t // ring_size
    if striped is not None:
        if striped and not causal:
            raise ValueError("striped ring layout only applies to causal")
        if striped and t_local % 2:
            raise ValueError(
                f"striped ring needs T/ring ({t_local}) even; got T={t}, "
                f"ring={ring_size}")
        return bool(striped)
    from dct_tpu_torch.config import SeqParallelConfig

    mode = SeqParallelConfig.from_env().ring_striped
    if mode == "off":
        return False
    if mode == "on":
        if causal and ring_size > 1 and t_local % 2:
            raise ValueError(
                f"striped ring needs T/ring ({t_local}) even; got T={t}, "
                f"ring={ring_size}")
        return bool(causal and ring_size > 1)
    return bool(causal and window is None and ring_size > 1
                and t_local % 2 == 0
                and flash_allowed(device)
                and _flash_aligned(t_local // 2, t_local))


def _flash_lse(q, k, v, *, causal=False, scale, window=None, q_offset=0):
    """One block of a ring step: ``(o, lse)`` of the flash path (the
    kernels take contiguous tensors; a half shard is a strided view)."""
    from dct_tpu_torch.ops import flash_attention as fa

    return fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=causal, scale=scale, window=window,
                              q_offset=q_offset, return_lse=True)


class _Tie(torch.autograd.Function):
    """``o`` unchanged, with ``kv`` as an input whose gradient is zero. A
    rank whose last ring steps are invisible uses none of their shifted
    KV, so autograd would skip their shifts' backward there while the
    other ranks run theirs; tying the last KV to the output makes every
    rank run the same backward shifts, in the same order."""

    @staticmethod
    def forward(ctx, o, kv):
        ctx.kv_meta = (kv.shape, kv.dtype, kv.device)
        return o.view_as(o)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.kv_meta
        return g, torch.zeros(shape, dtype=dtype, device=device)


def _ring_body_flash(q, k, v, *, shard, causal: bool, scale: float,
                     window: int | None):
    """The ring with the flash kernel as its block compute
    (``dct_tpu/ops/attention.py:386-471``), on this rank's contiguous
    shards. Step 0 is the diagonal shard; a causal step ``s >= 1`` is
    fully visible on ranks ``my >= s`` and invisible elsewhere, where
    nothing is computed. With a window, a partial-band step runs the
    windowed kernel with ``q_offset = s T_local`` and the ring stops after
    :func:`_ring_window_steps`."""
    from dct_tpu_torch.parallel.mesh import ring_shift

    my, t_local = shard.index, q.shape[-2]
    n_steps = _ring_window_steps(window, t_local, shard.size)
    kv = torch.stack([k, v])  # one shift a step for K and V together
    o = lse = None
    for step in range(n_steps):
        k_cur, v_cur = kv
        if step == 0:
            w = window if window is not None and window < t_local else None
            o_j, lse_j = _flash_lse(q, k_cur, v_cur, causal=causal,
                                    scale=scale, window=w)
            o, lse = o_j.float(), lse_j
        elif not causal:
            o, lse = _merge_lse(o, lse, *_flash_lse(
                q, k_cur, v_cur, scale=scale))
        elif my >= step:
            if window is not None and (step + 1) * t_local - 1 >= window:
                o_j, lse_j = _flash_lse(q, k_cur, v_cur, causal=True,
                                        scale=scale, window=window,
                                        q_offset=step * t_local)
            else:
                o_j, lse_j = _flash_lse(q, k_cur, v_cur, scale=scale)
            o, lse = _merge_lse(o, lse, o_j, lse_j)
        if step < n_steps - 1:
            kv = ring_shift(kv, shard)
    return _Tie.apply(o, kv).to(q.dtype)


def _ring_body_flash_striped(q, k, v, *, shard, scale: float):
    """The balanced causal ring on the striped layout with the flash
    kernel (``:474-534``): each rank's shard is chunk ``my`` then chunk
    ``2R-1-my``; every step costs two half-chunk blocks, at step ``s >=
    1`` one rectangular call: both q halves against the source's first
    half (``src < my``) or the second q half against the whole source
    shard (``src > my``)."""
    from dct_tpu_torch.parallel.mesh import ring_shift

    my, half = shard.index, q.shape[-2] // 2
    q1, q2 = q[..., :half, :], q[..., half:, :]
    k1, v1 = k[..., :half, :], v[..., :half, :]
    k2, v2 = k[..., half:, :], v[..., half:, :]
    o1, lse1 = _flash_lse(q1, k1, v1, causal=True, scale=scale)
    o1 = o1.float()
    o2a, lse2a = _flash_lse(q2, k1, v1, scale=scale)
    o2, lse2 = _merge_lse(o2a.float(), lse2a,
                          *_flash_lse(q2, k2, v2, causal=True, scale=scale))
    kv = torch.stack([k, v])
    for step in range(1, shard.size):
        kv = ring_shift(kv, shard)
        k_cur, v_cur = kv
        if my >= step:  # src < my: both halves see A_src, none B_src
            oa, la = _flash_lse(q, k_cur[..., :half, :],
                                v_cur[..., :half, :], scale=scale)
            o1, lse1 = _merge_lse(o1, lse1, oa[..., :half, :],
                                  la[..., :half])
            o2, lse2 = _merge_lse(o2, lse2, oa[..., half:, :],
                                  la[..., half:])
        else:  # src > my: A_my sees nothing, B_my the whole shard
            o2, lse2 = _merge_lse(o2, lse2, *_flash_lse(
                q2, k_cur, v_cur, scale=scale))
    return _Tie.apply(torch.cat([o1, o2], dim=-2), kv).to(q.dtype)


def _ring_body(q, k, v, *, shard, causal: bool, scale: float,
               striped: bool = False, window: int | None = None):
    """The plain online-softmax ring (``:537-595``), for CPU shards the
    flash path does not take (:func:`_kernel_route`): the causal mask (and window) on the global
    positions of either layout; a contiguous windowed ring stops after
    :func:`_ring_window_steps`, and a windowed step that the band fully
    masks computes nothing."""
    from dct_tpu_torch.parallel.mesh import ring_shift

    my, n, t_local = shard.index, shard.size, q.shape[-2]
    n_steps = n if striped else _ring_window_steps(window, t_local, n)
    dev = q.device

    def positions(rank):
        if not striped:
            return rank * t_local + torch.arange(t_local, device=dev)
        c = t_local // 2
        return torch.cat([rank * c + torch.arange(c, device=dev),
                          (2 * n - 1 - rank) * c
                          + torch.arange(c, device=dev)])

    q_pos = positions(my)
    m = torch.full(q.shape[:-1], NEG, dtype=torch.float32, device=dev)
    l = torch.zeros(q.shape[:-1], dtype=torch.float32, device=dev)
    o = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    kv = torch.stack([k, v])
    for step in range(n_steps):
        mask = None
        if causal:
            mask = _band_mask(q_pos, positions((my - step) % n), window)
        if (window is None or not (striped or step > 0)
                or bool(mask.any())):
            ke, ve = expand_kv(q, *kv)
            m, l, o = _online_block(q, ke, ve, scale, mask, m, l, o)
        if step < n_steps - 1:
            kv = ring_shift(kv, shard)
    return _finalize(l, _Tie.apply(o, kv), q.dtype)


def _seq_shard(mesh):
    shard = mesh.seq_shard()
    if shard is None:
        raise ValueError(f"the grid {mesh.shape} has no seq axis to "
                         "run a sequence-parallel engine over")
    return shard


def ring_attention(q, k, v, *, mesh, causal: bool = False,
                   scale: float | None = None, striped: bool | None = None,
                   window: int | None = None):
    """Ring attention over the grid's ``seq`` axis
    (``dct_tpu/ops/attention.py:599-762``) on this rank's shards: q
    ``[B, H, T/S, D]`` and k/v ``[B, G, T/S, D]`` holding its positions
    of the layout :func:`ring_striped` picks (contiguous: ``T/S``
    consecutive positions; striped: chunks ``my`` and ``2S-1-my``); o
    comes back in the same layout. ``striped`` as the reference's: None
    follows ``DCT_RING_STRIPED``. The block compute follows
    :func:`_kernel_route`: the flash kernel on a CUDA tensor (or a
    raise), the reference's choice on a CPU tensor."""
    _check_window(window, causal)
    shard = _seq_shard(mesh)
    t_local = q.shape[-2]
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    striped = ring_striped(t_local * shard.size, shard.size, causal=causal,
                           window=window, device=q.device, striped=striped)
    flash = ring_flash(t_local, striped=striped, window=window,
                       device=q.device)
    if striped:
        if flash:
            return _ring_body_flash_striped(q, k, v, shard=shard,
                                            scale=scale)
        return _ring_body(q, k, v, shard=shard, causal=True, scale=scale,
                          striped=True, window=window)
    if flash:
        return _ring_body_flash(q, k, v, shard=shard, causal=causal,
                                scale=scale, window=window)
    return _ring_body(q, k, v, shard=shard, causal=causal, scale=scale,
                      window=window)


def a2a_attention(q, k, v, *, mesh, causal: bool = False,
                  scale: float | None = None, block_size: int = 512,
                  window: int | None = None):
    """All-to-all (Ulysses-style) sequence parallelism
    (``dct_tpu/ops/attention.py:765-859``) on this rank's contiguous
    shards q ``[B, H, T/S, D]``, k/v ``[B, G, T/S, D]``: one exchange
    trades the sequence shard for a head shard (``[B, H/S, T, D]``), the
    single-shard path runs at full ``T`` (:func:`_kernel_route`: the flash
    kernel on a CUDA tensor; on a CPU tensor its plain version when the
    policy allows it and ``T`` is a multiple of 128, else blockwise or
    dense), and a second exchange
    restores the layout. q, k and v travel in one exchange. ``H`` and
    ``G`` must divide by ``S``."""
    from dct_tpu_torch.parallel.mesh import heads_to_seq, seq_to_heads

    _check_window(window, causal)
    shard = _seq_shard(mesh)
    s = shard.size
    b, h, t_local, d = q.shape
    g, t = k.shape[1], t_local * s
    if h % s or g % s:
        raise ValueError(
            f"a2a_attention: the seq axis ({s}) must divide the local heads "
            f"(H={h}, kv heads {g}); adjust heads/seq_len or the mesh, or "
            "use DCT_SP_ENGINE=ring")
    # [B, S, heads/S, T/S, D] per tensor, concatenated on the head axis, so
    # row j of the exchange carries head group j of q, k and v.
    parts = [x.reshape(b, s, x.shape[1] // s, t_local, d) for x in (q, k, v)]
    full = seq_to_heads(torch.cat(parts, dim=2).reshape(b, -1, t_local, d),
                        shard)
    ql, kl, vl = torch.split(full, [h // s, g // s, g // s], dim=1)
    ql, kl, vl = ql.contiguous(), kl.contiguous(), vl.contiguous()
    if a2a_flash(t, q.device):
        from dct_tpu_torch.ops import flash_attention as fa

        out = fa.flash_attention(ql, kl, vl, causal=causal, scale=scale,
                                 window=window)
    elif t > block_size and t % block_size == 0:
        out = blockwise_attention(ql, kl, vl, block_size=block_size,
                                  causal=causal, scale=scale, window=window)
    else:
        out = dense_attention(ql, kl, vl, causal=causal, scale=scale,
                              window=window)
    return heads_to_seq(out, shard)


class SequenceParallelAttention:
    """``attn(q, k, v)`` over the grid's ``seq`` axis by ``DCT_SP_ENGINE``
    (read when built), on this rank's shards, and the layout its caller
    must give it: :meth:`positions` are the global positions this rank
    holds (contiguous, or striped where the ring stripes), :meth:`inverse`
    puts the ranks' gathered positions back in order. The transformer
    takes its input at :meth:`positions` once and keeps that layout to
    the end. The layout of a length is decided at its first use and kept
    (its index tensors too: building them on the card in every forward
    would synchronize the stream), and the ring is told it."""

    def __init__(self, mesh, *, causal: bool = False,
                 window: int | None = None, block_size: int = 512):
        self.mesh, self.causal, self.window = mesh, causal, window
        self.block_size = block_size
        self.engine = sp_engine()
        self.shard = _seq_shard(mesh)
        self._layouts: dict = {}

    def _layout(self, t: int, device):
        """(striped, this rank's positions, the inverse order) for a
        sequence of ``t`` on ``device``."""
        key = (t, str(device))
        if key not in self._layouts:
            s, i = self.shard.size, self.shard.index
            if t % s:
                raise ValueError(f"seq len {t} does not split over seq={s}")
            striped = self.engine == "ring" and ring_striped(
                t, s, causal=self.causal, window=self.window, device=device)
            order, inv = (striped_layout(t, s) if striped
                          else (np.arange(t), np.arange(t)))
            n = t // s
            self._layouts[key] = (striped, *(
                torch.as_tensor(a, dtype=torch.long, device=device)
                for a in (order[i * n:(i + 1) * n], inv)))
        return self._layouts[key]

    def positions(self, t: int, device) -> torch.Tensor:
        """This rank's ``T/S`` global positions."""
        return self._layout(t, device)[1]

    def inverse(self, t: int, device) -> torch.Tensor:
        """Where each position sits in the seq ranks' order of holding
        them: the gathered ranks' values taken at it come back in sequence
        order."""
        return self._layout(t, device)[2]

    def __call__(self, q, k, v):
        if self.engine == "a2a":
            return a2a_attention(q, k, v, mesh=self.mesh, causal=self.causal,
                                 window=self.window,
                                 block_size=self.block_size)
        striped = self._layout(q.shape[-2] * self.shard.size, q.device)[0]
        return ring_attention(q, k, v, mesh=self.mesh, causal=self.causal,
                              window=self.window, striped=striped)
