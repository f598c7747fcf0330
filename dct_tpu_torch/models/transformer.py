"""Transformer family (counterpart of ``dct_tpu/models/transformer.py``).

``WeatherTransformer`` is a pre-LN encoder over ``[B, S, F]`` windows of
weather rows: a mean-pooled classifier head, or the causal family's
per-position head (``[B, S, C]``, or ``[B, S, horizon, C]`` for direct
multi-horizon forecasting). Attention is injected (``attn_fn``,
:func:`dct_tpu_torch.ops.attention.make_attention_fn`).

Parity with the flax modules, by construction:
- module names follow the flax param paths (``in_proj``, ``block_<i>/
  {ln_attn, attn/{qkv_proj, o_proj}, ln_ffn, ffn_in, ffn_out}``,
  ``ln_out``, ``head``), so :mod:`dct_tpu_torch.convert` maps keys 1:1;
- the fused qkv output is group-major ``(G, Hg + 2, Dh)``: per KV group,
  its Hg q heads, then one k and one v head;
- LayerNorm uses flax's ``epsilon=1e-6`` and takes its statistics in f32
  whatever the compute dtype; GELU is the tanh approximation;
- the sinusoidal table is added after ``in_proj`` only when
  ``pos_embed != "rope"``; RoPE rotates q and k (rotate-half pairing).

Parameters live in ``dtype`` (f32 masters in training; bf16 for a bf16
package, resident as the reference's scorer keeps them) and the forward
computes in ``compute_dtype`` (default: ``dtype``), as the flax module's
``compute_dtype`` over f32 params. LayerNorm statistics stay f32 and logits
come back f32.

Training behaviour (``transformer.py:145,151,362-366`` of the reference):
- dropout after the attention output and after ``ffn_out``, before each
  residual add, active only in training mode (``model.train()``; the
  registry hands models out in eval mode, flax's ``train=False``). Each
  mask is drawn with ``torch.rand(..., generator=g)`` from a generator
  seeded by the caller's ``dropout_key`` (the train state's dropout seed
  and the step), the layer and the site, so a step's masks depend on
  seed and step alone and a recompute draws the same mask. This is the
  contract of ``fold_in(rng, step)``, not JAX's bits;
- ``remat``: each block runs under ``torch.utils.checkpoint`` (non-
  reentrant), storing only block boundaries and recomputing the inside
  (attention forward included) in the backward.

Tensor parallelism (``dct_tpu/models/transformer.py:70-153``, the
reference's ``P(None, "model")`` and ``P("model", None)`` rules): on a
model axis of ``M`` ranks (:func:`dct_tpu_torch.parallel.sharding_rules.
shard_state_with_rules`), each attention keeps its rank's contiguous
block of the group-major qkv output, which is whole KV groups (their q
heads with their k and v head), runs the attention over its ``H/M`` local
heads and ``G/M`` KV heads (the flash kernels at that head count), and
sums its ``o_proj`` block's product over the model group before the
replicated bias; each block's ``ffn_in`` is column-parallel and its
``ffn_out`` row-parallel. ``G``, ``d_model`` and ``d_ff`` must divide by
``M`` (the placement raises, naming them). Everything between the blocks
(LayerNorms, residuals, dropout, the head) is replicated over the model
group and computed on every rank; the dropout masks depend on the key and
the data block alone, so the model ranks of a block draw the same ones.

Sequence parallelism (``dct_tpu/models/transformer.py:48-58`` with the
reference's ``ring_attention`` / ``a2a_attention``): when ``attn_fn`` is a
:class:`~dct_tpu_torch.ops.attention.SequenceParallelAttention`, each of
the ``S`` seq ranks of a block takes the ``T/S`` positions the engine
lays out for it (:meth:`~dct_tpu_torch.ops.attention.
SequenceParallelAttention.positions`: contiguous, or the striped ring's
chunks) once, at the input, and keeps them to the end: the sinusoidal
table and the rope angles are those of its global positions, each
dropout mask is the whole sequence's at those positions, every block but
attention acts per position. The mean pool sums the ranks' positions
over the seq group and divides by ``T``; the per-position logits are
gathered over the seq group and put back in sequence order. So the head
and the logits are the same on every seq rank, and the loss counts them
on seq index 0 (:func:`~dct_tpu_torch.parallel.mesh.tail_owned`).

Pipeline parallelism (``dct_tpu/models/transformer.py:155-310``):
``WeatherTransformerPP`` groups its ``n_layers`` blocks into ``n_stages``
equal stages, held in one module, ``pp_stages`` (:class:`StageStack`),
whose parameters carry a leading stage dim, the reference's stacked
``pp_stages`` leaves (``pp_stages/block_<i>/...`` ``[n_stages, ...]``).
The input projection, the positions and one dropout run before the
stages, the final LayerNorm, the mean pool and the head after them, on
every rank; the stages are deterministic. Without a pipe axis the stages
run one after another (the reference's oracle); on one (the placement
keeps a rank's own stage, :meth:`StageStack.split_pipe_axis`) they run
the GPipe schedule of :mod:`dct_tpu_torch.parallel.pipeline`, whose
batch must tile ``n_microbatches``. A stage's blocks split over the
model axis as any block does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dct_tpu_torch.models.mlp import Dropout, TorchStyleDense
from dct_tpu_torch.parallel.mesh import gather_from_seq, reduce_from_seq
from dct_tpu_torch.parallel.pipeline import pipeline_apply, sequential_apply


def sincos_positions(seq_len: int, d_model: int) -> torch.Tensor:
    """Fixed sinusoidal position table ``[S, D]`` f32 (sin on even
    columns, cos on odd), computed in numpy f32 as the reference does."""
    pos = np.arange(seq_len)[:, None].astype(np.float32)
    i = np.arange(d_model // 2)[None, :].astype(np.float32)
    ang = pos / np.power(10000.0, 2.0 * i / d_model)
    out = np.zeros((seq_len, d_model), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return torch.from_numpy(out)


def rope_tables(seq_len: int, head_dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotary cos/sin tables ``[S, Dh/2]`` f32."""
    half = head_dim // 2
    inv = 1.0 / np.power(10000.0, np.arange(half, dtype=np.float32) / half)
    ang = np.arange(seq_len, dtype=np.float32)[:, None] * inv[None, :]
    return torch.from_numpy(np.cos(ang)), torch.from_numpy(np.sin(ang))


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate q or k ``[..., T, Dh]`` by per-position angles (``[T, Dh/2]``
    tables, cast to x's dtype and broadcast over batch and heads)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = cos.to(x.dtype)
    sin = sin.to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def embed_positions(model: nn.Module, x: torch.Tensor):
    """``(h, rope, seq)``: ``model.in_proj`` of ``x`` ``[B, T, F]`` with
    its positions' sincos rows added (or, under rope, the tables its
    attention rotates by), at this seq rank's positions when
    ``model.seq_parallel`` is an engine (``seq = (positions, T)``, else
    None). The encoder families (the transformer, the MoE) share it."""
    dtype = model.compute_dtype
    sp, t = model.seq_parallel, x.shape[1]
    seq = None
    if sp is not None:  # this seq rank's positions, from here on
        pos = sp.positions(t, x.device)
        x = x.index_select(1, pos)
        seq = (pos, t)
    h = model.in_proj(x.to(dtype))
    rope = None
    if model.pos_embed == "rope":
        rope = (model.rope_cos[:t], model.rope_sin[:t])
        if seq is not None:
            rope = tuple(r.index_select(0, seq[0]) for r in rope)
    else:
        table = model.pos_table.to(dtype)
        h = h + (table if seq is None else table.index_select(0, seq[0]))
    return h, rope, seq


def mean_pool(model: nn.Module, h: torch.Tensor, t: int) -> torch.Tensor:
    """The mean of ``h`` ``[B, T', D]`` over the ``t`` positions; on a seq
    axis (``model.seq_parallel``) the ranks' sums all-reduced, in f32."""
    sp = model.seq_parallel
    if sp is None:
        return h.mean(dim=1)
    return (reduce_from_seq(h.float().sum(dim=1), sp.shard) / t).to(h.dtype)


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm``: epsilon 1e-6, statistics and affine in f32,
    output in the input's dtype."""

    def __init__(self, d: int, *, device=None, dtype=None):
        super().__init__(d, eps=1e-6, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(),
            self.bias.float(), self.eps,
        ).to(x.dtype)


class MultiHeadAttention(nn.Module):
    """Fused group-major qkv projection, injected attention, output
    projection. ``n_kv_heads`` < ``n_heads`` is grouped-query attention.
    A tensor-parallel unit (``tp_leaves``: its leaves' table specs)."""

    tp_leaves = {"qkv_proj/kernel": (None, "model"),
                 "qkv_proj/bias": ("model",),
                 "o_proj/kernel": ("model", None), "o_proj/bias": ()}

    def __init__(self, d_model: int, n_heads: int, attn_fn, *,
                 n_kv_heads: int | None = None, device=None, dtype=None,
                 compute_dtype=None):
        super().__init__()
        g = n_kv_heads or n_heads
        if n_heads % g:
            raise ValueError(
                f"n_kv_heads ({g}) must divide n_heads ({n_heads})"
            )
        self.d_model, self.n_heads, self.n_kv = d_model, n_heads, g
        self.head_dim = d_model // n_heads
        self.attn_fn = attn_fn
        kw = {"device": device, "dtype": dtype,
              "compute_dtype": compute_dtype}
        self.qkv_proj = TorchStyleDense(
            d_model, (n_heads + 2 * g) * self.head_dim, **kw
        )
        self.o_proj = TorchStyleDense(d_model, d_model, **kw)
        # Heads, KV heads and o's width on this rank (all of them unless
        # split over the model axis).
        self.local = (n_heads, g, d_model)

    def shard_model_axis(self, shard, *, split: bool) -> None:
        """Keep this rank's whole KV groups of the qkv projection and the
        matching input block of ``o_proj`` (``split``; otherwise stay
        replicated)."""
        if not split:
            return
        m = shard.size
        if self.n_kv % m:
            raise ValueError(
                f"tensor parallelism over model={m} needs whole KV groups "
                f"on every rank: n_kv_heads={self.n_kv} (n_heads="
                f"{self.n_heads}) does not divide by {m}; the reference's "
                "GSPMD would reshard, the port does not")
        self.qkv_proj.split_output(shard)
        self.o_proj.split_input(shard)
        self.local = (self.n_heads // m, self.n_kv // m, self.d_model // m)

    def forward(self, x: torch.Tensor, rope=None) -> torch.Tensor:
        b, t, _ = x.shape
        h, g, width = self.local
        hd = self.head_dim
        hg = self.n_heads // self.n_kv
        # [B, T, G, Hg+2, Dh]: per group, Hg q heads then one k and one v.
        qkv = self.qkv_proj(x).view(b, t, g, hg + 2, hd)
        q = qkv[:, :, :, :hg].reshape(b, t, h, hd).transpose(1, 2)
        k = qkv[:, :, :, hg].transpose(1, 2)  # [B, G, T, Dh]
        v = qkv[:, :, :, hg + 1].transpose(1, 2)
        if rope is not None:
            q = apply_rope(q, *rope)
            k = apply_rope(k, *rope)
        o = self.attn_fn(q.contiguous(), k.contiguous(), v.contiguous())
        o = o.transpose(1, 2).reshape(b, t, width)
        return self.o_proj(o)


class TransformerBlock(nn.Module):
    """Pre-LN residual block: attention, then a GELU feed-forward, each
    followed by dropout before its residual add. The feed-forward pair is
    a tensor-parallel unit."""

    tp_leaves = {"ffn_in/kernel": (None, "model"), "ffn_in/bias": ("model",),
                 "ffn_out/kernel": ("model", None), "ffn_out/bias": ()}

    def __init__(self, d_model: int, n_heads: int, d_ff: int, attn_fn, *,
                 dropout: float = 0.0, n_kv_heads: int | None = None,
                 device=None, dtype=None, compute_dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        ckw = dict(kw, compute_dtype=compute_dtype)
        self.ln_attn = LayerNorm(d_model, **kw)
        self.attn = MultiHeadAttention(
            d_model, n_heads, attn_fn, n_kv_heads=n_kv_heads, **ckw
        )
        self.ln_ffn = LayerNorm(d_model, **kw)
        self.ffn_in = TorchStyleDense(d_model, d_ff, **ckw)
        self.ffn_out = TorchStyleDense(d_ff, d_model, **ckw)
        self.drop = Dropout(dropout)

    def shard_model_axis(self, shard, *, split: bool) -> None:
        """Column-parallel ``ffn_in``, row-parallel ``ffn_out``
        (``split``; otherwise stay replicated)."""
        if not split:
            return
        d_ff = self.ffn_in.out_features
        if d_ff % shard.size:
            raise ValueError(
                f"tensor parallelism over model={shard.size} needs d_ff "
                f"({d_ff}) to divide by it")
        self.ffn_in.split_output(shard)
        self.ffn_out.split_input(shard)

    def forward(self, x: torch.Tensor, rope=None,
                key: tuple | None = None, seq=None) -> torch.Tensor:
        """``key``: the dropout key of this block (the model's key plus
        the layer index); each site appends its own index. ``seq``:
        ``(positions, T)`` of a seq rank's slice of the sequence."""
        h = self.attn(self.ln_attn(x), rope)
        x = x + self.drop(h, None if key is None else key + (0,), seq)
        h = F.gelu(self.ffn_in(self.ln_ffn(x)), approximate="tanh")
        h = self.ffn_out(h)
        return x + self.drop(h, None if key is None else key + (1,), seq)


class WeatherTransformer(nn.Module):
    """Encoder over ``[B, S, F]`` windows -> ``[B, C]`` logits, or with
    ``per_position`` ``[B, S, C]`` (``[B, S, horizon, C]`` when
    ``horizon > 1``). Logits are f32."""

    def __init__(self, input_dim: int, seq_len: int, *, d_model: int = 64,
                 n_heads: int = 4, n_layers: int = 2, d_ff: int = 256,
                 num_classes: int = 2, attn_fn=None,
                 per_position: bool = False, horizon: int = 1,
                 n_kv_heads: int | None = None, pos_embed: str = "sincos",
                 dropout: float = 0.1, remat: bool = False,
                 device=None, dtype=torch.float32, compute_dtype=None):
        super().__init__()
        if d_model % 2 or d_model % n_heads:
            raise ValueError(
                f"d_model={d_model} must be even (sinusoidal positions) "
                f"and divisible by n_heads={n_heads}"
            )
        if pos_embed not in ("sincos", "rope"):
            raise ValueError(
                f"pos_embed={pos_embed!r} must be 'sincos' or 'rope'"
            )
        head_dim = d_model // n_heads
        if pos_embed == "rope" and head_dim % 2:
            raise ValueError(f"rope needs an even head_dim (got {head_dim})")
        if attn_fn is None:
            from dct_tpu_torch.ops.attention import make_attention_fn

            attn_fn = make_attention_fn()
        self.compute_dtype = compute_dtype or dtype
        # The sequence-parallel engine, whose layout the forward takes.
        self.seq_parallel = attn_fn if hasattr(attn_fn, "positions") else None
        kw = {"device": device, "dtype": dtype}
        ckw = dict(kw, compute_dtype=self.compute_dtype)
        self.seq_len, self.n_layers = seq_len, n_layers
        self.per_position, self.horizon = per_position, horizon
        self.num_classes, self.pos_embed = num_classes, pos_embed
        self.remat = remat
        self.input_dim = input_dim
        self.in_proj = TorchStyleDense(input_dim, d_model, **ckw)
        for i in range(n_layers):
            self.add_module(f"block_{i}", TransformerBlock(
                d_model, n_heads, d_ff, attn_fn, dropout=dropout,
                n_kv_heads=n_kv_heads, **ckw
            ))
        self.ln_out = LayerNorm(d_model, **kw)
        head_out = num_classes * (horizon if per_position and horizon > 1 else 1)
        self.head = TorchStyleDense(d_model, head_out, **ckw)
        if pos_embed == "rope":
            cos, sin = rope_tables(seq_len, head_dim)
            self.register_buffer("rope_cos", cos.to(device), persistent=False)
            self.register_buffer("rope_sin", sin.to(device), persistent=False)
        else:
            self.register_buffer(
                "pos_table", sincos_positions(seq_len, d_model).to(device),
                persistent=False,
            )

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.n_layers)]

    def forward(self, x: torch.Tensor,
                dropout_key: tuple | None = None) -> torch.Tensor:
        """``dropout_key``: a tuple of ints (the train state's dropout
        seed and step, for instance) that seeds every dropout mask of
        this forward; needed only in training mode with dropout > 0."""
        sp, t = self.seq_parallel, x.shape[1]
        h, rope, seq = embed_positions(self, x)
        for i, block in enumerate(self.blocks()):
            key = None if dropout_key is None else tuple(dropout_key) + (i,)
            if self.remat and torch.is_grad_enabled():
                h = checkpoint(block, h, rope, key, seq, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                h = block(h, rope, key, seq)
        h = self.ln_out(h)
        if self.per_position:
            logits = self.head(h)
            if sp is not None:
                logits = gather_from_seq(logits, sp.shard).index_select(
                    1, sp.inverse(t, x.device))
            if self.horizon > 1:
                logits = logits.reshape(*logits.shape[:2], self.horizon,
                                        self.num_classes)
        else:
            logits = self.head(mean_pool(self, h, t))
        return logits.float()


class StageStack(nn.Module):
    """``pp_stages``: ``layers_per_stage`` pre-LN blocks (no dropout) whose
    parameters hold every stage's values on a leading dim, ``[n_stages,
    ...]``, or after :meth:`split_pipe_axis` this rank's stage alone.
    :meth:`run` applies one held stage, each block reading its stage's
    slices; ``forward`` applies the held stages in turn, or this rank's
    part of the pipeline schedule."""

    def __init__(self, n_stages: int, layers_per_stage: int, d_model: int,
                 n_heads: int, d_ff: int, attn_fn, *,
                 n_kv_heads: int | None = None, remat: bool = False,
                 n_microbatches: int | None = None, device=None,
                 dtype=None, compute_dtype=None):
        super().__init__()
        self.n_stages, self.layers = n_stages, layers_per_stage
        self.n_microbatches = n_microbatches
        self.remat = remat
        self.pipe = None  # this rank's PipeShard, once split
        for i in range(layers_per_stage):
            self.add_module(f"block_{i}", TransformerBlock(
                d_model, n_heads, d_ff, attn_fn, dropout=0.0,
                n_kv_heads=n_kv_heads, device=device, dtype=dtype,
                compute_dtype=compute_dtype))
        with torch.no_grad():
            for mod in self.modules():
                for attr, p in list(mod._parameters.items()):
                    mod._parameters[attr] = nn.Parameter(
                        p.detach().unsqueeze(0).repeat(
                            n_stages, *([1] * p.ndim)))

    def _slots(self, i: int) -> list:
        """(module, attribute) of every parameter of block ``i``."""
        block = getattr(self, f"block_{i}")
        return [(mod, attr) for mod in block.modules()
                for attr in mod._parameters]

    def stacked(self) -> list[torch.Tensor]:
        """The tensors the blocks read now (the parameters, or what a
        placement or a dtype rule put in their place)."""
        return [mod._parameters[attr] for i in range(self.layers)
                for mod, attr in self._slots(i)]

    def split_pipe_axis(self, shard) -> None:
        """Keep stage ``shard.index`` alone (None: keep every stage)."""
        if shard is None:
            return
        if shard.size != self.n_stages:
            raise ValueError(
                f"stacked params have {self.n_stages} stages but mesh axis "
                f"'pipe' has {shard.size} devices")
        self.keep_stage(shard.index)
        self.pipe = shard

    def keep_stage(self, j: int) -> None:
        """Hold stage ``j``'s values alone (a copy, ``[1, ...]``): a pipe
        rank's stage, or an MPMD stage's own parameters, which
        :meth:`run` applies as stage 0."""
        for i in range(self.layers):
            for mod, attr in self._slots(i):
                p = mod._parameters[attr]
                mod._parameters[attr] = nn.Parameter(
                    p.data[j:j + 1].clone())

    def _block(self, i: int, h, rope, *params):
        slots = self._slots(i)
        prev = [mod._parameters[attr] for mod, attr in slots]
        for (mod, attr), t in zip(slots, params):
            mod._parameters[attr] = t
        try:
            return getattr(self, f"block_{i}")(h, rope)
        finally:
            for (mod, attr), t in zip(slots, prev):
                mod._parameters[attr] = t

    def run(self, h: torch.Tensor, j: int, rope=None) -> torch.Tensor:
        """Held stage ``j``'s blocks over ``h`` (each under
        ``torch.utils.checkpoint`` with ``remat``)."""
        for i in range(self.layers):
            params = [mod._parameters[attr][j]
                      for mod, attr in self._slots(i)]
            if self.remat and torch.is_grad_enabled():
                h = checkpoint(self._block, i, h, rope, *params,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                h = self._block(i, h, rope, *params)
        return h

    def forward(self, h: torch.Tensor, rope=None) -> torch.Tensor:
        if self.pipe is None:
            return sequential_apply(lambda j, a: self.run(a, j, rope),
                                    self.n_stages, h)
        m = self.n_microbatches or self.pipe.size
        if h.shape[0] % m:
            from dct_tpu_torch.parallel.mesh import get_mesh

            dp = get_mesh().data_size
            raise ValueError(
                f"batch {h.shape[0] * dp} does not tile n_microbatches={m} "
                f"x data={dp} for the pipe={self.pipe.size} mesh; adjust "
                "batch_size or n_microbatches")
        return pipeline_apply(lambda a: self.run(a, 0, rope), h,
                              shard=self.pipe, n_microbatches=m,
                              params=self.stacked())


class WeatherTransformerPP(nn.Module):
    """Pipeline-parallel transformer: ``[B, S, F]`` windows -> ``[B, C]``
    f32 logits, its blocks grouped into ``n_stages`` stages (module
    docstring). The batch of a pipe world must tile ``n_microbatches``
    (default: the pipe size) or the forward raises, as the reference's
    (``dct_tpu/models/transformer.py:289-298``)."""

    def __init__(self, input_dim: int, seq_len: int, *, d_model: int = 64,
                 n_heads: int = 4, n_layers: int = 2, d_ff: int = 256,
                 num_classes: int = 2, dropout: float = 0.1,
                 n_stages: int = 2, n_microbatches: int | None = None,
                 attn_fn=None, remat: bool = False,
                 n_kv_heads: int | None = None, pos_embed: str = "sincos",
                 device=None, dtype=torch.float32, compute_dtype=None):
        super().__init__()
        if n_layers % n_stages:
            raise ValueError(
                f"n_layers={n_layers} must divide into "
                f"n_stages={n_stages} homogeneous stages"
            )
        if d_model % 2 or d_model % n_heads:
            raise ValueError(
                f"d_model={d_model} must be even (sinusoidal positions) "
                f"and divisible by n_heads={n_heads}"
            )
        if pos_embed not in ("sincos", "rope"):
            raise ValueError(
                f"pos_embed={pos_embed!r} must be 'sincos' or 'rope'"
            )
        if attn_fn is None:
            from dct_tpu_torch.ops.attention import make_attention_fn

            attn_fn = make_attention_fn()
        self.compute_dtype = compute_dtype or dtype
        self.seq_parallel = None
        kw = {"device": device, "dtype": dtype}
        ckw = dict(kw, compute_dtype=self.compute_dtype)
        self.seq_len, self.n_layers = seq_len, n_layers
        self.num_classes, self.pos_embed = num_classes, pos_embed
        self.remat, self.input_dim = remat, input_dim
        self.in_proj = TorchStyleDense(input_dim, d_model, **ckw)
        self.drop = Dropout(dropout)
        self.pp_stages = StageStack(
            n_stages, n_layers // n_stages, d_model, n_heads, d_ff, attn_fn,
            n_kv_heads=n_kv_heads, remat=remat,
            n_microbatches=n_microbatches, **ckw)
        self.ln_out = LayerNorm(d_model, **kw)
        self.head = TorchStyleDense(d_model, num_classes, **ckw)
        if pos_embed == "rope":
            cos, sin = rope_tables(seq_len, d_model // n_heads)
            self.register_buffer("rope_cos", cos.to(device), persistent=False)
            self.register_buffer("rope_sin", sin.to(device), persistent=False)
        else:
            self.register_buffer(
                "pos_table", sincos_positions(seq_len, d_model).to(device),
                persistent=False,
            )

    def blocks(self):
        return []

    def forward(self, x: torch.Tensor,
                dropout_key: tuple | None = None) -> torch.Tensor:
        """``dropout_key``: as :class:`WeatherTransformer`'s (one dropout,
        before the stages)."""
        h, rope, _ = embed_positions(self, x)
        h = self.drop(h, None if dropout_key is None
                      else tuple(dropout_key) + (0,))
        h = self.ln_out(self.pp_stages(h, rope))
        return self.head(h.mean(dim=1)).float()
