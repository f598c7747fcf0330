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
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dct_tpu_torch.models.mlp import TorchStyleDense


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


def mask_seed(key: tuple) -> int:
    """A 63-bit generator seed from a tuple of ints (dropout seed, step,
    [microbatch,] layer, site): stable across processes and devices."""
    digest = hashlib.blake2b(repr(tuple(int(k) for k in key)).encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


class Dropout(nn.Module):
    """flax ``nn.Dropout``: keep with probability ``1 - rate``, kept values
    divided by ``1 - rate``; the identity in eval mode or at rate 0. The
    mask comes from ``key`` (see :func:`mask_seed`), never from the global
    generator."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self._gen: torch.Generator | None = None

    def forward(self, x: torch.Tensor, key: tuple | None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        if key is None:
            raise ValueError(
                "dropout in training mode needs a dropout_key (the train "
                "state's seed and step)"
            )
        if self._gen is None or self._gen.device != x.device:
            self._gen = torch.Generator(device=x.device)
        self._gen.manual_seed(mask_seed(key))
        keep = torch.rand(x.shape, generator=self._gen, device=x.device) < (
            1.0 - self.rate
        )
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


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
    projection. ``n_kv_heads`` < ``n_heads`` is grouped-query attention."""

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

    def forward(self, x: torch.Tensor, rope=None) -> torch.Tensor:
        b, t, _ = x.shape
        g, hd = self.n_kv, self.head_dim
        hg = self.n_heads // g
        # [B, T, G, Hg+2, Dh]: per group, Hg q heads then one k and one v.
        qkv = self.qkv_proj(x).view(b, t, g, hg + 2, hd)
        q = qkv[:, :, :, :hg].reshape(b, t, self.n_heads, hd).transpose(1, 2)
        k = qkv[:, :, :, hg].transpose(1, 2)  # [B, G, T, Dh]
        v = qkv[:, :, :, hg + 1].transpose(1, 2)
        if rope is not None:
            q = apply_rope(q, *rope)
            k = apply_rope(k, *rope)
        o = self.attn_fn(q.contiguous(), k.contiguous(), v.contiguous())
        o = o.transpose(1, 2).reshape(b, t, self.d_model)
        return self.o_proj(o)


class TransformerBlock(nn.Module):
    """Pre-LN residual block: attention, then a GELU feed-forward, each
    followed by dropout before its residual add."""

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

    def forward(self, x: torch.Tensor, rope=None,
                key: tuple | None = None) -> torch.Tensor:
        """``key``: the dropout key of this block (the model's key plus
        the layer index); each site appends its own index."""
        h = self.attn(self.ln_attn(x), rope)
        x = x + self.drop(h, None if key is None else key + (0,))
        h = F.gelu(self.ffn_in(self.ln_ffn(x)), approximate="tanh")
        h = self.ffn_out(h)
        return x + self.drop(h, None if key is None else key + (1,))


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
        kw = {"device": device, "dtype": dtype}
        ckw = dict(kw, compute_dtype=self.compute_dtype)
        self.seq_len, self.n_layers = seq_len, n_layers
        self.per_position, self.horizon = per_position, horizon
        self.num_classes, self.pos_embed = num_classes, pos_embed
        self.remat = remat
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
        dtype = self.compute_dtype
        h = self.in_proj(x.to(dtype))
        rope = None
        if self.pos_embed == "rope":
            t = h.shape[1]
            rope = (self.rope_cos[:t], self.rope_sin[:t])
        else:
            h = h + self.pos_table.to(dtype)
        for i, block in enumerate(self.blocks()):
            key = None if dropout_key is None else tuple(dropout_key) + (i,)
            if self.remat and torch.is_grad_enabled():
                h = checkpoint(block, h, rope, key, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                h = block(h, rope, key)
        h = self.ln_out(h)
        if self.per_position:
            logits = self.head(h)
            if self.horizon > 1:
                logits = logits.reshape(*h.shape[:-1], self.horizon,
                                        self.num_classes)
        else:
            logits = self.head(h.mean(dim=1))
        return logits.float()
