"""Configuration the serving slice reads (copied from ``dct_tpu/config.py``).

``ModelConfig`` is the reference's model configuration field for field
(``dct_tpu/config.py:62-160``), so a package's ``model_meta.json`` builds
the same architecture here. ``ServingConfig`` keeps the fields this slice
reads (``:770-860``). Both read the same ``DCT_*`` environment names.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable


def _env(name: str, default: Any, cast: Callable = str) -> Any:
    raw = os.environ.get(name)
    if raw is None:
        return default
    if cast is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    return cast(raw)


@dataclass
class ModelConfig:
    """Model architecture; the fields and defaults of the reference's
    ``ModelConfig`` (the transformer families read ``seq_len`` through
    ``pos_embed``; the others are kept so a package's meta maps 1:1)."""

    name: str = "weather_mlp"
    input_dim: int | None = None
    hidden_dim: int = 64
    num_classes: int = 2
    dropout: float = 0.2
    seq_len: int = 32
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 256
    n_experts: int = 4
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_dispatch: str = "auto"
    moe_auto_threshold: int = 1 << 21
    router_top_k: int = 1
    n_stages: int = 2
    n_microbatches: int | None = None
    # Causal family: forecast horizon (H > 1 = direct multi-horizon head).
    horizon: int = 1
    remat: bool = False
    # Causal family: sliding-window attention (0 = full causal).
    attn_window: int = 0
    # Grouped-query attention: K/V heads (0 = n_heads).
    n_kv_heads: int = 0
    # "sincos" (additive table) or "rope" (rotary q/k).
    pos_embed: str = "sincos"

    @classmethod
    def from_env(cls) -> "ModelConfig":
        c = cls()
        c.name = _env("DCT_MODEL", c.name, str)
        c.hidden_dim = _env("DCT_HIDDEN_DIM", c.hidden_dim, int)
        c.num_classes = _env("DCT_NUM_CLASSES", c.num_classes, int)
        c.dropout = _env("DCT_DROPOUT", c.dropout, float)
        c.seq_len = _env("DCT_SEQ_LEN", c.seq_len, int)
        c.d_model = _env("DCT_D_MODEL", c.d_model, int)
        c.n_heads = _env("DCT_N_HEADS", c.n_heads, int)
        c.n_layers = _env("DCT_N_LAYERS", c.n_layers, int)
        c.d_ff = _env("DCT_D_FF", c.d_ff, int)
        c.n_experts = _env("DCT_N_EXPERTS", c.n_experts, int)
        c.capacity_factor = _env("DCT_CAPACITY_FACTOR", c.capacity_factor, float)
        c.router_aux_weight = _env(
            "DCT_ROUTER_AUX_WEIGHT", c.router_aux_weight, float
        )
        c.moe_dispatch = _env("DCT_MOE_DISPATCH", c.moe_dispatch, str)
        c.moe_auto_threshold = _env(
            "DCT_MOE_AUTO_THRESHOLD", c.moe_auto_threshold, int
        )
        c.router_top_k = _env("DCT_ROUTER_TOP_K", c.router_top_k, int)
        c.n_stages = _env("DCT_N_STAGES", c.n_stages, int)
        mb = os.environ.get("DCT_N_MICROBATCHES")
        c.n_microbatches = int(mb) if mb else c.n_microbatches
        c.horizon = _env("DCT_HORIZON", c.horizon, int)
        c.remat = _env("DCT_REMAT", c.remat, bool)
        c.attn_window = _env("DCT_ATTN_WINDOW", c.attn_window, int)
        c.n_kv_heads = _env("DCT_N_KV_HEADS", c.n_kv_heads, int)
        c.pos_embed = _env("DCT_POS_EMBED", c.pos_embed, str).strip().lower()
        return c


@dataclass
class ServingConfig:
    """The micro-batcher's knobs: a flush takes up to ``max_batch`` rows,
    waiting at most ``batch_window_ms`` past the oldest queued request
    (0 = opportunistic); ``workers`` scoring threads drain the queue
    (0 = score inline on the handler thread); ``fast_parse`` parses the
    ``{"data": ...}`` envelope straight from the request bytes."""

    max_batch: int = 64
    batch_window_ms: float = 0.0
    workers: int = 2
    fast_parse: bool = True

    @classmethod
    def from_env(cls) -> "ServingConfig":
        c = cls()
        c.max_batch = _env("DCT_SERVE_MAX_BATCH", c.max_batch, int)
        c.batch_window_ms = _env(
            "DCT_SERVE_BATCH_WINDOW_MS", c.batch_window_ms, float
        )
        c.workers = _env("DCT_SERVE_WORKERS", c.workers, int)
        c.fast_parse = _env("DCT_SERVE_FAST_PARSE", c.fast_parse, bool)
        return c
