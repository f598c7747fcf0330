"""Model registry (counterpart of ``dct_tpu/models/registry.py``).

The MLP, the transformer families (the pipeline-parallel one included),
the GRU and the MoE are ported. The pipeline family always takes the
single-shard attention, as the reference's registry entry
(``dct_tpu/models/registry.py:173-200``): its stages run the flash route
on a pipe axis and replicated over seq. On a grid
whose ``seq`` axis has more than one process (``mesh``) the two
transformer families and the MoE run sequence-parallel (their attention
is the axis's engine, and each seq rank keeps its positions); the MLP
and the GRU are replicated over ``seq``, as the reference's builders
drop the mesh (``dct_tpu/models/registry.py:80-100``): every seq rank of
a data row computes the whole block, and the loss counts on seq index 0.
Models come back in eval mode, the flax modules' ``train=False``; a
trainer calls ``model.train()``.
"""

from __future__ import annotations

import torch
from torch import nn

from dct_tpu_torch.config import ModelConfig
from dct_tpu_torch.models.gru import WeatherGRU
from dct_tpu_torch.models.mlp import WeatherMLP
from dct_tpu_torch.models.moe import WeatherMoE
from dct_tpu_torch.models.transformer import (
    WeatherTransformer,
    WeatherTransformerPP,
)

SEQUENCE_MODELS = {"weather_transformer", "weather_transformer_causal",
                   "weather_transformer_pp", "weather_gru", "weather_moe"}
CAUSAL_MODELS = {"weather_transformer_causal"}


def is_sequence_model(name: str) -> bool:
    """Families trained on sliding windows of the row stream."""
    return name in SEQUENCE_MODELS


def is_causal_model(name: str) -> bool:
    return name in CAUSAL_MODELS


def get_model(cfg: ModelConfig, *, input_dim: int | None = None,
              device=None, dtype=torch.float32,
              compute_dtype=None, mesh=None) -> nn.Module:
    """Build ``cfg.name`` on ``device`` with ``dtype`` parameters computing
    in ``compute_dtype`` (default ``dtype``), with ``cfg.dropout`` and
    ``cfg.remat`` (``dct_tpu/models/registry.py:63-170, 207-231``). The
    causal family gets causal attention (with ``attn_window`` when > 0)
    and the per-position head with ``horizon``; the MoE non-causal
    attention and its routing knobs; the GRU ``hidden_dim`` and
    ``n_layers``. ``device=None`` is the
    card (``cuda:0``; :class:`~dct_tpu_torch.device.DeviceError` without
    CUDA): a CPU model is built only when ``"cpu"`` is asked for. With a
    ``mesh`` whose seq axis has more than one process, the attention of
    a transformer or the MoE is that axis's engine
    (:func:`~dct_tpu_torch.ops.attention.make_attention_fn`)."""
    from dct_tpu_torch.device import resolve_device
    from dct_tpu_torch.ops.attention import make_attention_fn

    if cfg.name != "weather_mlp" and cfg.name not in SEQUENCE_MODELS:
        raise KeyError(f"Unknown model {cfg.name!r}")
    dim = cfg.input_dim if input_dim is None else input_dim
    if dim is None:
        raise ValueError("input_dim must be provided (inferred from data)")
    if device is None:
        device = resolve_device()
    kw = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
    if cfg.name == "weather_mlp":
        return WeatherMLP(
            dim, hidden_dim=cfg.hidden_dim, num_classes=cfg.num_classes,
            dropout=cfg.dropout, **kw,
        ).eval()
    if cfg.name == "weather_gru":
        return WeatherGRU(
            dim, cfg.seq_len, hidden_dim=cfg.hidden_dim,
            n_layers=cfg.n_layers, num_classes=cfg.num_classes,
            dropout=cfg.dropout, **kw,
        ).eval()
    if cfg.name == "weather_moe":
        return WeatherMoE(
            dim, cfg.seq_len, d_model=cfg.d_model, n_heads=cfg.n_heads,
            n_layers=cfg.n_layers, d_ff=cfg.d_ff, n_experts=cfg.n_experts,
            capacity_factor=cfg.capacity_factor,
            router_aux_weight=cfg.router_aux_weight,
            num_classes=cfg.num_classes, dropout=cfg.dropout,
            attn_fn=make_attention_fn(mesh), dispatch=cfg.moe_dispatch,
            top_k=cfg.router_top_k, auto_threshold=cfg.moe_auto_threshold,
            n_kv_heads=cfg.n_kv_heads if cfg.n_kv_heads > 0 else None,
            pos_embed=cfg.pos_embed, **kw,
        ).eval()
    if cfg.name == "weather_transformer_pp":
        return WeatherTransformerPP(
            dim, cfg.seq_len, d_model=cfg.d_model, n_heads=cfg.n_heads,
            n_layers=cfg.n_layers, d_ff=cfg.d_ff,
            num_classes=cfg.num_classes, dropout=cfg.dropout,
            n_stages=cfg.n_stages, n_microbatches=cfg.n_microbatches,
            attn_fn=make_attention_fn(None), remat=cfg.remat,
            n_kv_heads=cfg.n_kv_heads if cfg.n_kv_heads > 0 else None,
            pos_embed=cfg.pos_embed, **kw,
        ).eval()
    causal = cfg.name == "weather_transformer_causal"
    window = cfg.attn_window if causal and cfg.attn_window > 0 else None
    return WeatherTransformer(
        dim, cfg.seq_len, d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_layers=cfg.n_layers, d_ff=cfg.d_ff, num_classes=cfg.num_classes,
        attn_fn=make_attention_fn(mesh, causal=causal, window=window),
        per_position=causal, horizon=cfg.horizon if causal else 1,
        n_kv_heads=cfg.n_kv_heads if cfg.n_kv_heads > 0 else None,
        pos_embed=cfg.pos_embed, dropout=cfg.dropout, remat=cfg.remat, **kw,
    ).eval()


def config_from_meta(meta: dict) -> ModelConfig:
    """A package's ``model_meta.json`` -> the :class:`ModelConfig` it was
    trained with (``model`` names the family; unknown keys are ignored)."""
    import dataclasses

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    cfg = ModelConfig(**{
        k: v for k, v in meta.items() if k in fields and k != "name"
    })
    cfg.name = meta.get("model", cfg.name)
    cfg.input_dim = int(meta["input_dim"])
    return cfg
