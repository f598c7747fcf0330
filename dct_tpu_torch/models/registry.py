"""Model registry (counterpart of ``dct_tpu/models/registry.py``).

The two transformer families are ported (served and trained). Any other
registered name of the reference raises :class:`NotImplementedError`
naming the ROADMAP item that ports it; nothing else runs in its place.
Models come back in eval mode, the flax modules' ``train=False``; a
trainer calls ``model.train()``.
"""

from __future__ import annotations

import torch

from dct_tpu_torch.config import ModelConfig
from dct_tpu_torch.models.transformer import WeatherTransformer

CAUSAL_MODELS = {"weather_transformer_causal"}

_NOT_PORTED = {
    "weather_mlp": "ROADMAP Queue A, slice 3 (the MLP/data-parallel trainer)",
    "weather_gru": "ROADMAP Queue A, slice 4 (GRU and MoE)",
    "weather_moe": "ROADMAP Queue A, slice 4 (GRU and MoE)",
    "weather_transformer_pp": "ROADMAP Queue A, slice 4 (pipeline and MPMD)",
}


def is_causal_model(name: str) -> bool:
    return name in CAUSAL_MODELS


def get_model(cfg: ModelConfig, *, input_dim: int | None = None,
              device=None, dtype=torch.float32,
              compute_dtype=None) -> WeatherTransformer:
    """Build ``cfg.name`` on ``device`` with ``dtype`` parameters computing
    in ``compute_dtype`` (default ``dtype``), with ``cfg.dropout`` and
    ``cfg.remat`` (``dct_tpu/models/registry.py:135-170, 207-231``). The
    causal family gets causal attention (with ``attn_window`` when > 0)
    and the per-position head with ``horizon``. ``device=None`` is the
    card (``cuda:0``; :class:`~dct_tpu_torch.device.DeviceError` without
    CUDA): a CPU model is built only when ``"cpu"`` is asked for."""
    from dct_tpu_torch.device import resolve_device
    from dct_tpu_torch.ops.attention import make_attention_fn

    if cfg.name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {cfg.name!r} is not ported to dct_tpu_torch yet: "
            f"{_NOT_PORTED[cfg.name]}"
        )
    if cfg.name not in ("weather_transformer", "weather_transformer_causal"):
        raise KeyError(f"Unknown model {cfg.name!r}")
    dim = cfg.input_dim if input_dim is None else input_dim
    if dim is None:
        raise ValueError("input_dim must be provided (inferred from data)")
    if device is None:
        device = resolve_device()
    causal = cfg.name == "weather_transformer_causal"
    window = cfg.attn_window if causal and cfg.attn_window > 0 else None
    return WeatherTransformer(
        dim, cfg.seq_len, d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_layers=cfg.n_layers, d_ff=cfg.d_ff, num_classes=cfg.num_classes,
        attn_fn=make_attention_fn(causal=causal, window=window),
        per_position=causal, horizon=cfg.horizon if causal else 1,
        n_kv_heads=cfg.n_kv_heads if cfg.n_kv_heads > 0 else None,
        pos_embed=cfg.pos_embed, dropout=cfg.dropout, remat=cfg.remat,
        device=device, dtype=dtype, compute_dtype=compute_dtype,
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
