"""The port's transformer against the flax one (CPU).

A flax-initialised ``WeatherTransformer`` is carried into the port with
``load_flax_weights`` and both run the same numpy windows: the JAX model
through its Pallas flash kernel in interpret mode (``DCT_FLASH=interpret``),
the port through the flash path's plain version. T=256 takes the flash path
in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_tpu.config import ModelConfig as JaxModelConfig
from dct_tpu.models.registry import get_model as jax_get_model
from dct_tpu.serving.score_gen import _flatten_params
from dct_tpu_torch.config import ModelConfig
from dct_tpu_torch.convert import flax_shapes, load_flax_weights
from dct_tpu_torch.models import transformer as tt
from dct_tpu_torch.models.registry import get_model
from dct_tpu_torch.ops import flash_attention as fa
from torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(seq_len=256, d_model=32, n_heads=2, n_layers=2, d_ff=64)

CASES = [  # (family, horizon, pos_embed, n_kv_heads, attn_window)
    ("weather_transformer", 1, "sincos", 0, 0),
    ("weather_transformer", 1, "rope", 1, 0),
    ("weather_transformer_causal", 1, "sincos", 0, 0),
    ("weather_transformer_causal", 2, "rope", 1, 0),
    ("weather_transformer_causal", 2, "sincos", 1, 48),
]


def _flax_pair(family, horizon, pos_embed, n_kv, window, seed=0):
    fields = dict(SMALL, name=family, horizon=horizon, pos_embed=pos_embed,
                  n_kv_heads=n_kv, attn_window=window)
    jmodel = jax_get_model(JaxModelConfig(**fields), input_dim=5)
    params = jmodel.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, SMALL["seq_len"], 5))
    )["params"]
    tmodel = get_model(ModelConfig(**fields), input_dim=5, device="cpu")
    return jmodel, params, tmodel


@pytest.mark.parametrize("family,horizon,pos_embed,n_kv,window", CASES)
def test_logits_match_flax_through_flash(family, horizon, pos_embed, n_kv,
                                         window, monkeypatch):
    jmodel, params, tmodel = _flax_pair(family, horizon, pos_embed, n_kv,
                                        window)
    load_flax_weights(tmodel, _flatten_params(params))
    x = np.random.default_rng(7).standard_normal(
        (2, SMALL["seq_len"], 5)
    ).astype(np.float32)
    monkeypatch.setenv("DCT_FLASH", "interpret")
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    before = fa.launches
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert fa.launches == before  # CPU tensors: the plain version ran
    assert got.shape == ref.shape
    if family == "weather_transformer_causal":
        want = (2, SMALL["seq_len"]) + ((horizon,) if horizon > 1 else ()) + (2,)
        assert got.shape == want
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_flash_path_taken_at_t256(monkeypatch):
    """Every layer's attention goes through the flash wrapper at T=256."""
    calls = []
    real = fa.flash_attention
    monkeypatch.setattr(
        fa, "flash_attention",
        lambda *a, **kw: calls.append(kw["causal"]) or real(*a, **kw),
    )
    tmodel = get_model(
        ModelConfig(name="weather_transformer_causal", **SMALL),
        input_dim=5, device="cpu",
    )
    with torch.inference_mode():
        tmodel(torch.zeros(1, SMALL["seq_len"], 5))
    assert calls == [True] * SMALL["n_layers"]


def test_qkv_layout_is_group_major():
    """The fused projection's output columns are (G, Hg+2, Dh): a
    head-major reading would permute the heads silently."""
    mha = tt.MultiHeadAttention(32, 4, lambda q, k, v: q, n_kv_heads=2)
    with torch.no_grad():
        mha.qkv_proj.weight.zero_()
        mha.qkv_proj.bias.copy_(torch.arange(mha.qkv_proj.out_features,
                                             dtype=torch.float32))
        mha.o_proj.weight.copy_(torch.eye(32))
        mha.o_proj.bias.zero_()
    out = mha(torch.zeros(1, 3, 32))  # attn_fn returns q: o = q heads
    hd = 8
    # Group 0 holds q heads 0,1 at columns [0, 16); k at 16, v at 24;
    # group 1's q heads start at column 32.
    want = torch.cat([torch.arange(0, 16), torch.arange(32, 48)]).float()
    assert torch.equal(out[0, 0], want)
    assert mha.qkv_proj.out_features == (4 + 2 * 2) * hd


def test_sincos_and_rope_tables_match_reference():
    from dct_tpu.models.transformer import rope_tables as jrope
    from dct_tpu.models.transformer import sincos_positions as jsincos

    assert np.array_equal(tt.sincos_positions(64, 32).numpy(),
                          jsincos(64, 32))
    cos, sin = tt.rope_tables(64, 16)
    jcos, jsin = jrope(64, 16)
    assert np.array_equal(cos.numpy(), jcos) and np.array_equal(sin.numpy(), jsin)


def test_layernorm_is_flax_layernorm():
    from flax import linen as nn

    x = np.random.default_rng(1).standard_normal((3, 32)).astype(np.float32)
    ln = tt.LayerNorm(32)
    assert ln.eps == 1e-6
    ref = nn.LayerNorm().apply(
        {"params": {"scale": jnp.ones(32), "bias": jnp.zeros(32)}},
        jnp.asarray(x),
    )
    np.testing.assert_allclose(ln(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(ref), atol=1e-5)


def test_load_flax_weights_is_strict():
    _, params, tmodel = _flax_pair("weather_transformer", 1, "sincos", 0, 0)
    flat = _flatten_params(params)
    assert set(flat) == set(flax_shapes(tmodel))
    assert {k: v.shape for k, v in flat.items()} == flax_shapes(tmodel)
    missing = dict(flat)
    missing.pop("block_1/ffn_out/bias")
    with pytest.raises(KeyError, match="missing"):
        load_flax_weights(tmodel, missing)
    extra = dict(flat, **{"block_2/ffn_out/bias": flat["block_1/ffn_out/bias"]})
    with pytest.raises(KeyError, match="unexpected"):
        load_flax_weights(tmodel, extra)
    bad = dict(flat, **{"head/kernel": flat["head/kernel"].T})
    with pytest.raises(ValueError, match="head/kernel"):
        load_flax_weights(tmodel, bad)
    load_flax_weights(tmodel, flat)
    np.testing.assert_array_equal(
        tmodel.block_0.attn.qkv_proj.weight.detach().numpy(),
        flat["block_0/attn/qkv_proj/kernel"].T,
    )
    np.testing.assert_array_equal(
        tmodel.block_1.ln_ffn.weight.detach().numpy(),
        flat["block_1/ln_ffn/scale"],
    )


@pytest.mark.parametrize("family", [
    "weather_gru", "weather_moe", "weather_transformer_pp",
])
def test_registry_refuses_unported_families(family):
    """The GRU, the MoE and the pipeline family, each refused until it
    was ported, now build."""
    from dct_tpu_torch.models.gru import WeatherGRU
    from dct_tpu_torch.models.moe import WeatherMoE
    from dct_tpu_torch.models.transformer import WeatherTransformerPP

    model = get_model(ModelConfig(name=family), input_dim=5, device="cpu")
    assert isinstance(model, {"weather_gru": WeatherGRU,
                              "weather_moe": WeatherMoE,
                              "weather_transformer_pp":
                                  WeatherTransformerPP}[family])


def test_registry_unknown_family():
    with pytest.raises(KeyError):
        get_model(ModelConfig(name="weather_nope"), input_dim=5, device="cpu")


@pytest.mark.parametrize("family", ["weather_transformer",
                                    "weather_transformer_causal"])
def test_registry_default_device_is_the_card(family, monkeypatch):
    """``device=None`` resolves to ``cuda:0`` or raises; it never builds a
    CPU model in silence (ROADMAP Queue C)."""
    from dct_tpu_torch.device import DeviceError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(name=family, **SMALL)
    with pytest.raises(DeviceError, match="device='cpu'"):
        get_model(cfg, input_dim=5)
    model = get_model(cfg, input_dim=5, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}


def test_bf16_model_tracks_f32_model():
    """bf16 compute (a bf16 package's path) stays within the bf16 band
    of the f32 forward on the same weights."""
    _, params, tmodel = _flax_pair("weather_transformer_causal", 1, "sincos",
                                   0, 0)
    flat = _flatten_params(params)
    load_flax_weights(tmodel, flat)
    bmodel = get_model(
        ModelConfig(name="weather_transformer_causal", **SMALL),
        input_dim=5, device="cpu", dtype=torch.bfloat16,
    )
    load_flax_weights(bmodel, flat)
    assert bmodel.head.weight.dtype == torch.bfloat16
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, SMALL["seq_len"], 5)).astype(np.float32))
    with torch.inference_mode():
        p32 = torch.softmax(tmodel(x), -1)
        p16 = torch.softmax(bmodel(x), -1)
    assert p16.dtype == torch.float32
    assert (p32 - p16).abs().max().item() < 2e-2
