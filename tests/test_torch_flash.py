"""The port's flash attention against the JAX package's (CPU).

The plain PyTorch version of the CUDA kernel is held against the Pallas
kernel run in interpret mode, against ``flash_attention_lse`` and against
``dense_attention``, on the same numpy inputs. The wrapper's CPU path and
its refusals are pinned here; the kernel itself runs only on the card
(``tests/test_torch_cuda.py``; ``chip_smoke.py`` holds it against the
plain version at the serving shape).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_tpu.ops.attention import dense_attention as jax_dense
from dct_tpu.ops.pallas_attention import flash_attention as jax_flash
from dct_tpu.ops.pallas_attention import flash_attention_lse as jax_flash_lse
from dct_tpu_torch.ops import flash_attention as fa
from dct_tpu_torch.ops.attention import (
    blockwise_attention,
    dense_attention,
    make_attention_fn,
    select_attention_path,
)

B, H, G, T, D = 1, 4, 2, 256, 16
TOL = {"f32": 1e-5, "bf16": 2e-2}

CASES = [  # (causal, window, kv heads)
    (False, None, H),
    (True, None, H),
    (True, 64, H),
    (False, None, G),
    (True, None, G),
    (True, 100, G),
]


def _inputs(seed, g, t=T, d=D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, t, d)).astype(np.float32)
    k = rng.standard_normal((B, g, t, d)).astype(np.float32)
    v = rng.standard_normal((B, g, t, d)).astype(np.float32)
    return q, k, v


def _as(dtype, *arrays):
    if dtype == "f32":
        return [torch.from_numpy(a) for a in arrays], [
            jnp.asarray(a) for a in arrays
        ]
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrays], [
        jnp.asarray(a, jnp.bfloat16) for a in arrays
    ]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# The kernels' head dims on the main path (64) and the widest (128): the
# plain version the kernels are held to on the card is itself held to the
# reference there.
WIDE_CASES = [  # (head dim, causal, window, kv heads)
    (64, False, None, G),
    (64, True, 100, G),
    (128, True, None, H),
    (128, True, 64, H),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal,window,g", CASES)
def test_plain_matches_pallas_interpret(causal, window, g, dtype):
    _check_plain_against_pallas(causal, window, g, dtype, D)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d,causal,window,g", WIDE_CASES)
def test_plain_matches_pallas_interpret_wide_heads(d, causal, window, g,
                                                   dtype):
    _check_plain_against_pallas(causal, window, g, dtype, d)


def _check_plain_against_pallas(causal, window, g, dtype, d):
    (tq, tk, tv), (jq, jk, jv) = _as(dtype, *_inputs(1, g, d=d))
    o, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    ref = jax_flash(jq, jk, jv, block_q=128, block_k=128, causal=causal,
                    interpret=True, window=window)
    assert o.dtype == tq.dtype and o.shape == (B, H, T, d)
    np.testing.assert_allclose(_np(o), _np(ref), atol=TOL[dtype])
    ref_o, ref_lse = jax_flash_lse(jq, jk, jv, block_q=128, block_k=128,
                                   causal=causal, interpret=True,
                                   window=window)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, T)
    np.testing.assert_allclose(_np(o), _np(ref_o), atol=TOL[dtype])
    np.testing.assert_allclose(_np(lse), _np(ref_lse), atol=1e-5)


@pytest.mark.parametrize("causal,window,g", CASES)
def test_plain_and_paths_match_jax_dense(causal, window, g):
    (tq, tk, tv), (jq, jk, jv) = _as("f32", *_inputs(2, g))
    ref = _np(jax_dense(jq, jk, jv, causal=causal, window=window))
    o, _ = fa.flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(_np(o), ref, atol=1e-5)
    np.testing.assert_allclose(
        _np(dense_attention(tq, tk, tv, causal=causal, window=window)),
        ref, atol=1e-5,
    )
    np.testing.assert_allclose(
        _np(blockwise_attention(tq, tk, tv, block_size=64, causal=causal,
                                window=window)),
        ref, atol=1e-5,
    )


def test_wrapper_on_cpu_takes_the_plain_path():
    (tq, tk, tv), _ = _as("f32", *_inputs(3, G))
    before = fa.launches
    o, lse = fa.flash_attention(tq, tk, tv, causal=True, window=64,
                                return_lse=True)
    po, plse = fa.flash_attention_plain(tq, tk, tv, causal=True, window=64)
    assert torch.equal(o, po) and torch.equal(lse, plse)
    assert torch.equal(fa.flash_attention(tq, tk, tv),
                       fa.flash_attention_plain(tq, tk, tv)[0])
    assert fa.launches == before  # no kernel was launched


def test_wrapper_refusals():
    (tq, tk, tv), _ = _as("f32", *_inputs(4, G))
    with pytest.raises(NotImplementedError, match="q_offset"):
        fa.flash_attention(tq, tk, tv, causal=True, q_offset=128)
    with pytest.raises(ValueError, match="square"):
        fa.flash_attention(tq, tk[:, :, :128], tv[:, :, :128], causal=True)
    with pytest.raises(NotImplementedError, match="rectangular"):
        fa.flash_attention(tq, tk[:, :, :128], tv[:, :, :128])
    q24 = torch.zeros(B, H, T, 24)
    kv24 = torch.zeros(B, G, T, 24)
    with pytest.raises(ValueError, match="head dim 24"):
        fa.flash_attention(q24, kv24, kv24)
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention(tq, tk, tv, window=64)
    with pytest.raises(TypeError):
        fa.flash_attention(tq.half(), tk.half(), tv.half())
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(tq, tk, tv, block_q=96)


@pytest.mark.parametrize("t,path", [
    (32, "dense"), (256, "flash"), (384, "flash"), (200, "dense"),
    (1024, "flash"), (1536, "flash"), (1000, "dense"),
])
def test_path_rule_matches_reference(t, path, monkeypatch):
    from dct_tpu.ops.attention import select_attention_path as jax_select

    assert select_attention_path(t) == path
    # The reference takes flash only where a flash engine is configured;
    # with interpret mode on, its rule is the port's.
    monkeypatch.setenv("DCT_FLASH", "interpret")
    assert jax_select(t) == path


def test_attention_fn_routes_flash_through_the_wrapper(monkeypatch):
    calls = []
    real = fa.flash_attention

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention", spy)
    (tq, tk, tv), _ = _as("f32", *_inputs(5, G))
    attn = make_attention_fn(causal=True, window=32)
    o = attn(tq, tk, tv)
    assert len(calls) == 1 and calls[0]["causal"] and calls[0]["window"] == 32
    ref = dense_attention(tq, tk, tv, causal=True, window=32)
    np.testing.assert_allclose(_np(o), _np(ref), atol=1e-5)
    attn(tq[:, :, :64], tk[:, :, :64], tv[:, :, :64])  # dense path
    assert len(calls) == 1
