"""The port's CUDA kernel and served model on the card.

Each test needs a CUDA card of compute capability 9.0 and skips without
one (the kernel has no CPU mode). The file imports no JAX, so it runs on a
machine with the card and no JAX (``tests/conftest.py`` imports JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from dct_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

B, H, T = 2, 4, 256
CASES = [  # (causal, window, kv heads, head dim)
    (False, None, 4, 64),
    (True, None, 4, 64),
    (True, 100, 2, 64),
    (False, None, 2, 16),
    (True, None, 1, 32),
    (True, 64, 4, 128),
]


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda:0")


def _qkv(seed, g, d, dtype, device, t=T):
    rng = np.random.default_rng(seed)
    shapes = ((B, H, t, d), (B, g, t, d), (B, g, t, d))
    return [
        torch.from_numpy(rng.standard_normal(s).astype(np.float32))
        .to(device=device, dtype=dtype)
        for s in shapes
    ]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window,g,d", CASES)
def test_kernel_matches_plain(card, causal, window, g, d, dtype):
    q, k, v = _qkv(6, g, d, dtype, card)
    before = fa.launches
    o, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                return_lse=True)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert o.dtype == dtype and o.shape == q.shape and lse.shape == (B, H, T)
    po, plse = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (o.float() - po.float()).abs().max().item() <= tol
    assert (lse - plse).abs().max().item() <= 1e-4


def test_kernel_ragged_length_matches_plain(card):
    """T not a multiple of the kernel's 64-row tiles: the loop masks the
    ragged edge (block sizes chosen so the wrapper accepts T=200)."""
    q, k, v = _qkv(7, 2, 64, torch.float32, card, t=200)
    o = fa.flash_attention(q, k, v, causal=True, block_q=40, block_k=40)
    po, _ = fa.flash_attention_plain(q, k, v, causal=True, block_k=40)
    assert (o - po).abs().max().item() <= 1e-4


def test_kernel_refuses_non_contiguous(card):
    q, k, v = _qkv(8, 4, 64, torch.float32, card)
    k_strided = k.transpose(1, 2).contiguous().transpose(1, 2)
    assert k_strided.shape == k.shape and not k_strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, k_strided, v)


def test_served_model_on_card_matches_cpu(card):
    from dct_tpu_torch.serving.batching import TorchScorer
    from dct_tpu_torch.serving.package import init_package_weights

    meta = dict(model="weather_transformer_causal", input_dim=5, seq_len=T,
                d_model=64, n_heads=2, n_layers=2, d_ff=128, num_classes=2,
                horizon=2, n_kv_heads=1)
    weights = init_package_weights(meta, seed=1)
    x = np.random.default_rng(2).standard_normal((3, T, 5)).astype(np.float32)
    gpu = TorchScorer(weights, meta, card)
    fa.reset_launches()
    probs = gpu(x)
    assert fa.launches == meta["n_layers"] and gpu.forwards == 1
    cpu = TorchScorer(weights, meta, "cpu")
    np.testing.assert_allclose(probs, cpu(x), atol=1e-4)
