"""The port's CUDA kernels, served model and train step on the card.

Each test needs a CUDA card of compute capability 9.0 and skips without
one (the kernels have no CPU mode). The file imports no JAX, so it runs on a
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


# The f32 forward runs 3xTF32 on the tensor cores, whose products lose about
# 2^-22 of their size against the plain version's f32 products; a single
# TF32 pass keeps 11 bits of each operand and loses 2^-11. 1e-5 on o and lse
# holds the first and refuses the second.
F32_FWD_TOL = 1e-5


@pytest.mark.parametrize(
    "causal,window,g,d,q_scale",
    [(*case, 1.0) for case in CASES]
    + [(False, None, 4, 64, 3.0)],  # larger scores, a sharper softmax
)
def test_f32_forward_within_3xtf32_tolerance(card, causal, window, g, d,
                                             q_scale):
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's f32
    q, k, v = _qkv(15, g, d, torch.float32, card)
    q = q * q_scale
    o, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                return_lse=True)
    po, plse = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert (o - po).abs().max().item() <= F32_FWD_TOL
    assert (lse - plse).abs().max().item() <= F32_FWD_TOL


def test_kernel_ragged_length_matches_plain(card):
    """T not a multiple of the kernel's 64-row tiles: the loop masks the
    ragged edge (block sizes chosen so the wrapper accepts T=200)."""
    q, k, v = _qkv(7, 2, 64, torch.float32, card, t=200)
    o = fa.flash_attention(q, k, v, causal=True, block_q=40, block_k=40)
    po, _ = fa.flash_attention_plain(q, k, v, causal=True, block_k=40)
    assert (o - po).abs().max().item() <= 1e-4


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_kernel_ragged_length_matches_plain(card, causal):
    """The tensor-core forward at T=200: the cp.async ring zero-fills the
    rows past T and the edge tiles mask them."""
    q, k, v = _qkv(7, 2, 64, torch.bfloat16, card, t=200)
    o, lse = fa.flash_attention(q, k, v, causal=causal, block_q=40,
                                block_k=40, return_lse=True)
    po, plse = fa.flash_attention_plain(q, k, v, causal=causal, block_k=40)
    assert (o.float() - po.float()).abs().max().item() <= 2e-2
    assert (lse - plse).abs().max().item() <= 1e-4


@pytest.mark.parametrize("window", [2, 16])
def test_bf16_window_with_fully_masked_rows(card, window):
    """A window narrower than a tile leaves rows with no key in a tile the
    loop visits (window 2: nearly every row of an off-diagonal tile):
    those rows add nothing, forward and backward. (Window 1 makes dK
    analytically zero -- dP - delta cancels -- so its relative error
    would compare rounding noise with rounding noise.)"""
    t = 200
    q, k, v = _qkv(12, 2, 64, torch.bfloat16, card, t=t)
    o, lse = fa.flash_attention(q, k, v, causal=True, window=window,
                                block_q=40, block_k=40, return_lse=True)
    po, plse = fa.flash_attention_plain(q, k, v, causal=True, window=window,
                                        block_k=40)
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    assert (o.float() - po.float()).abs().max().item() <= 2e-2
    assert (lse - plse).abs().max().item() <= 1e-4
    args = _bwd_inputs(13, 2, 64, torch.bfloat16, card, t=t, causal=True,
                       window=window, block=40)
    dk, dv = fa.flash_bwd_dkdv(*args, causal=True, window=window)
    want = fa.flash_attention_bwd_plain(*args, causal=True, window=window,
                                        block_q=40, block_k=40)
    for got, ref in zip((dk, dv), want[1:]):
        assert _rel_err(got, ref) <= 1e-2


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


def _bwd_inputs(seed, g, d, dtype, device, t=T, causal=False, window=None,
                block=128):
    q, k, v = _qkv(seed, g, d, dtype, device, t=t)
    rng = np.random.default_rng(seed + 100)
    do = torch.from_numpy(rng.standard_normal((B, H, t, d)).astype(
        np.float32)).to(device=device, dtype=dtype)
    o, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                return_lse=True, block_q=block, block_k=block)
    return q, k, v, o, lse, do


def _rel_err(got, ref):
    """max|got - ref| / max|ref|."""
    ref = ref.float()
    return ((got.float() - ref).abs().max()
            / max(ref.abs().max().item(), 1e-30)).item()


# Backward tolerances, relative to each output's max: f32 differs by
# summation order only; a bf16 output by at most one step of bf16 (2^-7 of
# the largest value), where a dropped 64-row tile would err by far more.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window,g,d", CASES)
def test_bwd_kernels_match_plain(card, causal, window, g, d, dtype):
    args = _bwd_inputs(9, g, d, dtype, card, causal=causal, window=window)
    before = fa.launch_counts()
    dk, dv = fa.flash_bwd_dkdv(*args, causal=causal, window=window)
    dq = fa.flash_bwd_dq(*args, causal=causal, window=window)
    torch.cuda.synchronize()
    after = fa.launch_counts()
    assert after["flash_bwd_dkdv"] == before["flash_bwd_dkdv"] + 1
    assert after["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    want = fa.flash_attention_bwd_plain(*args, causal=causal, window=window)
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == dtype and got.shape == ref.shape
        assert _rel_err(got, ref) <= BWD_TOL[dtype]


# The f32 backward runs 3xTF32 on the tensor cores: about 2^-22 of each
# product is lost, where a single TF32 pass keeps 11 bits of each operand
# and loses about 2^-11 (5e-4) of each, above this 1e-4 gate.
@pytest.mark.parametrize(
    "causal,window,g,d,q_scale",
    [(*case, 1.0) for case in CASES]
    + [(False, None, 4, 64, 3.0)],  # larger scores, a sharper softmax
)
def test_f32_bwd_within_3xtf32_tolerance(card, causal, window, g, d,
                                         q_scale):
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's f32
    q, k, v, _, _, do = _bwd_inputs(17, g, d, torch.float32, card,
                                    causal=causal, window=window)
    q = q * q_scale
    o, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                return_lse=True)
    args = (q, k, v, o, lse, do)
    dk, dv = fa.flash_bwd_dkdv(*args, causal=causal, window=window)
    dq = fa.flash_bwd_dq(*args, causal=causal, window=window)
    want = fa.flash_attention_bwd_plain(*args, causal=causal, window=window)
    for got, ref in zip((dq, dk, dv), want):
        assert _rel_err(got, ref) <= BWD_TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernels_ragged_length_match_plain(card, dtype):
    """T=200 is not a multiple of the kernels' 64-row tiles."""
    args = _bwd_inputs(10, 2, 64, dtype, card, t=200, causal=True, block=40)
    dk, dv = fa.flash_bwd_dkdv(*args, causal=True)
    dq = fa.flash_bwd_dq(*args, causal=True)
    want = fa.flash_attention_bwd_plain(*args, causal=True, block_q=40,
                                        block_k=40)
    for got, ref in zip((dq, dk, dv), want):
        assert _rel_err(got, ref) <= BWD_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal,window,g,d", CASES)
def test_bf16_dkdv_is_bitwise_deterministic(card, causal, window, g, d,
                                            dtype):
    """One block sums a KV tile's whole GQA group in a fixed order (no
    atomics): two launches give the same bits, in bf16 and in f32."""
    args = _bwd_inputs(14, g, d, dtype, card, causal=causal, window=window)
    first = fa.flash_bwd_dkdv(*args, causal=causal, window=window)
    second = fa.flash_bwd_dkdv(*args, causal=causal, window=window)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal,window,g,d", CASES)
def test_bf16_dq_is_bitwise_deterministic(card, causal, window, g, d, dtype):
    """One block owns its dQ tile and sums the KV tiles in a fixed order
    (no atomics): two launches give the same bits, in bf16 and in f32."""
    args = _bwd_inputs(16, g, d, dtype, card, causal=causal, window=window)
    first = fa.flash_bwd_dq(*args, causal=causal, window=window)
    second = fa.flash_bwd_dq(*args, causal=causal, window=window)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_gradients_flow_through_the_kernels(card):
    """Regression: the kernel's output once carried no grad_fn, so nothing
    upstream of attention (qkv_proj, ln_attn) received a gradient."""
    from dct_tpu_torch.config import ModelConfig
    from dct_tpu_torch.models.registry import get_model

    q, k, v = (t.requires_grad_() for t in _qkv(11, 2, 64, torch.float32,
                                                  card))
    o = fa.flash_attention(q, k, v, causal=True)
    assert isinstance(o.grad_fn, fa.FlashAttention._backward_cls)
    model = get_model(ModelConfig(name="weather_transformer", seq_len=T,
                                  d_model=64, n_heads=2, n_layers=2,
                                  d_ff=128, dropout=0.0),
                      input_dim=5, device=card).train()
    fa.reset_launches()
    model(torch.randn(2, T, 5, device=card)).sum().backward()
    assert fa.launch_counts() == {"flash_fwd": 2, "flash_bwd_dkdv": 2,
                                  "flash_bwd_dq": 2}
    for block in model.blocks():
        for p in (block.attn.qkv_proj.weight, block.ln_attn.weight):
            assert p.grad is not None and p.grad.abs().max().item() > 0


@pytest.mark.parametrize("family", ["weather_transformer",
                                    "weather_transformer_causal"])
def test_train_step_on_card_matches_cpu(card, family):
    from dct_tpu_torch.config import ModelConfig
    from dct_tpu_torch.models.registry import get_model
    from dct_tpu_torch.train.state import create_train_state
    from dct_tpu_torch.train.steps import loss_and_grads

    cfg = ModelConfig(name=family, seq_len=T, d_model=64, n_heads=2,
                      n_layers=2, d_ff=128, n_kv_heads=1, dropout=0.0)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((3, T, 5)).astype(np.float32)
    shape = (3, T) if family == "weather_transformer_causal" else (3,)
    y = rng.integers(0, 2, shape).astype(np.int32)
    w = np.array([1.0, 1.0, 0.0], np.float32)
    torch.backends.cuda.matmul.allow_tf32 = False
    results = []
    for device in ("cpu", card):
        state = create_train_state(
            get_model(cfg, input_dim=5, device=device), input_dim=5, lr=1e-3,
            seed=5)
        results.append(loss_and_grads(state, x, y, w))
    (loss_c, grads_c), (loss_g, grads_g) = results
    assert abs(loss_g.item() - loss_c.item()) <= 1e-5 * abs(loss_c.item())
    # cuBLAS and the CPU sum in other orders; a small gradient that is a
    # cancelling sum of large terms (a bias) differs by ~1e-4 of its own
    # max, so each gradient is held to 1e-3 of its max.
    for a, b in zip(grads_g, grads_c):
        scale = b.abs().max().item()
        assert (a.cpu() - b).abs().max().item() <= 1e-3 * max(scale, 1e-30)
