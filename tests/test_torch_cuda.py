"""The port's CUDA kernels, served model and train step on the card.

Each test needs a CUDA card of compute capability 9.0 and skips without
one (the kernels have no CPU mode). The file imports no JAX, so it runs on a
machine with the card and no JAX (``tests/conftest.py`` imports JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""

import os

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


@pytest.mark.parametrize("engine", ["einsum", "sorted"])
def test_moe_forward_and_train_step_on_card_match_cpu(card, engine):
    """The MoE at T=256 (flash path) on the card against the CPU path on
    the same weights: logits within 1e-4, the train objective (aux
    included) within 1e-5, each gradient within 1e-3 of its max (as the
    transformer's), and 2 + 2 + 2 launches a train step."""
    from dct_tpu_torch.config import ModelConfig
    from dct_tpu_torch.models.registry import get_model
    from dct_tpu_torch.train.state import create_train_state
    from dct_tpu_torch.train.steps import loss_and_grads

    cfg = ModelConfig(name="weather_moe", seq_len=T, d_model=64, n_heads=2,
                      n_layers=2, d_ff=128, n_experts=4, capacity_factor=0.5,
                      router_top_k=2, moe_dispatch=engine, dropout=0.0)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((3, T, 5)).astype(np.float32)
    y = rng.integers(0, 2, (3,)).astype(np.int32)
    w = np.array([1.0, 1.0, 0.0], np.float32)
    torch.backends.cuda.matmul.allow_tf32 = False
    results = []
    for device in ("cpu", card):
        state = create_train_state(
            get_model(cfg, input_dim=5, device=device), input_dim=5, lr=1e-3,
            seed=5)
        fa.reset_launches()
        loss, grads = loss_and_grads(state, x, y, w)
        counts = fa.launch_counts()
        state.model.eval()
        with torch.no_grad():
            logits = state.model(torch.from_numpy(x).to(device)).cpu()
        engines = [b.moe.last_engine for b in state.model.blocks()]
        results.append((loss, grads, counts, logits, engines))
    (loss_c, grads_c, counts_c, logits_c, eng_c), \
        (loss_g, grads_g, counts_g, logits_g, eng_g) = results
    assert counts_c == {"flash_fwd": 0, "flash_bwd_dkdv": 0,
                        "flash_bwd_dq": 0}
    assert counts_g == {"flash_fwd": 2, "flash_bwd_dkdv": 2,
                        "flash_bwd_dq": 2}
    assert eng_c == eng_g == [engine, engine]
    assert (logits_g - logits_c).abs().max().item() <= 1e-4
    assert abs(loss_g.item() - loss_c.item()) <= 1e-5 * abs(loss_c.item())
    for a, b in zip(grads_g, grads_c):
        scale = b.abs().max().item()
        assert (a.cpu() - b).abs().max().item() <= 1e-3 * max(scale, 1e-30)


def test_gru_forward_on_card_matches_cpu(card):
    """The GRU (plain tensor ops, no kernel) on the card: f32 logits
    within 1e-5 of the CPU's, no flash launch."""
    from dct_tpu_torch.config import ModelConfig
    from dct_tpu_torch.convert import init_flax_weights, load_flax_weights
    from dct_tpu_torch.models.registry import get_model

    cfg = ModelConfig(name="weather_gru", seq_len=32, hidden_dim=64,
                      n_layers=2)
    x = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (5, 32, 5)).astype(np.float32))
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for device in ("cpu", card):
        model = get_model(cfg, input_dim=5, device=device)
        load_flax_weights(model, init_flax_weights(model, 3))
        fa.reset_launches()
        with torch.no_grad():
            out.append(model(x.to(device)).cpu())
        assert fa.launches == 0
    assert (out[1] - out[0]).abs().max().item() <= 1e-5


def test_pp_sequential_stack_on_card_matches_cpu(card):
    """``weather_transformer_pp`` (two stages of two blocks, T=256) on one
    card runs its stages one after another on the flash kernels: f32
    logits within 1e-4 of the CPU's and the stage leaves' gradients
    within 1e-3 of their largest, 4 forward, 4 dK/dV and 4 dQ launches."""
    from dct_tpu_torch.config import ModelConfig
    from dct_tpu_torch.convert import init_flax_weights, load_flax_weights
    from dct_tpu_torch.models.registry import get_model

    cfg = ModelConfig(name="weather_transformer_pp", seq_len=T, d_model=64,
                      n_heads=4, n_layers=4, d_ff=128, n_stages=2,
                      dropout=0.0)
    x = torch.from_numpy(np.random.default_rng(17).standard_normal(
        (4, T, 5)).astype(np.float32))
    torch.backends.cuda.matmul.allow_tf32 = False
    out, grads = [], []
    for device in ("cpu", card):
        model = get_model(cfg, input_dim=5, device=device)
        load_flax_weights(model, init_flax_weights(model, 3))
        fa.reset_launches()
        logits = model(x.to(device))
        logits.float().square().sum().backward()
        if device != "cpu":
            torch.cuda.synchronize()
            assert fa.launch_counts() == {"flash_fwd": 4,
                                          "flash_bwd_dkdv": 4,
                                          "flash_bwd_dq": 4}
        out.append(logits.detach().cpu())
        grads.append(model.pp_stages.block_1.attn.qkv_proj.weight.grad.cpu())
    assert (out[1] - out[0]).abs().max().item() <= 1e-4
    scale = grads[0].abs().max().item()
    assert (grads[1] - grads[0]).abs().max().item() <= 1e-3 * scale


# C1: head dims between the kernel instances run through the zero-padded
# instance above them (8 -> 16, 48 -> 64), the scale of the true D kept.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,d", [(False, 8), (True, 48)])
def test_padded_head_dims_match_plain(card, causal, d, dtype):
    q, k, v = _qkv(21, 2, d, dtype, card)
    o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    po, plse = fa.flash_attention_plain(q, k, v, causal=causal)
    assert o.shape == (B, H, T, d)
    tol = F32_FWD_TOL if dtype == torch.float32 else 2e-2
    assert (o.float() - po.float()).abs().max().item() <= tol
    assert (lse - plse).abs().max().item() <= 1e-4
    args = _bwd_inputs(22, 2, d, dtype, card, causal=causal)
    dk, dv = fa.flash_bwd_dkdv(*args, causal=causal)
    dq = fa.flash_bwd_dq(*args, causal=causal)
    want = fa.flash_attention_bwd_plain(*args, causal=causal)
    for got, ref in zip((dq, dk, dv), want):
        assert got.shape == ref.shape and got.is_contiguous()
        assert _rel_err(got, ref) <= BWD_TOL[dtype]


# C2: B*H = 65536 rows of blocks, one past gridDim.y's limit, on x now.
# The bf16 kernels decode a linear block id and the f32 kernels read
# blockIdx directly, so both dtypes run past the old limit.
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_grid_beyond_65535_heads_matches_plain(card, dtype):
    b, h, t, d = 8192, 8, 128, 16
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's f32
    gen = torch.Generator(device=card).manual_seed(3)
    q, k, v, do = (torch.randn(b, h, t, d, generator=gen, device=card,
                               dtype=dtype) for _ in range(4))
    o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    po, plse = fa.flash_attention_plain(q, k, v, causal=True)
    tol = F32_FWD_TOL if dtype == torch.float32 else 2e-2
    assert (o.float() - po.float()).abs().max().item() <= tol
    assert (lse - plse).abs().max().item() <= 1e-4
    del po, plse
    dk, dv = fa.flash_bwd_dkdv(q, k, v, o, lse, do, causal=True)
    dq = fa.flash_bwd_dq(q, k, v, o, lse, do, causal=True)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
    for got, ref in zip((dq, dk, dv), want):
        assert _rel_err(got, ref) <= BWD_TOL[dtype]


def test_trainer_fit_mlp_on_card(card, tmp_path):
    from dct_tpu_torch.config import DataConfig, ModelConfig, RunConfig
    from dct_tpu_torch.config import TrainConfig
    from dct_tpu_torch.data.dataset import WeatherArrays
    from dct_tpu_torch.tracking.client import LocalTracking
    from dct_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(0)
    x = rng.standard_normal((400, 5)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.int32)
    cfg = RunConfig(data=DataConfig(models_dir=str(tmp_path / "m")),
                    model=ModelConfig(name="weather_mlp"),
                    train=TrainConfig(epochs=1))
    res = Trainer(cfg, tracker=LocalTracking(root=str(tmp_path / "r"))).fit(
        WeatherArrays(x, y, [f"f{i}_norm" for i in range(5)]))
    assert all(p.device.type == "cuda" for p in res.state.params)
    assert np.isfinite(res.val_loss)
    names = os.listdir(tmp_path / "m")
    assert "last.ckpt" in names and os.path.exists(res.best_model_path)
    assert os.path.exists(tmp_path / "m" / "train_state" / "p0" / "state"
                          / "state.npz")


def test_gate_torch_engine_on_card_matches_numpy_engine(card):
    from dct_tpu_torch.evaluation import harness
    from dct_tpu_torch.serving.package import init_package_weights

    meta = {"model": "weather_transformer", "input_dim": 5, "seq_len": 256,
            "d_model": 64, "n_heads": 4, "n_layers": 2, "d_ff": 128,
            "num_classes": 2, "dropout": 0.0}
    weights = init_package_weights(meta, 4)
    x = np.random.default_rng(5).standard_normal((20, 256, 5)).astype(
        np.float32)
    fa.reset_launches()
    got = harness.batched_probs(weights, meta, x, batch_size=8,
                                engine="torch")
    assert fa.launch_counts()["flash_fwd"] == 2 * 3  # layers x chunks
    want = harness.batched_probs(weights, meta, x, batch_size=8)
    assert got.shape == want.shape == (20, 2)
    assert float(np.abs(got - want).max()) <= 1e-4


_NO_PYARROW = (
    "import sys\n"
    "class Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] == 'pyarrow':\n"
    "            raise ImportError('pyarrow is blocked')\n"
    "sys.meta_path.insert(0, Block())\n"
)


def test_parquet_round_trip_and_train_job_without_pyarrow(card, tmp_path):
    """C3 on the card: the port's ETL writes the processed dir, its codec
    reads it back, and ``python -m dct_tpu_torch.train_job`` trains from
    it, in processes where importing pyarrow fails."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if not k.startswith("DCT_")}
    env.update(PYTHONPATH=repo, DCT_PROCESSED_DIR=str(tmp_path / "proc"),
               DCT_MODELS_DIR=str(tmp_path / "models"),
               DCT_TRACKING_DIR=str(tmp_path / "mlruns"), DCT_EPOCHS="2",
               DCT_BATCH_SIZE="32")
    etl = _NO_PYARROW + (
        "import numpy as np\n"
        "from dct_tpu_torch.data.synthetic import generate_weather_csv\n"
        "from dct_tpu_torch.etl import parquet\n"
        "from dct_tpu_torch.etl.preprocess import preprocess_csv_to_parquet\n"
        f"d = {str(tmp_path)!r}\n"
        "csv = generate_weather_csv(d + '/raw.csv', rows=1200, seed=2)\n"
        "out = preprocess_csv_to_parquet(csv, d + '/proc')\n"
        "t = parquet.read_table(out)\n"
        "assert len(t['label_encoded']) == 1200\n"
        "cols = {'x': np.arange(9.0), 'y': np.arange(9, dtype=np.int32)}\n"
        "parquet.write_table(d + '/rt.parquet', cols)\n"
        "back = parquet.read_table(d + '/rt.parquet')\n"
        "assert all(np.array_equal(back[k], v) and back[k].dtype == v.dtype\n"
        "           for k, v in cols.items())\n"
        "assert 'pyarrow' not in sys.modules\n"
    )
    r = subprocess.run([sys.executable, "-c", etl], env=env,
                       cwd=str(tmp_path), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    job = _NO_PYARROW + (
        "import runpy\n"
        "try:\n"
        "    runpy.run_module('dct_tpu_torch.train_job', run_name='__main__')\n"
        "finally:\n"
        "    assert 'pyarrow' not in sys.modules\n"
    )
    r = subprocess.run([sys.executable, "-c", job], env=env,
                       cwd=str(tmp_path), capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert "device=cuda:0" in r.stdout and "done: val_loss" in r.stdout
    assert os.path.exists(tmp_path / "models" / "last.ckpt")


def test_supervised_crash_drill_on_card_heals_to_the_uninterrupted_run(
        card, tmp_path):
    """A small transformer world on cuda:0 under the supervisor, crashed at
    epoch 1 and relaunched, ends with the train state of an uninterrupted
    world: bitwise, or within the 0.03 val-loss band."""
    import json
    import subprocess
    import sys

    from dct_tpu_torch.data.synthetic import generate_weather_csv
    from dct_tpu_torch.etl.preprocess import preprocess_csv_to_parquet
    from dct_tpu_torch.launch.launcher import LocalProcessLauncher

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    csv = generate_weather_csv(str(tmp_path / "raw.csv"), rows=1200, seed=2)
    preprocess_csv_to_parquet(csv, str(tmp_path / "proc"))

    def world(name, **extra):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("DCT_")}
        env.update(PYTHONPATH=repo, DCT_PROCESSED_DIR=str(tmp_path / "proc"),
                   DCT_MODELS_DIR=str(tmp_path / name / "models"),
                   DCT_TRACKING_DIR=str(tmp_path / name / "mlruns"),
                   DCT_EVENTS_DIR=str(tmp_path / name / "events"),
                   DCT_HEARTBEAT_DIR=str(tmp_path / name / "hb"),
                   DCT_EPOCHS="2", DCT_BATCH_SIZE="16",
                   DCT_MODEL="weather_transformer", DCT_SEQ_LEN="256",
                   DCT_D_MODEL="64", DCT_N_HEADS="4", DCT_N_LAYERS="2",
                   DCT_D_FF="128", **extra)
        res = LocalProcessLauncher(stagger_seconds=0.0, timeout=600.0,
                                   poll_seconds=0.05).supervise(
            [sys.executable, "-m", "dct_tpu_torch.train_job"], world_size=1,
            env=env, backoff_s=0.1, jitter=0.0)
        assert res.success, res
        with np.load(tmp_path / name / "models" / "train_state" / "p0"
                     / "state" / "state.npz") as npz:
            leaves = [npz[str(i)] for i in range(len(npz.files))]
        with open(tmp_path / name / "events" / "events.jsonl") as f:
            events = [json.loads(x) for x in f]
        return res, leaves, events

    res, drill, events = world("drill", DCT_FAULT_SPEC="crash@rank0:epoch1")
    assert [a.classification for a in res.attempts] == ["crash", "success"]
    assert [e["epoch"] for e in events if e["event"] == "epoch_end"] == [0, 1]
    _, clean, clean_events = world("clean")
    if not all(np.array_equal(a, b) for a, b in zip(drill, clean)):
        vl = [[e["val_loss"] for e in ev if e["event"] == "epoch_end"][-1]
              for ev in (events, clean_events)]
        assert abs(vl[0] - vl[1]) <= 0.03, vl


def test_two_tenant_inline_session_on_card_launches_the_kernels(
        card, tmp_path, monkeypatch):
    """Two inline tenants of a small transformer (T=256) time-share
    cuda:0 under the scheduler: both tenants' rounds launch the three
    kernels, each gate consult the forward kernel, and the session loads
    the kernel libraries without building them again."""
    import json

    from dct_tpu_torch.config import (
        ObservabilityConfig,
        RunConfig,
        SchedulerConfig,
    )
    from dct_tpu_torch.data.dataset import load_processed_dataset
    from dct_tpu_torch.data.pipeline import BatchLoader, contiguous_split
    from dct_tpu_torch.data.synthetic import generate_weather_csv
    from dct_tpu_torch.data.windows import make_windows
    from dct_tpu_torch.ops import build
    from dct_tpu_torch.scheduler import WorkloadScheduler, parse_tenants

    build.load_kernels("flash_fwd", "flash_bwd")  # built before the session

    def libraries():
        return {n: os.path.getmtime(os.path.join(build.BUILD_DIR, n))
                for n in os.listdir(build.BUILD_DIR) if n.endswith(".so")}

    built = libraries()
    # Enough rows that the gate's held-out split holds whole windows.
    raw = generate_weather_csv(str(tmp_path / "raw.csv"), rows=2000, seed=4)
    monkeypatch.setenv("DCT_TRACKING_DIR", str(tmp_path / "mlruns"))
    monkeypatch.setenv("DCT_GATE_ENGINE", "torch")  # the gate's read of it
    cfg = RunConfig(
        obs=ObservabilityConfig(events_dir=str(tmp_path / "events"),
                                heartbeat_dir=str(tmp_path / "hb")),
        sched=SchedulerConfig(root=str(tmp_path / "tenants"), poll_s=0.2,
                              max_rounds=4))
    small = {"DCT_RAW_CSV": raw, "DCT_LOOP_TRAIN_MODE": "inline",
             "DCT_LOOP_EPOCHS_PER_ROUND": "1", "DCT_LOOP_SOAK_S": "0",
             "DCT_LOOP_POLL_S": "0.2", "DCT_LOOP_EVAL_POLL_S": "0.2",
             "DCT_GATE_ENGINE": "torch", "DCT_MODEL": "weather_transformer",
             "DCT_SEQ_LEN": "256", "DCT_D_MODEL": "64", "DCT_N_HEADS": "4",
             "DCT_N_LAYERS": "2", "DCT_D_FF": "128", "DCT_BATCH_SIZE": "16"}
    sched = WorkloadScheduler(cfg, tenants=parse_tenants(json.dumps([
        {"name": "alpha"}, {"name": "beta", "weight": 2}])),
        base_env=small, device="cuda:0")
    fa.reset_launches()
    summary = sched.run()
    counts = fa.launch_counts()
    assert summary["reason"] == "max_rounds" and summary["total_rounds"] == 4
    for name in ("alpha", "beta"):
        t = summary["tenants"][name]
        assert t["rounds"] >= 1 and t["state"] == "stopped" and not t["error"]
    # Every round one epoch: 2 layers x (train steps + eval batches)
    # forward, 2 x train steps each backward; the gate's engine adds 2
    # layers x 2 models x its chunks per consult (one engine pass per
    # package judged: every promotion but a tenant's first, every hold).
    windows = make_windows(load_processed_dataset(
        str(tmp_path / "tenants" / "alpha" / "processed")), 256)
    tr, va = contiguous_split(len(windows), val_fraction=0.2, gap=256)
    n_tr = BatchLoader(windows, tr, global_batch=16, shuffle=True).num_batches
    n_va = BatchLoader(windows, va, global_batch=16,
                       shuffle=False).num_batches
    rounds = summary["total_rounds"]
    assert counts["flash_bwd_dkdv"] == counts["flash_bwd_dq"] == (
        rounds * 2 * n_tr)
    gate = counts["flash_fwd"] - rounds * 2 * (n_tr + n_va)
    stops = [json.loads(x) for x in open(tmp_path / "events" / "events.jsonl")
             if '"tenant.stop"' in x]
    consults = sum(s["promotions"] + s["held"] - (s["promotions"] > 0)
                   for s in stops)
    assert gate >= 0 and gate % 4 == 0 and (gate > 0) == (consults > 0)
    assert libraries() == built


def _int8_twin(seed=4):
    from dct_tpu_torch.serving.package import init_package_weights
    from dct_tpu_torch.serving.quant import quantize_weights
    from dct_tpu_torch.serving.runtime import assemble_weights

    meta = dict(model="weather_transformer", input_dim=5, seq_len=T,
                d_model=64, n_heads=2, n_layers=2, d_ff=128, num_classes=2,
                horizon=1)
    flat, qmeta = quantize_weights(init_package_weights(meta, seed), meta,
                                   "int8")
    return assemble_weights(flat), qmeta, flat


def test_int8_package_on_card_matches_cpu(card):
    from dct_tpu_torch.serving.batching import Int8Dense, TorchScorer

    weights, meta, _ = _int8_twin()
    x = np.random.default_rng(3).standard_normal((5, T, 5)).astype(np.float32)
    gpu = TorchScorer(weights, meta, card)
    layers = [m for m in gpu.model.modules() if isinstance(m, Int8Dense)]
    assert layers and all(m.q8.dtype == torch.int8 and m.q8.is_cuda
                          for m in layers)
    fa.reset_launches()
    probs = gpu(x)
    assert fa.launches == meta["n_layers"]
    np.testing.assert_allclose(probs, TorchScorer(weights, meta, "cpu")(x),
                               atol=1e-4)


def test_mlp_package_served_on_card(card, tmp_path):
    import json
    import threading
    import urllib.request

    from dct_tpu_torch.checkpoint.manager import save_checkpoint
    from dct_tpu_torch.config import ServingConfig
    from dct_tpu_torch.models.registry import config_from_meta, get_model
    from dct_tpu_torch.serving.numpy_runtime import assemble_weights
    from dct_tpu_torch.serving.numpy_runtime import score_payload
    from dct_tpu_torch.serving.score_gen import generate_score_package
    from dct_tpu_torch.serving.server import make_server

    meta = {"model": "weather_mlp", "input_dim": 5, "hidden_dim": 64,
            "num_classes": 2}
    torch.manual_seed(0)
    ckpt = save_checkpoint(str(tmp_path / "m.ckpt"),
                           get_model(config_from_meta(meta), device="cpu"),
                           meta)
    generate_score_package(ckpt, str(tmp_path / "pkg"))
    server = make_server(str(tmp_path / "pkg"),
                         serving=ServingConfig(workers=1))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    x = np.random.default_rng(1).standard_normal((6, 5)).astype(np.float32)
    try:
        assert server.device.type == "cuda"
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/score",
            data=json.dumps({"data": x.tolist()}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            got = np.asarray(json.loads(r.read())["probabilities"])
    finally:
        server.shutdown()
        server.server_close()
    with np.load(str(tmp_path / "pkg" / "model.npz")) as npz:
        weights = assemble_weights({k: npz[k] for k in npz.files})
    ref = np.asarray(score_payload(weights, meta, x.tolist())["probabilities"])
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_two_process_pool_answers_on_card(card, tmp_path):
    """``python -m dct_tpu_torch.serve`` with ``DCT_SERVE_PROCS=2``: the
    parent builds the kernels without touching CUDA, each forked child
    takes cuda:0, both publish launches, SIGTERM drains to exit 0."""
    import json
    import signal
    import socket
    import subprocess
    import sys
    import time
    import urllib.request

    from dct_tpu_torch.serving.package import init_package_weights
    from dct_tpu_torch.serving.package import write_package

    meta = dict(model="weather_transformer", input_dim=5, seq_len=T,
                d_model=64, n_heads=2, n_layers=2, d_ff=128, num_classes=2,
                horizon=1)
    write_package(str(tmp_path / "pkg"), init_package_weights(meta, 0), meta)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if not k.startswith("DCT_")}
    env.update(PYTHONPATH=repo, DCT_PACKAGE_DIR=str(tmp_path / "pkg"),
               DCT_SERVE_PROCS="2", DCT_SERVE_HOST="127.0.0.1",
               DCT_SERVE_PORT=str(port), DCT_METRICS_PUBLISH_S="0.1",
               DCT_METRICS_DIR=str(tmp_path / "metrics"))
    proc = subprocess.Popen([sys.executable, "-m", "dct_tpu_torch.serve"],
                            env=env, cwd=str(tmp_path), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    x = np.random.default_rng(0).standard_normal((2, T, 5)).tolist()
    body = json.dumps({"data": x}).encode()
    try:
        procs, deadline = set(), time.time() + 180
        while len(procs) < 2 and time.time() < deadline:
            try:
                with urllib.request.urlopen(urllib.request.Request(
                        f"http://127.0.0.1:{port}/score", data=body),
                        timeout=60) as r:
                    assert np.isfinite(json.loads(r.read())["probabilities"]
                                       ).all()
                text = urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=30
                ).read().decode()
            except OSError:
                time.sleep(0.5)
                continue
            procs = {ln.split('proc="')[1].split('"')[0]
                     for ln in text.splitlines()
                     if ln.startswith("dct_requests_total{") and "proc=" in ln}
        assert len(procs) == 2
        launches = [float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
                    if ln.startswith('dct_kernel_launches{kernel="flash_fwd"}')]
        assert launches and launches[0] >= 2 * meta["n_layers"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)


def test_flash_interpret_mode_raises_on_a_cuda_tensor(card, monkeypatch):
    """Every knob that would select a plain path raises on a CUDA tensor,
    naming itself, and launches nothing: ``DCT_FLASH=interpret`` and
    ``off``, a block that does not divide T, and ``DCT_FLASH_BWD=remat``
    in the backward (after the forward's launch)."""
    from dct_tpu_torch.ops.attention import make_attention_fn

    q, k, v = _qkv(9, 4, 64, torch.float32, card)
    fa.reset_launches()
    for key, value in (("DCT_FLASH", "interpret"), ("DCT_FLASH", "off"),
                       ("DCT_FLASH_BLOCK_Q", "96")):
        monkeypatch.setenv(key, value)
        with pytest.raises(ValueError, match=f"{key}={value}"):
            make_attention_fn()(q, k, v)
        monkeypatch.delenv(key)
    assert fa.launches == 0
    monkeypatch.setenv("DCT_FLASH", "on")
    o = make_attention_fn()(q, k, v)
    assert fa.launches == 1
    np.testing.assert_allclose(o.cpu().numpy(), make_attention_fn()(
        q.cpu(), k.cpu(), v.cpu()).numpy(), atol=1e-4)
    monkeypatch.setenv("DCT_FLASH_BWD", "remat")
    fa.reset_launches()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves)
    with pytest.raises(ValueError, match="DCT_FLASH_BWD=remat"):
        out.sum().backward()
    assert fa.launch_counts() == {"flash_fwd": 1, "flash_bwd_dkdv": 0,
                                  "flash_bwd_dq": 0}


# (tq, tk, q_offset, window, kv heads): the ring's variants (the windowed
# ring's partial-band shards, some with rows no key reaches; the striped
# ring's rectangular half-chunk blocks; ragged lengths).
SP_CASES = [
    (128, 128, 128, 64, 4),
    (256, 256, 256, 100, 2),
    (128, 128, 256, 64, 4),
    (256, 128, 0, None, 4),
    (128, 256, 0, None, 2),
    (96, 160, 0, None, 4),
    (160, 160, 96, 80, 2),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tq,tk,q_offset,window,g", SP_CASES)
def test_ring_variants_match_plain(card, tq, tk, q_offset, window, g,
                                   dtype):
    """q_offset, Tq != Tk and the lse cotangent in the backward, each
    kernel against its plain version: o within 1e-5 (f32) or 2e-2, lse
    within 1e-4 (rows no key reaches at -1e30 on both sides), dq, dk, dv
    within 1e-4 (f32) or 1e-2 of max|plain|; one launch each, nothing
    infinite or NaN."""
    causal = window is not None
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    rng = np.random.default_rng(tq + tk + q_offset)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(card)

    q, do = rand(B, H, tq, 64).to(dtype), rand(B, H, tq, 64).to(dtype)
    k, v = rand(B, g, tk, 64).to(dtype), rand(B, g, tk, 64).to(dtype)
    g_lse = rand(B, H, tq)
    fa.reset_launches()
    # 32-row blocks: the wrapper's contract at the ragged lengths.
    o, lse = fa.flash_attention(q, k, v, return_lse=True, block_q=32,
                                block_k=32, **kw)
    dk, dv = fa.flash_bwd_dkdv(q, k, v, o, lse, do, g_lse=g_lse, **kw)
    dq = fa.flash_bwd_dq(q, k, v, o, lse, do, g_lse=g_lse, **kw)
    torch.cuda.synchronize()
    assert fa.launch_counts() == {"flash_fwd": 1, "flash_bwd_dkdv": 1,
                                  "flash_bwd_dq": 1}
    po, plse = fa.flash_attention_plain(q, k, v, block_k=32, **kw)
    grads = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, g_lse=g_lse,
                                         block_q=32, block_k=32, **kw)
    f32 = dtype == torch.float32
    for x in (o, lse, dq, dk, dv):
        assert torch.isfinite(x).all()
    assert (o.float() - po.float()).abs().max().item() <= (
        1e-5 if f32 else 2e-2)
    assert (lse - plse).abs().max().item() <= 1e-4
    for got, ref in zip((dq, dk, dv), grads):
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= (1e-4 if f32 else 1e-2) * max(
            ref.float().abs().max().item(), 1e-30)


def test_ring_variants_under_autograd_launch_the_kernels(card):
    """flash_attention(return_lse=True) under grad: the lse's cotangent
    reaches the backward kernels (the gradients equal the plain
    backward's with it), and nothing runs a plain path."""
    rng = np.random.default_rng(5)
    leaves = [torch.from_numpy(rng.standard_normal((B, H, t, 32)).astype(
        np.float32)).to(card).requires_grad_() for t in (128, 256, 256)]
    fa.reset_launches()
    o, lse = fa.flash_attention(*leaves, return_lse=True)
    do, g_lse = torch.ones_like(o), torch.full_like(lse, 0.5)
    got = torch.autograd.grad([o, lse], leaves, [do, g_lse])
    torch.cuda.synchronize()
    assert fa.launch_counts() == {"flash_fwd": 1, "flash_bwd_dkdv": 1,
                                  "flash_bwd_dq": 1}
    q, k, v = (x.detach() for x in leaves)
    want = fa.flash_attention_bwd_plain(q, k, v, o.detach(), lse.detach(),
                                        do, g_lse=g_lse)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


class _OneProcessSeq:
    """A grid whose seq axis of ``size`` ranks runs rank after rank in one
    process: ``seq_shard`` is rank ``index``'s, and ``shift`` (in place of
    ``ring_shift``) hands it the stacked K/V its ring steps bring."""

    def __init__(self, size):
        self.size, self.index, self.kvs, self.shifts = size, 0, [], 0
        self.shape = {"data": 1, "model": 1, "seq": size, "pipe": 1}

    def seq_shard(self):
        from dct_tpu_torch.parallel.mesh import SeqShard

        return SeqShard(self.size, self.index)

    def shift(self, x, shard):
        self.shifts += 1
        return self.kvs[(shard.index - self.shifts) % self.size]


def _seq4_ring(card, monkeypatch, t, causal, window, striped):
    """Each rank's ring output at seq=4 on the card (forward only), with
    its positions, and dense attention over the whole sequence."""
    from dct_tpu_torch.ops import attention as att
    from dct_tpu_torch.parallel import mesh as pm

    monkeypatch.setenv("DCT_SP_ENGINE", "ring")
    monkeypatch.setenv("DCT_RING_STRIPED", striped)
    grid = _OneProcessSeq(4)
    monkeypatch.setattr(pm, "ring_shift", grid.shift)
    q, k, v = _qkv(17, 2, 64, torch.float32, card, t=t)
    engines, pos = [], []
    for my in range(4):
        grid.index = my
        engines.append(att.SequenceParallelAttention(grid, causal=causal,
                                                     window=window))
        pos.append(engines[-1].positions(t, card))
    grid.kvs = [torch.stack([k[..., p, :], v[..., p, :]]) for p in pos]
    outs = []
    for my in range(4):
        grid.index, grid.shifts = my, 0
        outs.append(engines[my](q[..., pos[my], :], k[..., pos[my], :],
                                v[..., pos[my], :]))
    torch.cuda.synchronize()
    return outs, pos, att.dense_attention(q, k, v, causal=causal,
                                          window=window)


# (causal, window, DCT_RING_STRIPED, forward launches over the 4 ranks):
# striped half shards of 32 (3 + 3 a rank), the contiguous causal ring
# (1 + my), the non-causal ring (4 a rank), a window over 3 steps.
SEQ4_T256 = [
    (True, None, "auto", 24),
    (True, None, "off", 10),
    (False, None, "auto", 16),
    (True, 100, "auto", 9),
]


@pytest.mark.parametrize("causal,window,striped,launches", SEQ4_T256)
def test_seq4_ring_at_t256_runs_the_kernels(card, monkeypatch, causal,
                                            window, striped, launches):
    """seq=4 at T=256 (shards of 64 rows, half shards of 32) runs every
    ring step on the kernel, not a plain path: each rank's output equals
    dense attention at its positions within 1e-4, and the forward kernel
    launched the layout's count of calls."""
    fa.reset_launches()
    outs, pos, ref = _seq4_ring(card, monkeypatch, 256, causal, window,
                                striped)
    assert fa.launch_counts()["flash_fwd"] == launches
    for o, p in zip(outs, pos):
        assert (o - ref[..., p, :]).abs().max().item() <= 1e-4


@pytest.mark.parametrize("t,window,striped", [(768, None, "off"),
                                              (768, None, "auto"),
                                              (256, 64, "on")])
def test_seq4_ring_without_a_kernel_body_raises(card, monkeypatch, t,
                                                window, striped):
    """Shards of 192 rows (no whole number of 128-blocks) and a windowed
    striped ring have no kernel body: the ring raises on the card and
    launches nothing."""
    fa.reset_launches()
    with pytest.raises(ValueError, match="no flash kernel body"):
        _seq4_ring(card, monkeypatch, t, True, window, striped)
    assert fa.launch_counts()["flash_fwd"] == 0


class _OneProcessSeqGrid(_OneProcessSeq):
    """:class:`_OneProcessSeq` with the grid's sizes the MoE's routing
    checks (one data row, ``size`` seq ranks)."""

    data_size = 1

    @property
    def seq_size(self):
        return self.size


def test_moe_seq4_ring_at_t256_runs_the_kernels(card, monkeypatch):
    """weather_moe's block at seq=4, T=256 (shards of 64 rows), run rank
    after rank on one card with the ring's shift, the routing gather and
    the pooled sum stubbed: each rank's attention launches the non-causal
    ring's 4 forward calls and equals dense attention at its positions
    within 1e-4, and its MoE layer, routed over the four ranks' counts
    (einsum, tokens dropping), equals the one-process layer there within
    1e-4."""
    from dct_tpu_torch.config import ModelConfig
    from dct_tpu_torch.models import moe as moe_mod
    from dct_tpu_torch.models import transformer as tf_mod
    from dct_tpu_torch.models.registry import get_model
    from dct_tpu_torch.ops.attention import dense_attention
    from dct_tpu_torch.parallel import mesh as pm

    monkeypatch.setenv("DCT_SP_ENGINE", "ring")
    grid = _OneProcessSeqGrid(4)
    monkeypatch.setattr(pm, "ring_shift", grid.shift)
    monkeypatch.setattr(moe_mod, "get_mesh", lambda: grid)
    monkeypatch.setattr(tf_mod, "reduce_from_seq", lambda x, shard: x)
    counts, gathered = [], {}

    def gather(c):  # [k, B, E] -> [1, 4, k, B, E] over the four ranks
        counts.append(c)
        return gathered.get("all", c[None, None].expand(1, 4, *c.shape))

    monkeypatch.setattr(moe_mod, "all_gather_grad", gather)
    cfg = ModelConfig(name="weather_moe", seq_len=256, d_model=64,
                      n_heads=4, n_layers=1, d_ff=128, n_experts=4,
                      capacity_factor=0.5, moe_dispatch="einsum",
                      dropout=0.0)
    torch.manual_seed(5)
    one = get_model(cfg, input_dim=5, device=card)
    state = one.state_dict()
    attn_one = one.block_0.attn
    seen = {}

    def dense_capture(q, k, v):
        seen["kv"] = (k, v)
        seen["o"] = dense_attention(q, k, v)
        return seen["o"]

    attn_one.attn_fn = dense_capture
    moe_out = []
    one.block_0.moe.register_forward_hook(
        lambda m, i, o: moe_out.append(o))
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 256, 5)).astype(np.float32)).to(card)
    with torch.no_grad():
        one(x)
    ranks, pos = [], []
    for my in range(4):
        grid.index = my
        model = get_model(cfg, input_dim=5, device=card, mesh=grid)
        model.load_state_dict(state)
        ranks.append(model)
        pos.append(model.seq_parallel.positions(256, card))
    k, v = seen["kv"]
    grid.kvs = [torch.stack([k[..., p, :], v[..., p, :]]) for p in pos]

    def run():
        outs, attn = [], []
        for my, model in enumerate(ranks):
            grid.index, grid.shifts = my, 0
            engine = model.block_0.attn.attn_fn
            model.block_0.attn.attn_fn = (
                lambda q, k_, v_, e=engine: attn.append(e(q, k_, v_))
                or attn[-1])
            hook = model.block_0.moe.register_forward_hook(
                lambda m, i, o: outs.append(o))
            with torch.no_grad():
                model(x)
            hook.remove()
            model.block_0.attn.attn_fn = engine
        torch.cuda.synchronize()
        return attn, outs

    run()  # the routing counts of each rank
    gathered["all"] = torch.stack(counts[-4:])[None]
    fa.reset_launches()
    attn, outs = run()
    assert fa.launch_counts()["flash_fwd"] == 4 * 4
    for p, a, o in zip(pos, attn, outs):
        assert (a - seen["o"][..., p, :]).abs().max().item() <= 1e-4
        assert (o - moe_out[0][:, p]).abs().max().item() <= 1e-4
    dropped = sum(int((o == 0).all(dim=-1).sum()) for o in outs)
    assert dropped == int((moe_out[0] == 0).all(dim=-1).sum()) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mpmd_runner_on_one_card_launches_the_kernels(card, dtype):
    """``MpmdRunner`` at ``1,1`` on ``cuda:0`` (both stages on the card,
    a thread each): every stage launches ``2 (L/P) M`` forwards and
    ``(L/P) M`` dK/dV and dQ a train step and ``(L/P) M`` forwards an
    eval batch, counted per stage, and the losses match the sequential
    step."""
    from dct_tpu_torch.config import ModelConfig, MpmdConfig, RunConfig
    from dct_tpu_torch.parallel import mpmd
    from dct_tpu_torch.train import mpmd_trainer as mt
    from dct_tpu_torch.train import steps

    cfg = RunConfig()
    cfg.model = ModelConfig(name="weather_transformer_pp", seq_len=T,
                            d_model=64, n_heads=4, n_layers=4, d_ff=128,
                            n_stages=2, dropout=0.0)
    cfg.train.bf16_compute = dtype == torch.bfloat16
    cfg.train.optimizer, cfg.train.lr, cfg.train.momentum = "sgd", 0.01, 0.9
    m = 4
    cfg.mpmd = MpmdConfig(stages="1,1", microbatches=m)
    spec = cfg.mpmd.to_spec()
    devices = mpmd.carve_stage_meshes(spec.device_counts, device=card)
    full = mt.build_full_state(cfg, 5, device=card)
    seq = mt.build_full_state(cfg, 5, device=card)
    fns = mt.build_stage_fns(cfg.model)
    runner = mpmd.MpmdRunner(
        spec, [mpmd.split_state(full, k, 2) for k in range(2)],
        [mpmd.make_stage_programs(k, 2, fns) for k in range(2)], devices)
    step = steps.make_train_step()
    rng = np.random.default_rng(3)
    per = cfg.model.n_layers // 2 * m
    for _ in range(3):
        x = rng.standard_normal((8, T, 5)).astype(np.float32)
        y = rng.integers(0, 2, 8).astype(np.int32)
        w = np.ones(8, np.float32)
        loss, _ = runner.train_step(x, y, w)
        seq, mets = step(seq, x, y, w)
        tol = 1e-5 if dtype == torch.float32 else 5e-3
        assert abs(loss - float(mets["train_loss"])) <= tol
        for rep in runner.last_reports:
            assert rep.launches == {"flash_fwd": 2 * per,
                                    "flash_bwd_dkdv": per,
                                    "flash_bwd_dq": per}
    runner.eval_pass(x, y, w)
    for rep in runner.last_eval_reports:
        assert rep.launches == {"flash_fwd": per, "flash_bwd_dkdv": 0,
                                "flash_bwd_dq": 0}


def test_mpmd_stage_slice_of_two_cards_names_item_17c(card):
    from dct_tpu_torch.parallel import mpmd
    from dct_tpu_torch.train.mpmd_worker import stage_device

    with pytest.raises(mpmd.MpmdSpecError, match="item 17c"):
        mpmd.carve_stage_meshes((2, 1))
    with pytest.raises(mpmd.MpmdSpecError, match="item 17c"):
        mpmd.carve_stage_meshes((1, 1), model=2)
    spec = mpmd.spec_from_env_values("2,2", 4, "1f1b", 60.0, 29600)
    with pytest.raises(mpmd.MpmdSpecError, match="item 17c"):
        stage_device(spec, 0)
