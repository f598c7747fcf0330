"""The port's flash-attention backward against the JAX package's (CPU).

``flash_attention_bwd_plain`` (the two backward kernels' function in plain
PyTorch) is held against ``jax.vjp`` of the Pallas ``flash_attention`` run
in interpret mode (its two backward kernels), on the same numpy q/k/v/dO,
and against autograd through ``dense_attention`` in f64.
``FlashAttention``'s CPU path and the wrappers' refusals are pinned here;
the kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_tpu.ops.pallas_attention import flash_attention as jax_flash
from dct_tpu_torch.ops import flash_attention as fa
from dct_tpu_torch.ops.attention import dense_attention
from torch_threads import one_torch_thread  # noqa: F401

B, H, G, T, D = 1, 4, 2, 256, 16
# Errors are relative to max(1, max|reference|) per output: f32 differs by
# summation order only; bf16 by one rounding of P and dS near a tie.
TOL = {"f32": 1e-4, "bf16": 2e-2}

CASES = [  # (causal, window, kv heads), as tests/test_torch_flash.py
    (False, None, H),
    (True, None, H),
    (True, 64, H),
    (False, None, G),
    (True, None, G),
    (True, 100, G),
]


# Head dims 64 (the main path) and 128 (the widest), two CASES each.
WIDE_CASES = [  # (head dim, causal, window, kv heads)
    (64, False, None, G),
    (64, True, 100, G),
    (128, True, None, H),
    (128, True, 64, H),
]


def _inputs(seed, g, dtype="f32", d=D):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in (
        (B, H, T, d), (B, g, T, d), (B, g, T, d), (B, H, T, d))]
    if dtype == "f32":
        return [torch.from_numpy(a) for a in arrays], [
            jnp.asarray(a) for a in arrays]
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrays], [
        jnp.asarray(a, jnp.bfloat16) for a in arrays]


def _rel_err(got, ref) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - ref).max()
                 / max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal,window,g", CASES)
def test_plain_bwd_matches_pallas_vjp(causal, window, g, dtype):
    _check_plain_bwd_against_pallas(causal, window, g, dtype, D)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d,causal,window,g", WIDE_CASES)
def test_plain_bwd_matches_pallas_vjp_wide_heads(d, causal, window, g, dtype):
    _check_plain_bwd_against_pallas(causal, window, g, dtype, d)


def _check_plain_bwd_against_pallas(causal, window, g, dtype, d):
    (tq, tk, tv, tdo), (jq, jk, jv, jdo) = _inputs(11, g, dtype, d=d)
    _, vjp = jax.vjp(
        lambda q, k, v: jax_flash(q, k, v, block_q=128, block_k=128,
                                  causal=causal, interpret=True,
                                  window=window),
        jq, jk, jv,
    )
    refs = vjp(jdo)
    o, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                      window=window)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal=causal,
                                       window=window)
    for name, a, r in zip(("dq", "dk", "dv"), got, refs):
        assert a.dtype == tq.dtype and tuple(a.shape) == r.shape, name
        assert _rel_err(a, r) <= TOL[dtype], name


@pytest.mark.parametrize("causal,window,g", CASES)
def test_plain_bwd_matches_dense_autograd_f64(causal, window, g):
    """f32 blockwise sums against the f64 dense oracle: 1e-5."""
    (tq, tk, tv, tdo), _ = _inputs(12, g)
    q, k, v = (t.double().requires_grad_() for t in (tq, tk, tv))
    refs = torch.autograd.grad(
        dense_attention(q, k, v, causal=causal, window=window),
        (q, k, v), tdo.double(),
    )
    o, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                      window=window)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal=causal,
                                       window=window, block_q=64, block_k=128)
    for a, r in zip(got, refs):
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=1e-5)


@pytest.mark.parametrize("causal,window,g", CASES)
def test_function_cpu_grads_are_the_plain_bwd(causal, window, g):
    (tq, tk, tv, tdo), _ = _inputs(13, g)
    q, k, v = (t.clone().requires_grad_() for t in (tq, tk, tv))
    before = fa.launch_counts()
    o = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert isinstance(o.grad_fn, fa.FlashAttention._backward_cls)
    # dO as the model hands it over: a transposed, non-contiguous view.
    do_strided = tdo.transpose(1, 2).contiguous().transpose(1, 2)
    assert not do_strided.is_contiguous()
    got = torch.autograd.grad(o, (q, k, v), do_strided)
    po, plse = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                        window=window)
    assert torch.equal(o.detach(), po)
    want = fa.flash_attention_bwd_plain(tq, tk, tv, po, plse, tdo,
                                        causal=causal, window=window)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert fa.launch_counts() == before  # CPU tensors: no kernel launched


def test_per_kernel_wrappers_refuse_cpu_tensors():
    """Kernels 2 and 3 have no CPU mode: their wrappers launch or raise, and
    the CPU route of the backward is FlashAttention's alone."""
    (tq, tk, tv, tdo), _ = _inputs(14, G)
    o, lse = fa.flash_attention_plain(tq, tk, tv, causal=True, window=64)
    before = fa.launch_counts()
    for wrapper in (fa.flash_bwd_dkdv, fa.flash_bwd_dq):
        with pytest.raises(ValueError, match="flash_attention_bwd_plain"):
            wrapper(tq, tk, tv, o, lse, tdo, causal=True, window=64)
    assert fa.launch_counts() == before


def test_bwd_refusals_and_counters():
    (tq, tk, tv, tdo), _ = _inputs(15, G)
    o, lse = fa.flash_attention_plain(tq, tk, tv)
    with pytest.raises(TypeError, match="dtypes"):
        fa.flash_bwd_dq(tq, tk, tv, o.double(), lse, tdo)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_bwd_dkdv(tq, tk, tv, o, lse[..., :128], tdo)
    with pytest.raises(ValueError, match="must match"):
        fa.flash_bwd_dq(tq, tk, tv, o, lse, tdo[:, :2])
    q = tq.clone().requires_grad_()
    # Under grad the lse output carries its cotangent into the backward
    # (the ring's merge weights): the same (o, lse) as without grad, and
    # the gradient of lse alone is the plain backward with dO = 0.
    o_g, lse_g = fa.flash_attention(q, tk, tv, return_lse=True)
    with torch.no_grad():  # no grad required: lse is served as before
        o_n, lse_n = fa.flash_attention(q, tk, tv, return_lse=True)
    assert torch.equal(o_g, o_n) and torch.equal(lse_g, lse_n)
    g_lse = torch.ones_like(lse_n)
    (dq,) = torch.autograd.grad(lse_g, q, g_lse)
    want = fa.flash_attention_bwd_plain(tq, tk, tv, o_n, lse_n,
                                        torch.zeros_like(tdo), g_lse=g_lse)
    assert torch.equal(dq, want[0])
    fa.reset_launches()
    assert fa.launch_counts() == {"flash_fwd": 0, "flash_bwd_dkdv": 0,
                                  "flash_bwd_dq": 0}
    assert fa.launches == 0


@pytest.mark.parametrize("d,causal,window,g", [
    (8, False, None, H),
    (48, True, None, G),
    (80, True, 64, G),
])
def test_function_pads_head_dims_and_matches_pallas_vjp(d, causal, window, g):
    """D outside the kernel instances: the wrapper pads to the next
    instance, FlashAttention runs on the padded tensors and autograd slices
    the gradients back; 1e-4 of the Pallas kernels' vjp in interpret
    mode."""
    (tq, tk, tv, tdo), (jq, jk, jv, jdo) = _inputs(16, g, d=d)
    _, vjp = jax.vjp(
        lambda q, k, v: jax_flash(q, k, v, block_q=128, block_k=128,
                                  causal=causal, interpret=True,
                                  window=window),
        jq, jk, jv,
    )
    q, k, v = (t.clone().requires_grad_() for t in (tq, tk, tv))
    o = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert o.shape == (B, H, T, d)
    got = torch.autograd.grad(o, (q, k, v), tdo)
    for name, a, r in zip(("dq", "dk", "dv"), got, vjp(jdo)):
        assert tuple(a.shape) == r.shape, name
        assert _rel_err(a, r) <= TOL["f32"], name


def test_backward_refuses_head_dims_above_128():
    q = torch.zeros(B, H, T, 256, requires_grad=True)
    kv = torch.zeros(B, G, T, 256)
    with pytest.raises(ValueError, match="B2"):
        fa.flash_attention(q, kv, kv)


def test_bwd_wrappers_pad_before_checking_contiguity():
    """The forward's o at a padded head dim is a slice of the padded
    output (not contiguous); the backward wrappers pad it into a
    contiguous copy before their checks, so the only refusal on CPU
    tensors is the device."""
    (tq, tk, tv, tdo), _ = _inputs(17, G, d=8)
    o, lse = fa.flash_attention(tq, tk, tv, return_lse=True)
    assert not o.is_contiguous()
    for wrapper in (fa.flash_bwd_dkdv, fa.flash_bwd_dq):
        with pytest.raises(ValueError, match="flash_attention_bwd_plain"):
            wrapper(tq, tk, tv, o, lse, tdo)
