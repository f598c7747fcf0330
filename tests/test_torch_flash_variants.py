"""The flash variants the ring engine runs, port against the JAX package.

``q_offset`` (the windowed ring's partial-band shards), rectangular
``Tq != Tk`` (the striped ring's half-chunk blocks) and the backward
through the lse output (the ring's merge weights) of
``dct_tpu_torch.ops.flash_attention`` are held to the reference's
``flash_attention_lse`` (``dct_tpu/ops/pallas_attention.py:599-667``): its
Pallas forward in interpret mode, its rematerialized backward through
``jax.vjp`` with a nonzero lse cotangent. On the CPU the port runs the
kernels' plain versions (``flash_attention_plain``,
``flash_attention_bwd_plain``); the kernels themselves are held to those
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase (n)).
Tolerances: 1e-5 on o and lse, 1e-4 on dq, dk and dv (f32 both sides,
sums in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_tpu.ops.pallas_attention import flash_attention_lse as jax_flash_lse
from dct_tpu_torch.ops import flash_attention as fa
from torch_threads import one_torch_thread  # noqa: F401

D = 16

# (tag, b, h, g, tq, tk, causal, window, q_offset): the ring's calls at
# small size. Offsets of one and two shards under a window shorter than
# the shard leave rows that no key reaches (o = 0, lse = -1e30).
CASES = [
    ("offset_one_shard", 2, 2, 2, 128, 128, True, 64, 128),
    ("offset_two_shards", 1, 2, 1, 128, 128, True, 200, 256),
    ("offset_band_rows_masked", 1, 2, 2, 256, 256, True, 128, 256),
    ("offset_no_window", 1, 2, 2, 128, 128, True, None, 128),
    ("rect_q_long", 2, 2, 2, 256, 128, False, None, 0),
    ("rect_k_long", 2, 4, 2, 128, 256, False, None, 0),
    ("rect_small", 1, 2, 2, 64, 128, False, None, 0),
    ("square_lse_cotangent", 1, 2, 2, 128, 128, True, None, 0),
]


def _inputs(seed, b, h, g, tq, tk):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, tq, D)).astype(np.float32)
    k = rng.standard_normal((b, g, tk, D)).astype(np.float32)
    v = rng.standard_normal((b, g, tk, D)).astype(np.float32)
    do = rng.standard_normal((b, h, tq, D)).astype(np.float32)
    glse = rng.standard_normal((b, h, tq)).astype(np.float32)
    return q, k, v, do, glse


def _reference(q, k, v, do, glse, causal, window, q_offset):
    def f(q_, k_, v_):
        return jax_flash_lse(q_, k_, v_, 128, 128, causal, None, True,
                             window, q_offset)

    (o, lse), vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    dq, dk, dv = vjp((jnp.asarray(do), jnp.asarray(glse)))
    return [np.asarray(a) for a in (o, lse, dq, dk, dv)]


def _port(q, k, v, do, glse, causal, window, q_offset):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o, lse = fa.flash_attention(*leaves, causal=causal, window=window,
                                q_offset=q_offset, return_lse=True)
    grads = torch.autograd.grad([o, lse], leaves,
                                [torch.from_numpy(do),
                                 torch.from_numpy(glse)])
    return [a.detach().numpy() for a in (o, lse, *grads)]


def _close(got, ref, tag):
    o, lse, *grads = got
    ro, rlse, *rgrads = ref
    np.testing.assert_allclose(o, ro, atol=1e-5, rtol=0, err_msg=tag)
    # Rows no key reaches carry the -1e30 guard on both sides.
    np.testing.assert_allclose(lse, rlse, atol=1e-5, rtol=1e-6,
                               err_msg=tag)
    for name, g, r in zip(("dq", "dk", "dv"), grads, rgrads):
        np.testing.assert_allclose(g, r, atol=1e-4, rtol=0,
                                   err_msg=f"{tag} {name}")


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_variant_matches_the_reference_forward_and_vjp(case):
    tag, b, h, g, tq, tk, causal, window, q_offset = case
    arrays = _inputs(len(tag), b, h, g, tq, tk)
    ref = _reference(*arrays, causal, window, q_offset)
    got = _port(*arrays, causal, window, q_offset)
    _close(got, ref, tag)
    if q_offset and window is not None and window < q_offset:
        # The offset band leaves whole rows unreached: o = 0 there.
        dead = ref[1] < -1e29
        assert dead.any() and not np.abs(got[0][dead]).any()


def test_plain_backward_is_the_kernels_function_with_the_lse_cotangent():
    """``flash_attention_bwd_plain`` (what the kernels compute, blockwise,
    the cotangent folded into delta) equals the reference's vjp, from the
    forward's o and lse, at a rectangular and an offset shape."""
    for tq, tk, causal, window, q_offset in ((128, 256, False, None, 0),
                                             (128, 128, True, 96, 128)):
        q, k, v, do, glse = _inputs(7, 2, 2, 1, tq, tk)
        ref = _reference(q, k, v, do, glse, causal, window, q_offset)
        t = [torch.from_numpy(a) for a in (q, k, v)]
        o, lse = fa.flash_attention_plain(*t, causal=causal, window=window,
                                          q_offset=q_offset)
        grads = fa.flash_attention_bwd_plain(
            *t, o, lse, torch.from_numpy(do), causal=causal, window=window,
            q_offset=q_offset, g_lse=torch.from_numpy(glse))
        for g, r in zip(grads, ref[2:]):
            np.testing.assert_allclose(g.numpy(), r, atol=1e-4, rtol=0)


def test_remat_backward_carries_the_lse_cotangent(monkeypatch):
    """``DCT_FLASH_BWD=remat`` (the blockwise path differentiated) gives
    the kernels' plain backward, the lse cotangent and offset included."""
    arrays = _inputs(11, 1, 2, 2, 128, 128)
    want = _port(*arrays, True, 64, 128)
    monkeypatch.setenv("DCT_FLASH_BWD", "remat")
    got = _port(*arrays, True, 64, 128)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_unused_outputs_give_the_plain_gradients():
    """The lse unused (cotangent None) is the o-only backward; o unused
    (lse alone differentiated) is the lse cotangent alone."""
    q, k, v, do, glse = _inputs(13, 1, 2, 2, 128, 256)
    ref_o = _reference(q, k, v, do, np.zeros_like(glse), False, None, 0)
    ref_l = _reference(q, k, v, np.zeros_like(do), glse, False, None, 0)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = fa.flash_attention(*leaves)
    g_o = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    _, lse = fa.flash_attention(*leaves, return_lse=True)
    g_l = torch.autograd.grad(lse, leaves, torch.from_numpy(glse))
    for got, ref in ((g_o, ref_o), (g_l, ref_l)):
        for g, r in zip(got, ref[2:]):
            np.testing.assert_allclose(g.numpy(), r, atol=1e-4, rtol=0)


@pytest.mark.parametrize("kw,shape_k,match", [
    (dict(causal=True), 256, "square"),
    (dict(q_offset=128), 128, "requires causal"),
    (dict(causal=True, q_offset=-1), 128, ">= 0"),
    (dict(block_k=96), 128, "multiples"),
])
def test_the_reference_refusals_stay(kw, shape_k, match):
    """Causal Tq != Tk, an offset without causal (``_flash_fwd``
    :177-188), a negative offset and blocks that do not divide the
    lengths raise, as the reference's."""
    q = torch.zeros(1, 2, 128, D)
    k = torch.zeros(1, 2, shape_k, D)
    with pytest.raises(ValueError, match=match):
        fa.flash_attention(q, k, k, **kw)
