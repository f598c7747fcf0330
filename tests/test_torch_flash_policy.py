"""The ``DCT_FLASH`` policy and its knobs in the port (CPU), as in
``tests/test_flash_selection.py``: mode x device -> path (``off`` and
``interpret`` on a CUDA device raise, naming ``on`` and ``off``), the
``DCT_FLASH_BLOCK_Q/K`` blocks driving the selection (on a CPU tensor
blocks that do not divide T degrade to blockwise or dense; on a CUDA
tensor they raise), and ``DCT_FLASH_BWD=remat``: gradients of the
blockwise path within 1e-4 of the kernel path's (its plain version on the
CPU) and of the reference's remat backward (the Pallas forward in
interpret mode); on a CUDA device it raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_tpu.ops.attention import select_attention_path as jax_select
from dct_tpu.ops.pallas_attention import flash_attention as jax_flash
from dct_tpu_torch.ops import attention as att
from dct_tpu_torch.ops import flash_attention as fa

B, H, G, T, D = 1, 4, 2, 256, 16

# mode -> (path on a CPU tensor, path on a CUDA tensor) at T=1024; None
# means the selection raises.
POLICY = {
    "auto": ("flash", "flash"),
    "on": ("flash", "flash"),
    "1": ("flash", "flash"),
    "off": ("blockwise", None),
    "0": ("blockwise", None),
    "interpret": ("flash", None),
    "nonsense": ("flash", "flash"),  # unknown words are auto, as upstream
}


@pytest.mark.parametrize("mode", sorted(POLICY))
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_mode_by_device_selects_path(mode, device, monkeypatch):
    monkeypatch.setenv("DCT_FLASH", mode)
    want = POLICY[mode][device == "cuda"]
    if want is None:
        with pytest.raises(ValueError, match="DCT_FLASH=on.*DCT_FLASH=off"):
            att.select_attention_path(1024, device=device)
        return
    assert att.select_attention_path(1024, device=device) == want
    # Below the flash rule the policy does not matter.
    assert att.select_attention_path(64, device=device) == "dense"
    assert att.select_attention_path(320, device=device) == "dense"


@pytest.mark.parametrize("mode", ["off", "interpret", "on"])
@pytest.mark.parametrize("t", [64, 256, 320, 512, 1024, 1536])
def test_cpu_policy_equals_reference_where_the_reference_flashes_on_cpu(
        mode, t, monkeypatch):
    """On the CPU the reference takes flash under ``interpret`` and
    ``on`` (interpret mode) and never under ``off``; the port's CPU rule
    is the same."""
    monkeypatch.setenv("DCT_FLASH", mode)
    assert att.select_attention_path(t) == jax_select(t)


def _qkv(seed, t=T, g=G):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((B, H, t, D), (B, g, t, D), (B, g, t, D))]


def test_off_never_calls_the_flash_wrapper(monkeypatch):
    calls = []
    real = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    q, k, v = _qkv(1, t=1024)
    attn = att.make_attention_fn(causal=True)
    monkeypatch.setenv("DCT_FLASH", "off")
    o_off = attn(q, k, v)
    assert calls == []
    monkeypatch.setenv("DCT_FLASH", "auto")
    o_on = attn(q, k, v)
    assert len(calls) == 1
    ref = att.dense_attention(q, k, v, causal=True)
    np.testing.assert_allclose(o_off.numpy(), ref.numpy(), atol=1e-5)
    np.testing.assert_allclose(o_on.numpy(), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("bq,bk,flash", [
    ("128", "128", True), ("64", "256", True), ("256", "64", True),
    ("96", "128", False), ("128", "96", False), ("512", "128", False),
])
def test_block_knobs_drive_the_selection(bq, bk, flash, monkeypatch):
    """Blocks that divide T (and do not exceed it) keep the flash path,
    with the blocks passed on; others degrade to dense at T=256, as the
    reference's selection does."""
    calls = []
    real = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    monkeypatch.setenv("DCT_FLASH_BLOCK_Q", bq)
    monkeypatch.setenv("DCT_FLASH_BLOCK_K", bk)
    q, k, v = _qkv(2)
    o = att.make_attention_fn()(q, k, v)
    assert bool(calls) == flash
    if flash:
        assert (calls[0]["block_q"], calls[0]["block_k"]) == (int(bq), int(bk))
    np.testing.assert_allclose(o.numpy(), att.dense_attention(q, k, v).numpy(),
                               atol=1e-5)
    # The reference's selection under interpret mode agrees.
    monkeypatch.setenv("DCT_FLASH", "interpret")
    ref_flash = (jax_select(T, flash_block=max(int(bq), int(bk))) == "flash"
                 and T % int(bq) == 0 and T % int(bk) == 0)
    assert ref_flash == flash


@pytest.mark.parametrize("t,bq,bk,raises", [
    (1024, "128", "128", False), (1024, "256", "64", False),
    (1024, "96", "128", True), (1024, "128", "2048", True),
    (256, "512", "128", True),
    # Where the default blocks do not flash either, the knobs change
    # nothing on the card.
    (320, "96", "128", False), (64, "96", "96", False),
])
def test_cuda_blocks_that_do_not_divide_t_raise(t, bq, bk, raises,
                                                 monkeypatch):
    monkeypatch.setenv("DCT_FLASH_BLOCK_Q", bq)
    monkeypatch.setenv("DCT_FLASH_BLOCK_K", bk)
    if raises:
        with pytest.raises(ValueError, match="DCT_FLASH_BLOCK_Q=.*do not "
                                             f"divide T={t}"):
            att._check_cuda_blocks(t, int(bq), int(bk), 512)
    else:
        att._check_cuda_blocks(t, int(bq), int(bk), 512)


CASES = [(False, None, H), (True, None, G), (True, 64, G)]


@pytest.mark.parametrize("causal,window,g", CASES)
def test_remat_backward_matches_kernel_path_and_reference(
        causal, window, g, monkeypatch):
    q, k, v = _qkv(3, g=g)
    do = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (B, H, T, D)).astype(np.float32))

    def grads(mode):
        monkeypatch.setenv("DCT_FLASH_BWD", mode)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o = fa.flash_attention(*leaves, causal=causal, window=window)
        o.backward(do)
        return [x.grad.numpy() for x in leaves]

    kernel_path, remat = grads("kernel"), grads("remat")
    monkeypatch.setenv("DCT_FLASH_BWD", "remat")
    jq, jk, jv, jdo = (jnp.asarray(x.numpy()) for x in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(
        a, b, c, 128, 128, causal, None, True, window), jq, jk, jv)
    reference = [np.asarray(x) for x in vjp(jdo)]
    for ours, kern, ref in zip(remat, kernel_path, reference):
        scale = max(1.0, float(np.abs(ref).max()))
        assert np.abs(ours - kern).max() / scale < 1e-4
        assert np.abs(ours - ref).max() / scale < 1e-4


def test_remat_launches_no_backward_kernel_and_rejects_bad_modes(monkeypatch):
    fa.reset_launches()
    monkeypatch.setenv("DCT_FLASH_BWD", "remat")
    q, k, v = (x.requires_grad_() for x in _qkv(5))
    fa.flash_attention(q, k, v).sum().backward()
    assert fa.launch_counts() == {"flash_fwd": 0, "flash_bwd_dkdv": 0,
                                  "flash_bwd_dq": 0}  # the CPU launches none
    monkeypatch.setenv("DCT_FLASH_BWD", "sometimes")
    q2, k2, v2 = (x.requires_grad_() for x in _qkv(6))
    with pytest.raises(ValueError, match="DCT_FLASH_BWD"):
        fa.flash_attention(q2, k2, v2).sum().backward()


def test_remat_raises_on_a_cuda_device(monkeypatch):
    monkeypatch.setenv("DCT_FLASH_BWD", "remat")
    assert fa.bwd_mode("cpu") == "remat"
    with pytest.raises(ValueError, match="DCT_FLASH_BWD=remat.*CPU tensors"):
        fa.bwd_mode("cuda")
    monkeypatch.setenv("DCT_FLASH_BWD", "kernel")
    assert fa.bwd_mode("cuda") == "kernel"
