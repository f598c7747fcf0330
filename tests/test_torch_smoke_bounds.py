"""The yardstick of ``chip_smoke.py``: each kernel's bound at the main
path's shape (B=32, H=G=8, T=1024, D=64, not causal), on the CPU (the
bounds are arithmetic on shapes and datasheet rates; nothing runs on a
card)."""

import pytest
import torch

import chip_smoke

SHAPE = (32, 8, 8, 1024, 64)  # B, H, G, T, D


@pytest.mark.parametrize("dtype,kernel,ms,basis", [
    # f32 accuracy on the tensor cores: 3 TF32 products at 495 TFLOP/s.
    (torch.float32, "flash_fwd", 0.4165, "operations (3xTF32)"),
    (torch.float32, "flash_bwd_dkdv", 0.833, "operations (3xTF32)"),
    (torch.float32, "flash_bwd_dq", 0.625, "operations (3xTF32)"),
    # bf16 at 989 TFLOP/s, as before.
    (torch.bfloat16, "flash_fwd", 0.0695, "operations (bf16)"),
    (torch.bfloat16, "flash_bwd_dkdv", 0.139, "operations (bf16)"),
    (torch.bfloat16, "flash_bwd_dq", 0.104, "operations (bf16)"),
])
def test_bound_at_the_main_shape(dtype, kernel, ms, basis):
    if kernel == "flash_fwd":
        got = chip_smoke.attention_bound(*SHAPE, dtype, False, None,
                                         lse=True)
    else:
        got = chip_smoke.bwd_bound(kernel, *SHAPE, dtype, False, None)
    # bound_by keeps the kernels line's two words; the basis names the peak.
    assert got[1:] == ("operations", basis)
    assert got[0] == pytest.approx(ms, abs=5e-4)


def test_bound_is_bytes_where_bytes_take_longer():
    """One key per head: no work to speak of, the traffic bounds it."""
    ms, by, basis = chip_smoke.attention_bound(32, 8, 8, 1, 64,
                                               torch.float32, False, None,
                                               lse=True)
    assert (by, basis) == ("bytes", "bytes")
    assert ms == pytest.approx((4 * 32 * 8 * 64 * 4 + 32 * 8 * 4)
                               / chip_smoke.PEAK_BYTES * 1e3)


def test_every_kernel_and_dtype_is_held_to_the_tensor_cores():
    """Every (kernel, dtype) pair of the port is on the SASS check: each
    instance must hold HGMMA, and none may spill."""
    assert set(chip_smoke.TENSOR_CORE_SASS) == {
        (kernel, dtype)
        for kernel in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
        for dtype in ("bf16", "f32")
    }
