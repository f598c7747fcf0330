"""Device resolution for the port (counterpart of ``dct_tpu/utils/platform.py``).

The port's entry points run on the card: with no argument they resolve to
``cuda:0`` and raise when CUDA is absent. There is no fallback to the CPU;
a caller that wants the CPU (the tests, a CPU reference run) passes
``device="cpu"`` explicitly. The hand-written kernels are built for Hopper
(``sm_90a``), so a CUDA device must be compute capability 9.0.
"""

from __future__ import annotations

import torch

KERNEL_CAPABILITY = (9, 0)


class DeviceError(RuntimeError):
    """The requested device cannot run the port."""


def require_kernel_capability(device: torch.device) -> None:
    """Raise unless ``device`` is a CUDA device the kernels were built for."""
    cap = torch.cuda.get_device_capability(device)
    if tuple(cap) != KERNEL_CAPABILITY:
        raise DeviceError(
            f"{torch.cuda.get_device_name(device)} is compute capability "
            f"{cap[0]}.{cap[1]}; the port's kernels are built for sm_90a "
            f"(capability {KERNEL_CAPABILITY[0]}.{KERNEL_CAPABILITY[1]})"
        )


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda:0``; ``"cpu"`` -> the CPU; a CUDA device is
    checked for presence and compute capability 9.0. Raises
    :class:`DeviceError` instead of falling back."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise DeviceError(f"unsupported device {dev} (use cuda or cpu)")
    if not torch.cuda.is_available():
        raise DeviceError(
            f"device {dev} requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU"
        )
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    require_kernel_capability(dev)
    return dev
