"""Carry the JAX package's parameters into the port's modules.

The reference flattens a flax param tree to ``{"block_0/attn/qkv_proj/
kernel": ndarray, ...}`` (``dct_tpu/serving/score_gen.py:_flatten_params``),
which is also the layout of a package's ``model.npz``. The port names its
modules after the flax paths, so a key maps to a parameter by rule: ``/``
becomes ``.``, a dense ``kernel`` ``[in, out]`` becomes ``weight``
``[out, in]`` (transposed), a LayerNorm ``scale`` becomes ``weight``.
:func:`flax_weights` is the inverse (a model's parameters, or their
gradients, as a flat flax-path dict), and :func:`init_flax_weights` draws a
model's initial weights from a numpy seed, the same on every device.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def flax_names(model: nn.Module) -> dict[str, tuple[str, bool]]:
    """Torch parameter name -> (flax key, transposed) for every parameter
    of ``model``. Only ``nn.Linear`` and ``nn.LayerNorm`` hold
    parameters in the port's models; anything else raises."""
    out: dict[str, tuple[str, bool]] = {}
    for prefix, mod in model.named_modules():
        own = dict(mod.named_parameters(recurse=False))
        if not own:
            continue
        flax_prefix = prefix.replace(".", "/")
        if isinstance(mod, nn.Linear):
            out[f"{prefix}.weight"] = (f"{flax_prefix}/kernel", True)
        elif isinstance(mod, nn.LayerNorm):
            out[f"{prefix}.weight"] = (f"{flax_prefix}/scale", False)
        else:
            raise TypeError(
                f"no flax mapping for the parameters of {prefix} "
                f"({type(mod).__name__})"
            )
        if "bias" in own:
            out[f"{prefix}.bias"] = (f"{flax_prefix}/bias", False)
    return out


def flax_shapes(model: nn.Module) -> dict[str, tuple[int, ...]]:
    """Flax key -> the flax-layout shape ``model`` expects for it."""
    params = dict(model.named_parameters())
    out = {}
    for name, (key, transposed) in flax_names(model).items():
        shape = tuple(params[name].shape)
        out[key] = shape[::-1] if transposed else shape
    return out


def load_flax_weights(model: nn.Module, flat: dict) -> nn.Module:
    """Fill ``model`` from a flat flax-path dict, with strict key
    matching: a key the model lacks, or a parameter the dict lacks,
    raises ``KeyError``; a shape mismatch raises ``ValueError``. Values
    are cast to each parameter's dtype and device. Returns ``model``."""
    names = flax_names(model)
    want = {key: (name, tr) for name, (key, tr) in names.items()}
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(
            f"flax weights do not match {type(model).__name__}: missing "
            f"{missing[:8]}{'...' if len(missing) > 8 else ''}, unexpected "
            f"{extra[:8]}{'...' if len(extra) > 8 else ''}"
        )
    params = dict(model.named_parameters())
    with torch.no_grad():
        for key, (name, transposed) in want.items():
            value = np.asarray(flat[key], np.float32)
            if transposed:
                value = value.T
            p = params[name]
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(
                    f"{key}: shape {tuple(np.shape(flat[key]))} does not "
                    f"fit {name} {tuple(p.shape)}"
                )
            p.copy_(torch.tensor(value).to(p.dtype))
    return model


def flax_weights(model: nn.Module, *, grads: bool = False) -> dict:
    """The inverse of :func:`load_flax_weights`: flax key -> f32 ndarray
    of each parameter of ``model`` (of its ``.grad`` with ``grads=True``;
    a missing gradient raises), dense kernels transposed back to
    ``[in, out]``."""
    params = dict(model.named_parameters())
    out = {}
    for name, (key, transposed) in flax_names(model).items():
        t = params[name].grad if grads else params[name]
        if t is None:
            raise ValueError(f"{name} has no gradient")
        value = t.detach().float().cpu().numpy()
        out[key] = value.T if transposed else value
    return out


def init_flax_weights(model: nn.Module, seed: int) -> dict:
    """Random flax-path-keyed f32 weights for ``model`` from
    ``np.random.default_rng(seed)``: dense kernels and biases
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch's default, as the reference's
    ``torch_linear_init``), LayerNorm scale 1 and bias 0."""
    shapes = flax_shapes(model)
    rng = np.random.default_rng(seed)
    out = {}
    for key in sorted(shapes):
        shape = shapes[key]
        prefix, leaf = key.rsplit("/", 1)
        if f"{prefix}/scale" in shapes:  # a LayerNorm
            fill = 1.0 if leaf == "scale" else 0.0
            out[key] = np.full(shape, fill, np.float32)
            continue
        fan_in = shapes[f"{prefix}/kernel"][0]
        bound = 1.0 / np.sqrt(fan_in)
        out[key] = rng.uniform(-bound, bound, shape).astype(np.float32)
    return out
