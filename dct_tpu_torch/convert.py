"""Carry the JAX package's parameters into the port's modules.

The reference flattens a flax param tree to ``{"block_0/attn/qkv_proj/
kernel": ndarray, ...}`` (``dct_tpu/serving/score_gen.py:_flatten_params``),
which is also the layout of a package's ``model.npz``. The port names its
modules after the flax paths, so a key maps to a parameter by rule: ``/``
becomes ``.``, a dense ``kernel`` ``[in, out]`` becomes ``weight``
``[out, in]`` (transposed), a LayerNorm ``scale`` becomes ``weight``.
A module that holds parameters of its own in flax's layout (the GRU's
``h_kernel`` ``[H, 3H]`` and ``h_bias``, the MoE's ``experts_in_kernel``
``[E, D, F]`` and the other expert tensors) lists them in a
``flax_params`` attribute, ``{name: init}``; they keep their names and
layout. A pipeline stage's parameters carry the reference's stacked
stage dim first (``pp_stages/block_0/attn/qkv_proj/kernel`` ``[n_stages,
in, out]`` is a weight ``[n_stages, out, in]``): a kernel's last two dims
are swapped whatever comes before them. :func:`flax_weights` is the inverse (a model's parameters, or their
gradients, as a flat flax-path dict), and :func:`init_flax_weights` draws a
model's initial weights from a numpy seed, the same on every device.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def flax_names(model: nn.Module) -> dict[str, tuple[str, bool]]:
    """Torch parameter name -> (flax key, transposed) for every parameter
    of ``model``: those of ``nn.Linear`` and ``nn.LayerNorm`` and those a
    module lists in ``flax_params``; any other parameter raises."""
    out: dict[str, tuple[str, bool]] = {}
    for prefix, mod in model.named_modules():
        own = dict(mod.named_parameters(recurse=False))
        if not own:
            continue
        flax_prefix = prefix.replace(".", "/")
        listed = getattr(mod, "flax_params", None)
        if listed is not None:
            if set(own) != set(listed):
                raise TypeError(
                    f"{prefix} ({type(mod).__name__}) lists flax params "
                    f"{sorted(listed)} but holds {sorted(own)}"
                )
            for name in own:
                out[f"{prefix}.{name}" if prefix else name] = (
                    f"{flax_prefix}/{name}" if prefix else name, False)
            continue
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


def swap_layout(a: np.ndarray, transposed: bool) -> np.ndarray:
    """A host array between flax's layout and torch's (a kernel's last
    two dims swapped; the swap is its own inverse)."""
    return np.swapaxes(a, -1, -2) if transposed and a.ndim >= 2 else a


def flax_shape(shape: tuple, transposed: bool) -> tuple:
    """A torch-layout shape in flax layout (see :func:`swap_layout`)."""
    if transposed and len(shape) >= 2:
        return (*shape[:-2], shape[-1], shape[-2])
    return tuple(shape)


def flax_shapes(model: nn.Module) -> dict[str, tuple[int, ...]]:
    """Flax key -> the flax-layout shape ``model`` expects for it."""
    params = dict(model.named_parameters())
    return {key: flax_shape(tuple(params[name].shape), transposed)
            for name, (key, transposed) in flax_names(model).items()}


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
            value = swap_layout(np.asarray(flat[key], np.float32),
                                transposed)
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
        out[key] = swap_layout(t.detach().float().cpu().numpy(), transposed)
    return out


def _listed_inits(model: nn.Module) -> dict[str, tuple]:
    """Flax key -> init spec of every parameter a module lists in its
    ``flax_params``."""
    out = {}
    for prefix, mod in model.named_modules():
        for name, spec in (getattr(mod, "flax_params", None) or {}).items():
            key = f"{prefix.replace('.', '/')}/{name}" if prefix else name
            out[key] = tuple(spec)
    return out


def _truncated_normal(rng, shape, std: float) -> np.ndarray:
    """flax's ``truncated_normal``: N(0, 1) cut to [-2, 2] (redrawn
    outside), times ``std``."""
    out = rng.standard_normal(shape)
    bad = np.abs(out) > 2.0
    while bad.any():
        out[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(out) > 2.0
    return (out * std).astype(np.float32)


def _draw_listed(spec: tuple, shape, rng) -> np.ndarray:
    """One listed parameter drawn from its spec: ``("uniform", fan_in)``
    (the expert tensors: U(-1/sqrt(fan_in), 1/sqrt(fan_in))),
    ``("lecun_normal", fan_in)`` (flax's ``lecun_normal``: truncated
    normal of variance 1/fan_in) or ``("zeros",)``."""
    kind, *args = spec
    if kind == "zeros":
        return np.zeros(shape, np.float32)
    if kind == "uniform":
        bound = 1.0 / np.sqrt(args[0])
        return rng.uniform(-bound, bound, shape).astype(np.float32)
    if kind == "lecun_normal":
        # flax's variance_scaling divides by the std of N(0, 1) cut to
        # [-2, 2] so that the cut draw has variance 1/fan_in.
        std = np.sqrt(1.0 / args[0]) / 0.87962566103423978
        return _truncated_normal(rng, shape, std)
    raise ValueError(f"unknown init {kind!r}")


def init_listed(module: nn.Module) -> None:
    """Draw the parameters ``module`` lists in ``flax_params`` from their
    specs (:func:`_draw_listed`), seeded from torch's generator: a
    module's initial values at construction."""
    rng = np.random.default_rng(int(torch.randint(1 << 62, ())))
    with torch.no_grad():
        for name, spec in module.flax_params.items():
            param = getattr(module, name)
            param.copy_(torch.from_numpy(
                _draw_listed(tuple(spec), tuple(param.shape), rng)))


def init_flax_weights(model: nn.Module, seed: int) -> dict:
    """Random flax-path-keyed f32 weights for ``model`` from
    ``np.random.default_rng(seed)`` with the reference's distributions:
    dense kernels and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch's
    default, as the reference's ``torch_linear_init``), LayerNorm scale 1
    and bias 0, and for a listed parameter its own spec
    (:func:`_draw_listed`)."""
    shapes = flax_shapes(model)
    listed = _listed_inits(model)
    rng = np.random.default_rng(seed)
    out = {}
    for key in sorted(shapes):
        shape = shapes[key]
        if key in listed:
            out[key] = _draw_listed(listed[key], shape, rng)
            continue
        prefix, leaf = key.rsplit("/", 1)
        if f"{prefix}/scale" in shapes:  # a LayerNorm
            fill = 1.0 if leaf == "scale" else 0.0
            out[key] = np.full(shape, fill, np.float32)
            continue
        fan_in = shapes[f"{prefix}/kernel"][-2]
        bound = 1.0 / np.sqrt(fan_in)
        out[key] = rng.uniform(-bound, bound, shape).astype(np.float32)
    return out
