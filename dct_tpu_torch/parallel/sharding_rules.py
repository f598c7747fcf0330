"""Dtype rules (the dtype half of ``dct_tpu/parallel/sharding_rules.py``,
``:173-286``; the partition rules, and the rules' digest that keys the
reference's AOT cache, belong to later slices).

``DCT_DTYPE_RULES='pattern=dtype[;pattern=dtype...]'`` selects parameters by
a regex over their flax path (``params/block_0/attn/qkv_proj/kernel``, the
path the reference's rules see, taken from
:func:`dct_tpu_torch.convert.flax_names`) and casts the matching ones to a
low precision for the forward and backward. The f32 master parameters,
the accumulated gradients and the optimizer state stay f32: the cast
happens inside the loss body (:mod:`dct_tpu_torch.train.steps`), so
autograd routes the low-precision gradients back through the cast and
widens them to f32. No rules (the default) leaves the parameters as they
are.
"""

from __future__ import annotations

import os
import re

import torch
from torch import nn

#: Accepted dtype tokens (right-hand side of a clause) -> canonical name.
DTYPE_ALIASES = {
    "bf16": "bfloat16", "bfloat16": "bfloat16",
    "f16": "float16", "float16": "float16",
    "f32": "float32", "float32": "float32",
}


def parse_dtype_rules(text: str):
    """``DCT_DTYPE_RULES`` grammar -> tuple of (regex, dtype name).
    Malformed specs raise ``ValueError`` naming the offending clause."""
    rules = []
    for clause in (text or "").split(";"):
        clause = clause.strip()
        if not clause:
            continue
        if "=" not in clause:
            raise ValueError(
                f"DCT_DTYPE_RULES clause {clause!r} has no '=': expected "
                "pattern=dtype"
            )
        pattern, _, dname = clause.rpartition("=")
        pattern = pattern.strip()
        try:
            re.compile(pattern)
        except re.error as e:
            raise ValueError(
                f"DCT_DTYPE_RULES pattern {pattern!r} is not a valid "
                f"regex: {e}"
            ) from e
        canonical = DTYPE_ALIASES.get(dname.strip().lower())
        if canonical is None:
            raise ValueError(
                f"DCT_DTYPE_RULES clause {clause!r}: unknown dtype "
                f"{dname.strip()!r} (valid: "
                f"{', '.join(sorted(set(DTYPE_ALIASES)))})"
            )
        rules.append((pattern, canonical))
    return tuple(rules)


def dtype_rules():
    """The active ``DCT_DTYPE_RULES`` table (empty tuple when unset)."""
    return parse_dtype_rules(os.environ.get("DCT_DTYPE_RULES", ""))


def cast_params_by_rules(model: nn.Module) -> dict[str, torch.Tensor] | None:
    """Torch parameter name -> the parameter cast to its rule's dtype
    (first match wins; unmatched parameters pass as they are), for
    ``torch.func.functional_call``; ``None`` when no rules are set. The
    casts are differentiable, so gradients reach the f32 masters."""
    from dct_tpu_torch.convert import flax_names

    rules = dtype_rules()
    if not rules:
        return None
    names = flax_names(model)
    out = {}
    for name, p in model.named_parameters():
        path = "params/" + names[name][0]
        for pattern, dname in rules:
            if re.search(pattern, path):
                p = p.to(getattr(torch, dname))
                break
        out[name] = p
    return out


def dtype_rules_digest() -> str:
    """Content digest of the active dtype rules, recorded in the resume
    tier's layout manifest (``"off"`` when no rules are set), as the
    reference's ``dtype_rules_digest``."""
    import hashlib

    rules = dtype_rules()
    if not rules:
        return "off"
    blob = "|".join(f"{pat}={dname}" for pat, dname in rules)
    return hashlib.sha1(blob.encode()).hexdigest()[:10]
