"""Pack-side weight quantization (counterpart of ``dct_tpu/serving/quant.py``):
an f32 package -> its bf16 twin.

Every float leaf is rounded to nearest even bf16 and stored as its uint16
bit pattern under ``k::bf16`` (half the npz bytes); the meta gains the
reference's ``quant`` stanza (``{dtype, prob_bound}``). The port serves
such a package at bf16 compute (:class:`~dct_tpu_torch.serving.batching.
TorchScorer`). The int8 variant is not ported yet (ROADMAP Queue A).
"""

from __future__ import annotations

import numpy as np

from dct_tpu_torch.config import _env
from dct_tpu_torch.serving.runtime import bf16_pack

#: Documented max |p_quant - p_f32| parity bound (``DCT_QUANT_PROB_BOUND``).
DEFAULT_PROB_BOUND = 0.05


def quantize_weights(
    weights: dict, meta: dict, dtype: str = "bf16"
) -> tuple[dict, dict]:
    """(f32 flax-keyed weights, meta) -> (flat bf16 package dict, meta')."""
    if dtype != "bf16":
        raise NotImplementedError(
            f"{dtype} quantization is not ported to dct_tpu_torch yet "
            "(ROADMAP Queue A: int8 packages)"
        )
    flat: dict = {}
    for k, v in weights.items():
        v = np.asarray(v)
        if np.issubdtype(v.dtype, np.floating):
            flat[f"{k}::bf16"] = bf16_pack(v)
        else:
            flat[k] = v
    meta_out = dict(meta)
    meta_out["quant"] = {
        "dtype": dtype,
        "prob_bound": float(_env("DCT_QUANT_PROB_BOUND", DEFAULT_PROB_BOUND,
                                 float)),
    }
    return flat, meta_out
