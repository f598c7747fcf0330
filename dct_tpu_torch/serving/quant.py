"""Pack-side weight quantization (counterpart of ``dct_tpu/serving/quant.py``):
an f32 package -> its int8 or bf16 twin.

- ``int8``: per-output-channel symmetric scales over every 2D matmul
  kernel (``w\\d+`` MLP stacks, any 2D ``*kernel`` flax path), stored as
  ``k::q8`` (int8) + ``k::scale`` (f32); biases, LayerNorm affines and
  3D+ stacks stay f32. The arrays are the reference's bit for bit.
- ``bf16``: every float leaf rounded to nearest even bf16 and stored as
  its uint16 bit pattern under ``k::bf16`` (half the npz bytes).

The meta gains the reference's ``quant`` stanza (``{dtype,
prob_bound}``). The serve side is :func:`dct_tpu_torch.serving.runtime.
assemble_weights` (``QuantTensor`` leaves) and :class:`~dct_tpu_torch.
serving.batching.TorchScorer`, which keeps an int8 package's q8 and
scales resident on the card and dequantizes inside the forward.

    python -m dct_tpu_torch.serving.quant <f32 package> <out dir> [--dtype int8|bf16]
"""

from __future__ import annotations

import json
import os
import re

import numpy as np

from dct_tpu_torch.config import _env
from dct_tpu_torch.serving.runtime import bf16_pack

#: Documented max |p_quant - p_f32| parity bound (``DCT_QUANT_PROB_BOUND``).
DEFAULT_PROB_BOUND = 0.05

_MLP_KERNEL_RE = re.compile(r"w\d+$")


def prob_bound() -> float:
    """The asserted max-abs-prob parity bound (env-overridable)."""
    return float(_env("DCT_QUANT_PROB_BOUND", DEFAULT_PROB_BOUND, float))


def is_matmul_kernel(key: str, arr: np.ndarray) -> bool:
    """True for the 2D matmul kernels the int8 variant packs: MLP ``w<i>``
    stacks and any 2D flax ``*kernel`` leaf."""
    return arr.ndim == 2 and (
        key.endswith("kernel") or _MLP_KERNEL_RE.fullmatch(key) is not None
    )


def quantize_array_int8(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[K, M] f32 -> (int8 [K, M], f32 per-output-channel scale [M]).
    Symmetric: scale = max|w|/127 per column; an all-zero channel keeps
    scale 0 (dequantizes to exact zeros)."""
    a = np.asarray(a, np.float32)
    scale = (np.abs(a).max(axis=0) / np.float32(127.0)).astype(np.float32)
    safe = np.where(scale > 0, scale, 1).astype(np.float32)
    q = np.clip(np.rint(a / safe[None, :]), -127, 127).astype(np.int8)
    return q, scale


def quantize_weights(
    weights: dict, meta: dict, dtype: str = "int8"
) -> tuple[dict, dict]:
    """(f32 serving weights, meta) -> (flat quantized npz mapping, meta')
    in the ``k::q8``/``k::scale``/``k::bf16`` key grammar."""
    if dtype not in ("int8", "bf16"):
        raise ValueError(
            f"quantize dtype must be 'int8' or 'bf16', got {dtype!r}"
        )
    flat: dict = {}
    for k, v in weights.items():
        v = np.asarray(v)
        if dtype == "int8" and is_matmul_kernel(k, v):
            flat[f"{k}::q8"], flat[f"{k}::scale"] = quantize_array_int8(v)
        elif dtype == "bf16" and np.issubdtype(v.dtype, np.floating):
            flat[f"{k}::bf16"] = bf16_pack(v)
        else:
            flat[k] = v
    meta_out = dict(meta)
    meta_out["quant"] = {"dtype": dtype, "prob_bound": prob_bound()}
    return flat, meta_out


def quantize_package(package_dir: str, out_dir: str,
                     dtype: str | None = None) -> dict:
    """An f32 package -> a complete quantized sibling in ``out_dir``
    (``model.npz``, ``model_meta.json``, ``score.py``, ``conda.yaml``);
    ``dtype`` defaults to ``DCT_QUANT_DTYPE`` (int8). Returns the meta."""
    from dct_tpu_torch.serving.package import publish_text, write_package
    from dct_tpu_torch.serving.score_gen import _CONDA_YAML, render_score_py

    if dtype is None:
        dtype = str(_env("DCT_QUANT_DTYPE", "int8", str)).strip().lower()
    with np.load(os.path.join(package_dir, "model.npz")) as npz:
        weights = {k: npz[k] for k in npz.files}
    with open(os.path.join(package_dir, "model_meta.json")) as f:
        meta = json.load(f)
    if "quant" in meta:
        raise ValueError(
            f"{package_dir} is already quantized "
            f"({meta['quant'].get('dtype')}) — re-quantizing compounds "
            "rounding; start from the f32 package"
        )
    flat, meta_out = quantize_weights(weights, meta, dtype)
    write_package(out_dir, flat, meta_out)
    publish_text(os.path.join(out_dir, "score.py"), render_score_py())
    publish_text(os.path.join(out_dir, "conda.yaml"), _CONDA_YAML)
    return meta_out


def main(argv: list | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Quantize an f32 package (int8/bf16 twin)."
    )
    ap.add_argument("package_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--dtype", choices=("int8", "bf16"), default=None)
    args = ap.parse_args(argv)
    meta = quantize_package(args.package_dir, args.out_dir, args.dtype)
    print(json.dumps(meta.get("quant", {})))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
