"""Score packages: ``model.npz`` + ``model_meta.json``.

The format is the reference's (``dct_tpu/serving/score_gen.py``,
``export_npz_weights``): flax-path-keyed arrays in the npz (the MLP as
``w<i>``/``b<i>``; ``k::bf16`` bit patterns for a bf16 package, ``k::q8``
and ``k::scale`` pairs for an int8 one) and the model's self-describing
meta in JSON. A package written here is served by the reference's numpy scorer
unchanged, and the port serves the reference's packages.
"""

from __future__ import annotations

import json
import os

import numpy as np

from dct_tpu_torch.serving.runtime import assemble_weights


def load_package(package_dir: str) -> tuple[dict, dict]:
    """-> (serving weights: key -> f32 ndarray or ``QuantTensor``, meta)."""
    with np.load(os.path.join(package_dir, "model.npz")) as npz:
        flat = {k: npz[k] for k in npz.files}
    with open(os.path.join(package_dir, "model_meta.json")) as f:
        meta = json.load(f)
    return assemble_weights(flat), meta


def publish_text(path: str, text: str) -> None:
    """Atomic text publish: temporary sibling, then ``os.replace``."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def write_package(package_dir: str, weights: dict, meta: dict) -> None:
    """Write ``weights`` (the flat npz mapping) and ``meta``; each file is
    published atomically (temporary sibling, then ``os.replace``)."""
    os.makedirs(package_dir, exist_ok=True)
    npz_path = os.path.join(package_dir, "model.npz")
    tmp = f"{npz_path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **weights)
    os.replace(tmp, npz_path)
    publish_text(os.path.join(package_dir, "model_meta.json"),
                 json.dumps(meta, indent=2))


def init_package_weights(meta: dict, seed: int) -> dict:
    """Random flax-path-keyed f32 weights for the model ``meta`` describes
    (:func:`dct_tpu_torch.convert.init_flax_weights`)."""
    from dct_tpu_torch.convert import init_flax_weights
    from dct_tpu_torch.models.registry import config_from_meta, get_model

    return init_flax_weights(
        get_model(config_from_meta(meta), device="meta"), seed
    )
