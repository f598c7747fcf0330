"""Deploy-package generation: checkpoint -> {model.npz, model_meta.json,
score.py, conda.yaml} (counterpart of ``dct_tpu/serving/score_gen.py``).

The package is the reference's, so the reference's numpy scorer serves
what the port trains: ``model.npz`` holds the MLP as an anonymous dense
stack (``w0/b0, w1/b1``, kernels ``[in, out]``) and a sequence family as
its flax param tree flattened to ``/``-joined keys; ``model_meta.json`` is
the checkpoint's meta; ``score.py`` embeds
:mod:`dct_tpu_torch.serving.numpy_runtime`, a verbatim copy of the
reference's numpy ``serving/runtime.py``, so it is the same text the
reference generates. The reference's packaging-time scorer warm-up
(its compile cache) is ROADMAP Queue A item 18.
"""

from __future__ import annotations

import inspect
import os

import numpy as np

from dct_tpu_torch.checkpoint.manager import flatten_tree, param_tree
from dct_tpu_torch.serving.package import publish_text, write_package


def _serving_weights(p: dict, family: str) -> dict:
    """A dense host param tree (without the ``params`` level) -> the
    serving weights dict for ``family``."""
    from dct_tpu_torch.serving.numpy_runtime import _SEQUENCE_FAMILIES

    if family in _SEQUENCE_FAMILIES:
        return {k: np.asarray(v, np.float32)
                for k, v in flatten_tree(p).items()}

    def layer_index(name: str) -> int:
        tail = name.rsplit("_", 1)[-1]
        return int(tail) if tail.isdigit() else -1

    layers = sorted(p, key=layer_index)
    if not all(isinstance(p[n], dict) and {"kernel", "bias"} <= set(p[n])
               for n in layers):
        raise ValueError(
            f"Serving export for model={family!r} expects a sequential "
            f"dense stack; checkpoint has param tree {sorted(p)} — "
            "register a dedicated exporter for this family"
        )
    weights = {}
    for i, name in enumerate(layers):
        weights[f"w{i}"] = np.asarray(p[name]["kernel"], np.float32)
        weights[f"b{i}"] = np.asarray(p[name]["bias"], np.float32)
    return weights


def weights_from_checkpoint(ckpt_path: str) -> tuple[dict, dict]:
    """A ``*.ckpt`` (flax msgpack) -> (serving weights dict, meta)."""
    from dct_tpu_torch.checkpoint.manager import load_checkpoint

    params, meta = load_checkpoint(ckpt_path)
    family = meta.get("model", "weather_mlp")
    return _serving_weights(params["params"], family), meta


def weights_from_state(state, meta: dict) -> tuple[dict, dict]:
    """A live train state -> (serving weights dict, meta), without a
    checkpoint file."""
    family = dict(meta).get("model", "weather_mlp")
    return _serving_weights(param_tree(state.model)["params"],
                            family), dict(meta)


def export_npz_weights(ckpt_path: str, deploy_dir: str) -> dict:
    """model.ckpt -> model.npz + model_meta.json in ``deploy_dir``."""
    weights, meta = weights_from_checkpoint(ckpt_path)
    write_package(deploy_dir, weights, meta)
    return meta


_SCORE_TEMPLATE = '''"""Generated inference server entry (numpy-only).

Serves the dct_tpu rain classifier: init() loads model.npz/model_meta.json
from AZUREML_MODEL_DIR (with nested-path fallbacks), run() scores JSON
payloads {{"data": [[...feature vector...], ...]}}.
"""

import json
import os

import numpy as np

# ---- embedded from dct_tpu.serving.runtime (tested source of truth) ----
{runtime_source}
# ------------------------------------------------------------------------

_WEIGHTS = None
_META = None


def _locate(name):
    base = os.environ.get("AZUREML_MODEL_DIR", ".")
    expected = os.path.join(base, name)
    if os.path.exists(expected):
        return expected
    nested = os.path.join(base, "deploy_package", name)
    if os.path.exists(nested):
        return nested
    for root, _dirs, files in os.walk(base):
        if name in files:
            return os.path.join(root, name)
    raise FileNotFoundError(f"{{name}} not found under {{base}}")


def init():
    global _WEIGHTS, _META
    npz = np.load(_locate("model.npz"))
    # assemble_weights reconstitutes quantized packages (::q8/::scale/
    # ::bf16 key pairs -> QuantTensor / widened f32); a plain f32
    # package passes through unchanged.
    _WEIGHTS = assemble_weights({{k: npz[k] for k in npz.files}})
    with open(_locate("model_meta.json")) as f:
        _META = json.load(f)
    print(f"Model loaded: input_dim={{_META['input_dim']}}")


def run(raw_data):
    try:
        payload = json.loads(raw_data) if isinstance(raw_data, str) else raw_data
        return score_payload(_WEIGHTS, _META, payload["data"])
    except Exception as e:
        return {{"error": str(e)}}
'''

_CONDA_YAML = """name: dct-tpu-inference
channels:
  - conda-forge
dependencies:
  - python=3.10
  - numpy
  - pip
  - pip:
      - azureml-inference-server-http
"""


def render_score_py() -> str:
    """The generated score.py text: the template around the whole numpy
    runtime (its ``__future__`` import dropped, which must lead a file)."""
    from dct_tpu_torch.serving import numpy_runtime

    runtime_source = inspect.getsource(numpy_runtime).replace(
        "from __future__ import annotations\n", "")
    return _SCORE_TEMPLATE.format(runtime_source=runtime_source)


def generate_score_package(ckpt_path: str, deploy_dir: str) -> dict:
    """Write the full deploy package; returns the model meta."""
    meta = export_npz_weights(ckpt_path, deploy_dir)
    publish_text(os.path.join(deploy_dir, "score.py"), render_score_py())
    publish_text(os.path.join(deploy_dir, "conda.yaml"), _CONDA_YAML)
    return meta
