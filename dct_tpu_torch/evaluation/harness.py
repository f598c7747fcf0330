"""Champion/challenger offline eval harness (counterpart of
``dct_tpu/evaluation/harness.py``).

Loads the champion (the deployed package) and the challenger (a package or
a best checkpoint), runs both over the SAME held-out split (the trainer's
own: the seeded permutation's val block for the MLP, the gapped contiguous
tail for the window families), and returns per-example losses and metrics
sliced by label class: what the statistical gates (:mod:`gates`) turn into
a promote/hold/rollback decision.

Two engines over one split:

- ``numpy`` (the default): the serving twin
  (:mod:`dct_tpu_torch.serving.numpy_runtime`), the math the deployed
  ``score.py`` runs, so the gate judges what production would serve;
- ``torch`` (``jax``, the reference's name for its accelerator engine,
  selects it too): the registry model rebuilt from the package meta in f32
  on the caller's device (``cuda:0`` unless ``device="cpu"``; no CUDA and
  no ``"cpu"`` raises), the weights loaded, and a chunked ``no_grad``
  forward. The sequence families take the flash path at ``T >= 256``,
  ``T % 128 == 0``: on the card every layer launches the forward kernel.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

ACCELERATOR_ENGINES = ("torch", "jax")


class EvalError(RuntimeError):
    """The harness could not produce a comparison (missing package,
    incompatible data, empty split). Gates map this to fail-open/closed."""


# ----------------------------------------------------------------------
# Model loading: both sides of the comparison normalize to
# (serving weights, meta), the deployed representation.

def model_from_package(package_dir: str) -> tuple[dict, dict]:
    """(weights, meta) of a deploy package (model.npz + model_meta.json).
    Raises :class:`EvalError` for a missing/incomplete package."""
    from dct_tpu_torch.serving.numpy_runtime import assemble_weights

    npz_path = os.path.join(package_dir, "model.npz")
    meta_path = os.path.join(package_dir, "model_meta.json")
    try:
        with np.load(npz_path) as npz:
            # Quantized packages reconstitute to QuantTensor / widened f32
            # leaves; plain packages pass through.
            weights = assemble_weights({k: npz[k] for k in npz.files})
        with open(meta_path) as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        raise EvalError(f"Unreadable deploy package {package_dir}: {e}") from e
    return weights, meta


def model_from_checkpoint(ckpt_path: str) -> tuple[dict, dict]:
    """(weights, meta) from a raw .ckpt (the challenger before
    packaging) via the packager's own export path."""
    from dct_tpu_torch.serving.score_gen import weights_from_checkpoint

    try:
        return weights_from_checkpoint(ckpt_path)
    except (OSError, ValueError, KeyError) as e:
        raise EvalError(f"Unreadable checkpoint {ckpt_path}: {e}") from e


def load_model(path: str) -> tuple[dict, dict]:
    """Dispatch: a directory is a deploy package, a file a checkpoint."""
    if os.path.isdir(path):
        return model_from_package(path)
    return model_from_checkpoint(path)


# ----------------------------------------------------------------------
# Eval split: the trainer's validation split, rebuilt from the processed
# parquet with the same arithmetic.

def load_eval_split(
    processed_dir: str,
    meta: dict,
    *,
    val_fraction: float = 0.2,
    seed: int = 42,
    data=None,
) -> tuple[np.ndarray, np.ndarray]:
    """(x, y) of the held-out split shaped for ``meta``'s family.

    Row families get the seeded permutation split's val block; window
    families get the gapped contiguous tail (no row shared with any
    train window): the index arithmetic of ``Trainer.fit``, so the
    harness scores data the challenger never trained on. ``data``
    (pre-loaded WeatherArrays) skips the parquet load.
    """
    from dct_tpu_torch.data.dataset import load_processed_dataset
    from dct_tpu_torch.data.pipeline import contiguous_split, train_val_split
    from dct_tpu_torch.serving.numpy_runtime import _SEQUENCE_FAMILIES

    if data is None:
        try:
            data = load_processed_dataset(processed_dir)
        except (OSError, ValueError, RuntimeError) as e:
            raise EvalError(f"No eval data under {processed_dir}: {e}") from e
    family = meta.get("model", "weather_mlp")
    if family in _SEQUENCE_FAMILIES:
        from dct_tpu_torch.data.windows import make_windows
        from dct_tpu_torch.models.registry import is_causal_model

        seq_len = int(meta["seq_len"])
        windows = make_windows(data, seq_len)
        # Trainer.fit's gap: a causal family with horizon H supervised
        # train window i on label rows up to i+seq_len+H-1, so the
        # held-out tail clears that reach too.
        horizon = int(meta.get("horizon", 1) or 1)
        gap = seq_len + (horizon - 1 if is_causal_model(family) else 0)
        _, val_idx = contiguous_split(
            len(windows), val_fraction=val_fraction, gap=gap
        )
        x = np.ascontiguousarray(windows.features[val_idx], np.float32)
        y = np.asarray(windows.labels[val_idx], np.int64)
    else:
        _, val_idx = train_val_split(
            len(data), val_fraction=val_fraction, seed=seed
        )
        x = data.features[val_idx]
        y = np.asarray(data.labels[val_idx], np.int64)
    if len(x) == 0:
        raise EvalError(f"Empty eval split from {processed_dir}")
    return x, y


# ----------------------------------------------------------------------
# Batched apply.

def batched_probs(
    weights: dict,
    meta: dict,
    x: np.ndarray,
    *,
    batch_size: int = 1024,
    engine: str = "numpy",
    device=None,
) -> np.ndarray:
    """[N, C] class probabilities via the chosen engine, ``batch_size``
    examples per forward (a sequence family's activations grow with
    B * S, so a whole-split forward would not fit at the scale an eval
    harness exists for). Multi-horizon causal heads collapse to the
    next-step forecast (the slice the serving contract scores)."""
    if engine in ACCELERATOR_ENGINES:
        probs = _batched_probs_torch(weights, meta, x, batch_size, device)
    else:
        from dct_tpu_torch.serving.numpy_runtime import (
            forward_numpy,
            softmax_numpy,
        )

        parts = []
        for start in range(0, len(x), batch_size):
            piece = np.ascontiguousarray(
                x[start:start + batch_size], np.float32
            )
            parts.append(softmax_numpy(forward_numpy(weights, meta, piece)))
        probs = np.concatenate(parts, axis=0)
    if probs.ndim == 3:  # [N, H, C] multi-horizon -> next-step
        probs = probs[:, 0]
    return probs


def _batched_probs_torch(
    weights: dict, meta: dict, x: np.ndarray, batch_size: int, device
) -> np.ndarray:
    """The accelerator engine, the reference's ``_batched_probs_jax``
    (``dct_tpu/evaluation/harness.py:178-256``) on the process grid
    :func:`~dct_tpu_torch.parallel.mesh.get_mesh` gives (one process, or
    every process of a world calling this): the registry model rebuilt
    from the meta on ``device``, the package's weights loaded (quantized
    ones dequantized to dense f32 on the host) and placed by the family
    rules (:func:`dct_tpu_torch.serving.batching.mesh_scorer`, f32
    compute, TF32 off on the card), each chunk of ``batch_size`` examples
    split over ``data`` and its last chunk padded as the reference pads
    it (:func:`~dct_tpu_torch.parallel.mesh.score_split`)."""
    from dct_tpu_torch.device import resolve_device
    from dct_tpu_torch.parallel.mesh import get_mesh, score_split
    from dct_tpu_torch.serving.batching import mesh_scorer

    mesh = get_mesh()
    return score_split(mesh_scorer(weights, meta, resolve_device(device),
                                   mesh), x, batch_size, mesh)


def dense_weights(weights: dict) -> dict:
    """Host-dequantize a serving weights dict: QuantTensor leaves back
    to dense f32, everything else untouched (no copy)."""
    from dct_tpu_torch.serving.numpy_runtime import QuantTensor

    return {
        k: v.dequantize() if isinstance(v, QuantTensor) else v
        for k, v in weights.items()
    }


def flax_keyed(weights: dict, family: str) -> dict:
    """Serving weights -> flax-path keys (the layout
    :func:`dct_tpu_torch.convert.load_flax_weights` takes): the MLP's
    anonymous ``w<i>``/``b<i>`` stack becomes ``TorchStyleDense_<i>/
    {kernel,bias}``; the sequence families' keys already are flax paths."""
    if family == "weather_mlp" or not any("/" in k for k in weights):
        n_layers = sum(1 for k in weights if k.startswith("w"))
        out = {}
        for i in range(n_layers):
            out[f"TorchStyleDense_{i}/kernel"] = weights[f"w{i}"]
            out[f"TorchStyleDense_{i}/bias"] = weights[f"b{i}"]
        return out
    return dict(weights)


# ----------------------------------------------------------------------
# Per-example losses + sliced metrics.

@dataclass
class EvalResult:
    """One model's pass over the eval split."""

    name: str
    n: int
    loss_mean: float
    accuracy: float
    per_example_loss: np.ndarray = field(repr=False)
    predictions: np.ndarray = field(repr=False)
    # slice name -> {n, loss, accuracy}; slices are label classes
    # (rain/no-rain for the flagship binary task).
    slices: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "n": self.n,
            "loss_mean": self.loss_mean,
            "accuracy": self.accuracy,
            "slices": self.slices,
        }


def per_example_nll(probs: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """[N] negative log-likelihood of the true class — the paired unit
    the bootstrap/sign tests resample (clipped: a deployed softmax can
    underflow to exactly 0 in float32)."""
    p = np.clip(probs[np.arange(len(labels)), labels], 1e-12, 1.0)
    return -np.log(p).astype(np.float64)


_SLICE_NAMES = {0: "no_rain", 1: "rain"}


def slice_metrics(
    labels: np.ndarray, losses: np.ndarray, preds: np.ndarray
) -> dict:
    """Per-label-class metric slices (the reference task's rain/no-rain
    split; any class count generalizes to label_<c>)."""
    out = {}
    for c in np.unique(labels):
        m = labels == c
        name = _SLICE_NAMES.get(int(c), str(int(c)))
        out[f"label_{name}"] = {
            "n": int(m.sum()),
            "loss": float(losses[m].mean()),
            "accuracy": float((preds[m] == labels[m]).mean()),
        }
    return out


def evaluate_model(
    name: str,
    weights: dict,
    meta: dict,
    x: np.ndarray,
    y: np.ndarray,
    *,
    batch_size: int = 1024,
    engine: str = "numpy",
    device=None,
) -> EvalResult:
    probs = batched_probs(
        weights, meta, x, batch_size=batch_size, engine=engine,
        device=device,
    )
    losses = per_example_nll(probs, y)
    preds = np.argmax(probs, axis=-1)
    return EvalResult(
        name=name,
        n=len(y),
        loss_mean=float(losses.mean()),
        accuracy=float((preds == y).mean()),
        per_example_loss=losses,
        predictions=preds,
        slices=slice_metrics(y, losses, preds),
    )


@dataclass
class PairedEval:
    """Champion and challenger over the SAME examples, plus the paired
    per-example loss deltas (champion - challenger: positive = the
    challenger is better on that example)."""

    champion: EvalResult
    challenger: EvalResult
    deltas: np.ndarray = field(repr=False)
    paired: bool = True

    @property
    def mean_delta(self) -> float:
        """Mean loss delta, positive = challenger better. For an
        unpaired (family-upgrade) comparison the per-example deltas are
        empty, but the aggregate difference of means is still
        well-defined — the gates' mean-threshold checks must see it,
        not a constant 0."""
        if len(self.deltas):
            return float(self.deltas.mean())
        return float(self.champion.loss_mean - self.challenger.loss_mean)

    def slice_regressions(self) -> dict:
        """Per-slice loss regression (challenger - champion; positive =
        the challenger is WORSE on that slice)."""
        out = {}
        for name, ch in self.challenger.slices.items():
            cp = self.champion.slices.get(name)
            if cp is not None:
                out[name] = float(ch["loss"] - cp["loss"])
        return out

    def to_dict(self) -> dict:
        return {
            "champion": self.champion.to_dict(),
            "challenger": self.challenger.to_dict(),
            "mean_delta": self.mean_delta,
            "paired": self.paired,
            "slice_regressions": self.slice_regressions(),
        }


def evaluate_pair(
    champion: tuple[dict, dict],
    challenger: tuple[dict, dict],
    processed_dir: str,
    *,
    batch_size: int = 1024,
    engine: str = "numpy",
    val_fraction: float = 0.2,
    seed: int = 42,
    data=None,
    device=None,
) -> PairedEval:
    """Run both models over the held-out split.

    Per-example pairing requires both models to consume the same input
    shape (same family class: row vs window, same seq_len). A family
    upgrade (e.g. MLP champion vs transformer challenger) is evaluated
    UNPAIRED over each model's own view of the same held-out rows —
    the gates then fall back to mean-threshold comparisons only.
    """
    from dct_tpu_torch.serving.numpy_runtime import _SEQUENCE_FAMILIES

    cw, cm = champion
    hw, hm = challenger

    def shape_key(meta):
        fam = meta.get("model", "weather_mlp")
        seq = int(meta.get("seq_len", 0)) if fam in _SEQUENCE_FAMILIES else 0
        return (fam in _SEQUENCE_FAMILIES, seq, int(meta.get("input_dim", 0)))

    if shape_key(cm) == shape_key(hm):
        x, y = load_eval_split(
            processed_dir, hm, val_fraction=val_fraction, seed=seed,
            data=data,
        )
        champ_res = evaluate_model(
            "champion", cw, cm, x, y, batch_size=batch_size, engine=engine,
            device=device,
        )
        chall_res = evaluate_model(
            "challenger", hw, hm, x, y, batch_size=batch_size, engine=engine,
            device=device,
        )
        deltas = champ_res.per_example_loss - chall_res.per_example_loss
        return PairedEval(champ_res, chall_res, deltas, paired=True)
    # Incomparable input shapes: unpaired mean comparison over each
    # model's own windows of the same held-out rows.
    cx, cy = load_eval_split(
        processed_dir, cm, val_fraction=val_fraction, seed=seed, data=data
    )
    hx, hy = load_eval_split(
        processed_dir, hm, val_fraction=val_fraction, seed=seed, data=data
    )
    champ_res = evaluate_model(
        "champion", cw, cm, cx, cy, batch_size=batch_size, engine=engine,
            device=device,
    )
    chall_res = evaluate_model(
        "challenger", hw, hm, hx, hy, batch_size=batch_size, engine=engine,
            device=device,
    )
    return PairedEval(
        champ_res, chall_res, np.zeros(0, np.float64), paired=False
    )
