"""Batch inference: processed parquet in, predictions parquet out
(counterpart of ``jobs/predict.py``).

    python -m dct_tpu_torch.predict_job

Environment:
  DCT_CKPT            checkpoint to score with (default: the newest
                      ``weather-best-*.ckpt`` under DCT_MODELS_DIR, else
                      ``last.ckpt``)
  DCT_MODELS_DIR      where checkpoints live                [data/models]
  DCT_PROCESSED_DIR   the ETL's parquet to score            [data/processed]
  DCT_PREDICTIONS     output parquet [data/predictions/predictions.parquet]
  DCT_PREDICT_ENGINE  ``torch`` (default: the registry model on the card,
                      every layer's attention on the flash kernel; the
                      counterpart of the reference's ``jax`` engine) or
                      ``numpy`` (the serving twin, the reference's numbers
                      bit for bit)
  DCT_PREDICT_CHUNK   windows (rows) per forward [8192]. At the full-width
                      transformer (d_model 512, d_ff 2048, seq_len 1024)
                      8192 windows need about 64 GiB for one layer's d_ff
                      activations in f32; 256 windows (2 GiB a d_ff tensor)
                      fit on an 80 GB card
  DCT_DEVICE          ``cpu`` for the CPU; default ``cuda:0``

Sequence families score sliding windows (prediction i is the forecast for
the row after window i); row families score each row. Columns: ``row``
(int64), ``predicted`` (int32 argmax), ``prob_<c>`` (float32) per class,
``label`` (int32) when the data carries labels; a multi-horizon causal
checkpoint (meta horizon H > 1) writes ``prob_h<k>_<c>`` for k = 1..H and
``pred_h<k>`` for k >= 2 instead, ``predicted`` staying the next step's.
The parquet goes through the port's own codec
(:mod:`dct_tpu_torch.etl.parquet`). The reference's ``DCT_PREDICT_DTYPE=
bfloat16`` and its mesh layout are not ported (ROADMAP Queue A items 3
and 15): the first raises.
"""

from __future__ import annotations

import glob
import os
import sys
import time

import numpy as np


def find_checkpoint(models_dir: str) -> str:
    """``DCT_CKPT``, else the newest ``weather-best-*.ckpt`` by mtime (the
    name embeds val_loss, so a name sort would pick the worst), else
    ``last.ckpt``; raises ``FileNotFoundError``."""
    explicit = os.environ.get("DCT_CKPT")
    if explicit:
        if not os.path.exists(explicit):
            raise FileNotFoundError(f"DCT_CKPT={explicit} does not exist")
        return explicit
    best = sorted(glob.glob(os.path.join(models_dir, "weather-best-*.ckpt")),
                  key=os.path.getmtime)
    if best:
        return best[-1]
    last = os.path.join(models_dir, "last.ckpt")
    if os.path.exists(last):
        return last
    raise FileNotFoundError(
        f"No checkpoint under {models_dir} (expected weather-best-*.ckpt "
        "or last.ckpt; set DCT_CKPT to score a specific file)"
    )


def score_in_chunks(fn, x: np.ndarray, chunk: int, *,
                    pad_last: bool = False) -> np.ndarray:
    """``fn`` (rows -> probabilities) over ``x`` in chunks of ``chunk``
    rows, concatenated. With ``pad_last`` (a model whose routing depends on
    the rows scored together: ``routing_depends_on_batch``, the MoE), an
    input that spans more than one chunk has its partial last chunk padded
    to ``chunk`` rows with repeats of its last row, as the reference's
    accelerator engines do (``jobs/predict.py:118-128``,
    ``dct_tpu/evaluation/harness.py:243-249``), and only its real rows'
    answers kept."""
    parts = []
    for start in range(0, len(x), chunk):
        piece = np.ascontiguousarray(x[start:start + chunk], np.float32)
        real = len(piece)
        if pad_last and len(x) > chunk and real < chunk:
            piece = np.concatenate(
                [piece, np.repeat(piece[-1:], chunk - real, axis=0)])
        parts.append(fn(piece)[:real])
    return np.concatenate(parts, axis=0)


def score(weights: dict, meta: dict, x: np.ndarray, chunk: int,
          engine: str = "torch", device=None) -> np.ndarray:
    """Probabilities of ``x`` in chunks of ``chunk`` rows: ``[N, C]``, or
    ``[N, H, C]`` for a multi-horizon causal model. The torch engine pads
    an MoE checkpoint's partial last chunk as the reference's jax engine
    does (:func:`score_in_chunks`)."""
    if engine == "numpy":
        from dct_tpu_torch.serving.runtime import forward_numpy, softmax_numpy

        return score_in_chunks(
            lambda piece: softmax_numpy(forward_numpy(weights, meta, piece)),
            x, chunk)
    if engine == "torch":
        from dct_tpu_torch.device import resolve_device
        from dct_tpu_torch.serving.batching import TorchScorer

        scorer = TorchScorer(weights, meta, resolve_device(device))
        return score_in_chunks(scorer, x, chunk, pad_last=scorer.true_shape)
    raise ValueError(
        f"DCT_PREDICT_ENGINE={engine!r} not in ('torch', 'numpy')")


def prediction_columns(probs: np.ndarray, index: np.ndarray,
                       truth) -> tuple[dict, float]:
    """The output table's columns and the accuracy against ``truth``
    (nan without labels)."""
    frame = {"row": np.asarray(index, np.int64)}
    if probs.ndim == 3:
        pred = np.argmax(probs[:, 0], axis=-1)
        frame["predicted"] = pred.astype(np.int32)
        for h in range(probs.shape[1]):
            if h > 0:
                frame[f"pred_h{h + 1}"] = np.argmax(
                    probs[:, h], axis=-1).astype(np.int32)
            for c in range(probs.shape[-1]):
                frame[f"prob_h{h + 1}_{c}"] = probs[:, h, c].astype(np.float32)
    else:
        pred = np.argmax(probs, axis=-1)
        frame["predicted"] = pred.astype(np.int32)
        for c in range(probs.shape[-1]):
            frame[f"prob_{c}"] = probs[:, c].astype(np.float32)
    acc = float("nan")
    if truth is not None and np.asarray(truth).ndim == 1:
        frame["label"] = np.asarray(truth, np.int32)
        acc = float((pred == np.asarray(truth)).mean())
    return frame, acc


def main() -> int:
    from dct_tpu_torch.data.dataset import load_processed_dataset
    from dct_tpu_torch.data.windows import make_windows
    from dct_tpu_torch.etl.parquet import write_table
    from dct_tpu_torch.serving.runtime import _SEQUENCE_FAMILIES
    from dct_tpu_torch.serving.score_gen import weights_from_checkpoint

    if os.environ.get("DCT_PREDICT_DTYPE", "float32") != "float32":
        raise NotImplementedError(
            "DCT_PREDICT_DTYPE=bfloat16 (bf16 compute over f32 weights) is "
            "not ported: ROADMAP Queue A item 3")
    models_dir = os.environ.get("DCT_MODELS_DIR", "data/models")
    processed = os.environ.get("DCT_PROCESSED_DIR", "data/processed")
    out_path = os.environ.get("DCT_PREDICTIONS",
                              "data/predictions/predictions.parquet")
    ckpt = find_checkpoint(models_dir)
    weights, meta = weights_from_checkpoint(ckpt)
    family = meta.get("model", "weather_mlp")
    print(f"Scoring with {ckpt} (family={family})", flush=True)

    data = load_processed_dataset(processed)
    if data.input_dim != int(meta.get("input_dim", data.input_dim)):
        raise ValueError(
            f"Checkpoint expects input_dim={meta.get('input_dim')} but the "
            f"processed data has {data.input_dim} features")
    if family in _SEQUENCE_FAMILIES:
        seq_len = int(meta["seq_len"])
        windows = make_windows(data, seq_len)
        x, truth = windows.features, windows.labels
        index = np.arange(seq_len, seq_len + len(windows))
    else:
        x, truth = data.features, data.labels
        index = np.arange(len(data))
    chunk = int(os.environ.get("DCT_PREDICT_CHUNK", "8192"))
    engine = os.environ.get("DCT_PREDICT_ENGINE", "torch").strip().lower()
    t0 = time.perf_counter()
    probs = score(weights, meta, x, chunk, engine,
                  os.environ.get("DCT_DEVICE") or None)
    score_s = time.perf_counter() - t0
    frame, acc = prediction_columns(probs, index, truth)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    write_table(out_path, frame)
    print(f"Wrote {len(index)} predictions to {out_path}"
          + (f" (accuracy vs recorded labels: {acc:.4f})" if acc == acc
             else ""), flush=True)
    from dct_tpu_torch.ops.flash_attention import launch_counts

    print(f"[predict_job] scored {len(index)} in {score_s:.4f} s "
          f"({engine} engine, chunk {chunk}); launches {launch_counts()}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
