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
  DCT_PREDICT_DTYPE   ``float32`` (default) or ``bfloat16``: the torch
                      engine computes in bf16 over the checkpoint's f32
                      weights (the bf16 flash forward on the card), as the
                      reference's jax engine does
  DCT_DEVICE          ``cpu`` for the CPU; default ``cuda:<rank>``
  WORLD_SIZE / NODE_RANK / MASTER_ADDR / MASTER_PORT and DCT_MESH_DATA /
  DCT_MESH_MODEL / DCT_MESH_SEQ  a world of processes (one a card, NCCL;
                      gloo on the CPU) on the grid ``train_job`` takes

Sequence families score sliding windows (prediction i is the forecast for
the row after window i); row families score each row. Columns: ``row``
(int64), ``predicted`` (int32 argmax), ``prob_<c>`` (float32) per class,
``label`` (int32) when the data carries labels; a multi-horizon causal
checkpoint (meta horizon H > 1) writes ``prob_h<k>_<c>`` for k = 1..H and
``pred_h<k>`` for k >= 2 instead, ``predicted`` staying the next step's.
The parquet goes through the port's own codec
(:mod:`dct_tpu_torch.etl.parquet`).

The torch engine is the reference's mesh engine (``jobs/predict.py:
62-138``), on one card as on a world: every rank builds the registry
model with the mesh and attention engines ``train_job`` builds (tensor
parallelism at ``model > 1``, the ring or all-to-all engine at
``seq > 1``), loads the checkpoint's dense weights and keeps its
placement of them by the family rules
(:func:`~dct_tpu_torch.serving.batching.mesh_scorer`), and scores its
``data`` share of each chunk (:func:`~dct_tpu_torch.parallel.mesh.
score_split`: the last chunk padded as the reference pads it); only the
coordinator writes the parquet. The job prints the set-up's seconds
(``build_s``: model, weights) apart from the scoring loop's, and the
windows a second of the chunks after the first (the first also pays the
first collective and the kernels' load).
"""

from __future__ import annotations

import glob
import json
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


def score_in_chunks(fn, x: np.ndarray, chunk: int) -> np.ndarray:
    """``fn`` (rows -> probabilities) over ``x`` in chunks of ``chunk``
    rows, concatenated: the numpy engine's loop."""
    parts = []
    for start in range(0, len(x), chunk):
        parts.append(fn(np.ascontiguousarray(x[start:start + chunk],
                                             np.float32)))
    return np.concatenate(parts, axis=0)


def score(weights: dict, meta: dict, x: np.ndarray, chunk: int,
          engine: str = "torch", device=None, dtype: str = "float32",
          mesh=None, timings: dict | None = None) -> np.ndarray:
    """Probabilities of ``x`` in chunks of ``chunk`` rows: ``[N, C]``, or
    ``[N, H, C]`` for a multi-horizon causal model. The torch engine is
    the mesh engine (module docstring), which every process of the grid
    runs, on one card too. ``timings``, when given, gets ``build_s`` (the
    engine's set-up: the model built and its weights loaded) and
    ``chunk_s`` (each chunk's real rows and seconds, its probabilities
    on the host)."""
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"DCT_PREDICT_DTYPE={dtype!r} not in ('float32', 'bfloat16')")
    timings = {} if timings is None else timings
    t0 = time.perf_counter()
    if engine == "numpy":
        from dct_tpu_torch.serving.runtime import forward_numpy, softmax_numpy

        timings.update(build_s=0.0, chunk_s=[])
        return score_in_chunks(
            lambda piece: softmax_numpy(forward_numpy(weights, meta, piece)),
            x, chunk)
    if engine == "torch":
        import torch

        from dct_tpu_torch.device import resolve_device
        from dct_tpu_torch.parallel.mesh import get_mesh, score_split
        from dct_tpu_torch.serving.batching import mesh_scorer

        mesh = mesh or get_mesh()
        fn = mesh_scorer(weights, meta, resolve_device(device), mesh,
                         getattr(torch, dtype))
        timings.update(build_s=time.perf_counter() - t0, chunk_s=[])
        return score_split(fn, x, chunk, mesh, times=timings["chunk_s"])
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
    from dct_tpu_torch.config import DistributedConfig, MeshConfig
    from dct_tpu_torch.device import process_device
    from dct_tpu_torch.parallel.distributed import initialize_from_env
    from dct_tpu_torch.parallel.mesh import make_mesh, set_mesh

    engine = os.environ.get("DCT_PREDICT_ENGINE", "torch").strip().lower()
    if engine != "torch":
        return _predict(engine, None, None)
    cfg = DistributedConfig.from_env()
    device = process_device(cfg.process_id, cfg.num_processes,
                            os.environ.get("DCT_DEVICE") or None)
    initialize_from_env(cfg, device=device)
    try:
        mesh = make_mesh(MeshConfig.from_env())
        set_mesh(mesh)
        return _predict(engine, device, mesh)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def _predict(engine: str, device, mesh) -> int:
    from dct_tpu_torch.data.dataset import load_processed_dataset
    from dct_tpu_torch.data.windows import make_windows
    from dct_tpu_torch.etl.parquet import write_table
    from dct_tpu_torch.parallel.distributed import is_coordinator
    from dct_tpu_torch.serving.runtime import _SEQUENCE_FAMILIES
    from dct_tpu_torch.serving.score_gen import weights_from_checkpoint

    dtype = os.environ.get("DCT_PREDICT_DTYPE", "float32").strip().lower()
    models_dir = os.environ.get("DCT_MODELS_DIR", "data/models")
    processed = os.environ.get("DCT_PROCESSED_DIR", "data/processed")
    out_path = os.environ.get("DCT_PREDICTIONS",
                              "data/predictions/predictions.parquet")
    ckpt = find_checkpoint(models_dir)
    weights, meta = weights_from_checkpoint(ckpt)
    family = meta.get("model", "weather_mlp")
    lead = is_coordinator()
    if lead:
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
    timings: dict = {}
    t0 = time.perf_counter()
    probs = score(weights, meta, x, chunk, engine, device, dtype, mesh,
                  timings)
    chunks = timings["chunk_s"] or [(len(x), time.perf_counter() - t0)]
    score_s = sum(s for _, s in chunks)
    rest = chunks[1:] or chunks
    steady = sum(n for n, _ in rest) / sum(s for _, s in rest)
    from dct_tpu_torch.ops.flash_attention import launch_counts

    mesh_shape = {} if mesh is None else dict(mesh.shape)
    print(f"[predict_job] scored {len(index)} in {score_s:.4f} s "
          f"(build {timings['build_s']:.4f} s, first chunk "
          f"{chunks[0][1]:.4f} s, {steady:.1f} windows/s after it; "
          f"{engine} engine, {dtype}, chunk {chunk}, mesh {mesh_shape}); "
          f"launches {json.dumps(launch_counts())}", flush=True)
    if not lead:
        return 0
    frame, acc = prediction_columns(probs, index, truth)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    write_table(out_path, frame)
    print(f"Wrote {len(index)} predictions to {out_path}"
          + (f" (accuracy vs recorded labels: {acc:.4f})" if acc == acc
             else ""), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
