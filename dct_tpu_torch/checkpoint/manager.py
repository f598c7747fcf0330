"""Checkpointing: the best/last deploy tier and the full-state resume tier
(counterpart of ``dct_tpu/checkpoint/manager.py``).

1. **Deploy tier**: single ``*.ckpt`` files in flax's msgpack layout
   (:mod:`dct_tpu_torch.checkpoint.msgpack`) holding ``{"meta": {...},
   "params": {"params": <flax param tree>}}``, the bytes the reference's
   ``save_checkpoint`` writes for the same weights.
   :class:`BestLastCheckpointer` keeps ``weather-best-{epoch:02d}-
   {val_loss:.2f}.ckpt`` (the best val_loss so far) and ``last.ckpt``.
2. **Resume tier**: per process, ``p<rank>/state/`` holds ``state.npz``,
   ``meta.json`` and ``layout.json``, published through a
   ``state.next`` -> ``state`` rotation so one complete checkpoint exists
   at every instant. ``state.npz`` stores the reference's TrainState
   leaves by index, in the order ``jax.tree.leaves`` gives them for
   ``{"opt_state", "params", "rng", "step"}``: the optax state (Adam's
   ``count``, ``mu`` and ``nu``; a schedule's count), the flax param tree,
   the dropout key as uint32[2], the int32 step. Parameters and moments
   are in flax layout (dense kernels ``[in, out]``), so either side
   resumes the other's run.

Cross-process sharded leaves (saved as local shards by the reference)
wait for ROADMAP Queue A item 15: here every leaf is saved whole.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from dct_tpu_torch.checkpoint import msgpack


def param_tree(model: torch.nn.Module) -> dict:
    """``{"params": <nested flax param tree>}`` of f32 host arrays."""
    from dct_tpu_torch.convert import flax_weights

    tree: dict = {}
    for key, value in flax_weights(model).items():
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(value, np.float32)
    return {"params": tree}


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """Nested param tree -> flat ``{"a/b/c": ndarray}``."""
    out = {}
    for name, val in tree.items():
        key = f"{prefix}/{name}" if prefix else str(name)
        if isinstance(val, dict):
            out.update(flatten_tree(val, key))
        else:
            out[key] = val
    return out


def save_checkpoint(path: str, params: Any, meta: dict) -> str:
    """Write ``{"meta", "params"}`` as one msgpack file, through a
    pid-suffixed temp file and ``os.replace`` (never a torn file).
    ``params`` is a model or a ``{"params": tree}`` of host arrays."""
    if isinstance(params, torch.nn.Module):
        params = param_tree(params)
    data = msgpack.serialize({"meta": dict(meta), "params": params})
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> tuple[Any, dict]:
    """Returns ``(params, meta)``: the ``{"params": tree}`` of host
    arrays and the meta dict."""
    with open(path, "rb") as f:
        payload = msgpack.restore(f.read())
    return payload["params"], dict(payload["meta"])


class BestLastCheckpointer:
    """save_top_k=1 on min val_loss, plus an always-updated last.ckpt."""

    def __init__(self, dirpath: str, *,
                 filename_template: str = "weather-best-{epoch:02d}-{val_loss:.2f}",
                 monitor: str = "val_loss", mode: str = "min"):
        self.dirpath = dirpath
        self.filename_template = filename_template
        self.monitor = monitor
        self.sign = 1.0 if mode == "min" else -1.0
        self.best_value: float | None = None
        self.best_model_path: str = ""
        os.makedirs(dirpath, exist_ok=True)

    @property
    def last_path(self) -> str:
        return os.path.join(self.dirpath, "last.ckpt")

    def update(self, *, epoch: int, metrics: dict, params: Any,
               meta: dict) -> bool:
        """Write last.ckpt; if the monitor improved, replace the best
        file. Returns True when a new best was saved."""
        meta = {**meta, "epoch": int(epoch),
                **{k: float(v) for k, v in metrics.items()}}
        if isinstance(params, torch.nn.Module):
            params = param_tree(params)
        save_checkpoint(self.last_path, params, meta)
        value = float(metrics[self.monitor])
        improved = (self.best_value is None
                    or self.sign * value < self.sign * self.best_value)
        if improved:
            name = self.filename_template.format(epoch=epoch, **metrics)
            new_path = os.path.join(self.dirpath, name + ".ckpt")
            save_checkpoint(new_path, params, meta)
            old = self.best_model_path
            if old and os.path.exists(old) and (
                    os.path.abspath(old) != os.path.abspath(new_path)):
                os.remove(old)
            self.best_value = value
            self.best_model_path = new_path
        return improved


# ------------------------------------------------------------ resume tier


def _param_order(model: torch.nn.Module) -> list[tuple[int, str, bool]]:
    """(index in ``model.parameters()``, flax key, transposed) in the
    order ``jax.tree.leaves`` visits the flax param tree: keys sorted
    level by level."""
    from dct_tpu_torch.convert import flax_names

    names = flax_names(model)
    rows = [(i, *names[name]) for i, (name, _) in
            enumerate(model.named_parameters())]
    return sorted(rows, key=lambda r: r[1].split("/"))


def _to_flax(t: torch.Tensor, transposed: bool) -> np.ndarray:
    # Always a copy: on the CPU ``.numpy()`` shares the live tensor's
    # storage, which the next step updates in place while an async save
    # is still writing.
    a = t.detach().float().cpu().numpy()
    return np.array(a.T if transposed else a, order="C")


def _opt_leaves(tx, st, per_param) -> list:
    """The optax leaves of the port's optimizer state ``st``."""
    if tx.kind == "chain":
        return [leaf for t, s in zip(tx.parts, st)
                for leaf in _opt_leaves(t, s, per_param)]
    count = lambda c: np.asarray(c, np.int32)  # noqa: E731
    if tx.kind == "adam":
        return [count(st["count"]), *per_param(st["mu"]),
                *per_param(st["nu"])]
    if tx.kind == "lion":
        return [count(st["count"]), *per_param(st["mu"])]
    if tx.kind == "trace":
        return per_param(st)
    if tx.kind == "schedule":
        return [count(st)]
    return []


def _opt_from_leaves(tx, st, it, per_param, step: int):
    """The port's optimizer state from the optax leaves of ``it``, shaped
    like the template ``st``."""
    if tx.kind == "chain":
        return [_opt_from_leaves(t, s, it, per_param, step)
                for t, s in zip(tx.parts, st)]
    if tx.kind == "adam":
        return {"count": int(next(it)), "mu": per_param(it),
                "nu": per_param(it)}
    if tx.kind == "lion":
        return {"count": int(next(it)), "mu": per_param(it)}
    if tx.kind == "trace":
        return per_param(it)
    if tx.kind == "schedule":
        return int(next(it))
    # A constant rate's count is not part of optax's state; the port's
    # counts updates, which is the step.
    return step if isinstance(st, int) else st


def state_leaves(state) -> list[np.ndarray]:
    """The reference's ``jax.tree.leaves`` of the train state, as host
    arrays, from the port's :class:`~dct_tpu_torch.train.state.TrainState`."""
    order = _param_order(state.model)

    def per_param(tensors):
        return [_to_flax(tensors[i], tr) for i, _, tr in order]

    params = state.params
    rng = int(state.rng)
    return [
        *_opt_leaves(state.tx, state.opt_state, per_param),
        *per_param(params),
        np.asarray([rng >> 32, rng & 0xFFFFFFFF], np.uint32),
        np.asarray(state.step, np.int32),
    ]


def restore_state_leaves(state, leaves: list[np.ndarray]):
    """Fill ``state`` (in place) from the reference's leaf list; raises
    ``KeyError`` when the count or a shape does not fit."""
    template = state_leaves(state)
    if len(leaves) != len(template):
        raise KeyError(
            f"{len(leaves)} leaves saved, {len(template)} expected: "
            "typically DCT_OPTIMIZER (or another state-shaping knob) "
            "changed since the checkpoint was written"
        )
    for i, (a, t) in enumerate(zip(leaves, template)):
        if tuple(np.shape(a)) != tuple(t.shape):
            raise KeyError(f"leaf {i} has shape {tuple(np.shape(a))} on "
                           f"disk but {tuple(t.shape)} in the template")
    order = _param_order(state.model)
    params = state.params
    dev = params[0].device

    def per_param(it):
        out = [None] * len(order)
        for i, _, tr in order:
            a = np.asarray(next(it), np.float32)
            out[i] = torch.tensor(a.T if tr else a).to(
                device=dev, dtype=params[i].dtype).contiguous()
        return out

    n_opt = len(leaves) - len(order) - 2
    *_, key, step = leaves
    step = int(np.asarray(step))
    state.opt_state = _opt_from_leaves(
        state.tx, state.opt_state, iter(leaves[:n_opt]), per_param, step)
    with torch.no_grad():
        for p, value in zip(params, per_param(iter(leaves[n_opt:-2]))):
            p.copy_(value)
    key = np.asarray(key).astype(np.uint64)
    state.rng = int(key[0]) << 32 | int(key[1])
    state.step = step
    return state


class TrainStateCheckpointer:
    """Full train-state save/restore for true resume: one directory per
    process with crash-safe rotation (``state`` > ``state.next`` >
    ``state.old``)."""

    _LIVE, _NEXT, _OLD = "state", "state.next", "state.old"

    def __init__(self, dirpath: str):
        self.dirpath = os.path.abspath(dirpath)
        os.makedirs(self.dirpath, exist_ok=True)
        self._pending: threading.Thread | None = None
        self._error: BaseException | None = None

    def _dir(self, name: str) -> str:
        return os.path.join(self.dirpath, name)

    def _restore_candidates(self) -> list[str]:
        return [self._dir(n) for n in (self._LIVE, self._NEXT, self._OLD)
                if os.path.exists(os.path.join(self._dir(n), "state.npz"))]

    @staticmethod
    def _layout(state, leaves) -> dict:
        """``layout.json``: each leaf's global shape, its PartitionSpec
        (every leaf is replicated over the data axis: ``[]``) and how it
        was saved, with the process topology and the dtype rules."""
        from dct_tpu_torch.parallel.distributed import (
            process_count,
            process_index,
        )
        from dct_tpu_torch.parallel.sharding_rules import dtype_rules_digest

        return {
            "version": 1,
            "process_index": process_index(),
            "process_count": process_count(),
            "mesh": {"data": process_count(), "model": 1, "seq": 1,
                     "pipe": 1},
            "dtype_rules": dtype_rules_digest(),
            "leaves": [{"leaf": i, "shape": [int(s) for s in a.shape],
                        "spec": [], "saved": "whole"}
                       for i, a in enumerate(leaves)],
        }

    def save(self, state, meta: dict | None = None) -> str:
        """Persist the state now (joins any async write first)."""
        self.wait()
        leaves = state_leaves(state)
        return self._publish(leaves, meta, self._layout(state, leaves))

    def save_async(self, state, meta: dict | None = None) -> None:
        """Snapshot the state to host arrays now and write it on a worker
        thread; at most one write is in flight. :meth:`wait` joins it and
        raises its failure."""
        self.wait()
        leaves = state_leaves(state)
        layout = self._layout(state, leaves)

        def work():
            try:
                self._publish(leaves, meta, layout)
            except BaseException as e:  # surfaced by the next wait()
                self._error = e

        self._pending = threading.Thread(target=work, daemon=True)
        self._pending.start()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"async train-state checkpoint write failed: {err!r}"
            ) from err

    def _publish(self, leaves, meta, layout) -> str:
        next_dir = self._dir(self._NEXT)
        if os.path.isdir(next_dir):
            shutil.rmtree(next_dir)
        os.makedirs(next_dir)
        for name, write in (
            ("state.npz", lambda f: np.savez(
                f, **{str(i): a for i, a in enumerate(leaves)})),
            ("meta.json", lambda f: f.write(json.dumps(meta).encode())),
            ("layout.json", lambda f: f.write(json.dumps(layout).encode())),
        ):
            if name == "meta.json" and meta is None:
                continue
            final = os.path.join(next_dir, name)
            with open(final + ".tmp", "wb") as f:
                write(f)
            os.replace(final + ".tmp", final)
        live, old = self._dir(self._LIVE), self._dir(self._OLD)
        if os.path.isdir(old):
            shutil.rmtree(old)
        if os.path.isdir(live):
            os.rename(live, old)
        os.rename(next_dir, live)
        if os.path.isdir(old):
            shutil.rmtree(old)
        return live

    def exists(self) -> bool:
        self.wait()
        return bool(self._restore_candidates())

    def load_meta(self) -> dict:
        """Run facts saved beside the newest checkpoint ({} if none)."""
        self.wait()
        candidates = self._restore_candidates()
        path = os.path.join(candidates[0], "meta.json") if candidates else ""
        if not path or not os.path.exists(path):
            return {}
        with open(path) as f:
            return dict(json.load(f))

    def restore(self, state):
        """Restore into ``state`` (in place) and return it."""
        self.wait()
        candidates = self._restore_candidates()
        if not candidates:
            raise FileNotFoundError(
                f"No train-state checkpoint under {self.dirpath}")
        with np.load(os.path.join(candidates[0], "state.npz")) as npz:
            keys = sorted((k for k in npz.files if k.isdigit()), key=int)
            if keys != [str(i) for i in range(len(keys))] or len(keys) != len(
                    npz.files):
                raise KeyError(
                    f"{candidates[0]}/state.npz holds {sorted(npz.files)}: "
                    "shard-saved leaves (a sharded run) wait for ROADMAP "
                    "Queue A item 15")
            leaves = [npz[k] for k in keys]
        try:
            return restore_state_leaves(state, leaves)
        except KeyError as e:
            raise KeyError(
                f"Checkpoint {candidates[0]} does not match this run's "
                f"TrainState: {e.args[0]}. Restore the original setting, "
                f"or clear {self.dirpath} to restart the trajectory."
            ) from e
