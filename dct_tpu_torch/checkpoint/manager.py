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

   On a mesh, a leaf split across processes (a tensor-parallel slice, a
   ZeRO-1 moment block, an FSDP parameter block) is saved as this
   process's block under ``"<i>_s<off0>x<off1>..."``, keyed by its global
   start offsets in flax layout, as the reference's ``_index_key`` keys
   its local shards; every other leaf keeps ``"<i>"`` and is saved whole.
   ``layout.json`` (version 1) records the process index and count, the
   mesh, the dtype rules and, per leaf, its global ``shape``, declared
   ``spec`` and ``"saved": "shards" | "whole"``. A restore reads this
   process's own file on the same topology; where shards are involved and
   the mesh or the process count changed, it raises (the reference re-maps
   shards across topologies: ROADMAP Queue A item 15b).

The deploy tier is dense whatever the placement: :func:`save_checkpoint`
takes the gathered tree (:func:`dct_tpu_torch.parallel.sharding_rules.
gather_tree`, which every process runs; only the coordinator writes).

Both tiers consult the process fault plan inside their write window (the
``save`` point: a temp file written, its final name not yet renamed), so
``slow_save`` widens that window and ``crash_save`` dies inside it: only
``*.tmp`` debris remains and the previous publish stays the one restored.
They put ``best_saved`` / ``last_saved`` / ``resume_state_saved`` on the
event log and their writes and restores on the span timeline.
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
from dct_tpu_torch.observability import events as _events
from dct_tpu_torch.observability import spans as _spans
from dct_tpu_torch.resilience import faults as _faults


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
    # Fault hook inside the window a preemption would tear.
    _faults.get_default().maybe_fire("save", save_kind="deploy", path=path)
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
        with _spans.get_default().span(
                "checkpoint.deploy_write", component="checkpoint",
                epoch=int(epoch)) as sp:
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
            sp.set(improved=improved)
        _events.get_default().emit(
            "checkpoint", "best_saved" if improved else "last_saved",
            epoch=int(epoch),
            path=self.best_model_path if improved else self.last_path,
            **{self.monitor: value})
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
    """The reference's ``jax.tree.leaves`` of an unsplit train state, as
    host arrays, from the port's
    :class:`~dct_tpu_torch.train.state.TrainState`."""
    entries, _ = state_entries(state)
    return [entries[str(i)] for i in range(len(entries))]


def restore_state_leaves(state, leaves: list[np.ndarray]):
    """Fill ``state`` (in place) from the reference's leaf list; raises
    ``KeyError`` when the count or a shape does not fit."""
    return restore_entries(state, {str(i): a for i, a in enumerate(leaves)})


def _leaf_values(state) -> list[tuple[str, int | None, Any]]:
    """Every leaf of the reference's state tree in its order, as ``(kind,
    parameter index or None, value)``: counts, the rng and the step as
    host arrays; moments and parameters as the tensors this process
    stores (torch layout)."""
    from dct_tpu_torch.parallel.sharding_rules import opt_slots

    order = _param_order(state.model)
    out = []
    for kind, _, value in opt_slots(state.tx, state.opt_state):
        if kind == "count":
            out.append(("count", None, np.asarray(value, np.int32)))
        else:
            out += [("moment", i, value[i]) for i, _, _ in order]
    out += [("param", i, state.stored_param(i)) for i, _, _ in order]
    rng = int(state.rng)
    out.append(("rng", None, np.asarray([rng >> 32, rng & 0xFFFFFFFF],
                                        np.uint32)))
    out.append(("step", None, np.asarray(state.step, np.int32)))
    return out


def _leaf_axis(layout, kind: str, i):
    """(the layout leaf, the axis that splits this state leaf or None,
    its declared spec)."""
    if layout is None or i is None:
        return None, None, ()
    lf = layout.leaves[i]
    if kind == "moment":
        return lf, lf.moment_axis, lf.moment_spec
    return lf, lf.param_axis, lf.param_spec


def state_entries(state) -> tuple[dict, list]:
    """(the ``state.npz`` entries of this process, the ``layout.json``
    leaf records): whole leaves under ``"<i>"``, split ones as this
    process's block under ``"<i>_s<offsets>"`` (flax layout, global
    start offsets)."""
    from dct_tpu_torch.parallel.sharding_rules import spec_to_json

    layout = getattr(state, "layout", None)
    order = {i: tr for i, _, tr in _param_order(state.model)}
    entries, records = {}, []
    for n, (kind, i, value) in enumerate(_leaf_values(state)):
        lf, axis, spec = _leaf_axis(layout, kind, i)
        if i is None:
            shape = [int(d) for d in value.shape]
            entries[str(n)] = value
        else:
            a = _to_flax(value, order[i])
            shape = ([int(d) for d in lf.shape] if lf is not None
                     else [int(d) for d in a.shape])
            if axis is None:
                entries[str(n)] = a
            else:
                off = "x".join(str(o) for o in lf.offsets())
                entries[f"{n}_s{off}"] = a
        records.append({"leaf": n, "shape": shape,
                        "spec": spec_to_json(spec),
                        "saved": "shards" if axis else "whole"})
    return entries, records


def restore_entries(state, entries: dict):
    """Fill ``state`` (in place) from ``state.npz`` entries saved on this
    topology; raises ``KeyError`` when a leaf is missing or its count or
    shape does not fit."""
    layout = getattr(state, "layout", None)
    values = _leaf_values(state)
    groups = {k.split("_s")[0] for k in entries if k[:1].isdigit()}
    if len(groups) != len(values):
        raise KeyError(
            f"{len(groups)} leaves saved, {len(values)} expected: "
            "typically DCT_OPTIMIZER (or another state-shaping knob) "
            "changed since the checkpoint was written"
        )
    rows = _param_order(state.model)
    order = {i: tr for i, _, tr in rows}
    params = state.params
    dev = params[0].device

    def tensor(i, a):
        a = np.asarray(a, np.float32)
        return torch.tensor(a.T if order[i] and a.ndim == 2 else a).to(
            device=dev, dtype=params[i].dtype).contiguous()

    prepared = []
    for n, (kind, i, value) in enumerate(values):
        lf, axis, _ = _leaf_axis(layout, kind, i)
        key = str(n)
        if axis is not None:
            key = f"{n}_s" + "x".join(str(o) for o in lf.offsets())
        if key not in entries:
            raise KeyError(
                f"leaf {n} ({kind}) has no entry {key!r}; saved "
                f"{sorted(k for k in entries if k.split('_s')[0] == str(n))}")
        a = entries[key]
        want = (tuple(value.shape) if i is None
                else tuple(_to_flax(value, order[i]).shape))
        if tuple(np.shape(a)) != want:
            raise KeyError(f"leaf {n} has shape {tuple(np.shape(a))} on "
                           f"disk but {want} in the template")
        prepared.append(a if i is None else tensor(i, a))

    def per_param(it):
        out = [None] * len(rows)
        for i, _, _ in rows:
            out[i] = next(it)
        return out

    n_opt = len(prepared) - len(rows) - 2
    *_, key, step = prepared
    step = int(np.asarray(step))
    state.opt_state = _opt_from_leaves(
        state.tx, state.opt_state, iter(prepared[:n_opt]), per_param, step)
    with torch.no_grad():
        for (i, _, _), value in zip(rows, prepared[n_opt:-2]):
            if i in state.shards:
                state.shards[i] = value
            else:
                params[i].copy_(value)
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
    def _layout(state, records) -> dict:
        """``layout.json``: the process topology, the mesh, the dtype
        rules and each leaf's global shape, declared spec and how it was
        saved (:func:`state_entries`)."""
        from dct_tpu_torch.parallel.distributed import (
            process_count,
            process_index,
        )
        from dct_tpu_torch.parallel.mesh import get_mesh
        from dct_tpu_torch.parallel.sharding_rules import dtype_rules_digest

        layout = getattr(state, "layout", None)
        mesh = layout.mesh if layout is not None else get_mesh()
        return {
            "version": 1,
            "process_index": process_index(),
            "process_count": process_count(),
            "mesh": {k: int(v) for k, v in mesh.shape.items()},
            "dtype_rules": dtype_rules_digest(),
            "leaves": records,
        }

    def save(self, state, meta: dict | None = None) -> str:
        """Persist the state now (joins any async write first)."""
        self.wait()
        entries, records = state_entries(state)
        return self._publish(entries, meta, self._layout(state, records))

    def save_async(self, state, meta: dict | None = None) -> None:
        """Snapshot the state to host arrays now and write it on a worker
        thread; at most one write is in flight. :meth:`wait` joins it and
        raises its failure."""
        self.wait()
        entries, records = state_entries(state)
        layout = self._layout(state, records)

        def work():
            try:
                self._publish(entries, meta, layout)
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

    def _publish(self, entries, meta, layout) -> str:
        # Spanned from whichever thread publishes (save_async's worker
        # included); a failed write is recorded too.
        span = _spans.get_default().start(
            "checkpoint.resume_save", component="checkpoint",
            epochs_completed=(meta or {}).get("epochs_completed"))
        try:
            return self._publish_inner(entries, meta, layout)
        except BaseException as e:
            span.attrs["error"] = type(e).__name__
            raise
        finally:
            span.end()

    def _publish_inner(self, entries, meta, layout) -> str:
        next_dir = self._dir(self._NEXT)
        if os.path.isdir(next_dir):
            shutil.rmtree(next_dir)
        os.makedirs(next_dir)
        for name, write in (
            ("state.npz", lambda f: np.savez(f, **entries)),
            ("meta.json", lambda f: f.write(json.dumps(meta).encode())),
            ("layout.json", lambda f: f.write(json.dumps(layout).encode())),
        ):
            if name == "meta.json" and meta is None:
                continue
            final = os.path.join(next_dir, name)
            with open(final + ".tmp", "wb") as f:
                write(f)
            if name == "state.npz":
                # Fault hook between the state write and its rename: a
                # crash_save here leaves state.next with only *.tmp
                # debris, which _restore_candidates skips.
                _faults.get_default().maybe_fire(
                    "save", save_kind="resume_state", dir=next_dir)
            os.replace(final + ".tmp", final)
        live, old = self._dir(self._LIVE), self._dir(self._OLD)
        if os.path.isdir(old):
            shutil.rmtree(old)
        if os.path.isdir(live):
            os.rename(live, old)
        os.rename(next_dir, live)
        if os.path.isdir(old):
            shutil.rmtree(old)
        # The supervisor reads these to count the wall clock a failed
        # attempt lost since its last durable resume point.
        _events.get_default().emit(
            "checkpoint", "resume_state_saved", dir=live,
            epochs_completed=(meta or {}).get("epochs_completed"))
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
        with _spans.get_default().span("checkpoint.restore",
                                       component="checkpoint"):
            return self._restore(state)

    def _restore(self, state):
        candidates = self._restore_candidates()
        if not candidates:
            raise FileNotFoundError(
                f"No train-state checkpoint under {self.dirpath}")
        with np.load(os.path.join(candidates[0], "state.npz")) as npz:
            entries = {k: npz[k] for k in npz.files}
        self._check_topology(state, candidates[0], entries)
        try:
            return restore_entries(state, entries)
        except KeyError as e:
            raise KeyError(
                f"Checkpoint {candidates[0]} does not match this run's "
                f"TrainState: {e.args[0]}. Restore the original setting, "
                f"or clear {self.dirpath} to restart the trajectory."
            ) from e

    def _check_topology(self, state, where: str, entries: dict) -> None:
        """Refuse a restore that would have to re-map shards: shard-saved
        leaves, or a split template, under another mesh or process count
        than the saving run's."""
        layout = getattr(state, "layout", None)
        split_now = layout is not None and layout.sharded
        shards = any("_s" in k for k in entries)
        if not (split_now or shards):
            return
        try:
            with open(os.path.join(where, "layout.json")) as f:
                saved = json.load(f)
        except (OSError, ValueError):
            saved = {}
        now = self._layout(state, [])
        was = {"mesh": saved.get("mesh"),
               "process_count": saved.get("process_count")}
        cur = {"mesh": now["mesh"], "process_count": now["process_count"]}
        if was != cur:
            raise RuntimeError(
                f"Checkpoint {where} was saved on topology {was} and this "
                f"run is {cur}: a shard-saved resume restores on the saving "
                "topology only (re-mapping shards onto another mesh is "
                "ROADMAP Queue A item 15b). Resume with the saving mesh, or "
                f"clear {self.dirpath} to restart the trajectory.")
