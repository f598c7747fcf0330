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
   ZeRO-1 moment block, an FSDP block, a rule's placement) is saved as
   this process's block under ``"<i>_s<off0>x<off1>..."``, keyed by its
   global start offsets in flax layout, as the reference's
   ``_index_key`` keys its local shards; every other leaf keeps ``"<i>"``
   and is saved whole. ``layout.json`` (version 1) records the process
   index and count, the mesh, the dtype rules and, per leaf, its global
   ``shape``, stored ``spec`` and ``"saved": "shards" | "whole"``.

   A restore reads this process's own file. A leaf whose saved block is
   the one this run's layout places here (offsets **and** extents)
   loads as it is; any other is **re-mapped** (the reference's
   ``_reassemble``, ``dct_tpu/checkpoint/manager.py:577-634``): the
   dense leaf is assembled from this process's entries and those of its
   sibling ranks' ``p<rank>/`` directories beside it (a shared
   filesystem), and this run's block taken from it, so a checkpoint
   saved on ``data=2, model=2`` resumes on ``data=4`` with the values
   bit-identical. A rank with no file of its own (a grown world)
   restores from its siblings alone, and :meth:`TrainStateCheckpointer.
   exists` and :meth:`~TrainStateCheckpointer.load_meta` answer from
   them. A sibling whose ``epochs_completed`` differs from this
   process's (or, without one, the first sibling's) is stale and never
   merged. Shards that do not tile a leaf (a private disk, a missing or
   stale sibling) raise with the way out. A re-map puts
   ``shard.topology_remap`` on the event log and the restore's span and
   sets :attr:`TrainStateCheckpointer.last_remap`.

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
    restore_entries(state, {str(i): a for i, a in enumerate(leaves)})
    return state


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


def _leaf_spec(layout, kind: str, i):
    """(the layout leaf, the stored spec of this state leaf) or (None,
    ())."""
    if layout is None or i is None:
        return None, ()
    lf = layout.leaves[i]
    return lf, lf.moment_spec if kind == "moment" else lf.param_spec


def _entry_key(n: int, lf, spec) -> str:
    if lf is None or not lf.splits(spec):
        return str(n)
    return f"{n}_s" + "x".join(str(o) for o in lf.offsets(spec))


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
        lf, spec = _leaf_spec(layout, kind, i)
        if i is None:
            shape = [int(d) for d in value.shape]
            entries[str(n)] = value
        else:
            a = _to_flax(value, order[i])
            shape = ([int(d) for d in lf.shape] if lf is not None
                     else [int(d) for d in a.shape])
            entries[_entry_key(n, lf, spec)] = a
        records.append({"leaf": n, "shape": shape,
                        "spec": spec_to_json(spec),
                        "saved": ("shards" if lf is not None
                                  and lf.splits(spec) else "whole")})
    return entries, records


def _parts(entries: dict, n: int) -> dict:
    """Leaf ``n``'s entries keyed by their global start offsets (a whole
    entry at the origin)."""
    out = {}
    prefix = f"{n}_s"
    for k, v in entries.items():
        if k == str(n):
            out[(0,) * np.ndim(v)] = v
        elif k.startswith(prefix):
            rest = k[len(prefix):]
            out[tuple(int(o) for o in rest.split("x")) if rest else ()] = v
    return out


def _assemble_dense(gshape: tuple, parts: dict):
    """Offset-keyed blocks -> one dense array, or None when they do not
    tile ``gshape`` exactly (out of bounds, gaps, overlaps), as the
    reference's ``_assemble_dense``."""
    first = next(iter(parts.values()))
    dense = np.zeros(gshape, dtype=first.dtype)
    covered = 0
    for off, arr in parts.items():
        off = tuple(off) + (0,) * (len(gshape) - len(off))
        if np.ndim(arr) != len(gshape) or any(
                o + s > g for o, s, g in zip(off, np.shape(arr), gshape)):
            return None
        dense[tuple(slice(o, o + s)
                    for o, s in zip(off, np.shape(arr)))] = arr
        covered += np.size(arr)
    return dense if covered == dense.size else None


def restore_entries(state, entries: dict, extra=None) -> list[int]:
    """Fill ``state`` (in place) from ``state.npz`` entries. A leaf whose
    entry is this layout's block (its key and extents) loads as it is;
    any other is re-mapped from the dense leaf assembled from
    ``entries`` and ``extra(n)`` (leaf ``n``'s blocks in sibling ranks'
    files, by offsets). Returns the
    re-mapped leaves; raises ``KeyError`` when the leaf count or a
    whole leaf's shape does not fit, ``ValueError`` when the blocks do
    not tile a leaf."""
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

    prepared, remapped = [], []
    for n, (kind, i, value) in enumerate(values):
        lf, spec = _leaf_spec(layout, kind, i)
        want = (tuple(value.shape) if i is None
                else tuple(_to_flax(value, order[i]).shape))
        key = _entry_key(n, lf, spec)
        a = entries.get(key)
        if a is None or tuple(np.shape(a)) != want:
            gshape = tuple(lf.shape) if lf is not None else want
            parts = _parts(entries, n)
            if not parts:
                raise KeyError(f"leaf {n} ({kind}) has no entry")
            whole = entries.get(str(n))
            if whole is not None and tuple(np.shape(whole)) != gshape:
                raise KeyError(f"leaf {n} has shape {np.shape(whole)} on "
                               f"disk but {gshape} in the template")
            for off, arr in (extra(n) if extra else {}).items():
                parts.setdefault(off, arr)
            dense = _assemble_dense(gshape, parts)
            if dense is None:
                raise ValueError(
                    f"leaf {n} ({kind}) is saved as blocks at "
                    f"{sorted(_parts(entries, n))} and this run places "
                    f"{key!r} here, but the blocks available (this "
                    "process's file and any sibling p<rank>/ files) do "
                    f"not tile its shape {gshape}: a topology re-map needs "
                    "every saving rank's state file on a shared "
                    "filesystem. Restore with the saving mesh and process "
                    "count, or clear the train_state dir to restart from "
                    "the deploy checkpoint.")
            a = dense
            if lf is not None:
                a = np.ascontiguousarray(dense[tuple(
                    slice(o, o + s) for o, s in
                    zip(lf.offsets(spec), lf.block_shape(spec)))])
            remapped.append(n)
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
                state.shards[i] = value.requires_grad_(True)
            else:
                params[i].copy_(value)
    key = np.asarray(key).astype(np.uint64)
    state.rng = int(key[0]) << 32 | int(key[1])
    state.step = step
    return remapped


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
        self._sibling_cache: dict | None = None
        #: The last restore's re-map (``leaves``, ``from_mesh``,
        #: ``from_processes``, ``to_mesh``, ``to_processes``), or None.
        self.last_remap: dict | None = None

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

    def _sibling_candidate_dirs(self) -> list[str]:
        """The newest restorable rotation of every sibling rank's
        ``p<rank>/`` directory beside this one (a shared filesystem)."""
        parent = os.path.dirname(self.dirpath)
        try:
            names = sorted(os.listdir(parent))
        except OSError:
            return []
        out = []
        for n in names:
            d = os.path.join(parent, n)
            if (os.path.abspath(d) == self.dirpath
                    or not (n.startswith("p") and n[1:].isdigit())):
                continue
            for rot in (self._LIVE, self._NEXT, self._OLD):
                cand = os.path.join(d, rot)
                if os.path.exists(os.path.join(cand, "state.npz")):
                    out.append(cand)
                    break
        return out

    @staticmethod
    def _dir_json(d: str, name: str) -> dict:
        try:
            with open(os.path.join(d, name)) as f:
                return dict(json.load(f))
        except (OSError, ValueError):
            return {}

    def exists(self) -> bool:
        """A checkpoint of this process's own, or sibling ranks' files to
        restore from (a grown world: the new rank must resume with the
        others, or the start-epoch check would stop the world)."""
        self.wait()
        return bool(self._restore_candidates()
                    or self._sibling_candidate_dirs())

    def load_meta(self) -> dict:
        """Run facts saved beside the newest checkpoint, a sibling's when
        this process has none ({} if none)."""
        self.wait()
        candidates = (self._restore_candidates()
                      or self._sibling_candidate_dirs()[:1])
        return self._dir_json(candidates[0], "meta.json") if candidates else {}

    def load_layout(self) -> dict:
        """The layout manifest beside the newest checkpoint (this
        process's, else a sibling's; {} if none)."""
        self.wait()
        for d in self._restore_candidates() + self._sibling_candidate_dirs():
            if os.path.exists(os.path.join(d, "layout.json")):
                return self._dir_json(d, "layout.json")
        return {}

    def _sibling_entries(self) -> dict:
        """The entries of every consistent sibling, merged (the first
        sibling wins a key), read once a restore. A sibling whose
        ``epochs_completed`` differs from this process's checkpoint (or,
        with none, the first sibling's) is stale: its blocks are never
        tiled beside the others'."""
        if self._sibling_cache is not None:
            return self._sibling_cache
        own = self._restore_candidates()
        ref = (self._dir_json(own[0], "meta.json").get("epochs_completed")
               if own else None)
        merged: dict = {}
        for i, d in enumerate(self._sibling_candidate_dirs()):
            epochs = self._dir_json(d, "meta.json").get("epochs_completed")
            if not own and i == 0:
                ref = epochs
            if epochs != ref:
                continue
            with np.load(os.path.join(d, "state.npz")) as npz:
                for k in npz.files:
                    merged.setdefault(k, npz[k])
        self._sibling_cache = merged
        return merged

    def restore(self, state):
        """Restore into ``state`` (in place) and return it."""
        self.wait()
        with _spans.get_default().span("checkpoint.restore",
                                       component="checkpoint") as sp:
            state = self._restore(state)
            if self.last_remap is not None:
                sp.set(topology_remap=self.last_remap["leaves"])
            return state

    def _restore(self, state):
        self._sibling_cache = None
        self.last_remap = None
        candidates = self._restore_candidates()
        if candidates:
            source = candidates[0]
            with np.load(os.path.join(source, "state.npz")) as npz:
                entries = {k: npz[k] for k in npz.files}
        elif self._sibling_entries():
            source, entries = "siblings", dict(self._sibling_entries())
        else:
            raise FileNotFoundError(
                f"No train-state checkpoint under {self.dirpath}")
        try:
            remapped = restore_entries(
                state, entries,
                extra=lambda n: _parts(self._sibling_entries(), n))
        except KeyError as e:
            raise KeyError(
                f"Checkpoint {source} does not match this run's "
                f"TrainState: {e.args[0]}. Restore the original setting, "
                f"or clear {self.dirpath} to restart the trajectory."
            ) from e
        finally:
            # The pool holds whole copies of the siblings' arrays.
            self._sibling_cache = None
        if remapped:
            from dct_tpu_torch.parallel.distributed import process_count

            saved = self.load_layout()
            now = self._layout(state, [])
            self.last_remap = {
                "leaves": len(remapped),
                "from_mesh": saved.get("mesh"),
                "from_processes": saved.get("process_count"),
                "to_mesh": now["mesh"], "to_processes": process_count()}
            _events.get_default().emit("shard", "shard.topology_remap",
                                       dir=source, **self.last_remap)
        return state
