"""Stored placements gathered at their use: per-unit FSDP and the rule
layouts outside the family tables (the port's counterpart of the
resharding GSPMD inserts for the reference's placements,
``dct_tpu/parallel/sharding_rules.py:289-416``).

A leaf whose stored spec differs from its compute spec (a
:class:`~dct_tpu_torch.parallel.sharding_rules.Leaf` that is
``resharded``: an FSDP block over ``data``, a rule's ``seq`` or ``model``
placement of a leaf computed whole, a replicated leaf of a unit computed
tensor-parallel) keeps only its stored block, in ``state.shards``; its
module's parameter is empty. The leaves of one **unit**, a direct child
of the model (the input projection, each transformer, MoE or GRU block,
the final LayerNorm, the head), are gathered together when the unit
runs (:func:`install_units` wraps its ``forward``):

- forward: one all-gather over each axis that splits any of the unit's
  stored blocks (``data``, then ``seq``, then ``model``), each leaf then
  narrowed to its compute slice and cast to its ``DCT_DTYPE_RULES``
  dtype, and put into its module for the unit's forward alone. The
  tensors that the unit's operations save for the backward are packed as
  references (``saved_tensors_hooks``), so the gathered tensors are freed
  when the unit's forward returns;
- backward: the first operation of the unit's backward that needs one of
  them gathers the unit again (the same collectives); when the unit's
  backward ends, the gradient of each compute slice goes back to its
  stored block (one autograd function, :class:`_Gather`): all-gathered
  over ``model`` where the compute slice splits it, reduce-scattered
  over each of ``data`` and ``seq`` that the stored block splits (the
  per-rank contributions summed over that group, the trap of a stored
  axis that is also a gradient axis), narrowed where the stored block
  splits ``model`` (the model ranks of a leaf computed whole hold equal
  gradients), and the re-gathered tensors freed. The rest of the
  gradient group (``data`` x ``seq``) is summed by the step
  (:meth:`~dct_tpu_torch.train.state.TrainState.reduce_gradients`);
- remat (a transformer block under ``torch.utils.checkpoint``, whose
  saved-tensor hooks the unit's own would shadow): the unit installs no
  hooks, so the checkpoint saves none of the block's tensors, gathered
  parameters included, and reruns the block, gathering it again, in the
  backward; the rerun's gathered tensors are held until the unit's
  backward ends.

A unit whose gathered parameters take fewer than :data:`UNIT_MIN_BYTES`
(1 MiB; a block's biases and LayerNorms under the family tables, an
input projection, a head) is not
gathered on its own: the leaves of every such unit (but a remat block)
are gathered together when the model's forward starts, in one
all-gather an axis, held, saved by autograd as they are, until the end
of the model's backward, and their gradients reduced in one
reduce-scatter an axis there. Two collectives a step then stand where
each small unit ran three.

Each process counts the bytes of gathered parameters it holds
(:func:`gathered_bytes`): the gathered compute tensors of the unit
running its forward, or of the unit whose backward needed them, and the
small units' held for the step. Nothing is prefetched, so the peak is
one unit's (:func:`unit_bytes`) beside the small units'
(:func:`step_bytes`), which a step holds as a declared addition to the
one-unit bound, beside the stored blocks. The collectives' transient
buffers (the flat all-gather buffer, a narrowed leaf's whole) are not
counted. Under a bf16 compute
dtype a module's own ``.to`` cast of a gathered f32 weight is a new
tensor, which the backward keeps as any activation.
"""

from __future__ import annotations

import functools
import threading

import torch
import torch.distributed as dist
from torch import nn

from dct_tpu_torch.parallel.sharding_rules import rule_dtype

# A unit gathering fewer bytes is gathered with the other small ones once
# a step: below about 1 MiB a collective's cost is its latency.
UNIT_MIN_BYTES = 1 << 20
_LOCK = threading.Lock()
_COUNT = {"live": 0, "peak": 0}


def _count(delta: int) -> None:
    with _LOCK:
        _COUNT["live"] += delta
        _COUNT["peak"] = max(_COUNT["peak"], _COUNT["live"])


def gathered_bytes() -> dict:
    """``{"live", "peak"}``: the bytes of gathered parameters this process
    holds now, and the most it held at once since :func:`reset_peak`."""
    with _LOCK:
        return dict(_COUNT)


def reset_peak() -> None:
    with _LOCK:
        _COUNT["peak"] = _COUNT["live"]


def all_gather_dims(tensors, dims, mesh, axis: str) -> list:
    """Each tensor's blocks of ``axis``'s processes concatenated along its
    dim in ``dims`` (in axis order), in one flat all-gather over the axis
    group; all tensors of one dtype."""
    parts = mesh.shape[axis]
    moved = [t.movedim(d, 0).contiguous() for t, d in zip(tensors, dims)]
    buf = torch.cat([m.reshape(-1) for m in moved])
    out = buf.new_empty(parts * buf.numel())
    dist.all_gather_into_tensor(out, buf, group=mesh.axis_group(axis))
    out = out.view(parts, -1)
    res, off = [], 0
    for m, d in zip(moved, dims):
        n = m.numel()
        full = out[:, off:off + n].reshape(parts * m.shape[0], *m.shape[1:])
        res.append(full.movedim(0, d).contiguous())
        off += n
    return res


def reduce_scatter_dims(tensors, dims, mesh, axis: str) -> list:
    """Each tensor summed over ``axis``'s processes, this process's block
    of it along its dim in ``dims`` kept: one flat reduce-scatter."""
    parts = mesh.shape[axis]
    moved = [t.movedim(d, 0) for t, d in zip(tensors, dims)]
    rows = [m.reshape(parts, -1) for m in moved]
    buf = torch.cat(rows, dim=1).contiguous()
    mine = buf.new_empty(buf.shape[1])
    dist.reduce_scatter_tensor(mine, buf.reshape(-1),
                               group=mesh.axis_group(axis))
    res, off = [], 0
    for m, r, d in zip(moved, rows, dims):
        n = r.shape[1]
        block = mine[off:off + n].reshape(m.shape[0] // parts, *m.shape[1:])
        res.append(block.movedim(0, d))
        off += n
    return res


def _only(spec, axis: str) -> tuple:
    return tuple(a if a == axis else None for a in spec)


class Unit:
    """The resharded leaves ``idx`` of one direct child of the model."""

    def __init__(self, state, idx: list[int]):
        model = state.model
        names = [n for n, _ in model.named_parameters()]
        self.state, self.idx = state, idx
        self.leaves = [state.layout.leaves[i] for i in idx]
        self.mesh = state.layout.mesh
        self.slots = []
        for i in idx:
            owner, _, attr = names[i].rpartition(".")
            self.slots.append((model.get_submodule(owner), attr))
        self.saved: dict = {}
        self.cache = None
        self.remat = False
        self.whole_step = False

    def nbytes(self) -> int:
        """The bytes of the unit's gathered compute tensors (f32, or the
        leaves' rule dtypes)."""
        n = 0
        for lf in self.leaves:
            dtype = rule_dtype(lf.key) or torch.float32
            numel = 1
            for s in lf.block_shape(lf.compute_spec):
                numel *= s
            n += numel * torch.tensor([], dtype=dtype).element_size()
        return n

    def stored(self) -> list[torch.Tensor]:
        return [self.state.shards[i] for i in self.idx]

    def materialize(self, stored) -> list[torch.Tensor]:
        """The compute tensors from the stored blocks (no autograd)."""
        ts = [s.detach() for s in stored]
        for axis in ("data", "seq", "model"):
            sel = [(k, lf.tdim(lf.param_spec.index(axis)))
                   for k, lf in enumerate(self.leaves)
                   if axis in lf.axes(lf.param_spec)]
            if sel:
                out = all_gather_dims([ts[k] for k, _ in sel],
                                      [d for _, d in sel], self.mesh, axis)
                for (k, _), o in zip(sel, out):
                    ts[k] = o
        out = []
        for lf, t in zip(self.leaves, ts):
            t = lf.local(t, lf.compute_spec)
            dtype = rule_dtype(lf.key)
            out.append((t if dtype is None else t.to(dtype)).contiguous())
        return out

    def reduce(self, grads) -> list[torch.Tensor]:
        """Compute-slice gradients -> stored-block gradients (module
        docstring), still partial over the gradient-group axes the stored
        block does not split."""
        gs = [g.float() for g in grads]
        sel = [(k, lf.tdim(lf.compute_spec.index("model")))
               for k, lf in enumerate(self.leaves)
               if "model" in lf.axes(lf.compute_spec)]
        if sel:
            out = all_gather_dims([gs[k] for k, _ in sel],
                                  [d for _, d in sel], self.mesh, "model")
            for (k, _), o in zip(sel, out):
                gs[k] = o
        for axis in ("data", "seq"):
            sel = [(k, lf.tdim(lf.param_spec.index(axis)))
                   for k, lf in enumerate(self.leaves)
                   if axis in lf.axes(lf.param_spec)]
            if sel:
                out = reduce_scatter_dims([gs[k] for k, _ in sel],
                                          [d for _, d in sel], self.mesh,
                                          axis)
                for (k, _), o in zip(sel, out):
                    gs[k] = o
        return [lf.local(g, _only(lf.param_spec, "model")).contiguous()
                for lf, g in zip(self.leaves, gs)]

    def pack(self, t: torch.Tensor):
        ptr = t.untyped_storage().data_ptr() if t.numel() else 0
        k = self.saved.get(ptr) if ptr else None
        if k is None:
            return t
        return (k, t.size(), t.stride(), t.storage_offset())

    def unpack(self, packed):
        if isinstance(packed, torch.Tensor):
            return packed
        k, size, stride, offset = packed
        if self.cache is None:
            self.cache = self.materialize(self.stored())
            _count(_nbytes(self.cache))
        return self.cache[k].as_strided(size, stride, offset)

    def release(self) -> None:
        """Free the tensors gathered again for the backward."""
        if self.cache is not None:
            _count(-_nbytes(self.cache))
            self.cache = None


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class _Gather(torch.autograd.Function):
    """The unit's stored blocks -> its compute tensors; the backward takes
    their gradients back to the blocks as the unit's backward ends."""

    @staticmethod
    def forward(ctx, unit, *stored):
        ctx.unit = unit
        return tuple(unit.materialize(stored))

    @staticmethod
    def backward(ctx, *grads):
        unit = ctx.unit
        unit.release()
        return (None, *unit.reduce(grads))


def _unit_forward(unit: Unit, forward, *args, **kwargs):
    stored = unit.stored()
    grad = torch.is_grad_enabled() and any(s.requires_grad for s in stored)
    remat = grad and unit.remat
    # The rerun of a rematerialized unit runs inside the backward.
    rerun = remat and torch._C._current_graph_task_id() != -1
    if not rerun:
        unit.release()  # held by a forward whose backward never ran
    outs = _Gather.apply(unit, *stored) if grad else unit.materialize(stored)
    held = _nbytes(outs)
    _count(held)
    unit.saved = {o.untyped_storage().data_ptr(): k
                  for k, o in enumerate(outs)}
    prev = []
    for (mod, attr), o in zip(unit.slots, outs):
        prev.append(mod._parameters[attr])
        mod._parameters[attr] = o
    try:
        if remat or unit.whole_step:
            return forward(*args, **kwargs)
        with torch.autograd.graph.saved_tensors_hooks(unit.pack, unit.unpack):
            return forward(*args, **kwargs)
    finally:
        for (mod, attr), p in zip(unit.slots, prev):
            mod._parameters[attr] = p
        unit.saved = {}
        if rerun or (grad and unit.whole_step):
            unit.cache = outs
        else:
            _count(-held)
        del outs


def install_units(state) -> list[Unit]:
    """Wrap the forward of every direct child of ``state.model`` that
    holds resharded leaves, the small ones' leaves together in the
    model's own forward (module docstring); returns the per-unit ones."""
    model = state.model
    names = [n for n, _ in model.named_parameters()]
    rematted = ({id(b) for b in model.blocks()}
                if getattr(model, "remat", False) else set())
    groups: dict[str, list[int]] = {}
    for i in state.layout.resharded():
        top, _, rest = names[i].partition(".")
        if not rest:
            raise ValueError(f"parameter {names[i]} belongs to no unit: "
                             "the model's own parameters cannot reshard")
        groups.setdefault(top, []).append(i)
    units, small = [], []
    for top, idx in groups.items():
        mod: nn.Module = getattr(model, top)
        unit = Unit(state, idx)
        unit.remat = id(mod) in rematted
        if not unit.remat and unit.nbytes() < UNIT_MIN_BYTES:
            small.extend(idx)
            continue
        mod.forward = functools.partial(_unit_forward, unit, mod.forward)
        units.append(unit)
    model.dct_units = units
    model.dct_step_unit = None
    if small:
        step = Unit(state, sorted(small))
        step.whole_step = True
        model.forward = functools.partial(_unit_forward, step, model.forward)
        model.dct_step_unit = step
    return units


def unit_bytes(state) -> list[int]:
    """The bytes of each per-unit gather's compute tensors."""
    return [u.nbytes() for u in getattr(state.model, "dct_units", [])]


def step_bytes(state) -> int:
    """The bytes of the small units' compute tensors, held from the
    model's forward to the end of its backward."""
    step = getattr(state.model, "dct_step_unit", None)
    return 0 if step is None else step.nbytes()
