"""The process grid and its collectives (counterpart of
``dct_tpu/parallel/mesh.py``; the ``seq`` and ``pipe`` axes wait for
ROADMAP Queue A items 16 and 17).

One process drives one device. The reference lays its devices out in
enumeration order over ``[data, model, seq, pipe]`` (``mesh.py:140``), so
process ``p`` of ``W = D x M`` sits at data row ``p // M`` and model
column ``p % M``. :func:`make_mesh` builds that grid from a
:class:`~dct_tpu_torch.config.MeshConfig` and one process group per data
row (its ``M`` processes: the **model group**, which shares one block of
every batch) and one per model column (its ``D`` processes: the **data
group**, over which gradients and metrics are reduced). Every process
creates every group, in the same order, as ``torch.distributed`` requires.

:func:`set_mesh` makes a grid the process default; without one, the
default is the data axis alone over every process. The reductions below
run over the default grid's data group: the model ranks of one block hold
the same loss, the same metric sums and the same gradients of replicated
parameters, so a sum over the world would count them ``M`` times. The
reference's step is one program over the global batch; here each process
divides its block's weighted loss sum by the global row count and
:func:`all_reduce_sum` adds the gradients and the losses over the data
group in one flat buffer (:mod:`dct_tpu_torch.train.steps`): the
reference's global weighted mean, the zero-weight padding of the last
batch included, which a mean of per-process means is not.

The model axis's collectives carry gradients (small
``torch.autograd.Function`` s): :func:`copy_to_model` (the identity
forward, an all-reduce backward: the input of a column-parallel layer),
:func:`reduce_from_model` (an all-reduce forward, the identity backward:
the output of a row-parallel layer), :func:`gather_from_model` (a tiled
all-gather forward, this rank's slice backward) and
:func:`all_to_all_model` (the expert exchange, its own inverse).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

from dct_tpu_torch.config import MeshConfig
from dct_tpu_torch.parallel.distributed import process_count, process_index

AXES = ("data", "model", "seq", "pipe")
# The axes beyond data and model, with the ROADMAP item that ports each.
_UNPORTED_AXES = {"seq": ("a sequence-parallel axis", 16),
                  "pipe": ("a pipeline axis", 17)}


@dataclass(frozen=True)
class ModelShard:
    """This process's place on the model axis: ``index`` of ``size``,
    and the process group of its ``size`` model ranks."""

    size: int
    index: int
    group: object = None


class ProcessMesh:
    """The ``[data, model]`` grid of processes (``seq`` and ``pipe`` are
    1). ``shape`` maps every axis name to its size, as the reference's
    ``Mesh.shape``; ``data_index`` and ``model_index`` place this
    process."""

    def __init__(self, data: int, model: int = 1, *, rank: int | None = None,
                 world: int | None = None):
        self.shape = {"data": int(data), "model": int(model), "seq": 1,
                      "pipe": 1}
        self.world = process_count() if world is None else int(world)
        self.rank = process_index() if rank is None else int(rank)
        m = self.model_size
        self.data_index, self.model_index = self.rank // m, self.rank % m
        self.data_group = self.model_group = None
        if self.world > 1 and dist.is_initialized():
            self._build_groups()

    @property
    def data_size(self) -> int:
        return self.shape["data"]

    @property
    def model_size(self) -> int:
        return self.shape["model"]

    def _build_groups(self) -> None:
        d, m = self.data_size, self.model_size
        # A group spanning the world is the default group (``None``).
        if m > 1 and d > 1:
            for row in range(d):  # every process creates every group
                g = dist.new_group([row * m + c for c in range(m)])
                if row == self.data_index:
                    self.model_group = g
            for col in range(m):
                g = dist.new_group([r * m + col for r in range(d)])
                if col == self.model_index:
                    self.data_group = g

    def model_shard(self) -> ModelShard | None:
        """This process's :class:`ModelShard`, or None when the model axis
        has one process."""
        if self.model_size == 1:
            return None
        return ModelShard(self.model_size, self.model_index, self.model_group)

    def __repr__(self) -> str:
        return (f"ProcessMesh({self.shape}, rank={self.rank}: data row "
                f"{self.data_index}, model column {self.model_index})")


def resolve_sizes(cfg: MeshConfig, n: int) -> dict:
    """The four axis sizes for ``n`` processes, ``-1`` absorbing the rest,
    with the reference's errors (``dct_tpu/parallel/mesh.py:44-63``): the
    grid must cover every process."""
    sizes = {"data": cfg.data, "model": cfg.model, "seq": cfg.seq,
             "pipe": cfg.pipe}
    fixed = math.prod(s for s in sizes.values() if s != -1)
    free = [a for a, s in sizes.items() if s == -1]
    if len(free) > 1:
        raise ValueError("At most one mesh axis may be -1")
    if free:
        if n % fixed != 0:
            raise ValueError(
                f"{n} devices not divisible by fixed axes {sizes}")
        sizes[free[0]] = n // fixed
    need = math.prod(sizes.values())
    if need > n:
        raise ValueError(f"Mesh {sizes} needs {need} devices, have {n}")
    if need != n:
        raise ValueError(
            f"Mesh {sizes} covers {need} of {n} devices: the port drives "
            "one device per process, so the mesh must cover every process "
            "(WORLD_SIZE)")
    return sizes


def make_mesh(cfg: MeshConfig | None = None) -> ProcessMesh:
    """The process grid of ``cfg`` over this run's processes (and its
    groups, when the process group is up)."""
    sizes = resolve_sizes(cfg or MeshConfig(), process_count())
    for axis, (what, item) in _UNPORTED_AXES.items():
        if sizes[axis] > 1:
            raise NotImplementedError(
                f"DCT_MESH_{axis.upper()}={sizes[axis]} asks for {what}; "
                f"the port has the data and model axes only: ROADMAP Queue "
                f"A item {item}")
    return ProcessMesh(sizes["data"], sizes["model"])


_MESH: ProcessMesh | None = None


def set_mesh(mesh: ProcessMesh | None) -> None:
    """Make ``mesh`` the process default (None: the data axis alone)."""
    global _MESH
    _MESH = mesh


def get_mesh() -> ProcessMesh:
    """The default grid: the one :func:`set_mesh` set while its world is
    the current one, else the data axis over every process."""
    global _MESH
    world = process_count()
    if _MESH is None or _MESH.world != world or _MESH.rank != process_index():
        _MESH = ProcessMesh(world, 1)
    return _MESH


def process_data_block() -> tuple[int, int]:
    """``(num_blocks, my_block)`` of each global batch: one block per data
    row, the ``M`` processes of a model group loading the same block."""
    mesh = get_mesh()
    return mesh.data_size, mesh.data_index


def data_parallel() -> bool:
    """Whether gradients and metrics are reduced over processes."""
    return get_mesh().data_size > 1


def all_reduce_sum(tensors) -> list[torch.Tensor]:
    """The elementwise sums of ``tensors`` over the data group, through
    one f32 all-reduce of a flat buffer; the tensors themselves come back
    (as f32 values in their own dtypes) when the data axis has one
    process."""
    tensors = list(tensors)
    mesh = get_mesh()
    if mesh.data_size == 1:
        return tensors
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.data_group)
    out, i = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[i:i + n].view(t.shape).to(t.dtype))
        i += n
    return out


def all_gather_ints(value: int) -> list[int]:
    """``value`` of every process, in rank order."""
    if process_count() == 1:
        return [int(value)]
    out = [None] * process_count()
    dist.all_gather_object(out, int(value))
    return [int(v) for v in out]


def all_gather_rows(tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` of every process of the data group stacked in data-row
    order, ``[D, ...]`` (on its own device: NCCL for CUDA tensors, gloo on
    the CPU); with one data row, ``tensor[None]``. Carries no gradient."""
    tensor = tensor.detach()
    mesh = get_mesh()
    if mesh.data_size == 1:
        return tensor[None]
    out = [torch.empty_like(tensor) for _ in range(mesh.data_size)]
    dist.all_gather(out, tensor.contiguous(), group=mesh.data_group)
    return torch.stack(out)


# ------------------------------------------------- model-axis autograd


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard, ctx.rows = shard, x.shape[0]
        out = x.new_empty((shard.size * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=shard.group)
        return out

    @staticmethod
    def backward(ctx, g):
        lo = ctx.shard.index * ctx.rows
        return g[lo:lo + ctx.rows], None


class _AllToAllModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    # Both buffers contiguous: a gradient may arrive with permuted strides,
    # which ``empty_like`` would copy.
    x = x.contiguous()
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x, group=group)
    return out


def copy_to_model(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """``x`` (replicated over the model group) into a model-parallel
    region: the identity, whose backward all-reduces the gradient."""
    return _CopyToModel.apply(x, shard.group)


def reduce_from_model(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """The sum of the model ranks' partial ``x``; the backward passes the
    (replicated) gradient through."""
    return _ReduceFromModel.apply(x, shard.group)


def gather_from_model(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """The model ranks' ``x`` concatenated on dim 0 in rank order; the
    backward keeps this rank's rows of the gradient."""
    return _GatherFromModel.apply(x, shard)


def all_to_all_model(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """``x`` ``[M, ...]``: row ``j`` goes to model rank ``j``, and row
    ``j`` of the result came from rank ``j``. Its own inverse, so the
    backward is the same exchange."""
    return _AllToAllModel.apply(x, shard.group)
