"""The process grid and its collectives (counterpart of
``dct_tpu/parallel/mesh.py``; the ``pipe`` axis waits for ROADMAP Queue A
item 17).

One process drives one device. The reference lays its devices out in
enumeration order over ``[data, model, seq, pipe]`` (``mesh.py:140``), so
process ``p`` of ``W = D x M x S`` sits at data row ``p // (M S)``, model
column ``(p // S) % M`` and seq index ``p % S``. :func:`make_mesh` builds
that grid from a :class:`~dct_tpu_torch.config.MeshConfig` and its
process groups: the **model group** (the ``M`` processes of one data row
and seq index, which share one block of every batch and split the
tensor-parallel layers), the **seq group** (the ``S`` processes of one
data row and model column, which hold the ``T/S`` positions of that block
each and run the sequence-parallel attention engines), the **data group**
(the ``D`` processes of one model column and seq index) and the
**gradient group** (the ``D x S`` processes of one model column, over
which gradients, losses and metrics are reduced). Every process creates
every group, in the same order, as ``torch.distributed`` requires.

:func:`set_mesh` makes a grid the process default; without one, the
default is the data axis alone over every process. The reductions below
run over the default grid's gradient group: the model ranks of one block
hold the same loss, the same metric sums and the same gradients of
replicated parameters, so a sum over the world would count them ``M``
times. The seq ranks of a block hold one share each of its gradients
(their positions' part of every parameter's), and the replicated tail
of the model (the pooled head, the gathered per-position logits) counts
on seq index 0 alone (:func:`seq_owned`), so a sum over the gradient
group is exact. The reference's step is one program over the global
batch; here each process divides its block's weighted loss sum by the
global row count and :func:`all_reduce_sum` adds the gradients and the
losses over the gradient group in one flat buffer
(:mod:`dct_tpu_torch.train.steps`): the reference's global weighted mean,
the zero-weight padding of the last batch included, which a mean of
per-process means is not.

The model axis's collectives carry gradients (small
``torch.autograd.Function`` s): :func:`copy_to_model` (the identity
forward, an all-reduce backward: the input of a column-parallel layer),
:func:`reduce_from_model` (an all-reduce forward, the identity backward:
the output of a row-parallel layer), :func:`gather_from_model` (a tiled
all-gather forward, this rank's slice backward) and
:func:`all_to_all_model` (the expert exchange, its own inverse). So do the
seq axis's: :func:`ring_shift` (one ``batch_isend_irecv`` to the next
seq rank, the reverse shift backward: a ring step of the ring engine),
:func:`seq_to_heads` and :func:`heads_to_seq` (the all-to-all engine's
two ``all_to_all_single`` exchanges, each the other's backward),
:func:`reduce_from_seq` (the mean pool's sum, all-reduced both ways) and
:func:`gather_from_seq` (the per-position logits, an all-gather forward
and an all-reduce of the gradient, this rank's slice, backward). Each of
them is one collective a call: where several tensors travel together
(the ring's K and V, the engine's q, k and v) they travel as one, so
the backward's collectives run in one order on every rank.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

from dct_tpu_torch.config import MeshConfig
from dct_tpu_torch.parallel.distributed import process_count, process_index

AXES = ("data", "model", "seq", "pipe")
# The axes the port does not have, with the ROADMAP item that ports each.
_UNPORTED_AXES = {"pipe": ("a pipeline axis", 17)}


@dataclass(frozen=True)
class ModelShard:
    """This process's place on the model axis: ``index`` of ``size``,
    and the process group of its ``size`` model ranks."""

    size: int
    index: int
    group: object = None


@dataclass(frozen=True)
class SeqShard:
    """This process's place on the seq axis: ``index`` of ``size``, the
    process group of its ``size`` seq ranks and their global ranks in seq
    order (the peers of a ring step)."""

    size: int
    index: int
    group: object = None
    ranks: tuple = ()


class ProcessMesh:
    """The ``[data, model, seq]`` grid of processes (``pipe`` is 1).
    ``shape`` maps every axis name to its size, as the reference's
    ``Mesh.shape``; ``data_index``, ``model_index`` and ``seq_index``
    place this process."""

    def __init__(self, data: int, model: int = 1, seq: int = 1, *,
                 rank: int | None = None, world: int | None = None):
        self.shape = {"data": int(data), "model": int(model),
                      "seq": int(seq), "pipe": 1}
        self.world = process_count() if world is None else int(world)
        self.rank = process_index() if rank is None else int(rank)
        self.data_index, self.model_index, self.seq_index = self._coords(
            self.rank)
        self.data_group = self.model_group = None
        self.seq_group = self.grad_group = None
        self.seq_ranks = tuple(self._peers((2,))[0])
        if self.world > 1 and dist.is_initialized():
            self._build_groups()

    @property
    def data_size(self) -> int:
        return self.shape["data"]

    @property
    def model_size(self) -> int:
        return self.shape["model"]

    @property
    def seq_size(self) -> int:
        return self.shape["seq"]

    @property
    def grad_size(self) -> int:
        """The processes a gradient is summed over: ``data x seq``."""
        return self.data_size * self.seq_size

    def _coords(self, p: int) -> tuple[int, int, int]:
        m, s = self.model_size, self.seq_size
        return p // (m * s), (p // s) % m, p % s

    def _peers(self, vary: tuple) -> list:
        """The groups of processes that differ only on the axes ``vary``
        (0 data, 1 model, 2 seq), in the order of their first rank: this
        process's first, then every group."""
        groups: dict = {}
        for p in range(self.data_size * self.model_size * self.seq_size):
            c = self._coords(p)
            groups.setdefault(tuple(c[a] for a in range(3)
                                    if a not in vary), []).append(p)
        mine = tuple(c for a, c in enumerate(self._coords(self.rank))
                     if a not in vary)
        return [groups[mine], list(groups.values())]

    def _build_groups(self) -> None:
        def build(vary):
            mine, groups = self._peers(vary)
            out = None
            for ranks in groups:  # every process creates every group
                # A group spanning the world is the default group (None);
                # a group of one process is never used.
                if 1 < len(ranks) < self.world:
                    g = dist.new_group(ranks)
                    if ranks == mine:
                        out = g
            return out

        self.model_group = build((1,))
        self.data_group = build((0,))
        self.seq_group = build((2,))
        if self.seq_size == 1:
            self.grad_group = self.data_group
        elif self.data_size == 1:
            self.grad_group = self.seq_group
        else:
            self.grad_group = build((0, 2))

    def axis_index(self, axis: str) -> int:
        """This process's index on ``axis``."""
        return {"data": self.data_index, "model": self.model_index,
                "seq": self.seq_index, "pipe": 0}[axis]

    def axis_group(self, axis: str):
        """The process group of ``axis`` (None: the default group, or an
        axis of one process, which no collective runs over)."""
        return {"data": self.data_group, "model": self.model_group,
                "seq": self.seq_group}[axis]

    def model_shard(self) -> ModelShard | None:
        """This process's :class:`ModelShard`, or None when the model axis
        has one process."""
        if self.model_size == 1:
            return None
        return ModelShard(self.model_size, self.model_index, self.model_group)

    def seq_shard(self) -> SeqShard | None:
        """This process's :class:`SeqShard`, or None when the seq axis has
        one process."""
        if self.seq_size == 1:
            return None
        return SeqShard(self.seq_size, self.seq_index, self.seq_group,
                        self.seq_ranks)

    def __repr__(self) -> str:
        return (f"ProcessMesh({self.shape}, rank={self.rank}: data row "
                f"{self.data_index}, model column {self.model_index}, seq "
                f"index {self.seq_index})")


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
                f"the port has the data, model and seq axes: ROADMAP Queue "
                f"A item {item}")
    return ProcessMesh(sizes["data"], sizes["model"], sizes["seq"])


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
    row, the ``M x S`` processes of a data row loading the same block."""
    mesh = get_mesh()
    return mesh.data_size, mesh.data_index


def data_parallel() -> bool:
    """Whether gradients and metrics are reduced over processes."""
    return get_mesh().grad_size > 1


def seq_owned(weight: torch.Tensor) -> torch.Tensor:
    """``weight`` on seq index 0 and zeros on the other seq ranks: the
    rows' weights of a loss or metric over the model's replicated tail
    (every seq rank of a block computes the same logits), so the sum over
    the gradient group counts them once."""
    mesh = get_mesh()
    if mesh.seq_size == 1 or mesh.seq_index == 0:
        return weight
    return torch.zeros_like(weight)


def all_reduce_sum(tensors) -> list[torch.Tensor]:
    """The elementwise sums of ``tensors`` over the gradient group (data
    x seq), through one f32 all-reduce of a flat buffer; the tensors
    themselves come back (as f32 values in their own dtypes) when that
    group has one process."""
    tensors = list(tensors)
    mesh = get_mesh()
    if mesh.grad_size == 1:
        return tensors
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.grad_group)
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


def all_gather_grad(tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` of every process of the gradient group (data x seq),
    ``[D, S, ...]`` by data row and seq index (on its own device: NCCL
    for CUDA tensors, gloo on the CPU); with one such process,
    ``tensor[None, None]``. Carries no gradient. The MoE's routing
    gathers its per-row choice counts with it: under ``seq`` a rank's
    positions of a row lie between those of the seq ranks before and
    after it, so the global order needs every rank's rows."""
    tensor = tensor.detach()
    mesh = get_mesh()
    if mesh.grad_size == 1:
        return tensor[None, None]
    out = tensor.new_empty(mesh.grad_size * tensor.numel())
    dist.all_gather_into_tensor(out, tensor.reshape(-1).contiguous(),
                                group=mesh.grad_group)
    # The group's ranks ascend, so data row major, then seq index.
    return out.view(mesh.data_size, mesh.seq_size, *tensor.shape)


def score_split(fn, x, chunk: int, mesh: ProcessMesh | None = None,
                times: list | None = None):
    """``fn`` (a data rank's rows -> their probabilities, a tensor on its
    device) over the host array ``x`` in chunks split over the ``data``
    axis, as the reference's accelerator engines split theirs
    (``jobs/predict.py:116-133``): the chunk rounded up to a multiple of
    ``data``; a partial last chunk padded with repeats of its last row to
    the whole chunk when ``x`` spans more than one (an MoE's routing
    depends on the rows scored together), else to a multiple of
    ``data``; data rank ``r`` scoring the ``r``-th of ``data`` equal
    blocks of each chunk, the blocks all-gathered back over the data
    group in row order. Every process of the grid calls it (the model and
    seq ranks of a data row score the same block) and gets every row's
    probabilities, as a host array. ``times``, when given, gets each
    chunk's real rows and its seconds, the probabilities on the host."""
    import numpy as np

    mesh = mesh or get_mesh()
    dp = mesh.data_size
    chunk = max(dp, -(-chunk // dp) * dp)
    parts = []
    for start in range(0, len(x), chunk):
        t0 = time.perf_counter()
        piece = np.ascontiguousarray(x[start:start + chunk], np.float32)
        real = len(piece)
        pad = (chunk - real) if len(x) > chunk else (-real) % dp
        if pad:
            piece = np.concatenate([piece, np.repeat(piece[-1:], pad,
                                                     axis=0)])
        n = len(piece) // dp
        out = fn(piece[mesh.data_index * n:(mesh.data_index + 1) * n])
        if dp > 1:
            mine = out.contiguous()
            out = mine.new_empty((dp * n, *mine.shape[1:]))
            dist.all_gather_into_tensor(out, mine, group=mesh.data_group)
        parts.append(out[:real].cpu().numpy())
        if times is not None:
            times.append((real, time.perf_counter() - t0))
    return np.concatenate(parts, axis=0)


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


# --------------------------------------------------- seq-axis autograd


def _shift(x: torch.Tensor, shard: SeqShard, step: int) -> torch.Tensor:
    """``x`` of the seq rank ``step`` places back: one send to the rank
    ``step`` ahead and one receive, batched."""
    x = x.contiguous()
    out = torch.empty_like(x)
    n, i = shard.size, shard.index
    ops = [dist.P2POp(dist.isend, x, shard.ranks[(i + step) % n],
                      group=shard.group),
           dist.P2POp(dist.irecv, out, shard.ranks[(i - step) % n],
                      group=shard.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return _shift(x, shard, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.shard, -1), None


def ring_shift(x: torch.Tensor, shard: SeqShard) -> torch.Tensor:
    """One ring step: this rank's ``x`` goes to the next seq rank and the
    previous one's comes back (``lax.ppermute`` over ``j -> j + 1``); the
    backward shifts the gradient the other way."""
    return _RingShift.apply(x, shard)


def _exchange(x: torch.Tensor, shard: SeqShard) -> torch.Tensor:
    """``x`` ``[S, ...]``: row ``j`` to seq rank ``j``; row ``j`` of the
    result came from seq rank ``j``."""
    x = x.contiguous()
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x, group=shard.group)
    return out


def _seq_to_heads(x: torch.Tensor, shard: SeqShard) -> torch.Tensor:
    b, h, t, d = x.shape
    s = shard.size
    parts = x.reshape(b, s, h // s, t, d).transpose(0, 1)
    out = _exchange(parts, shard)  # [S (source seq rank), B, H/S, T, D]
    return out.permute(1, 2, 0, 3, 4).reshape(b, h // s, s * t, d)


def _heads_to_seq(x: torch.Tensor, shard: SeqShard) -> torch.Tensor:
    b, h, t, d = x.shape
    s = shard.size
    parts = x.reshape(b, h, s, t // s, d).permute(2, 0, 1, 3, 4)
    out = _exchange(parts, shard)  # [S (source head group), B, H, T/S, D]
    return out.transpose(0, 1).reshape(b, s * h, t // s, d)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return _seq_to_heads(x, shard)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g, ctx.shard), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return _heads_to_seq(x, shard)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g, ctx.shard), None


def seq_to_heads(x: torch.Tensor, shard: SeqShard) -> torch.Tensor:
    """``[B, H, T/S, D]`` (this rank's positions of every head) ->
    ``[B, H/S, T, D]`` (every position of its ``H/S`` heads): one
    ``all_to_all_single`` (``lax.all_to_all(split_axis=1,
    concat_axis=2)``); the backward is :func:`heads_to_seq`."""
    return _SeqToHeads.apply(x, shard)


def heads_to_seq(x: torch.Tensor, shard: SeqShard) -> torch.Tensor:
    """The inverse of :func:`seq_to_heads`."""
    return _HeadsToSeq.apply(x, shard)


class _ReduceFromSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        x = x.contiguous().clone()
        dist.all_reduce(x, group=shard.group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.shard.group)
        return g, None


class _GatherFromSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard, ctx.n = shard, x.shape[1]
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(shard.size)]
        dist.all_gather(parts, x.contiguous(), group=shard.group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.shard.group)
        lo = ctx.shard.index * ctx.n
        return g[:, lo:lo + ctx.n], None


def reduce_from_seq(x: torch.Tensor, shard: SeqShard) -> torch.Tensor:
    """The sum of the seq ranks' ``x``, on every seq rank. Each rank's
    copy feeds its own share of the objective, so the backward sums the
    copies' gradients the same way (an all-reduce)."""
    return _ReduceFromSeq.apply(x, shard)


def gather_from_seq(x: torch.Tensor, shard: SeqShard) -> torch.Tensor:
    """The seq ranks' ``x`` ``[B, T/S, ...]`` concatenated on dim 1 in
    seq order, on every seq rank; the backward sums the copies' gradients
    and keeps this rank's positions."""
    return _GatherFromSeq.apply(x, shard)
