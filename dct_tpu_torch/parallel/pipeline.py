"""GPipe over the ``pipe`` axis (counterpart of
``dct_tpu/parallel/pipeline.py``).

The reference streams ``M`` microbatches through ``P`` stages inside one
``shard_map``: ``M + P - 1`` ticks, each stage applying its slice of the
stacked stage parameters ``P("pipe", ...)`` to its activation and a
``ppermute`` handing the result to the next stage, the last stage's
banked outputs ``psum``-ed to every pipe device; its backward is
``jax.grad`` of that forward. Here each process is one stage and holds
its own stage's parameters (:class:`~dct_tpu_torch.models.transformer.
StageStack`):

- forward: stage ``p`` runs microbatch ``m`` at tick ``m + p``, so it runs
  only on the ``M`` ticks at which it holds a real microbatch (the
  reference computes on the ramp ticks too and discards the result: the
  same function, ``M`` stage calls a stage instead of ``M + P - 1``).
  Stage 0 takes its microbatches from its input; every other stage
  receives each from the previous stage (one ``batch_isend_irecv``), and
  every stage but the last sends its output on. The last stage's outputs
  are broadcast to every stage, as the reference's ``psum`` gives them.
- backward: one autograd node (:class:`_Pipeline`) for the whole
  schedule, whose backward runs it in reverse, microbatch by microbatch
  from the last: the last stage takes its own cotangent of the outputs
  (the tail of the model counts on the last stage alone,
  :func:`~dct_tpu_torch.parallel.mesh.tail_owned`, so no other copy
  carries one), every other stage receives each microbatch's cotangent
  from the next stage, differentiates its stage call and sends the
  input's cotangent to the previous stage. Every send meets its receive
  in the same order on both ranks of a pair, which one ``backward()``
  over a graph of point-to-point nodes, in the order autograd picks, does
  not promise. Stage 0's input cotangents are the gradient of its input.

The bubble is the reference's: ``(P - 1) / (M + P - 1)`` of a step's
ticks see a stage idle (:func:`bubble`). With ``DCT_PIPE_TRACE=1`` each
train schedule on a card records CUDA events around this stage's calls
and backward passes and around the whole schedule, and :func:`trace`
returns their sums (``busy_ms`` of ``span_ms``: the stage's idle share of
the pipelined step is ``1 - busy / span``); it synchronizes once a
schedule, so it is for measurement only. Without a pipe axis
(:func:`sequential_apply`) the stages run one after another on the whole
batch: the reference's oracle and the path of one process.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from dct_tpu_torch.parallel.mesh import (
    PipeShard,
    pipe_broadcast,
    pipe_recv,
    pipe_send,
)

# The pipe groups that have run a collective (see :func:`_warm`).
_WARM: set = set()
# DCT_PIPE_TRACE's (busy ms, span ms) of this process's train schedules.
_TRACE: list = []


def trace() -> dict:
    """The traced train schedules (module docstring): their count, this
    stage's busy and whole-schedule milliseconds summed, and the median
    schedule's."""
    def median(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2] if xs else 0.0

    return {"schedules": len(_TRACE),
            "busy_ms": sum(b for b, _ in _TRACE),
            "span_ms": sum(s for _, s in _TRACE),
            "median_busy_ms": median([b for b, _ in _TRACE]),
            "median_span_ms": median([s for _, s in _TRACE])}


class _Events:
    """CUDA events around a schedule and its stage's work, when
    ``DCT_PIPE_TRACE=1`` and the schedule runs on a card."""

    def __init__(self, device: torch.device):
        self.on = (device.type == "cuda"
                   and os.environ.get("DCT_PIPE_TRACE") == "1")
        self.pairs: list = []
        self.start = self._event() if self.on else None

    def _event(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def busy(self, fn, *args, **kwargs):
        """``fn(*args, **kwargs)``, timed as this stage's work."""
        if not self.on:
            return fn(*args, **kwargs)
        a = self._event()
        out = fn(*args, **kwargs)
        self.pairs.append((a, self._event()))
        return out

    def close(self) -> None:
        if not self.on:
            return
        end = self._event()
        end.synchronize()
        _TRACE.append((sum(a.elapsed_time(b) for a, b in self.pairs),
                       self.start.elapsed_time(end)))


def stack_stage_params(stage_params: list[dict]) -> dict:
    """``[per-stage {key: array}]`` with one structure -> ``{key: array
    [n_stages, ...]}`` (numpy arrays or tensors), the reference's stacked
    layout."""
    import numpy as np

    keys = list(stage_params[0])
    out = {}
    for k in keys:
        parts = [sp[k] for sp in stage_params]
        out[k] = (torch.stack(parts) if isinstance(parts[0], torch.Tensor)
                  else np.stack(parts))
    return out


def ticks(n_microbatches: int, n_stages: int) -> int:
    """The GPipe schedule's ticks: ``M + P - 1``."""
    return n_microbatches + n_stages - 1


def bubble(n_microbatches: int, n_stages: int) -> float:
    """The share of a stage's ticks without a microbatch:
    ``(P - 1) / (M + P - 1)``."""
    return (n_stages - 1) / ticks(n_microbatches, n_stages)


def _warm(shard: PipeShard, like: torch.Tensor) -> None:
    """One all-reduce over the pipe group before its first point-to-point
    call: NCCL needs every rank of a group in the group's first
    collective, which a stage's lone send is not."""
    key = (shard.ranks, id(shard.group))
    if key not in _WARM:
        dist.all_reduce(like.new_zeros(1, dtype=torch.float32),
                        group=shard.group)
        _WARM.add(key)


def sequential_apply(stage_fn, n_stages: int, h: torch.Tensor):
    """The stages one after another over the whole batch:
    ``stage_fn(s, h)`` for ``s`` in order."""
    for s in range(n_stages):
        h = stage_fn(s, h)
    return h


class _Schedule:
    """One forward of the schedule on this stage, and its reverse."""

    def __init__(self, stage_fn, shard: PipeShard, n_microbatches: int):
        self.stage_fn, self.shard, self.m = stage_fn, shard, n_microbatches
        self.kept: list = []
        self.events = None

    def forward(self, h: torch.Tensor, grad: bool) -> torch.Tensor:
        shard, m = self.shard, self.m
        first, last = shard.index == 0, shard.index == shard.size - 1
        xs = h.detach().reshape(m, h.shape[0] // m, *h.shape[1:])
        ys = torch.empty_like(xs)
        if grad:
            self.events = _Events(h.device)
        for i in range(m):
            a = xs[i] if first else pipe_recv(xs[i], shard.prev, shard)
            if grad:
                a = a.detach().requires_grad_(True)
            with torch.set_grad_enabled(grad):
                out = (self.events.busy(self.stage_fn, a) if grad
                       else self.stage_fn(a))
            if last:
                ys[i] = out.detach()
            else:
                pipe_send(out, shard.next, shard)
            if grad:
                self.kept.append((a, out))
        ys = pipe_broadcast(ys, shard.size - 1, shard)
        return ys.reshape(h.shape)

    def backward(self, g: torch.Tensor, params):
        shard, m = self.shard, self.m
        first, last = shard.index == 0, shard.index == shard.size - 1
        gs = g.reshape(m, g.shape[0] // m, *g.shape[1:])
        gx = torch.empty_like(gs) if first else None
        gp = [None] * len(params)
        for i in reversed(range(m)):
            a, out = self.kept.pop()
            gi = (gs[i] if last
                  else pipe_recv(out.detach(), shard.next, shard))
            res = self.events.busy(torch.autograd.grad, out, [a, *params],
                                   gi.to(out.dtype), allow_unused=True)
            for k, r in enumerate(res[1:]):
                if r is not None:
                    gp[k] = r if gp[k] is None else gp[k] + r
            if first:
                gx[i] = res[0]
            else:
                pipe_send(res[0], shard.prev, shard)
        self.events.close()
        gp = [torch.zeros_like(p) if r is None else r
              for p, r in zip(params, gp)]
        # A later stage's input is never read: its gradient is zero.
        return (torch.zeros_like(g) if gx is None
                else gx.reshape(g.shape)), gp


class _Pipeline(torch.autograd.Function):
    """The schedule as one autograd node over the stage's input and the
    tensors its stage call reads (``params``)."""

    @staticmethod
    def forward(ctx, sched, h, *params):
        ctx.sched, ctx.params = sched, params
        return sched.forward(h, grad=True)

    @staticmethod
    def backward(ctx, g):
        gh, gp = ctx.sched.backward(g, ctx.params)
        ctx.sched = ctx.params = None
        return (None, gh, *gp)


def pipeline_apply(stage_fn, h: torch.Tensor, *, shard: PipeShard,
                   n_microbatches: int, params=()) -> torch.Tensor:
    """This stage's part of the GPipe schedule over ``h`` ``[B, ...]``
    (module docstring): ``stage_fn(a)`` runs this rank's stage on a
    microbatch, reading ``params`` (the tensors its gradient is taken
    with respect to). Every stage passes the same ``h`` (only stage 0's
    is read) and gets the last stage's outputs ``[B, ...]``;
    differentiable in ``h`` and ``params`` when grad is enabled."""
    b = h.shape[0]
    if b % n_microbatches:
        raise ValueError(
            f"batch {b} not divisible by n_microbatches {n_microbatches}")
    _warm(shard, h)
    sched = _Schedule(stage_fn, shard, n_microbatches)
    params = tuple(params)
    if torch.is_grad_enabled() and (h.requires_grad or any(
            p.requires_grad for p in params)):
        return _Pipeline.apply(sched, h, *params)
    return sched.forward(h, grad=False)
