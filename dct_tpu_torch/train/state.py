"""Train state, optimizers and LR schedules (counterpart of
``dct_tpu/train/state.py``).

The optimizers are written to optax's update rules, as small gradient
transformations over a list of tensors (``init(params) -> state``,
``update(grads, state, params) -> (updates, state)``) that chain like
optax's, because ``torch.optim`` differs where it matters here: its SGD
weight decay is coupled (added to the gradient before the momentum), it has
no Lion, and its global-norm clip adds 1e-6 to the norm. Schedules are
evaluated at each transformation's own update count, from 0, as optax's
are.

Unlike the reference's immutable pytree, :class:`TrainState` is updated in
place: the step applies the update to the model's f32 master parameters
and advances the step and the optimizer state, which saves a copy of every
parameter per step.

On a mesh (:func:`dct_tpu_torch.parallel.sharding_rules.
shard_state_with_rules`) the state carries a layout, and the optimizer
works on what each process owns, its **update space**: a parameter's
stored block (a tensor-parallel slice, which the model holds; a resharded
leaf's block, an FSDP block over ``data`` or a rule's placement, which
only ``shards`` holds and its unit gathers at use,
:mod:`dct_tpu_torch.parallel.reshard`; else the whole parameter), and
under ZeRO-1 the ``data`` block of a replicated parameter along its
leading flax dim (a view, whose updated blocks are all-gathered back
after the step); where a rule stores the moments apart otherwise, the
parameter's block in the moments' placement (gathered before the update
and its stored block taken back after it).
:meth:`TrainState.reduce_gradients` brings the raw
gradients into the update space: each gradient is summed over the
gradient-group axes (``data``, ``seq``) its stored block does not split,
in one flat all-reduce for each set of such axes (a resharded leaf's
gradient comes back from its unit already reduce-scattered over the
axes its block splits), and ZeRO-1's over ``data`` in one flat
reduce-scatter, then over ``seq``; a gradient whose moments are stored
apart otherwise is then brought to their placement.
:meth:`TrainState.grad_norm` is the
norm over the logical arrays: each update-space tensor's squares summed
over the axes that split it, each replicated leaf counted once. The
numbers equal data parallelism's; what changes is the memory each
process holds.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from dct_tpu_torch.parallel.sharding_rules import (
    flax_layout,
    respec,
    shard_state_with_rules,
)


class GradientTransformation(NamedTuple):
    """``kind`` names the optax state the transformation's state stands
    for (``adam``, ``lion``, ``trace``, ``schedule``; ``chain`` with its
    ``parts``; empty for a stateless one), so the resume tier can write
    and read the state under optax's leaf order."""

    init: Callable[[list], Any]
    update: Callable[[list, Any, list], tuple[list, Any]]
    kind: str = ""
    parts: tuple = ()


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return [tx.init(params) for tx in txs]

    def update(updates, state, params, norm=None):
        """``norm``: the global norm of ``updates``, for a clip that comes
        first (it alone sees them as given)."""
        new_state = []
        for tx, s in zip(txs, state):
            if norm is not None and tx.kind == "clip":
                updates, s = tx.update(updates, s, params, norm)
            else:
                updates, s = tx.update(updates, s, params)
            norm = None
            new_state.append(s)
        return updates, new_state

    return GradientTransformation(init, update, "chain", txs)


def _bias_correction(decay: float, count: int) -> float:
    # optax divides by 1 - decay**count with the power taken in f32; the
    # step count lives on the host, so this is a host scalar too.
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    """optax's ``scale_by_adam``, as ``torch._foreach_*`` passes over all
    tensors at once."""

    def init(params):
        return {"count": 0, "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def update(updates, state, params):
        mu = torch._foreach_add(torch._foreach_mul(updates, 1 - b1),
                                torch._foreach_mul(state["mu"], b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(updates, updates), 1 - b2),
            torch._foreach_mul(state["nu"], b2),
        )
        count = state["count"] + 1
        denom = torch._foreach_sqrt(
            torch._foreach_div(nu, _bias_correction(b2, count)))
        torch._foreach_add_(denom, eps)
        out = torch._foreach_div(
            torch._foreach_div(mu, _bias_correction(b1, count)), denom)
        return out, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update, "adam")


def scale_by_lion(b1: float = 0.9, b2: float = 0.99) -> GradientTransformation:
    def init(params):
        return {"count": 0, "mu": [torch.zeros_like(p) for p in params]}

    def update(updates, state, params):
        mu = state["mu"]
        out = [torch.sign((1.0 - b1) * g + b1 * m) for g, m in zip(updates, mu)]
        return out, {"count": state["count"] + 1,
                     "mu": [(1 - b2) * g + b2 * m for g, m in zip(updates, mu)]}

    return GradientTransformation(init, update, "lion")


def trace(decay: float) -> GradientTransformation:
    """Momentum: ``t = g + decay * t``; the update is ``t``."""

    def init(params):
        return [torch.zeros_like(p) for p in params]

    def update(updates, state, params):
        new = [g + decay * t for g, t in zip(updates, state)]
        return new, new

    return GradientTransformation(init, update, "trace")


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    """Decoupled decay: ``u + weight_decay * p``."""

    def update(updates, state, params):
        return [u + weight_decay * p for u, p in zip(updates, params)], state

    return GradientTransformation(lambda params: None, update)


def scale_by_learning_rate(rate) -> GradientTransformation:
    """``-rate * u``; a callable rate is evaluated at the update count."""

    def init(params):
        return 0

    def update(updates, count, params):
        lr = rate(count) if callable(rate) else rate
        return torch._foreach_mul(updates, -lr), count + 1

    # optax keeps the count only for a schedule (ScaleByScheduleState).
    return GradientTransformation(init, update,
                                  "schedule" if callable(rate) else "")


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (f32)."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Scale every update by ``max_norm / norm`` when the global norm is at
    least ``max_norm`` (no epsilon, as optax). The update takes the norm
    when it is known (a sharded state's :meth:`TrainState.grad_norm`),
    else :func:`global_norm` of the updates."""

    def update(updates, state, params, norm=None):
        if norm is None:
            norm = global_norm(updates)
        clipped = norm >= max_norm
        return [torch.where(clipped, u / norm.to(u.dtype) * max_norm, u)
                for u in updates], state

    return GradientTransformation(lambda params: None, update, "clip")


def make_lr_schedule(lr: float, *, schedule: str = "constant",
                     warmup_steps: int = 0, decay_steps: int = 0,
                     end_lr_fraction: float = 0.0):
    """``constant``: ``lr`` (linear warmup from 0 over ``warmup_steps``
    when > 0); ``cosine``: optional warmup, then cosine decay over
    ``decay_steps`` to ``lr * end_lr_fraction``. Returns a float or a
    function of the update count."""

    def warmup(count):
        return lr * min(max(count, 0), warmup_steps) / warmup_steps

    if schedule == "constant":
        return warmup if warmup_steps > 0 else lr
    if schedule == "cosine":
        if decay_steps <= 0:
            raise ValueError("cosine schedule needs decay_steps > 0")

        def cos(count):
            c = min(count, decay_steps)
            decay = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
            return lr * ((1 - end_lr_fraction) * decay + end_lr_fraction)

        if warmup_steps > 0:
            return lambda count: (
                warmup(count) if count < warmup_steps
                else cos(count - warmup_steps)
            )
        return cos
    raise ValueError(
        f"Unknown lr schedule '{schedule}' (expected constant|cosine)"
    )


def make_optimizer(rate, *, optimizer: str = "adam",
                   weight_decay: float = 0.0, momentum: float = 0.0,
                   grad_clip_norm: float = 0.0) -> GradientTransformation:
    """``adam`` (a positive ``weight_decay`` upgrades to AdamW), ``adamw``,
    ``sgd`` (momentum trace, then decoupled decay, then the rate), ``lion``
    (b1 0.9, b2 0.99, decoupled decay); ``grad_clip_norm`` > 0 clips by the
    global norm first. ``adafactor`` is not ported yet and
    raises."""
    opt = optimizer.strip().lower()
    if momentum and opt not in ("sgd", "adafactor"):
        raise ValueError(
            f"DCT_MOMENTUM={momentum} is only meaningful for sgd/"
            f"adafactor (got optimizer={optimizer!r}; adam/adamw/lion "
            "are governed by their betas)"
        )
    if opt in ("adam", "adamw"):
        parts = [scale_by_adam()]
        if opt == "adamw" or weight_decay > 0.0:
            parts.append(add_decayed_weights(weight_decay))
    elif opt == "sgd":
        parts = [trace(momentum)] if momentum else []
        if weight_decay > 0.0:
            parts.append(add_decayed_weights(weight_decay))
    elif opt == "lion":
        parts = [scale_by_lion(), add_decayed_weights(weight_decay)]
    elif opt == "adafactor":
        raise NotImplementedError(
            "DCT_OPTIMIZER=adafactor is not ported to dct_tpu_torch yet: "
            "ROADMAP Queue A item 5"
        )
    else:
        raise ValueError(
            f"DCT_OPTIMIZER={optimizer!r} not in "
            "('adam', 'adamw', 'sgd', 'adafactor', 'lion')"
        )
    parts.append(scale_by_learning_rate(rate))
    if grad_clip_norm > 0.0:
        parts.insert(0, clip_by_global_norm(grad_clip_norm))
    return chain(*parts)


@dataclass
class TrainState:
    """The model (holding the f32 master parameters, or this process's
    slices of them), the optimizer and its state, the step, the seed and
    the dropout seed ``rng`` that, with the step, seeds every dropout mask
    of a step. ``layout`` is the placement on a mesh (None: every process
    holds everything); ``shards`` the resharded parameters' stored
    blocks."""

    model: nn.Module
    tx: GradientTransformation
    opt_state: Any
    step: int
    seed: int
    rng: int
    layout: Any = None
    shards: dict = field(default_factory=dict)

    @property
    def params(self) -> list[torch.Tensor]:
        return list(self.model.parameters())

    def stored_param(self, i: int) -> torch.Tensor:
        """What this process stores of parameter ``i``: a resharded
        leaf's block, else the parameter (a tensor-parallel slice, or
        whole)."""
        return self.shards.get(i, self.params[i])

    def grad_targets(self) -> list[torch.Tensor]:
        """The tensors a step differentiates, in ``params`` order: each
        parameter's stored tensor (a resharded leaf's block, which its
        unit gathers at use)."""
        return [self.shards.get(i, p) for i, p in enumerate(self.params)]

    def update_params(self) -> list[torch.Tensor]:
        """The tensors the optimizer updates (the module docstring's
        update space): each parameter's block in its moments' placement
        (a view of a ZeRO-1 leaf's, a gathered copy where the moments are
        stored apart otherwise)."""
        out = []
        for i in range(len(self.params)):
            t = self.stored_param(i)
            lf = None if self.layout is None else self.layout.leaves[i]
            if lf is not None and lf.zero1:
                t = lf.local(t.detach(), lf.moment_spec)
            elif lf is not None and lf.apart:
                t = respec(t.detach(), lf, lf.param_spec, lf.moment_spec)
            out.append(t)
        return out

    def place_params(self, full: list[torch.Tensor]) -> None:
        """Keep each resharded parameter as its stored block of ``full``
        (every parameter's full torch-layout tensor), releasing the
        module's parameter (after the layout is set)."""
        params = self.params
        for i in self.layout.resharded():
            lf = self.layout.leaves[i]
            self.shards[i] = lf.local(full[i], lf.param_spec).clone(
                memory_format=torch.contiguous_format).requires_grad_(True)
            params[i].data = params[i].data.new_empty(0)

    def _gather_blocks(self, idx: list[int], blocks) -> list[torch.Tensor]:
        """The full torch-layout tensors of the ZeRO-1 leaves ``idx``
        from this process's ``blocks``, in one all-gather over the data
        group (each block contiguous rows of the leaf's flax layout)."""
        layout = self.layout
        d = layout.mesh.shape["data"]
        flat = [flax_layout(b, layout.leaves[i].transposed).reshape(-1)
                for i, b in zip(idx, blocks)]
        buf = torch.cat(flat)
        out = buf.new_empty(d * buf.numel())
        dist.all_gather_into_tensor(out, buf, group=layout.mesh.data_group)
        out = out.view(d, -1)
        full, off = [], 0
        for i, f in zip(idx, flat):
            lf = layout.leaves[i]
            n = f.numel()
            a = out[:, off:off + n].reshape(lf.shape)
            full.append(flax_layout(a, lf.transposed).contiguous())
            off += n
        return full

    def reduce_gradients(self, grads, extras=()):
        """Raw per-process gradients of :meth:`grad_targets` and scalars
        ``extras`` -> (update-space gradients summed over the gradient
        group, data x seq, the summed ``extras``): one flat all-reduce
        for each set of gradient axes the stored blocks leave unsplit
        (the replicated leaves' with the extras over the whole group),
        and for the ZeRO-1 leaves one flat reduce-scatter over the data
        group and, under ``seq``, one all-reduce of this process's blocks
        over the seq group."""
        from dct_tpu_torch.parallel.mesh import all_reduce_sum

        grads, extras = list(grads), list(extras)
        layout = self.layout
        zero1 = [] if layout is None else layout.zero1()
        buckets: dict[tuple, list[int]] = {}
        grad_axes = ("data", "seq")
        if layout is not None:
            grad_axes = tuple(a for a in grad_axes
                              if layout.mesh.shape[a] > 1)
        for i in range(len(grads)):
            if i in zero1:
                continue
            left = grad_axes
            if layout is not None:
                split = layout.leaves[i].axes(layout.leaves[i].param_spec)
                left = tuple(a for a in grad_axes if a not in split)
            buckets.setdefault(left, []).append(i)
        whole = buckets.pop(grad_axes, [])
        reduced = all_reduce_sum([*(grads[i] for i in whole), *extras])
        out = [None] * len(grads)
        for i, g in zip(whole, reduced):
            out[i] = g
        for left, idx in buckets.items():
            flat = [grads[i].reshape(-1).float() for i in idx]
            if left:
                buf = torch.cat(flat)
                dist.all_reduce(buf, group=layout.mesh.axis_group(left[0]))
                flat, off = [], 0
                for i in idx:
                    n = grads[i].numel()
                    flat.append(buf[off:off + n])
                    off += n
            for i, f in zip(idx, flat):
                out[i] = f.view(grads[i].shape).to(grads[i].dtype)
        for i in [] if layout is None else layout.apart():
            lf = layout.leaves[i]
            out[i] = respec(out[i], lf, lf.param_spec, lf.moment_spec)
        if zero1:
            d = layout.mesh.shape["data"]
            rows = [flax_layout(grads[i], layout.leaves[i].transposed)
                    .reshape(d, -1).float() for i in zero1]
            buf = torch.cat(rows, dim=1).contiguous()
            mine = buf.new_empty(buf.shape[1])
            dist.reduce_scatter_tensor(mine, buf.reshape(-1),
                                       group=layout.mesh.data_group)
            if layout.mesh.seq_size > 1:
                # The seq ranks of a data row hold the same blocks and
                # one share each of their gradients.
                dist.all_reduce(mine, group=layout.mesh.seq_group)
            off = 0
            for i, r in zip(zero1, rows):
                lf = layout.leaves[i]
                n = r.shape[1]
                block = mine[off:off + n].reshape(lf.shape[0] // d,
                                                  *lf.shape[1:])
                out[i] = flax_layout(block, lf.transposed).to(
                    grads[i].dtype)
                off += n
        return out, reduced[len(whole):]

    def grad_norm(self, grads) -> torch.Tensor:
        """The global norm of update-space ``grads`` over the logical
        arrays (f32): each tensor's squares summed over the axes that
        split it (one all-reduce over each axis's group in turn)."""
        layout = self.layout
        if layout is None or not layout.sharded:
            return global_norm(grads)
        parts: dict[tuple, list] = {(): []}
        for i, g in enumerate(grads):
            lf = layout.leaves[i]
            parts.setdefault(lf.axes(lf.moment_spec), []).append(
                (g.float() * g.float()).sum())
        zero = grads[0].new_zeros((), dtype=torch.float32)
        total = sum(parts.pop(()), zero)
        for axes, squares in parts.items():
            s = sum(squares, zero).reshape(1)
            for axis in axes:
                dist.all_reduce(s, group=layout.mesh.axis_group(axis))
            total = total + s[0]
        return torch.sqrt(total)

    def apply_gradients(self, grads, norm: torch.Tensor) -> "TrainState":
        """One optimizer update of update-space ``grads``, whose global
        norm (:meth:`grad_norm`) is ``norm``, in place; the step advances.
        ZeRO-1 blocks are all-gathered back into their stored
        parameters, as is any block updated in its moments' placement."""
        params = self.update_params()
        with torch.no_grad():
            updates, self.opt_state = self.tx.update(
                list(grads), self.opt_state, params, norm
            )
            torch._foreach_add_(params, updates)
            zero1 = [] if self.layout is None else self.layout.zero1()
            if zero1:
                for i, t in zip(zero1, self._gather_blocks(
                        zero1, [params[i] for i in zero1])):
                    self.stored_param(i).copy_(t)
            for i in [] if self.layout is None else self.layout.apart():
                lf = self.layout.leaves[i]
                self.stored_param(i).copy_(
                    respec(params[i], lf, lf.moment_spec, lf.param_spec))
        self.step += 1
        return self


def create_train_state(model: nn.Module, *, input_dim: int, lr: float,
                       seed: int, example_shape: tuple | None = None,
                       lr_schedule=None, weight_decay: float = 0.0,
                       grad_clip_norm: float = 0.0, optimizer: str = "adam",
                       momentum: float = 0.0, mesh=None,
                       shard_opt: bool = False, shard_params: bool = False,
                       family: str | None = None) -> TrainState:
    """Initialize ``model``'s parameters from ``seed``
    (:func:`dct_tpu_torch.convert.init_flax_weights`, the same values on
    every device) and the optimizer. ``input_dim`` and ``example_shape``
    (``(1, seq_len, input_dim)`` for the sequence families) are checked
    against the model. ``lr_schedule`` (a float or a function of the
    update count) overrides ``lr``. With a ``mesh`` the state is placed by
    the partition rules of ``family`` (``shard_opt``: ZeRO-1,
    ``shard_params``: FSDP; :func:`dct_tpu_torch.parallel.sharding_rules.
    shard_state_with_rules`)."""
    from dct_tpu_torch.convert import init_flax_weights, load_flax_weights
    from dct_tpu_torch.models.mlp import mask_seed

    features = model.input_dim
    if input_dim != features or (example_shape and example_shape[-1] != features):
        raise ValueError(
            f"model takes {features} input features, not input_dim="
            f"{input_dim} / example_shape={example_shape}"
        )
    if any(p.dtype != torch.float32 for p in model.parameters()):
        raise TypeError("a train state needs f32 master parameters; set "
                        "the compute dtype apart (compute_dtype)")
    load_flax_weights(model, init_flax_weights(model, seed))
    tx = make_optimizer(
        lr_schedule if lr_schedule is not None else lr, optimizer=optimizer,
        weight_decay=weight_decay, momentum=momentum,
        grad_clip_norm=grad_clip_norm,
    )
    state = TrainState(model=model, tx=tx,
                       opt_state=tx.init(list(model.parameters())), step=0,
                       seed=int(seed), rng=mask_seed((seed, 1)))
    if mesh is not None:
        shard_state_with_rules(state, mesh, shard_opt=shard_opt,
                               shard_params=shard_params, family=family)
    return state
