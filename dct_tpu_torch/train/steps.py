"""Train and eval steps (counterpart of ``dct_tpu/train/steps.py``).

The step bodies are the reference's: the weighted-mean cross entropy over
real rows (per position for the causal family), its gradients with respect
to the f32 master parameters, the global gradient norm and the optimizer
update; eval returns the six sums (loss, accuracy, count, tp, fp, fn).
``DCT_DTYPE_RULES`` casts the matching parameters inside the loss body
(:mod:`dct_tpu_torch.parallel.sharding_rules`), so gradients come back f32.

Where the reference compiles a step with ``jit`` and an epoch with
``lax.scan``, the port runs eagerly and loops in Python over the stacked
``[S, B, ...]`` batches: the same order and the same updates. A model
with an ``aux_loss()`` (the MoE family's load-balance terms, the
reference's sown ``aux_loss`` collection, ``:60-83, 110-135``) adds the
terms of its forward to the train objective, divided by the
microbatch count under accumulation; eval leaves them out, so
``val_loss`` stays pure cross entropy. Dropout
masks are seeded by ``(state.rng, state.step)`` (and the microbatch under
accumulation), the contract of ``fold_in(rng, step)`` (``:70``).
Steps update the state in place (see :mod:`dct_tpu_torch.train.state`) and
return it, with the losses and sums as tensors on the model's device.

Under data parallelism (:mod:`dct_tpu_torch.parallel.mesh`) each data
row of processes holds a block of every global batch: the train bodies
divide the block's weighted loss sum by the global row count (a scalar
all-reduce, before the backward), differentiate it and sum the gradients
and the loss over the data group
(:meth:`~dct_tpu_torch.train.state.TrainState.reduce_gradients`: one
all-reduce, and a reduce-scatter for the leaves whose optimizer state is
split over ``data``); the eval sums are reduced once per pass. Every
process then holds the reference's global weighted means. The model ranks
of a block hold the same loss and sums, so nothing is reduced over the
model axis here: its collectives run inside the tensor-parallel modules.
The seq ranks of a block hold one share each of its gradients, and the
same logits: the bodies weight the rows on seq index 0 alone
(:func:`~dct_tpu_torch.parallel.mesh.seq_owned`), and the gradients and
sums are reduced over data x seq.
The grad norm is :meth:`~dct_tpu_torch.train.state.TrainState.grad_norm`,
over the logical arrays. The bodies differentiate each parameter's
stored tensor (:meth:`~dct_tpu_torch.train.state.TrainState.
grad_targets`): a resharded leaf's block (FSDP, a rule's placement) is
gathered by its unit as the unit runs
(:mod:`dct_tpu_torch.parallel.reshard`). With one process the
reductions return their inputs.
"""

from __future__ import annotations

import torch

from dct_tpu_torch.ops.losses import (
    masked_accuracy,
    masked_binary_counts,
    masked_cross_entropy,
)
from dct_tpu_torch.parallel.mesh import all_reduce_sum, seq_owned
from dct_tpu_torch.parallel.sharding_rules import cast_params_by_rules
from dct_tpu_torch.train.state import TrainState


def _position_weight(logits, y, weight):
    """Per-position supervision: ``[B, S, C]`` logits with ``[B, S]``
    labels (or ``[B, S, H, C]`` with ``[B, S, H]``) broadcast the ``[B]``
    row weight over the label positions."""
    if logits.ndim == y.ndim + 1 and y.ndim >= 2 and weight.ndim == 1:
        return weight.reshape(-1, *([1] * (y.ndim - 1))).expand(y.shape)
    return weight


def _device_tensors(state: TrainState, *arrays):
    dev = next(state.model.parameters()).device
    return [torch.as_tensor(a, device=dev) for a in arrays]


def _apply(state: TrainState, x, dropout_key):
    params = cast_params_by_rules(state.model)
    if params is None:
        return state.model(x, dropout_key=dropout_key)
    return torch.func.functional_call(state.model, params, (x,),
                                      {"dropout_key": dropout_key})


def _aux_loss(model):
    """The pre-weighted auxiliary terms of ``model``'s last forward (its
    share of them under data parallelism), or None."""
    fn = getattr(model, "aux_loss", None)
    return fn() if fn is not None else None


def loss_and_grads(state: TrainState, x, y, weight):
    """The train body's objective and its gradients, without the update:
    ``(loss, grads)`` with grads in the update space (``state.params``
    order; see :mod:`dct_tpu_torch.train.state`)."""
    x, y, weight = _device_tensors(state, x, y, weight)
    weight = seq_owned(weight)
    state.model.train()
    logits = _apply(state, x, (state.rng, state.step))
    loss_sum, count = masked_cross_entropy(
        logits, y, _position_weight(logits, y, weight)
    )
    (total,) = all_reduce_sum([count])
    loss = loss_sum / torch.clamp(total, min=1.0)
    aux = _aux_loss(state.model)
    if aux is not None:
        loss = loss + aux
    grads = torch.autograd.grad(loss, state.grad_targets())
    grads, (loss,) = state.reduce_gradients(grads, [loss.detach()])
    return loss, grads


def _train_body(state: TrainState, x, y, weight):
    """One optimization step -> (state, loss, grad global norm)."""
    loss, grads = loss_and_grads(state, x, y, weight)
    gnorm = state.grad_norm(grads)
    return state.apply_gradients(grads, gnorm), loss, gnorm


def _train_accum_body(state: TrainState, x, y, weight, accum_steps: int):
    """One optimizer step over ``accum_steps`` microbatches (consecutive
    row blocks): gradients summed, then applied once. The loss of a chunk
    is its weighted CE sum over the whole batch's supervised count, so the
    sum equals one step on the whole batch."""
    x, y, weight = _device_tensors(state, x, y, weight)
    weight = seq_owned(weight)
    b = x.shape[0]
    if b % accum_steps:
        raise ValueError(f"batch {b} does not split into {accum_steps} "
                         "microbatches")
    n = b // accum_steps
    positions = 1
    for d in y.shape[1:]:
        positions *= d
    (total,) = all_reduce_sum([weight.float().sum() * positions])
    total = torch.clamp(total, min=1.0)
    state.model.train()
    grads, loss = None, torch.zeros((), device=x.device)
    targets = state.grad_targets()
    for i in range(accum_steps):
        rows = slice(i * n, (i + 1) * n)
        cy, cw = y[rows], weight[rows]
        logits = _apply(state, x[rows], (state.rng, state.step, i))
        loss_sum, _ = masked_cross_entropy(
            logits, cy, _position_weight(logits, cy, cw)
        )
        chunk = loss_sum / total
        aux = _aux_loss(state.model)
        if aux is not None:
            chunk = chunk + aux / accum_steps
        g = torch.autograd.grad(chunk, targets)
        grads = g if grads is None else [a + c for a, c in zip(grads, g)]
        loss = loss + chunk.detach()
    grads, (loss,) = state.reduce_gradients(grads, [loss])
    gnorm = state.grad_norm(grads)
    return state.apply_gradients(grads, gnorm), loss, gnorm


def _eval_body(state: TrainState, x, y, weight):
    """One eval batch -> (loss_sum, acc_sum, count, tp, fp, fn)."""
    x, y, weight = _device_tensors(state, x, y, weight)
    weight = seq_owned(weight)
    state.model.eval()
    with torch.no_grad():
        logits = _apply(state, x, None)
        w = _position_weight(logits, y, weight)
        loss_sum, count = masked_cross_entropy(logits, y, w)
        acc_sum, _ = masked_accuracy(logits, y, w)
        tp, fp, fn = masked_binary_counts(logits, y, w)
    return loss_sum, acc_sum, count, tp, fp, fn


def make_train_step(*, accum_steps: int = 1, with_grad_norm: bool = False):
    """Per-batch step: ``(state, x, y, weight) -> (state, metrics)`` with
    ``metrics["train_loss"]`` (and ``"grad_norm"``). ``accum_steps`` > 1
    accumulates that many microbatches into one update."""

    def train_step(state: TrainState, x, y, weight):
        if accum_steps > 1:
            state, loss, gnorm = _train_accum_body(state, x, y, weight,
                                                   accum_steps)
        else:
            state, loss, gnorm = _train_body(state, x, y, weight)
        metrics = {"train_loss": loss}
        if with_grad_norm:
            metrics["grad_norm"] = gnorm
        return state, metrics

    return train_step


def _epoch_train(state: TrainState, xs, ys, ws, accum_steps: int):
    """S stacked batches (grouped by ``accum_steps`` into one update each)
    -> (state, losses [S'], grad norms [S'])."""
    xs, ys, ws = _device_tensors(state, xs, ys, ws)
    if accum_steps > 1:
        s, b = xs.shape[0], xs.shape[1]
        xs = xs.reshape(s // accum_steps, accum_steps * b, *xs.shape[2:])
        ys = ys.reshape(s // accum_steps, accum_steps * b, *ys.shape[2:])
        ws = ws.reshape(s // accum_steps, accum_steps * b)
    losses, gnorms = [], []
    for x, y, w in zip(xs, ys, ws):
        if accum_steps > 1:
            state, loss, gnorm = _train_accum_body(state, x, y, w,
                                                   accum_steps)
        else:
            state, loss, gnorm = _train_body(state, x, y, w)
        losses.append(loss)
        gnorms.append(gnorm)
    empty = torch.zeros(0, device=xs.device)
    return (state, torch.stack(losses) if losses else empty,
            torch.stack(gnorms) if gnorms else empty)


def _epoch_eval(state: TrainState, xs, ys, ws):
    """The six sums over S stacked validation batches (over all
    processes' blocks)."""
    xs, ys, ws = _device_tensors(state, xs, ys, ws)
    sums = tuple(torch.zeros((), device=xs.device) for _ in range(6))
    for x, y, w in zip(xs, ys, ws):
        sums = tuple(a + b for a, b in zip(sums, _eval_body(state, x, y, w)))
    return tuple(all_reduce_sum(sums))


def make_epoch_train_step(*, accum_steps: int = 1,
                          with_grad_norms: bool = False):
    """Whole-epoch training: ``(state, xs, ys, ws) -> (state, losses)``
    (plus the grad norms with ``with_grad_norms``), the same as S calls
    of :func:`make_train_step`'s step."""

    def epoch_train(state: TrainState, xs, ys, ws):
        state, losses, gnorms = _epoch_train(state, xs, ys, ws, accum_steps)
        if with_grad_norms:
            return state, losses, gnorms
        return state, losses

    return epoch_train


def make_epoch_train_eval_step(*, accum_steps: int = 1,
                               with_grad_norms: bool = False):
    """A training epoch, then a validation pass on the updated state:
    ``(state, xs, ys, ws, vxs, vys, vws) -> (state, losses, sums)`` (plus
    the grad norms), sums being (val_loss_sum, val_acc_sum, val_count,
    tp, fp, fn)."""

    def epoch_fused(state: TrainState, xs, ys, ws, vxs, vys, vws):
        state, losses, gnorms = _epoch_train(state, xs, ys, ws, accum_steps)
        sums = _epoch_eval(state, vxs, vys, vws)
        if with_grad_norms:
            return state, losses, sums, gnorms
        return state, losses, sums

    return epoch_fused


def make_multi_epoch_train_eval_step(*, accum_steps: int = 1,
                                     with_grad_norms: bool = False):
    """K training epochs, each followed by a validation pass, in one call:
    ``(state, xs [K,S,B,...], ys, ws, vxs, vys, vws) -> (state, losses
    [K,S], sums)`` (plus the grad norms ``[K,S]``), sums being a 6-tuple of
    ``[K]`` tensors; the same as K calls of
    :func:`make_epoch_train_eval_step`'s step (the ``epoch_chunk``
    knob). ``xs``, ``ys`` and ``ws`` may also be sequences of K per-epoch
    ``[S,B,...]`` stacks, which are then never copied into one."""

    def multi_epoch(state: TrainState, xs, ys, ws, vxs, vys, vws):
        losses, gnorms, sums = [], [], []
        for exs, eys, ews in zip(xs, ys, ws):
            state, ls, gn = _epoch_train(state, exs, eys, ews, accum_steps)
            losses.append(ls)
            gnorms.append(gn)
            sums.append(_epoch_eval(state, vxs, vys, vws))
        sums = tuple(torch.stack(col) for col in zip(*sums))
        losses, gnorms = torch.stack(losses), torch.stack(gnorms)
        if with_grad_norms:
            return state, losses, sums, gnorms
        return state, losses, sums

    return multi_epoch


def make_eval_step():
    """Per-batch eval step returning the six running sums (of this
    process's block; the caller reduces the totals)."""
    return _eval_body


def make_epoch_eval_step():
    """Whole-valset evaluation: ``(state, vxs, vys, vws) -> `` the six
    global sums (loss_sum, acc_sum, count, tp, fp, fn)."""
    return _epoch_eval
