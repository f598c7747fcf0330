"""Train and eval steps (counterpart of ``dct_tpu/train/steps.py``).

The step bodies are the reference's: the weighted-mean cross entropy over
real rows (per position for the causal family), its gradients with respect
to the f32 master parameters, the global gradient norm and the optimizer
update; eval returns the six sums (loss, accuracy, count, tp, fp, fn).
``DCT_DTYPE_RULES`` casts the matching parameters inside the loss body
(:mod:`dct_tpu_torch.parallel.sharding_rules`), so gradients come back f32.

Where the reference compiles a step with ``jit`` and an epoch with
``lax.scan``, the port runs eagerly and loops in Python over the stacked
``[S, B, ...]`` batches: the same order and the same updates. Dropout
masks are seeded by ``(state.rng, state.step)`` (and the microbatch under
accumulation), the contract of ``fold_in(rng, step)`` (``:70``).
Steps update the state in place (see :mod:`dct_tpu_torch.train.state`) and
return it, with the losses and sums as tensors on the model's device.
"""

from __future__ import annotations

import torch

from dct_tpu_torch.ops.losses import (
    masked_accuracy,
    masked_binary_counts,
    masked_cross_entropy,
)
from dct_tpu_torch.parallel.sharding_rules import cast_params_by_rules
from dct_tpu_torch.train.state import TrainState, global_norm


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


def loss_and_grads(state: TrainState, x, y, weight):
    """The train body's objective and its gradients, without the update:
    ``(loss, grads)`` with grads in ``state.params`` order."""
    x, y, weight = _device_tensors(state, x, y, weight)
    state.model.train()
    logits = _apply(state, x, (state.rng, state.step))
    loss_sum, count = masked_cross_entropy(
        logits, y, _position_weight(logits, y, weight)
    )
    loss = loss_sum / torch.clamp(count, min=1.0)
    grads = torch.autograd.grad(loss, state.params)
    return loss.detach(), grads


def _train_body(state: TrainState, x, y, weight):
    """One optimization step -> (state, loss, grad global norm)."""
    loss, grads = loss_and_grads(state, x, y, weight)
    gnorm = global_norm(grads)
    return state.apply_gradients(grads), loss, gnorm


def _train_accum_body(state: TrainState, x, y, weight, accum_steps: int):
    """One optimizer step over ``accum_steps`` microbatches (consecutive
    row blocks): gradients summed, then applied once. The loss of a chunk
    is its weighted CE sum over the whole batch's supervised count, so the
    sum equals one step on the whole batch."""
    x, y, weight = _device_tensors(state, x, y, weight)
    b = x.shape[0]
    if b % accum_steps:
        raise ValueError(f"batch {b} does not split into {accum_steps} "
                         "microbatches")
    n = b // accum_steps
    positions = 1
    for d in y.shape[1:]:
        positions *= d
    total = torch.clamp(weight.float().sum() * positions, min=1.0)
    state.model.train()
    params = state.params
    grads, loss = None, torch.zeros((), device=x.device)
    for i in range(accum_steps):
        rows = slice(i * n, (i + 1) * n)
        cy, cw = y[rows], weight[rows]
        logits = _apply(state, x[rows], (state.rng, state.step, i))
        loss_sum, _ = masked_cross_entropy(
            logits, cy, _position_weight(logits, cy, cw)
        )
        chunk = loss_sum / total
        g = torch.autograd.grad(chunk, params)
        grads = g if grads is None else [a + c for a, c in zip(grads, g)]
        loss = loss + chunk.detach()
    gnorm = global_norm(grads)
    return state.apply_gradients(grads), loss, gnorm


def _eval_body(state: TrainState, x, y, weight):
    """One eval batch -> (loss_sum, acc_sum, count, tp, fp, fn)."""
    x, y, weight = _device_tensors(state, x, y, weight)
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
    """The six sums over S stacked validation batches."""
    xs, ys, ws = _device_tensors(state, xs, ys, ws)
    sums = tuple(torch.zeros((), device=xs.device) for _ in range(6))
    for x, y, w in zip(xs, ys, ws):
        sums = tuple(a + b for a, b in zip(sums, _eval_body(state, x, y, w)))
    return sums


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


def make_eval_step():
    """Per-batch eval step returning the six running sums."""
    return _eval_body
