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
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
from torch import nn


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

    def update(updates, state, params):
        new_state = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
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
    least ``max_norm`` (no epsilon, as optax)."""

    def update(updates, state, params):
        norm = global_norm(updates)
        clipped = norm >= max_norm
        return [torch.where(clipped, u / norm.to(u.dtype) * max_norm, u)
                for u in updates], state

    return GradientTransformation(lambda params: None, update)


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
    global norm first. ``adafactor`` is not ported yet and raises."""
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
    """The model (holding the f32 master parameters), the optimizer and
    its state, the step, the seed and the dropout seed ``rng`` that, with
    the step, seeds every dropout mask of a step."""

    model: nn.Module
    tx: GradientTransformation
    opt_state: Any
    step: int
    seed: int
    rng: int

    @property
    def params(self) -> list[torch.Tensor]:
        return list(self.model.parameters())

    def apply_gradients(self, grads) -> "TrainState":
        """One optimizer update, in place; the step advances."""
        params = self.params
        with torch.no_grad():
            updates, self.opt_state = self.tx.update(
                list(grads), self.opt_state, params
            )
            torch._foreach_add_(params, updates)
        self.step += 1
        return self


def create_train_state(model: nn.Module, *, input_dim: int, lr: float,
                       seed: int, example_shape: tuple | None = None,
                       lr_schedule=None, weight_decay: float = 0.0,
                       grad_clip_norm: float = 0.0, optimizer: str = "adam",
                       momentum: float = 0.0) -> TrainState:
    """Initialize ``model``'s parameters from ``seed``
    (:func:`dct_tpu_torch.convert.init_flax_weights`, the same values on
    every device) and the optimizer. ``input_dim`` and ``example_shape``
    (``(1, seq_len, input_dim)`` for the sequence families) are checked
    against the model. ``lr_schedule`` (a float or a function of the
    update count) overrides ``lr``."""
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
    return TrainState(model=model, tx=tx,
                      opt_state=tx.init(list(model.parameters())), step=0,
                      seed=int(seed), rng=mask_seed((seed, 1)))
