"""Recurrent family (counterpart of ``dct_tpu/models/gru.py``).

``WeatherGRU`` stacks GRU layers over ``[B, S, F]`` windows and classifies
the last layer's final state. Each layer computes the input projections
of every timestep in one product (``x_gates``, ``[B, S, 3H]`` in r, z, n
order), then steps through time with one ``[B, H] x [H, 3H]`` product and
the gates of ``torch.nn.GRU``: the reset gate scales the whole hidden
pre-activation, bias included, ``n = tanh(xn + r * (h Wh + bh))``.

Parameters carry the flax names and layouts: ``gru_<i>/x_gates`` is a
dense layer, ``gru_<i>/h_kernel`` ``[H, 3H]`` and ``gru_<i>/h_bias``
``[3H]`` stay in flax's layout (``flax_params``, see
:mod:`dct_tpu_torch.convert`), ``head`` is dense. The state is kept in the
compute dtype, as the reference's scan carry is. Dropout (flax
``nn.Dropout`` semantics, the port's seeding) goes between layers and on
the last state. No kernel lies on this path: the reference's recurrence is
plain JAX, so plain tensor ops are its counterpart.
"""

from __future__ import annotations

import torch
from torch import nn

from dct_tpu_torch.convert import init_listed
from dct_tpu_torch.models.mlp import Dropout, TorchStyleDense


class GRULayer(nn.Module):
    """One GRU layer: ``[B, S, D_in]`` -> (outputs ``[B, S, H]``, last
    state ``[B, H]``)."""

    def __init__(self, input_dim: int, hidden: int, *, device=None,
                 dtype=None, compute_dtype=None):
        super().__init__()
        self.hidden = hidden
        self.compute_dtype = compute_dtype
        self.x_gates = TorchStyleDense(input_dim, 3 * hidden, device=device,
                                       dtype=dtype,
                                       compute_dtype=compute_dtype)
        self.h_kernel = nn.Parameter(torch.empty(
            hidden, 3 * hidden, device=device, dtype=dtype))
        self.h_bias = nn.Parameter(torch.zeros(
            3 * hidden, device=device, dtype=dtype))
        self.flax_params = {"h_kernel": ("lecun_normal", hidden),
                            "h_bias": ("zeros",)}
        init_listed(self)

    def forward(self, xs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        dtype = self.compute_dtype or xs.dtype
        x_gates = self.x_gates(xs)  # [B, S, 3H]
        wh = self.h_kernel.to(dtype)
        bh = self.h_bias.to(dtype)
        h = torch.zeros(xs.shape[0], self.hidden, dtype=dtype,
                        device=xs.device)
        outs = []
        for t in range(xs.shape[1]):
            hg = h @ wh + bh
            xr, xz, xn = x_gates[:, t].chunk(3, dim=-1)
            hr, hz, hn = hg.chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h = (1.0 - z) * n + z * h
            outs.append(h)
        return torch.stack(outs, dim=1), h


class WeatherGRU(nn.Module):
    """Stacked GRU over ``[B, S, F]`` windows -> ``[B, num_classes]`` f32
    logits. ``seq_len`` is the window the model is trained and served at
    (the recurrence itself takes any length)."""

    def __init__(self, input_dim: int, seq_len: int, *, hidden_dim: int = 64,
                 n_layers: int = 2, num_classes: int = 2,
                 dropout: float = 0.2, device=None, dtype=torch.float32,
                 compute_dtype=None):
        super().__init__()
        self.input_dim, self.seq_len = input_dim, seq_len
        self.n_layers = n_layers
        self.compute_dtype = compute_dtype or dtype
        kw = {"device": device, "dtype": dtype,
              "compute_dtype": self.compute_dtype}
        for i in range(n_layers):
            self.add_module(f"gru_{i}", GRULayer(
                input_dim if i == 0 else hidden_dim, hidden_dim, **kw))
        self.drop = Dropout(dropout)
        self.head = TorchStyleDense(hidden_dim, num_classes, **kw)

    def forward(self, x: torch.Tensor,
                dropout_key: tuple | None = None) -> torch.Tensor:
        """``dropout_key`` seeds every dropout mask of this forward
        (needed only in training mode with dropout > 0); site ``i`` is
        the dropout after layer ``i``, the last one on the final state."""
        h = x.to(self.compute_dtype)
        last = None
        for i in range(self.n_layers):
            h, last = getattr(self, f"gru_{i}")(h)
            if i < self.n_layers - 1:
                h = self.drop(h, None if dropout_key is None
                              else tuple(dropout_key) + (i,))
        pooled = self.drop(last, None if dropout_key is None
                           else tuple(dropout_key) + (self.n_layers - 1,))
        return self.head(pooled).float()
