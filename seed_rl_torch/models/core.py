"""Shared network building blocks: MLP torsos and done-resetting LSTM stacks.

Port of ``seed_rl_tpu/models/core.py``. Parameters start from flax's
defaults, so learning curves stay comparable with the JAX package:
lecun-normal (truncated) Dense kernels, orthogonal LSTM recurrent kernels
per gate, zero biases.

The LSTM reset semantics match the JAX package: where ``done`` is set at a
timestep the core state is reset to the initial (zero) state *before* that
step's core update, because the post-done observation is the first of the
next episode. The carry of each cell is ``(c, h)``, flax's order.
"""

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.utils._pytree as pytree

# Standard deviation of a standard normal truncated to [-2, 2]; flax's
# variance_scaling divides by it so the truncated draw keeps variance 1.
_TRUNCATED_NORMAL_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator):
    """flax ``lecun_normal`` for a ``[out, in]`` or ``[out, in, kh, kw]``
    weight: fan-in (``in * kh * kw``) scaling."""
    std = math.sqrt(1.0 / weight[0].numel()) / _TRUNCATED_NORMAL_STD
    with torch.no_grad():
        nn.init.trunc_normal_(
            weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator
        )
    return weight


def dense(in_features: int, out_features: int,
          generator: torch.Generator) -> nn.Linear:
    """``nn.Linear`` initialised like flax ``nn.Dense``."""
    layer = nn.Linear(in_features, out_features)
    lecun_normal_(layer.weight, generator)
    nn.init.zeros_(layer.bias)
    return layer


def conv(in_channels: int, out_channels: int, kernel: int, stride: int,
         padding: int, generator: torch.Generator) -> nn.Conv2d:
    """``nn.Conv2d`` initialised like flax ``nn.Conv`` (lecun-normal kernel,
    zero bias). ``padding`` is symmetric: flax's ``"VALID"`` is 0, its
    ``"SAME"`` for an odd kernel at stride 1 is ``kernel // 2``."""
    layer = nn.Conv2d(in_channels, out_channels, kernel, stride, padding)
    lecun_normal_(layer.weight, generator)
    nn.init.zeros_(layer.bias)
    return layer


def lstm_initial_state(
    lstm_sizes: Sequence[int], batch_size: int, device=None,
    dtype=torch.float32,
):
    """Zero carry for a stack of LSTM cells: tuple of (c, h) pairs."""
    return tuple(
        (
            torch.zeros((batch_size, size), dtype=dtype, device=device),
            torch.zeros((batch_size, size), dtype=dtype, device=device),
        )
        for size in lstm_sizes
    )


def reset_state_where_done(done, state, initial_state):
    """Per-batch-element select of the initial state where done is set."""

    def sel(init, cur):
        d = done.reshape(done.shape + (1,) * (cur.dim() - done.dim()))
        return torch.where(d, init, cur)

    return pytree.tree_map(sel, initial_state, state)


class MLPTorso(nn.Module):
    """Plain MLP (ReLU by default), one ``dense`` layer per size."""

    def __init__(self, input_size: int, layer_sizes: Sequence[int],
                 activation: str, generator: torch.Generator):
        super().__init__()
        sizes = [input_size] + list(layer_sizes)
        self.layers = nn.ModuleList(
            dense(a, b, generator) for a, b in zip(sizes[:-1], sizes[1:])
        )
        self.activation = getattr(torch, activation)
        self.output_size = sizes[-1]

    def forward(self, x):
        x = x.to(torch.float32)
        for layer in self.layers:
            x = self.activation(layer(x))
        return x


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell`` with its per-gate params fused.

    ``weight_ih`` [4H, in] and ``weight_hh`` [4H, H] stack the gates in the
    order i, f, g, o; ``bias`` [4H] is the hidden-side bias (flax's input
    kernels have none).
    """

    def __init__(self, input_size: int, hidden_size: int,
                 generator: torch.Generator):
        super().__init__()
        self.hidden_size = hidden_size
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden_size, input_size))
        self.weight_hh = nn.Parameter(
            torch.empty(4 * hidden_size, hidden_size)
        )
        self.bias = nn.Parameter(torch.zeros(4 * hidden_size))
        with torch.no_grad():
            for gate in range(4):
                rows = slice(gate * hidden_size, (gate + 1) * hidden_size)
                lecun_normal_(self.weight_ih[rows], generator)
                nn.init.orthogonal_(self.weight_hh[rows], generator=generator)

    def forward(self, carry, x) -> Tuple[Tuple[torch.Tensor, torch.Tensor],
                                         torch.Tensor]:
        c, h = carry
        gates = (
            nn.functional.linear(h, self.weight_hh, self.bias)
            + nn.functional.linear(x, self.weight_ih)
        )
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return (new_c, new_h), new_h


class LSTMStack(nn.Module):
    """Stacked LSTM cells, single step, with done-masked state reset."""

    def __init__(self, input_size: int, lstm_sizes: Sequence[int],
                 generator: torch.Generator):
        super().__init__()
        self.lstm_sizes = tuple(lstm_sizes)
        sizes = [input_size] + list(lstm_sizes)
        self.cells = nn.ModuleList(
            LSTMCell(a, b, generator) for a, b in zip(sizes[:-1], sizes[1:])
        )

    def forward(self, inputs, core_state, done):
        initial = lstm_initial_state(
            self.lstm_sizes, inputs.shape[0], inputs.device, inputs.dtype
        )
        core_state = reset_state_where_done(done, core_state, initial)
        x = inputs
        new_states = []
        for cell, carry in zip(self.cells, core_state):
            carry, x = cell(carry, x)
            new_states.append(carry)
        return x, tuple(new_states)
