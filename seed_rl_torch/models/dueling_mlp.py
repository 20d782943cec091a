"""Dueling LSTM DQN over vector observations (R2D2's non-pixel network).

Port of ``seed_rl_tpu/models/dueling_mlp.py::VectorDuelingDQNNet``: MLP
torso, then ``[torso, reward, one_hot(prev_action)]`` into one LSTM cell
whose state resets where ``done`` is set, then dueling heads
``Q = V + (A - mean_a A)`` (the advantage head has no bias) and the greedy
action.

``forward`` is one step on ``[B]`` inputs; ``unroll`` runs time-major
``[T, B]`` inputs, folding the torso and the heads over T*B and stepping
only the LSTM over time, which computes what stepping ``forward`` (the JAX
package's ``lax.scan``) computes. Parameters are drawn on the CPU from a
generator seeded with ``seed`` and then moved, as in ``models/policy.py``.

``DuelingQHeads`` holds what this net shares with the pixel net
``models/atari.py::DuelingLSTMDQNNet``: the LSTM's input layout and the
dueling heads.
"""

from typing import Sequence

import torch
import torch.nn as nn

from seed_rl_torch.device import resolve_device
from seed_rl_torch.models.core import (
    LSTMStack,
    MLPTorso,
    dense,
    lecun_normal_,
    lstm_initial_state,
)
from seed_rl_torch.models.policy import _flatten_observation, _generator
from seed_rl_torch.types import QAgentOutput


class DuelingQHeads:
    """The dueling heads ``Q = V + (A - mean_a A)`` over hidden layers
    (the advantage head has no bias) and the greedy action, and the LSTM
    input ``[features, reward, one_hot(prev_action)]``. A mixin of
    ``nn.Module``s; the parameter names are flax's."""

    def _init_heads(self, core_size: int, hidden_size: int,
                    num_actions: int, generator: torch.Generator):
        self.num_actions = num_actions
        self.hidden_value = dense(core_size, hidden_size, generator)
        self.value_head = dense(hidden_size, 1, generator)
        self.hidden_advantage = dense(core_size, hidden_size, generator)
        self.advantage_head = nn.Linear(hidden_size, num_actions, bias=False)
        lecun_normal_(self.advantage_head.weight, generator)

    def _core_inputs(self, features, prev_action, reward):
        one_hot = nn.functional.one_hot(
            prev_action.long(), self.num_actions).to(features.dtype)
        return torch.cat(
            [features, reward.to(features.dtype).unsqueeze(-1), one_hot],
            dim=-1)

    def _heads(self, x) -> QAgentOutput:
        value = self.value_head(torch.relu(self.hidden_value(x)))
        advantage = self.advantage_head(
            torch.relu(self.hidden_advantage(x)))
        advantage = advantage - torch.mean(advantage, dim=-1, keepdim=True)
        q_values = value + advantage
        action = torch.argmax(q_values, dim=-1).to(torch.int32)
        return QAgentOutput(action, q_values)


class VectorDuelingDQNNet(DuelingQHeads, nn.Module):
    """MLP torso + LSTM + dueling Q heads; outputs ``QAgentOutput``."""

    stateless = False

    def __init__(
        self,
        num_actions: int,
        input_size: int,
        mlp_sizes: Sequence[int] = (64,),
        lstm_size: int = 64,
        hidden_size: int = 64,
        seed: int = 0,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        generator = _generator(seed)
        self.lstm_size = lstm_size
        self.torso = MLPTorso(input_size, mlp_sizes, "relu", generator)
        core_input = self.torso.output_size + 1 + num_actions
        self.lstm = LSTMStack(core_input, (lstm_size,), generator)
        self._init_heads(lstm_size, hidden_size, num_actions, generator)
        self.to(device)

    def initial_state(self, batch_size: int):
        return lstm_initial_state(
            (self.lstm_size,), batch_size, self.value_head.weight.device
        )

    def _torso_inputs(self, prev_action, env_output, batch_dims):
        obs = _flatten_observation(env_output.observation, batch_dims)
        lead = obs.shape[:batch_dims]
        x = self.torso(obs.reshape((-1, obs.shape[-1]))).reshape(
            lead + (-1,))
        return self._core_inputs(x, prev_action, env_output.reward)

    def forward(self, prev_action, env_output, core_state):
        x = self._torso_inputs(prev_action, env_output, batch_dims=1)
        x, core_state = self.lstm(x, core_state, env_output.done)
        return self._heads(x), core_state

    def unroll(self, prev_actions, env_outputs, core_state):
        """Time-major ``[T, B]`` forward; returns (QAgentOutput [T, B, ...],
        final core state)."""
        x = self._torso_inputs(prev_actions, env_outputs, batch_dims=2)
        outputs = []
        for step in range(x.shape[0]):
            out, core_state = self.lstm(
                x[step], core_state, env_outputs.done[step])
            outputs.append(out)
        return self._heads(torch.stack(outputs)), core_state
