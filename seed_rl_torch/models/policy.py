"""Policy-value networks (V-trace/PPO family heads).

Port of ``seed_rl_tpu/models/policy.py``. ``MLPAndLSTM`` is MLP torso ->
stacked LSTM with done reset -> policy-logits + baseline heads;
``MLPPolicyNetwork`` is the stateless variant.

Networks are step-level modules: ``forward(prev_action, env_output,
core_state) -> ((policy_params, baseline), new_core_state)`` on batch-major
``[B, ...]`` inputs. Unlike flax, a module needs its input width up front
(``input_size``) and is built on the device it runs on. Parameters are
drawn on the CPU from a generator seeded with ``seed`` and then moved, so
a seed gives the same weights on every device.
"""

from typing import Sequence

import torch
import torch.nn as nn

from seed_rl_torch.device import resolve_device
from seed_rl_torch.models.core import (
    LSTMStack,
    MLPTorso,
    dense,
    lstm_initial_state,
)
from seed_rl_torch.utils import tree


def _flatten_observation(observation, batch_dims: int = 1) -> torch.Tensor:
    """Concatenate a (possibly dict) observation into a flat f32 vector,
    dict keys in sorted order as ``jax.tree.leaves`` takes them."""
    leaves = tree.sorted_leaves(observation)
    batch_shape = tuple(leaves[0].shape[:batch_dims])
    flat = [
        leaf.to(torch.float32).reshape(batch_shape + (-1,))
        for leaf in leaves
    ]
    return flat[0] if len(flat) == 1 else torch.cat(flat, dim=-1)


def _generator(seed: int) -> torch.Generator:
    generator = torch.Generator()
    generator.manual_seed(seed)
    return generator


class MLPAndLSTM(nn.Module):
    """MLP torso + stacked LSTM + (policy_params, baseline) heads."""

    stateless = False

    def __init__(
        self,
        parametric_distribution_param_size: int,
        input_size: int,
        mlp_sizes: Sequence[int] = (64, 64),
        lstm_sizes: Sequence[int] = (64,),
        seed: int = 0,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        generator = _generator(seed)
        self.lstm_sizes = tuple(lstm_sizes)
        self.torso = MLPTorso(input_size, mlp_sizes, "relu", generator)
        self.lstm = LSTMStack(self.torso.output_size, lstm_sizes, generator)
        core_size = self.lstm_sizes[-1]
        self.policy_logits = dense(
            core_size, parametric_distribution_param_size, generator
        )
        self.baseline = dense(core_size, 1, generator)
        self.to(device)

    def initial_state(self, batch_size: int):
        return lstm_initial_state(
            self.lstm_sizes, batch_size, self.baseline.weight.device
        )

    def _heads(self, x):
        return self.policy_logits(x), self.baseline(x).squeeze(-1)

    def forward(self, prev_action, env_output, core_state):
        del prev_action
        x = self.torso(_flatten_observation(env_output.observation))
        x, core_state = self.lstm(x, core_state, env_output.done)
        return self._heads(x), core_state

    def unroll(self, prev_actions, env_outputs, core_state):
        """Time-major ``[T, B]`` forward: torso and heads folded over T*B,
        only the LSTM stepped over time (same math as stepping ``forward``).
        """
        del prev_actions
        obs = _flatten_observation(env_outputs.observation, batch_dims=2)
        t, b = obs.shape[:2]
        x = self.torso(obs.reshape(t * b, -1)).reshape(t, b, -1)
        outputs = []
        for step in range(t):
            out, core_state = self.lstm(
                x[step], core_state, env_outputs.done[step]
            )
            outputs.append(out)
        policy_params, baseline = self._heads(torch.stack(outputs))
        return (policy_params, baseline), core_state


class MLPPolicyNetwork(nn.Module):
    """Stateless MLP policy+value net (separate or shared torso)."""

    stateless = True

    def __init__(
        self,
        parametric_distribution_param_size: int,
        input_size: int,
        mlp_sizes: Sequence[int] = (64, 64),
        shared_torso: bool = False,
        activation: str = "tanh",
        seed: int = 0,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        generator = _generator(seed)
        self.shared_torso = shared_torso
        if shared_torso:
            self.torso = MLPTorso(input_size, mlp_sizes, activation, generator)
            head_size = self.torso.output_size
        else:
            self.policy_torso = MLPTorso(
                input_size, mlp_sizes, activation, generator
            )
            self.value_torso = MLPTorso(
                input_size, mlp_sizes, activation, generator
            )
            head_size = self.policy_torso.output_size
        self.policy_logits = dense(
            head_size, parametric_distribution_param_size, generator
        )
        self.baseline = dense(head_size, 1, generator)
        self.to(device)

    def initial_state(self, batch_size: int):
        del batch_size
        return ()

    def forward(self, prev_action, env_output, core_state):
        del prev_action
        x = _flatten_observation(env_output.observation)
        if self.shared_torso:
            policy_in = value_in = self.torso(x)
        else:
            policy_in, value_in = self.policy_torso(x), self.value_torso(x)
        policy_params = self.policy_logits(policy_in)
        baseline = self.baseline(value_in).squeeze(-1)
        return (policy_params, baseline), core_state
