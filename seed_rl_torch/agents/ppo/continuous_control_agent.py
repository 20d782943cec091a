"""Continuous-control policy/value network and its normalizing agent.

Port of ``seed_rl_tpu/agents/ppo/continuous_control_agent.py``:
- ``ContinuousControlNet``: MLP policy and value torsos (or one shared),
  with optional layer normalization and residual connections, an optional
  stack of done-resetting LSTM cells on the policy torso's output that both
  heads then read, swish by default, and per-head initialization gains
  (orthogonal where a gain is given, as the PPO configs ask, Glorot
  uniform otherwise). ``std_independent_of_input`` broadcasts a free
  trainable log-std after the policy head; ``correct_observations`` adds a
  trainable affine on the observation (the compensation of
  ``input_normalization.py``).
- ``NormalizingPolicyAgent``: a ``PolicyAgent`` that normalizes and clips
  observations before the net. It holds the tracker statistics as
  ``obs_norm``; ``update_observation_normalization`` folds a training
  unroll's observations into them once per training step and writes the
  compensation affine, the only trained weights it touches.

The initializers draw from a generator seeded with ``seed`` on the CPU
(PyTorch's orthogonal and Glorot draws: the same distributions as flax's,
not the same numbers); the parity tests carry flax's weights over with
``models/convert.py``. ``unroll`` of a recurrent net folds the torsos and
heads over T*B and steps only the LSTM cells, which computes what the JAX
package's scan of the step computes.
"""

from typing import Callable, Optional

import torch
import torch.nn as nn

from seed_rl_torch.agent import PolicyAgent
from seed_rl_torch.device import resolve_device
from seed_rl_torch.models.core import LSTMStack, lstm_initial_state
from seed_rl_torch.models.policy import _generator
from seed_rl_torch.types import EnvOutput


def swish(x):
    return x * torch.sigmoid(x)


def _linear(in_features: int, out_features: int, gain: Optional[float],
            generator: torch.Generator) -> nn.Linear:
    """A Dense layer with orthogonal(gain) weights, or Glorot uniform ones
    where ``gain`` is None; zero bias."""
    layer = nn.Linear(in_features, out_features)
    with torch.no_grad():
        if gain is None:
            nn.init.xavier_uniform_(layer.weight, generator=generator)
        else:
            nn.init.orthogonal_(layer.weight, gain, generator=generator)
        nn.init.zeros_(layer.bias)
    return layer


class MLPBlock(nn.Module):
    """``num_layers`` Dense layers, each after an optional LayerNorm, with
    residual connections from the second layer on."""

    def __init__(self, input_size: int, num_layers: int, num_units: int,
                 gain: Optional[float], activation: Callable,
                 use_layer_norm: bool, residual: bool,
                 generator: torch.Generator):
        super().__init__()
        sizes = [input_size] + [num_units] * num_layers
        self.layers = nn.ModuleList(
            _linear(a, b, gain, generator)
            for a, b in zip(sizes[:-1], sizes[1:]))
        # flax's LayerNorm: epsilon 1e-6, unit scale, zero bias.
        self.norms = nn.ModuleList(
            nn.LayerNorm(size, eps=1e-6) for size in sizes[:-1]
        ) if use_layer_norm else None
        self.activation = activation
        self.residual = residual

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            h = self.norms[i](x) if self.norms is not None else x
            h = self.activation(layer(h))
            x = x + h if (self.residual and i > 0) else h
        return x


class ContinuousControlNet(nn.Module):
    """MLP (+ optional LSTM) net with policy-params and baseline heads."""

    def __init__(
        self,
        parametric_distribution_param_size: int,
        input_size: int,
        num_layers_policy: int = 3,
        num_layers_value: int = 3,
        num_layers_rnn: int = 0,
        num_units_policy: int = 256,
        num_units_value: int = 256,
        num_units_rnn: int = 256,
        use_layer_norm: bool = False,
        shared: bool = False,
        residual_connections: bool = False,
        activation: Callable = swish,
        kernel_init_gain: Optional[float] = None,
        last_kernel_init_policy_gain: Optional[float] = None,
        last_kernel_init_value_gain: Optional[float] = None,
        correct_observations: bool = False,
        std_independent_of_input: bool = False,
        seed: int = 0,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        generator = _generator(seed)
        self.num_layers_rnn = num_layers_rnn
        self.num_units_rnn = num_units_rnn
        self.correct_observations = correct_observations
        self.std_independent_of_input = std_independent_of_input
        self.shared = shared
        if correct_observations:
            self.obs_correction_scale = nn.Parameter(torch.ones(input_size))
            self.obs_correction_bias = nn.Parameter(torch.zeros(input_size))

        def block(layers, units):
            return MLPBlock(input_size, layers, units, kernel_init_gain,
                            activation, use_layer_norm, residual_connections,
                            generator)

        if shared:
            if (num_layers_policy, num_units_policy) != (
                    num_layers_value, num_units_value):
                raise ValueError("a shared torso needs the same policy and "
                                 "value layers and units")
            self.shared_torso = block(num_layers_policy, num_units_policy)
        else:
            self.policy_torso = block(num_layers_policy, num_units_policy)
            self.value_torso = block(num_layers_value, num_units_value)
        policy_size, value_size = num_units_policy, num_units_value
        if num_layers_rnn:
            self.lstm = LSTMStack(num_units_policy,
                                  (num_units_rnn,) * num_layers_rnn,
                                  generator)
            policy_size = value_size = num_units_rnn
        policy_out = parametric_distribution_param_size
        if std_independent_of_input:
            policy_out //= 2
            self.free_log_std = nn.Parameter(torch.zeros(policy_out))
        self.policy_head = _linear(policy_size, policy_out,
                                   last_kernel_init_policy_gain, generator)
        self.value_head = _linear(value_size, 1, last_kernel_init_value_gain,
                                  generator)
        self.to(device)

    @property
    def stateless(self) -> bool:
        return self.num_layers_rnn == 0

    def initial_state(self, batch_size: int):
        if self.num_layers_rnn == 0:
            return ()
        return lstm_initial_state((self.num_units_rnn,) * self.num_layers_rnn,
                                  batch_size, self.value_head.weight.device)

    def _torsos(self, observation):
        if isinstance(observation, dict):
            observation = torch.cat(
                [v.to(torch.float32) for _, v in sorted(observation.items())],
                dim=-1)
        obs = observation.to(torch.float32)
        if self.correct_observations:
            obs = self.obs_correction_scale * obs + self.obs_correction_bias
        if self.shared:
            out = self.shared_torso(obs)
            return out, out
        return self.policy_torso(obs), self.value_torso(obs)

    def _heads(self, policy_in, value_in):
        policy_params = self.policy_head(policy_in)
        if self.std_independent_of_input:
            free_std = self.free_log_std.expand(policy_params.shape)
            policy_params = torch.cat([policy_params, free_std], dim=-1)
        return policy_params, self.value_head(value_in).squeeze(-1)

    def forward(self, prev_action, env_output: EnvOutput, core_state):
        del prev_action
        policy_in, value_in = self._torsos(env_output.observation)
        if self.num_layers_rnn:
            policy_in, core_state = self.lstm(policy_in, core_state,
                                              env_output.done)
            value_in = policy_in
        return self._heads(policy_in, value_in), core_state

    def unroll(self, prev_actions, env_outputs: EnvOutput, core_state):
        """Time-major ``[T, B]`` forward of a recurrent net: torsos and
        heads folded over T*B, the LSTM cells stepped over time."""
        del prev_actions
        policy_in, _ = self._torsos(env_outputs.observation)
        outputs = []
        for step in range(policy_in.shape[0]):
            out, core_state = self.lstm(policy_in[step], core_state,
                                        env_outputs.done[step])
            outputs.append(out)
        x = torch.stack(outputs)
        return self._heads(x, x), core_state


class NormalizingPolicyAgent(PolicyAgent):
    """PolicyAgent that normalizes (and clips) observations before the net.

    ``obs_norm`` is the tracker state of ``input_normalization`` (``()``
    without one); the PPO learner updates it once per training step, before
    the epochs, and never trains it.
    """

    def __init__(self, net, distribution, input_normalization=None,
                 input_clipping: Optional[float] = None):
        super().__init__(net, distribution)
        self.input_normalization = input_normalization
        self.input_clipping = input_clipping
        self.obs_norm = ()
        if input_normalization is not None:
            self.obs_norm = input_normalization.init_state(
                next(net.parameters()).device)

    def _transform(self, env_output: EnvOutput) -> EnvOutput:
        obs = env_output.observation
        if self.input_normalization is not None:
            obs = self.input_normalization.normalize(self.obs_norm, obs)
        if self.input_clipping is not None:
            obs = torch.clamp(obs, -self.input_clipping, self.input_clipping)
        return env_output._replace(observation=obs)

    def policy_step(self, prev_action, env_output, core_state,
                    generator=None, deterministic=False, noise=None):
        return super().policy_step(prev_action, self._transform(env_output),
                                   core_state, generator, deterministic,
                                   noise)

    def unroll(self, prev_actions, env_outputs, core_state):
        return super().unroll(prev_actions, self._transform(env_outputs),
                              core_state)

    @torch.no_grad()
    def update_observation_normalization(self, observations):
        """Folds ``observations`` ([T, B, obs_size], raw) into the
        statistics and, with ``correct_observations``, reassigns the net's
        compensation affine so the policy and value do not move."""
        norm = self.input_normalization
        if norm is None:
            return
        if not self.net.correct_observations:
            self.obs_norm = norm.tracker.update(self.obs_norm, observations)
            return
        net = self.net
        comp = {"compensation_mean": net.obs_correction_bias,
                "compensation_std": net.obs_correction_scale}
        self.obs_norm, new = norm.update_statistics(self.obs_norm, comp,
                                                    observations)
        net.obs_correction_bias.copy_(new["compensation_mean"])
        net.obs_correction_scale.copy_(new["compensation_std"])
