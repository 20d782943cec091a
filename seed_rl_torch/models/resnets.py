"""IMPALA-style residual conv networks (the DmLab-class deep agent).

Port of ``seed_rl_tpu/models/resnets.py``: ``ResidualStack`` (3x3 SAME conv,
3x3/2 SAME max pool, residual blocks of ReLU-conv-ReLU-conv),
``ImpalaResNetTorso`` (stacks (16,2)(32,2)(32,2), ReLU, Dense 256) and
``ImpalaDeep`` (torso, then [torso, reward clipped to +-1, one-hot previous
action] into an LSTM(256) that resets where ``done`` is set, then policy
logits and baseline), and ``GFootball`` (the stateless Football agent: four
stacks (16,2)(32,2)(32,2)(32,2) over the bit planes that
``envs/football.py::unpackbits`` unpacks on the device, then policy logits
and baseline).

Frames stay NHWC uint8; the torso runs channels_last and flattens in the
JAX package's (H, W, C) order (see ``models/atari.py``). A 3x3 SAME conv at
stride 1 is a symmetric pad of 1; the pool's SAME padding can be
asymmetric and lives in ``ops/pooling.py``.

``dtype`` is the torso's compute dtype, as in the JAX package: every conv
and the Dense cast their input, kernel and bias to it (``models/core.py``),
the pool and the residual sums run in it, and the torso returns f32; the
LSTM and the heads compute in f32.

``remat=True`` recomputes the torso in the backward pass
(``torch.utils.checkpoint``) with the same parameters, trading a second
torso forward for not storing its activations.

The JAX package's ``ImpalaDeep`` has no time-major path, so its agent scans
the whole step over time. Here ``unroll`` folds the torso and the heads over
T*B and steps only the LSTM cell, which computes what stepping ``forward``
computes. Parameters are drawn on the CPU from a generator seeded with
``seed`` and then moved, as in ``models/policy.py``.
"""

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.utils.checkpoint

from seed_rl_torch.device import resolve_device
from seed_rl_torch.envs.football import unpackbits
from seed_rl_torch.models.atari import flatten_hwc, nchw_frames
from seed_rl_torch.models.core import (
    LSTMStack,
    conv,
    conv_apply,
    dense,
    dense_apply,
    lstm_initial_state,
)
from seed_rl_torch.models.policy import _generator
from seed_rl_torch.ops.pooling import max_pool_same
from seed_rl_torch.utils.profiling import span


class ResidualStack(nn.Module):
    """Conv + max-pool downscale followed by residual conv blocks, computing
    in ``dtype``."""

    def __init__(self, in_channels: int, num_ch: int, num_blocks: int,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = conv(in_channels, num_ch, 3, 1, 1, generator)
        self.blocks = nn.ModuleList(
            nn.ModuleList(conv(num_ch, num_ch, 3, 1, 1, generator)
                          for _ in range(2))
            for _ in range(num_blocks)
        )

    def forward(self, x):
        x = max_pool_same(conv_apply(self.conv, x, self.dtype), (3, 3),
                          (2, 2))
        for conv0, conv1 in self.blocks:
            y = conv_apply(conv0, torch.relu(x), self.dtype)
            x = x + conv_apply(conv1, torch.relu(y), self.dtype)
        return x


class ImpalaResNetTorso(nn.Module):
    """Residual stacks + ReLU + Dense, computing in ``dtype``. Input: uint8
    ``[N, H, W, C]``; output f32."""

    def __init__(
        self,
        observation_shape: Tuple[int, int, int],
        generator: torch.Generator,
        stack_config: Sequence[Tuple[int, int]] = ((16, 2), (32, 2), (32, 2)),
        out_features: int = 256,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        h, w, channels = observation_shape
        stacks = []
        for num_ch, num_blocks in stack_config:
            stacks.append(
                ResidualStack(channels, num_ch, num_blocks, generator, dtype))
            channels = num_ch
            h, w = -(-h // 2), -(-w // 2)  # a SAME pool at stride 2: ceil
        self.stacks = nn.ModuleList(stacks)
        self.dense = dense(channels * h * w, out_features, generator)

    def forward(self, frames):
        with span("torso"):
            x = nchw_frames(frames, self.dtype)
            for stack in self.stacks:
                x = stack(x)
            x = flatten_hwc(torch.relu(x))
            return torch.relu(dense_apply(self.dense, x, self.dtype)).to(
                torch.float32)


def core_inputs(torso: ImpalaResNetTorso, num_actions: int, prev_action,
                env_output, batch_dims: int, remat: bool = False):
    """The core's input over ``batch_dims`` leading dims: the torso's
    features, the reward clipped to +-1 and the one-hot previous action,
    f32. ``remat`` recomputes the torso in the backward pass."""
    frames = env_output.observation
    lead = frames.shape[:batch_dims]
    frames = frames.reshape((-1,) + frames.shape[batch_dims:])
    if remat and torch.is_grad_enabled():
        x = torch.utils.checkpoint.checkpoint(torso, frames,
                                              use_reentrant=False)
    else:
        x = torso(frames)
    x = x.reshape(lead + x.shape[-1:])
    reward = torch.clamp(env_output.reward.to(x.dtype), -1.0, 1.0)
    one_hot = nn.functional.one_hot(prev_action.long(), num_actions).to(
        x.dtype)
    return torch.cat([x, reward.unsqueeze(-1), one_hot], dim=-1)


class ImpalaDeep(nn.Module):
    """Deep IMPALA agent: resnet torso + LSTM(256) + policy/value heads.

    ``forward(prev_action, env_output, core_state)`` on ``[B]`` inputs and
    ``unroll`` on time-major ``[T, B]`` inputs return
    ``((policy_logits, baseline), core_state)``; the core state is a tuple
    holding one LSTM ``(c, h)`` pair, as in the JAX package.
    """

    stateless = False

    def __init__(
        self,
        num_actions: int,
        observation_shape: Tuple[int, int, int],
        lstm_size: int = 256,
        remat: bool = False,
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        generator = _generator(seed)
        self.num_actions = num_actions
        self.lstm_size = lstm_size
        self.remat = remat
        self.torso = ImpalaResNetTorso(tuple(observation_shape), generator,
                                       dtype=dtype)
        core_input = self.torso.dense.out_features + 1 + num_actions
        self.lstm = LSTMStack(core_input, (lstm_size,), generator)
        self.policy_logits = dense(lstm_size, num_actions, generator)
        self.baseline = dense(lstm_size, 1, generator)
        self.to(device)

    def initial_state(self, batch_size: int):
        return lstm_initial_state(
            (self.lstm_size,), batch_size, self.baseline.weight.device)

    def _core_inputs(self, prev_action, env_output, batch_dims: int):
        return core_inputs(self.torso, self.num_actions, prev_action,
                           env_output, batch_dims, self.remat)

    def _heads(self, x):
        return self.policy_logits(x), self.baseline(x).squeeze(-1)

    def forward(self, prev_action, env_output, core_state):
        x = self._core_inputs(prev_action, env_output, batch_dims=1)
        x, core_state = self.lstm(x, core_state, env_output.done)
        return self._heads(x), core_state

    def unroll(self, prev_actions, env_outputs, core_state):
        """[T, B] training path: folded torso/heads, the LSTM stepped."""
        x = self._core_inputs(prev_actions, env_outputs, batch_dims=2)
        outputs = []
        for step in range(x.shape[0]):
            out, core_state = self.lstm(
                x[step], core_state, env_outputs.done[step])
            outputs.append(out)
        return self._heads(torch.stack(outputs)), core_state


class GFootball(nn.Module):
    """Stateless 4-stack resnet agent over bit-packed SMM observations.

    ``observation_shape`` is the packed ``(H, W, C)`` uint16 frame's (with
    ``unpack_input_bits``, the torso sees ``16 C`` planes).
    ``forward(prev_action, env_output, core_state)`` returns
    ``((policy_params, baseline), core_state)``; the core state is ``()``.
    """

    stateless = True

    def __init__(
        self,
        parametric_distribution_param_size: int,
        observation_shape: Tuple[int, int, int],
        unpack_input_bits: bool = True,
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        generator = _generator(seed)
        h, w, channels = observation_shape
        self.unpack_input_bits = unpack_input_bits
        if unpack_input_bits:
            channels *= 16
        self.torso = ImpalaResNetTorso(
            (h, w, channels), generator,
            stack_config=((16, 2), (32, 2), (32, 2), (32, 2)), dtype=dtype)
        out = self.torso.dense.out_features
        self.policy_logits = dense(out, parametric_distribution_param_size,
                                   generator)
        self.baseline = dense(out, 1, generator)
        self.to(device)

    def initial_state(self, batch_size: int):
        del batch_size
        return ()

    def forward(self, prev_action, env_output, core_state):
        del prev_action
        frame = env_output.observation
        if self.unpack_input_bits:
            frame = unpackbits(frame)
        x = self.torso(frame)
        return (self.policy_logits(x), self.baseline(x).squeeze(-1)), \
            core_state
