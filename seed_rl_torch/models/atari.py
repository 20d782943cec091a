"""Atari network family: conv torso, frame stacking, policy and Q nets.

Port of ``seed_rl_tpu/models/atari.py``:
- ``AtariConvTorso``: 32x8s4 / 64x4s2 / 64x3s1 VALID convs + Dense 512 over
  frames scaled to [0, 1] in f32;
- ``stack_frame`` / ``stack_frames_time_major``: the last ``stack_size``
  frames with the history zeroed across episode boundaries;
- ``AgentState`` = (LSTM core state, frame-stacking history);
- ``AtariPolicyNet``: torso, optional done-resetting LSTM, policy-logits and
  baseline heads (V-trace, PPO);
- ``DuelingLSTMDQNNet``: torso, then ``[conv features, reward,
  one_hot(prev_action)]`` into a done-resetting LSTM(512), then dueling
  heads with hidden 512, a bias-free advantage head and mean-centred
  advantages, and the greedy action (R2D2).

Observations stay NHWC uint8, as envs emit them. The torso reads them as
an NCHW view of NHWC memory, i.e. PyTorch's ``channels_last`` format, so
the convs run channels_last without a copy and their output is NHWC in
memory. The JAX package flattens the conv output in (H, W, C) order before
the Dense layer; flattening the channels_last output in that order is a
view, so the Dense weight is flax's kernel transposed, with no permutation
in the converter and no transpose in the step.

Compute dtypes are the JAX package's: ``dtype`` is the torso's (its convs
and Dense cast their input, kernel and bias to it, see ``models/core.py``;
the frames are cast, then scaled by 1/255; the torso returns f32),
``core_dtype`` the LSTM gates' (the carry and the core's output stay f32);
the heads compute in f32.

Like the JAX package's time-major path, ``unroll`` folds the torso and the
heads over T*B and steps only the LSTM cell over time; it computes what
stepping ``forward`` computes. Parameters are drawn on the CPU from a
generator seeded with ``seed`` and then moved, as in ``models/policy.py``.
"""

from typing import Any, NamedTuple, Tuple

import torch
import torch.nn as nn

from seed_rl_torch.device import resolve_device
from seed_rl_torch.models.core import (
    LSTMStack,
    conv,
    conv_apply,
    dense,
    dense_apply,
    lstm_initial_state,
    reset_state_where_done,
)
from seed_rl_torch.models.dueling_mlp import DuelingQHeads
from seed_rl_torch.models.policy import _generator
from seed_rl_torch.utils.profiling import span

# (features, kernel, stride) of the Nature-DQN conv stack, VALID padding.
_CONV_STACK = ((32, 8, 4), (64, 4, 2), (64, 3, 1))


def nchw_frames(frames: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 ``[N, H, W, C]`` frames as ``dtype`` ``[N, C, H, W]`` in [0, 1]
    (cast, then divided by 255 in ``dtype``), laid out channels_last (the
    NHWC memory, viewed NCHW)."""
    return frames.permute(0, 3, 1, 2).to(dtype) / 255.0


def flatten_hwc(x: torch.Tensor) -> torch.Tensor:
    """``[N, C, H, W]`` features flattened in the JAX package's (H, W, C)
    order; a view when ``x`` is channels_last."""
    return x.permute(0, 2, 3, 1).flatten(1)


class AtariConvTorso(nn.Module):
    """Nature-DQN conv stack + Dense(512), computing in ``dtype``. Input:
    uint8 ``[N, H, W, C]``; output f32."""

    def __init__(self, in_channels: int, frame_shape: Tuple[int, int],
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        layers = []
        h, w = frame_shape
        for features, kernel, stride in _CONV_STACK:
            layers.append(conv(in_channels, features, kernel, stride, 0,
                               generator))
            in_channels = features
            h, w = (h - kernel) // stride + 1, (w - kernel) // stride + 1
        if h < 1 or w < 1:
            raise ValueError(f"frames {frame_shape} are too small for the "
                             "Nature-DQN conv stack")
        self.convs = nn.ModuleList(layers)
        self.dense = dense(in_channels * h * w, 512, generator)

    def forward(self, frames):
        with span("torso"):
            x = nchw_frames(frames, self.dtype)
            for layer in self.convs:
                x = torch.relu(conv_apply(layer, x, self.dtype))
            x = torch.relu(dense_apply(self.dense, flatten_hwc(x),
                                       self.dtype))
            return x.to(torch.float32)


def initial_frame_stacking_state(
    stack_size: int, batch_size: int, frame_shape: Tuple[int, int],
    device=None,
):
    """Zero uint8 history of the last stack_size-1 frames."""
    if stack_size == 1:
        return ()
    h, w = frame_shape
    return torch.zeros((batch_size, h, w, stack_size - 1), dtype=torch.uint8,
                       device=device)


def stack_frame(observation, frame_state, done, stack_size: int):
    """Single-step frame stacking with done-masked history reset.

    Args:
      observation: uint8[B, H, W, 1] current frame.
      frame_state: uint8[B, H, W, stack_size-1] previous frames
        (oldest..newest) or () when stack_size == 1.
      done: bool[B].
      stack_size: number of frames in the stack.

    Returns:
      (stacked uint8[B, H, W, stack_size] oldest..newest, new frame_state).
    """
    if stack_size == 1:
        return observation, ()
    frame_state = reset_state_where_done(
        done, frame_state, torch.zeros_like(frame_state))
    stacked = torch.cat([frame_state, observation], dim=-1)
    return stacked, stacked[..., 1:]


def stack_frames_time_major(observation, frame_state, done, stack_size: int):
    """Frame stacking over a [T, B, H, W, 1] unroll, with no loop over time.

    Channel ``j`` (oldest..newest) of ``stacked[t]`` is ``obs[t - a]`` with
    age ``a = stack_size-1-j``, zeroed if an episode boundary occurred in
    steps ``t-a+1 .. t``: what stepping ``stack_frame`` over time gives.
    Frames older than the unroll come from ``frame_state`` and are also
    zeroed by any done in ``0 .. t``. Each channel is a shifted slice of one
    time-padded frame buffer, masked by comparing cumulative done counts.

    Returns (stacked uint8[T, B, H, W, stack_size], final frame_state).
    """
    if stack_size == 1:
        return observation, ()
    t_len, s = observation.shape[0], stack_size
    # History frames as pseudo-observations at t = -(s-1) .. -1.
    hist = frame_state.permute(3, 0, 1, 2).unsqueeze(-1)
    frames = torch.cat([hist, observation], dim=0)  # [T+s-1, B, ...]
    cum = torch.cumsum(done.to(torch.int32), dim=0)  # [T, B]
    # cum_pad[s-1 + t] = cum[t]; indices < s-1 (t < 0) read 0.
    cum_pad = torch.cat([torch.zeros_like(cum[:1]).expand(s - 1, -1), cum])
    parts = []
    for j in range(s):
        sl = frames[j:j + t_len]
        if j == s - 1:  # age 0: the current frame
            parts.append(sl)
            continue
        # Survives iff no done in (t-age, t]: cum[t] - cum[t-age] == 0.
        alive = cum_pad[s - 1:] == cum_pad[j:j + t_len]
        parts.append(sl * alive[..., None, None, None].to(sl.dtype))
    stacked = torch.cat(parts, dim=-1)
    return stacked, stacked[-1][..., 1:]


class AgentState(NamedTuple):
    """Atari agent state: recurrent core + frame-stacking history."""

    core_state: Any
    frame_stacking_state: Any


class AtariPolicyNet(nn.Module):
    """Conv (+ optional LSTM) policy/value net for Atari V-trace.

    ``forward(prev_action, env_output, agent_state)`` on ``[B]`` inputs and
    ``unroll`` on time-major ``[T, B]`` inputs return
    ``((policy_params, baseline), AgentState)``. Frames are 1-channel, so
    the torso sees ``stack_size`` channels.
    """

    def __init__(
        self,
        parametric_distribution_param_size: int,
        frame_shape: Tuple[int, int] = (84, 84),
        stack_size: int = 4,
        lstm_size: int = 0,  # 0 = feed-forward
        dtype: torch.dtype = torch.float32,
        core_dtype: torch.dtype = torch.float32,
        seed: int = 0,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        generator = _generator(seed)
        self.frame_shape = tuple(frame_shape)
        self.stack_size = stack_size
        self.lstm_size = lstm_size
        self.torso = AtariConvTorso(stack_size, frame_shape, generator,
                                    dtype)
        if lstm_size:
            self.core = LSTMStack(512, (lstm_size,), generator, core_dtype)
        head_size = lstm_size or 512
        self.policy_logits = dense(
            head_size, parametric_distribution_param_size, generator)
        self.baseline = dense(head_size, 1, generator)
        self.to(device)

    @property
    def stateless(self) -> bool:
        # Frame stacking is stateful, so only stack_size == 1 and no LSTM is
        # truly stateless.
        return self.lstm_size == 0 and self.stack_size == 1

    def initial_state(self, batch_size: int) -> AgentState:
        device = self.baseline.weight.device
        core = (lstm_initial_state((self.lstm_size,), batch_size, device)
                if self.lstm_size else ())
        return AgentState(
            core_state=core,
            frame_stacking_state=initial_frame_stacking_state(
                self.stack_size, batch_size, self.frame_shape, device),
        )

    def _heads(self, x):
        return self.policy_logits(x), self.baseline(x).squeeze(-1)

    def forward(self, prev_action, env_output, agent_state):
        del prev_action
        done = env_output.done
        frame_state = (agent_state.frame_stacking_state
                       if self.stack_size > 1 else ())
        stacked, frame_state = stack_frame(
            env_output.observation, frame_state, done, self.stack_size)
        x = self.torso(stacked)
        core = ()
        if self.lstm_size:
            x, core = self.core(x, agent_state.core_state, done)
        return self._heads(x), AgentState(core, frame_state)

    def unroll(self, prev_actions, env_outputs, agent_state):
        """[T, B] training path: folded torso/heads, the LSTM stepped."""
        del prev_actions
        done = env_outputs.done
        stacked, frame_state = stack_frames_time_major(
            env_outputs.observation, agent_state.frame_stacking_state, done,
            self.stack_size)
        t, b = stacked.shape[:2]
        x = self.torso(stacked.reshape((t * b,) + stacked.shape[2:]))
        x = x.reshape(t, b, -1)
        core = ()
        if self.lstm_size:
            core, outputs = agent_state.core_state, []
            for step in range(t):
                out, core = self.core(x[step], core, done[step])
                outputs.append(out)
            x = torch.stack(outputs)
        return self._heads(x), AgentState(core, frame_state)


class DuelingLSTMDQNNet(DuelingQHeads, nn.Module):
    """Dueling LSTM DQN from frames (R2D2).

    ``forward(prev_action, env_output, agent_state)`` on ``[B]`` inputs and
    ``unroll`` on time-major ``[T, B]`` inputs return
    ``(QAgentOutput(action, q_values), AgentState)``. Epsilon-greedy
    exploration is the R2D2 agent's (``agents/r2d2.py::R2D2Agent``).
    """

    stateless = False

    def __init__(
        self,
        num_actions: int,
        frame_shape: Tuple[int, int] = (84, 84),
        stack_size: int = 4,
        lstm_size: int = 512,
        dtype: torch.dtype = torch.float32,
        core_dtype: torch.dtype = torch.float32,
        seed: int = 0,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        generator = _generator(seed)
        self.frame_shape = tuple(frame_shape)
        self.stack_size = stack_size
        self.lstm_size = lstm_size
        self.torso = AtariConvTorso(stack_size, frame_shape, generator,
                                    dtype)
        self.core = LSTMStack(512 + 1 + num_actions, (lstm_size,), generator,
                              core_dtype)
        self._init_heads(lstm_size, 512, num_actions, generator)
        self.to(device)

    def initial_state(self, batch_size: int) -> AgentState:
        device = self.value_head.weight.device
        return AgentState(
            core_state=lstm_initial_state((self.lstm_size,), batch_size,
                                          device),
            frame_stacking_state=initial_frame_stacking_state(
                self.stack_size, batch_size, self.frame_shape, device),
        )

    def forward(self, prev_action, env_output, agent_state):
        done = env_output.done
        stacked, frame_state = stack_frame(
            env_output.observation, agent_state.frame_stacking_state, done,
            self.stack_size)
        x = self._core_inputs(self.torso(stacked), prev_action,
                              env_output.reward)
        x, core = self.core(x, agent_state.core_state, done)
        return self._heads(x), AgentState(core, frame_state)

    def unroll(self, prev_actions, env_outputs, agent_state):
        """[T, B] training path: folded torso/heads, the LSTM stepped."""
        done = env_outputs.done
        stacked, frame_state = stack_frames_time_major(
            env_outputs.observation, agent_state.frame_stacking_state, done,
            self.stack_size)
        t, b = stacked.shape[:2]
        conv_out = self.torso(stacked.reshape((t * b,) + stacked.shape[2:]))
        x = self._core_inputs(conv_out.reshape(t, b, -1), prev_actions,
                              env_outputs.reward)
        core, outputs = agent_state.core_state, []
        for step in range(t):
            out, core = self.core(x[step], core, done[step])
            outputs.append(out)
        return self._heads(torch.stack(outputs)), AgentState(core, frame_state)
