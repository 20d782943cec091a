"""Synthetic on-device benchmark environments with Atari/DmLab-shaped frames.

Port of ``SyntheticAtariEnv`` and ``SyntheticDmLabEnv`` of
``seed_rl_tpu/envs/synthetic.py``. Frames cost next to nothing to make, so a
run measures the framework and the network rather than an emulator:
- ``SyntheticAtariEnv``: uint8 ``[84, 84, 1]`` frames, 18 actions;
- ``SyntheticDmLabEnv``: uint8 ``[72, 96, 3]`` frames, 9 actions.
Each episode draws a hidden ``seed`` in [0, 255); the frame at step t is
``(row + 37 * channel + t + seed) % 255`` (channel 0 only for Atari), and
the reward is 1 for playing action ``seed % num_actions``. Episodes
terminate after ``episode_length`` steps.

``SyntheticFootballEnv`` waits for the host-env slice (its net unpacks
bit planes) and ``SyntheticAtariGymEnv``, a host-process env, for host envs.
"""

from typing import NamedTuple, Tuple

import torch

from seed_rl_torch.envs.core import StepResult, TensorEnv, TensorSpec
from seed_rl_torch.envs.spaces import Discrete


class _SynthState(NamedTuple):
    t: torch.Tensor  # i32[B]
    seed: torch.Tensor  # i32[B]


class SyntheticAtariEnv(TensorEnv):
    """Cheap uint8-frame environment with Atari-like episode statistics."""

    channels = 1
    channel_stride = 0  # added per channel to the frame's byte pattern

    def __init__(
        self,
        num_actions: int = 18,
        frame_shape: Tuple[int, int] = (84, 84),
        episode_length: int = 1000,
    ):
        self.num_actions = num_actions
        self.frame_shape = tuple(frame_shape)
        self.episode_length = episode_length
        self._action_space = Discrete(num_actions)

    def observation_spec(self):
        return TensorSpec(self.frame_shape + (self.channels,), torch.uint8)

    @property
    def action_space(self):
        return self._action_space

    def _obs(self, state):
        h, w = self.frame_shape
        device = state.t.device
        row = torch.arange(h, dtype=torch.int32, device=device)
        chan = torch.arange(self.channels, dtype=torch.int32, device=device)
        pattern = row[:, None, None] + self.channel_stride * chan  # [H, 1, C]
        offset = (state.t + state.seed)[:, None, None, None]
        frames = ((pattern + offset) % 255).to(torch.uint8)  # [B, H, 1, C]
        return frames.expand(-1, -1, w, -1).contiguous()

    def reset(self, num_envs, generator):
        seed = torch.randint(0, 255, (num_envs,), generator=generator,
                             device=generator.device, dtype=torch.int32)
        state = _SynthState(t=torch.zeros_like(seed), seed=seed)
        return state, self._obs(state)

    def step(self, state, action, generator):
        del generator
        t = state.t + 1
        new_state = _SynthState(t=t, seed=state.seed)
        reward = (action == state.seed % self.num_actions).to(torch.float32)
        terminated = t >= self.episode_length
        return StepResult(
            state=new_state,
            observation=self._obs(new_state),
            reward=reward,
            terminated=terminated,
            abandoned=torch.zeros_like(terminated),
        )


class SyntheticDmLabEnv(SyntheticAtariEnv):
    """DmLab-shaped frames: 72x96 RGB uint8, a 9-action discrete set."""

    channels = 3
    channel_stride = 37

    def __init__(
        self,
        num_actions: int = 9,
        frame_shape: Tuple[int, int] = (72, 96),
        episode_length: int = 1000,
    ):
        super().__init__(num_actions, frame_shape, episode_length)
