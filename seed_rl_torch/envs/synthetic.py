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

- ``SyntheticFootballEnv``: bit-packed uint16 ``[72, 96, 1]`` frames (the
  Football wire format, ``envs/football.py``), 19 actions, the frame
  ``(row + t + seed) % 65535``, episodes of 500 steps.

``SyntheticAtariGymEnv`` is the host-process twin of ``SyntheticAtariEnv``
with gymnasium's API, a plain numpy class (``envs/host.py`` batches it): the
same frames and rewards as the JAX package's for the same seed, byte for
byte, so the host data paths run end to end without an emulator.
"""

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from seed_rl_torch.envs.core import StepResult, TensorEnv, TensorSpec
from seed_rl_torch.envs.spaces import Box, Discrete


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


class SyntheticFootballEnv(SyntheticAtariEnv):
    """SMM-shaped bit-packed frames: ``[72, 96, 1]`` uint16, 19 actions.
    ``GFootball`` unpacks the planes on the device, so a rollout over these
    frames runs the unpack and the 4-stack resnet."""

    def __init__(self, num_actions: int = 19, episode_length: int = 500):
        super().__init__(num_actions, (72, 96), episode_length)

    def observation_spec(self):
        return TensorSpec(self.frame_shape + (1,), torch.uint16)

    def _obs(self, state):
        h, w = self.frame_shape
        row = torch.arange(h, dtype=torch.int32, device=state.t.device)
        frames = (row[None, :, None, None]
                  + (state.t + state.seed)[:, None, None, None]) % 65535
        return frames.expand(-1, -1, w, -1).to(torch.uint16).contiguous()


class SyntheticAtariGymEnv:
    """Host-process twin of ``SyntheticAtariEnv`` (gymnasium's API).

    Atari-shaped uint8 frames; reward 1 for picking the episode's hidden
    action (encoded in the frame bytes). Cheap enough that host-pipeline
    measurements measure the framework, not an emulator.
    """

    def __init__(
        self,
        num_actions: int = 18,
        frame_shape: Tuple[int, int] = (84, 84),
        episode_length: int = 1000,
    ):
        self.num_actions = num_actions
        self.frame_shape = tuple(frame_shape)
        self.episode_length = episode_length
        self.action_space = Discrete(num_actions)
        h, w = frame_shape
        self.observation_space = Box(0, 255, (h, w, 1), np.uint8)
        self._rng = np.random.default_rng(0)
        self._t = 0
        self._seed_val = 0
        self._row = np.broadcast_to(
            np.arange(h, dtype=np.int32).reshape(h, 1, 1), (h, w, 1))

    def _obs(self):
        return ((self._row + self._t + self._seed_val) % 255).astype(
            np.uint8)

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._seed_val = int(self._rng.integers(0, 255))
        self._t = 0
        return self._obs(), {}

    def step(self, action):
        self._t += 1
        reward = float(int(action) == self._seed_val % self.num_actions)
        terminated = self._t >= self.episode_length
        return self._obs(), reward, terminated, False, {}

    def close(self):
        pass
