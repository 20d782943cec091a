"""Google Research Football adapter and the bit-packed observation codec.

Port of ``seed_rl_tpu/envs/football.py``:
- ``PackedBitsObservation``: boolean SMM planes packed to uint16 on the
  host (8-16x less to copy to the device);
- ``unpackbits``: the inverse on torch tensors, back to {0, 255} float
  planes, with the same bit order (most significant bit first within each
  uint16's low, then high byte);
- ``create_environment``: the SMM env, which needs the ``gfootball``
  package (imported inside the function).
"""

import numpy as np
import torch

from seed_rl_torch.envs.host import Wrapper
from seed_rl_torch.envs.spaces import Box

_BIT_PATTERNS = (
    2**7, 2**6, 2**5, 2**4, 2**3, 2**2, 2**1, 2**0,
    2**15, 2**14, 2**13, 2**12, 2**11, 2**10, 2**9, 2**8,
)


class PackedBitsObservation(Wrapper):
    """Packs boolean observation planes into uint16 along the last axis."""

    def __init__(self, env):
        super().__init__(env)
        shape = env.observation_space.shape
        self.observation_space = Box(
            0, np.iinfo(np.uint16).max,
            shape[:-1] + ((shape[-1] + 15) // 16,), np.uint16)

    def observation(self, observation):
        data = np.packbits(observation, axis=-1)  # packs to uint8
        if data.shape[-1] % 2 == 1:
            data = np.pad(
                data, [(0, 0)] * (data.ndim - 1) + [(0, 1)], "constant")
        return data.view(np.uint16)

    def reset(self, *, seed=None, options=None):
        observation, info = self.env.reset(seed=seed, options=options)
        return self.observation(observation), info

    def step(self, action):
        observation, reward, terminated, truncated, info = self.env.step(
            action)
        return (self.observation(observation), reward, terminated, truncated,
                info)


def unpackbits(frame: torch.Tensor) -> torch.Tensor:
    """The inverse of ``PackedBitsObservation``: uint16 ``[..., C]`` ->
    f32 ``[..., 16 C]`` planes of 0 and 255."""
    patterns = torch.tensor(_BIT_PATTERNS, dtype=torch.int32,
                            device=frame.device)
    bits = torch.bitwise_and(frame.to(torch.int32)[..., None], patterns)
    planes = (bits != 0).to(torch.float32) * 255.0
    return planes.reshape(planes.shape[:-2]
                          + (planes.shape[-2] * planes.shape[-1],))


def create_environment(
    level: str = "academy_empty_goal_close",
    representation: str = "extracted",
    rewards: str = "scoring",
    pack_bits: bool = True,
):
    """GFootball SMM env; requires the ``gfootball`` package."""
    try:
        import gfootball.env as football_env
    except ImportError as e:
        raise ImportError(
            "Football environments need the gfootball package; the "
            "PackedBitsObservation codec and GFootball network are testable "
            "without it."
        ) from e
    env = football_env.create_environment(
        env_name=level,
        representation=representation,
        rewards=rewards,
        stacked=True,
    )
    if pack_bits:
        env = PackedBitsObservation(env)
    return env
