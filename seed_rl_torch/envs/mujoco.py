"""MuJoCo / gym environment factory.

Port of ``seed_rl_tpu/envs/mujoco.py``: a gymnasium env, its observations
cast to float32 (``SinglePrecisionWrapper``), ``Box`` actions rescaled to
[-1, 1] (``UniformBoundActionSpaceWrapper``) and optionally discretized
(lin / log). Only ``create_environment`` imports gymnasium, inside the
function.
"""

from typing import Optional

import numpy as np

from seed_rl_torch.envs.host import (
    DiscretizeEnvWrapper,
    UniformBoundActionSpaceWrapper,
    Wrapper,
)
from seed_rl_torch.envs.spaces import Box


def _is_box(space) -> bool:
    return hasattr(space, "low") and hasattr(space, "high")


class SinglePrecisionWrapper(Wrapper):
    """Casts observations to float32."""

    def __init__(self, env):
        super().__init__(env)
        space = env.observation_space
        if _is_box(space):
            self.observation_space = Box(space.low.astype(np.float32),
                                         space.high.astype(np.float32))

    def observation(self, observation):
        return np.asarray(observation, np.float32)

    def reset(self, *, seed: Optional[int] = None, options=None):
        observation, info = self.env.reset(seed=seed, options=options)
        return self.observation(observation), info

    def step(self, action):
        observation, reward, terminated, truncated, info = self.env.step(
            action)
        return (self.observation(observation), reward, terminated, truncated,
                info)


def create_environment(
    env_name: str = "HalfCheetah-v5",
    discretization: str = "none",
    n_actions_per_dim: int = 11,
    action_ratio: Optional[float] = 30.0,
    seed: Optional[int] = None,
):
    """A MuJoCo / gym env with the reference's wrapper stack."""
    import gymnasium as gym

    env = SinglePrecisionWrapper(gym.make(env_name))
    if _is_box(env.action_space):
        env = UniformBoundActionSpaceWrapper(env)
        if discretization != "none":
            env = DiscretizeEnvWrapper(env, n_actions_per_dim, discretization,
                                       action_ratio)
    if seed is not None:
        env.reset(seed=seed)
    return env
