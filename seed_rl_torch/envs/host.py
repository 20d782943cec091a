"""Host-process environments: action wrappers and the batched host env.

Port of ``seed_rl_tpu/envs/host.py``, for envs that step in the host
process (MuJoCo, ALE, DmLab, Football and their numpy stand-ins):
- ``UniformBoundActionSpaceWrapper``: rescales a ``Box`` action space to
  [-1, 1];
- ``DiscretizeEnvWrapper``: lin or log buckets of each continuous action
  dimension, as a ``MultiDiscrete`` space;
- ``HostBatchedEnv``: N envs stepped on the host (optionally on a thread
  pool: MuJoCo and ALE release the GIL) with auto-reset and the
  ``EnvOutput`` transition contract: the post-transition observation, the
  post-reset one when ``done``, ``abandoned`` = gymnasium's ``truncated``,
  ``episode_step`` zeroed after a done.

Every class here works over any object with gymnasium's API (``reset(seed=)``
returning ``(obs, info)``, ``step`` returning the 5-tuple) and imports no
gymnasium: the wrappers are plain classes that forward what they do not
change, and the spaces they make are the port's own (``envs/spaces.py``).
Outputs stay numpy; ``rollout_host.HostRolloutEngine`` moves them to the
device.
"""

import concurrent.futures
from typing import Any, Callable, Optional

import numpy as np
import torch

from seed_rl_torch.envs.core import TensorSpec
from seed_rl_torch.envs.spaces import Box, MultiDiscrete
from seed_rl_torch.types import EnvOutput


class Wrapper:
    """Forwards the gymnasium API to ``env``; subclasses override parts."""

    def __init__(self, env):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space

    @property
    def unwrapped(self):
        return getattr(self.env, "unwrapped", self.env)

    def reset(self, *, seed: Optional[int] = None, options=None):
        return self.env.reset(seed=seed, options=options)

    def step(self, action):
        return self.env.step(action)

    def close(self):
        return self.env.close()


class UniformBoundActionSpaceWrapper(Wrapper):
    """Rescale actions so that action space bounds are [-1, 1]."""

    def __init__(self, env):
        super().__init__(env)
        space = env.action_space
        if not (hasattr(space, "low") and hasattr(space, "high")):
            raise ValueError(f"expected a Box action space, got {space}")
        n = space.shape[0]
        self.half_range = (space.high - space.low).astype(np.float32) / 2.0
        self.center = space.low.astype(np.float32) + self.half_range
        self.action_space = Box(-np.ones(n, np.float32),
                                np.ones(n, np.float32))

    def step(self, action):
        if np.abs(action).max() >= 1.00001:
            raise ValueError(f"action outside [-1, 1]: {action}")
        action = np.clip(action, -1.0, 1.0)
        return self.env.step(self.center + action * self.half_range)


class DiscretizeEnvWrapper(Wrapper):
    """Discretize continuous actions into n buckets per dimension."""

    def __init__(self, env, n_actions_per_dim, discretization="lin",
                 action_ratio=None):
        super().__init__(env)
        space = env.action_space
        if len(space.shape) != 1:
            raise ValueError(f"expected a 1-D Box action space, got {space}")
        self.action_space = MultiDiscrete([n_actions_per_dim] * space.shape[0])
        high = space.high
        high = high[0] if not np.isscalar(high) else high
        if not (np.all(space.high == high) and np.all(space.low == -high)):
            raise ValueError("discretization needs bounds [-h, h] alike in "
                             "every dimension")
        if discretization == "log":
            if n_actions_per_dim % 2 != 1:
                raise ValueError(
                    "log discretization needs an odd number of buckets")
            if action_ratio is None:
                raise ValueError("log discretization needs action_ratio")
            log_range = np.linspace(
                np.log(high / action_ratio), np.log(high),
                n_actions_per_dim // 2,
            )
            self.action_set = np.concatenate(
                [-np.exp(np.flip(log_range)), [0.0], np.exp(log_range)])
        elif discretization == "lin":
            self.action_set = np.linspace(-high, high, n_actions_per_dim)
        else:
            raise ValueError(discretization)

    def step(self, action):
        return self.env.step(np.take(self.action_set, action))


def _spec_of(x) -> TensorSpec:
    x = np.asarray(x)
    return TensorSpec(x.shape, torch.from_numpy(x[None][:0]).dtype)


class HostBatchedEnv:
    """N host envs with auto-reset, producing batched numpy ``EnvOutput``s.

    The per-env transition protocol is the reference actor loop's:
    ``reset`` returns the first observation with reward 0 / done False;
    each ``step`` returns post-transition values with the post-reset
    observation when done; ``abandoned`` is gymnasium's ``truncated``
    (a time limit), presented on the done transition. Dict observations
    are stacked per key.
    """

    def __init__(
        self,
        create_env_fn: Callable[[int], Any],
        num_envs: int,
        num_threads: Optional[int] = None,
    ):
        self.envs = [create_env_fn(i) for i in range(num_envs)]
        self.num_envs = num_envs
        self._pool = (concurrent.futures.ThreadPoolExecutor(num_threads)
                      if num_threads else None)
        self._episode_step = np.zeros(num_envs, np.int32)
        obs, _ = self.envs[0].reset(seed=0)
        self._obs_template = obs

    @property
    def action_space(self):
        return self.envs[0].action_space

    @property
    def observation_space(self):
        return self.envs[0].observation_space

    def observation_spec(self):
        """Shape and dtype of one observation (a ``TensorSpec``, or a dict
        of them for dict observations)."""
        if isinstance(self._obs_template, dict):
            return {k: _spec_of(v) for k, v in self._obs_template.items()}
        return _spec_of(self._obs_template)

    def _stack_obs(self, obs_list):
        if isinstance(obs_list[0], dict):
            return {k: np.stack([o[k] for o in obs_list])
                    for k in obs_list[0]}
        return np.stack(obs_list)

    def _map(self, fn):
        if self._pool is not None:
            return list(self._pool.map(fn, range(self.num_envs)))
        return [fn(i) for i in range(self.num_envs)]

    def reset(self, seed: int = 0) -> EnvOutput:
        """Resets env ``i`` with seed ``seed + i``."""
        def do_reset(i):
            obs, _ = self.envs[i].reset(seed=seed + i)
            return obs

        obs_list = self._map(do_reset)
        self._episode_step[:] = 0
        n = self.num_envs
        return EnvOutput(
            reward=np.zeros(n, np.float32),
            done=np.zeros(n, bool),
            observation=self._stack_obs(obs_list),
            abandoned=np.zeros(n, bool),
            episode_step=np.zeros(n, np.int32),
        )

    def step(self, actions: np.ndarray) -> EnvOutput:
        def do_step(i):
            obs, reward, terminated, truncated, _ = self.envs[i].step(
                actions[i])
            done = terminated or truncated
            if done:
                obs, _ = self.envs[i].reset()
            return obs, reward, done, truncated

        obs_list, rewards, dones, truncs = zip(*self._map(do_step))
        self._episode_step += 1
        episode_step = self._episode_step.copy()
        dones = np.asarray(dones, bool)
        self._episode_step[dones] = 0
        return EnvOutput(
            reward=np.asarray(rewards, np.float32),
            done=dones,
            observation=self._stack_obs(list(obs_list)),
            abandoned=np.asarray(truncs, bool),
            episode_step=episode_step,
        )

    def close(self):
        for env in self.envs:
            env.close()
        if self._pool is not None:
            self._pool.shutdown()
