"""Tensor-environment protocol and auto-resetting batching on one device.

Port of ``seed_rl_tpu/envs/core.py``. The JAX package writes one env as
pure functions and batches it with ``vmap``; here a ``TensorEnv`` works on
a leading batch axis itself, with its state a tuple of ``[B, ...]`` tensors
on the device and its randomness drawn from a ``torch.Generator`` the
caller passes in.

The per-transition contract is unchanged:
``EnvOutput = (reward, done, observation, abandoned, episode_step)`` with
``observation`` post-transition, and post-reset when ``done``: auto-reset
happens inside ``BatchedEnv.step``, so downstream code never sees a
terminal observation.
"""

import abc
from typing import Any, NamedTuple, Tuple

import torch
import torch.utils._pytree as pytree

from seed_rl_torch.device import resolve_device
from seed_rl_torch.types import EnvOutput


class TensorSpec(NamedTuple):
    """Shape and dtype of one (un-batched) tensor."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


class StepResult(NamedTuple):
    state: Any
    observation: Any
    reward: torch.Tensor
    terminated: torch.Tensor  # bool: proper episode termination
    abandoned: torch.Tensor  # bool: episode cut short (e.g. time limit)


class TensorEnv(abc.ABC):
    """A batch of environments stepped together as tensors.

    State is a tuple of ``[B, ...]`` tensors. Tensors are made on the
    generator's device.
    """

    @abc.abstractmethod
    def observation_spec(self) -> TensorSpec:
        """Spec of a single observation."""

    @property
    @abc.abstractmethod
    def action_space(self):
        """A space (``seed_rl_torch.envs.spaces``) of a single action."""

    @abc.abstractmethod
    def reset(
        self, num_envs: int, generator: torch.Generator
    ) -> Tuple[Any, Any]:
        """Returns (state, observation) for ``num_envs`` fresh episodes."""

    @abc.abstractmethod
    def step(
        self, state, action, generator: torch.Generator
    ) -> StepResult:
        """Advances every env one step. Must NOT auto-reset (the wrapper does)."""


class TimeLimit(TensorEnv):
    """Abandons (not terminates) episodes after ``max_episode_steps``.

    Hitting the limit sets ``abandoned`` so abandoned-aware estimators can
    bootstrap instead of treating it as a terminal state.
    """

    def __init__(self, env: TensorEnv, max_episode_steps: int):
        self._env = env
        self._limit = max_episode_steps

    def observation_spec(self):
        return self._env.observation_spec()

    @property
    def action_space(self):
        return self._env.action_space

    def reset(self, num_envs, generator):
        state, obs = self._env.reset(num_envs, generator)
        t = torch.zeros(num_envs, dtype=torch.int32, device=generator.device)
        return (state, t), obs

    def step(self, state, action, generator):
        inner_state, t = state
        result = self._env.step(inner_state, action, generator)
        t = t + 1
        abandoned = (t >= self._limit) & ~result.terminated
        return StepResult(
            state=(result.state, t),
            observation=result.observation,
            reward=result.reward,
            terminated=result.terminated,
            abandoned=result.abandoned | abandoned,
        )


class BatchedEnvState(NamedTuple):
    env_state: Any  # [B, ...] env state tensors
    episode_step: torch.Tensor  # i32[B]


def _tree_where(pred, on_true, on_false):
    """Select whole sub-trees per batch element (pred is [B])."""

    def sel(a, b):
        p = pred.reshape(pred.shape + (1,) * (a.dim() - pred.dim()))
        return torch.where(p, a, b)

    return pytree.tree_map(sel, on_true, on_false)


class BatchedEnv:
    """Runs a ``TensorEnv`` over ``num_envs`` envs with auto-reset.

    Owns the device and the generator every reset and step draws from.
    """

    def __init__(self, env: TensorEnv, num_envs: int, device=None,
                 seed: int = 0):
        self.env = env
        self.num_envs = num_envs
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def observation_spec(self):
        return self.env.observation_spec()

    @property
    def action_space(self):
        return self.env.action_space

    def reset(self) -> Tuple[BatchedEnvState, EnvOutput]:
        states, obs = self.env.reset(self.num_envs, self.generator)
        zeros = dict(size=(self.num_envs,), device=self.device)
        env_output = EnvOutput(
            reward=torch.zeros(**zeros, dtype=torch.float32),
            done=torch.zeros(**zeros, dtype=torch.bool),
            observation=obs,
            abandoned=torch.zeros(**zeros, dtype=torch.bool),
            episode_step=torch.zeros(**zeros, dtype=torch.int32),
        )
        return BatchedEnvState(
            env_state=states,
            episode_step=torch.zeros(**zeros, dtype=torch.int32),
        ), env_output

    def step(
        self, state: BatchedEnvState, action
    ) -> Tuple[BatchedEnvState, EnvOutput]:
        result = self.env.step(state.env_state, action, self.generator)
        done = result.terminated | result.abandoned
        episode_step = state.episode_step + 1

        # Auto-reset: draw fresh states for every env and select where done,
        # which keeps the step free of data-dependent shapes and host syncs.
        reset_states, reset_obs = self.env.reset(
            self.num_envs, self.generator
        )
        new_env_state = _tree_where(done, reset_states, result.state)
        observation = _tree_where(done, reset_obs, result.observation)

        env_output = EnvOutput(
            reward=result.reward.to(torch.float32),
            done=done,
            observation=observation,
            # The step count reported on the done transition is the
            # completed episode's length.
            episode_step=episode_step,
            abandoned=result.abandoned,
        )
        return BatchedEnvState(
            env_state=new_env_state,
            episode_step=torch.where(
                done, torch.zeros_like(episode_step), episode_step
            ),
        ), env_output
