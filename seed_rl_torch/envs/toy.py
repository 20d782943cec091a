"""Toy tensor environments for algorithm sanity tests.

Port of ``seed_rl_tpu/envs/toy.py``:
- ``ToyEnv``: observe a random target vector; the reward is the negative
  squared distance between the action and the *previous* observation's
  target.
- ``ToyMemoryEnv``: targets are visible only for the first ``horizon``
  steps and must be reproduced from memory afterwards.
- ``DiscreteMatchEnv``: observe a one-hot target action, be rewarded 1 for
  playing it (the R2D2 test env).
- ``BitFlippingEnv``: goal-conditioned bit flipping (the HER test bed,
  arXiv:1707.01495) with dict observations ``{achieved_goal, desired_goal,
  observation}``.

The dynamics match the JAX package given the same targets; the random
streams differ (``torch.Generator`` vs ``jax.random``).
"""

from typing import NamedTuple

import torch

from seed_rl_torch.envs.core import StepResult, TensorEnv, TensorSpec
from seed_rl_torch.envs.spaces import Box, Discrete


def _one_hot(index, n):
    """f32 one-hot rows of ``index`` (int[B]); an index >= n gives zeros."""
    return (index[:, None].long()
            == torch.arange(n, device=index.device)).to(torch.float32)


def _uniform(shape, generator):
    """U[-1, 1) draws on the generator's device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * 2.0 - 1.0


def _with_zero_column(x):
    return torch.cat([x, torch.zeros_like(x[:, :1])], dim=-1)


class _ToyState(NamedTuple):
    t: torch.Tensor  # i32[B]
    target: torch.Tensor  # f32[B, n_actions]: what the action should match


class ToyEnv(TensorEnv):
    """Match the observed random vector with your action."""

    def __init__(self, horizon: int = 3, n_actions: int = 3):
        self.horizon = horizon
        self.n_actions = n_actions
        self._action_space = Box(-1.0, 1.0, (n_actions,))

    def observation_spec(self):
        return TensorSpec((self.n_actions + 1,), torch.float32)

    @property
    def action_space(self):
        return self._action_space

    def reset(self, num_envs, generator):
        target = _uniform((num_envs, self.n_actions), generator)
        t = torch.zeros(num_envs, dtype=torch.int32, device=target.device)
        return _ToyState(t=t, target=target), _with_zero_column(target)

    def step(self, state, action, generator):
        reward = -torch.sum(torch.square(action - state.target), dim=-1)
        target = _uniform(state.target.shape, generator)
        t = state.t + 1
        return StepResult(
            state=_ToyState(t=t, target=target),
            observation=_with_zero_column(target),
            reward=reward,
            terminated=t >= self.horizon,
            abandoned=torch.zeros_like(t, dtype=torch.bool),
        )


class _ToyMemoryState(NamedTuple):
    t: torch.Tensor  # i32[B]
    memory: torch.Tensor  # f32[B, horizon, n_actions] targets drawn at reset


class ToyMemoryEnv(TensorEnv):
    """Reproduce targets observed ``horizon`` steps ago (recurrence test)."""

    def __init__(self, horizon: int = 3, n_actions: int = 3):
        self.horizon = horizon
        self.n_actions = n_actions
        self._action_space = Box(-1.0, 1.0, (n_actions,))

    def observation_spec(self):
        return TensorSpec((self.n_actions + 1,), torch.float32)

    @property
    def action_space(self):
        return self._action_space

    def _memory_at(self, memory, idx):
        rows = torch.arange(memory.shape[0], device=memory.device)
        return memory[rows, idx.long()]

    def _obs(self, state):
        visible = state.t < self.horizon
        idx = torch.clamp(state.t, max=self.horizon - 1)
        mem = self._memory_at(state.memory, idx)
        mem = torch.where(visible[:, None], mem, torch.zeros_like(mem))
        return _with_zero_column(mem)

    def reset(self, num_envs, generator):
        memory = _uniform((num_envs, self.horizon, self.n_actions), generator)
        t = torch.zeros(num_envs, dtype=torch.int32, device=memory.device)
        state = _ToyMemoryState(t=t, memory=memory)
        return state, self._obs(state)

    def step(self, state, action, generator):
        t = state.t
        # Recall phase: reward for matching the target seen `horizon` ago.
        recall_idx = torch.clamp(t - self.horizon, 0, self.horizon - 1)
        recall_reward = -torch.sum(
            torch.square(action - self._memory_at(state.memory, recall_idx)),
            dim=-1,
        )
        zero = torch.zeros_like(recall_reward)
        reward = torch.where(t < self.horizon, zero, recall_reward)
        terminated = t >= 2 * self.horizon
        reward = torch.where(terminated, zero, reward)
        new_state = _ToyMemoryState(t=t + 1, memory=state.memory)
        return StepResult(
            state=new_state,
            observation=self._obs(new_state),
            reward=reward,
            terminated=terminated,
            abandoned=torch.zeros_like(terminated),
        )


class _MatchState(NamedTuple):
    t: torch.Tensor  # i32[B]
    target: torch.Tensor  # i64[B] current target action


class DiscreteMatchEnv(TensorEnv):
    """Observe a one-hot target, be rewarded for playing it (DQN test env)."""

    def __init__(self, n_actions: int = 4, horizon: int = 10):
        self.n_actions = n_actions
        self.horizon = horizon
        self._action_space = Discrete(n_actions)

    def observation_spec(self):
        return TensorSpec((self.n_actions,), torch.float32)

    @property
    def action_space(self):
        return self._action_space

    def _draw_target(self, num_envs, generator):
        return torch.randint(0, self.n_actions, (num_envs,),
                             generator=generator, device=generator.device)

    def _obs(self, target):
        return torch.nn.functional.one_hot(target, self.n_actions).to(
            torch.float32)

    def reset(self, num_envs, generator):
        target = self._draw_target(num_envs, generator)
        t = torch.zeros(num_envs, dtype=torch.int32, device=target.device)
        return _MatchState(t=t, target=target), self._obs(target)

    def step(self, state, action, generator):
        reward = (action == state.target).to(torch.float32)
        target = self._draw_target(state.target.shape[0], generator)
        t = state.t + 1
        terminated = t >= self.horizon
        return StepResult(
            state=_MatchState(t=t, target=target),
            observation=self._obs(target),
            reward=reward,
            terminated=terminated,
            abandoned=torch.zeros_like(terminated),
        )


class _BitFlippingState(NamedTuple):
    bits: torch.Tensor  # f32[B, n_bits]
    goal: torch.Tensor  # f32[B, n_bits]
    t: torch.Tensor  # i32[B]


class BitFlippingEnv(TensorEnv):
    """Goal-conditioned bit flipping; dict observations for HER.

    Action ``i < n_bits`` flips bit i, action ``n_bits`` is a no-op. The
    bits and the goal of a fresh episode are fair coin flips drawn from the
    ``BatchedEnv`` generator.
    """

    def __init__(self, n_bits: int = 10, horizon: int = 20):
        self.n_bits = n_bits
        self.horizon = horizon
        self._action_space = Discrete(n_bits + 1)

    def observation_spec(self):
        return {
            "achieved_goal": TensorSpec((self.n_bits,), torch.float32),
            "desired_goal": TensorSpec((self.n_bits,), torch.float32),
            "observation": TensorSpec((self.horizon + 1,), torch.float32),
        }

    @property
    def action_space(self):
        return self._action_space

    def _obs(self, state):
        return {
            "achieved_goal": state.bits,
            "desired_goal": state.goal,
            "observation": _one_hot(state.t, self.horizon + 1),
        }

    @staticmethod
    def compute_reward(achieved_goal, desired_goal):
        """clip(-#mismatched bits, -1, 0); HER relabels with it too."""
        mismatches = torch.sum((achieved_goal != desired_goal).to(
            torch.float32), dim=-1)
        return torch.clamp(-mismatches, -1.0, 0.0)

    def _coin_flips(self, num_envs, generator):
        return (torch.rand((num_envs, self.n_bits), generator=generator,
                           device=generator.device) < 0.5).to(torch.float32)

    def reset(self, num_envs, generator):
        bits = self._coin_flips(num_envs, generator)
        goal = self._coin_flips(num_envs, generator)
        t = torch.zeros(num_envs, dtype=torch.int32, device=bits.device)
        state = _BitFlippingState(bits=bits, goal=goal, t=t)
        return state, self._obs(state)

    def step(self, state, action, generator):
        flip = _one_hot(action, self.n_bits)  # zeros for the no-op
        bits = torch.abs(state.bits - flip)
        t = state.t + 1
        new_state = _BitFlippingState(bits=bits, goal=state.goal, t=t)
        terminated = t >= self.horizon
        return StepResult(
            state=new_state,
            observation=self._obs(new_state),
            reward=self.compute_reward(bits, state.goal),
            terminated=terminated,
            abandoned=torch.zeros_like(terminated),
        )
