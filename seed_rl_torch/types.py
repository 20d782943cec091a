"""Core tensor tuples shared across the port (``seed_rl_tpu/types.py``).

- ``EnvOutput = (reward, done, observation, abandoned, episode_step)``:
  ``observation`` is the observation *after* the transition, and the first
  observation of the next episode when ``done`` is set.
- ``AgentOutput = (action, policy_logits, baseline)`` for policy agents.
- ``QAgentOutput = (action, q_values)`` for Q agents (R2D2).

All are plain ``NamedTuple``s of tensors, so ``torch.utils._pytree`` maps
over them like the JAX package maps over its pytrees.
"""

from typing import Any, NamedTuple


class EnvOutput(NamedTuple):
    """One environment transition, batched and/or time-major stacked.

    Attributes:
      reward: f32[...] reward obtained by the *previous* action.
      done: bool[...] whether the episode ended with the previous action
        (terminated OR abandoned).
      observation: tensor (or tuple/dict of tensors), post-transition and
        post-reset when done.
      abandoned: bool[...] episode was cut (e.g. TimeLimit) rather than
        properly terminated.
      episode_step: i32[...] number of steps in the current episode.
    """

    reward: Any
    done: Any
    observation: Any
    abandoned: Any
    episode_step: Any


class AgentOutput(NamedTuple):
    """Policy-agent output (V-trace / PPO / SAC actors)."""

    action: Any
    policy_logits: Any
    baseline: Any


class QAgentOutput(NamedTuple):
    """Q-agent output (R2D2)."""

    action: Any
    q_values: Any
