"""Agent = network + parametric action distribution.

Port of ``seed_rl_tpu/agent.py``: step-mode application on ``[B]`` inputs
returning ``AgentOutput(action, policy_logits, baseline)`` plus the new
core state, and unroll-mode application on time-major ``[T, B]`` inputs.
The network module holds its parameters (the JAX package passes them in).
Sampling takes an explicit ``torch.Generator``; training unrolls skip it.

For stateless networks the unroll folds time into batch (``batch_apply``);
recurrent networks provide their own ``unroll``.

``NormalizingObservationsAgent`` normalizes observations by streaming
statistics (``ops/normalizer.py``) before the wrapped agent's network sees
them. Where the JAX package carries the statistics in the parameter tree,
here the wrapper holds them as ``obs_norm``: they are never trained, and
the learner folds each training step's observations into them once.
"""

from typing import Any, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from seed_rl_torch.distributions import ParametricDistribution
from seed_rl_torch.ops import normalizer
from seed_rl_torch.types import AgentOutput, EnvOutput


def batch_apply(fn, inputs):
    """Fold leading [T, B] dims into one batch dim, apply, unfold."""
    leaves = pytree.tree_leaves(inputs)
    t, b = leaves[0].shape[:2]
    folded = pytree.tree_map(
        lambda x: x.reshape((t * b,) + tuple(x.shape[2:])), inputs
    )
    out = fn(folded)
    return pytree.tree_map(
        lambda x: x.reshape((t, b) + tuple(x.shape[1:])), out
    )


class PolicyAgent:
    """Policy-gradient-family agent (V-trace, PPO, SAC actor)."""

    def __init__(self, net: torch.nn.Module,
                 distribution: ParametricDistribution):
        self.net = net
        self.distribution = distribution

    def initial_state(self, batch_size: int):
        return self.net.initial_state(batch_size)

    def policy_step(
        self,
        prev_action,
        env_output: EnvOutput,
        core_state,
        generator: Optional[torch.Generator] = None,
        deterministic: bool = False,
        noise=None,
    ) -> Tuple[AgentOutput, Any]:
        """One inference step on [B] inputs; samples an action, or takes
        the distribution's mode when ``deterministic``. ``noise`` (the
        tree of ``distribution.draws``) replaces the generator's draws."""
        (policy_params, baseline), core_state = self.net(
            prev_action, env_output, core_state
        )
        if deterministic:
            action = self.distribution.mode(policy_params)
        else:
            action = self.distribution.sample(policy_params, generator,
                                              noise)
        return AgentOutput(action, policy_params, baseline), core_state

    def unroll(
        self, prev_actions, env_outputs: EnvOutput, core_state
    ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], Any]:
        """Training forward over time-major [T, B] inputs (no sampling)."""
        if self.net.stateless:
            out = batch_apply(
                lambda args: self.net(args[0], args[1], ())[0],
                (prev_actions, env_outputs),
            )
            return out, core_state
        return self.net.unroll(prev_actions, env_outputs, core_state)


class NormalizingObservationsAgent:
    """Observation-normalizing wrapper around a ``PolicyAgent``.

    ``update_observation_normalization`` folds a training unroll's
    observations into ``obs_norm``, once per training step.
    """

    def __init__(self, inner: PolicyAgent, observation_size: int):
        self.inner = inner
        self.net = inner.net
        self.distribution = inner.distribution
        device = next(inner.net.parameters()).device
        self.obs_norm = normalizer.init(observation_size, device)

    def initial_state(self, batch_size: int):
        return self.inner.initial_state(batch_size)

    def _normalized(self, env_outputs: EnvOutput) -> EnvOutput:
        observation = normalizer.normalize_observation(
            self.obs_norm, env_outputs.observation)
        return env_outputs._replace(observation=observation)

    def policy_step(self, prev_action, env_output, core_state,
                    generator: Optional[torch.Generator] = None,
                    deterministic: bool = False, noise=None):
        return self.inner.policy_step(
            prev_action, self._normalized(env_output), core_state, generator,
            deterministic, noise)

    def unroll(self, prev_actions, env_outputs, core_state):
        return self.inner.unroll(prev_actions, self._normalized(env_outputs),
                                 core_state)

    def update_observation_normalization(self, observation):
        """End-of-training-step statistics fold."""
        self.obs_norm = normalizer.update_from_observation(
            self.obs_norm, observation)
