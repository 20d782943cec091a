"""Agent = network + parametric action distribution.

Port of ``seed_rl_tpu/agent.py``: step-mode application on ``[B]`` inputs
returning ``AgentOutput(action, policy_logits, baseline)`` plus the new
core state, and unroll-mode application on time-major ``[T, B]`` inputs.
The network module holds its parameters (the JAX package passes them in).
Sampling takes an explicit ``torch.Generator``; training unrolls skip it.

For stateless networks the unroll folds time into batch (``batch_apply``);
recurrent networks provide their own ``unroll``.

``NormalizingObservationsAgent`` waits for ``ops/normalizer.py`` in a later
slice.
"""

from typing import Any, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from seed_rl_torch.distributions import ParametricDistribution
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
    ) -> Tuple[AgentOutput, Any]:
        """One inference step on [B] inputs; samples an action, or takes
        the distribution's mode when ``deterministic``."""
        (policy_params, baseline), core_state = self.net(
            prev_action, env_output, core_state
        )
        if deterministic:
            action = self.distribution.mode(policy_params)
        else:
            action = self.distribution.sample(policy_params, generator)
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
