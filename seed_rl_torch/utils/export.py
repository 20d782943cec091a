"""Code-independent policy export.

Port of ``seed_rl_tpu/utils/export.py``, which serializes the jitted
policy step as StableHLO with its parameters. Here the deterministic
policy step is captured with ``torch.export`` and saved with
``torch.export.save`` to ``<directory>/policy.pt2``: the program and, as
its state, the net's parameters and a normalizing agent's observation
statistics. ``load_policy`` runs it without the model-building code.

The inputs and outputs are NamedTuple trees (``EnvOutput``, Atari's
``AgentState`` with its frame stack); each is registered for serialization
under a stable name, the counterpart of the JAX package's
``_register_pytree_serialization``.

The JAX signature's ``rng`` has nothing to feed in a deterministic step
and is dropped; a sampling policy (``deterministic=False``) is not
exported: a ``torch.Generator`` cannot cross ``torch.export``.
"""

import copy
import os
from typing import Callable

import torch
import torch.utils._pytree as pytree

FILE_NAME = "policy.pt2"


def _register_pytree_serialization():
    """Registers the NamedTuples a policy step takes or returns with
    ``torch.utils._pytree`` under stable names (idempotent)."""
    from seed_rl_torch.models.atari import AgentState
    from seed_rl_torch.types import AgentOutput, EnvOutput, QAgentOutput

    for cls in (EnvOutput, AgentOutput, QAgentOutput, AgentState):
        if cls not in pytree.SUPPORTED_NODES:
            pytree._register_namedtuple(
                cls, serialized_type_name=f"seed_rl_torch.{cls.__name__}")


class _PolicyStep(torch.nn.Module):
    """``agent.policy_step(..., deterministic=True)`` as a module: the net
    is its submodule and the observation statistics its buffers."""

    def __init__(self, agent):
        super().__init__()
        self.net = agent.net
        # A copy whose statistics ``forward`` points at the buffers.
        self._agent = copy.copy(agent)
        stats = getattr(agent, "obs_norm", None) or ()
        leaves, self._stats_spec = pytree.tree_flatten(stats)
        self._num_stats = len(leaves)
        for i, leaf in enumerate(leaves):
            self.register_buffer(f"obs_norm_{i}", leaf.detach().clone())

    def forward(self, prev_action, env_output, core_state):
        if self._num_stats:
            self._agent.obs_norm = pytree.tree_unflatten(
                [getattr(self, f"obs_norm_{i}")
                 for i in range(self._num_stats)], self._stats_spec)
        output, new_state = self._agent.policy_step(
            prev_action, env_output, core_state, deterministic=True)
        return output.action, new_state


def export_policy(directory: str, agent, example_prev_action,
                  example_env_output, deterministic: bool = True):
    """Serializes the agent's deterministic policy step and its state to
    ``directory`` at the example's batch size, shapes and device."""
    if not deterministic:
        raise NotImplementedError(
            "only the deterministic policy step is exported: a sampling "
            "step would need a torch.Generator, which cannot cross "
            "torch.export")
    _register_pytree_serialization()
    batch = pytree.tree_leaves(example_env_output.observation)[0].shape[0]
    args = (example_prev_action, example_env_output,
            agent.initial_state(batch))
    with torch.no_grad():
        program = torch.export.export(_PolicyStep(agent), args)
    # The example inputs are NamedTuples, which a weights-only load of the
    # program refuses; the program needs none of them.
    program.example_inputs = None
    os.makedirs(directory, exist_ok=True)
    torch.export.save(program, os.path.join(directory, FILE_NAME))


def load_policy(directory: str) -> Callable:
    """Loads an exported policy; returns ``fn(prev_action, env_output,
    core_state) -> (action, new_core_state)``."""
    _register_pytree_serialization()
    module = torch.export.load(os.path.join(directory, FILE_NAME)).module()

    def policy(prev_action, env_output, core_state):
        with torch.no_grad():
            return module(prev_action, env_output, core_state)

    return policy
