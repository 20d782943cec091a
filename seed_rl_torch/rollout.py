"""On-device batched rollout engine.

Port of ``seed_rl_tpu/rollout.py``. A Python loop over T steps advances the
batch of tensor envs and the policy on the device (the JAX package runs a
``lax.scan`` under ``jit``) and emits the same time-major
``[overlap + T + 1, B]`` unrolls: consecutive unrolls share ``overlap + 1``
boundary timesteps, unroll k covers global env steps
``k*T .. k*T + overlap + T``, and each unroll stores the core state before
its first timestep.

The engine owns the generator that action sampling draws from.

On a CUDA device the T steps and the unroll's assembly are one CUDA graph
(``CudaGraph``): the first ``rollout`` runs them eagerly (which warms
cuDNN, lazy inits and the allocator), the second captures them and every
call replays them, so the host launches one graph where the loop launched
thousands of kernels. The engine's and the env's generators are registered
with the graph, so a replay draws what the eager loop would. An agent whose
net writes its core state in place (GTrXL's memory) keeps that state in the
graph's own inputs from call to call: a replay updates it where it lies.
The core state an unroll stores is always a copy (``unroll_state``). A
capture that CUDA refuses (a body that waits for the host) leaves the
engine eager for good, with a warning; running out of memory in a capture
raises. Elsewhere the loop runs eagerly. ``captures``,
``graph_replays`` and ``capture_failures`` count the graph path's events.
The graph holds its memory pool, about the rollout's working set, for as
long as the engine lives.
"""

from typing import Any, List, NamedTuple, Tuple

import torch
import torch.utils._pytree as pytree

from seed_rl_torch.cuda_graph import GraphedCalls, tensors_of
from seed_rl_torch.envs.core import BatchedEnv, BatchedEnvState
from seed_rl_torch.types import EnvOutput
from seed_rl_torch.utils.profiling import span


class Timestep(NamedTuple):
    """One completed timestep: action entering, obs seen, output produced."""

    prev_action: Any
    env_output: EnvOutput
    agent_output: Any


class Unroll(NamedTuple):
    """Training input: [overlap+T+1, B] timesteps + initial core state."""

    agent_state: Any  # core state before the unroll's first timestep
    timesteps: Timestep


class RolloutState(NamedTuple):
    env_state: BatchedEnvState
    env_output: EnvOutput  # next observation to process
    agent_state: Any  # current core state
    prev_action: Any
    carry_timesteps: Timestep  # last overlap+1 completed timesteps
    next_unroll_state: Any  # core state at the next unroll's first timestep


# The env axis of every rollout-state field: all of it is per env, so a
# rank holds its envs' (``parallel/dp.py``).
ROLLOUT_SHARDS = RolloutState(
    env_state=0, env_output=0, agent_state=0, prev_action=0,
    carry_timesteps=1,  # time-major [overlap + 1, B, ...]
    next_unroll_state=0,
)


def unroll_state(agent_state):
    """The core state an unroll stores: a copy of ``agent_state``, which a
    net that writes its state in place (GTrXL's memory) changes later."""
    return pytree.tree_map(torch.clone, agent_state)


def _stack_time(timesteps: List[Timestep]) -> Timestep:
    flat = [pytree.tree_flatten(ts) for ts in timesteps]
    spec = flat[0][1]
    leaves = [torch.stack(xs) for xs in zip(*(leaves for leaves, _ in flat))]
    return pytree.tree_unflatten(leaves, spec)


def _concat_time(a, b):
    return pytree.tree_map(lambda x, y: torch.cat([x, y], dim=0), a, b)


def _tail_time(tree, n):
    return pytree.tree_map(lambda x: x[-n:], tree)


class RolloutEngine(GraphedCalls):
    """Generates fixed-length unrolls by stepping envs + policy on device.

    Args:
      batched_env: a ``BatchedEnv`` (auto-resetting, on one device).
      agent: object with ``policy_step(prev_action, env_output, core_state,
        generator, deterministic=...)`` and ``initial_state(batch)``.
      unroll_length: T — new timesteps per unroll.
      num_overlapping_steps: o — timesteps shared with the previous unroll in
        addition to the +1 boundary step (R2D2 burn-in).
      seed: seeds the action-sampling generator.
      deterministic: act by the policy's mode instead of sampling (eval).
    """

    is_host = False

    def __init__(
        self,
        batched_env: BatchedEnv,
        agent,
        unroll_length: int,
        num_overlapping_steps: int = 0,
        seed: int = 0,
        deterministic: bool = False,
    ):
        if unroll_length <= num_overlapping_steps:
            raise ValueError(
                "unroll_length must exceed the overlap (the reference "
                "UnrollStore has the same constraint)"
            )
        self.env = batched_env
        self.agent = agent
        self.unroll_length = unroll_length
        self.overlap = num_overlapping_steps
        self.deterministic = deterministic
        self.device = batched_env.device
        self.generator = torch.Generator(device=batched_env.device)
        self.generator.manual_seed(seed)
        # A rank's actions are its slice of the global draw.
        self.draws = batched_env.mesh.draws(self.generator,
                                            batched_env.global_num_envs)
        self._zero_action = zero_action_for_space(
            batched_env.action_space, batched_env.device
        )
        # The rollout as one CUDA graph on a CUDA device (``rollout``); the
        # eager loop elsewhere.
        self._init_graphs(self.device, "rollout", "the rollout")

    def _batch_zero_action(self, batch):
        zero = self._zero_action
        return zero.expand((batch,) + tuple(zero.shape)).contiguous()

    def _step(self, env_state, env_output, agent_state, prev_action):
        with span("rollout.policy_step"):
            agent_output, agent_state = self.agent.policy_step(
                prev_action, env_output, agent_state, self.draws,
                deterministic=self.deterministic,
            )
        timestep = Timestep(
            prev_action=prev_action,
            env_output=env_output,
            agent_output=agent_output,
        )
        with span("rollout.env_step"):
            env_state, env_output = self.env.step(env_state,
                                                  agent_output.action)
        return env_state, env_output, agent_state, agent_output.action, timestep

    @torch.no_grad()
    def init(self) -> RolloutState:
        """Reset envs and prime the first ``overlap+1`` timesteps.

        Priming makes the first unroll cover genuine env steps 0..o+T (no
        zero padding), matching the reference store's first completed unroll.
        """
        env_state, env_output = self.env.reset()
        batch = self.env.num_envs
        agent_state = self.agent.initial_state(batch)
        prev_action = self._batch_zero_action(batch)
        primed = []
        for _ in range(self.overlap + 1):
            env_state, env_output, agent_state, prev_action, timestep = (
                self._step(env_state, env_output, agent_state, prev_action)
            )
            primed.append(timestep)
        return RolloutState(
            env_state=env_state,
            env_output=env_output,
            agent_state=agent_state,
            prev_action=prev_action,
            carry_timesteps=_stack_time(primed),
            next_unroll_state=self.agent.initial_state(batch),
        )

    def _body(self, state: RolloutState) -> Tuple[RolloutState, Timestep]:
        """The rollout's device work: T env steps from ``state`` and the
        unroll's assembly. Returns the new state and the unroll's
        ``[o+T+1, B]`` timesteps."""
        env_state, env_output = state.env_state, state.env_output
        agent_state, prev_action = state.agent_state, state.prev_action
        # The core state at the timestep that starts the *next* unroll
        # (``state.next_unroll_state`` is not read).
        capture_step = self.unroll_length - self.overlap - 1
        new_timesteps = []
        for step in range(self.unroll_length):
            if step == capture_step:
                next_unroll_state = unroll_state(agent_state)
            env_state, env_output, agent_state, prev_action, timestep = (
                self._step(env_state, env_output, agent_state, prev_action)
            )
            new_timesteps.append(timestep)

        unroll_timesteps = _concat_time(
            state.carry_timesteps, _stack_time(new_timesteps)
        )
        new_state = RolloutState(
            env_state=env_state,
            env_output=env_output,
            agent_state=agent_state,
            prev_action=prev_action,
            carry_timesteps=_tail_time(unroll_timesteps, self.overlap + 1),
            next_unroll_state=next_unroll_state,
        )
        return new_state, unroll_timesteps

    @torch.no_grad()
    def rollout(self, state: RolloutState) -> Tuple[RolloutState, Unroll]:
        """Advance T env steps; emit one [o+T+1, B] unroll."""
        with span("rollout"):
            if self._graph_class is None:
                new_state, timesteps = self._body(state)
            else:
                new_state, timesteps = self._graphed(state)
        return new_state, Unroll(agent_state=state.next_unroll_state,
                                 timesteps=timesteps)

    def _graphed(self, state: RolloutState) -> Tuple[RolloutState, Timestep]:
        """``_body`` by the graph (``GraphedCalls``), with the agent's and
        env's tensors read in place. ``next_unroll_state``, which the body
        does not read, is no input."""
        return self._through_graph(
            self._body, state._replace(next_unroll_state=()),
            tensors_of((self.agent, self.env)),
            [self.generator, self.env.generator], self._hand_out)

    def _hand_out(self, outputs, inputs) -> Tuple[RolloutState, Timestep]:
        """A replay's outputs cloned, so that every unroll and state handed
        out is the caller's own, as the eager loop's are. A leaf of the
        agent state that the body writes in place (GTrXL's memory) comes
        out as the static input at the same position: it is handed out as
        it is, and when the next call passes it back, nothing is copied."""
        new_state, timesteps = outputs
        timesteps = pytree.tree_map(torch.clone, timesteps)
        agent_leaves, agent_spec = pytree.tree_flatten(new_state.agent_state)
        agent_state = pytree.tree_unflatten(
            [out if out is static else out.clone()
             for out, static in zip(agent_leaves,
                                    pytree.tree_leaves(inputs.agent_state))],
            agent_spec)
        new_state = pytree.tree_map(
            torch.clone,
            new_state._replace(agent_state=(), carry_timesteps=()))
        return new_state._replace(
            agent_state=agent_state,
            carry_timesteps=_tail_time(timesteps, self.overlap + 1)), timesteps


def zero_action_for_space(space, device=None):
    """Zero action tensor for a single env, by duck typing on the space."""
    sub_spaces = getattr(space, "spaces", None)
    if isinstance(sub_spaces, (tuple, list)):
        # Joint distributions emit concatenated float actions (see
        # distributions.JointDistribution).
        width = 0
        for sub in sub_spaces:
            if hasattr(sub, "nvec"):
                width += len(sub.nvec)
            elif hasattr(sub, "n"):
                width += 1
            else:
                width += sub.shape[0]
        return torch.zeros((width,), dtype=torch.float32, device=device)
    if hasattr(space, "nvec"):
        return torch.zeros(
            (len(space.nvec),), dtype=torch.int32, device=device
        )
    if hasattr(space, "n"):
        return torch.zeros((), dtype=torch.int32, device=device)
    if hasattr(space, "low") and hasattr(space, "high"):
        return torch.zeros(
            tuple(space.shape), dtype=torch.float32, device=device
        )
    raise ValueError(f"Unsupported action space {space}")
