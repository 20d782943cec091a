"""Rollout engine for host-process environments (gym, MuJoCo, ALE).

Port of ``seed_rl_tpu/rollout_host.py``: env stepping happens on the host
in a ``HostBatchedEnv``, the policy step runs on the device, and the
finished ``[overlap+T+1, B]`` unroll lives on the device for the learner's
``update``. It has the same ``Unroll`` layout as ``rollout.RolloutEngine``:
consecutive unrolls share the ``overlap + 1`` boundary timesteps, and each
unroll stores the core state before its first timestep (captured at step
``T - overlap - 1`` of the previous one), so every learner's update works
with either engine.

Where the JAX engine takes the parameters to act with as an argument, this
one acts with its own copy of the agent (``BehaviourPolicy``), which
``publish`` refreshes from the training agent where the JAX loops read
``rollout_params``. The training agent's parameters change in place on
every optimizer step; the copy keeps what was published, so a rollout
that runs beside an update (``--pipeline_host_rollouts``) acts with the
parameters from before it, as in the JAX package.

On the card the engine works on a CUDA stream of its own, so its policy
steps can run beside an update on the default stream. Observations go up
from pinned host memory and stay uint8; actions come back to the host once
a step. At the end of a rollout the engine waits for its stream, so the
unroll it returns is complete, and marks the unroll's tensors as used on
the default stream, where the learner reads them.
"""

import copy
import threading
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from seed_rl_torch.device import resolve_device
from seed_rl_torch.envs.host import HostBatchedEnv
from seed_rl_torch.rollout import (
    Timestep,
    Unroll,
    _concat_time,
    _stack_time,
    _tail_time,
    unroll_state,
    zero_action_for_space,
)


class BehaviourPolicy:
    """A copy of an agent that acts while the original trains.

    ``publish`` (any thread) snapshots the training agent's tensors on the
    caller's stream; ``refresh`` (the acting thread) copies the latest
    snapshot into the copy, on the acting stream, after the snapshot is
    made. A snapshot taken before an optimizer step keeps the values from
    before it. The network's parameters and buffers are copied in place;
    the observation statistics (``obs_norm``), which the agents replace
    rather than update and whose leaves may share one tensor
    (``normalizer.init``), are replaced by the snapshot's.
    """

    def __init__(self, agent):
        self.agent = copy.deepcopy(agent)
        self.agent.net.requires_grad_(False)
        self._lock = threading.Lock()
        self._pending = None

    @torch.no_grad()
    def publish(self, agent):
        tensors = [t.detach().clone()
                   for t in list(agent.net.parameters())
                   + list(agent.net.buffers())]
        obs_norm = getattr(agent, "obs_norm", None)
        if obs_norm is not None:
            obs_norm = pytree.tree_map(lambda t: t.detach().clone(),
                                       obs_norm)
        event = None
        if tensors and tensors[0].is_cuda:
            event = torch.cuda.Event()
            event.record()
        with self._lock:
            self._pending = (tensors, obs_norm, event)

    @torch.no_grad()
    def refresh(self):
        with self._lock:
            pending, self._pending = self._pending, None
        if pending is None:
            return
        snapshot, obs_norm, event = pending
        targets = (list(self.agent.net.parameters())
                   + list(self.agent.net.buffers()))
        if len(targets) != len(snapshot):
            raise ValueError("the published agent does not match the copy")
        if event is not None:
            stream = torch.cuda.current_stream()
            stream.wait_event(event)
            for s in snapshot + pytree.tree_leaves(obs_norm or ()):
                s.record_stream(stream)
        for t, s in zip(targets, snapshot):
            t.copy_(s)
        if hasattr(self.agent, "obs_norm"):
            self.agent.obs_norm = obs_norm


class HostRolloutState(NamedTuple):
    """Where a host rollout stands; the envs' own state is in the
    ``HostBatchedEnv``."""

    env_output: Any  # numpy EnvOutput, the next to process
    agent_state: Any  # current core state (device)
    prev_action: Any  # device
    carry_timesteps: Timestep  # last overlap+1 completed timesteps
    next_unroll_state: Any  # core state at the next unroll's first timestep


class HostRolloutEngine:
    """``RolloutEngine``'s contract, with env stepping on the host.

    Args:
      batched_env: a ``HostBatchedEnv``.
      agent: the training agent; the engine acts with a copy of it as it
        is now, refreshed by ``publish``.
      unroll_length: T, new timesteps per unroll.
      num_overlapping_steps: o, timesteps shared with the previous unroll
        besides the boundary step (R2D2's burn-in).
      device: where the policy runs (default: the CUDA device).
      seed: seeds the action-sampling generator.
      deterministic: act by the policy's mode (eval).
    """

    is_host = True

    def __init__(
        self,
        batched_env: HostBatchedEnv,
        agent,
        unroll_length: int,
        num_overlapping_steps: int = 0,
        device=None,
        seed: int = 0,
        deterministic: bool = False,
    ):
        if unroll_length <= num_overlapping_steps:
            raise ValueError("unroll_length must exceed the overlap")
        self.env = batched_env
        self.agent = agent
        self.unroll_length = unroll_length
        self.overlap = num_overlapping_steps
        self.deterministic = deterministic
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.behaviour = BehaviourPolicy(agent)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._zero_action = zero_action_for_space(batched_env.action_space,
                                                  self.device)

    def publish(self, agent=None):
        """Snapshot ``agent`` (default: the training agent) for the
        rollouts that start after this call."""
        self.behaviour.publish(self.agent if agent is None else agent)

    def _to_device(self, env_output):
        """A numpy ``EnvOutput`` on the device, dtypes kept (frames uint8)."""
        def upload(x):
            t = torch.from_numpy(np.ascontiguousarray(x))
            if self._stream is None:
                return t.to(self.device)
            return t.pin_memory().to(self.device, non_blocking=True)

        return pytree.tree_map(upload, env_output)

    def _to_host(self, action):
        return action.cpu().numpy()

    def _run_steps(self, state: HostRolloutState, num_steps: int,
                   capture_at: Optional[int]):
        """``num_steps`` policy + env steps from ``state``; returns the new
        state, the stacked timesteps and the core state before step
        ``capture_at``."""
        env_output = state.env_output
        agent_state, prev_action = state.agent_state, state.prev_action
        captured = state.next_unroll_state
        agent = self.behaviour.agent
        timesteps = []
        for step in range(num_steps):
            if step == capture_at:
                captured = unroll_state(agent_state)
            env_output_dev = self._to_device(env_output)
            agent_output, agent_state = agent.policy_step(
                prev_action, env_output_dev, agent_state, self.generator,
                deterministic=self.deterministic)
            timesteps.append(Timestep(prev_action, env_output_dev,
                                      agent_output))
            env_output = self.env.step(self._to_host(agent_output.action))
            prev_action = agent_output.action
        return (state._replace(env_output=env_output, agent_state=agent_state,
                               prev_action=prev_action),
                _stack_time(timesteps), captured)

    def _on_stream(self, fn):
        """Runs ``fn`` on the engine's stream, waits for it, and marks what
        it made as used on the default stream."""
        if self._stream is None:
            return fn()
        with torch.cuda.stream(self._stream):
            result = fn()
        self._stream.synchronize()
        default = torch.cuda.default_stream(self.device)
        for t in pytree.tree_leaves(result):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(default)
        return result

    @torch.no_grad()
    def init(self, seed: int = 0) -> HostRolloutState:
        """Resets the envs (env ``i`` with ``seed + i``) and primes the
        first ``overlap + 1`` timesteps, so the first unroll covers genuine
        env steps 0..o+T."""
        def run():
            self.behaviour.refresh()
            batch = self.env.num_envs
            zero = self._zero_action
            state = HostRolloutState(
                env_output=self.env.reset(seed=seed),
                agent_state=self.behaviour.agent.initial_state(batch),
                prev_action=zero.expand((batch,) + tuple(zero.shape))
                .contiguous(),
                carry_timesteps=None,
                next_unroll_state=None,
            )
            state, primed, _ = self._run_steps(state, self.overlap + 1, None)
            return state._replace(
                carry_timesteps=primed,
                next_unroll_state=self.behaviour.agent.initial_state(batch))

        return self._on_stream(run)

    @torch.no_grad()
    def rollout(self, state: HostRolloutState):
        """Advance T env steps; emit one [o+T+1, B] unroll on the device."""
        def run():
            self.behaviour.refresh()
            new_state, new_steps, captured = self._run_steps(
                state, self.unroll_length,
                capture_at=self.unroll_length - self.overlap - 1)
            timesteps = _concat_time(state.carry_timesteps, new_steps)
            unroll = Unroll(agent_state=state.next_unroll_state,
                            timesteps=timesteps)
            return new_state._replace(
                carry_timesteps=_tail_time(timesteps, self.overlap + 1),
                next_unroll_state=captured), unroll

        return self._on_stream(run)
