"""Actor loop and the learner-side inference bridge for external actors.

Port of ``seed_rl_tpu/runtime/actor.py`` (the reference's
common/actor.py:45-185 and the learners' ``inference`` functions, e.g.
agents/vtrace/learner.py:350-405), for environments stepped outside the
learner:

- ``actor_loop`` steps one batched env group, calling
  ``client.inference(env_id, run_id, env_output, raw_reward) -> action``
  per env and step. It draws a fresh random ``run_id`` per (re)start, from
  an unseeded generator, so the learner detects restarts (actor.py:80-84);
  on a transport error it rebuilds the envs (actor.py:71-74, 182-185).
- ``InferenceBridge`` is the handler bound to the batching server
  (``inference_server.py``). Per batch it detects ``run_id`` changes and
  resets those envs' unroll, recurrent state and previous action
  (learner.py:352-366), drops stale duplicate requests of dying actors
  (``get_non_dying_envs``, common/utils.py:1005-1059), hands the batch's
  timesteps to episode accounting (``on_timesteps``), runs the policy on
  the batch, scatters the recurrent state back, appends the timesteps to a
  ``HostUnrollStore`` and queues completed unrolls for the learner.

Episodes are accounted when their timesteps arrive, in the handler, as
the reference's inference function does (vtrace learner.py:373-378), not
when the learner trains on them as in the JAX package: a restart there
invalidates an env's accumulator while unrolls of its old life may still
wait in the queue, and those are then summed into the new life's first
return.

The JAX bridge reads a parameter snapshot on every batch. Here the learner
trains the agent's modules in place on another thread, so the bridge acts
through a ``rollout_host.BehaviourPolicy``: a copy of the agent that
``publish`` (the learner's thread, after each update) snapshots and the
handler refreshes before each batch. On the card the handler works on a
CUDA stream of its own, as ``HostRolloutEngine`` does. Per-env state stays
in numpy on the host: a batch gathers its rows, uploads them, runs the
policy step and downloads actions and state, as the JAX bridge does.
"""

import inspect
import queue
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from seed_rl_torch.rollout import Timestep, Unroll
from seed_rl_torch.rollout_host import BehaviourPolicy
from seed_rl_torch.runtime import specs as specs_lib
from seed_rl_torch.runtime.unroll_store import HostUnrollStore
from seed_rl_torch.utils.profiling import ExportingTimer, InferenceReturn


def get_non_dying_envs(env_ids: np.ndarray, run_ids: np.ndarray):
    """Mask dropping in-flight stale requests of restarting envs.

    When one env appears more than once in a batch (the old actor's last
    in-flight request racing its replacement's first), only the latest
    request survives; after filtering each env appears once
    (common/utils.py:1005-1059). A *changed* run_id relative to the
    learner's stored one is a restart, handled by resetting state, and is
    not dropped.
    """
    del run_ids  # the latest request wins whatever its run
    last = {}
    for i, env_id in enumerate(env_ids):
        last[int(env_id)] = i
    keep = np.zeros(len(env_ids), bool)
    keep[list(last.values())] = True
    return keep


def _to_host(tree):
    return specs_lib.map_tree(lambda t: t.detach().cpu().numpy(), tree)


class InferenceBridge:
    """The batch handler and unroll pipeline around an agent's policy step.

    Args:
      agent: the training agent; the bridge acts with a copy of it as it
        is now, refreshed by ``publish``.
      num_envs: the fleet's envs (global ids ``0 .. num_envs - 1``).
      unroll_length / num_overlapping_steps: the unrolls' T and burn-in.
      timestep_specs: ``(action spec, EnvOutput of specs, agent output of
        specs)`` of one env's timestep (``specs.ArraySpec`` leaves).
      unroll_queue_max_size: completed-unroll batches queued for the
        learner; more are dropped.
      example_action: one env's action (no batch dim), the first previous
        action of every env (default: an int32 zero).
      profile_inference_return: an ``InferenceReturn`` stage to return at.
      config: the value ``get_config`` hands to actors.
      store_unrolls_on_inference: False when actors build their unrolls
        and push them with ``add_unroll`` (PPO's external-actor contract).
      evaluator: receives ``add_stats``' episodes.
      virtual_batch_size / training_iterations_fn: ``pending_minimize``'s
        pacing.
      on_timesteps: ``on_timesteps(env_ids, env_output, restarted_ids)``,
        called in the handler with each batch's kept requests, after their
        restarts are known and in arrival order: the episode accounting.
      device: where the policy runs (default: the agent's parameters').
      seed: seeds the action-sampling generator on ``device``.
    """

    def __init__(
        self,
        agent,
        num_envs: int,
        unroll_length: int,
        timestep_specs,
        num_overlapping_steps: int = 0,
        unroll_queue_max_size: int = 64,
        example_action=None,
        profile_inference_return: Optional[InferenceReturn] = None,
        config=None,
        store_unrolls_on_inference: bool = True,
        evaluator=None,
        virtual_batch_size: int = 1,
        training_iterations_fn: Optional[Callable[[], int]] = None,
        on_timesteps: Optional[Callable] = None,
        device=None,
        seed: int = 0,
    ):
        self._example_action = (
            np.zeros((), np.int32) if example_action is None
            else np.asarray(example_action))
        self.agent = agent
        self.num_envs = num_envs
        self.device = torch.device(
            device if device is not None
            else next(agent.net.parameters()).device)
        self.behaviour = BehaviourPolicy(agent)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self.store = HostUnrollStore(num_envs, unroll_length, timestep_specs,
                                     num_overlapping_steps)
        self.unroll_queue: "queue.Queue" = queue.Queue(unroll_queue_max_size)
        self.run_ids = np.zeros((num_envs,), np.int64)
        self.profile_inference_return = profile_inference_return
        self.config = config
        self.store_unrolls_on_inference = store_unrolls_on_inference
        self.evaluator = evaluator
        self.virtual_batch_size = max(int(virtual_batch_size), 1)
        self._training_iterations_fn = training_iterations_fn
        # Completed unrolls queued so far, by either path (the reference's
        # host.completed_unrolls, learner.py:909-913).
        self.completed_unrolls = 0
        self.on_timesteps = on_timesteps
        self._pending = []  # unrolls taken off the queue, not yet batched
        # Host seconds of the handler's parts, summed over its batches:
        # restart bookkeeping, the gather and the upload; the policy step
        # until its stream is done; the download, the scatter and the
        # store. Read by chip_smoke.py.
        self.handler_seconds = dict.fromkeys(
            ("gather_upload", "policy", "store"), 0.0)
        self.handler_batches = 0
        self.handler_rows = 0

        # Dense per-env state, numpy on the host (the reference's
        # Aggregators).
        state0 = _to_host(self.behaviour.agent.initial_state(num_envs))
        self._agent_states = state0
        self._initial_state_row = specs_lib.map_tree(lambda x: x[:1].copy(),
                                                     state0)
        # The core state at the start of each env's current unroll (the
        # first_agent_states aggregator, vtrace learner.py:333-340).
        self._unroll_first_states = specs_lib.map_tree(np.copy, state0)
        self._prev_actions: Optional[np.ndarray] = None
        # Agents with per-env policy data (R2D2's epsilon ladder) take the
        # batch rows' global env ids.
        self._pass_env_ids = (
            "env_ids" in inspect.signature(agent.policy_step).parameters)

    def publish(self, agent=None):
        """Snapshot ``agent`` (default: the training agent) for the batches
        that start after this call."""
        self.behaviour.publish(self.agent if agent is None else agent)

    def get_config(self):
        return self.config

    def add_stats(self, data) -> None:
        """An actor-reported finished episode (EpisodeInfo-shaped) -> the
        Evaluator (reference learner.py:1095-1098)."""
        if self.evaluator is not None:
            self.evaluator.add(data)

    def add_unroll(self, first_states, timesteps) -> None:
        """An actor-built unroll batch -> the unroll queue (the reference's
        ``add_unroll`` RPC, learner.py:1100-1104). ``first_states`` leaves
        are [B, ...] core states, ``timesteps`` leaves [B, T_total, ...]."""
        batch = len(specs_lib.leaves_of(timesteps)[0])
        env_ids = np.arange(batch, dtype=np.int64)
        self.unroll_queue.put((env_ids, first_states, timesteps))
        self.completed_unrolls += batch

    def pending_minimize(self) -> bool:
        """True while training lags the collected unrolls (reference
        learner.py:908-913): actors poll it to pace themselves."""
        if self._training_iterations_fn is None:
            return False
        return self._training_iterations_fn() < (
            self.completed_unrolls // self.virtual_batch_size)

    def _zero_actions(self, n):
        if self._prev_actions is not None:
            return (np.zeros((n,) + self._prev_actions.shape[1:],
                             self._prev_actions.dtype),)
        return (np.broadcast_to(np.zeros_like(self._example_action),
                                (n,) + self._example_action.shape).copy(),)

    def _reset_envs(self, restarted: np.ndarray):
        self.store.reset(restarted)
        for states in (self._agent_states, self._unroll_first_states):
            for leaf, init in zip(specs_lib.leaves_of(states),
                                  specs_lib.leaves_of(
                                      self._initial_state_row)):
                leaf[restarted] = init[0]
        if self._prev_actions is not None:
            self._prev_actions[restarted] = 0

    def _to_device(self, tree):
        """Host arrays -> tensors on the device, copied on the current
        stream (the handler's own, or the learner's)."""
        def up(x):
            t = torch.from_numpy(np.ascontiguousarray(x))
            if self.device.type != "cuda":
                return t
            return t.pin_memory().to(self.device, non_blocking=True)

        return specs_lib.map_tree(up, tree)

    @torch.no_grad()
    def _policy_step(self, prev_action, env_output, core_state, env_ids):
        """Uploads, steps and downloads on the bridge's stream; returns the
        numpy agent output and new state, and the seconds at the upload's
        and the step's ends."""
        def run():
            self.behaviour.refresh()
            inputs = self._to_device((prev_action, env_output, core_state,
                                      env_ids))
            t_uploaded = time.perf_counter()
            kwargs = {"env_ids": inputs[3]} if self._pass_env_ids else {}
            out, state = self.behaviour.agent.policy_step(
                inputs[0], inputs[1], inputs[2], self.generator, **kwargs)
            if self._stream is not None:
                self._stream.synchronize()
            t_stepped = time.perf_counter()
            return _to_host(out), _to_host(state), t_uploaded, t_stepped

        if self._stream is None:
            return run()
        with torch.cuda.stream(self._stream):
            return run()

    def handler(self, env_ids: np.ndarray, request):
        """InferenceServer handler: request = (run_id i64, EnvOutput)."""
        t0 = time.perf_counter()
        stage = self.profile_inference_return
        if stage == InferenceReturn.INSTANTLY:
            return self._zero_actions(len(env_ids))

        run_ids, env_output = request
        keep = get_non_dying_envs(env_ids, run_ids)
        # Restarted envs among the kept requests: reset their rows.
        restarted = []
        for i in np.flatnonzero(keep):
            env_id = int(env_ids[i])
            if self.run_ids[env_id] != run_ids[i]:
                restarted.append(env_id)
                self.run_ids[env_id] = run_ids[i]
        restarted = np.asarray(restarted, np.int64)
        if len(restarted):
            self._reset_envs(restarted)

        kept_idx = np.flatnonzero(keep)
        kept_env_ids = env_ids[kept_idx]
        kept_output = specs_lib.map_tree(lambda x: x[kept_idx], env_output)
        if self.on_timesteps is not None:
            self.on_timesteps(kept_env_ids, kept_output, restarted)
        core_state = specs_lib.map_tree(lambda x: x[kept_env_ids],
                                        self._agent_states)
        if self._prev_actions is None:
            prev_action = np.broadcast_to(
                self._example_action,
                (len(kept_env_ids),) + self._example_action.shape).copy()
        else:
            prev_action = self._prev_actions[kept_env_ids]
        if stage == InferenceReturn.BEFORE_INFERENCE:
            return self._zero_actions(len(env_ids))

        agent_output, new_state, t1, t2 = self._policy_step(
            prev_action, kept_output, core_state, kept_env_ids)
        for leaf, new in zip(specs_lib.leaves_of(self._agent_states),
                             specs_lib.leaves_of(new_state)):
            leaf[kept_env_ids] = new
        actions = agent_output.action
        if self._prev_actions is None:
            self._prev_actions = np.zeros(
                (self.num_envs,) + actions.shape[1:], actions.dtype)
        if stage == InferenceReturn.AFTER_INFERENCE:
            self._prev_actions[kept_env_ids] = actions
            return self._zero_actions(len(env_ids))

        # Dying requests get a zero action (their actors are being
        # replaced).
        full_actions = np.zeros((len(env_ids),) + actions.shape[1:],
                                actions.dtype)
        full_actions[kept_idx] = actions
        # Actors that build their own unrolls (add_unroll) or an eval run
        # store nothing here (reference store_unrolls_on_inference,
        # learner_config.py:99).
        if self.store_unrolls_on_inference:
            completed_ids, unrolls = self.store.append(
                kept_env_ids, (prev_action, kept_output, agent_output))
            self._prev_actions[kept_env_ids] = actions
            if stage == InferenceReturn.AFTER_UNROLL:
                return self._zero_actions(len(env_ids))
            if len(completed_ids):
                self._queue_completed(completed_ids, unrolls)
        else:
            self._prev_actions[kept_env_ids] = actions
        t3 = time.perf_counter()
        seconds = self.handler_seconds
        seconds["gather_upload"] += t1 - t0
        seconds["policy"] += t2 - t1
        seconds["store"] += t3 - t2
        self.handler_batches += 1
        self.handler_rows += len(env_ids)
        return (full_actions,)

    def _queue_completed(self, completed_ids, unrolls):
        first_states = specs_lib.map_tree(lambda x: x[completed_ids],
                                          self._unroll_first_states)
        try:
            self.unroll_queue.put_nowait((completed_ids, first_states,
                                          unrolls))
            self.completed_unrolls += len(completed_ids)
        except queue.Full:
            pass  # dropped under backpressure (off-policy tolerates it)
        # The next unroll of these envs starts at the carried boundary;
        # record the state entering it.
        for first, cur in zip(specs_lib.leaves_of(self._unroll_first_states),
                              specs_lib.leaves_of(self._agent_states)):
            first[completed_ids] = cur[completed_ids]

    def next_unroll_batch(
        self,
        batch_size: int,
        timeout: float = 10.0,
        with_env_ids: bool = False,
        training_only_below: Optional[int] = None,
        excluded_sink: Optional[Callable] = None,
    ):
        """Collects ``batch_size`` completed unrolls, time-major, on the
        bridge's device.

        Returns an ``Unroll`` (leaves [T_total, batch, ...], the agent
        state [batch, ...]) for any learner's ``update``; surplus unrolls
        wait for the next call. With ``with_env_ids`` the return is
        ``(env_ids i64[batch], Unroll)``. ``training_only_below=N`` keeps
        eval envs' unrolls (env_id >= N) out of the batch (reference r2d2
        learner.py:793-803): each goes to ``excluded_sink(env_id,
        first_state, item_major_timesteps)`` instead. Raises
        ``queue.Empty`` after ``timeout`` seconds without an unroll.
        """
        while len(self._pending) < batch_size:
            completed_ids, first_states, unrolls = self.unroll_queue.get(
                timeout=timeout)
            for j, env_id in enumerate(completed_ids.tolist()):
                item = (env_id,
                        specs_lib.map_tree(lambda x: x[j], first_states),
                        specs_lib.map_tree(lambda x: x[j], unrolls))
                if (training_only_below is not None
                        and env_id >= training_only_below):
                    if excluded_sink is not None:
                        excluded_sink(*item)
                    continue
                self._pending.append(item)
        items = self._pending[:batch_size]
        self._pending = self._pending[batch_size:]

        def stack(axis):
            return lambda *xs: np.stack(xs, axis=axis)

        states = specs_lib.map_tree(stack(0), *[s for _, s, _ in items])
        # Item-major [T, ...] rows -> time-major [T, batch, ...].
        timesteps = specs_lib.map_tree(stack(1), *[u for _, _, u in items])
        prev_actions, env_outputs, agent_outputs = self._to_device(timesteps)
        unroll = Unroll(agent_state=self._to_device(states),
                        timesteps=Timestep(prev_action=prev_actions,
                                           env_output=env_outputs,
                                           agent_output=agent_outputs))
        if with_env_ids:
            return np.asarray([e for e, _, _ in items], np.int64), unroll
        return unroll


def actor_loop(
    create_env_fn: Callable[[], Any],
    client,
    num_steps: Optional[int] = None,
    env_id_offset: int = 0,
    max_reconnects: int = 10,
    timer_export_fn=None,
    apply_config_fn=None,
    client_factory=None,
    inference_threads: Optional[int] = None,
):
    """Steps a batched host env group against an inference client.

    ``client.inference(env_id, run_id, env_output_row, raw_reward) ->
    action``; batching happens server-side. One random int64 run_id per
    life of the env group, from an unseeded generator (a restart must not
    repeat it). With ``timer_export_fn`` the windowed wall-clock averages
    ``actor/elapsed_inference_s``, ``actor/elapsed_env_step_s`` and
    ``actor/elapsed_env_reset_s`` are exported (reference
    common/actor.py:100-110), and the partial windows when the loop ends.

    The envs' calls run concurrently on a thread pool
    (``inference_threads``; default one per env, 0 or 1 the reference's
    serial loop): one actor's serial calls cannot fill a server batch, so
    each would wait out the flush timeout. Each env still blocks on its own
    action. A socket client serves one call at a time, so the concurrent
    mode takes ``client_factory`` to open one connection per pool thread;
    an in-process ``BridgeClient`` is safe to share. Returns the steps run.
    """
    import concurrent.futures

    inference_timer = ExportingTimer("actor/elapsed_inference_s", 100,
                                     timer_export_fn)
    env_step_timer = ExportingTimer("actor/elapsed_env_step_s", 100,
                                    timer_export_fn)
    env_reset_timer = ExportingTimer("actor/elapsed_env_reset_s", 1,
                                     timer_export_fn)
    reconnects = 0
    steps_done = 0
    try:
        while True:
            pool = None
            tls = threading.local()
            made_clients = []
            try:
                # Adopt the learner's pushed config before building envs
                # (reference update_config at actor.py:75).
                if apply_config_fn is not None and hasattr(client,
                                                           "get_config"):
                    pushed = client.get_config()
                    if pushed is not None:
                        apply_config_fn(pushed)
                env = create_env_fn()
                run_id = np.random.default_rng().integers(1, 2**62,
                                                          dtype=np.int64)
                with env_reset_timer:
                    output = env.reset()
                n = env.num_envs
                threads = n if inference_threads is None else inference_threads

                def thread_client():
                    if client_factory is None:
                        return client
                    c = getattr(tls, "client", None)
                    if c is None:
                        c = tls.client = client_factory()
                        made_clients.append(c)
                    return c

                def call(i, out):
                    row = specs_lib.map_tree(lambda x: x[i], out)
                    return np.asarray(thread_client().inference(
                        env_id_offset + i, run_id, row, row.reward))

                if threads > 1:
                    pool = concurrent.futures.ThreadPoolExecutor(
                        min(threads, n))
                while num_steps is None or steps_done < num_steps:
                    with inference_timer:
                        if pool is not None:
                            actions = list(pool.map(
                                lambda i: call(i, output), range(n)))
                        else:
                            actions = [call(i, output) for i in range(n)]
                    with env_step_timer:
                        output = env.step(np.stack(actions))
                    steps_done += 1
                env.close()
                return steps_done
            except RuntimeError:
                reconnects += 1
                if reconnects > max_reconnects:
                    raise
            finally:
                # Every exit releases the pool's threads and their
                # connections. Join the workers before closing their
                # clients: a worker may still be blocked in a recv on its
                # own client.
                if pool is not None:
                    pool.shutdown(wait=True, cancel_futures=True)
                for c in made_clients:
                    try:
                        c.close()
                    except OSError:
                        pass
    finally:
        for timer in (inference_timer, env_step_timer, env_reset_timer):
            timer.flush()


class BridgeClient:
    """An in-process ``InferenceServer`` in the reference actor's call
    convention, with the bridge's RPC surface."""

    def __init__(self, server, bridge=None):
        self._server = server
        self._bridge = bridge

    def inference(self, env_id, run_id, env_output, raw_reward):
        del raw_reward  # tracked learner-side via EnvOutput.reward
        (action,) = self._server.inference(env_id,
                                           (np.int64(run_id), env_output))
        return action

    def get_config(self):
        """The learner's pushed config (reference get_config RPC)."""
        return self._bridge.get_config() if self._bridge is not None else None

    def add_stats(self, data):
        """Report a finished episode (reference add_stats RPC)."""
        if self._bridge is not None:
            self._bridge.add_stats(data)

    def add_unroll(self, first_states, timesteps):
        """Push an actor-built unroll batch (reference add_unroll RPC)."""
        if self._bridge is not None:
            self._bridge.add_unroll(first_states, timesteps)

    def pending_minimize(self):
        """The learner's training backlog (reference pending_minimize
        RPC)."""
        return (self._bridge.pending_minimize() if self._bridge is not None
                else False)
