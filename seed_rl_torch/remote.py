"""Remote-actor training: the learner serves inference over a socket.

Port of ``seed_rl_tpu/remote.py``, the reference's deployment shape
(gcp/run.py:54-68: K worker machines x actor processes, one learner): actor
processes (``--run_mode=actor``) step host envs and make one blocking
inference call per env step (common/actor.py:45-185); the learner
(``--run_mode=learner``) batches the calls in the native batcher, runs the
policy on the card, accumulates unrolls in a ``HostUnrollStore`` and trains
on the unroll batches (agents/vtrace/learner.py:314-483).

The learner's env gives the specs only (vtrace/learner.py:174-178): the
learner steps no env.

Episode metrics are exact: ``PerEnvEpisodeStats`` keys its accumulators by
global env id and takes each env's timesteps in the order its actor sent
them, in the bridge's handler (the reference's env_infos Aggregator,
vtrace learner.py:373-378); an actor restart starts the env's accumulator
again at the new life's reset, so the episode the old life was running is
left out and no return mixes two lives. The JAX package counts episodes
when their unrolls are trained on instead; a restart can then meet an old
life's unroll still queued and sum it into the new life's first return.
"""

import collections
import inspect
import json
import os
import signal
import sys
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from seed_rl_torch.runtime import specs as specs_lib
from seed_rl_torch.types import EnvOutput


def _host_array(x, dtype):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


class PerEnvEpisodeStats:
    """Episode accounting keyed by global env id.

    The remote counterpart of ``utils.episode_stats``: per-env return
    accumulators indexed by env id and a window over completed episodes.
    ``completed_returns`` keeps each env's latest returns, so a caller can
    hold the learner's accounting against the actors' own. The handler's
    thread updates it and the learner's reads the window, under a lock.
    """

    def __init__(self, num_envs: int, keep_last: int = 16):
        self.return_acc = np.zeros((num_envs,), np.float64)
        self.num_episodes = 0
        self.sum_return = 0.0
        self.sum_length = 0.0
        self.completed_returns = collections.defaultdict(
            lambda: collections.deque(maxlen=keep_last))
        self._lock = threading.Lock()

    def restart(self, env_ids) -> None:
        """New actor lives: each of these envs starts again at a reset, an
        episode boundary; the episodes their old lives were running are
        left out."""
        with self._lock:
            self.return_acc[np.asarray(env_ids, np.int64)] = 0.0

    def _consume(self, env_id, reward, done, episode_step) -> None:
        acc = self.return_acc[env_id]
        for t in range(reward.shape[0]):
            acc += reward[t]
            if done[t]:
                self.num_episodes += 1
                self.sum_return += acc
                self.sum_length += float(episode_step[t])
                self.completed_returns[env_id].append(acc)
                acc = 0.0
        self.return_acc[env_id] = acc

    def update_batch(self, env_ids, env_outputs) -> None:
        """Consumes a time-major [T, B] block, column b of env
        ``env_ids[b]``; a batch keeps each env's arrival order. Only the
        scalar fields come to the host, never the observations."""
        reward = _host_array(env_outputs.reward, np.float64)
        done = _host_array(env_outputs.done, bool)
        episode_step = _host_array(env_outputs.episode_step, None)
        with self._lock:
            for b, env_id in enumerate(np.asarray(env_ids).tolist()):
                self._consume(env_id, reward[:, b], done[:, b],
                              episode_step[:, b])

    def window_metrics(self, prefix: str = "episodes"):
        """Mean return and length over the window, then a new window; None
        if no episode ended in it."""
        with self._lock:
            if not self.num_episodes:
                return None
            metrics = {
                f"{prefix}/mean_return": self.sum_return / self.num_episodes,
                f"{prefix}/mean_length": self.sum_length / self.num_episodes,
                f"{prefix}/num_episodes": float(self.num_episodes),
            }
            self.num_episodes = 0
            self.sum_return = 0.0
            self.sum_length = 0.0
        return metrics


def episode_accounting(stats: PerEnvEpisodeStats,
                       eval_stats: Optional[PerEnvEpisodeStats] = None,
                       num_training_envs: Optional[int] = None):
    """The bridge's ``on_timesteps`` hook: each kept request's timestep
    into ``stats`` (env ids below ``num_training_envs``) or
    ``eval_stats`` (the rest), after its env's restart if it has one."""
    def on_timesteps(env_ids, env_output, restarted):
        if len(restarted):
            stats.restart(restarted)
            if eval_stats is not None:
                eval_stats.restart(restarted)
        evals = (np.zeros(len(env_ids), bool) if num_training_envs is None
                 else env_ids >= num_training_envs)
        for target, rows in ((stats, ~evals), (eval_stats, evals)):
            if rows.any():
                target.update_batch(env_ids[rows], specs_lib.map_tree(
                    lambda x: x[None, rows], env_output))

    return on_timesteps


def array_specs(observation_spec):
    """A tree of ``specs.ArraySpec`` from an env's observation spec (an
    ``envs.core.TensorSpec`` of a torch dtype, an ``ArraySpec``, or a dict
    of either)."""
    if isinstance(observation_spec, dict):
        return {k: array_specs(v) for k, v in observation_spec.items()}
    dtype = observation_spec.dtype
    if isinstance(dtype, torch.dtype):
        dtype = torch.empty(0, dtype=dtype).numpy().dtype
    return specs_lib.array_spec(observation_spec.shape, dtype)


class SpecHostEnv:
    """A stand-in for the learner's env that gives specs and is never
    stepped."""

    def __init__(self, observation_spec, action_space, num_envs: int):
        self._observation_spec = observation_spec
        self.action_space = action_space
        self.num_envs = num_envs

    def observation_spec(self):
        return self._observation_spec

    def reset(self, seed: int = 0) -> EnvOutput:
        del seed
        n = self.num_envs
        return EnvOutput(
            reward=np.zeros(n, np.float32),
            done=np.zeros(n, bool),
            observation=specs_lib.map_tree(
                lambda s: np.zeros((n,) + tuple(s.shape), s.dtype),
                array_specs(self._observation_spec)),
            abandoned=np.zeros(n, bool),
            episode_step=np.zeros(n, np.int32),
        )

    def close(self):
        pass


def _single_env_specs(observation_spec, agent, zero_action, device):
    """(EnvOutput specs, action spec, agent output specs) of one env's
    timestep. The agent output's come from one policy step on a batch of
    one zero input, the signature discovery of the reference's TypeSpecs
    (grpc.cc:145-153)."""
    env_output_specs = EnvOutput(
        reward=specs_lib.array_spec((), np.float32),
        done=specs_lib.array_spec((), bool),
        observation=array_specs(observation_spec),
        abandoned=specs_lib.array_spec((), bool),
        episode_step=specs_lib.array_spec((), np.int32),
    )
    zero_action = np.asarray(zero_action)
    action_spec = specs_lib.array_spec(zero_action.shape, zero_action.dtype)

    def zeros(spec):
        return torch.zeros((1,) + tuple(spec.shape),
                           dtype=torch.from_numpy(
                               np.zeros((), spec.dtype)).dtype,
                           device=device)

    kwargs = {}
    if "env_ids" in inspect.signature(agent.policy_step).parameters:
        kwargs["env_ids"] = torch.zeros((1,), dtype=torch.long, device=device)
    with torch.no_grad():
        agent_output, _ = agent.policy_step(
            zeros(action_spec), specs_lib.map_tree(zeros, env_output_specs),
            agent.initial_state(1), torch.Generator(device=device), **kwargs)
    agent_output_spec = specs_lib.map_tree(lambda t: specs_lib.spec_of(t[0]),
                                           agent_output)
    return env_output_specs, action_spec, agent_output_spec


def _bridge_and_server(agent, observation_spec, zero_action, num_envs,
                       unroll_length, num_overlapping_steps,
                       inference_batch_size, server_address, config_push,
                       device, seed):
    """The bridge, and its server bound at ``server_address``."""
    from seed_rl_torch.runtime.actor import InferenceBridge
    from seed_rl_torch.runtime.inference_server import InferenceServer

    env_output_specs, action_spec, agent_output_spec = _single_env_specs(
        observation_spec, agent, zero_action, device)
    bridge = InferenceBridge(
        agent, num_envs=num_envs, unroll_length=unroll_length,
        timestep_specs=(action_spec, env_output_specs, agent_output_spec),
        num_overlapping_steps=num_overlapping_steps,
        example_action=np.asarray(zero_action), device=device, seed=seed)
    request_specs = (specs_lib.array_spec((), np.int64),  # run_id
                     env_output_specs)
    if not inference_batch_size:
        # The reference's auto-tune, max(env_batch_size, num_envs / (2 *
        # num_hosts)) (common/utils.py:989-1002), for one host.
        inference_batch_size = max(1, num_envs // 2)
    server = InferenceServer([bridge.handler], request_specs, (action_spec,),
                             batch_size=inference_batch_size,
                             flush_timeout_ms=50)
    try:
        server.serve(server_address, config=config_push)
    except OSError:
        server.shutdown()
        raise
    return bridge, server


def _server_metrics(server) -> Dict[str, Any]:
    stats = server.stats
    return {"server/total_batches": stats["total_batches"],
            "server/connections": stats.get("connections", 0)}


def run_remote_learner(
    agent,
    learner,
    observation_spec,
    server_address: str,
    total_environment_frames: int,
    unroll_length: int,
    num_envs: int,
    inference_batch_size: int = 0,
    num_overlapping_steps: int = 0,
    logger=None,
    checkpoint=None,
    log_every_steps: int = 10,
    config_push=None,
    seed: int = 1,
    stats_sink: Optional[dict] = None,
    unroll_timeout: float = 300.0,
):
    """Serves inference at ``server_address`` and trains on streamed
    unrolls, one per env per update, until the frame budget.

    ``learner`` has ``init`` / ``update(state, unroll)`` and an ``engine``
    whose zero action sizes the actions (V-trace, PPO over a
    ``HostRolloutEngine``). The bridge's generator is seeded ``seed``.
    ``stats_sink``: a dict that receives the ``PerEnvEpisodeStats`` under
    ``"episodes"``, the bridge and the server. Returns the final state and
    the last update's metrics.
    """
    state = learner.init()
    if checkpoint is not None:
        state = checkpoint.restore_or(learner, state)
    bridge, server = _bridge_and_server(
        agent, observation_spec, learner.engine._zero_action.cpu().numpy(),
        num_envs, unroll_length, num_overlapping_steps, inference_batch_size,
        server_address, config_push, learner.device, seed)
    frames_per_batch = num_envs * unroll_length
    frames = 0
    metrics: Dict[str, Any] = {}
    ep_stats = PerEnvEpisodeStats(num_envs)
    bridge.on_timesteps = episode_accounting(ep_stats)
    if stats_sink is not None:
        stats_sink.update(episodes=ep_stats, bridge=bridge, server=server)
    wait_s = 0.0
    try:
        while frames < total_environment_frames:
            t0 = time.perf_counter()
            unroll = bridge.next_unroll_batch(num_envs,
                                              timeout=unroll_timeout)
            wait_s += time.perf_counter() - t0
            state, metrics = learner.update(state, unroll)
            bridge.publish()
            frames += frames_per_batch
            step = state.step
            if logger is not None and step % log_every_steps == 0:
                logs = dict(metrics, **_server_metrics(server))
                logs.update(ep_stats.window_metrics() or {})
                logs["time/unroll_wait_s"] = wait_s
                wait_s = 0.0
                logger.log(step, logs, frames=frames)
            if checkpoint is not None:
                checkpoint.maybe_save(step, learner, state)
        if checkpoint is not None:
            checkpoint.maybe_save(state.step, learner, state, force=True)
    finally:
        server.shutdown()
    return state, metrics


def run_remote_offpolicy_learner(
    agent,
    learner,
    replay,
    observation_spec,
    server_address: str,
    total_environment_frames: int,
    unroll_length: int,
    num_envs: int,
    replay_ratio: float,
    replay_buffer_min_size: int,
    example_action,
    num_training_envs: Optional[int] = None,
    num_overlapping_steps: int = 0,
    inference_batch_size: int = 0,
    logger=None,
    checkpoint=None,
    log_every_cycles: int = 10,
    config_push=None,
    seed: int = 1,
    unroll_timeout: float = 300.0,
    stats_sink: Optional[dict] = None,
    replay_dir: Optional[str] = None,
):
    """Off-policy remote training: R2D2 and SAC served to actor fleets.

    The reference's R2D2 / SAC learner shape (agents/r2d2/learner.py:765-822,
    agents/sac/learner.py:539-556): the learner serves batched inference
    (R2D2's epsilons taken by env id), accumulates burn-in-overlapped
    unrolls, inserts those of training envs (env_id < num_training_envs;
    eval experience is never stored, r2d2 learner.py:793-803) into the
    host-RAM replay with their initial priorities, and trains under the
    replay-ratio contract as ``host_offpolicy_loop`` does.

    ``learner``: an ``R2D2HostLearner`` / ``SACHostLearner`` whose
    ``num_envs`` is the insertion batch (unrolls per cycle), typically
    ``max(1, round(batch_size / replay_ratio))`` (the reference's
    insertion_batch, r2d2 learner.py:113-117). ``example_action``: one
    env's action (no batch dim). ``stats_sink``: a dict that receives the
    ``PerEnvEpisodeStats`` under ``"episodes"`` / ``"eval_episodes"``, the
    bridge and the server. With ``replay_dir`` the replay is restored
    before serving and saved beside every checkpoint save. Returns the
    final state and the last batch's logs.
    """
    from seed_rl_torch.host_offpolicy import _window_means, train_owed

    n_train = num_training_envs or num_envs
    insertion_batch = learner.num_envs
    device = learner.device
    state = learner.init()
    if checkpoint is not None:
        state = checkpoint.restore_or(learner, state)
    if replay_dir is not None and replay.restore(replay_dir):
        print(f"Restored replay buffer from {replay_dir}: "
              f"{replay.num_inserted} items", flush=True)
    bridge, server = _bridge_and_server(
        agent, observation_spec, example_action, num_envs, unroll_length,
        num_overlapping_steps, inference_batch_size, server_address,
        config_push, device, seed)

    ep_stats = PerEnvEpisodeStats(num_envs)
    eval_stats = PerEnvEpisodeStats(num_envs)
    bridge.on_timesteps = episode_accounting(ep_stats, eval_stats, n_train)
    if stats_sink is not None:
        stats_sink.update(episodes=ep_stats, eval_episodes=eval_stats,
                          bridge=bridge, server=server)

    owed = 0.0
    cycles = frames = 0
    window_logs = []
    logs: Dict[str, Any] = {}
    on_unroll = getattr(learner, "on_unroll", None)
    wait_s = train_s = 0.0
    try:
        while frames < total_environment_frames:
            t0 = time.perf_counter()
            unroll = bridge.next_unroll_batch(
                insertion_batch, timeout=unroll_timeout,
                training_only_below=n_train)
            wait_s += time.perf_counter() - t0
            if on_unroll is not None:
                # Folds fresh observations into the statistics: the policy
                # changed without an optimizer step, so publish it again.
                state = on_unroll(state, unroll)
                bridge.publish()
            items, priorities = learner.make_items_and_priorities(unroll)
            replay.insert(items, priorities)
            cycles += 1
            frames += learner.frames_per_cycle

            if replay.num_inserted >= replay_buffer_min_size:
                t1 = time.perf_counter()
                state, owed, batch_logs = train_owed(
                    learner, replay, state, owed,
                    replay_ratio * insertion_batch)
                if batch_logs:
                    window_logs.extend(batch_logs)
                    logs = batch_logs[-1]
                    bridge.publish()
                train_s += time.perf_counter() - t1

            if logger is not None and cycles % log_every_cycles == 0:
                metrics = _window_means(window_logs) if window_logs else {}
                window_logs = []
                metrics.update(ep_stats.window_metrics() or {})
                metrics.update(eval_stats.window_metrics("eval_episodes")
                               or {})
                metrics["replay/num_inserted"] = replay.num_inserted
                metrics["replay/ram_gb"] = round(replay.nbytes() / 2**30, 3)
                metrics.update(_server_metrics(server))
                metrics["time/unroll_wait_s"] = wait_s
                metrics["time/train_s"] = train_s
                wait_s = train_s = 0.0
                logger.log(state.step, metrics, frames=frames)
            if checkpoint is not None:
                if checkpoint.maybe_save(state.step, learner, state):
                    if replay_dir is not None:
                        replay.save(replay_dir)
        if checkpoint is not None:
            checkpoint.maybe_save(state.step, learner, state, force=True)
            if replay_dir is not None:
                replay.save(replay_dir)
    finally:
        server.shutdown()
    return state, logs


class EpisodeReporter:
    """An actor's batched env that reports each episode it completes.

    ``report_fn(env_id, episode_return, episode_frames)`` is called with
    the return the learner's ``PerEnvEpisodeStats`` counts for the same
    transitions (float64 sums of the float32 rewards), so a fleet's
    learner-side returns can be held against the actors' own (the
    reference's actors log each episode the same way, common/actor.py).
    """

    def __init__(self, env, env_id_offset: int, report_fn):
        self.env = env
        self.num_envs = env.num_envs
        self.offset = env_id_offset
        self.report_fn = report_fn
        self.steps = 0
        self._acc = np.zeros(env.num_envs, np.float64)

    def _account(self, out: EnvOutput) -> EnvOutput:
        self._acc += np.asarray(out.reward, np.float64)
        for i in np.flatnonzero(out.done).tolist():
            self.report_fn(self.offset + i, float(self._acc[i]),
                           int(out.episode_step[i]))
            self._acc[i] = 0.0
        return out

    def reset(self) -> EnvOutput:
        self._acc[:] = 0.0
        return self._account(self.env.reset())

    def step(self, actions) -> EnvOutput:
        self.steps += 1
        return self._account(self.env.step(actions))

    def close(self):
        self.env.close()


# A pool thread's connection is made after the actor's first one, so the
# learner was up; one that cannot connect within this long found it gone.
# Every exit of the actor loop joins its pool, so this bounds how long a
# stopping actor waits for such a thread, not the first connection's wait.
POOL_CONNECT_TIMEOUT_S = 10.0


def run_actor(
    create_env_fn,
    server_address: str,
    num_steps: Optional[int] = None,
    env_id_offset: int = 0,
    timer_export_fn=None,
    max_reconnects: int = 20,
    connect_timeout: float = 120.0,
):
    """An actor process's loop: host envs and blocking socket inference.

    ``create_env_fn()`` returns a batched host env whose env ``i`` has the
    global id ``env_id_offset + i`` (the reference's env_id = task *
    env_batch_size + i, common/actor.py:77). A transport error tears down
    and rebuilds the client and the envs, the reference's reconnect loop
    (actor.py:71-74, 182-185), which also waits for a learner that has not
    bound its socket yet. Returns the env steps run. Nothing here touches
    a CUDA device.
    """
    from seed_rl_torch.runtime.actor import actor_loop
    from seed_rl_torch.runtime.transport import RemoteActorClient

    reconnects = 0
    steps_done = 0
    while True:
        try:
            client = RemoteActorClient(server_address,
                                       connect_timeout=connect_timeout)
        except OSError:  # ConnectionError included
            reconnects += 1
            if reconnects > max_reconnects:
                raise
            time.sleep(0.5)
            continue
        try:
            remaining = None if num_steps is None else num_steps - steps_done
            if remaining is not None and remaining <= 0:
                return steps_done
            # max_reconnects=0: a transport error reaches this loop, which
            # rebuilds the connection too, not only the envs.
            steps_done += actor_loop(
                create_env_fn, client, num_steps=remaining,
                env_id_offset=env_id_offset, timer_export_fn=timer_export_fn,
                max_reconnects=0,
                # Concurrent per-env calls need one connection per pool
                # thread (a SocketClient serves one call at a time).
                client_factory=lambda: RemoteActorClient(
                    server_address, connect_timeout=min(
                        connect_timeout, POOL_CONNECT_TIMEOUT_S)))
            return steps_done
        except (RuntimeError, OSError):
            reconnects += 1
            if reconnects > max_reconnects:
                raise
            time.sleep(0.5)
        finally:
            client.close()


def actor_main(create_env_fn, server_address: str,
               num_steps: Optional[int] = None, env_id_offset: int = 0):
    """An actor process: ``run_actor`` over ``create_env_fn()``'s envs.
    Prints one JSON line when SIGTERM stops it cleanly from then on
    (``actor_started``), one per episode it completes and one when it
    stops (its steps, its timings and whether CUDA was initialised).
    Returns the env steps run."""
    timers = {}
    reporters = []

    def report(env_id, episode_return, frames):
        # One write call: a SIGTERM's exit cannot cut the line in two.
        line = json.dumps({"actor_episode": {
            "env_id": env_id, "return": episode_return, "frames": frames}})
        os.write(sys.stdout.fileno(), (line + "\n").encode())

    def create():
        reporters.append(EpisodeReporter(create_env_fn(), env_id_offset,
                                         report))
        return reporters[-1]

    def stop(signum, frame):
        raise SystemExit(0)

    previous = signal.signal(signal.SIGTERM, stop)
    print(json.dumps({"actor_started": {"env_id_offset": env_id_offset,
                                        "pid": os.getpid()}}), flush=True)
    try:
        return run_actor(create, server_address, num_steps=num_steps,
                         env_id_offset=env_id_offset,
                         timer_export_fn=timers.__setitem__)
    finally:
        print(json.dumps({"actor": {
            "env_id_offset": env_id_offset,
            "num_envs": reporters[-1].num_envs if reporters else 0,
            "steps": sum(r.steps for r in reporters), **timers,
            "cuda_initialized": torch.cuda.is_initialized()}}), flush=True)
        signal.signal(signal.SIGTERM, previous)
