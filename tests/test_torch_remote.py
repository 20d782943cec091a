"""Remote-actor training in the port (seed_rl_torch.remote and the CLI).

- ``PerEnvEpisodeStats`` gives the JAX package's results for the same
  timesteps.
- The accounting is exact across an actor restart. The JAX remote loops
  count an episode when its unroll is trained on, and invalidate an env at
  a restart when the handler sees it: an old life's unroll still queued is
  then summed into the new life's first return. The port counts episodes
  in the handler, in arrival order (the reference's way); a test holds the
  JAX package's mixed return beside the port's exact ones.
- The remote learners of tests/test_remote_offpolicy.py with actor
  threads over the socket: R2D2 (epsilons by env id, an eval env kept out
  of the replay), SAC (continuous actions, observation statistics), PPO,
  with exact per-env returns.
- The CLI: ``--run_mode=learner`` in this process on the CPU for all four
  agents against actor processes (``remote.actor_main`` over
  synthetic_atari_host envs with short episodes; the CLI's own actor mode
  runs in tests/test_torch_imports.py), the learner's returns held against
  the actors' own printed ones; an actor killed mid-run and replaced on
  the same env ids; the refusals; the fleet launcher's command layout and
  (marked slow, as tests/test_fleet.py's is) a tiny fleet end to end.

Socket paths are short and unique; every join, wait and ``communicate``
has its own timeout.
"""

import functools
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import uuid

import jax
import numpy as np
import pytest
import torch

from seed_rl_tpu import remote as jax_remote
from seed_rl_tpu.types import EnvOutput as JaxEnvOutput
from seed_rl_torch import distributions as tpd
from seed_rl_torch import fleet, optim, remote, train
from seed_rl_torch.agent import PolicyAgent
from seed_rl_torch.agents import r2d2, sac
from seed_rl_torch.models import (
    ActorCriticMLP,
    MLPPolicyNetwork,
    VectorDuelingDQNNet,
)
from seed_rl_torch.envs.spaces import Discrete
from seed_rl_torch.replay_host import HostReplayBuffer
from seed_rl_torch.runtime.specs import array_spec
from seed_rl_torch.runtime.transport import unique_socket_path
from seed_rl_torch.types import EnvOutput
from test_torch_actor_runtime import _both_bridges

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 60


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def sock_path():
    return unique_socket_path("srt")


def _join(threads):
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "an actor hung"


def test_per_env_episode_stats_matches_jax():
    rng = np.random.default_rng(0)
    num_envs = 5
    port = remote.PerEnvEpisodeStats(num_envs)
    ref = jax_remote.PerEnvEpisodeStats(num_envs)
    for step in range(30):
        ids = rng.permutation(num_envs)[:rng.integers(1, num_envs + 1)]
        T = int(rng.integers(1, 6))
        rows = EnvOutput(
            reward=rng.normal(size=(T, len(ids))).astype(np.float32),
            done=rng.random((T, len(ids))) < 0.3,
            observation=np.zeros((T, len(ids), 2), np.float32),
            abandoned=np.zeros((T, len(ids)), bool),
            episode_step=rng.integers(1, 9, (T, len(ids))).astype(np.int32))
        port.update_batch(ids, rows)
        ref.update_batch(ids, JaxEnvOutput(*rows))
        if step % 7 == 6:
            assert port.window_metrics() == ref.window_metrics()
    np.testing.assert_array_equal(port.return_acc, ref.return_acc)
    assert {e: list(v) for e, v in port.completed_returns.items()} == {
        e: list(v) for e, v in ref.completed_returns.items()}
    port.restart([1, 3])
    assert port.return_acc[1] == port.return_acc[3] == 0.0


def _reward_rows(reward, done, step):
    return EnvOutput(reward=np.array([reward], np.float32),
                     done=np.array([done]),
                     observation=np.full((1, 4), step, np.float32),
                     abandoned=np.zeros(1, bool),
                     episode_step=np.array([step], np.int32))


def test_restart_with_a_queued_unroll_mixes_lives_in_jax_not_in_the_port():
    """One env, episodes of 3 steps. Life 1 pays 1 a step, life 2 pays 10:
    their returns are 3 and 30. Life 1 completes an unroll that waits in
    the queue, runs 2 more steps and restarts; life 2 completes an unroll.
    The JAX loop's accounting, applied as its run_remote_learner does,
    reports 31 for life 2's first episode; the port reports 3 and 30."""
    *_, jbridge, tbridge = _both_bridges(num_envs=1, unroll_length=4)
    jstats = jax_remote.PerEnvEpisodeStats(1)
    jbridge.on_unroll_lost = lambda ids: [jstats.invalidate(int(e))
                                          for e in ids]
    tstats = remote.PerEnvEpisodeStats(1)
    tbridge.on_timesteps = remote.episode_accounting(tstats)
    ids = np.array([0])
    for run_id, reward, steps in ((11, 1.0, 6), (22, 10.0, 5)):
        for t in range(steps):
            done = t > 0 and t % 3 == 0
            rows = _reward_rows(reward if t else 0.0, done, 3 if done
                                else t % 3)
            request = (np.array([run_id], np.int64), rows)
            tbridge.handler(ids, request)
            jbridge.handler(ids, (request[0], JaxEnvOutput(*rows)))
    # Life 1's unroll was queued before the restart; both bridges hold it
    # and life 2's.
    for _ in range(2):
        env_ids, unroll = jbridge.next_unroll_batch(1, timeout=5,
                                                    with_env_ids=True)
        jstats.update_batch(env_ids, jax.tree.map(
            lambda x: x[1:], unroll.timesteps.env_output))
    assert list(jstats.completed_returns[0]) == [31.0]
    assert list(tstats.completed_returns[0]) == [3.0, 30.0]


def test_next_unroll_batch_keeps_eval_envs_out():
    num_envs = 4
    seen = []
    bridge = _both_bridges(num_envs, unroll_length=2)[-1]
    rows = EnvOutput(reward=np.ones(num_envs, np.float32),
                     done=np.zeros(num_envs, bool),
                     observation=np.zeros((num_envs, 4), np.float32),
                     abandoned=np.zeros(num_envs, bool),
                     episode_step=np.zeros(num_envs, np.int32))
    for _ in range(6):  # two unrolls of every env
        bridge.handler(np.arange(num_envs),
                       (np.ones(num_envs, np.int64), rows))
    env_ids, unroll = bridge.next_unroll_batch(
        4, timeout=5, with_env_ids=True, training_only_below=3,
        excluded_sink=lambda env_id, state, ts: seen.append(env_id))
    np.testing.assert_array_equal(env_ids, [0, 1, 2, 0])
    assert seen == [3, 3]
    assert unroll.timesteps.prev_action.shape == (3, 4)
    # Envs 1 and 2's second unrolls wait; a third is not coming.
    with pytest.raises(queue.Empty):
        bridge.next_unroll_batch(3, timeout=0.2)
    np.testing.assert_array_equal(
        bridge.next_unroll_batch(2, with_env_ids=True)[0], [1, 2])


class _RewardScriptedEnvGroup:
    """Env with global id e pays e + 1 a step, episodes of 5 steps: any
    mixing of envs' accumulators would give a return of no env."""

    def __init__(self, num_envs, env_id_offset, obs_dim=3):
        self.num_envs = num_envs
        self.offset = env_id_offset
        self.obs_dim = obs_dim
        self.t = np.zeros(num_envs, np.int32)

    def reset(self):
        self.t[:] = 0
        return self._output(np.zeros(self.num_envs, np.float32))

    def _output(self, reward):
        obs = np.tile(self.t[:, None].astype(np.float32), (1, self.obs_dim))
        done = self.t >= 5
        out = EnvOutput(reward=reward, done=done.copy(), observation=obs,
                        abandoned=np.zeros(self.num_envs, bool),
                        episode_step=self.t.copy())
        self.t[done] = 0
        return out

    def step(self, actions):
        self.t += 1
        return self._output(np.arange(self.num_envs, dtype=np.float32)
                            + self.offset + 1.0)

    def close(self):
        pass


def _actor_threads(path, make_env, offsets, steps):
    """Actor threads that stop once the learner closes its socket (they
    give up their reconnects when it is gone)."""
    def run(offset):
        try:
            remote.run_actor(functools.partial(make_env, offset), path,
                             num_steps=steps, env_id_offset=offset,
                             connect_timeout=30, max_reconnects=0)
        except (RuntimeError, OSError):
            pass  # the learner is done

    threads = [threading.Thread(target=run, args=(off,), daemon=True)
               for off in offsets]
    for t in threads:
        t.start()
    return threads


def _adam(lr=1e-3):
    return functools.partial(optim.ClippedAdam, learning_rate=lr,
                             clip_norm=40.0)


def test_remote_r2d2_fleet_exact_episode_stats():
    """R2D2 served to a 2-thread actor fleet over the socket: trains from
    the replay, epsilons by env id, the eval env's experience kept out,
    exact per-env returns."""
    num_envs, num_training, unroll_length, burn_in = 4, 3, 5, 2
    path = sock_path()
    net = VectorDuelingDQNNet(4, 3, mlp_sizes=(16,), lstm_size=8,
                              hidden_size=8, device="cpu")
    epsilons = torch.cat([r2d2.training_env_epsilons(num_training),
                          torch.full((num_envs - num_training,), 1e-3)])
    agent = r2d2.R2D2Agent(net, epsilons)
    config = r2d2.R2D2Config(n_steps=2, burn_in=burn_in,
                             replay_buffer_size=64, replay_buffer_min_size=2,
                             batch_size=2, update_target_every_n_step=10)
    learner = r2d2.R2D2HostLearner(agent, config, _adam(), 2, unroll_length)
    replay = HostReplayBuffer(64, config.importance_sampling_exponent,
                              device="cpu")
    actors = _actor_threads(
        path, lambda off: _RewardScriptedEnvGroup(2, off), (0, 2), 400)
    sink = {}
    state, logs = remote.run_remote_offpolicy_learner(
        agent, learner, replay, array_spec((3,), np.float32), path,
        total_environment_frames=60, unroll_length=unroll_length,
        num_envs=num_envs, replay_ratio=1.0, replay_buffer_min_size=2,
        example_action=np.zeros((), np.int32),
        num_training_envs=num_training, num_overlapping_steps=burn_in,
        unroll_timeout=60.0, stats_sink=sink)
    _join(actors)
    assert state.step > 0 and np.isfinite(float(logs["losses/td"]))
    assert replay.num_inserted >= 2
    recorded = {e: list(v) for e, v in sink["episodes"].completed_returns
                .items() if v}
    assert recorded, "no training episodes recorded"
    for e, returns in recorded.items():
        assert e < num_training
        np.testing.assert_array_equal(returns, 5.0 * (e + 1))
    for e, returns in sink["eval_episodes"].completed_returns.items():
        assert e >= num_training
        np.testing.assert_array_equal(list(returns), 5.0 * (e + 1))
    # 6 cycles of an insertion batch of 2 training-env unrolls.
    assert replay.num_inserted == 12


class _ContinuousScriptedEnvGroup:
    """Continuous actions (2 dims), reward 1 a step, episodes of 4."""

    def __init__(self, num_envs, obs_dim=3, act_dim=2):
        self.num_envs, self.obs_dim, self.act_dim = num_envs, obs_dim, act_dim
        self.t = np.zeros(num_envs, np.int32)

    def reset(self):
        self.t[:] = 0
        return self._output(np.zeros(self.num_envs, np.float32))

    def _output(self, reward):
        obs = np.tile(self.t[:, None].astype(np.float32), (1, self.obs_dim))
        done = self.t >= 4
        out = EnvOutput(reward=reward, done=done.copy(), observation=obs,
                        abandoned=np.zeros(self.num_envs, bool),
                        episode_step=self.t.copy())
        self.t[done] = 0
        return out

    def step(self, actions):
        assert actions.shape == (self.num_envs, self.act_dim), actions.shape
        assert actions.dtype == np.float32
        self.t += 1
        return self._output(np.ones(self.num_envs, np.float32))

    def close(self):
        pass


def test_remote_sac_learner_with_actor_threads():
    """SAC to an external fleet: continuous actions over the wire, the
    uniform host replay, replay ratio 4, observation statistics folded
    and published (reference sac/learner.py:539-556)."""
    num_envs, unroll_length, act_dim = 2, 4, 2
    path = sock_path()
    dist = tpd.NormalTanhDistribution(act_dim)
    net = ActorCriticMLP(dist.param_size, array_spec((3,), np.float32),
                         n_critics=2, mlp_sizes=(16,), device="cpu")
    agent = sac.SACAgent(net, dist, 3)
    config = sac.SACConfig(batch_size=2, replay_buffer_size=64,
                           replay_buffer_min_size=2,
                           unroll_length=unroll_length, polyak=0.99)
    learner = sac.SACHostLearner(agent, config, _adam(), 1, unroll_length)
    replay = HostReplayBuffer(64, 0.0, device="cpu")
    actors = _actor_threads(
        path, lambda off: _ContinuousScriptedEnvGroup(num_envs), (0,), 300)
    sink = {}
    state, logs = remote.run_remote_offpolicy_learner(
        agent, learner, replay, array_spec((3,), np.float32), path,
        total_environment_frames=6 * unroll_length, unroll_length=4,
        num_envs=num_envs, replay_ratio=4.0, replay_buffer_min_size=2,
        example_action=np.zeros((act_dim,), np.float32),
        unroll_timeout=60.0, stats_sink=sink)
    _join(actors)
    assert state.step > 0 and np.isfinite(float(logs["losses/total"]))
    # The last publish came after the last update and statistics fold:
    # the bridge's next batch acts with both.
    copy = sink["bridge"].behaviour
    copy.refresh()
    for got, want in zip(copy.agent.net.parameters(),
                         agent.net.parameters()):
        assert torch.equal(got, want)
    assert agent.obs_norm.steps > 0
    for got, want in zip(copy.agent.obs_norm, agent.obs_norm):
        assert torch.equal(got, want)
    returns = [r for v in sink["episodes"].completed_returns.values()
               for r in v]
    assert returns and all(r == 4.0 for r in returns)


def test_remote_ppo_learner_with_actor_threads():
    """PPO to external actors (reference policy_gradient
    learner.py:1114-1121): the full epochs x minibatch pass on each batch
    of streamed unrolls, exact per-env returns."""
    from seed_rl_torch.agents.ppo import policy_losses
    from seed_rl_torch.agents.ppo.generalized_onpolicy_loss import (
        GeneralizedOnPolicyLoss,
    )
    from seed_rl_torch.agents.ppo.learner import PPOConfig, PPOLearner
    from seed_rl_torch.agents.ppo.policy_regularizers import (
        KLPolicyRegularizer,
    )
    from seed_rl_torch.ops.advantages import GAE
    from seed_rl_torch.ops.popart import PopArt
    from seed_rl_torch.ops.running_statistics import AverageMeanStd
    from seed_rl_torch.rollout_host import HostRolloutEngine

    num_envs, unroll_length = 4, 4
    path = sock_path()
    dist = tpd.CategoricalDistribution(4)
    agent = PolicyAgent(MLPPolicyNetwork(dist.param_size, 3, mlp_sizes=(16,),
                                         device="cpu"), dist)
    loss = GeneralizedOnPolicyLoss(
        agent=agent,
        reward_normalizer=PopArt(AverageMeanStd(), compensate=False),
        parametric_action_distribution=dist,
        advantage_estimator=GAE(lambda_=0.95),
        policy_loss=policy_losses.ppo(epsilon=0.2), discount_factor=0.99,
        regularizer=KLPolicyRegularizer(entropy=0.01), baseline_cost=1.0)
    obs_spec = array_spec((3,), np.float32)
    engine = HostRolloutEngine(
        remote.SpecHostEnv(obs_spec, Discrete(4), num_envs), agent,
        unroll_length, device="cpu")
    learner = PPOLearner(engine, agent, loss,
                         PPOConfig(epochs_per_step=2, batch_mode="shuffle",
                                   batches_per_step=2), _adam())
    actors = _actor_threads(
        path, lambda off: _RewardScriptedEnvGroup(2, off), (0, 2), 200)
    sink = {}
    state, metrics = remote.run_remote_learner(
        agent, learner, obs_spec, path,
        total_environment_frames=num_envs * unroll_length * 4,
        unroll_length=unroll_length, num_envs=num_envs, stats_sink=sink)
    _join(actors)
    assert state.step == 4
    assert learner.optimizer.count == 4 * 2 * 2
    assert all(np.isfinite(float(v)) for v in metrics.values())
    recorded = sink["episodes"].completed_returns
    assert recorded
    for e, returns in recorded.items():
        np.testing.assert_array_equal(list(returns), 5.0 * (e + 1))


# --- The CLI: a learner in this process, actor processes. ---------------

EPISODE = 9  # the actors' synthetic_atari_host episode length
# An actor process: ``remote.actor_main`` over synthetic_atari_host envs
# whose episodes last EPISODE steps; argv: address, env id offset, envs.
ACTOR = f"""
import sys
from seed_rl_torch.envs.host import HostBatchedEnv
from seed_rl_torch.envs.synthetic import SyntheticAtariGymEnv
from seed_rl_torch.remote import actor_main
envs = int(sys.argv[3])
actor_main(lambda: HostBatchedEnv(
               lambda i: SyntheticAtariGymEnv(episode_length={EPISODE}),
               envs, num_threads=envs),
           sys.argv[1], env_id_offset=int(sys.argv[2]))
"""


def _common_flags(agent, path):
    return [f"--agent={agent}", "--env=synthetic_atari_host",
            f"--server_address={path}", "--unroll_length=6", "--burn_in=2",
            "--n_steps=2", "--batch_size=4", "--replay_buffer_size=64",
            "--replay_buffer_min_size=4", "--epochs_per_step=1",
            "--batches_per_step=2"]


def _start_actor(path, offset, envs=2):
    """An actor process, its output in a file beside the socket."""
    cmd = [sys.executable, "-c", ACTOR, path, str(offset), str(envs)]
    out = path + f".{offset}.{uuid.uuid4().hex[:4]}.out"
    with open(out, "w") as stdout:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=stdout,
                                stderr=subprocess.PIPE, text=True,
                                env={**os.environ, "PYTHONPATH": ROOT})
    proc.out = out
    return proc


def _actor_output(proc, signum=signal.SIGTERM):
    """Stops an actor (SIGTERM once it prints that it can stop cleanly, or
    SIGKILL) and parses its lines: (episodes by env id, the final record
    or None when it was killed)."""
    deadline = time.time() + 120
    while signum == signal.SIGTERM and proc.poll() is None and (
            time.time() < deadline):
        with open(proc.out) as f:
            if "actor_started" in f.readline():
                break
        time.sleep(0.05)
    if proc.poll() is None:
        proc.send_signal(signum)
    _, err = proc.communicate(timeout=60)
    with open(proc.out) as f:
        lines = f.read().splitlines()
    os.unlink(proc.out)
    episodes, final = {}, None
    for line in lines:
        record = json.loads(line)
        if "actor_episode" in record:
            ep = record["actor_episode"]
            assert ep["frames"] == EPISODE
            episodes.setdefault(ep["env_id"], []).append(ep["return"])
        elif "actor" in record:
            final = record["actor"]
    if signum == signal.SIGTERM:
        assert proc.returncode == 0, err
        assert final is not None and final["cuda_initialized"] is False
    return episodes, final


def _prefix_per_life(returns, lives):
    """How many of each actor life's returns ``returns`` holds, when it is,
    life by life in order, all of that life's returns or all but the last
    (whose done-carrying request may not have been served); else None."""
    if not lives:
        return [] if not returns else None
    life = lives[0]
    for k in (len(life), len(life) - 1):
        if k >= 0 and returns[:k] == life[:k]:
            rest = _prefix_per_life(returns[k:], lives[1:])
            if rest is not None:
                return [k] + rest
    return None


def _learner_stats(monkeypatch):
    made = []
    init = remote.PerEnvEpisodeStats.__init__

    def record(self, num_envs, keep_last=16):
        init(self, num_envs, keep_last=1000)
        made.append(self)

    monkeypatch.setattr(remote.PerEnvEpisodeStats, "__init__", record)
    return made


def test_pool_threads_connect_within_a_bounded_timeout(monkeypatch):
    """The actor's first client waits connect_timeout for the learner; a
    pool thread's client, made once the learner was up, waits at most
    POOL_CONNECT_TIMEOUT_S: a learner gone by then must not hold a stopping
    actor, whose loop joins its pool, for the whole connect_timeout."""
    from seed_rl_torch.runtime import actor, transport

    timeouts = []

    class Client:
        def __init__(self, address, connect_timeout):
            timeouts.append(connect_timeout)

        def close(self):
            pass

    def loop(create_env_fn, client, client_factory, **kwargs):
        client_factory()
        return 1

    monkeypatch.setattr(transport, "RemoteActorClient", Client)
    monkeypatch.setattr(actor, "actor_loop", loop)
    assert remote.run_actor(None, "unused", connect_timeout=120.0) == 1
    assert timeouts == [120.0, remote.POOL_CONNECT_TIMEOUT_S]
    assert remote.POOL_CONNECT_TIMEOUT_S <= 10.0
    timeouts.clear()
    remote.run_actor(None, "unused", connect_timeout=0.2)
    assert timeouts == [0.2, 0.2]


@pytest.mark.parametrize("agent", ["vtrace", "ppo", "r2d2", "sac"])
def test_cli_learner_and_actor_processes(agent, monkeypatch):
    path = sock_path()
    stats = _learner_stats(monkeypatch)
    actors = [_start_actor(path, 2 * k) for k in range(2)]
    try:
        learner, state, metrics = train.main(
            ["--run_mode=learner", "--device=cpu", "--num_envs=4",
             "--total_environment_frames=96", *_common_flags(agent, path)])
    finally:
        results = [_actor_output(p) for p in actors]
    assert all(np.isfinite(float(v)) for v in metrics.values())
    if agent in ("vtrace", "ppo"):
        assert state.step == 4  # 96 frames of 4 envs x 6 steps
    else:
        # Insertion batches of 4 / ratio 0.75 -> 5 unrolls; 96 frames ->
        # 4 cycles; a batch is owed once 4 items are in.
        assert state.step >= 1
    # Any envs' unrolls fill a batch: a slow actor may not have stepped.
    assert sum(final["steps"] for _, final in results) > 0
    assert any("actor/elapsed_inference_s" in final for _, final in results)
    actor_returns = {e: r for episodes, _ in results
                     for e, r in episodes.items()}
    learner_returns = {e: list(v) for e, v in
                       stats[0].completed_returns.items()}
    assert learner_returns and set(learner_returns) <= set(actor_returns)
    for e, returns in learner_returns.items():
        assert _prefix_per_life(returns, [actor_returns[e]]) is not None, (
            e, returns, actor_returns[e])


def test_cli_r2d2_learner_goes_on_when_an_actor_is_replaced(monkeypatch):
    """An actor process is killed after the learner's first insert and
    replaced on the same env ids; the learner trains on, omits the
    episodes the killed actor was running, and its returns equal the
    actors' own, life by life."""
    path = sock_path()
    stats = _learner_stats(monkeypatch)
    actors = [_start_actor(path, 2 * k) for k in range(2)]
    first_insert = threading.Event()
    # The learner holds its later inserts until the handler has counted an
    # episode of the replacement's, so that it is still serving then.
    replacement_started = threading.Event()
    replacement_counted = threading.Event()
    accounting = remote.episode_accounting

    def watched_accounting(*args, **kwargs):
        hook = accounting(*args, **kwargs)
        restarted_seen = set()

        def on_timesteps(env_ids, env_output, restarted):
            if replacement_started.is_set():
                restarted_seen.update(int(e) for e in restarted if e < 2)
            hook(env_ids, env_output, restarted)
            done = set(env_ids[env_output.done].tolist())
            if done & restarted_seen:
                replacement_counted.set()

        return on_timesteps

    monkeypatch.setattr(remote, "episode_accounting", watched_accounting)
    insert = HostReplayBuffer.insert

    def watched(replay, items, priorities):
        if first_insert.is_set():
            replacement_counted.wait(timeout=120)
        first_insert.set()
        return insert(replay, items, priorities)

    monkeypatch.setattr(HostReplayBuffer, "insert", watched)
    killed = {}

    def replace_actor():
        if not first_insert.wait(timeout=120):
            return
        killed["episodes"], _ = _actor_output(actors[0], signal.SIGKILL)
        replacement_started.set()
        actors.append(_start_actor(path, 0))

    replacer = threading.Thread(target=replace_actor)
    replacer.start()
    try:
        learner, state, metrics = train.main(
            ["--run_mode=learner", "--device=cpu", "--num_envs=4",
             "--total_environment_frames=300",
             *_common_flags("r2d2", path)])
    finally:
        _join([replacer])
        results = [_actor_output(p) for p in actors[1:]]
    assert actors[0].returncode == -signal.SIGKILL
    assert replacement_counted.is_set()
    assert state.step > 1
    survivor, replacement = results[0][0], results[1][0]
    assert replacement, "the replacement actor completed no episode"
    learner_returns = {e: list(v) for e, v in
                       stats[0].completed_returns.items()}
    from_replacement = 0
    for e in (0, 1):
        lives = [killed["episodes"].get(e, []), replacement.get(e, [])]
        counts = _prefix_per_life(learner_returns.get(e, []), lives)
        assert counts is not None, (e, learner_returns.get(e), lives)
        from_replacement += counts[1]
    assert from_replacement > 0
    for e in (2, 3):
        assert _prefix_per_life(learner_returns[e], [survivor[e]]) is not None


@pytest.mark.parametrize("flags", [["--run_mode=learner", "--env=toy"],
                                   ["--run_mode=actor", "--env=catch"]])
def test_cli_refuses_the_remote_modes_on_device_envs(flags):
    with pytest.raises(NotImplementedError, match="serves host envs"):
        train.main(["--agent=vtrace", "--device=cpu", *flags])


@pytest.mark.parametrize("flags, match", [
    (["--env=synthetic_atari_host", "--env_id_offset=4"], "env_id_offset"),
    (["--env=synthetic_atari_host", "--inference_batch_size=8"],
     "inference_batch_size"),
    (["--env=synthetic_atari_host", "--server_address=/tmp/x.sock"],
     "server_address"),
    (["--env=synthetic_atari_host", "--run_mode=learner",
      "--pipeline_host_rollouts"], "pipeline_host_rollouts"),
])
def test_cli_refuses_remote_flags_it_would_not_read(flags, match):
    with pytest.raises(ValueError, match=match):
        train.main(["--agent=vtrace", "--device=cpu", *flags])


def test_actor_mode_needs_no_device(monkeypatch):
    """The actor path resolves no device: it runs where torch sees no card
    and --device names one (the learner's flags pass through)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = sock_path()
    monkeypatch.setattr(remote, "run_actor", functools.partial(
        remote.run_actor, connect_timeout=0.2, max_reconnects=0))
    handler = signal.getsignal(signal.SIGTERM)
    with pytest.raises(OSError):  # no learner: the connect gives up
        train.main(["--run_mode=actor", "--agent=vtrace",
                    "--env=synthetic_atari_host", "--num_envs=1",
                    f"--server_address={path}", "--device=cuda"])
    assert signal.getsignal(signal.SIGTERM) is handler


def test_fleet_command_layout():
    args = fleet.parse_args(["--agent=vtrace", "--env=synthetic_atari_host",
                             "--workers=2", "--actors_per_worker=3",
                             "--envs_per_actor=4",
                             "--server_address=/tmp/x.sock", "--",
                             "--unroll_length=7"])
    learner = fleet._learner_cmd(args, 2 * 3 * 4)
    assert learner[1:3] == ["-m", "seed_rl_torch.train"]
    assert "--run_mode=learner" in learner
    assert "--num_envs=24" in learner
    assert "--unroll_length=7" in learner
    # Actor task k steps envs [k * envs_per_actor, (k + 1) *
    # envs_per_actor), the reference's env_id = task * env_batch_size + i.
    actor5 = fleet._actor_cmd(args, task=5)
    assert actor5[1:3] == ["-m", "seed_rl_torch.train"]
    assert "--run_mode=actor" in actor5
    assert "--num_envs=4" in actor5
    assert "--env_id_offset=20" in actor5
    assert "--unroll_length=7" in actor5


@pytest.mark.slow
def test_tiny_fleet_end_to_end(tmp_path):
    path = sock_path()
    proc = subprocess.run(
        [sys.executable, "-m", "seed_rl_torch.fleet", "--agent=vtrace",
         "--env=synthetic_atari_host", "--workers=1",
         "--actors_per_worker=2", "--envs_per_actor=2",
         f"--logdir={tmp_path}", f"--server_address={path}", "--",
         "--device=cpu", "--unroll_length=5",
         "--total_environment_frames=60"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=420)
    out = proc.stdout.decode()
    assert proc.returncode == 0, out
    assert "learner exited rc=0" in out, out
