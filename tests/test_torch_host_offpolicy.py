"""The host-RAM replay and the off-policy host data path (R2D2, SAC) of
seed_rl_torch against the JAX package.

Mirrors tests/test_host_offpolicy.py:
- ``HostReplayBuffer``: FIFO wrap-around, and the same seed and priorities
  give JAX's sampled indices and importance weights exactly (prioritized
  and uniform); priority write-back, the prefetch thread (whose error
  reaches the caller), and save / restore in the port's own format;
- the replay-ratio contract: the owed batches a cycle, with the fractional
  carry, equal JAX's counts exactly, plain and pipelined;
- ``R2D2HostLearner.make_items_and_priorities`` on a JAX host unroll (eval
  envs left out) and one ``train_on_batch`` give JAX's items exactly and
  its priorities, loss and logs within rtol 1e-4 / atol 1e-5, the
  parameters after Adam within rtol 1e-3 / atol 1e-4 (Adam's first step
  from pixels, as tests/test_torch_pixel_vtrace.py states);
  ``SACHostLearner.train_on_batch`` gives JAX's metrics and parameters
  within rtol 1e-4 / atol 1e-5 with JAX's loss noise injected;
- R2D2 end to end on ``synthetic_atari_host`` (plain and pipelined), SAC on
  gymnasium's Pendulum, and the CLI with ``--checkpoint_replay``: a resume
  restores the learner state and the replay bitwise; a dead rollout
  worker's error reaches the main thread.
"""

import functools
import math
import types

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.utils._pytree as pytree

from seed_rl_tpu import distributions as jpd
from seed_rl_tpu.agents import r2d2 as jax_r2d2
from seed_rl_tpu.agents import sac as jax_sac
from seed_rl_tpu.envs import host as jax_host
from seed_rl_tpu.envs import synthetic as jax_synthetic
from seed_rl_tpu.models import atari as jax_atari
from seed_rl_tpu.models import sac_nets as jax_sac_nets
from seed_rl_tpu.replay_host import HostReplayBuffer as JaxReplay
from seed_rl_tpu.rollout_host import HostRolloutEngine as JaxHostEngine
from seed_rl_tpu.types import EnvOutput as JaxEnvOutput
from seed_rl_torch import distributions as pd
from seed_rl_torch import host_offpolicy, optim, train
from seed_rl_torch.agents import r2d2, sac
from seed_rl_torch.envs import host, synthetic
from seed_rl_torch.envs.core import TensorSpec
from seed_rl_torch.host_offpolicy import host_offpolicy_loop
from seed_rl_torch.models import (
    ActorCriticMLP,
    AgentState,
    DuelingLSTMDQNNet,
    VisualActorCritic,
    convert,
)
from seed_rl_torch.replay_host import HostReplayBuffer
from seed_rl_torch.rollout import Timestep, Unroll
from seed_rl_torch.rollout_host import HostRolloutEngine
from seed_rl_torch.types import EnvOutput, QAgentOutput
from seed_rl_torch.utils import checkpoint as ckpt

TOL = dict(rtol=1e-4, atol=1e-5)
UPDATED_TOL = dict(rtol=1e-3, atol=1e-4)
FRAME, A, LSTM = (36, 36), 4, 16


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread, so that the other test
    processes sharing the cores do not stall every op's thread barrier
    (see tests/test_torch_ppo.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _buffers(size, beta, seed=0):
    return (HostReplayBuffer(size, beta, seed=seed, device="cpu"),
            JaxReplay(size, beta, seed=seed))


def test_host_replay_fifo_wraparound_matches_jax():
    buf, jbuf = _buffers(8, 0.6)
    for start, n in ((0, 6), (100, 4)):
        items = {"x": start + np.arange(n, dtype=np.float32)}
        np.testing.assert_array_equal(buf.insert(items, np.ones(n)),
                                      jbuf.insert(dict(items), np.ones(n)))
    assert buf.num_inserted == jbuf.num_inserted == 8
    np.testing.assert_array_equal(buf._storage[0],
                                  [102, 103, 2, 3, 4, 5, 100, 101])
    np.testing.assert_array_equal(buf._storage[0], jbuf._storage[0])


@pytest.mark.parametrize("priorities,exponent,beta", [
    ([1.0, 1.0, 8.0, 0.0], 1.0, 0.5),
    ([0.3, 2.5, 0.01, 1.7, 0.9, 4.0], 0.9, 0.6),
    ([0.0] * 5, 0.0, 0.0),
])
def test_host_replay_draws_match_jax_exactly(priorities, exponent, beta):
    """Same seed, same float64 priorities, same call order: the same
    indices and importance weights, bit for bit, and the items they name."""
    n = len(priorities)
    buf, jbuf = _buffers(8, beta, seed=1)
    items = {"x": np.arange(n, dtype=np.float32),
             "frames": np.arange(n * 6, dtype=np.uint8).reshape(n, 2, 3)}
    buf.insert(items, np.asarray(priorities))
    jbuf.insert(dict(items), np.asarray(priorities))
    for _ in range(3):
        idx, w, got = buf.sample(256, exponent, to_device=False)
        jidx, jw, want = jbuf.sample(256, exponent, device_put=False)
        np.testing.assert_array_equal(idx, jidx)
        assert w.dtype == jw.dtype == np.float32
        np.testing.assert_array_equal(w, jw)
        for k in ("x", "frames"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    if exponent:
        p = np.asarray(priorities)
        assert np.bincount(idx, minlength=n)[p == 0].sum() == 0
    # On the device: tensors of the same values.
    _, _, on_device = buf.sample(4, exponent)
    assert isinstance(on_device["frames"], torch.Tensor)
    assert on_device["frames"].dtype == torch.uint8


def test_host_replay_update_priorities_and_async():
    buf = HostReplayBuffer(4, 1.0, device="cpu")
    buf.insert({"x": np.zeros(4, np.float32)}, np.array([1.0, 1, 1, 1]))
    buf.update_priorities(np.array([0, 1, 2]), torch.zeros(3))
    buf.sample_async(64, priority_exp=1.0)
    indices, weights, _ = buf.wait_sample()
    np.testing.assert_array_equal(indices, np.full(64, 3))
    with pytest.raises(RuntimeError):
        buf.wait_sample()
    empty = HostReplayBuffer(4, 1.0, device="cpu")
    empty.sample_async(2, priority_exp=1.0)
    with pytest.raises(RuntimeError, match="prefetch") as info:
        empty.wait_sample()
    assert isinstance(info.value.__cause__, ValueError)


def test_host_replay_save_restore_roundtrip(tmp_path):
    """Contents, priorities, cursors and later FIFO behaviour survive a
    save and a restore, bitwise; the item structure comes back."""
    d = str(tmp_path / "replay")
    buf = HostReplayBuffer(8, 0.6, seed=3, device="cpu")
    items = r2d2.StoredUnroll(
        agent_state=(), prev_actions=torch.arange(6, dtype=torch.int32),
        env_outputs={"y": torch.arange(12, dtype=torch.uint8).reshape(6, 2),
                     "a": torch.ones(6)},
        agent_outputs=None)
    buf.insert(items, np.array([1.0, 2, 3, 4, 5, 6]))
    buf.update_priorities(np.array([1]), np.array([9.0]))
    buf.save(d)
    restored = HostReplayBuffer(8, 0.6, seed=3, device="cpu")
    assert restored.restore(d)
    assert restored.num_inserted == 6
    assert restored.insert_index == buf.insert_index
    for got, want in zip(restored._storage, buf._storage):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(restored._priorities, buf._priorities)
    more = r2d2.StoredUnroll((), torch.arange(4, dtype=torch.int32),
                             {"a": torch.zeros(4),
                              "y": torch.zeros((4, 2), dtype=torch.uint8)},
                             None)
    np.testing.assert_array_equal(buf.insert(more, np.ones(4)),
                                  restored.insert(more, np.ones(4)))
    for got, want in zip(restored._storage, buf._storage):
        np.testing.assert_array_equal(got, want)
    _, _, sampled = restored.sample(4, priority_exp=1.0)
    assert isinstance(sampled, r2d2.StoredUnroll)
    assert list(sampled.env_outputs) == ["a", "y"]
    # A full buffer saves every row; a crash between the renames leaves
    # the snapshot at <dir>.old, which restore falls back to.
    buf.save(d)
    import os
    os.rename(d, d + ".old")
    again = HostReplayBuffer(8, 0.6, device="cpu")
    assert again.restore(d) and again.num_inserted == 8
    with pytest.raises(ValueError):
        HostReplayBuffer(16, 0.6, device="cpu").restore(d)
    assert not HostReplayBuffer(8, 0.6, device="cpu").restore(
        str(tmp_path / "nope"))
    with pytest.raises(ValueError, match="layout"):
        restored.insert({"x": np.zeros(1)}, np.ones(1))


class _CountingEngine:
    """Stands in for the ``HostRolloutEngine``."""

    overlap = 0

    def __init__(self, num_envs, unroll_length, fail_at=None):
        self.env = types.SimpleNamespace(num_envs=num_envs)
        self.unroll_length = unroll_length
        self.rollouts = 0
        self.fail_at = fail_at

    def publish(self, agent=None):
        pass

    def init(self, seed=0):
        return None

    def rollout(self, state):
        self.rollouts += 1
        if self.rollouts == self.fail_at:
            raise OSError("env crashed")
        T, B = self.unroll_length + 1, self.env.num_envs
        env_output = EnvOutput(
            reward=torch.zeros((T, B)), done=torch.zeros((T, B), dtype=bool),
            observation=torch.zeros((T, B, 3)),
            abandoned=torch.zeros((T, B), dtype=bool),
            episode_step=torch.zeros((T, B), dtype=torch.int32))
        return state, Unroll((), Timestep(torch.zeros((T, B)), env_output,
                                          None))


class _CountingLearner:
    """One item per env; counts the batches in its state."""

    agent = None
    device = torch.device("cpu")
    priority_exponent = 0.0

    def __init__(self, num_envs, batch_size):
        self.num_training_envs = num_envs
        self.batch_size = batch_size
        self.frames_per_cycle = num_envs

    def init(self):
        return {"step": 0}

    def make_items_and_priorities(self, unroll):
        n = self.num_training_envs
        return {"x": torch.zeros((n, 2))}, torch.ones((n,))

    def train_on_batch(self, state, items, weights):
        return ({"step": state["step"] + 1}, torch.ones((self.batch_size,)),
                {"loss": torch.zeros(())})


@pytest.mark.parametrize("replay_ratio,cap,pipeline,expected", [
    # owed a cycle = ratio * 8 / 4: 1.5 carries over to 15 in 10 cycles.
    (0.75, None, False, 15),
    (1.0, None, False, 20),
    (0.25, None, False, 5),
    (1.0, 1, False, 10),
    (0.75, None, True, 15),
    (1.0, None, True, 20),
])
def test_replay_ratio_contract(replay_ratio, cap, pipeline, expected):
    """The JAX package's counts: each cycle owes replay_ratio x training
    envs / batch batches, the fraction carried in a Python float."""
    cycles, num_envs, batch = 10, 8, 4
    engine = _CountingEngine(num_envs, unroll_length=1)
    learner = _CountingLearner(num_envs, batch)
    replay = HostReplayBuffer(1024, 0.0, device="cpu")
    state, _ = host_offpolicy_loop(
        learner, engine, replay, total_environment_frames=cycles * num_envs,
        replay_ratio=replay_ratio, replay_buffer_min_size=1,
        max_train_batches_per_cycle=cap, pipeline=pipeline)
    assert state["step"] == expected
    assert replay.num_inserted == cycles * num_envs
    # The queue of one bounds the pipelined overproduction.
    assert cycles <= engine.rollouts <= cycles + (2 if pipeline else 0)


def test_a_dead_rollout_worker_fails_the_run():
    engine = _CountingEngine(8, unroll_length=1, fail_at=3)
    with pytest.raises(RuntimeError, match="worker died") as info:
        host_offpolicy_loop(
            _CountingLearner(8, 4), engine,
            HostReplayBuffer(64, 0.0, device="cpu"),
            total_environment_frames=80, replay_ratio=1.0,
            replay_buffer_min_size=1, pipeline=True)
    assert isinstance(info.value.__cause__, OSError)


def _jax_r2d2(num_envs, num_eval, target_every=1):
    env = jax_host.HostBatchedEnv(
        lambda i: jax_synthetic.SyntheticAtariGymEnv(
            num_actions=A, frame_shape=FRAME, episode_length=5 + i),
        num_envs)
    net = jax_atari.DuelingLSTMDQNNet(num_actions=A, frame_shape=FRAME,
                                      lstm_size=LSTM)
    training = num_envs - num_eval
    agent = jax_r2d2.R2D2Agent(net, jnp.concatenate(
        [jax_r2d2.training_env_epsilons(training),
         jnp.full((num_eval,), 1e-3)]))
    config = jax_r2d2.R2D2Config(
        discounting=0.9, burn_in=2, n_steps=2, batch_size=3,
        replay_buffer_size=64, replay_buffer_min_size=8,
        update_target_every_n_step=target_every, num_eval_envs=num_eval)
    engine = JaxHostEngine(env, agent, 6, num_overlapping_steps=2)
    optimizer = optax.chain(optax.clip_by_global_norm(0.05), optax.adam(1e-3))
    learner = jax_r2d2.R2D2HostLearner(agent, config, optimizer, num_envs, 6)
    return env, engine, learner, config, agent


def _t(x):
    return torch.from_numpy(np.array(x))


def _torch_items(items):
    return r2d2.StoredUnroll(
        agent_state=AgentState(*(jax.tree.map(_t, p)
                                 for p in items.agent_state)),
        prev_actions=_t(items.prev_actions),
        env_outputs=EnvOutput(*map(_t, items.env_outputs)),
        agent_outputs=QAgentOutput(*map(_t, items.agent_outputs)))


def _port_r2d2(config, num_envs, params, target_params):
    net = DuelingLSTMDQNNet(A, frame_shape=FRAME, lstm_size=LSTM,
                            device="cpu")
    net.load_state_dict(convert.state_dict_for(net, params))
    tconfig = r2d2.R2D2Config(**{
        f: getattr(config, f) for f in r2d2.R2D2Config.__dataclass_fields__})
    training = num_envs - config.num_eval_envs
    agent = r2d2.R2D2Agent(net, torch.cat([
        r2d2.training_env_epsilons(training),
        torch.full((config.num_eval_envs,), 1e-3)]))
    learner = r2d2.R2D2HostLearner(
        agent, tconfig, functools.partial(optim.ClippedAdam,
                                          learning_rate=1e-3, clip_norm=0.05),
        num_envs, 6)
    learner.target_net.load_state_dict(
        convert.state_dict_for(net, target_params))
    return learner


def test_r2d2_host_learner_matches_jax():
    """Items and initial priorities of a JAX host unroll (the eval env left
    out, B2's plain version on the CPU), then one batch of those items."""
    num_envs = 4
    env, engine, jlearner, config, _ = _jax_r2d2(num_envs, 1)
    jstate = jax.jit(jlearner.init)(
        jax.random.PRNGKey(0), engine._batch_zero_action(num_envs),
        jax.tree.map(jnp.asarray, env.reset(seed=0)))
    target = jax.jit(jlearner.init)(
        jax.random.PRNGKey(5), engine._batch_zero_action(num_envs),
        jax.tree.map(jnp.asarray, env.reset(seed=0))).params
    jstate = jstate._replace(target_params=target, step=jnp.int32(0))
    host_state = engine.init(jstate.params, jax.random.PRNGKey(1))
    host_state, junroll = engine.rollout(jstate.params, host_state)
    jitems, jpriorities = jax.jit(jlearner.make_items_and_priorities)(junroll)

    params = jax.tree.map(np.asarray, jstate.params)
    learner = _port_r2d2(config, num_envs, params,
                         jax.tree.map(np.asarray, target))
    ts = junroll.timesteps
    unroll = Unroll(
        agent_state=AgentState(*(jax.tree.map(_t, p)
                                 for p in junroll.agent_state)),
        timesteps=Timestep(_t(ts.prev_action),
                           EnvOutput(*map(_t, ts.env_output)),
                           QAgentOutput(*map(_t, ts.agent_output))))
    items, priorities = learner.make_items_and_priorities(unroll)
    assert priorities.shape == (3,) and items.prev_actions.shape == (3, 9)
    for got, want in zip(pytree.tree_leaves(items), jax.tree.leaves(jitems)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(priorities.numpy(), jpriorities, **TOL)

    weights = np.array([1.0, 0.5, 0.25], np.float32)
    jstate2, jprio, jlogs = jax.jit(jlearner.train_on_batch)(
        jstate, jitems, jnp.asarray(weights))
    state, prio, logs = learner.train_on_batch(
        learner.init(), _torch_items(jitems), torch.from_numpy(weights))
    assert state.step == int(jstate2.step) == 1
    np.testing.assert_allclose(prio.detach().numpy(), jprio, **TOL)
    assert set(logs) == set(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), **TOL,
                                   err_msg=k)
    want = convert.state_dict_for(learner.net,
                                  jax.tree.map(np.asarray, jstate2.params))
    for name, p in learner.net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   **UPDATED_TOL, err_msg=name)
    # update_target_every_n_step=1: the target took the new parameters.
    for t, p in zip(learner.target_net.parameters(),
                    learner.net.parameters()):
        assert torch.equal(t, p)


def _sac_items(rng, n, steps):
    def swap(t):
        return np.swapaxes(t, 0, 1)

    env_outputs = dict(
        reward=rng.normal(size=(steps, n)).astype(np.float32),
        done=rng.uniform(size=(steps, n)) < 0.2,
        observation=rng.normal(size=(steps, n, 5)).astype(np.float32),
        abandoned=np.zeros((steps, n), bool),
        episode_step=np.zeros((steps, n), np.int32))
    prev = rng.uniform(-0.99, 0.99, (steps, n, 2)).astype(np.float32)
    act = rng.uniform(-0.99, 0.99, (steps, n, 2)).astype(np.float32)
    return swap(prev), {k: swap(v) for k, v in env_outputs.items()}, swap(act)


def test_sac_host_learner_matches_jax():
    """One batch of JAX's SACHostLearner and the port's, the JAX loss's
    noise injected (its loss rng is split from the state's rng)."""
    B, unroll = 6, 2
    rng = np.random.RandomState(0)
    jnet = jax_sac_nets.ActorCriticMLP(4, n_critics=2, mlp_sizes=(16, 12))
    jagent = jax_sac.SACAgent(jnet, jpd.NormalTanhDistribution(2))
    config = jax_sac.SACConfig(discounting=0.9, batch_size=B, polyak=0.8,
                               target_entropy=-2.0, unroll_length=unroll)
    joptimizer = optax.chain(optax.clip_by_global_norm(5.0),
                             optax.adam(1e-3))
    jlearner = jax_sac.SACHostLearner(jagent, config, joptimizer, B, unroll)
    prev, eo, act = _sac_items(rng, B, unroll + 1)
    example_eo = JaxEnvOutput(**{k: jnp.asarray(v[:, 0])
                                 for k, v in eo.items()})
    jstate = jlearner.init(jax.random.PRNGKey(0), jnp.asarray(prev[:, 0]),
                           example_eo)
    target = jagent.init_params(jax.random.PRNGKey(4),
                                jnp.asarray(prev[:, 0]), example_eo)
    jstate = jstate._replace(target_net_params=target,
                             rng=jax.random.PRNGKey(3))
    jitems = jax_sac.StoredUnroll(
        agent_state=(), prev_actions=jnp.asarray(prev),
        env_outputs=JaxEnvOutput(**jax.tree.map(jnp.asarray, eo)),
        agent_actions=jnp.asarray(act))
    jstate2, jprio, jmetrics = jax.jit(jlearner.train_on_batch)(
        jstate, jitems, jnp.ones((B,)))

    agents = []
    for tree in (jstate.params["net"], target):
        net = ActorCriticMLP(4, TensorSpec((5,), torch.float32), n_critics=2,
                             mlp_sizes=(16, 12), device="cpu")
        net.load_state_dict(convert.state_dict_for(
            net, jax.tree.map(np.asarray, tree)))
        agents.append(sac.SACAgent(net, pd.NormalTanhDistribution(2)))
    tconfig = sac.SACConfig(discounting=0.9, batch_size=B, polyak=0.8,
                            target_entropy=-2.0, unroll_length=unroll)
    learner = sac.SACHostLearner(
        agents[0], tconfig, functools.partial(
            optim.ClippedAdam, learning_rate=1e-3, clip_norm=5.0), B, unroll)
    learner.target_agent = agents[1]
    _, loss_rng = jax.random.split(jstate.rng)
    keys = jax.random.split(loss_rng, 4)

    def normal(key, steps):
        return torch.tensor(np.asarray(
            jax.random.normal(key, (steps, B, 2), jnp.float32)))

    noise = sac.SACNoise(normal(keys[0], unroll), normal(keys[1], unroll),
                         normal(keys[2], unroll + 1),
                         normal(keys[3], unroll + 1))
    items = sac.StoredUnroll((), torch.from_numpy(prev),
                             EnvOutput(**pytree.tree_map(torch.from_numpy,
                                                         eo)),
                             torch.from_numpy(act))
    state, prio, metrics = learner.train_on_batch(
        learner.init(), items, torch.ones(B), noise=noise)
    assert state.step == int(jstate2.step) == 1
    np.testing.assert_array_equal(prio.numpy(), jprio)
    assert set(metrics) == set(jmetrics) and len(metrics) == 11
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   **TOL, err_msg=k)
    for net, tree in ((learner.net, jstate2.params["net"]),
                      (learner.target_agent.net, jstate2.target_net_params)):
        want = convert.state_dict_for(net, jax.tree.map(np.asarray, tree))
        for name, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       **TOL, err_msg=name)
    np.testing.assert_allclose(float(learner.entropy_cost.detach()),
                               float(jstate2.params["entropy_cost"]), **TOL)


def _tiny_r2d2_host(num_envs=4, num_eval=0):
    env = host.HostBatchedEnv(
        lambda i: synthetic.SyntheticAtariGymEnv(
            num_actions=A, frame_shape=FRAME, episode_length=12), num_envs)
    net = DuelingLSTMDQNNet(A, frame_shape=FRAME, stack_size=2,
                            lstm_size=LSTM, device="cpu")
    training = num_envs - num_eval
    agent = r2d2.R2D2Agent(net, torch.cat([
        r2d2.training_env_epsilons(training),
        torch.full((num_eval,), 1e-3)]))
    config = r2d2.R2D2Config(burn_in=2, n_steps=2, batch_size=4,
                             replay_buffer_size=64, replay_buffer_min_size=8,
                             update_target_every_n_step=4,
                             num_eval_envs=num_eval)
    engine = HostRolloutEngine(env, agent, 6, num_overlapping_steps=2,
                               device="cpu", seed=1)
    learner = r2d2.R2D2HostLearner(
        agent, config, functools.partial(optim.ClippedAdam,
                                         learning_rate=1e-3), num_envs, 6)
    replay = HostReplayBuffer(config.replay_buffer_size,
                              config.importance_sampling_exponent,
                              device="cpu")
    return env, engine, learner, replay


@pytest.mark.parametrize("pipeline", [False, True])
def test_r2d2_host_end_to_end(pipeline):
    """R2D2 over host envs and the host-RAM replay: only training envs
    store experience, trained priorities are written back, the parameters
    move."""
    env, engine, learner, replay = _tiny_r2d2_host(num_envs=4, num_eval=1)
    before = [p.detach().clone() for p in learner.net.parameters()]
    cycles = 8
    state, logs = host_offpolicy_loop(
        learner, engine, replay, total_environment_frames=4 * 6 * cycles,
        replay_ratio=1.0, replay_buffer_min_size=8, pipeline=pipeline)
    assert replay.num_inserted == 3 * cycles
    # 3 items a cycle, batch 4, ratio 1: from the 3rd cycle 0.75 a cycle.
    assert state.step == int(0.75 * (cycles - 2))
    assert np.isfinite(replay._priorities[:replay.num_inserted]).all()
    assert len(set(replay._priorities[:replay.num_inserted])) > 3
    assert all(math.isfinite(float(v)) for v in logs.values())
    assert not all(torch.equal(b, p) for b, p in
                   zip(before, learner.net.parameters()))
    env.close()


def test_sac_host_end_to_end_pendulum():
    """SAC over a real gym env through gymnasium (the reference's MuJoCo
    shape), replay ratio 4."""
    num_envs = 4
    env = host.HostBatchedEnv(
        lambda i: host.UniformBoundActionSpaceWrapper(gym.make(
            "Pendulum-v1")), num_envs)
    dist = pd.get_parametric_distribution_for_action_space(env.action_space)
    net = ActorCriticMLP(dist.param_size, env.observation_spec(),
                         n_critics=2, mlp_sizes=(32, 32), device="cpu")
    agent = sac.SACAgent(net, dist)
    config = sac.SACConfig(batch_size=16, replay_buffer_size=256,
                           replay_buffer_min_size=32, unroll_length=1)
    engine = HostRolloutEngine(env, agent, 1, device="cpu")
    learner = sac.SACHostLearner(agent, config, functools.partial(
        optim.ClippedAdam, learning_rate=3e-4), num_envs, 1)
    replay = HostReplayBuffer(256, 0.0, device="cpu")
    state, logs = host_offpolicy_loop(
        learner, engine, replay, total_environment_frames=40 * num_envs,
        replay_ratio=4.0, replay_buffer_min_size=32)
    assert state.step == 4 * 4 * (40 - 7) // 16
    assert replay.num_inserted == 4 * 40
    assert all(math.isfinite(float(v)) for v in logs.values())
    env.close()


CLI = ["--env=synthetic_atari_host", "--device=cpu", "--num_envs=4",
       "--unroll_length=6", "--burn_in=2", "--n_steps=2", "--batch_size=4",
       "--replay_buffer_size=64", "--replay_buffer_min_size=8",
       "--log_every_steps=2"]


@pytest.mark.parametrize("agent,flags,batches", [
    # 6 cycles of 4 items, batch 4, training from the 2nd cycle on.
    ("r2d2", ["--replay_ratio=1.0"], 5),
    ("r2d2", [], 3),  # the JAX default, 0.75 a cycle
    ("r2d2", ["--replay_ratio=1.0", "--pipeline_host_rollouts"], 5),
    ("sac", ["--replay_ratio=2.0"], 10),
    ("sac", ["--replay_ratio=2.0", "--pipeline_host_rollouts"], 10),
])
def test_train_main_off_policy_host_envs(agent, flags, batches):
    learner, state, logs = train.main(
        [f"--agent={agent}", "--total_environment_frames=144"] + CLI + flags)
    assert state.step == batches
    assert all(math.isfinite(float(v)) for v in logs.values())
    learner_type, net_type = {
        "r2d2": (r2d2.R2D2HostLearner, DuelingLSTMDQNNet),
        "sac": (sac.SACHostLearner, VisualActorCritic)}[agent]
    assert isinstance(learner, learner_type)
    assert isinstance(learner.net, net_type)


def test_train_main_checkpoint_replay_resumes_bitwise(tmp_path, monkeypatch):
    """--checkpoint_replay: the learner state and the replay restored on
    resume equal the saved ones bitwise, and no cycle is lost."""
    loops = []
    original = host_offpolicy.host_offpolicy_loop

    def recording_loop(learner, engine, replay, *args, **kwargs):
        loops.append((learner, replay))
        return original(learner, engine, replay, *args, **kwargs)

    restores = []
    restore = ckpt.CheckpointManager.restore_or

    def recording_restore(self, learner, state):
        state = restore(self, learner, state)
        restores.append(ckpt.to_saveable(learner.checkpoint_state(state)))
        return state

    monkeypatch.setattr(host_offpolicy, "host_offpolicy_loop",
                        recording_loop)
    monkeypatch.setattr(ckpt.CheckpointManager, "restore_or",
                        recording_restore)
    argv = ["--agent=r2d2", f"--logdir={tmp_path}", "--checkpoint_replay",
            "--replay_ratio=1.0", "--save_checkpoint_secs=0"] + CLI
    learner, state, _ = train.main(argv + ["--total_environment_frames=72"])
    saved = ckpt.to_saveable(learner.checkpoint_state(state))
    saved_replay = loops[0][1]
    snapshot = [s.copy() for s in saved_replay._storage]
    assert state.step == 2 and saved_replay.num_inserted == 12

    # The frame budget counts this run's cycles: one more.
    resumed, state2, _ = train.main(argv + ["--total_environment_frames=24"])
    restored = restores[1]
    for got, want in zip(pytree.tree_leaves(restored),
                         pytree.tree_leaves(saved), strict=True):
        if isinstance(want, torch.Tensor):
            assert got.dtype == want.dtype and torch.equal(got, want)
        else:
            assert got == want
    replay = loops[1][1]
    assert replay.num_inserted == 12 + 4 and replay.insert_index == 16
    for got, want in zip(replay._storage, snapshot, strict=True):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got[:12], want[:12])
    assert state2.step == 3
    # The last save holds the resumed run's replay, all of it.
    saved_again = HostReplayBuffer(64, 0.6, device="cpu")
    assert saved_again.restore(str(tmp_path / "replay"))
    for got, want in zip(saved_again._storage, replay._storage):
        np.testing.assert_array_equal(got, want)


def test_train_main_refuses_checkpoint_replay_without_logdir():
    with pytest.raises(ValueError, match="--logdir"):
        train.main(["--agent=r2d2", "--checkpoint_replay"] + CLI)
