"""Host environments and the on-policy host data path of seed_rl_torch
against the JAX package.

Mirrors tests/test_host_envs.py:
- the action wrappers (``UniformBoundActionSpaceWrapper``,
  ``DiscretizeEnvWrapper``) pass the env the same actions as JAX's, exactly;
- ``HostBatchedEnv`` (auto-reset, ``abandoned`` from a time limit,
  ``episode_step``, a thread pool, dict observations) gives JAX's outputs
  exactly;
- ``SyntheticAtariGymEnv`` gives JAX's frames and rewards byte for byte,
  ``SyntheticFootballEnv`` JAX's frames for the same state;
- a ``HostRolloutEngine`` unroll (the overlap, the boundary step, the
  captured core state) equals JAX's from the same parameters (carried over
  with ``models/convert.py``): greedy R2D2 and deterministic V-trace
  policies, actions exactly, agent outputs and states within rtol 1e-4 /
  atol 1e-5 (convolutions sum in another order);
- ``host_learner_loop(pipeline=True)`` rolls unroll k+1 out with the
  parameters from before update k (a saved copy, not the live module);
- ``run_eval(host=True)`` gives JAX's episodes for the same parameters;
- V-trace learns the host toy env; the MuJoCo HalfCheetah wrapper stack
  gives JAX's observations; the CLI runs every agent on
  ``synthetic_atari_host`` (plain and pipelined, and eval).
"""

import math

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from seed_rl_tpu import distributions as jpd
from seed_rl_tpu.agent import PolicyAgent as JaxPolicyAgent
from seed_rl_tpu.agents import r2d2 as jax_r2d2
from seed_rl_tpu.envs import host as jax_host
from seed_rl_tpu.envs import synthetic as jax_synthetic
from seed_rl_tpu.evaluation import run_eval as jax_run_eval
from seed_rl_tpu.models import atari as jax_atari
from seed_rl_tpu.rollout_host import HostRolloutEngine as JaxHostEngine
from seed_rl_tpu.types import EnvOutput as JaxEnvOutput
from seed_rl_torch import distributions as pd
from seed_rl_torch import optim, train
from seed_rl_torch.agent import PolicyAgent
from seed_rl_torch.agents import r2d2
from seed_rl_torch.agents import vtrace as vtrace_agent
from seed_rl_torch.envs import host, synthetic
from seed_rl_torch.envs.spaces import MultiDiscrete
from seed_rl_torch.evaluation import run_eval
from seed_rl_torch.host_loop import host_learner_loop
from seed_rl_torch.models import (
    AtariPolicyNet,
    DuelingLSTMDQNNet,
    MLPPolicyNetwork,
    convert,
)
from seed_rl_torch.rollout_host import HostRolloutEngine
from seed_rl_torch.utils import episode_stats

TOL = dict(rtol=1e-4, atol=1e-5)
FRAME, A = (36, 36), 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread, so that the other test
    processes sharing the cores do not stall every op's thread barrier
    (see tests/test_torch_ppo.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class GymToyEnv(gym.Env):
    """Host twin of the toy env: match the observed random target."""

    def __init__(self, horizon=3, n_actions=3):
        self.horizon = horizon
        self.n_actions = n_actions
        self.observation_space = gym.spaces.Box(
            -np.inf, np.inf, (n_actions + 1,), np.float32)
        self.action_space = gym.spaces.Box(-1.0, 1.0, (n_actions,),
                                           np.float32)
        self._rng = np.random.RandomState(0)

    def _obs(self):
        self._target = self._rng.uniform(-1, 1, self.n_actions).astype(
            np.float32)
        return np.concatenate([self._target, [0.0]]).astype(np.float32)

    def reset(self, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self.t = 0
        return self._obs(), {}

    def step(self, action):
        reward = -float(np.sum((action - self._target) ** 2))
        self.t += 1
        return self._obs(), reward, self.t >= self.horizon, False, {}


class DictToyEnv(GymToyEnv):
    """The toy env with a dict observation (keys out of sorted order)."""

    def reset(self, seed=None, options=None):
        obs, info = super().reset(seed, options)
        return self._dict(obs), info

    def step(self, action):
        obs, *rest = super().step(action)
        return (self._dict(obs),) + tuple(rest)

    def _dict(self, obs):
        return {"z": obs[:2], "a": obs[2:].astype(np.float64)}


class FixedEnv:
    """Records the action it is given."""

    def __init__(self, low, high):
        self.observation_space = gym.spaces.Box(-1, 1, (1,), np.float32)
        self.action_space = gym.spaces.Box(np.asarray(low, np.float32),
                                           np.asarray(high, np.float32),
                                           dtype=np.float32)

    @property
    def unwrapped(self):
        return self

    def reset(self, seed=None, options=None):
        return np.zeros(1, np.float32), {}

    def step(self, action):
        self.last_action = action
        return np.zeros(1, np.float32), 0.0, False, False, {}

    def close(self):
        pass


class _GymFixed(FixedEnv, gym.Env):
    """``FixedEnv`` as a ``gym.Env``, for the JAX wrappers."""


def _last_actions(wrapped_jax, wrapped_port, actions):
    got, want = [], []
    for action in actions:
        wrapped_jax.step(np.asarray(action))
        wrapped_port.step(np.asarray(action))
        want.append(np.asarray(wrapped_jax.unwrapped.last_action))
        got.append(np.asarray(wrapped_port.unwrapped.last_action))
    return got, want


def test_uniform_bound_wrapper_matches_jax():
    low, high = [0.0, -4.0], [2.0, 4.0]
    jenv = jax_host.UniformBoundActionSpaceWrapper(_GymFixed(low, high))
    tenv = host.UniformBoundActionSpaceWrapper(FixedEnv(low, high))
    np.testing.assert_array_equal(tenv.action_space.low, -1.0)
    np.testing.assert_array_equal(tenv.action_space.high, 1.0)
    np.testing.assert_array_equal(tenv.action_space.low,
                                  jenv.action_space.low)
    tenv.reset()
    jenv.reset()
    got, want = _last_actions(jenv, tenv, [[1.0, -1.0], [0.0, 0.5],
                                           [-0.25, 0.999]])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[0], [2.0, -4.0], atol=1e-6)
    with pytest.raises(ValueError):
        tenv.step(np.array([1.5, 0.0]))


@pytest.mark.parametrize("discretization,ratio", [("lin", None),
                                                  ("log", 10.0)])
def test_discretize_wrapper_matches_jax(discretization, ratio):
    jenv = jax_host.DiscretizeEnvWrapper(_GymFixed([-1.0] * 2, [1.0] * 2), 5,
                                         discretization, action_ratio=ratio)
    tenv = host.DiscretizeEnvWrapper(FixedEnv([-1.0] * 2, [1.0] * 2), 5,
                                     discretization, action_ratio=ratio)
    assert isinstance(tenv.action_space, MultiDiscrete)
    np.testing.assert_array_equal(tenv.action_space.nvec,
                                  jenv.action_space.nvec)
    np.testing.assert_array_equal(tenv.action_set, jenv.action_set)
    got, want = _last_actions(jenv, tenv, [[0, 4], [2, 2], [4, 0], [1, 3]])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[0], [-1.0, 1.0])
    np.testing.assert_allclose(got[1], [0.0, 0.0])


def _assert_outputs_equal(got, want):
    for field in JaxEnvOutput._fields:
        g, w = getattr(got, field), getattr(want, field)
        if isinstance(w, dict):
            assert list(g) == list(w)
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
        else:
            assert np.asarray(g).dtype == np.asarray(w).dtype, field
            np.testing.assert_array_equal(g, w, err_msg=field)


@pytest.mark.parametrize("env_cls,threads", [(GymToyEnv, None),
                                             (GymToyEnv, 3),
                                             (DictToyEnv, 2)])
def test_host_batched_env_matches_jax(env_cls, threads):
    """Auto-reset, abandoned = truncated (a time limit cutting the 5-step
    episodes at 4), episode_step zeroed after a done, as JAX's."""
    def make(i):
        return gym.wrappers.TimeLimit(env_cls(horizon=5 + (i == 1) * 10),
                                      max_episode_steps=4)

    jenv = jax_host.HostBatchedEnv(make, 3, num_threads=threads)
    tenv = host.HostBatchedEnv(make, 3, num_threads=threads)
    spec = tenv.observation_spec()
    jspec = jenv.observation_spec()
    specs = ([spec[k] for k in sorted(spec)] if isinstance(spec, dict)
             else [spec])
    for s, j in zip(specs, jax.tree.leaves(jspec), strict=True):
        assert tuple(s.shape) == tuple(j.shape)
        assert torch.empty((), dtype=s.dtype).numpy().dtype == j.dtype
    _assert_outputs_equal(tenv.reset(seed=3), jenv.reset(seed=3))
    rng = np.random.RandomState(0)
    for t in range(11):
        actions = rng.uniform(-1, 1, (3, 3)).astype(np.float32)
        got, want = tenv.step(actions), jenv.step(actions)
        _assert_outputs_equal(got, want)
        if t == 3:
            assert got.done.all() and got.abandoned.all()
            np.testing.assert_array_equal(got.episode_step, 4)
    tenv.close()
    jenv.close()


def test_synthetic_atari_gym_env_matches_jax_byte_for_byte():
    jenv = jax_synthetic.SyntheticAtariGymEnv(num_actions=5,
                                              episode_length=7)
    tenv = synthetic.SyntheticAtariGymEnv(num_actions=5, episode_length=7)
    assert tenv.observation_space.shape == jenv.observation_space.shape
    assert tenv.action_space.n == jenv.action_space.n
    rng = np.random.RandomState(0)
    for seed in (0, 11):
        t_obs, _ = tenv.reset(seed=seed)
        j_obs, _ = jenv.reset(seed=seed)
        assert t_obs.dtype == np.uint8 and t_obs.tobytes() == j_obs.tobytes()
        for _ in range(9):
            action = rng.randint(0, 5)
            got, want = tenv.step(action), jenv.step(action)
            assert got[0].tobytes() == want[0].tobytes()
            assert got[1:4] == want[1:4]


def test_synthetic_football_frames_match_jax():
    tenv = synthetic.SyntheticFootballEnv()
    jenv = jax_synthetic.SyntheticFootballEnv()
    assert tuple(tenv.observation_spec().shape) == jenv.observation_spec(
    ).shape
    assert tenv.observation_spec().dtype == torch.uint16
    state = synthetic._SynthState(t=torch.tensor([0, 3, 499]),
                                  seed=torch.tensor([254, 7, 100]))
    got = tenv._obs(state)
    assert got.shape == (3, 72, 96, 1) and got.dtype == torch.uint16
    for b in range(3):
        want = jenv._obs(jax_synthetic._SynthState(
            t=jnp.int32(int(state.t[b])), seed=jnp.int32(int(state.seed[b]))))
        np.testing.assert_array_equal(got[b].to(torch.int32).numpy(),
                                      np.asarray(want).astype(np.int32))


def _frame_env(num_envs, package, episode_length=5):
    cls = (jax_synthetic if package == "jax" else synthetic
           ).SyntheticAtariGymEnv
    make = (jax_host if package == "jax" else host).HostBatchedEnv
    return make(lambda i: cls(num_actions=A, frame_shape=FRAME,
                              episode_length=episode_length + i), num_envs)


def _jax_example(num_envs):
    return (jnp.zeros((num_envs,), jnp.int32), JaxEnvOutput(
        reward=jnp.zeros((num_envs,)), done=jnp.zeros((num_envs,), bool),
        observation=jnp.zeros((num_envs,) + FRAME + (1,), jnp.uint8),
        abandoned=jnp.zeros((num_envs,), bool),
        episode_step=jnp.zeros((num_envs,), jnp.int32)))


def _r2d2_agents(num_envs):
    jnet = jax_atari.DuelingLSTMDQNNet(num_actions=A, frame_shape=FRAME,
                                       lstm_size=16)
    prev, eo = _jax_example(num_envs)
    params = jnet.init(jax.random.PRNGKey(0), prev, eo,
                       jnet.initial_state(num_envs))
    tnet = DuelingLSTMDQNNet(A, frame_shape=FRAME, lstm_size=16,
                             device="cpu")
    tnet.load_state_dict(convert.state_dict_for(
        tnet, jax.tree.map(np.asarray, params)))
    eps = np.full((num_envs,), 0.5, np.float32)
    return (jax_r2d2.R2D2Agent(jnet, jnp.asarray(eps)), params,
            r2d2.R2D2Agent(tnet, torch.from_numpy(eps)))


def _vtrace_agents(num_envs):
    jnet = jax_atari.AtariPolicyNet(parametric_distribution_param_size=A,
                                    frame_shape=FRAME, stack_size=4,
                                    lstm_size=16)
    prev, eo = _jax_example(num_envs)
    params = jnet.init(jax.random.PRNGKey(1), prev, eo,
                       jnet.initial_state(num_envs))
    tnet = AtariPolicyNet(parametric_distribution_param_size=A,
                          frame_shape=FRAME, stack_size=4, lstm_size=16,
                          device="cpu")
    tnet.load_state_dict(convert.state_dict_for(
        tnet, jax.tree.map(np.asarray, params)))
    return (JaxPolicyAgent(jnet, jpd.CategoricalDistribution(A)), params,
            PolicyAgent(tnet, pd.CategoricalDistribution(A)))


def _assert_tree_close(got, want, what):
    got = [g for g in pytree.tree_leaves(got)]
    want = [np.asarray(w) for w in jax.tree.leaves(want)]
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.detach().numpy()
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=f"{what} leaf {i}")
        else:
            np.testing.assert_allclose(g, w, **TOL,
                                       err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("agents,overlap", [(_r2d2_agents, 2),
                                            (_vtrace_agents, 0)])
def test_host_unroll_matches_jax(agents, overlap):
    """Two consecutive [o+T+1, B] unrolls from the same parameters, with
    episodes ending inside them: actions exactly, outputs and the stored
    core states within tolerance, the boundary shared."""
    B, T = 3, 5
    jagent, params, tagent = agents(B)
    jengine = JaxHostEngine(_frame_env(B, "jax"), jagent, T,
                            num_overlapping_steps=overlap,
                            deterministic=True)
    tengine = HostRolloutEngine(_frame_env(B, "torch"), tagent, T,
                                num_overlapping_steps=overlap,
                                device="cpu", deterministic=True)
    jstate = jengine.init(params, jax.random.PRNGKey(0))
    tstate = tengine.init()
    unrolls = []
    for _ in range(2):
        jstate, junroll = jengine.rollout(params, jstate)
        tstate, tunroll = tengine.rollout(tstate)
        assert tunroll.timesteps.env_output.reward.shape == (overlap + T + 1,
                                                             B)
        np.testing.assert_array_equal(
            tunroll.timesteps.agent_output.action.numpy(),
            np.asarray(junroll.timesteps.agent_output.action))
        _assert_tree_close(tunroll.timesteps, junroll.timesteps, "timesteps")
        _assert_tree_close(tunroll.agent_state, junroll.agent_state,
                           "stored core state")
        unrolls.append(tunroll)
    assert bool(unrolls[0].timesteps.env_output.done.any())
    for a, b in zip(pytree.tree_leaves(unrolls[0].timesteps),
                    pytree.tree_leaves(unrolls[1].timesteps)):
        assert torch.equal(a[-(overlap + 1):], b[:overlap + 1])


def _toy_vtrace(num_envs=16, unroll_length=10, threads=None, seed=0):
    env = host.HostBatchedEnv(lambda i: GymToyEnv(horizon=3), num_envs,
                              num_threads=threads)
    dist = pd.NormalTanhDistribution(3)
    net = MLPPolicyNetwork(parametric_distribution_param_size=dist.param_size,
                           input_size=4, mlp_sizes=(32, 32), seed=seed,
                           device="cpu")
    agent = PolicyAgent(net, dist)
    engine = HostRolloutEngine(env, agent, unroll_length, device="cpu",
                               seed=1)
    learner = vtrace_agent.VTraceLearner(
        engine, agent,
        vtrace_agent.VTraceConfig(discounting=0.9, entropy_cost=1e-3),
        lambda params: optim.ClippedAdam(params, learning_rate=3e-3),
        seed=2)
    return learner, engine


def test_pipelined_unroll_acts_with_the_parameters_before_the_update():
    """JAX's pipelining: unroll k+1 is collected with the parameters from
    before update k. Replayed from saved copies of those parameters, the
    pipelined unrolls come out bitwise; acting with the live module (the
    parameters after update k) would not."""
    learner, engine = _toy_vtrace(num_envs=4, unroll_length=3)
    unrolls, before = [], []
    rollout, update = engine.rollout, learner.update

    def recording_rollout(state):
        state, unroll = rollout(state)
        unrolls.append(unroll)
        return state, unroll

    def recording_update(state, unroll):
        before.append({k: v.clone() for k, v in
                       learner.agent.net.state_dict().items()})
        return update(state, unroll)

    engine.rollout = recording_rollout
    learner.update = recording_update
    state, _ = host_learner_loop(learner, engine, 3 * 4 * 3, pipeline=True)
    # Rollouts: p0 (first), p0 (beside update 1), p1, p2; 4 updates.
    assert state.step == 4 and len(unrolls) == 4 and len(before) == 4

    replay_learner, replay_engine = _toy_vtrace(num_envs=4, unroll_length=3)
    agent = replay_learner.agent
    host_state = None
    for k, params in enumerate([before[0], before[0], before[1], before[2]]):
        agent.net.load_state_dict(params)
        replay_engine.publish(agent)
        if host_state is None:
            host_state = replay_engine.init()
        host_state, unroll = replay_engine.rollout(host_state)
        for got, want in zip(pytree.tree_leaves(unrolls[k]),
                             pytree.tree_leaves(unroll)):
            assert torch.equal(got, want), f"unroll {k}"
    # The parameters did move: the live module would have acted otherwise.
    assert not all(torch.equal(before[0][k], before[1][k])
                   for k in before[0])


def test_host_vtrace_learns_toy_env():
    learner, engine = _toy_vtrace(num_envs=32, threads=4)
    state = learner.init()
    engine.publish()
    host_state = engine.init()

    def run(state, host_state, n):
        for _ in range(n):
            engine.publish()
            host_state, unroll = engine.rollout(host_state)
            state, _ = learner.update(state, unroll)
        return state, host_state

    state, host_state = run(state, host_state, 30)
    early = float(state.stats.sum_return) / float(state.stats.num_episodes)
    state = state._replace(stats=episode_stats.reset_window(state.stats))
    state, host_state = run(state, host_state, 250)
    state = state._replace(stats=episode_stats.reset_window(state.stats))
    state, host_state = run(state, host_state, 40)
    late = float(state.stats.sum_return) / float(state.stats.num_episodes)
    assert late > early + 1.0, (early, late)


def test_host_eval_matches_jax():
    """``run_eval(host=True)``: the deterministic policy over host envs
    reset with seed 0 + i, as JAX's."""
    B = 3
    jagent, params, tagent = _vtrace_agents(B)
    want = jax_run_eval(_frame_env(B, "jax", episode_length=4), jagent,
                        params, jax.random.PRNGKey(1234), 7,
                        unroll_length=3, host=True)
    got = run_eval(_frame_env(B, "torch", episode_length=4), tagent, 7,
                   unroll_length=3, host=True, device="cpu")
    assert got == pytest.approx(want, rel=1e-6)
    assert got["eval/num_episodes"] >= 7


def test_mujoco_halfcheetah_wrapper_stack_matches_jax():
    from seed_rl_tpu.envs import mujoco as jax_mujoco
    from seed_rl_torch.envs import mujoco

    tenv = mujoco.create_environment("HalfCheetah-v5")
    jenv = jax_mujoco.create_environment("HalfCheetah-v5")
    np.testing.assert_array_equal(tenv.action_space.low, -1.0)
    assert tenv.observation_space.dtype == np.float32
    t_obs, _ = tenv.reset(seed=0)
    j_obs, _ = jenv.reset(seed=0)
    assert t_obs.dtype == np.float32
    np.testing.assert_array_equal(t_obs, j_obs)
    rng = np.random.RandomState(0)
    for _ in range(5):
        action = rng.uniform(-1, 1, 6).astype(np.float32)
        got, want = tenv.step(action), jenv.step(action)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:4] == want[1:4]
    tenv.close()
    jenv.close()


def test_mujoco_vtrace_smoke():
    """V-trace on HalfCheetah through gymnasium, one unroll and update."""
    from seed_rl_torch.envs import mujoco

    env = host.HostBatchedEnv(
        lambda i: mujoco.create_environment("HalfCheetah-v5"), 2,
        num_threads=2)
    dist = pd.get_parametric_distribution_for_action_space(env.action_space)
    net = MLPPolicyNetwork(parametric_distribution_param_size=dist.param_size,
                           input_size=17, mlp_sizes=(16, 16), device="cpu")
    agent = PolicyAgent(net, dist)
    engine = HostRolloutEngine(env, agent, 8, device="cpu")
    learner = vtrace_agent.VTraceLearner(
        engine, agent, vtrace_agent.VTraceConfig(),
        lambda params: optim.ClippedAdam(params, learning_rate=3e-4))
    state, metrics = host_learner_loop(learner, engine, 2 * 8)
    assert state.step == 1
    assert math.isfinite(float(metrics["losses/total"]))
    env.close()


CLI = ["--env=synthetic_atari_host", "--device=cpu", "--num_envs=4",
       "--unroll_length=6", "--burn_in=2", "--n_steps=2", "--batch_size=4",
       "--replay_buffer_size=64", "--replay_buffer_min_size=8",
       "--log_every_steps=1", "--epochs_per_step=1", "--batches_per_step=2"]


@pytest.mark.parametrize("agent,flags,steps", [
    ("vtrace", [], 2),
    ("vtrace", ["--pipeline_host_rollouts"], 3),
    ("ppo", [], 2),
    ("ppo", ["--pipeline_host_rollouts"], 3),
])
def test_train_main_on_policy_host_envs(agent, flags, steps):
    """V-trace and PPO through host_learner_loop; pipelined, the last
    collected unroll is trained on too."""
    learner, state, metrics = train.main(
        [f"--agent={agent}", "--total_environment_frames=48"] + CLI + flags)
    assert learner.engine.is_host and state.rollout is None
    assert state.step == steps
    assert all(math.isfinite(float(v)) for v in metrics.values())
    assert isinstance(learner.agent.net, AtariPolicyNet)


def test_train_main_host_eval(tmp_path, capsys):
    argv = ["--agent=vtrace", f"--logdir={tmp_path}",
            "--total_environment_frames=24"] + CLI
    train.main(argv)
    capsys.readouterr()
    _, state, metrics = train.main(argv + ["--run_mode=eval",
                                           "--eval_episodes=2"])
    assert state.step == 1 and metrics["eval/restored_step"] == 1
    assert metrics["eval/num_episodes"] >= 2
    assert '"eval/restored_step": 1' in capsys.readouterr().out


@pytest.mark.parametrize("agent,flags,steps", [
    ("vtrace", [], 2),
    ("ppo", ["--epochs_per_step=1", "--batches_per_step=2"], 2),
    ("sac", ["--replay_ratio=2.0", "--batch_size=4",
             "--replay_buffer_min_size=4"], 1),
    # gym's discrete CartPole through the same adapter.
    ("r2d2", ["--env_name=CartPole-v1", "--replay_ratio=2.0",
              "--batch_size=4", "--burn_in=1", "--replay_buffer_min_size=4"],
     1),
])
def test_train_main_on_mujoco(agent, flags, steps):
    """--env=mujoco builds the gym env through gymnasium (HalfCheetah by
    default) with the JAX CLI's wrapper stack and trains every agent."""
    learner, state, metrics = train.main([
        f"--agent={agent}", "--env=mujoco", "--device=cpu", "--num_envs=2",
        "--unroll_length=4", "--total_environment_frames=16",
        "--log_every_steps=1"] + flags)
    assert state.step == steps
    assert all(math.isfinite(float(v)) for v in metrics.values())
