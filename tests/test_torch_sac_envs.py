"""The SAC slice's envs in seed_rl_torch against the JAX package.

- ``BitFlippingEnv``: tests/test_envs_rollout.py's semantics test on the
  port, and steps from one state (the JAX reset's bits and goal) on the
  same actions, no-ops included: observations, rewards and terminations
  equal.
- ``ContinuousCatchEnv``: tests/test_catch.py's mechanics test on the
  port, and steps from one state on the same velocities: the float paddle
  equal within 1e-6, frames, rewards and terminations equal (the next ball
  column is a draw of each package's own stream, so it is carried over
  from JAX where a ball landed, as tests/test_torch_pixel_envs.py does).
- A dict observation rides as a tree through ``BatchedEnv`` (auto-reset),
  ``TimeLimit``, ``RolloutEngine`` and ``PrioritizedReplay``, also when
  the inserted dicts were built in another key order.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.utils._pytree as pytree

from seed_rl_tpu.envs import catch as jax_catch
from seed_rl_tpu.envs import toy as jax_toy
from seed_rl_torch import distributions as tpd
from seed_rl_torch.agents.sac import SACAgent
from seed_rl_torch.envs import (
    BatchedEnv,
    BitFlippingEnv,
    ContinuousCatchEnv,
    TimeLimit,
)
from seed_rl_torch.envs.catch import ContinuousCatchState
from seed_rl_torch.envs.toy import _BitFlippingState
from seed_rl_torch.models import ActorCriticMLP
from seed_rl_torch.replay import PrioritizedReplay
from seed_rl_torch.rollout import RolloutEngine

KEYS = ("achieved_goal", "desired_goal", "observation")


def _generator(seed=0):
    return torch.Generator().manual_seed(seed)


def _jax_reset(env, B, seed):
    return jax.vmap(env.reset)(jax.random.split(jax.random.PRNGKey(seed), B))


def _assert_obs_equal(got, want):
    assert set(got) == set(KEYS)
    for k in KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_bit_flipping_env_semantics():
    env = BitFlippingEnv(n_bits=4, horizon=6)
    state, obs = env.reset(1, _generator())
    assert obs["observation"].shape == (1, 7)
    assert obs["observation"][0, 0] == 1.0  # one_hot(t = 0)
    bits0 = obs["achieved_goal"][0].clone()
    result = env.step(state, torch.tensor([2]), _generator())  # flip bit 2
    bits1 = result.observation["achieved_goal"][0]
    assert bits1[2] == 1 - bits0[2]
    keep = [0, 1, 3]
    torch.testing.assert_close(bits1[keep], bits0[keep])
    result2 = env.step(result.state, torch.tensor([4]), _generator())  # no-op
    torch.testing.assert_close(result2.observation["achieved_goal"][0], bits1)
    mismatches = float(torch.sum(bits1 != result.observation[
        "desired_goal"][0]))
    assert float(result.reward) == max(-1.0, -mismatches)
    assert env.action_space.n == 5
    assert env.compute_reward(bits1, bits1) == 0.0


def test_bit_flipping_steps_match_jax_from_the_same_state():
    B, n_bits, horizon = 16, 5, 7
    jenv = jax_toy.BitFlippingEnv(n_bits=n_bits, horizon=horizon)
    tenv = BitFlippingEnv(n_bits=n_bits, horizon=horizon)
    jstate, jobs = _jax_reset(jenv, B, 0)
    tstate = _BitFlippingState(
        *(torch.tensor(np.asarray(x)) for x in jstate))
    _assert_obs_equal(tenv._obs(tstate), jobs)
    spec = tenv.observation_spec()
    for k, s in jenv.observation_spec().items():
        assert spec[k].shape == s.shape and spec[k].dtype == torch.float32
    jstep = jax.jit(jax.vmap(jenv.step))
    # Flips and the no-op (action n_bits), past the horizon.
    actions = np.random.RandomState(1).randint(0, n_bits + 1,
                                               (horizon + 2, B))
    for a in actions:
        jres = jstep(jstate, jnp.asarray(a, jnp.int32))
        tres = tenv.step(tstate, torch.tensor(a, dtype=torch.int32),
                         _generator())
        _assert_obs_equal(tres.observation, jres.observation)
        np.testing.assert_array_equal(tres.reward.numpy(), jres.reward)
        np.testing.assert_array_equal(tres.terminated.numpy(),
                                      jres.terminated)
        assert not tres.abandoned.any()
        jstate, tstate = jres.state, tres.state
    # Some envs reached their goal (reward 0), some did not.
    assert set(np.unique(np.asarray(jres.reward))) <= {-1.0, 0.0}


def test_bit_flipping_reset_draws_fair_bits_on_the_generator_device():
    env = BitFlippingEnv(n_bits=10)
    state, obs = env.reset(4096, _generator(3))
    for k in ("achieved_goal", "desired_goal"):
        assert set(torch.unique(obs[k]).tolist()) == {0.0, 1.0}
        assert abs(float(obs[k].mean()) - 0.5) < 0.02
    assert not torch.equal(state.bits, state.goal)
    assert int(state.t.max()) == 0


def test_continuous_catch_mechanics():
    env = ContinuousCatchEnv(rows=5, cols=5, cell_pixels=1,
                             balls_per_episode=2, max_speed=1.0)
    state, obs = env.reset(1, _generator())
    assert obs.shape == (1, 5, 5, 1) and obs.dtype == torch.uint8
    assert env.action_space.shape == (1,)
    p0 = float(state.paddle_pos)
    r = env.step(state, torch.tensor([[1.0]]), _generator())
    assert abs(float(r.state.paddle_pos) - min(p0 + 1.0, 4.0)) < 1e-6
    state, _ = env.reset(1, _generator(1))
    total = 0.0
    g = _generator(2)
    for _ in range(20):
        delta = float(state.ball_col) - float(state.paddle_pos)
        r = env.step(state, torch.tensor([[np.clip(delta, -1.0, 1.0)]]), g)
        total += float(r.reward)
        state = r.state
        if bool(r.terminated):
            break
    # 4 rows of fall at speed 1 reach any column: both balls caught.
    assert total == 2.0, total


@pytest.mark.parametrize("shape", [
    dict(rows=5, cols=4, cell_pixels=2, balls_per_episode=2),
    dict(),  # the default 12x12 grid at 7 pixels a cell: 84x84 frames
])
def test_continuous_catch_steps_match_jax_from_the_same_state(shape):
    B = 16
    jenv = jax_catch.ContinuousCatchEnv(**shape)
    tenv = ContinuousCatchEnv(**shape)
    jstate, jobs = _jax_reset(jenv, B, 0)

    def carried(js):
        return ContinuousCatchState(
            *(torch.tensor(np.asarray(x)) for x in js[:4]))

    tstate = carried(jstate)
    np.testing.assert_array_equal(tenv._obs_continuous(tstate).numpy(), jobs)
    jstep = jax.jit(jax.vmap(jenv.step))
    # Velocities past the box too, and exact half cells (rounded to even).
    velocities = np.random.RandomState(1).uniform(-1.3, 1.3, (60, B, 1))
    velocities[:3] = 1.0 / 3.0
    rewards = []
    for v in velocities.astype(np.float32):
        jres = jstep(jstate, jnp.asarray(v))
        tres = tenv.step(tstate, torch.tensor(v), _generator())
        landed = np.asarray(jres.state.ball_row) == 0
        np.testing.assert_allclose(tres.state.paddle_pos.numpy(),
                                   np.asarray(jres.state.paddle_pos),
                                   rtol=0, atol=1e-6)
        for name in ("ball_row", "balls_done"):
            np.testing.assert_array_equal(
                getattr(tres.state, name).numpy(),
                np.asarray(getattr(jres.state, name)), err_msg=name)
        np.testing.assert_array_equal(
            tres.state.ball_col.numpy()[~landed],
            np.asarray(jres.state.ball_col)[~landed])
        np.testing.assert_array_equal(tres.reward.numpy(), jres.reward)
        np.testing.assert_array_equal(tres.terminated.numpy(),
                                      jres.terminated)
        rewards.append(np.asarray(jres.reward))
        jstate = jres.state
        tstate = carried(jstate)
        np.testing.assert_array_equal(tenv._obs_continuous(tstate).numpy(),
                                      jres.observation)
    assert np.asarray(jres.terminated).any()
    assert {-1.0, 1.0} <= set(np.unique(rewards))  # misses and catches


def test_dict_observations_ride_batched_env_time_limit_rollout_and_replay():
    B, T, n_bits, horizon = 6, 5, 3, 4
    env = BatchedEnv(TimeLimit(BitFlippingEnv(n_bits, horizon), 3), B,
                     device="cpu", seed=0)
    spec = env.observation_spec()
    dist = tpd.CategoricalDistribution(n_bits + 1)
    agent = SACAgent(ActorCriticMLP(dist.param_size, spec, mlp_sizes=(8,),
                                    action_dim=1, device="cpu"), dist)
    engine = RolloutEngine(env, agent, T, seed=1)
    rollout = engine.init()
    rollout, unroll = engine.rollout(rollout)
    ts = unroll.timesteps
    obs = ts.env_output.observation
    assert isinstance(obs, dict) and set(obs) == set(KEYS)
    assert obs["achieved_goal"].shape == (T + 1, B, n_bits)
    assert obs["observation"].shape == (T + 1, B, horizon + 1)
    # The time limit (3 steps) abandons every episode at env step 3; the
    # step after it sees the next episode's first observation, t = 0.
    done = ts.env_output.done
    assert ts.env_output.abandoned.any() and torch.equal(
        done, ts.env_output.abandoned)
    torch.testing.assert_close(
        obs["observation"][done][:, 0], torch.ones(int(done.sum())))
    # The stored t counts the episode's steps.
    t = torch.argmax(obs["observation"], dim=-1)
    torch.testing.assert_close(t, ts.env_output.episode_step.long()
                               * (~done).long())

    items = pytree.tree_map(lambda x: x.transpose(0, 1),
                            (ts.prev_action, ts.env_output))
    replay = PrioritizedReplay(size=8, importance_sampling_exponent=0.0)
    state = replay.init_state(pytree.tree_map(lambda x: x[0], items))
    # The same items with the dict rebuilt in reverse key order land leaf by
    # leaf all the same.
    reordered = (items[0], items[1]._replace(observation={
        k: items[1].observation[k] for k in reversed(KEYS)}))
    state, _ = replay.insert(state, reordered, torch.ones((B,)))
    _, _, sampled = replay.sample(state, None, B, 0,
                                  indices=torch.arange(B))
    for k in KEYS:
        torch.testing.assert_close(sampled[1].observation[k],
                                   items[1].observation[k])
    torch.testing.assert_close(sampled[0], items[0])
