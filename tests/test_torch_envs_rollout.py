"""The port's tensor envs, auto-reset batching and rollout engine.

Mirrors tests/test_envs_rollout.py (auto-reset and step counts, time-limit
abandonment, unroll shapes, the +1 boundary and burn-in overlaps, the
stored first-step core state, the first unroll starting at reset) on
seed_rl_torch, and holds the toy envs' dynamics against the JAX package
given the same targets (the random streams differ).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from seed_rl_tpu.envs import toy as jax_toy
from seed_rl_tpu.rollout import _zero_action_for_space as jax_zero_action
from seed_rl_torch import distributions as pd
from seed_rl_torch.agent import PolicyAgent
from seed_rl_torch.envs import BatchedEnv, TimeLimit, ToyEnv, ToyMemoryEnv
from seed_rl_torch.envs import toy as torch_toy
from seed_rl_torch.models import MLPAndLSTM
from seed_rl_torch.rollout import RolloutEngine, zero_action_for_space


def _make_engine(num_envs=4, unroll_length=5, overlap=0, horizon=3, seed=0):
    env = BatchedEnv(ToyEnv(horizon=horizon), num_envs, device="cpu",
                     seed=seed)
    dist = pd.NormalTanhDistribution(3)
    net = MLPAndLSTM(dist.param_size, 4, mlp_sizes=(16,), lstm_sizes=(8,),
                     seed=1, device="cpu")
    return RolloutEngine(
        env, PolicyAgent(net, dist), unroll_length,
        num_overlapping_steps=overlap, seed=seed,
    )


def test_batched_env_auto_resets_and_counts_steps():
    num_envs, horizon = 3, 4
    env = BatchedEnv(ToyEnv(horizon=horizon), num_envs, device="cpu")
    state, out = env.reset()
    assert not out.done.any()
    for t in range(1, horizon + 1):
        state, out = env.step(state, torch.zeros(num_envs, 3))
        if t < horizon:
            assert not out.done.any()
            assert (out.episode_step == t).all()
        else:
            assert out.done.all()
            # Episode step on the done transition is the episode length.
            assert (out.episode_step == horizon).all()
    # Next step starts a new episode.
    state, out = env.step(state, torch.zeros(num_envs, 3))
    assert (out.episode_step == 1).all()
    assert not out.done.any()


def test_time_limit_abandons():
    env = BatchedEnv(TimeLimit(ToyEnv(horizon=100), 5), 2, device="cpu")
    state, out = env.reset()
    for _ in range(5):
        assert not out.done.any()
        state, out = env.step(state, torch.zeros(2, 3))
    assert out.done.all()
    assert out.abandoned.all()


def test_rollout_shapes_and_boundary_overlap():
    T, B = 5, 4
    engine = _make_engine(num_envs=B, unroll_length=T)
    state = engine.init()
    state, unroll1 = engine.rollout(state)
    state, unroll2 = engine.rollout(state)
    ts = unroll1.timesteps
    assert ts.env_output.observation.shape == (T + 1, B, 4)
    assert ts.agent_output.action.shape == (T + 1, B, 3)
    assert ts.agent_output.policy_logits.shape == (T + 1, B, 6)
    # Boundary: last timestep of unroll k == first timestep of unroll k+1.
    for leaf1, leaf2 in zip(
        jax.tree.leaves(unroll1.timesteps), jax.tree.leaves(unroll2.timesteps)
    ):
        torch.testing.assert_close(leaf1[-1], leaf2[0], rtol=0, atol=0)


def test_rollout_burn_in_overlap():
    T, B, o = 6, 2, 2
    engine = _make_engine(num_envs=B, unroll_length=T, overlap=o)
    state = engine.init()
    state, unroll1 = engine.rollout(state)
    state, unroll2 = engine.rollout(state)
    assert unroll1.timesteps.env_output.reward.shape == (o + T + 1, B)
    # Last o+1 timesteps of unroll k == first o+1 of unroll k+1.
    for leaf1, leaf2 in zip(
        jax.tree.leaves(unroll1.timesteps), jax.tree.leaves(unroll2.timesteps)
    ):
        torch.testing.assert_close(
            leaf1[-(o + 1):], leaf2[: o + 1], rtol=0, atol=0
        )


@pytest.mark.parametrize("overlap", [0, 2])
def test_rollout_unroll_agent_state_matches_boundary(overlap):
    """The stored core state must reproduce the unroll's agent outputs."""
    T, B = 4, 3
    engine = _make_engine(num_envs=B, unroll_length=T, overlap=overlap,
                          horizon=2)
    state = engine.init()
    for _ in range(3):
        state, unroll = engine.rollout(state)
        ts = unroll.timesteps
        with torch.no_grad():
            (logits, baseline), _ = engine.agent.unroll(
                ts.prev_action, ts.env_output, unroll.agent_state
            )
        torch.testing.assert_close(
            logits, ts.agent_output.policy_logits, rtol=1e-5, atol=1e-5
        )
        torch.testing.assert_close(
            baseline, ts.agent_output.baseline, rtol=1e-5, atol=1e-5
        )


def test_rollout_first_unroll_starts_at_reset():
    T, B = 3, 2
    engine = _make_engine(num_envs=B, unroll_length=T, horizon=50)
    state, unroll = engine.rollout(engine.init())
    # First timestep of the first unroll is the reset transition:
    # zero prev_action, zero reward, done=False, episode_step 0.
    ts = unroll.timesteps
    assert (ts.prev_action[0] == 0).all()
    assert (ts.env_output.reward[0] == 0).all()
    assert not ts.env_output.done[0].any()
    assert (ts.env_output.episode_step[0] == 0).all()
    for leaf in jax.tree.leaves(unroll.agent_state):
        assert (leaf == 0).all()


def test_rollout_is_reproducible_from_seeds():
    a = _make_engine(seed=3)
    b = _make_engine(seed=3)
    _, ua = a.rollout(a.init())
    _, ub = b.rollout(b.init())
    for x, y in zip(jax.tree.leaves(ua), jax.tree.leaves(ub)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_rollout_rejects_overlap_not_below_unroll_length():
    with pytest.raises(ValueError):
        _make_engine(unroll_length=3, overlap=3)


def test_toy_env_dynamics_match_jax_given_targets():
    B, horizon = 6, 3
    jenv = jax_toy.ToyEnv(horizon=horizon)
    jstate, jobs = jax.vmap(jenv.reset)(
        jax.random.split(jax.random.PRNGKey(0), B)
    )
    tstate = torch_toy._ToyState(
        t=torch.tensor(np.asarray(jstate.t)),
        target=torch.tensor(np.asarray(jstate.target)),
    )
    np.testing.assert_allclose(
        torch_toy._with_zero_column(tstate.target).numpy(), jobs
    )
    actions = np.random.RandomState(1).uniform(-1, 1, (horizon, B, 3))
    actions = actions.astype(np.float32)
    g = torch.Generator().manual_seed(0)
    tenv = ToyEnv(horizon=horizon)
    for t in range(horizon):
        jres = jax.vmap(jenv.step)(jstate, jnp.asarray(actions[t]))
        tres = tenv.step(tstate, torch.from_numpy(actions[t]), g)
        np.testing.assert_allclose(tres.reward.numpy(), jres.reward,
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(tres.terminated.numpy(),
                                      jres.terminated)
        np.testing.assert_array_equal(tres.state.t.numpy(), jres.state.t)
        # Carry the JAX targets over so both see the same next target.
        jstate = jres.state
        tstate = tres.state._replace(
            target=torch.tensor(np.asarray(jstate.target))
        )


def test_toy_memory_env_episode_matches_jax():
    B, horizon = 4, 3
    jenv = jax_toy.ToyMemoryEnv(horizon=horizon)
    jstate, jobs = jax.vmap(jenv.reset)(
        jax.random.split(jax.random.PRNGKey(2), B)
    )
    tenv = ToyMemoryEnv(horizon=horizon)
    tstate = torch_toy._ToyMemoryState(
        t=torch.tensor(np.asarray(jstate.t)),
        memory=torch.tensor(np.asarray(jstate.memory)),
    )
    np.testing.assert_allclose(tenv._obs(tstate).numpy(), jobs)
    rng = np.random.RandomState(3)
    g = torch.Generator().manual_seed(0)
    for _ in range(2 * horizon + 1):
        action = rng.uniform(-1, 1, (B, 3)).astype(np.float32)
        jres = jax.vmap(jenv.step)(jstate, jnp.asarray(action))
        tres = tenv.step(tstate, torch.from_numpy(action), g)
        np.testing.assert_allclose(tres.reward.numpy(), jres.reward,
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tres.observation.numpy(),
                                   jres.observation)
        np.testing.assert_array_equal(tres.terminated.numpy(),
                                      jres.terminated)
        jstate, tstate = jres.state, tres.state
    assert tres.terminated.all()


def test_zero_action_matches_jax_for_spaces():
    import gymnasium as gym

    box = gym.spaces.Box(-1.0, 1.0, (3,))
    for space in [
        gym.spaces.Discrete(4),
        gym.spaces.MultiDiscrete([2, 2, 2]),
        box,
        gym.spaces.Tuple([gym.spaces.Discrete(2),
                          gym.spaces.MultiDiscrete([3, 3]), box]),
    ]:
        want = jax_zero_action(space)
        got = zero_action_for_space(space)
        assert tuple(got.shape) == want.shape, space
        assert str(got.dtype).split(".")[-1] == str(want.dtype), space
        assert (got == 0).all()


def test_auto_reset_selects_uint16_frames_bit_for_bit():
    """The synthetic Football env's uint16 frames go through the reset
    select by their int16 view (torch.where has no CUDA kernel for uint16):
    every bit pattern survives, the top bit included."""
    from seed_rl_torch.envs import core

    rng = np.random.RandomState(0)
    a = rng.randint(0, 2 ** 16, (5, 3, 2)).astype(np.uint16)
    b = rng.randint(0, 2 ** 16, (5, 3, 2)).astype(np.uint16)
    a[0, 0, 0], b[1, 0, 0] = 0xFFFF, 0x8000
    pred = np.array([True, False, True, False, False])
    got = core._tree_where(torch.from_numpy(pred),
                           {"f": torch.from_numpy(a)},
                           {"f": torch.from_numpy(b)})["f"]
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.numpy(),
                                  np.where(pred[:, None, None], a, b))
