"""The port's pixel envs (Catch, synthetic Atari and DmLab frames).

Mirrors tests/test_catch.py's mechanics and rendering tests and
tests/test_env_adapters.py's synthetic DmLab shapes on seed_rl_torch, holds
each env's step against the JAX package's from the same state (the random
streams differ, so Catch's next ball column is carried over from JAX), and
checks that auto-reset hands the policy the next episode's first frame.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from seed_rl_tpu.envs import catch as jax_catch
from seed_rl_tpu.envs import synthetic as jax_synthetic
from seed_rl_torch.envs import (
    BatchedEnv,
    CatchEnv,
    SyntheticAtariEnv,
    SyntheticDmLabEnv,
)
from seed_rl_torch.envs.catch import CatchState
from seed_rl_torch.envs.synthetic import _SynthState


def _generator(seed=0):
    return torch.Generator().manual_seed(seed)


def test_catch_mechanics():
    env = CatchEnv(rows=5, cols=5, cell_pixels=2, balls_per_episode=2)
    g = _generator()
    state, obs = env.reset(1, g)
    assert obs.shape == (1, 10, 10, 1) and obs.dtype == torch.uint8
    # Ball starts at the top, paddle mid-bottom.
    assert int(state.ball_row) == 0
    assert int(state.paddle_col) == 2

    # Track the ball column and drive the paddle onto it: reward +1.
    for _ in range(4):  # ball reaches the bottom row after rows-1 steps
        action = torch.sign(state.ball_col - state.paddle_col) + 1
        result = env.step(state, action, g)
        state = result.state
    assert float(result.reward) == 1.0
    assert not bool(result.terminated)  # 1 of 2 balls resolved

    # Miss the next ball deliberately: reward -1 and episode end.
    for _ in range(4):
        away = 0 if int(state.ball_col) >= int(state.paddle_col) else 2
        result = env.step(state, torch.tensor([away]), g)
        state = result.state
    assert float(result.reward) == -1.0
    assert bool(result.terminated)


def test_catch_frame_renders_ball_and_paddle():
    env = CatchEnv(rows=5, cols=5, cell_pixels=3, balls_per_episode=1)
    state, obs = env.reset(1, _generator(1))
    obs = obs[0, ..., 0].numpy()
    # Exactly two cells lit (ball + paddle), each a 3x3 block of 255.
    assert (obs == 255).sum() == 2 * 9
    ball_c, paddle_c = int(state.ball_col), int(state.paddle_col)
    assert (obs[0:3, ball_c * 3:ball_c * 3 + 3] == 255).all()
    assert (obs[12:15, paddle_c * 3:paddle_c * 3 + 3] == 255).all()
    # The default grid renders at the Atari shape.
    assert CatchEnv().observation_spec().shape == (84, 84, 1)


def _jax_reset(env, B, seed):
    return jax.vmap(env.reset)(jax.random.split(jax.random.PRNGKey(seed), B))


@pytest.mark.parametrize("shape", [
    dict(rows=5, cols=4, cell_pixels=2, balls_per_episode=2),
    dict(),  # the default 12x12 grid at 7 pixels a cell: 84x84 frames
])
def test_catch_steps_match_jax_from_the_same_state(shape):
    B = 16
    jenv, tenv = jax_catch.CatchEnv(**shape), CatchEnv(**shape)
    jstate, jobs = _jax_reset(jenv, B, 0)

    def carried(js):
        return CatchState(*(torch.tensor(np.asarray(x)) for x in js[:4]))

    tstate = carried(jstate)
    np.testing.assert_array_equal(tenv._obs(tstate).numpy(), jobs)
    g = _generator()
    jstep = jax.jit(jax.vmap(jenv.step))
    actions = np.random.RandomState(1).randint(0, 3, (60, B))
    for a in actions:
        jres = jstep(jstate, jnp.asarray(a, jnp.int32))
        tres = tenv.step(tstate, torch.tensor(a), g)
        landed = np.asarray(jres.state.ball_row) == 0
        for name in ("ball_row", "paddle_col", "balls_done"):
            np.testing.assert_array_equal(
                getattr(tres.state, name).numpy(),
                np.asarray(getattr(jres.state, name)), err_msg=name)
        # Where no ball landed the column carries; elsewhere it is a draw.
        np.testing.assert_array_equal(
            tres.state.ball_col.numpy()[~landed],
            np.asarray(jres.state.ball_col)[~landed])
        np.testing.assert_array_equal(tres.reward.numpy(), jres.reward)
        np.testing.assert_array_equal(tres.terminated.numpy(),
                                      jres.terminated)
        assert not tres.abandoned.any()
        jstate = jres.state
        tstate = carried(jstate)
        np.testing.assert_array_equal(tenv._obs(tstate).numpy(),
                                      jres.observation)
    assert np.asarray(jres.terminated).any()


@pytest.mark.parametrize("jax_cls,torch_cls", [
    (jax_synthetic.SyntheticAtariEnv, SyntheticAtariEnv),
    (jax_synthetic.SyntheticDmLabEnv, SyntheticDmLabEnv),
])
def test_synthetic_steps_match_jax_from_the_same_state(jax_cls, torch_cls):
    B, length = 8, 3
    jenv, tenv = jax_cls(episode_length=length), torch_cls(episode_length=length)
    jstate, jobs = _jax_reset(jenv, B, 2)
    tstate = _SynthState(t=torch.tensor(np.asarray(jstate.t)),
                         seed=torch.tensor(np.asarray(jstate.seed)))
    np.testing.assert_array_equal(tenv._obs(tstate).numpy(), jobs)
    assert tenv.observation_spec().shape == jenv.observation_spec().shape
    assert tenv.observation_spec().dtype == torch.uint8
    assert tenv.action_space.n == jenv.action_space.n
    actions = np.random.RandomState(3).randint(0, tenv.num_actions,
                                               (length, B))
    actions[0] = np.asarray(jstate.seed) % tenv.num_actions  # some reward
    for a in actions:
        jres = jax.vmap(jenv.step)(jstate, jnp.asarray(a, jnp.int32))
        tres = tenv.step(tstate, torch.tensor(a, dtype=torch.int32),
                         _generator())
        np.testing.assert_array_equal(tres.observation.numpy(),
                                      jres.observation)
        np.testing.assert_array_equal(tres.reward.numpy(), jres.reward)
        np.testing.assert_array_equal(tres.terminated.numpy(),
                                      jres.terminated)
        np.testing.assert_array_equal(tres.state.t.numpy(), jres.state.t)
        jstate, tstate = jres.state, tres.state
    assert tres.terminated.all()


def test_synthetic_dmlab_env_shapes():
    """SyntheticDmLabEnv: 72x96x3 uint8 frames, 9 actions, frames that vary
    across channels and steps."""
    env = BatchedEnv(SyntheticDmLabEnv(), 3, device="cpu")
    assert env.observation_spec().shape == (72, 96, 3)
    assert env.action_space.n == 9
    state, out = env.reset()
    obs = out.observation
    assert obs.shape == (3, 72, 96, 3) and obs.dtype == torch.uint8
    state, out2 = env.step(state, torch.zeros(3, dtype=torch.int32))
    assert out2.observation.shape == (3, 72, 96, 3)
    assert int((out2.observation != obs).sum()) > 0
    assert (obs[:, :, :, 1].long() - obs[:, :, :, 0].long()).abs().sum() > 0


def test_catch_auto_reset_hands_over_the_next_episodes_first_frame():
    num_envs = 4
    inner = CatchEnv(rows=4, cols=5, cell_pixels=2, balls_per_episode=1)
    env = BatchedEnv(inner, num_envs, device="cpu", seed=5)
    state, out = env.reset()
    stay = torch.ones(num_envs, dtype=torch.int32)
    for t in range(1, inner.rows):  # one ball: rows-1 steps an episode
        state, out = env.step(state, stay)
        assert bool(out.done.all()) == (t == inner.rows - 1)
    assert (out.episode_step == inner.rows - 1).all()
    assert (out.reward.abs() == 1).all()
    # The observation is the post-reset frame: ball on the top row, paddle
    # back in the middle, nothing resolved, and it renders the new state.
    s = state.env_state
    assert (s.ball_row == 0).all() and (s.balls_done == 0).all()
    assert (s.paddle_col == inner.cols // 2).all()
    torch.testing.assert_close(out.observation, inner._obs(s), rtol=0, atol=0)
    assert (state.episode_step == 0).all()
    state, out = env.step(state, stay)
    assert not out.done.any() and (out.episode_step == 1).all()


def test_synthetic_auto_reset_restarts_the_frame_pattern():
    env = BatchedEnv(SyntheticAtariEnv(frame_shape=(6, 5), episode_length=2),
                     3, device="cpu", seed=1)
    state, out = env.reset()
    action = torch.zeros(3, dtype=torch.int32)
    state, out = env.step(state, action)
    assert not out.done.any()
    torch.testing.assert_close(out.observation,
                               env.env._obs(state.env_state), rtol=0, atol=0)
    state, out = env.step(state, action)
    assert out.done.all() and (state.env_state.t == 0).all()
    row = torch.arange(6, dtype=torch.int32)[None, :, None]
    want = (row + state.env_state.seed[:, None, None]) % 255
    torch.testing.assert_close(out.observation[..., 0],
                               want.to(torch.uint8).expand(-1, -1, 5),
                               rtol=0, atol=0)
