"""The port's Atari nets and frame stacking (seed_rl_torch.models.atari)
against the JAX package.

Frame stacking is integer work and must agree exactly. ``AtariPolicyNet``'s
flax parameters are carried over with seed_rl_torch.models.convert, and
both packages see the same numpy frames: one step from a live agent state,
and a time-major unroll with ``done`` resets inside it. Outputs and states
agree within rtol 1e-4 / atol 1e-5 (the convolutions sum in another order).
The port's folded unroll also equals stepping ``forward`` (mirroring
tests/test_env_adapters.py's step-vs-unroll test), and the stateless net
(no LSTM, one frame) folds time into batch through ``PolicyAgent``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from seed_rl_tpu import distributions as jpd
from seed_rl_tpu.agent import PolicyAgent as JaxPolicyAgent
from seed_rl_tpu.models import atari as jax_atari
from seed_rl_tpu.types import EnvOutput as JaxEnvOutput
from seed_rl_torch import distributions as tpd
from seed_rl_torch.agent import PolicyAgent
from seed_rl_torch.models import AgentState, AtariPolicyNet, convert
from seed_rl_torch.models import atari
from seed_rl_torch.types import EnvOutput

TOL = dict(rtol=1e-4, atol=1e-5)
PARAMS = 5


def _env_output(rng, lead, frame_shape, done_p=0.0):
    return dict(
        reward=rng.normal(size=lead).astype(np.float32),
        done=rng.uniform(size=lead) < done_p,
        observation=rng.randint(0, 256, lead + frame_shape + (1,)).astype(
            np.uint8),
        abandoned=np.zeros(lead, bool),
        episode_step=np.zeros(lead, np.int32),
    )


def _jax(eo):
    return JaxEnvOutput(**{k: jnp.asarray(v) for k, v in eo.items()})


def _torch(eo):
    return EnvOutput(**{k: torch.from_numpy(v) for k, v in eo.items()})


def _assert_trees_close(got, want, **tol):
    got_leaves = jax.tree.leaves(
        jax.tree.map(lambda t: t.detach().numpy(), got))
    want_leaves = jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g, np.asarray(w), **(tol or TOL))


def _random_agent_state(rng, B, frame_shape, stack_size, lstm_size):
    core = (((rng.normal(size=(B, lstm_size)).astype(np.float32),
              rng.normal(size=(B, lstm_size)).astype(np.float32)),)
            if lstm_size else ())
    frames = (rng.randint(0, 256, (B,) + frame_shape + (stack_size - 1,))
              .astype(np.uint8) if stack_size > 1 else ())
    return core, frames


def test_stack_frame_matches_jax():
    rng = np.random.RandomState(0)
    B, shape, s = 4, (6, 5), 4
    state = rng.randint(0, 256, (B,) + shape + (s - 1,)).astype(np.uint8)
    jstate, tstate = jnp.asarray(state), torch.from_numpy(state)
    for _ in range(5):
        obs = rng.randint(0, 256, (B,) + shape + (1,)).astype(np.uint8)
        done = rng.uniform(size=B) < 0.4
        jstacked, jstate = jax_atari.stack_frame(
            jnp.asarray(obs), jstate, jnp.asarray(done), s)
        tstacked, tstate = atari.stack_frame(
            torch.from_numpy(obs), tstate, torch.from_numpy(done), s)
        np.testing.assert_array_equal(tstacked.numpy(), jstacked)
        np.testing.assert_array_equal(tstate.numpy(), jstate)
    obs = torch.zeros((B,) + shape + (1,), dtype=torch.uint8)
    stacked, state = atari.stack_frame(obs, (), torch.zeros(B, dtype=bool), 1)
    assert stacked is obs and state == ()


@pytest.mark.parametrize("stack_size", [1, 2, 4])
def test_stack_frames_time_major_matches_jax_and_stepping(stack_size):
    rng = np.random.RandomState(stack_size)
    T, B, shape = 7, 3, (4, 5)
    obs = rng.randint(0, 256, (T, B) + shape + (1,)).astype(np.uint8)
    done = rng.uniform(size=(T, B)) < 0.3
    done[2, 0] = done[3, 0] = True  # back-to-back episode boundaries
    hist = (rng.randint(0, 256, (B,) + shape + (stack_size - 1,))
            .astype(np.uint8) if stack_size > 1 else ())
    jstacked, jfinal = jax_atari.stack_frames_time_major(
        jnp.asarray(obs), jax.tree.map(jnp.asarray, hist), jnp.asarray(done),
        stack_size)
    tstacked, tfinal = atari.stack_frames_time_major(
        torch.from_numpy(obs), jax.tree.map(torch.from_numpy, hist),
        torch.from_numpy(done), stack_size)
    np.testing.assert_array_equal(tstacked.numpy(), jstacked)
    _assert_trees_close(tfinal, jfinal, rtol=0, atol=0)
    # The vectorized form is stack_frame scanned over time.
    state = jax.tree.map(torch.from_numpy, hist)
    for t in range(T):
        stacked, state = atari.stack_frame(
            torch.from_numpy(obs[t]), state, torch.from_numpy(done[t]),
            stack_size)
        torch.testing.assert_close(stacked, tstacked[t], rtol=0, atol=0)
    assert jax.tree.structure(state) == jax.tree.structure(tfinal)


# (frame_shape, stack_size, lstm_size): the V-trace CLI's net (4 frames,
# LSTM) at Atari frames, the Catch learning test's, a feed-forward stack,
# one frame with an LSTM, and the stateless net.
NETS = [
    ((84, 84), 4, 24),
    ((36, 36), 2, 16),
    ((36, 36), 3, 0),
    ((36, 36), 1, 8),
    ((36, 36), 1, 0),
]


def _nets(frame_shape, stack_size, lstm_size, B=3):
    jnet = jax_atari.AtariPolicyNet(
        parametric_distribution_param_size=PARAMS, frame_shape=frame_shape,
        stack_size=stack_size, lstm_size=lstm_size)
    tnet = AtariPolicyNet(PARAMS, frame_shape=frame_shape,
                          stack_size=stack_size, lstm_size=lstm_size,
                          device="cpu")
    rng = np.random.RandomState(1)
    params = jnet.init(
        jax.random.PRNGKey(2), jnp.zeros((B,), jnp.int32),
        _jax(_env_output(rng, (B,), frame_shape)), jnet.initial_state(B))
    params = jax.tree.map(np.asarray, params)
    tnet.load_state_dict(convert.state_dict_for(tnet, params), strict=True)
    return jnet, tnet, params


@pytest.mark.parametrize("frame_shape,stack_size,lstm_size", NETS)
def test_step_matches_flax(frame_shape, stack_size, lstm_size):
    jnet, tnet, params = _nets(frame_shape, stack_size, lstm_size)
    B = 4
    rng = np.random.RandomState(5)
    eo = _env_output(rng, (B,), frame_shape, done_p=0.5)
    core, frames = _random_agent_state(rng, B, frame_shape, stack_size,
                                       lstm_size)
    jstate = jax_atari.AgentState(jax.tree.map(jnp.asarray, core),
                                  jax.tree.map(jnp.asarray, frames))
    tstate = AgentState(jax.tree.map(torch.from_numpy, core),
                        jax.tree.map(torch.from_numpy, frames))
    (jp, jb), jnew = jnet.apply(params, jnp.zeros((B,), jnp.int32), _jax(eo),
                                jstate)
    (tp, tb), tnew = tnet(torch.zeros(B, dtype=torch.int32), _torch(eo),
                          tstate)
    assert tp.shape == (B, PARAMS) and tb.shape == (B,)
    np.testing.assert_allclose(tp.detach().numpy(), jp, **TOL)
    np.testing.assert_allclose(tb.detach().numpy(), jb, **TOL)
    _assert_trees_close(tnew, jnew)


@pytest.mark.parametrize("frame_shape,stack_size,lstm_size", NETS)
def test_unroll_with_done_resets_matches_flax(frame_shape, stack_size,
                                              lstm_size):
    jnet, tnet, params = _nets(frame_shape, stack_size, lstm_size)
    T, B = 5, 3
    rng = np.random.RandomState(6)
    eo = _env_output(rng, (T, B), frame_shape, done_p=0.3)
    eo["done"][2, :2] = True  # resets inside the unroll
    prev_actions = rng.randint(0, PARAMS, (T, B)).astype(np.int32)
    core, frames = _random_agent_state(rng, B, frame_shape, stack_size,
                                       lstm_size)
    jagent = JaxPolicyAgent(jnet, jpd.CategoricalDistribution(PARAMS))
    tagent = PolicyAgent(tnet, tpd.CategoricalDistribution(PARAMS))
    jstate = jax_atari.AgentState(jax.tree.map(jnp.asarray, core),
                                  jax.tree.map(jnp.asarray, frames))
    tstate = AgentState(jax.tree.map(torch.from_numpy, core),
                        jax.tree.map(torch.from_numpy, frames))
    (jp, jb), jnew = jagent.unroll(params, jnp.asarray(prev_actions),
                                   _jax(eo), jstate)
    (tp, tb), tnew = tagent.unroll(torch.from_numpy(prev_actions),
                                   _torch(eo), tstate)
    assert tp.shape == (T, B, PARAMS) and tb.shape == (T, B)
    np.testing.assert_allclose(tp.detach().numpy(), jp, **TOL)
    np.testing.assert_allclose(tb.detach().numpy(), jb, **TOL)
    _assert_trees_close(tnew, jnew)


@pytest.mark.parametrize("stack_size,lstm_size", [(4, 16), (2, 0)])
def test_step_matches_unroll(stack_size, lstm_size):
    """Folded-torso training path == sequential step path (same module)."""
    frame_shape = (36, 36)
    net = AtariPolicyNet(PARAMS, frame_shape=frame_shape,
                         stack_size=stack_size, lstm_size=lstm_size, seed=3,
                         device="cpu")
    T, B = 6, 3
    rng = np.random.RandomState(7)
    eo = _torch(_env_output(rng, (T, B), frame_shape, done_p=0.3))
    with torch.no_grad():
        (up, ub), ustate = net.unroll(None, eo, net.initial_state(B))
        state = net.initial_state(B)
        for t in range(T):
            (p, b), state = net(None, jax.tree.map(lambda x: x[t], eo), state)
            torch.testing.assert_close(p, up[t], rtol=2e-5, atol=2e-5)
            torch.testing.assert_close(b, ub[t], rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(state, ustate, rtol=2e-5, atol=2e-5)


def test_initial_state_and_stateless_flag():
    net = AtariPolicyNet(PARAMS, stack_size=4, lstm_size=32, device="cpu")
    state = net.initial_state(5)
    assert isinstance(state, AgentState) and not net.stateless
    (c, h), = state.core_state
    assert c.shape == h.shape == (5, 32)
    assert state.frame_stacking_state.shape == (5, 84, 84, 3)
    assert state.frame_stacking_state.dtype == torch.uint8
    assert not state.frame_stacking_state.any()
    assert AtariPolicyNet(PARAMS, stack_size=1, lstm_size=0,
                          device="cpu").stateless
    assert not AtariPolicyNet(PARAMS, stack_size=2, lstm_size=0,
                              device="cpu").stateless
    assert net.torso.dense.in_features == 7 * 7 * 64  # 84x84 frames


def test_initialisation_follows_flax_conv_defaults():
    net = AtariPolicyNet(PARAMS, stack_size=4, lstm_size=16, seed=7,
                         device="cpu")
    for name, p in net.named_parameters():
        if name.endswith("bias"):
            assert torch.count_nonzero(p) == 0, name
    # lecun normal over the conv's fan-in (in * kh * kw), truncated at 2 std.
    w = net.torso.convs[1].weight.detach()
    fan_in = 32 * 4 * 4
    np.testing.assert_allclose(float(w.std()), fan_in ** -0.5, rtol=0.05)
    assert float(w.abs().max()) <= 2 * fan_in ** -0.5 / 0.8796 + 1e-6
    again = AtariPolicyNet(PARAMS, stack_size=4, lstm_size=16, seed=7,
                           device="cpu")
    torch.testing.assert_close(net.state_dict(), again.state_dict())


def test_deterministic_policy_step_takes_the_mode():
    net = AtariPolicyNet(3, frame_shape=(36, 36), stack_size=2, lstm_size=8,
                         device="cpu")
    agent = PolicyAgent(net, tpd.CategoricalDistribution(3))
    rng = np.random.RandomState(8)
    eo = _torch(_env_output(rng, (6,), (36, 36)))
    with torch.no_grad():
        out, _ = agent.policy_step(torch.zeros(6, dtype=torch.int32), eo,
                                   net.initial_state(6), deterministic=True)
    torch.testing.assert_close(out.action,
                               torch.argmax(out.policy_logits, -1).to(
                                   out.action.dtype), rtol=0, atol=0)


def test_too_small_frames_are_refused():
    with pytest.raises(ValueError, match="too small"):
        AtariPolicyNet(PARAMS, frame_shape=(20, 20), device="cpu")
