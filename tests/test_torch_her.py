"""Hindsight experience replay in seed_rl_torch against the JAX package.

Mirrors tests/test_replay.py's HER cases on the port (future goals with
rewards that agree with them, no substitution at probability 0) and holds
``HindsightExperienceReplay.sample`` against ``seed_rl_tpu.replay`` on the
same buffer, with JAX's four draws (indices, goal and mask uniforms, window
starts) injected: relabelled goals, recomputed rewards and every cut leaf
equal (the rewards are sums of the same few small integers), the stored
agent state kept whole.
"""

from typing import Any, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from seed_rl_tpu.replay import HindsightExperienceReplay as JaxHER
from seed_rl_tpu.types import EnvOutput as JaxEnvOutput
from seed_rl_torch.envs import BitFlippingEnv
from seed_rl_torch.replay import HERDraws, HindsightExperienceReplay
from seed_rl_torch.types import EnvOutput


class _Item(NamedTuple):
    agent_state: Any
    env_outputs: Any
    prev_actions: Any


def _reward(achieved_goal, desired_goal):
    return np.clip(-np.sum(achieved_goal != desired_goal, -1), -1.0,
                   0.0).astype(np.float32)


def _items(batch, horizon, n_bits, seed, done_p=0.0, goals="zeros"):
    """Goal-env windows, item-major [batch, horizon, ...], as numpy; the
    stored rewards are what the env gives: reward[t] = r(achieved[t],
    desired[t-1])."""
    rng = np.random.RandomState(seed)
    bits = (rng.uniform(size=(batch, horizon, n_bits)) < 0.5).astype(
        np.float32)
    desired = (np.zeros((batch, horizon, n_bits), np.float32)
               if goals == "zeros" else
               (rng.uniform(size=(batch, horizon, n_bits)) < 0.5).astype(
                   np.float32))
    reward = np.concatenate([np.zeros((batch, 1), np.float32),
                             _reward(bits[:, 1:], desired[:, :-1])], axis=1)
    return _Item(
        agent_state=rng.normal(size=(batch, 2)).astype(np.float32),
        env_outputs=dict(
            reward=reward,
            done=rng.uniform(size=(batch, horizon)) < done_p,
            observation={
                "achieved_goal": bits,
                "desired_goal": desired,
                "observation": rng.normal(size=(batch, horizon, 3)).astype(
                    np.float32),
            },
            abandoned=np.zeros((batch, horizon), bool),
            episode_step=np.tile(np.arange(horizon, dtype=np.int32),
                                 (batch, 1)),
        ),
        prev_actions=rng.randint(0, n_bits + 1, (batch, horizon)).astype(
            np.int32),
    )


def _torch_items(items):
    return items._replace(
        agent_state=torch.from_numpy(items.agent_state),
        env_outputs=EnvOutput(**jax.tree.map(torch.from_numpy,
                                             items.env_outputs)),
        prev_actions=torch.from_numpy(items.prev_actions))


def _jax_items(items):
    return items._replace(
        agent_state=jnp.asarray(items.agent_state),
        env_outputs=JaxEnvOutput(**jax.tree.map(jnp.asarray,
                                                items.env_outputs)),
        prev_actions=jnp.asarray(items.prev_actions))


def _filled(her, items):
    state = her.init_state(jax.tree.map(lambda t: t[0], items))
    n = len(items.agent_state)
    ones = torch.ones((n,)) if isinstance(items.agent_state,
                                          torch.Tensor) else jnp.ones((n,))
    state, _ = her.insert(state, items, ones)
    return state


def _her(cls, size, unroll, p):
    return cls(size=size, importance_sampling_exponent=0.0,
               compute_reward_fn=(BitFlippingEnv.compute_reward
                                  if cls is HindsightExperienceReplay else
                                  jax_reward),
               unroll_length=unroll, substitution_probability=p)


def jax_reward(achieved_goal, desired_goal):
    return jnp.clip(-jnp.sum((achieved_goal != desired_goal).astype(
        jnp.float32), -1), -1.0, 0.0)


def test_her_substitutes_future_goals_and_fixes_rewards():
    horizon, n_bits, unroll = 8, 5, 3
    her = _her(HindsightExperienceReplay, 16, unroll, 1.0)
    state = _filled(her, _torch_items(_items(4, horizon, n_bits, 0)))
    _, _, sampled = her.sample(state, torch.Generator().manual_seed(1), 6, 0)
    obs = sampled.env_outputs.observation
    assert obs["achieved_goal"].shape == (6, unroll + 1, n_bits)
    assert sampled.agent_state.shape == (6, 2)  # not cut
    # Every reward agrees with the (relabelled) goals it was computed for.
    want = BitFlippingEnv.compute_reward(obs["achieved_goal"][:, 1:],
                                         obs["desired_goal"][:, :-1])
    torch.testing.assert_close(sampled.env_outputs.reward[:, 1:], want)
    # With substitution probability 1 and no dones no goal stays zero
    # unless the achieved goal it took was zero.
    assert obs["desired_goal"].sum() > 0


def test_her_no_substitution_when_probability_zero():
    horizon, n_bits, unroll = 6, 4, 2
    her = _her(HindsightExperienceReplay, 8, unroll, 0.0)
    state = _filled(her, _torch_items(_items(3, horizon, n_bits, 2)))
    _, _, sampled = her.sample(state, torch.Generator().manual_seed(3), 5, 0)
    obs = sampled.env_outputs.observation
    torch.testing.assert_close(obs["desired_goal"],
                               torch.zeros_like(obs["desired_goal"]))
    want = BitFlippingEnv.compute_reward(obs["achieved_goal"][:, 1:],
                                         obs["desired_goal"][:, :-1])
    torch.testing.assert_close(sampled.env_outputs.reward[:, 1:], want)


@pytest.mark.parametrize("p,done_p,goals", [
    (0.8, 0.0, "zeros"),
    (1.0, 0.2, "random"),
    (0.5, 0.3, "random"),
    (0.0, 0.2, "random"),
])
def test_her_sample_matches_jax_with_its_draws_injected(p, done_p, goals):
    size, n, horizon, n_bits, unroll, num = 16, 12, 9, 5, 3, 20
    items = _items(n, horizon, n_bits, 4, done_p, goals)
    jher = _her(JaxHER, size, unroll, p)
    jstate = _filled(jher, _jax_items(items))
    rng = jax.random.PRNGKey(5)
    jindices, jweights, jsampled = jax.jit(
        lambda s, r: jher.sample(s, r, num, 0))(jstate, rng)
    base, goal, mask, begin = jax.random.split(rng, 4)
    indices = jax.random.randint(base, (num,), 0, n)
    np.testing.assert_array_equal(np.asarray(indices), np.asarray(jindices))
    draws = HERDraws(
        goal_uniform=torch.tensor(np.asarray(
            jax.random.uniform(goal, (num, horizon)))),
        mask_uniform=torch.tensor(np.asarray(
            jax.random.uniform(mask, (num, horizon)))),
        window_start=torch.tensor(np.asarray(
            jax.random.randint(begin, (num,), 0, horizon - unroll))),
    )

    her = _her(HindsightExperienceReplay, size, unroll, p)
    state = _filled(her, _torch_items(items))
    got_indices, weights, sampled = her.sample(
        state, None, num, 0, indices=torch.tensor(np.asarray(indices)),
        draws=draws)
    np.testing.assert_array_equal(got_indices.numpy(), np.asarray(jindices))
    np.testing.assert_array_equal(weights.numpy(), np.asarray(jweights))
    got, want = jax.tree.leaves(sampled), jax.tree.leaves(jsampled)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    # The agent state is the stored one: the state before the window's
    # first step, wherever the cut starts.
    np.testing.assert_array_equal(sampled.agent_state.numpy(),
                                  items.agent_state[np.asarray(indices)])
    if done_p:
        relabelled = (sampled.env_outputs.observation["desired_goal"]
                      != torch.tensor(items.env_outputs["observation"][
                          "desired_goal"])[indices.tolist()][
                              torch.arange(num)[:, None],
                              draws.window_start[:, None]
                              + torch.arange(unroll + 1)]).any(-1)
        assert not (relabelled & sampled.env_outputs.done).any()


def test_her_refuses_windows_shorter_than_an_unroll():
    her = _her(HindsightExperienceReplay, 4, 5, 0.5)
    state = _filled(her, _torch_items(_items(2, 5, 3, 0)))
    with pytest.raises(ValueError, match="cannot hold"):
        her.sample(state, torch.Generator().manual_seed(0), 2, 0)
