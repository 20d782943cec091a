"""The port's distributions (seed_rl_torch.distributions) against the JAX package.

Parameters and actions are made from a seed with numpy; sampling noise is
drawn once in JAX (the same draw the JAX method makes from its key) and
handed to the port. Outputs agree within rtol = atol = 1e-5.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from seed_rl_tpu import distributions as jpd
from seed_rl_torch import distributions as tpd
from seed_rl_torch.envs.spaces import Box

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want):
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(want), **TOL
    )


def _params(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).normal(size=shape) * scale).astype(
        np.float32
    )


def _pair(maker, *args):
    return maker(jpd, *args), maker(tpd, *args)


@pytest.mark.parametrize("std_fn", ["default", "softplus", "safe_exp"])
def test_normal_tanh_log_prob_including_tails(std_fn):
    if std_fn == "default":
        make = lambda m: m.NormalTanhDistribution(3)  # noqa: E731
    elif std_fn == "softplus":
        make = lambda m: m.NormalTanhDistribution(  # noqa: E731
            3, gaussian_std_fn=m.softplus_std_fn(1.0, 1e-3))
    else:
        make = lambda m: m.NormalTanhDistribution(  # noqa: E731
            3, gaussian_std_fn=m.safe_exp_std_fn(1.0, 1e-3))
    jd, td = make(jpd), make(tpd)
    params = _params((4, 6, 6), seed=1)
    actions = np.random.RandomState(2).uniform(-0.99, 0.99, (4, 6, 3))
    # At the 0.999 threshold, just inside and beyond it, and at +-1.
    edge = np.array([-1.0, -0.9995, -0.999, -0.9989, 0.9989, 0.999, 0.9995,
                     1.0, 1.5])
    actions[0, :, :] = np.resize(edge, (6, 3))
    actions[1, :, :] = -np.resize(edge, (6, 3))
    actions = actions.astype(np.float32)
    want = jd.log_prob(params, actions)
    got = td.log_prob(torch.from_numpy(params), torch.from_numpy(actions))
    _close(got, want)
    assert torch.isfinite(got).all()


def test_normal_tanh_boundary_gradient_finite():
    td = tpd.NormalTanhDistribution(1)
    for a in [-1.0, -0.9999, 0.9999, 1.0]:
        params = torch.zeros(2, requires_grad=True)
        lp = td.log_prob(params, torch.tensor([a]))
        (grad,) = torch.autograd.grad(lp, params)
        assert torch.isfinite(lp) and torch.isfinite(grad).all(), a


def test_normal_tanh_sample_and_entropy_with_injected_noise():
    jd, td = _pair(lambda m: m.NormalTanhDistribution(3))
    params = _params((5, 7, 6), seed=3)
    key = jax.random.PRNGKey(4)
    noise = jax.random.normal(key, (5, 7, 3), jnp.float32)
    tparams = torch.from_numpy(params)
    tnoise = torch.tensor(np.asarray(noise))
    _close(td.sample(tparams, noise=tnoise), jd.sample(params, key))
    _close(td.entropy(tparams, noise=tnoise), jd.entropy(params, key))
    _close(td.mode(tparams), jd.mode(params))
    other = _params((5, 7, 6), seed=5)
    _close(
        td.kl_divergence(tparams, torch.from_numpy(other)),
        jd.kl_divergence(params, other),
    )
    with pytest.raises(ValueError):
        td.entropy(tparams)


def test_normal_tanh_sample_uses_generator_and_stays_in_bounds():
    td = tpd.NormalTanhDistribution(3)
    params = torch.arange(6.0, requires_grad=True)
    g = torch.Generator().manual_seed(0)
    s = td.sample(params, g)
    assert (s.abs() <= 1.0).all()
    (grad,) = torch.autograd.grad(s.sum(), params)
    assert (grad != 0).any()  # pathwise (reparametrized)
    s2 = td.sample(params, torch.Generator().manual_seed(0))
    torch.testing.assert_close(s, s2)


def test_normal_clipped_matches_jax():
    jd, td = _pair(lambda m: m.NormalClippedDistribution(2))
    params = _params((3, 4), seed=6)
    actions = np.random.RandomState(7).uniform(-1, 1, (3, 2)).astype(
        np.float32
    )
    key = jax.random.PRNGKey(8)
    noise = jax.random.normal(key, (3, 2), jnp.float32)
    tparams = torch.from_numpy(params)
    _close(td.log_prob(tparams, torch.from_numpy(actions)),
           jd.log_prob(params, actions))
    _close(td.entropy(tparams), jd.entropy(params))
    _close(td.sample(tparams, noise=torch.tensor(np.asarray(noise))),
           jd.sample(params, key))
    _close(td.mode(tparams), jd.mode(params))
    other = _params((3, 4), seed=9)
    _close(td.kl_divergence(tparams, torch.from_numpy(other)),
           jd.kl_divergence(params, other))


def test_categorical_matches_jax_with_injected_gumbel():
    jd, td = _pair(lambda m: m.CategoricalDistribution(5))
    logits = _params((6, 5), seed=10, scale=2.0)
    actions = np.random.RandomState(11).randint(0, 5, (6,)).astype(np.int32)
    key = jax.random.PRNGKey(12)
    gumbel = jax.random.gumbel(key, (6, 5), jnp.float32)
    tl = torch.from_numpy(logits)
    _close(td.log_prob(tl, torch.from_numpy(actions)),
           jd.log_prob(logits, actions))
    _close(td.entropy(tl), jd.entropy(logits))
    other = _params((6, 5), seed=13)
    _close(td.kl_divergence(tl, torch.from_numpy(other)),
           jd.kl_divergence(logits, other))
    sample = td.sample(tl, noise=torch.tensor(np.asarray(gumbel)))
    assert sample.dtype == torch.int32
    np.testing.assert_array_equal(sample.numpy(), jd.sample(logits, key))
    np.testing.assert_array_equal(td.mode(tl).numpy(), jd.mode(logits))


def test_categorical_sampling_distribution():
    td = tpd.CategoricalDistribution(4)
    logits = torch.log(torch.tensor([0.1, 0.2, 0.3, 0.4])).expand(20000, 4)
    samples = td.sample(logits, torch.Generator().manual_seed(0))
    freqs = np.bincount(samples.numpy(), minlength=4) / 20000
    np.testing.assert_allclose(freqs, [0.1, 0.2, 0.3, 0.4], atol=0.02)


def test_multi_categorical_matches_jax():
    jd, td = _pair(lambda m: m.MultiCategoricalDistribution(3, 4))
    params = _params((2, 12), seed=14)
    actions = np.random.RandomState(15).randint(0, 4, (2, 3)).astype(np.int32)
    key = jax.random.PRNGKey(16)
    gumbel = jax.random.gumbel(key, (2, 3, 4), jnp.float32)
    tp = torch.from_numpy(params)
    _close(td.log_prob(tp, torch.from_numpy(actions)),
           jd.log_prob(params, actions))
    _close(td.entropy(tp), jd.entropy(params))
    np.testing.assert_array_equal(
        td.sample(tp, noise=torch.tensor(np.asarray(gumbel))).numpy(),
        jd.sample(params, key),
    )
    np.testing.assert_array_equal(td.mode(tp).numpy(), jd.mode(params))


def test_joint_distribution_matches_jax():
    jd, td = _pair(lambda m: m.JointDistribution(
        [m.CategoricalDistribution(3), m.NormalTanhDistribution(2)]))
    assert td.param_size == jd.param_size == 7
    params = _params((4, 7), seed=17)
    actions = np.concatenate(
        [np.array([[0.0], [1.0], [2.0], [1.0]]),
         np.random.RandomState(18).uniform(-0.9, 0.9, (4, 2))], axis=-1,
    ).astype(np.float32)
    tp = torch.from_numpy(params)
    _close(td.log_prob(tp, torch.from_numpy(actions)),
           jd.log_prob(params, actions))
    _close(td.mode(tp), jd.mode(params))
    s = td.sample(tp, torch.Generator().manual_seed(0))
    assert s.shape == (4, 3) and s.dtype == torch.float32


def test_std_fns_and_safe_exp_match_jax():
    x = np.linspace(-20, 20, 41).astype(np.float32)
    for maker in ["safe_exp_std_fn", "softplus_std_fn"]:
        for args in [(1.0, 1e-3), (0.5, 1e-2)]:
            want = getattr(jpd, maker)(*args)(x)
            _close(getattr(tpd, maker)(*args)(torch.from_numpy(x)), want)
    _close(tpd.softplus_default_std_fn(torch.from_numpy(x)),
           jpd.softplus_default_std_fn(x))
    xt = torch.tensor(20.0, requires_grad=True)
    (grad,) = torch.autograd.grad(tpd.safe_exp(xt), xt)
    # Forward is clipped at exp(15); the gradient matches the clipped forward.
    np.testing.assert_allclose(float(grad), math.exp(15.0), rtol=1e-5)


def test_deterministic_tanh():
    td = tpd.DeterministicTanhDistribution(2)
    params = torch.tensor([0.5, -2.0])
    np.testing.assert_allclose(td.sample(params).numpy(),
                               np.tanh([0.5, -2.0]), rtol=1e-5)
    assert td.entropy(params).shape == ()


def test_action_space_dispatch_duck_typed():
    import gymnasium as gym

    def both(space):
        return (
            type(jpd.get_parametric_distribution_for_action_space(space)),
            type(tpd.get_parametric_distribution_for_action_space(space)),
        )

    box = gym.spaces.Box(low=-1.0, high=1.0, shape=(4,))
    for space in [
        gym.spaces.Discrete(5),
        gym.spaces.MultiDiscrete([3, 3]),
        box,
        gym.spaces.Tuple([gym.spaces.Discrete(2), box]),
    ]:
        jcls, tcls = both(space)
        assert tcls.__name__ == jcls.__name__, space
    own = tpd.get_parametric_distribution_for_action_space(Box(-1, 1, (3,)))
    assert isinstance(own, tpd.NormalTanhDistribution)
    assert own.param_size == 6
    clipped = tpd.get_parametric_distribution_for_action_space(
        Box(-1, 1, (3,)),
        tpd.continuous_action_config(action_postprocessor="ClippedIdentity"),
    )
    assert isinstance(clipped, tpd.NormalClippedDistribution)
    for bad in [gym.spaces.Box(low=0.0, high=1.0, shape=(4,)),
                Box(0.0, 1.0, (2,))]:
        with pytest.raises(ValueError):
            tpd.get_parametric_distribution_for_action_space(bad)
