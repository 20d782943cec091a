"""The port's ImpalaDeep (seed_rl_torch.models.resnets) against the JAX
package.

Flax parameters are carried over with seed_rl_torch.models.convert; both
packages see the same numpy frames, rewards, previous actions, dones and a
live core state. The forward and the gradient of a sum of squares of its
outputs agree within rtol 1e-4 / atol 1e-5, with the JAX net in either
pool setting (``custom_pool_bwd`` True and False); the gradient tree is
converted like the parameters. Remat gives what no remat gives (mirroring
tests/test_env_adapters.py), and the port's folded unroll agrees with the
JAX agent's scan of the step over time.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from seed_rl_tpu import distributions as jpd
from seed_rl_tpu.agent import PolicyAgent as JaxPolicyAgent
from seed_rl_tpu.models import resnets as jax_resnets
from seed_rl_tpu.types import EnvOutput as JaxEnvOutput
from seed_rl_torch import distributions as tpd
from seed_rl_torch.agent import PolicyAgent
from seed_rl_torch.models import ImpalaDeep, convert
from seed_rl_torch.types import EnvOutput

TOL = dict(rtol=1e-4, atol=1e-5)
ACTIONS, LSTM = 4, 16
# Catch-like 1-channel frames with odd sizes on the way down (24 -> 12 ->
# 6 -> 3, 20 -> 10 -> 5 -> 3), and DmLab-like RGB frames.
SHAPES = [(24, 20, 1), (16, 24, 3)]


def _env_output(rng, lead, obs_shape, done_p=0.0):
    return dict(
        reward=rng.normal(size=lead).astype(np.float32) * 2,  # some clipped
        done=rng.uniform(size=lead) < done_p,
        observation=rng.randint(0, 256, lead + obs_shape).astype(np.uint8),
        abandoned=np.zeros(lead, bool),
        episode_step=np.zeros(lead, np.int32),
    )


def _jax(eo):
    return JaxEnvOutput(**{k: jnp.asarray(v) for k, v in eo.items()})


def _torch(eo):
    return EnvOutput(**{k: torch.from_numpy(v) for k, v in eo.items()})


def _core_state(rng, B):
    return ((rng.normal(size=(B, LSTM)).astype(np.float32),
             rng.normal(size=(B, LSTM)).astype(np.float32)),)


def _nets(obs_shape, custom_pool_bwd=True, remat=False, B=2):
    jnet = jax_resnets.ImpalaDeep(num_actions=ACTIONS, lstm_size=LSTM,
                                  custom_pool_bwd=custom_pool_bwd)
    tnet = ImpalaDeep(ACTIONS, obs_shape, lstm_size=LSTM, remat=remat,
                      device="cpu")
    rng = np.random.RandomState(0)
    params = jnet.init(jax.random.PRNGKey(1), jnp.zeros((B,), jnp.int32),
                       _jax(_env_output(rng, (B,), obs_shape)),
                       jnet.initial_state(B))
    params = jax.tree.map(np.asarray, params)
    tnet.load_state_dict(convert.state_dict_for(tnet, params), strict=True)
    return jnet, tnet, params


def _assert_named_close(named, converted, what):
    assert set(named) == set(converted), what
    for name, got in named.items():
        np.testing.assert_allclose(got.detach().numpy(),
                                   converted[name].numpy(), **TOL,
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("custom_pool_bwd", [True, False])
@pytest.mark.parametrize("obs_shape", SHAPES)
def test_forward_and_gradients_match_flax(obs_shape, custom_pool_bwd):
    jnet, tnet, params = _nets(obs_shape, custom_pool_bwd)
    B = 3
    rng = np.random.RandomState(2)
    eo = _env_output(rng, (B,), obs_shape, done_p=0.5)
    prev = rng.randint(0, ACTIONS, B).astype(np.int32)
    core = _core_state(rng, B)

    def jloss(p):
        (logits, baseline), new = jnet.apply(
            p, jnp.asarray(prev), _jax(eo), jax.tree.map(jnp.asarray, core))
        loss = jnp.sum(logits ** 2) + jnp.sum(baseline ** 2)
        return loss, (logits, baseline, new)

    (jl, (jlogits, jbaseline, jnew)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    (logits, baseline), new = tnet(torch.from_numpy(prev), _torch(eo),
                                   jax.tree.map(torch.from_numpy, core))
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, **TOL)
    np.testing.assert_allclose(baseline.detach().numpy(), jbaseline, **TOL)
    for g, w in zip(jax.tree.leaves(new), jax.tree.leaves(jnew)):
        np.testing.assert_allclose(g.detach().numpy(), w, **TOL)
    loss = torch.sum(logits ** 2) + torch.sum(baseline ** 2)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    names = [n for n, _ in tnet.named_parameters()]
    grads = torch.autograd.grad(loss, list(tnet.parameters()))
    _assert_named_close(
        dict(zip(names, grads)),
        convert.state_dict_for(tnet, jax.tree.map(np.asarray, jgrads)),
        "grad")


def test_remat_matches_no_remat():
    """remat=True is a memory/compute trade: outputs and gradients are
    those of the stored-activation path (same parameters)."""
    obs_shape = SHAPES[1]
    _, net, params = _nets(obs_shape)
    _, net_r, _ = _nets(obs_shape, remat=True)
    T, B = 3, 2
    rng = np.random.RandomState(3)
    eo = _torch(_env_output(rng, (T, B), obs_shape, done_p=0.3))
    prev = torch.from_numpy(rng.randint(0, ACTIONS, (T, B)).astype(np.int32))
    results = []
    for n in (net, net_r):
        (logits, baseline), _ = n.unroll(prev, eo, n.initial_state(B))
        loss = torch.sum(logits ** 2) + torch.sum(baseline ** 2)
        results.append((loss, torch.autograd.grad(loss, list(n.parameters()))))
    (l0, g0), (l1, g1) = results
    torch.testing.assert_close(l0, l1, rtol=1e-6, atol=0)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0)


@pytest.mark.parametrize("obs_shape", SHAPES)
def test_folded_unroll_matches_the_jax_scan(obs_shape):
    jnet, tnet, params = _nets(obs_shape)
    T, B = 5, 3
    rng = np.random.RandomState(4)
    eo = _env_output(rng, (T, B), obs_shape, done_p=0.3)
    eo["done"][2, :2] = True
    prev = rng.randint(0, ACTIONS, (T, B)).astype(np.int32)
    core = _core_state(rng, B)
    # ImpalaDeep has no time-major path in JAX: the agent scans the step.
    jagent = JaxPolicyAgent(jnet, jpd.CategoricalDistribution(ACTIONS))
    tagent = PolicyAgent(tnet, tpd.CategoricalDistribution(ACTIONS))
    (jp, jb), jnew = jagent.unroll(params, jnp.asarray(prev), _jax(eo),
                                   jax.tree.map(jnp.asarray, core))
    (tp, tb), tnew = tagent.unroll(torch.from_numpy(prev), _torch(eo),
                                   jax.tree.map(torch.from_numpy, core))
    assert tp.shape == (T, B, ACTIONS) and tb.shape == (T, B)
    np.testing.assert_allclose(tp.detach().numpy(), jp, **TOL)
    np.testing.assert_allclose(tb.detach().numpy(), jb, **TOL)
    for g, w in zip(jax.tree.leaves(tnew), jax.tree.leaves(jnew)):
        np.testing.assert_allclose(g.detach().numpy(), w, **TOL)


def test_unroll_equals_stepping_forward():
    obs_shape = SHAPES[0]
    net = ImpalaDeep(ACTIONS, obs_shape, lstm_size=LSTM, seed=5,
                     device="cpu")
    T, B = 4, 3
    rng = np.random.RandomState(5)
    eo = _torch(_env_output(rng, (T, B), obs_shape, done_p=0.4))
    prev = torch.from_numpy(rng.randint(0, ACTIONS, (T, B)).astype(np.int32))
    with torch.no_grad():
        (up, ub), ustate = net.unroll(prev, eo, net.initial_state(B))
        state = net.initial_state(B)
        for t in range(T):
            (p, b), state = net(prev[t], jax.tree.map(lambda x: x[t], eo),
                                state)
            torch.testing.assert_close(p, up[t], rtol=2e-5, atol=2e-5)
            torch.testing.assert_close(b, ub[t], rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(state, ustate, rtol=2e-5, atol=2e-5)


def test_full_width_shapes_on_atari_frames():
    net = ImpalaDeep(18, (84, 84, 1), device="cpu")
    # 84 -> 42 -> 21 -> 11 after the three SAME pools, 32 channels.
    assert net.torso.dense.in_features == 11 * 11 * 32
    assert net.torso.dense.out_features == 256
    assert net.lstm.cells[0].weight_ih.shape == (4 * 256, 256 + 1 + 18)
    (c, h), = net.initial_state(2)
    assert c.shape == h.shape == (2, 256)
    rng = np.random.RandomState(6)
    eo = _torch(_env_output(rng, (2,), (84, 84, 1)))
    with torch.no_grad():
        (logits, baseline), _ = net(torch.zeros(2, dtype=torch.int32), eo,
                                    net.initial_state(2))
    assert logits.shape == (2, 18) and baseline.shape == (2,)
