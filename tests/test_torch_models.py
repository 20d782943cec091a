"""The port's networks (seed_rl_torch.models) against the flax originals.

Flax parameters are initialised in JAX, carried over with
seed_rl_torch.models.convert, and both networks see the same numpy inputs:
one step from a random core state, and a time-major unroll with ``done``
resets inside it. Outputs and core states agree within rtol = atol = 1e-5;
over a dict observation whose keys were inserted out of sorted order
(flax concatenates the leaves in sorted key order), within rtol = atol =
1e-6.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from seed_rl_tpu import distributions as jpd
from seed_rl_tpu.agent import PolicyAgent as JaxPolicyAgent
from seed_rl_tpu.models import MLPAndLSTM as JaxMLPAndLSTM
from seed_rl_tpu.models import MLPPolicyNetwork as JaxMLPPolicyNetwork
from seed_rl_tpu.types import EnvOutput as JaxEnvOutput
from seed_rl_torch import distributions as tpd
from seed_rl_torch.agent import PolicyAgent, batch_apply
from seed_rl_torch.models import MLPAndLSTM, MLPPolicyNetwork, convert
from seed_rl_torch.types import EnvOutput

TOL = dict(rtol=1e-5, atol=1e-5)
OBS, PARAMS = 4, 6


def _env_output(rng, lead, done_p=0.0):
    return dict(
        reward=rng.normal(size=lead).astype(np.float32),
        done=rng.uniform(size=lead) < done_p,
        observation=rng.normal(size=lead + (OBS,)).astype(np.float32),
        abandoned=np.zeros(lead, bool),
        episode_step=np.zeros(lead, np.int32),
    )


def _jax(eo):
    return JaxEnvOutput(**{k: jnp.asarray(v) for k, v in eo.items()})


def _torch(eo):
    return EnvOutput(**{k: torch.from_numpy(v) for k, v in eo.items()})


def _nets(kind, **kw):
    if kind == "lstm":
        jnet = JaxMLPAndLSTM(PARAMS, **kw)
        tnet = MLPAndLSTM(PARAMS, OBS, device="cpu", **kw)
    else:
        jnet = JaxMLPPolicyNetwork(PARAMS, **kw)
        tnet = MLPPolicyNetwork(PARAMS, OBS, device="cpu", **kw)
    B = 3
    rng = np.random.RandomState(0)
    params = jnet.init(
        jax.random.PRNGKey(1), jnp.zeros((B, 3)), _jax(_env_output(rng, (B,))),
        jnet.initial_state(B),
    )
    params = jax.tree.map(np.asarray, params)
    tnet.load_state_dict(convert.state_dict_for(tnet, params), strict=True)
    return jnet, tnet, params


def _random_state(sizes, B, rng):
    return tuple(
        (rng.normal(size=(B, s)).astype(np.float32),
         rng.normal(size=(B, s)).astype(np.float32))
        for s in sizes
    )


NETS = [
    ("lstm", dict(mlp_sizes=(16,), lstm_sizes=(8,))),
    ("lstm", dict(mlp_sizes=(16, 12), lstm_sizes=(8, 6))),
    ("lstm", dict()),  # the default width: MLP (64, 64), LSTM (64,)
    ("mlp", dict(mlp_sizes=(16, 16))),
    ("mlp", dict(mlp_sizes=(16,), shared_torso=True, activation="relu")),
]


@pytest.mark.parametrize("kind,kw", NETS)
def test_step_matches_flax(kind, kw):
    jnet, tnet, params = _nets(kind, **kw)
    B = 5
    rng = np.random.RandomState(2)
    eo = _env_output(rng, (B,), done_p=0.5)
    state = (
        _random_state(tnet.lstm_sizes, B, rng) if kind == "lstm" else ()
    )
    (jp, jb), jstate = jnet.apply(
        params, jnp.zeros((B, 3)), _jax(eo), jax.tree.map(jnp.asarray, state)
    )
    (tp, tb), tstate = tnet(
        torch.zeros(B, 3), _torch(eo), jax.tree.map(torch.from_numpy, state)
    )
    np.testing.assert_allclose(tp.detach().numpy(), jp, **TOL)
    np.testing.assert_allclose(tb.detach().numpy(), jb, **TOL)
    for jleaf, tleaf in zip(jax.tree.leaves(jstate), jax.tree.leaves(
            jax.tree.map(lambda t: t.detach().numpy(), tstate))):
        np.testing.assert_allclose(tleaf, jleaf, **TOL)


@pytest.mark.parametrize("kind,kw", NETS)
def test_unroll_with_done_resets_matches_flax(kind, kw):
    jnet, tnet, params = _nets(kind, **kw)
    T, B = 7, 4
    rng = np.random.RandomState(3)
    eo = _env_output(rng, (T, B), done_p=0.3)
    eo["done"][2, :2] = True  # resets inside the unroll
    prev_actions = rng.normal(size=(T, B, 3)).astype(np.float32)
    state = (
        _random_state(tnet.lstm_sizes, B, rng) if kind == "lstm" else ()
    )
    jagent = JaxPolicyAgent(jnet, jpd.NormalTanhDistribution(3))
    tagent = PolicyAgent(tnet, tpd.NormalTanhDistribution(3))
    (jp, jb), jstate = jagent.unroll(
        params, jnp.asarray(prev_actions), _jax(eo),
        jax.tree.map(jnp.asarray, state),
    )
    (tp, tb), tstate = tagent.unroll(
        torch.from_numpy(prev_actions), _torch(eo),
        jax.tree.map(torch.from_numpy, state),
    )
    assert tp.shape == (T, B, PARAMS) and tb.shape == (T, B)
    np.testing.assert_allclose(tp.detach().numpy(), jp, **TOL)
    np.testing.assert_allclose(tb.detach().numpy(), jb, **TOL)
    for jleaf, tleaf in zip(jax.tree.leaves(jstate), jax.tree.leaves(
            jax.tree.map(lambda t: t.detach().numpy(), tstate))):
        np.testing.assert_allclose(tleaf, jleaf, **TOL)


@pytest.mark.parametrize("order", [("b", "a", "c"), ("c", "b", "a")])
def test_mlp_and_lstm_over_a_dict_out_of_key_order_matches_flax(order):
    widths = {"a": 1, "b": 2, "c": 1}  # OBS wide in all
    T, B = 5, 3
    tol = dict(rtol=1e-6, atol=1e-6)
    rng = np.random.RandomState(4)
    eo = _env_output(rng, (T, B), done_p=0.3)
    eo["observation"] = {k: rng.normal(size=(T, B, widths[k])).astype(
        np.float32) for k in order}
    jeo = JaxEnvOutput(**jax.tree.map(jnp.asarray, eo))
    # torch's pytree keeps each dict's insertion order.
    teo = EnvOutput(**torch.utils._pytree.tree_map(torch.from_numpy, eo))
    assert tuple(teo.observation) == order
    jnet = JaxMLPAndLSTM(PARAMS, mlp_sizes=(16,), lstm_sizes=(8,))
    tnet = MLPAndLSTM(PARAMS, OBS, mlp_sizes=(16,), lstm_sizes=(8,),
                      device="cpu")
    params = jax.tree.map(np.asarray, jnet.init(
        jax.random.PRNGKey(1), jnp.zeros((B, 3)),
        jax.tree.map(lambda x: x[0], jeo), jnet.initial_state(B)))
    tnet.load_state_dict(convert.state_dict_for(tnet, params), strict=True)
    state = _random_state(tnet.lstm_sizes, B, rng)
    jstate = jax.tree.map(jnp.asarray, state)
    tstate = jax.tree.map(torch.from_numpy, state)
    (jp, jb), _ = jnet.apply(params, jnp.zeros((B, 3)),
                             jax.tree.map(lambda x: x[0], jeo), jstate)
    (tp, tb), _ = tnet(torch.zeros(B, 3),
                       torch.utils._pytree.tree_map(lambda x: x[0], teo),
                       tstate)
    np.testing.assert_allclose(tp.detach().numpy(), jp, **tol)
    np.testing.assert_allclose(tb.detach().numpy(), jb, **tol)
    jagent = JaxPolicyAgent(jnet, jpd.NormalTanhDistribution(3))
    tagent = PolicyAgent(tnet, tpd.NormalTanhDistribution(3))
    (jp, jb), jfinal = jagent.unroll(params, jnp.zeros((T, B, 3)), jeo,
                                     jstate)
    (tp, tb), tfinal = tagent.unroll(torch.zeros(T, B, 3), teo, tstate)
    np.testing.assert_allclose(tp.detach().numpy(), jp, **tol)
    np.testing.assert_allclose(tb.detach().numpy(), jb, **tol)
    for jleaf, tleaf in zip(jax.tree.leaves(jfinal),
                            jax.tree.leaves(tfinal)):
        np.testing.assert_allclose(tleaf.detach().numpy(), jleaf, **tol)


def test_unroll_equals_stepping_forward():
    """The folded unroll is the step function applied T times."""
    net = MLPAndLSTM(PARAMS, OBS, mlp_sizes=(16,), lstm_sizes=(8,),
                     device="cpu")
    T, B = 5, 3
    rng = np.random.RandomState(4)
    eo = _torch(_env_output(rng, (T, B), done_p=0.4))
    state = net.initial_state(B)
    (up, ub), ustate = net.unroll(torch.zeros(T, B, 3), eo, state)
    for t in range(T):
        (p, b), state = net(None, jax.tree.map(lambda x: x[t], eo), state)
        torch.testing.assert_close(p, up[t], **TOL)
        torch.testing.assert_close(b, ub[t], **TOL)
    torch.testing.assert_close(state, ustate, **TOL)


def test_batch_apply_folds_and_unfolds():
    x = torch.arange(24.0).reshape(2, 3, 4)
    out = batch_apply(lambda a: (a[0] * 2, a[1].sum(-1)), (x, x))
    torch.testing.assert_close(out[0], x * 2)
    torch.testing.assert_close(out[1], x.sum(-1))


def test_initialisation_follows_flax_defaults():
    net = MLPAndLSTM(PARAMS, 200, mlp_sizes=(300,), lstm_sizes=(64,),
                     seed=7, device="cpu")
    for name, p in net.named_parameters():
        if name.endswith("bias"):
            assert torch.count_nonzero(p) == 0, name
    # lecun normal: std sqrt(1/fan_in), truncated at 2 std.
    w = net.torso.layers[0].weight.detach()
    np.testing.assert_allclose(float(w.std()), (1 / 200) ** 0.5, rtol=0.05)
    assert float(w.abs().max()) <= 2 * (1 / 200) ** 0.5 / 0.8796 + 1e-6
    # Orthogonal recurrent kernel per gate.
    w_hh = net.lstm.cells[0].weight_hh.detach()
    for gate in range(4):
        q = w_hh[gate * 64:(gate + 1) * 64]
        torch.testing.assert_close(q @ q.T, torch.eye(64), atol=1e-5, rtol=0)
    again = MLPAndLSTM(PARAMS, 200, mlp_sizes=(300,), lstm_sizes=(64,),
                       seed=7, device="cpu")
    torch.testing.assert_close(net.state_dict(), again.state_dict())


def test_convert_rejects_unknown_network():
    with pytest.raises(TypeError):
        convert.state_dict_for(torch.nn.Linear(2, 2), {})


def test_networks_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MLPAndLSTM(PARAMS, OBS)
