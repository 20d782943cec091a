"""The port's SAC nets (seed_rl_torch.models.sac_nets) against flax.

Flax parameters are initialised in JAX and carried over with
seed_rl_torch.models.convert; both nets see the same numpy inputs, and
every head (actor parameters, V, the Q heads; the visual net's embedding
and its ``*_from_embedding`` heads; the recurrent net's time-major heads
with ``done`` resets inside the unroll and its ``step`` with every net's
carry) agrees within rtol 1e-4 / atol 1e-5 (sums in another order; the
conv torso's within the same). Dict observations are inserted out of key
order on the port's side. Also mirrored from tests/test_sac.py and
tests/test_catch.py: the recurrent ``step`` against the time-major unroll,
the withheld desired goal, and the shared embedding against per-head
torsos.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.utils._pytree as pytree

from seed_rl_tpu.models import sac_nets as jax_sac_nets
from seed_rl_tpu.types import EnvOutput as JaxEnvOutput
from seed_rl_torch.envs import TensorSpec
from seed_rl_torch.models import (
    ActorCriticLSTM,
    ActorCriticMLP,
    VisualActorCritic,
    convert,
)
from seed_rl_torch.types import EnvOutput

TOL = dict(rtol=1e-4, atol=1e-5)
GOAL_WIDTHS = {"observation": 7, "desired_goal": 4, "achieved_goal": 4}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread (see tests/test_torch_ppo.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _observation(kind, rng, lead):
    if kind == "vector":
        return rng.normal(size=lead + (5,)).astype(np.float32)
    if kind == "frames":
        return rng.randint(0, 256, lead + (42, 42, 1)).astype(np.uint8)
    return {k: rng.normal(size=lead + (w,)).astype(np.float32)
            for k, w in GOAL_WIDTHS.items()}  # not in sorted order


def _spec(kind):
    if kind == "vector":
        return TensorSpec((5,), torch.float32)
    if kind == "frames":
        return TensorSpec((42, 42, 1), torch.uint8)
    return {k: TensorSpec((w,), torch.float32)
            for k, w in GOAL_WIDTHS.items()}


def _env_output(kind, rng, lead, done_p=0.0):
    return dict(
        reward=rng.normal(size=lead).astype(np.float32),
        done=rng.uniform(size=lead) < done_p,
        observation=_observation(kind, rng, lead),
        abandoned=np.zeros(lead, bool),
        episode_step=np.zeros(lead, np.int32),
    )


def _jax(eo):
    return JaxEnvOutput(**jax.tree.map(jnp.asarray, eo))


def _torch(eo):
    # Keeps each dict's insertion order, unlike jax.tree.map.
    return EnvOutput(**pytree.tree_map(torch.from_numpy, eo))


def _actions(discrete, rng, lead, action_dim):
    if discrete:
        return rng.randint(0, 5, lead).astype(np.int32)
    return rng.uniform(-1, 1, lead + (action_dim,)).astype(np.float32)


def _close(got, want, tol=TOL, what=""):
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **tol,
                                   err_msg=what)


def _init(jnet, tnet, prev_action, env_output, state):
    params = jax.tree.map(np.asarray, jnet.init(
        jax.random.PRNGKey(1), jnp.asarray(prev_action), _jax(env_output),
        state))
    tnet.load_state_dict(convert.state_dict_for(tnet, params), strict=True)
    return params


# (kind, discrete, kwargs): the param size is 5 logits or 2 x 2 loc/scale.
STATELESS = [
    ("vector", False, dict(mlp_sizes=(16, 12))),
    ("goal", True, dict(mlp_sizes=(16,), n_critics=3)),
    ("vector", True, dict()),  # the default width: (256, 256)
    ("frames", False, dict(head_sizes=(16,))),
    ("frames", True, dict()),  # the default heads: (256,)
]


@pytest.mark.parametrize("kind,discrete,kw", STATELESS)
def test_stateless_sac_nets_match_flax(kind, discrete, kw):
    B, T = 3, 4
    rng = np.random.RandomState(0)
    param_size, action_dim = (5, 1) if discrete else (4, 2)
    jcls, tcls = ((jax_sac_nets.VisualActorCritic, VisualActorCritic)
                  if kind == "frames" else
                  (jax_sac_nets.ActorCriticMLP, ActorCriticMLP))
    extra = dict(action_dim=1) if discrete else {}
    jnet = jcls(param_size, **kw, **extra)
    tnet = tcls(param_size, _spec(kind), **kw, **extra, device="cpu")
    eo = _env_output(kind, rng, (B,))
    params = _init(jnet, tnet, _actions(discrete, rng, (B,), action_dim), eo,
                   ())
    for lead in ((B,), (T, B)):
        eo = _env_output(kind, rng, lead)
        action = _actions(discrete, rng, lead, action_dim)
        prev = _actions(discrete, rng, lead, action_dim)
        jargs = (jnp.asarray(prev), _jax(eo), ())
        targs = (torch.from_numpy(prev), _torch(eo), ())
        for name in ("get_action_params", "get_v"):
            _close(getattr(tnet, name)(*targs),
                   jnet.apply(params, *jargs, method=getattr(jnet, name)),
                   what=f"{name} {lead}")
        q = tnet.get_q(*targs, torch.from_numpy(action))
        assert q.shape == lead + (kw.get("n_critics", 2),)
        _close(q, jnet.apply(params, *jargs, jnp.asarray(action),
                             method=jnet.get_q), what=f"get_q {lead}")
        if kind != "frames":
            continue
        emb = tnet.get_embedding(*targs)
        jemb = jnet.apply(params, *jargs, method=jnet.get_embedding)
        assert emb.shape == lead + (512,)
        _close(emb, jemb, what="embedding")
        _close(tnet.get_q_from_embedding(emb, torch.from_numpy(action)),
               jnet.apply(params, jemb, jnp.asarray(action),
                          method=jnet.get_q_from_embedding))
        _close(tnet.get_v_from_embedding(emb),
               jnet.apply(params, jemb, method=jnet.get_v_from_embedding))


def _lstm_nets(discrete, **kw):
    param_size, action_dim = (5, 1) if discrete else (4, 2)
    extra = dict(action_dim=1) if discrete else {}
    jnet = jax_sac_nets.ActorCriticLSTM(param_size, **kw, **extra)
    tnet = ActorCriticLSTM(param_size, _spec("goal"), **kw, **extra,
                           device="cpu")
    return jnet, tnet, action_dim


def _random_state(tnet, B, rng):
    return pytree.tree_map(
        lambda t: rng.normal(size=t.shape).astype(np.float32),
        tnet.initial_state(B))


LSTM_NETS = [
    (False, dict(lstm_sizes=(8,), pre_mlp_sizes=(6,), post_mlp_sizes=(7,),
                 ff_mlp_sizes=(5,))),
    (True, dict(lstm_sizes=(8, 6), pre_mlp_sizes=(6, 5), post_mlp_sizes=(7,),
                ff_mlp_sizes=(5, 4), n_critics=1)),
    (True, dict()),  # the default widths: LSTM 256, MLPs (256,)
]


@pytest.mark.parametrize("discrete,kw", LSTM_NETS)
def test_actor_critic_lstm_matches_flax(discrete, kw):
    B, T = 3, 6
    rng = np.random.RandomState(1)
    jnet, tnet, action_dim = _lstm_nets(discrete, **kw)
    eo = _env_output("goal", rng, (B,))
    params = _init(jnet, tnet, _actions(discrete, rng, (B,), action_dim), eo,
                   jnet.initial_state(B))
    state = _random_state(tnet, B, rng)
    jstate = jax.tree.map(jnp.asarray, state)
    tstate = pytree.tree_map(torch.from_numpy, state)

    # Time-major heads, with done resets inside the unroll.
    eo = _env_output("goal", rng, (T, B), done_p=0.3)
    prev = _actions(discrete, rng, (T, B), action_dim)
    action = _actions(discrete, rng, (T, B), action_dim)
    jargs = (jnp.asarray(prev), _jax(eo), jstate)
    targs = (torch.from_numpy(prev), _torch(eo), tstate)
    for name in ("get_action_params", "get_v"):
        _close(getattr(tnet, name)(*targs),
               jnet.apply(params, *jargs, method=getattr(jnet, name)),
               what=name)
    _close(tnet.get_q(*targs, torch.from_numpy(action)),
           jnet.apply(params, *jargs, jnp.asarray(action), method=jnet.get_q),
           what="get_q")

    # One step from the random carries: the actor's parameters and every
    # net's new carry.
    eo = _env_output("goal", rng, (B,), done_p=0.5)
    prev = _actions(discrete, rng, (B,), action_dim)
    got = tnet.step(torch.from_numpy(prev), _torch(eo), tstate)
    want = jnet.apply(params, jnp.asarray(prev), _jax(eo), jstate,
                      method=jnet.step)
    assert len(got[1]) == len(tnet.q) + 2
    _close(got, want, what="step")


def test_recurrent_sac_step_matches_time_major_unroll():
    """``step`` T times == one time-major pass (parameters and resets
    shared)."""
    B, T = 3, 5
    rng = np.random.RandomState(2)
    _, tnet, action_dim = _lstm_nets(
        False, lstm_sizes=(16,), pre_mlp_sizes=(16,), post_mlp_sizes=(16,),
        ff_mlp_sizes=(16,))
    eo = _torch(_env_output("goal", rng, (T, B), done_p=0.3))
    prev = torch.from_numpy(_actions(False, rng, (T, B), action_dim))
    state, stepwise = tnet.initial_state(B), []
    for t in range(T):
        out, state = tnet.step(prev[t], pytree.tree_map(lambda x: x[t], eo),
                               state)
        stepwise.append(out)
    time_major = tnet.get_action_params(prev, eo, tnet.initial_state(B))
    torch.testing.assert_close(torch.stack(stepwise), time_major, rtol=2e-5,
                               atol=2e-5)
    assert tnet.get_v(prev, eo, tnet.initial_state(B)).shape == (T, B)
    assert tnet.get_q(prev, eo, tnet.initial_state(B),
                      torch.zeros((T, B, action_dim))).shape == (T, B, 2)


def test_recurrent_sac_goalenv_withholds_desired_goal():
    """Changing desired_goal must not change any carry, but the actor's
    feed-forward branch sees it."""
    B = 3
    rng = np.random.RandomState(3)
    _, tnet, _ = _lstm_nets(True, lstm_sizes=(16,), pre_mlp_sizes=(16,),
                            post_mlp_sizes=(16,), ff_mlp_sizes=(16,),
                            n_critics=1)
    eo = _torch(_env_output("goal", rng, (B,)))
    prev = torch.zeros((B,), dtype=torch.int32)
    out_a, state_a = tnet.step(prev, eo, tnet.initial_state(B))
    shifted = eo._replace(observation=dict(
        eo.observation, desired_goal=eo.observation["desired_goal"] + 1.0))
    out_b, state_b = tnet.step(prev, shifted, tnet.initial_state(B))
    for a, b in zip(pytree.tree_leaves(state_a), pytree.tree_leaves(state_b)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(out_a, out_b)
    with pytest.raises(ValueError, match="goal-env keys"):
        tnet.step(prev, eo._replace(observation={
            "observation": eo.observation["observation"]}),
            tnet.initial_state(B))


def test_visual_shared_embedding_matches_per_head_torso():
    """The heads on a shared embedding give what each head's own torso pass
    gives (the loss's one-torso-per-parameter-set path)."""
    B = 3
    rng = np.random.RandomState(4)
    net = VisualActorCritic(2, _spec("frames"), head_sizes=(16,),
                            device="cpu")
    eo = _torch(_env_output("frames", rng, (B,)))
    args = (torch.zeros((B, 1)), eo, ())
    action = torch.full((B, 1), 0.3)
    emb = net.get_embedding(*args)
    torch.testing.assert_close(net.get_action_params_from_embedding(emb),
                               net.get_action_params(*args), rtol=0, atol=0)
    torch.testing.assert_close(net.get_v_from_embedding(emb),
                               net.get_v(*args), rtol=0, atol=0)
    torch.testing.assert_close(net.get_q_from_embedding(emb, action),
                               net.get_q(*args, action), rtol=0, atol=0)


def test_sac_nets_report_state_and_widths():
    mlp = ActorCriticMLP(4, _spec("goal"), device="cpu")
    assert mlp.stateless and mlp.initial_state(3) == ()
    assert mlp.q[0].layers[0].in_features == 15 + 2
    assert [layer.out_features for layer in mlp.actor.layers] == [256, 256, 4]
    lstm = ActorCriticLSTM(5, _spec("goal"), action_dim=1, device="cpu")
    assert not lstm.stateless
    state = lstm.initial_state(2)
    assert len(state) == 4 and state[0][0][0].shape == (2, 256)
    # The recurrent branch sees achieved_goal + observation + the previous
    # action; the feed-forward branch every key (and the Q nets the action).
    assert lstm.actor.pre_mlp.layers[0].in_features == 4 + 7 + 1
    assert lstm.actor.ff_mlp.layers[0].in_features == 15
    assert lstm.q[1].ff_mlp.layers[0].in_features == 16
