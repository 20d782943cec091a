"""The port's SAC (seed_rl_torch.agents.sac) against the JAX package.

- ``compute_loss`` on the same time-major batch, flax parameters carried
  over (online and a different target set), JAX's four loss draws injected
  (``SACNoise``): loss, the ten metrics, and the gradient of every net
  parameter and of the entropy-cost parameter agree within rtol 1e-4 /
  atol 1e-5 (float32 sums in another order). Cases: ``ActorCriticMLP``
  with a tanh-normal policy and the ``v`` and ``q`` bootstraps (one with
  the reward clip and the alpha loss), the categorical policy's
  normalized-advantage PG (population std), ``VisualActorCritic`` from
  Catch frames, ``ActorCriticLSTM``, and HER's bootstrap on the previous
  step's goal (recurrent, and an MLP behind observation normalization
  whose target holds its own statistics).
- One ``SACLearner.train_on_batch`` against the JAX learner's
  ``_train_on_batch`` on the same replay, its sample and loss draws
  injected: metrics, the pre-clip norm, the parameters after clip + Adam,
  the polyak-moved target and the entropy-cost parameter within rtol
  1e-4 / atol 1e-5; from pixels the parameters within rtol 1e-3 / atol
  1e-4, because Adam's first step divides each gradient by its own
  magnitude and so carries the conv gradients' last-digit differences into
  the parameters at the size of the learning rate. Also the alpha clip:
  the parameter pushed past -20 lands on it in both.
- The learning and wiring tests of tests/test_sac.py and
  tests/test_normalizer.py's SAC case on the port, the visual train step
  of tests/test_catch.py, the CLI on the CPU on each of the five envs, and
  the CLI's refusals.
"""

import functools
import math
import types
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
import torch.utils._pytree as pytree

from seed_rl_tpu import distributions as jpd
from seed_rl_tpu.agents import sac as jsac
from seed_rl_tpu.models import sac_nets as jnets
from seed_rl_tpu.ops import normalizer as jnorm
from seed_rl_tpu.types import EnvOutput as JaxEnvOutput
from seed_rl_torch import distributions as tpd
from seed_rl_torch import optim, train
from seed_rl_torch.agents import sac
from seed_rl_torch.envs import (
    BatchedEnv,
    BitFlippingEnv,
    ContinuousCatchEnv,
    DiscreteMatchEnv,
    TensorSpec,
    ToyEnv,
)
from seed_rl_torch.envs.catch import ContinuousCatchState
from seed_rl_torch.models import (
    ActorCriticLSTM,
    ActorCriticMLP,
    VisualActorCritic,
    convert,
)
from seed_rl_torch.ops import normalizer
from seed_rl_torch.replay import HERDraws
from seed_rl_torch.rollout import RolloutEngine
from seed_rl_torch.types import EnvOutput
from seed_rl_torch.utils import episode_stats

TOL = dict(rtol=1e-4, atol=1e-5)
UPDATED_TOL = dict(rtol=1e-3, atol=1e-4)
GOAL_WIDTHS = {"observation": 6, "desired_goal": 4, "achieved_goal": 4}
N_ACTIONS = 5  # discrete: 4 bits + the no-op


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread, so that the other test
    processes sharing the cores do not stall every op's thread barrier
    (see tests/test_torch_ppo.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Case(NamedTuple):
    net: str  # mlp, visual or lstm
    obs: str  # vector, goal or frames
    discrete: bool
    bootstrap: str = "v"
    target_entropy: Optional[float] = None
    max_abs_reward: float = 0.0
    her: bool = False
    normalize: bool = False


CASES = {
    "mlp_tanh_v": Case("mlp", "vector", False, "v", -2.0, 0.5),
    "mlp_tanh_q": Case("mlp", "vector", False, "q"),
    "mlp_categorical_pg": Case("mlp", "goal", True, "q", -1.0),
    "visual_catch": Case("visual", "frames", False, "q", -1.0),
    "lstm": Case("lstm", "goal", False, "v", -2.0),
    "her_lstm": Case("lstm", "goal", True, "q", her=True),
    "her_mlp_normalized": Case("mlp", "goal", True, "v", her=True,
                               normalize=True),
    # --env=discrete_match: a one-hot observation, Discrete actions taken
    # as int32, the categorical actor on the pg path.
    "discrete_match": Case("mlp", "match", True, "v", -1.0),
    # --normalize_observations on Catch frames: per-channel statistics.
    "visual_catch_normalized": Case("visual", "frames", True, "q", -1.0,
                                    normalize=True),
    "visual_catch_continuous_normalized": Case(
        "visual", "frames", False, "q", -1.0, normalize=True),
}
FRAMES = dict(rows=6, cols=6, cell_pixels=7)  # 42x42, the torso's least


def _action_size(case):
    if case.discrete:
        return N_ACTIONS
    return 1 if case.obs == "frames" else 2


def _spec(case):
    if case.obs == "vector":
        return TensorSpec((5,), torch.float32)
    if case.obs == "frames":
        return TensorSpec((42, 42, 1), torch.uint8)
    if case.obs == "match":
        return DiscreteMatchEnv(N_ACTIONS).observation_spec()
    return {k: TensorSpec((w,), torch.float32)
            for k, w in GOAL_WIDTHS.items()}


def _observation(case, rng, lead):
    if case.obs == "vector":
        return rng.normal(size=lead + (5,)).astype(np.float32)
    if case.obs == "frames":
        # Catch frames of random states.
        n = int(np.prod(lead))
        state = ContinuousCatchState(
            ball_row=torch.tensor(rng.randint(0, 6, n), dtype=torch.int32),
            ball_col=torch.tensor(rng.randint(0, 6, n), dtype=torch.int32),
            paddle_pos=torch.tensor(rng.uniform(0, 5, n),
                                    dtype=torch.float32),
            balls_done=torch.zeros(n, dtype=torch.int32))
        frames = ContinuousCatchEnv(**FRAMES)._obs_continuous(state)
        return frames.numpy().reshape(lead + (42, 42, 1))
    if case.obs == "match":
        return np.eye(N_ACTIONS, dtype=np.float32)[
            rng.randint(0, N_ACTIONS, lead)]
    obs = {k: (rng.uniform(size=lead + (w,)) < 0.5).astype(np.float32)
           for k, w in GOAL_WIDTHS.items()}
    obs["observation"] = rng.normal(size=lead + (6,)).astype(np.float32)
    return obs


def _actions(case, rng, lead):
    if case.discrete:
        return rng.randint(0, N_ACTIONS, lead).astype(np.int32)
    return rng.uniform(-0.99, 0.99, lead + (_action_size(case),)).astype(
        np.float32)


def _nets(case, **kw):
    """(flax net, port net type, its kwargs)."""
    p = 2 * _action_size(case) if not case.discrete else N_ACTIONS
    extra = dict(action_dim=1) if case.discrete else {}
    if case.net == "mlp":
        sizes = dict(mlp_sizes=(16, 12))
        return (jnets.ActorCriticMLP(p, **sizes, **extra), ActorCriticMLP,
                dict(**sizes, **extra))
    if case.net == "visual":
        sizes = dict(head_sizes=(16,))
        return (jnets.VisualActorCritic(p, **sizes, **extra),
                VisualActorCritic, dict(**sizes, **extra))
    sizes = dict(lstm_sizes=(8,), pre_mlp_sizes=(6,), post_mlp_sizes=(7,),
                 ff_mlp_sizes=(5,))
    return (jnets.ActorCriticLSTM(p, **sizes, **extra), ActorCriticLSTM,
            dict(**sizes, **extra))


def _dists(case):
    if case.discrete:
        return (jpd.CategoricalDistribution(N_ACTIONS),
                tpd.CategoricalDistribution(N_ACTIONS))
    return (jpd.NormalTanhDistribution(_action_size(case)),
            tpd.NormalTanhDistribution(_action_size(case)))


def _data(case, rng, T1, B, tnet):
    """A time-major [T1, B] batch as numpy: (agent_state, prev_actions,
    env_outputs as a dict, agent_actions)."""
    state = pytree.tree_map(
        lambda t: rng.normal(size=t.shape).astype(np.float32),
        tnet.initial_state(B))
    env_outputs = dict(
        reward=rng.normal(size=(T1, B)).astype(np.float32),
        done=rng.uniform(size=(T1, B)) < 0.2,
        observation=_observation(case, rng, (T1, B)),
        abandoned=np.zeros((T1, B), bool),
        episode_step=np.zeros((T1, B), np.int32),
    )
    return (state, _actions(case, rng, (T1, B)), env_outputs,
            _actions(case, rng, (T1, B)))


def _to_jax(data):
    state, prev, eo, act = data
    return (jax.tree.map(jnp.asarray, state), jnp.asarray(prev),
            JaxEnvOutput(**jax.tree.map(jnp.asarray, eo)), jnp.asarray(act))


def _to_torch(data):
    state, prev, eo, act = data
    return (pytree.tree_map(torch.from_numpy, state), torch.from_numpy(prev),
            EnvOutput(**pytree.tree_map(torch.from_numpy, eo)),
            torch.from_numpy(act))


def _noise(case, rng, T, B):
    """The port's ``SACNoise`` from the JAX loss's rng, drawn as the JAX
    distributions draw: a [T, B] sample and entropy, [T + 1, B] next."""
    keys = jax.random.split(rng, 4)
    n = _action_size(case)
    draw = jax.random.gumbel if case.discrete else jax.random.normal

    def t(key, steps, fn=draw):
        return torch.tensor(np.asarray(fn(key, (steps, B, n), jnp.float32)))

    if case.discrete:
        return sac.SACNoise(sample=t(keys[0], T),
                            next_sample=t(keys[2], T + 1))
    return sac.SACNoise(t(keys[0], T), t(keys[1], T), t(keys[2], T + 1),
                        t(keys[3], T + 1))


class Setup(NamedTuple):
    jagent: object
    jparams: object  # {"net": ..., "entropy_cost": ...}
    jtarget: object
    tagent: sac.SACAgent
    ttarget: sac.SACAgent
    entropy_cost: torch.nn.Parameter


def _obs_stats(case, rng, n):
    """JAX normalizer statistics folded from n random observations, one
    statistic per last-axis entry (per channel of frames), as JAX sizes
    them."""
    return jnorm.update_from_observation(
        jnorm.init(normalizer.observation_width(_spec(case))),
        jax.tree.map(jnp.asarray, _observation(case, rng, (n,))))


def _setup(case, rng, B, entropy_cost=0.05):
    jnet, tcls, kw = _nets(case)
    jdist, tdist = _dists(case)
    jagent = jsac.SACAgent(jnet, jdist, normalize_observations=case.normalize)
    width = (normalizer.observation_width(_spec(case)) if case.normalize
             else None)
    agents = [sac.SACAgent(tcls(jdist.param_size, _spec(case), **kw,
                                device="cpu"), tdist, width)
              for _ in range(2)]
    example = _to_jax(_data(case, rng, 1, B, agents[0].net))
    trees = []
    for key, agent in zip((1, 2), agents):
        tree = jagent.init_params(jax.random.PRNGKey(key), example[1][0],
                                  jax.tree.map(lambda x: x[0], example[2]))
        if case.normalize:
            tree = dict(tree, obs_norm=_obs_stats(case, rng, 50 * key))
            agent.obs_norm = normalizer.NormalizerState(
                *(torch.tensor(np.asarray(x)) for x in tree["obs_norm"]))
        tree = jax.tree.map(np.asarray, tree)
        agent.net.load_state_dict(convert.state_dict_for(
            agent.net, tree["policy"] if case.normalize else tree))
        trees.append(tree)
    param = np.float32(math.log(entropy_cost))
    return Setup(jagent, {"net": trees[0], "entropy_cost": param}, trees[1],
                 agents[0], agents[1],
                 torch.nn.Parameter(torch.tensor(param)))


def _config(case, **kw):
    common = dict(discounting=0.9, bootstrap_net=case.bootstrap,
                  target_entropy=case.target_entropy,
                  max_abs_reward=case.max_abs_reward,
                  her_window_length=8 if case.her else None)
    common.update(kw)
    return jsac.SACConfig(**common), sac.SACConfig(**common)


def _named(net, tree, normalize):
    want = convert.state_dict_for(net, tree["policy"] if normalize else tree)
    return {n: want[n].numpy() for n, _ in net.named_parameters()}


@pytest.mark.parametrize("name", list(CASES))
def test_compute_loss_matches_jax(name):
    case = CASES[name]
    T, B = 4, 6
    rng = np.random.RandomState(0)
    setup = _setup(case, rng, B)
    jconfig, tconfig = _config(case)
    data = _data(case, rng, T + 1, B, setup.tagent.net)
    loss_rng = jax.random.PRNGKey(7)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jsac.compute_loss(jconfig, setup.jagent, p, setup.jtarget,
                                    *_to_jax(data), loss_rng),
        has_aux=True))(setup.jparams)

    loss, metrics = sac.compute_loss(
        tconfig, setup.tagent, setup.ttarget, setup.entropy_cost,
        *_to_torch(data), noise=_noise(case, loss_rng, T, B))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    assert set(metrics) == set(jmetrics) and len(metrics) == 10
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   **TOL, err_msg=k)
    params = list(setup.tagent.net.parameters()) + [setup.entropy_cost]
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    want = _named(setup.tagent.net, jax.tree.map(np.asarray, jgrads["net"]),
                  case.normalize)
    for (pname, p), g in zip(setup.tagent.net.named_parameters(), grads):
        g = torch.zeros_like(p) if g is None else g
        np.testing.assert_allclose(g.numpy(), want[pname], **TOL,
                                   err_msg=f"grad {pname}")
    np.testing.assert_allclose(float(grads[-1]),
                               float(jgrads["entropy_cost"]), **TOL)
    # The target net takes no gradient and no parameter .grad was touched.
    assert all(p.grad is None for p in params)
    assert all(not p.requires_grad or p.grad is None
               for p in setup.ttarget.net.parameters())


def _items(case, rng, n, steps, tnet):
    """n replay items of ``steps`` timesteps, item-major, as numpy."""
    state, prev, eo, act = _data(case, rng, steps, n, tnet)

    def swap(t):
        return np.swapaxes(t, 0, 1)

    return (state, swap(prev), jax.tree.map(swap, eo), swap(act))


@pytest.mark.parametrize("name,clamp", [
    ("mlp_tanh_v", True),
    ("her_lstm", False),
    ("visual_catch", False),
    ("discrete_match", False),
])
def test_train_on_batch_matches_jax(name, clamp):
    train_on_batch_against_jax(CASES[name], clamp)


def train_on_batch_against_jax(case, clamp=False):
    """One ``train_on_batch`` of the port and of JAX from the same
    parameters, replay and draws: metrics within TOL, the parameters after
    Adam within TOL (UPDATED_TOL from frames)."""
    n, batch, unroll, lr, clip = 10, 6, 2, 1e-3, 5.0
    window = 8 if case.her else unroll
    rng = np.random.RandomState(1)
    # At the clamp, alpha is tiny and its loss still pushes the parameter
    # down: Adam's first step (~lr) crosses -20, which both clip back to.
    setup = _setup(case, rng, batch,
                   entropy_cost=math.exp(-19.9995) if clamp else 0.05)
    kw = dict(batch_size=batch, replay_buffer_size=16,
              replay_buffer_min_size=1, unroll_length=unroll, polyak=0.8,
              update_target_every_n_step=2)
    if clamp:
        kw["target_entropy"] = -1000.0
    jconfig, tconfig = _config(case, **kw)
    items = _items(case, rng, n, window + 1, setup.tagent.net)

    joptimizer = optax.chain(optax.clip_by_global_norm(clip), optax.adam(lr))
    jlearner = jsac.SACLearner(
        types.SimpleNamespace(unroll_length=window,
                              env=types.SimpleNamespace(num_envs=n)),
        setup.jagent, jconfig, joptimizer,
        compute_reward_fn=_jax_reward if case.her else None)
    jitems = jsac.StoredUnroll(*_to_jax(items))
    jreplay = jlearner.replay.init_state(jax.tree.map(lambda t: t[0],
                                                      jitems))
    jreplay, _ = jlearner.replay.insert(jreplay, jitems, jnp.ones((n,)))
    rng_key = jax.random.PRNGKey(3)
    # Batch 2 of the learner's count: 2 % 2 == 0 moves the target.
    carry = (setup.jparams, setup.jtarget,
             joptimizer.init(setup.jparams), jreplay, rng_key,
             jnp.asarray(1, jnp.int32))
    (jparams, jtarget, *_), jmetrics = jax.jit(
        lambda c: jlearner._train_on_batch(c, None))(carry)

    _, sample_rng, loss_rng = jax.random.split(rng_key, 3)
    if case.her:
        base, goal, mask, begin = jax.random.split(sample_rng, 4)
        draws = HERDraws(*(torch.tensor(np.asarray(x)) for x in (
            jax.random.uniform(goal, (batch, window + 1)),
            jax.random.uniform(mask, (batch, window + 1)),
            jax.random.randint(begin, (batch,), 0, window + 1 - unroll))))
    else:
        base, draws = sample_rng, HERDraws()
    indices = torch.tensor(np.asarray(
        jax.random.randint(base, (batch,), 0, n)))

    learner = sac.SACLearner(
        types.SimpleNamespace(
            overlap=0, unroll_length=window,
            env=types.SimpleNamespace(device=torch.device("cpu"),
                                      num_envs=n)),
        setup.tagent, tconfig,
        functools.partial(optim.ClippedAdam, learning_rate=lr,
                          clip_norm=clip),
        compute_reward_fn=BitFlippingEnv.compute_reward if case.her
        else None)
    learner.target_agent = setup.ttarget
    with torch.no_grad():
        learner.entropy_cost.copy_(setup.entropy_cost)
    titems = sac.StoredUnroll(*_to_torch(items))
    replay = learner.replay.init_state(pytree.tree_map(lambda t: t[0],
                                                       titems))
    replay, _ = learner.replay.insert(replay, titems, torch.ones((n,)))
    state = sac.SACTrainState(replay=replay, rollout=None, stats=None,
                              step=0, batches=1)
    state, metrics = learner.train_on_batch(
        state, indices=indices, draws=draws,
        noise=_noise(case, loss_rng, unroll, batch))

    assert state.batches == 2
    assert set(metrics) == set(jmetrics) and len(metrics) == 11
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   **TOL, err_msg=k)
    jparams = jax.tree.map(np.asarray, jparams)
    tol = UPDATED_TOL if case.obs == "frames" else TOL
    for what, net, tree in (
            ("updated", learner.net, jparams["net"]),
            ("target", learner.target_agent.net,
             jax.tree.map(np.asarray, jtarget))):
        want = _named(net, tree, case.normalize)
        for pname, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[pname],
                                       **tol, err_msg=f"{what} {pname}")
    entropy_cost = float(learner.entropy_cost.detach())
    np.testing.assert_allclose(entropy_cost, float(jparams["entropy_cost"]),
                               **tol)
    if clamp:
        assert entropy_cost == -20.0
        assert float(jparams["entropy_cost"]) == -20.0


def _jax_reward(achieved_goal, desired_goal):
    return jnp.clip(-jnp.sum((achieved_goal != desired_goal).astype(
        jnp.float32), -1), -1.0, 0.0)


def test_polyak_moves_every_n_batches_from_the_step_count():
    case = CASES["mlp_tanh_v"]
    rng = np.random.RandomState(2)
    setup = _setup(case, rng, 4)
    n = 8
    _, tconfig = _config(case, batch_size=4, replay_buffer_size=n,
                         replay_buffer_min_size=1, unroll_length=2,
                         update_target_every_n_step=3, polyak=0.5)
    learner = sac.SACLearner(
        types.SimpleNamespace(
            overlap=0, unroll_length=2,
            env=types.SimpleNamespace(device=torch.device("cpu"),
                                      num_envs=n)),
        setup.tagent, tconfig,
        functools.partial(optim.ClippedAdam, learning_rate=1e-3))
    titems = sac.StoredUnroll(*_to_torch(_items(case, rng, n, 3,
                                                setup.tagent.net)))
    replay = learner.replay.init_state(pytree.tree_map(lambda t: t[0],
                                                       titems))
    replay, _ = learner.replay.insert(replay, titems, torch.ones((n,)))
    state = sac.SACTrainState(replay, None, None, 0, 0)
    moved = []
    for _ in range(6):
        before = [p.clone() for p in learner.target_agent.net.parameters()]
        online = [p.detach().clone() for p in learner.net.parameters()]
        state, _ = learner.train_on_batch(state)
        after = list(learner.target_agent.net.parameters())
        moved.append(not all(torch.equal(a, b)
                             for a, b in zip(after, before)))
        if moved[-1]:
            new_online = list(learner.net.parameters())
            for a, b, o in zip(after, before, new_online):
                torch.testing.assert_close(a, 0.5 * b + 0.5 * o.detach())
            assert not all(torch.equal(a, o) for a, o in zip(after, online))
    assert moved == [False, False, True, False, False, True]
    assert learner.optimizer.count == 6


# -- learning and wiring, mirroring tests/test_sac.py --------------------


def _toy_learner(num_envs=32, batch_size=64, seed=0):
    env = BatchedEnv(ToyEnv(horizon=3), num_envs, device="cpu", seed=seed)
    dist = tpd.NormalTanhDistribution(3)
    net = ActorCriticMLP(dist.param_size, env.observation_spec(),
                         mlp_sizes=(64, 64), device="cpu", seed=seed)
    agent = sac.SACAgent(net, dist)
    config = sac.SACConfig(discounting=0.9, entropy_cost=0.05,
                           target_entropy=-3.0, batch_size=batch_size,
                           replay_buffer_size=4096,
                           replay_buffer_min_size=256, polyak=0.95)
    return sac.SACLearner(
        RolloutEngine(env, agent, 1, seed=seed + 1), agent, config,
        functools.partial(optim.ClippedAdam, learning_rate=3e-3),
        seed=seed + 2)


def _warm(learner):
    state = learner.init()
    while state.replay.num_inserted < learner.config.replay_buffer_min_size:
        state = learner.warmup_step(state)
    return state


def _window_return(state):
    stats = state.stats
    return float(stats.sum_return) / float(stats.num_episodes)


def test_sac_learns_toy_env():
    learner = _toy_learner()
    state = _warm(learner)
    state, _ = learner.train_many(state, 50)
    early = _window_return(state)
    state = state._replace(stats=episode_stats.reset_window(state.stats))
    for _ in range(6):
        state, metrics = learner.train_many(state, 50)
    late = _window_return(state)
    assert late > early + 1.0, (early, late)
    assert math.isfinite(float(metrics["losses/total"]))


@pytest.mark.parametrize("repeats", [1, 2])
def test_num_action_repeats_counts_frames_as_jax(repeats):
    """``SACConfig.num_action_repeats`` multiplies the frame count of the
    device learner and of the host learner, as JAX does
    (``seed_rl_tpu/agents/sac.py:438-440, 648-650``), and leaves the batch
    alone: the frames a step or cycle, and the steps run for a frame
    budget, equal JAX's (exact: integers)."""
    num_envs, unroll, batch = 8, 1, 16
    kw = dict(batch_size=batch, replay_buffer_size=256,
              replay_buffer_min_size=32, num_action_repeats=repeats)
    jconfig, tconfig = jsac.SACConfig(**kw), sac.SACConfig(**kw)
    jlearner = jsac.SACLearner(
        types.SimpleNamespace(unroll_length=unroll,
                              env=types.SimpleNamespace(num_envs=num_envs)),
        None, jconfig, optax.adam(1e-3))
    env = BatchedEnv(ToyEnv(horizon=3), num_envs, device="cpu")
    dist = tpd.NormalTanhDistribution(3)
    net = ActorCriticMLP(dist.param_size, env.observation_spec(),
                         mlp_sizes=(16,), device="cpu")
    agent = sac.SACAgent(net, dist)
    learner = sac.SACLearner(
        RolloutEngine(env, agent, unroll), agent, tconfig,
        functools.partial(optim.ClippedAdam, learning_rate=1e-3))
    assert (learner.frames_per_step == jlearner.frames_per_step
            == num_envs * unroll * repeats)
    total = 6 * num_envs * unroll
    state, _ = sac.learner_loop(learner, total)
    want = 0
    while want * jlearner.frames_per_step < total:  # the JAX CLI's loop
        want += 1
    assert state.step == want == 6 // repeats
    assert state.batches == state.step  # one batch of 16 a step

    jhost = jsac.SACHostLearner(None, jconfig, optax.adam(1e-3), num_envs,
                                unroll_length=4)
    host = sac.SACHostLearner(agent, tconfig,
                              functools.partial(optim.ClippedAdam,
                                                learning_rate=1e-3),
                              num_envs, unroll_length=4)
    assert (host.frames_per_cycle == jhost.frames_per_cycle
            == num_envs * 4 * repeats)
    assert host.batch_size == jhost.batch_size == batch


def test_sac_polyak_target_moves_toward_online():
    learner = _toy_learner(num_envs=8, batch_size=16)
    state = learner.init()
    for _ in range(40):
        state = learner.warmup_step(state)
    t0 = next(learner.target_agent.net.parameters()).clone()
    state, _ = learner.train_step(state)
    t1 = next(learner.target_agent.net.parameters())
    online = next(learner.net.parameters())
    assert not torch.allclose(t0, t1)
    assert not torch.allclose(t1, online)
    assert state.step == 1 and state.batches == 1


def test_sac_her_bitflipping_runs_and_improves():
    num_envs, n_bits, horizon, window = 16, 4, 8, 8
    env = BatchedEnv(BitFlippingEnv(n_bits=n_bits, horizon=horizon),
                     num_envs, device="cpu", seed=0)
    dist = tpd.CategoricalDistribution(n_bits + 1)
    net = ActorCriticMLP(dist.param_size, env.observation_spec(),
                         mlp_sizes=(64, 64), action_dim=1, device="cpu")
    agent = sac.SACAgent(net, dist)
    config = sac.SACConfig(
        discounting=0.98, entropy_cost=0.05, batch_size=64,
        replay_buffer_size=1024, replay_buffer_min_size=128,
        unroll_length=2, her_window_length=window,
        her_substitution_probability=0.8, polyak=0.95,
        train_batches_per_step=2)
    learner = sac.SACLearner(
        RolloutEngine(env, agent, window, seed=1), agent, config,
        functools.partial(optim.ClippedAdam, learning_rate=3e-3),
        compute_reward_fn=BitFlippingEnv.compute_reward, seed=2)
    state = _warm(learner)
    state, _ = learner.train_many(state, 50)
    early = _window_return(state)
    for _ in range(5):
        state, _ = learner.train_many(state, 50)
    state = state._replace(stats=episode_stats.reset_window(state.stats))
    for _ in range(2):
        state, metrics = learner.train_many(state, 50)
    late = _window_return(state)
    # Returns lie in [-horizon, 0]; HER must drive the improvement.
    assert late > early + 1.5, (early, late)
    assert math.isfinite(float(metrics["losses/total"]))
    assert state.batches == 2 * state.step


def test_sac_discrete_actor_uses_pg_path():
    assert not tpd.CategoricalDistribution(5).reparametrizable
    assert tpd.NormalTanhDistribution(2).reparametrizable


def test_recurrent_sac_trains_end_to_end():
    num_envs = 8
    env = BatchedEnv(ToyEnv(horizon=3), num_envs, device="cpu")
    dist = tpd.NormalTanhDistribution(3)
    net = ActorCriticLSTM(dist.param_size, env.observation_spec(),
                          lstm_sizes=(16,), pre_mlp_sizes=(16,),
                          post_mlp_sizes=(16,), ff_mlp_sizes=(16,),
                          device="cpu")
    agent = sac.SACAgent(net, dist)
    config = sac.SACConfig(discounting=0.9, entropy_cost=0.05,
                           batch_size=16, replay_buffer_size=256,
                           replay_buffer_min_size=32, unroll_length=4,
                           polyak=0.95)
    learner = sac.SACLearner(
        RolloutEngine(env, agent, 4), agent, config,
        functools.partial(optim.ClippedAdam, learning_rate=1e-3))
    state, metrics = learner.train_step(_warm(learner))
    assert math.isfinite(float(metrics["losses/total"]))
    # One carry per net rides the stored unrolls: actor, v, q0, q1.
    assert len(state.rollout.agent_state) == 4
    assert len(state.replay.buffer.agent_state) == 4


def test_sac_normalizing_agent_trains():
    """tests/test_normalizer.py's SAC case: the statistics fold once per
    rollout, and the target holds its own polyak-averaged copy."""
    env = BatchedEnv(ToyEnv(horizon=3), 8, device="cpu")
    dist = tpd.NormalTanhDistribution(3)
    spec = env.observation_spec()
    net = ActorCriticMLP(dist.param_size, spec, mlp_sizes=(32,),
                         device="cpu")
    agent = sac.SACAgent(net, dist, normalizer.observation_width(spec))
    config = sac.SACConfig(batch_size=16, replay_buffer_size=256,
                           replay_buffer_min_size=32, unroll_length=1)
    learner = sac.SACLearner(
        RolloutEngine(env, agent, 1), agent, config,
        functools.partial(optim.ClippedAdam, learning_rate=1e-3))
    state = _warm(learner)
    assert float(agent.obs_norm.steps) == 4 * 8  # 4 rollouts of 1 x 8
    assert float(learner.target_agent.obs_norm.steps) == 0.0
    state, metrics = learner.train_step(state)
    assert math.isfinite(float(metrics["losses/total"]))
    # polyak 0.9 moved the target's copy a tenth of the way.
    torch.testing.assert_close(learner.target_agent.obs_norm.steps,
                               torch.tensor(0.1 * 5 * 8))
    assert any(t is learner.target_agent.obs_norm.sum
               for t in learner.state_tensors(state))


def test_visual_sac_train_step():
    """tests/test_catch.py's visual SAC step: VisualActorCritic on
    ContinuousCatch frames through the fused learner."""
    env = BatchedEnv(ContinuousCatchEnv(**FRAMES), 4, device="cpu")
    dist = tpd.get_parametric_distribution_for_action_space(env.action_space)
    net = VisualActorCritic(dist.param_size, env.observation_spec(),
                            head_sizes=(32,), device="cpu")
    agent = sac.SACAgent(net, dist)
    assert agent.has_shared_embedding
    config = sac.SACConfig(batch_size=4, replay_buffer_size=32,
                           replay_buffer_min_size=8, unroll_length=2)
    learner = sac.SACLearner(
        RolloutEngine(env, agent, 2), agent, config,
        functools.partial(optim.ClippedAdam, learning_rate=3e-4))
    state, logs = learner.train_step(_warm(learner))
    assert math.isfinite(float(logs["losses/total"]))
    assert state.step == 1
    assert state.replay.buffer.env_outputs.observation.dtype == torch.uint8


# -- the CLI ---------------------------------------------------------------

SMALL = ["--device=cpu", "--num_envs=4", "--unroll_length=2",
         "--batch_size=8", "--replay_buffer_size=64",
         "--replay_buffer_min_size=16", "--total_environment_frames=24",
         "--steps_per_call=1", "--log_every_steps=1"]


@pytest.mark.parametrize("flags,net", [
    (["--env=toy", "--lr_decay_multiplier=0.5"], ActorCriticMLP),
    (["--env=toy_memory", "--sac_net=lstm", "--bootstrap_net=q"],
     ActorCriticLSTM),
    (["--env=bit_flipping", "--her_window_length=4",
      "--normalize_observations"], ActorCriticMLP),
    (["--env=catch", "--target_entropy=auto"], VisualActorCritic),
    (["--env=catch_continuous", "--target_entropy=auto"], VisualActorCritic),
    (["--env=discrete_match", "--target_entropy=auto"], ActorCriticMLP),
    (["--env=catch", "--normalize_observations"], VisualActorCritic),
    (["--env=catch_continuous", "--normalize_observations"],
     VisualActorCritic),
])
def test_train_main_sac_on_cpu(flags, net):
    learner, state, metrics = train.main(["--agent=sac"] + SMALL + flags)
    assert isinstance(learner.net, net)
    her = "--her_window_length=4" in flags
    assert state.step == (2 if her else 3)
    assert state.batches == state.step
    assert learner.optimizer.count == state.step
    assert state.replay.num_inserted >= 16
    assert all(math.isfinite(float(v)) for v in metrics.values())
    assert all(t.device.type == "cpu" for t in
               learner.parameters() + learner.state_tensors(state))
    config = learner.config
    if "--target_entropy=auto" in flags:
        assert config.target_entropy == (-1.0)
    if her:
        assert config.her_window_length == 4 and config.unroll_length == 2
        assert learner.engine.unroll_length == 4
        assert learner.agent.normalize_observations
        assert float(learner.agent.obs_norm.steps) > 0
        assert learner.agent.obs_norm.mean.shape == (10 + 10 + 21,)
    elif "--normalize_observations" in flags:
        # One statistic per channel of the frames, as JAX sizes them.
        spec = learner.engine.env.observation_spec()
        assert learner.agent.obs_norm.mean.shape == (spec.shape[-1],)
        assert float(learner.agent.obs_norm.steps) > 0
    if "--lr_decay_multiplier=0.5" in flags:
        # The 3 updates of the budget, one a step: the decay ends at 3.
        lr = learner.optimizer.schedule
        assert lr(2) > lr(3) == lr(4) == pytest.approx(0.5 * lr(0))


@pytest.mark.parametrize("flags,error", [
    (["--env=toy", "--her_window_length=4"], ValueError),
    (["--env=bit_flipping", "--her_window_length=2"], ValueError),
    (["--env=toy", "--train_batches_per_step=4"], ValueError),
    (["--env=toy", "--update_target_every_n_step=1"], ValueError),
    (["--env=catch", "--sac_net=lstm"], ValueError),
    (["--env=toy", "--replay_buffer_size=8"], ValueError),
    (["--env=synthetic_atari"], NotImplementedError),
])
def test_train_main_sac_refuses(flags, error):
    with pytest.raises(error):
        train.main(["--agent=sac"] + SMALL + flags)


def test_sac_learner_refuses_a_min_size_past_the_buffer():
    env = BatchedEnv(ToyEnv(), 2, device="cpu")
    dist = tpd.NormalTanhDistribution(3)
    agent = sac.SACAgent(ActorCriticMLP(dist.param_size,
                                        env.observation_spec(),
                                        device="cpu"), dist)
    with pytest.raises(ValueError, match="exceeds the buffer"):
        sac.SACLearner(
            RolloutEngine(env, agent, 1), agent,
            sac.SACConfig(replay_buffer_size=8, replay_buffer_min_size=9),
            functools.partial(optim.ClippedAdam, learning_rate=1e-3))
