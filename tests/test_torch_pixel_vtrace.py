"""V-trace from pixels in seed_rl_torch against the JAX package.

The whole slice: the JAX RolloutEngine runs Catch frames through a pixel
net (``AtariPolicyNet`` with stacked frames and an LSTM, or
``ImpalaDeep``) and produces one unroll, which starts mid-stream with a
live agent state (frame history included). That unroll and the JAX
learner's parameters (carried over with models/convert.py) go through the
JAX ``compute_loss`` / ``VTraceLearner.update`` and through the port's.
Loss, every metric and every gradient agree within rtol 1e-4 / atol 1e-5
(sums, the convolutions' too, run in another order); the parameters after
one clip + Adam step within rtol 1e-3 / atol 1e-4, because Adam's first
step moves each weight by lr * g / (|g| + eps): a gradient element near
eps in size (a few of ImpalaDeep's conv weights) turns the convolutions'
summation-order difference of ~1e-9 into a share of lr. Then
deterministic evaluation (mirroring tests/test_eval_export.py), the CLI's
pixel paths on the CPU, its refusals, and a learning test from pixels
(mirroring tests/test_catch.py).
"""

import functools
import math

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from seed_rl_tpu import distributions as jpd
from seed_rl_tpu.agent import PolicyAgent as JaxPolicyAgent
from seed_rl_tpu.agents import vtrace as jax_vtrace
from seed_rl_tpu.envs import BatchedEnv as JaxBatchedEnv
from seed_rl_tpu.envs.catch import CatchEnv as JaxCatchEnv
from seed_rl_tpu.models import atari as jax_atari
from seed_rl_tpu.models import resnets as jax_resnets
from seed_rl_tpu.rollout import RolloutEngine as JaxRolloutEngine
from seed_rl_torch import distributions as tpd
from seed_rl_torch import optim, train
from seed_rl_torch.agent import PolicyAgent
from seed_rl_torch.agents import vtrace
from seed_rl_torch.envs import BatchedEnv, CatchEnv
from seed_rl_torch.evaluation import run_eval
from seed_rl_torch.models import AgentState, AtariPolicyNet, ImpalaDeep
from seed_rl_torch.models import convert
from seed_rl_torch.rollout import RolloutEngine, Timestep, Unroll
from seed_rl_torch.types import AgentOutput, EnvOutput
from seed_rl_torch.utils import episode_stats

TOL = dict(rtol=1e-4, atol=1e-5)
# The parameters after one Adam step (see the module docstring).
UPDATED_TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread, so that the other test
    processes sharing the cores do not stall every op's thread barrier
    (see tests/test_torch_vtrace_agent.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
# 36x36 frames for the Nature-DQN torso (its smallest), 12x12 for ImpalaDeep.
CATCH = {"atari": dict(rows=6, cols=6, cell_pixels=6, balls_per_episode=2),
         "impala": dict(rows=6, cols=6, cell_pixels=2, balls_per_episode=2)}


def _tensor(x):
    return torch.tensor(np.asarray(x))


def _agent_state(state):
    if isinstance(state, jax_atari.AgentState):
        return AgentState(*(jax.tree.map(_tensor, part) for part in state))
    return jax.tree.map(_tensor, state)


def _torch_unroll(unroll):
    ts = unroll.timesteps
    return Unroll(
        agent_state=_agent_state(unroll.agent_state),
        timesteps=Timestep(
            prev_action=_tensor(ts.prev_action),
            env_output=EnvOutput(*map(_tensor, ts.env_output)),
            agent_output=AgentOutput(*map(_tensor, ts.agent_output)),
        ),
    )


def _nets(kind):
    if kind == "atari":
        return (jax_atari.AtariPolicyNet(3, frame_shape=(36, 36),
                                         stack_size=3, lstm_size=16),
                AtariPolicyNet(3, frame_shape=(36, 36), stack_size=3,
                               lstm_size=16, device="cpu"))
    return (jax_resnets.ImpalaDeep(num_actions=3, lstm_size=16),
            ImpalaDeep(3, (12, 12, 1), lstm_size=16, device="cpu"))


def _assert_tree_close(named_tensors, converted, what, tol=TOL):
    assert set(named_tensors) == set(converted), what
    for name, got in named_tensors.items():
        np.testing.assert_allclose(
            got.detach().numpy(), converted[name].numpy(), **tol,
            err_msg=f"{what}: {name}",
        )


@pytest.mark.parametrize("kind", sorted(CATCH))
def test_train_step_on_catch_frames_matches_jax(kind):
    B, T, lr = 6, 8, 1e-3
    jnet, tnet = _nets(kind)
    config = dict(entropy_cost=0.01, discounting=0.95)
    jconfig = jax_vtrace.VTraceConfig(**config)
    tconfig = vtrace.VTraceConfig(**config)

    jdist = jpd.CategoricalDistribution(3)
    jagent = JaxPolicyAgent(jnet, jdist)
    jengine = JaxRolloutEngine(
        JaxBatchedEnv(JaxCatchEnv(**CATCH[kind]), B), jagent, T)
    jlearner = jax_vtrace.VTraceLearner(
        jengine, jagent, jconfig,
        optax.chain(optax.clip_by_global_norm(40.0), optax.adam(lr)))
    jstate = jlearner.init(jax.random.PRNGKey(0))
    # Two rollouts, so the unroll starts mid-stream with a live state.
    rollout = jax.jit(jengine.rollout)
    _, unroll = rollout(
        jstate.params["net"], rollout(jstate.params["net"], jstate.rollout)[0]
    )
    assert bool(jnp.any(unroll.timesteps.env_output.done))
    assert bool(jnp.any(unroll.timesteps.env_output.reward != 0))
    loss_rng = jax.random.PRNGKey(7)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        functools.partial(jax_vtrace.compute_loss, jconfig, jagent, jdist),
        has_aux=True,
    ))(jstate.params, unroll, loss_rng)
    jnew, jupdate_metrics = jax.jit(jlearner.update)(jstate, unroll, loss_rng)

    params = jax.tree.map(np.asarray, jstate.params)
    state_dict, entropy_cost = convert.vtrace_params(tnet, params)
    tnet.load_state_dict(state_dict, strict=True)
    tagent = PolicyAgent(tnet, tpd.CategoricalDistribution(3))
    tlearner = vtrace.VTraceLearner(
        RolloutEngine(BatchedEnv(CatchEnv(**CATCH[kind]), B, device="cpu"),
                      tagent, T),
        tagent, tconfig,
        functools.partial(optim.ClippedAdam, learning_rate=lr,
                          clip_norm=40.0),
    )
    with torch.no_grad():
        tlearner.entropy_cost.copy_(entropy_cost)
    tunroll = _torch_unroll(unroll)

    loss, metrics = vtrace.compute_loss(
        tconfig, tagent, tagent.distribution, tlearner.entropy_cost, tunroll)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   **TOL, err_msg=k)

    grads = torch.autograd.grad(loss, tlearner.parameters())
    names = [n for n, _ in tnet.named_parameters()] + ["entropy_cost"]
    want_net, want_ec = convert.vtrace_params(
        tnet, jax.tree.map(np.asarray, jgrads))
    _assert_tree_close(dict(zip(names, grads)),
                       dict(want_net, entropy_cost=want_ec), "grad")

    tnew, update_metrics = tlearner.update(tlearner.init(), tunroll)
    for k in update_metrics:
        np.testing.assert_allclose(float(update_metrics[k]),
                                   float(jupdate_metrics[k]), **TOL,
                                   err_msg=k)
    want_net, want_ec = convert.vtrace_params(
        tnet, jax.tree.map(np.asarray, jnew.params))
    _assert_tree_close(
        dict(tnet.named_parameters(), entropy_cost=tlearner.entropy_cost),
        dict(want_net, entropy_cost=want_ec), "updated param", UPDATED_TOL,
    )
    assert tnew.step == int(jnew.step) == 1
    for got, want in zip(tnew.stats, jnew.stats):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _catch_agent(num_envs, seed=0):
    env = BatchedEnv(CatchEnv(rows=6, cols=6, cell_pixels=6,
                              balls_per_episode=3), num_envs, device="cpu")
    net = AtariPolicyNet(3, frame_shape=(36, 36), stack_size=2, lstm_size=8,
                         seed=seed, device="cpu")
    return env, PolicyAgent(net, tpd.CategoricalDistribution(3))


def test_run_eval_collects_episodes():
    env, agent = _catch_agent(8)
    metrics = run_eval(env, agent, num_episodes=16, unroll_length=10)
    assert metrics["eval/num_episodes"] >= 16
    # Every Catch episode is balls * (rows - 1) steps.
    assert metrics["eval/mean_length"] == 15.0
    assert -3.0 <= metrics["eval/mean_return"] <= 3.0


def test_run_eval_is_deterministic():
    env, agent = _catch_agent(4, seed=1)
    m1 = run_eval(env, agent, num_episodes=8, unroll_length=10, seed=3)
    m2 = run_eval(env, agent, num_episodes=8, unroll_length=10, seed=3)
    assert m1 == m2


def test_deterministic_rollout_acts_by_the_mode():
    env, agent = _catch_agent(4)
    engine = RolloutEngine(env, agent, 5, deterministic=True)
    _, unroll = engine.rollout(engine.init())
    out = unroll.timesteps.agent_output
    torch.testing.assert_close(
        out.action, torch.argmax(out.policy_logits, -1).to(out.action.dtype),
        rtol=0, atol=0)


def test_vtrace_learns_catch_from_pixels():
    """A conv+LSTM policy improves substantially on Catch from pixels."""
    num_envs = 32
    env = BatchedEnv(
        CatchEnv(rows=6, cols=6, cell_pixels=6, balls_per_episode=3),
        num_envs, device="cpu", seed=1,
    )
    net = AtariPolicyNet(3, frame_shape=(36, 36), stack_size=2, lstm_size=32,
                         seed=1, device="cpu")
    agent = PolicyAgent(net, tpd.CategoricalDistribution(3))
    learner = vtrace.VTraceLearner(
        RolloutEngine(env, agent, unroll_length=10, seed=2), agent,
        vtrace.VTraceConfig(entropy_cost=0.01),
        functools.partial(optim.ClippedAdam, learning_rate=1e-3,
                          clip_norm=40.0),
        seed=3,
    )

    def window_return(s):
        n = float(s.stats.num_episodes)
        assert n > 0
        return float(s.stats.sum_return) / n

    # 260 train steps of small ops: one intra-op thread, so that other test
    # processes sharing the cores do not stall every op's thread barrier.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state, _ = learner.train_many(learner.init(), 10)
        early = window_return(state)
        state = state._replace(stats=episode_stats.reset_window(state.stats))
        for _ in range(25):
            state, _ = learner.train_many(state, 10)
        late = window_return(state)
    finally:
        torch.set_num_threads(threads)
    # Random is ~ -3 + balls/cols * 6 ~= -2; optimal is +3. Require a
    # decisive improvement over the early window.
    assert late > early + 1.0, (early, late)
    assert late > 0.5, (early, late)


@pytest.mark.parametrize("env", ["catch", "synthetic_atari"])
@pytest.mark.parametrize("conv_net", ["auto", "impala_deep"])
def test_train_main_on_pixels_on_cpu(env, conv_net):
    learner, state, metrics = train.main([
        "--agent=vtrace", f"--env={env}", f"--conv_net={conv_net}",
        "--device=cpu", "--num_envs=4", "--unroll_length=3",
        "--total_environment_frames=24", "--steps_per_call=1",
        "--log_every_steps=1",
    ])
    assert state.step == 2
    assert all(math.isfinite(float(v)) for v in metrics.values())
    net = learner.agent.net
    obs = learner.engine.env.observation_spec()
    assert tuple(obs.shape) == (84, 84, 1) and obs.dtype == torch.uint8
    if conv_net == "auto":
        assert isinstance(net, AtariPolicyNet)
        assert (net.stack_size, net.lstm_size) == (4, 256)
    else:
        assert isinstance(net, ImpalaDeep) and not net.remat
    actions = learner.engine.env.action_space.n
    assert net.policy_logits.out_features == actions == (
        3 if env == "catch" else 18)


def test_train_main_remat_torso_on_cpu():
    learner, state, _ = train.main([
        "--agent=vtrace", "--env=catch", "--conv_net=impala_deep",
        "--remat_torso", "--device=cpu", "--num_envs=2", "--unroll_length=2",
        "--total_environment_frames=4", "--steps_per_call=1",
        "--log_every_steps=1",
    ])
    assert state.step == 1 and learner.agent.net.remat


@pytest.mark.parametrize("argv,error", [
    (["--env=catch", "--conv_net=atari"], ValueError),
    (["--env=toy", "--conv_net=impala_deep"], ValueError),
    (["--env=catch", "--remat_torso"], ValueError),
    (["--env=synthetic_atari", "--normalize_observations"],
     NotImplementedError),
    (["--env=catch_continuous"], NotImplementedError),
    (["--agent=r2d2", "--env=synthetic_atari_host",
      "--normalize_observations"], NotImplementedError),
    (["--agent=sac", "--env=synthetic_atari"], NotImplementedError),
])
def test_train_main_refuses_pixel_options_it_does_not_take(argv, error):
    with pytest.raises(error):
        train.main(["--agent=vtrace", "--device=cpu"] + argv)
