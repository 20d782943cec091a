"""The port's V-trace train step (seed_rl_torch.agents.vtrace) against JAX.

The whole slice: the JAX RolloutEngine produces one unroll; that unroll and
the JAX learner's parameters (carried over with models/convert.py) go
through the JAX ``compute_loss`` / ``VTraceLearner.update`` and through the
port's. The entropy estimate's normal draw is made in JAX and injected.
Loss, every metric, every gradient (the entropy-cost scalar included) and
the parameters after one clip + Adam step agree within rtol 1e-4 / atol
1e-5 (sums run in another order). Then the port learns the toy env on its
own (mirroring tests/test_vtrace_agent.py) and its CLI trains on the CPU.
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
from seed_rl_tpu.envs import ToyEnv as JaxToyEnv
from seed_rl_tpu.models import MLPAndLSTM as JaxMLPAndLSTM
from seed_rl_tpu.models import MLPPolicyNetwork as JaxMLPPolicyNetwork
from seed_rl_tpu.rollout import RolloutEngine as JaxRolloutEngine
from seed_rl_torch import distributions as tpd
from seed_rl_torch import optim, train
from seed_rl_torch.agent import PolicyAgent
from seed_rl_torch.agents import vtrace
from seed_rl_torch.envs import BatchedEnv, ToyEnv
from seed_rl_torch.models import MLPAndLSTM, MLPPolicyNetwork, convert
from seed_rl_torch.rollout import RolloutEngine, Timestep, Unroll
from seed_rl_torch.types import AgentOutput, EnvOutput
from seed_rl_torch.utils import episode_stats

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread, so that the other test
    processes sharing the cores do not stall every op's thread barrier
    (with torch's default, six test workers on a loaded 8-core machine ran
    test_vtrace_learns_toy_env in 487 s, against 4.7 s alone on one
    thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

SLICE_CASES = {
    "lstm-defaults": dict(
        net="lstm", clip_norm=40.0, lr=3e-4, config=dict()),
    "mlp-clipped-kl-target-entropy": dict(
        net="mlp", clip_norm=0.05, lr=1e-3,
        config=dict(lambda_=0.9, kl_cost=0.5, target_entropy=-2.0,
                    max_abs_reward=1.0, discounting=0.9)),
}


def _tensor(x):
    return torch.tensor(np.asarray(x))


def _torch_unroll(unroll):
    ts = unroll.timesteps
    return Unroll(
        agent_state=jax.tree.map(_tensor, unroll.agent_state),
        timesteps=Timestep(
            prev_action=_tensor(ts.prev_action),
            env_output=EnvOutput(*map(_tensor, ts.env_output)),
            agent_output=AgentOutput(*map(_tensor, ts.agent_output)),
        ),
    )


def _nets(kind):
    if kind == "lstm":
        return (JaxMLPAndLSTM(6, mlp_sizes=(16,), lstm_sizes=(8,)),
                MLPAndLSTM(6, 4, mlp_sizes=(16,), lstm_sizes=(8,),
                           device="cpu"))
    return (JaxMLPPolicyNetwork(6, mlp_sizes=(16, 16)),
            MLPPolicyNetwork(6, 4, mlp_sizes=(16, 16), device="cpu"))


def _assert_tree_close(named_tensors, converted, what):
    assert set(named_tensors) == set(converted), what
    for name, got in named_tensors.items():
        np.testing.assert_allclose(
            got.detach().numpy(), converted[name].numpy(), **TOL,
            err_msg=f"{what}: {name}",
        )


@pytest.mark.parametrize("case", sorted(SLICE_CASES))
def test_train_step_matches_jax(case):
    spec = SLICE_CASES[case]
    B, T = 8, 6
    jnet, tnet = _nets(spec["net"])
    jconfig = jax_vtrace.VTraceConfig(**spec["config"])
    tconfig = vtrace.VTraceConfig(**spec["config"])

    # JAX: one unroll from its engine, then grads and one update.
    jdist = jpd.NormalTanhDistribution(3)
    jagent = JaxPolicyAgent(jnet, jdist)
    jengine = JaxRolloutEngine(JaxBatchedEnv(JaxToyEnv(horizon=3), B),
                               jagent, T)
    jlearner = jax_vtrace.VTraceLearner(
        jengine, jagent, jconfig,
        optax.chain(optax.clip_by_global_norm(spec["clip_norm"]),
                    optax.adam(spec["lr"])),
    )
    jstate = jlearner.init(jax.random.PRNGKey(0))
    # Two rollouts, so the unroll starts mid-stream with a live core state.
    rollout = jax.jit(jengine.rollout)
    _, unroll = rollout(
        jstate.params["net"], rollout(jstate.params["net"], jstate.rollout)[0]
    )
    loss_rng = jax.random.PRNGKey(7)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        functools.partial(jax_vtrace.compute_loss, jconfig, jagent, jdist),
        has_aux=True,
    ))(jstate.params, unroll, loss_rng)
    jnew, jupdate_metrics = jax.jit(jlearner.update)(jstate, unroll, loss_rng)
    # The draw compute_loss's entropy estimate makes from loss_rng.
    noise = _tensor(jax.random.normal(loss_rng, (T, B, 3), jnp.float32))

    # Port: same params, same unroll, same noise.
    params = jax.tree.map(np.asarray, jstate.params)
    state_dict, entropy_cost = convert.vtrace_params(tnet, params)
    tnet.load_state_dict(state_dict, strict=True)
    tagent = PolicyAgent(tnet, tpd.NormalTanhDistribution(3))
    tlearner = vtrace.VTraceLearner(
        RolloutEngine(BatchedEnv(ToyEnv(horizon=3), B, device="cpu"),
                      tagent, T),
        tagent, tconfig,
        functools.partial(optim.ClippedAdam, learning_rate=spec["lr"],
                          clip_norm=spec["clip_norm"]),
    )
    with torch.no_grad():
        tlearner.entropy_cost.copy_(entropy_cost)
    tunroll = _torch_unroll(unroll)

    loss, metrics = vtrace.compute_loss(
        tconfig, tagent, tagent.distribution, tlearner.entropy_cost,
        tunroll, entropy_noise=noise,
    )
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   **TOL, err_msg=k)

    grads = torch.autograd.grad(loss, tlearner.parameters())
    names = [n for n, _ in tnet.named_parameters()] + ["entropy_cost"]
    jgrads = jax.tree.map(np.asarray, jgrads)
    want_net, want_ec = convert.vtrace_params(tnet, jgrads)
    _assert_tree_close(dict(zip(names, grads)),
                       dict(want_net, entropy_cost=want_ec), "grad")

    tstate = tlearner.init()
    tnew, update_metrics = tlearner.update(tstate, tunroll,
                                           entropy_noise=noise)
    for k in update_metrics:
        np.testing.assert_allclose(float(update_metrics[k]),
                                   float(jupdate_metrics[k]), **TOL,
                                   err_msg=k)
    want_net, want_ec = convert.vtrace_params(
        tnet, jax.tree.map(np.asarray, jnew.params)
    )
    _assert_tree_close(
        dict(tnet.named_parameters(), entropy_cost=tlearner.entropy_cost),
        dict(want_net, entropy_cost=want_ec), "updated param",
    )
    assert tnew.step == int(jnew.step) == 1
    for got, want in zip(tnew.stats, jnew.stats):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_entropy_cost_param_is_clipped_after_update():
    learner = _make_learner(num_envs=4, unroll_length=3)
    with torch.no_grad():
        learner.entropy_cost.fill_(5.0)  # beyond 20 / speed = 2
    state, _ = learner.train_step(learner.init())
    assert float(learner.entropy_cost.detach()) == pytest.approx(2.0)


def test_clipped_adam_matches_optax_with_linear_schedule():
    rng = np.random.RandomState(0)
    shapes = [(3, 4), (5,), ()]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * 3 for s in shapes]
             for _ in range(4)]
    schedule = optax.linear_schedule(1e-2, 2e-3, transition_steps=3)
    tx = optax.chain(optax.clip_by_global_norm(2.0),
                     optax.adam(schedule, b1=0.5, eps=1e-6))
    jparams = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(np.array(p)))
               for p in params]
    adam = optim.ClippedAdam(tparams, optim.linear_schedule(1e-2, 2e-3, 3),
                             clip_norm=2.0, b1=0.5, eps=1e-6)
    for g in grads:
        updates, opt_state = tx.update([jnp.asarray(x) for x in g],
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, x in zip(tparams, g):
            p.grad = torch.from_numpy(np.array(x))
        adam.step()
        for got, want in zip(tparams, jparams):
            np.testing.assert_allclose(got.detach().numpy(), want,
                                       rtol=1e-5, atol=1e-6)
    assert adam.learning_rate() == pytest.approx(2e-3)


def test_clip_by_global_norm_leaves_small_grads_alone():
    grads = [torch.tensor([0.3, 0.4])]
    norm = optim.clip_by_global_norm_(grads, 1.0)
    assert float(norm) == pytest.approx(0.5)
    torch.testing.assert_close(grads[0], torch.tensor([0.3, 0.4]))
    grads = [torch.tensor([3.0, 4.0])]
    optim.clip_by_global_norm_(grads, 1.0)
    torch.testing.assert_close(grads[0], torch.tensor([0.6, 0.8]))


def _make_learner(num_envs=64, unroll_length=10, lstm=False):
    env = BatchedEnv(ToyEnv(horizon=3), num_envs, device="cpu")
    dist = tpd.NormalTanhDistribution(3)
    if lstm:
        net = MLPAndLSTM(dist.param_size, 4, mlp_sizes=(32,),
                         lstm_sizes=(16,), device="cpu")
    else:
        net = MLPPolicyNetwork(dist.param_size, 4, mlp_sizes=(32, 32),
                               device="cpu")
    agent = PolicyAgent(net, dist)
    config = vtrace.VTraceConfig(
        discounting=0.9, entropy_cost=1e-3, lambda_=1.0
    )
    return vtrace.VTraceLearner(
        RolloutEngine(env, agent, unroll_length), agent, config,
        functools.partial(optim.ClippedAdam, learning_rate=3e-3),
    )


def _mean_return(state):
    n = float(state.stats.num_episodes)
    assert n > 0
    return float(state.stats.sum_return) / n


def test_vtrace_learns_toy_env():
    learner = _make_learner()
    state = learner.init()
    state, _ = learner.train_many(state, 50)
    early_return = _mean_return(state)
    state = state._replace(stats=episode_stats.reset_window(state.stats))
    state, metrics = learner.train_many(state, 350)
    late_return = _mean_return(state)
    # ToyEnv optimum is ~0; random ~ -2 per step. Require clear learning.
    assert late_return > early_return + 1.0, (early_return, late_return)
    assert late_return > -2.0, late_return
    assert math.isfinite(float(metrics["losses/total"]))


def test_vtrace_lstm_variant_trains_one_step():
    learner = _make_learner(num_envs=8, unroll_length=6, lstm=True)
    state, metrics = learner.train_step(learner.init())
    assert state.step == 1
    assert math.isfinite(float(metrics["losses/total"]))


def test_learner_loop_counts_steps():
    learner = _make_learner(num_envs=8, unroll_length=5)
    state, metrics = vtrace.learner_loop(
        learner, total_environment_frames=8 * 5 * 4, steps_per_call=2,
        log_every_steps=2,
    )
    assert state.step == 4
    assert math.isfinite(float(metrics["losses/total"]))
    with pytest.raises(ValueError):
        vtrace.learner_loop(learner, 40, log_every_steps=1, steps_per_call=2)


@pytest.mark.parametrize("env", ["toy", "toy_memory"])
def test_train_main_on_cpu(env):
    learner, state, metrics = train.main([
        "--agent=vtrace", f"--env={env}", "--device=cpu",
        "--num_envs=8", "--unroll_length=5", "--total_environment_frames=80",
        "--steps_per_call=1", "--log_every_steps=1",
        "--lr_decay_multiplier=0.5",
    ])
    assert state.step == 2
    assert all(math.isfinite(float(v)) for v in metrics.values())
    assert isinstance(learner.agent.net, MLPAndLSTM)
    assert learner.agent.net.lstm_sizes == (64,)
    # Linear decay over the 2 updates of the budget, as optax counts them.
    assert learner.optimizer.learning_rate() == pytest.approx(1.5e-4)


@pytest.mark.parametrize("flag", [
    # SAC on discrete_match, --agent_module and a learner on a device
    # env's specs are ported (tests/test_torch_sac.py, tests/
    # test_torch_agent_module.py, tests/test_torch_remote.py); V-trace on
    # discrete_match and R2D2 on toy are not.
    "--agent=vtrace", "--env=toy", "--run_mode=actor",
    "--normalize_observations",
])
def test_train_main_refuses_what_is_not_ported(flag):
    argv = ["--agent=r2d2", "--env=discrete_match", "--device=cpu", flag]
    with pytest.raises(NotImplementedError, match="not ported"):
        train.main(argv)


@pytest.mark.parametrize("flag", ["--run_mode=eval", "--logdir",
                                  "--init_checkpoint"])
def test_train_main_takes_the_checkpoint_flags(flag, tmp_path, capsys):
    """What the refusals above held back until checkpoints were ported."""
    argv = ["--agent=vtrace", "--env=toy", "--device=cpu", "--num_envs=8",
            "--unroll_length=5", "--total_environment_frames=40",
            "--steps_per_call=1", "--log_every_steps=1"]
    train.main(argv + [f"--logdir={tmp_path / 'source'}"])
    extra = {
        "--run_mode=eval": [f"--logdir={tmp_path / 'source'}", flag],
        "--logdir": [f"--logdir={tmp_path / 'source'}",
                     "--total_environment_frames=80"],
        "--init_checkpoint": [f"--logdir={tmp_path / 'warm'}",
                              f"--init_checkpoint={tmp_path / 'source'}",
                              "--total_environment_frames=80"],
    }[flag]
    capsys.readouterr()
    _, state, metrics = train.main(argv + extra)
    if flag == "--run_mode=eval":
        assert state.step == 1 and metrics["eval/restored_step"] == 1
        assert '"eval/restored_step": 1' in capsys.readouterr().out
    else:  # resumed or warm-started at step 1, then one more step
        assert state.step == 2
        assert all(math.isfinite(float(v)) for v in metrics.values())
