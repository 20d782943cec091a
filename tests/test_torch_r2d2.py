"""The port's R2D2 (seed_rl_torch.agents.r2d2) against the JAX package.

- ``DiscreteMatchEnv`` steps like JAX's given the same targets;
- ``VectorDuelingDQNNet`` (flax params carried over with models/convert.py)
  gives the same Q values, greedy actions and core states, one step and
  unrolled with ``done`` resets, within rtol = atol = 1e-5;
- epsilon-greedy ``policy_step`` with JAX's draws injected, and the
  epsilon ladder;
- ``unroll_to_items`` (eval envs dropped) and ``initial_priorities``
  (n-step and Retrace) on one JAX unroll;
- the whole slice: the JAX learner's replay, its sampled indices, its
  online and (different) target parameters go through JAX
  ``compute_loss_and_priorities`` + optax clip + Adam and through the
  port's ``train_on_batch``; loss, priorities, importance weights, every
  gradient and the updated parameters agree within rtol 1e-4 / atol 1e-5
  (float32 sums run in another order);
- the target network's schedule, warmup inserting training envs only, the
  port learning ``discrete_match`` on its own (mirroring
  tests/test_r2d2.py) and its CLI on the CPU.
"""

import functools
import math

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from seed_rl_tpu.agents import r2d2 as jax_r2d2
from seed_rl_tpu.envs import BatchedEnv as JaxBatchedEnv
from seed_rl_tpu.envs import toy as jax_toy
from seed_rl_tpu.models.dueling_mlp import (
    VectorDuelingDQNNet as JaxVectorDuelingDQNNet,
)
from seed_rl_tpu.rollout import RolloutEngine as JaxRolloutEngine
from seed_rl_tpu.types import EnvOutput as JaxEnvOutput
from seed_rl_torch import optim, train
from seed_rl_torch.agents import r2d2
from seed_rl_torch.envs import BatchedEnv, DiscreteMatchEnv
from seed_rl_torch.models import VectorDuelingDQNNet, convert
from seed_rl_torch.replay import ReplayState
from seed_rl_torch.rollout import RolloutEngine, Timestep, Unroll
from seed_rl_torch.types import EnvOutput, QAgentOutput
from seed_rl_torch.utils import episode_stats

NET_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-5)
A, OBS = 4, 4
SMALL_NET = dict(mlp_sizes=(16,), lstm_size=8, hidden_size=16)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread, so that the other test
    processes sharing the cores do not stall every op's thread barrier
    (see tests/test_torch_vtrace_agent.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tree_t(tree):
    """A JAX pytree of arrays -> the same tuples of torch tensors."""
    return jax.tree.map(_t, tree)


def _jax_nets(key=0, **kw):
    """Flax net + params and the port's net holding the same weights."""
    jnet = JaxVectorDuelingDQNNet(num_actions=A, **kw)
    B = 3
    env_output = JaxEnvOutput(
        reward=jnp.zeros((B,)), done=jnp.zeros((B,), bool),
        observation=jnp.zeros((B, OBS)), abandoned=jnp.zeros((B,), bool),
        episode_step=jnp.zeros((B,), jnp.int32),
    )
    params = jnet.init(jax.random.PRNGKey(key), jnp.zeros((B,), jnp.int32),
                       env_output, jnet.initial_state(B))
    params = jax.tree.map(np.asarray, params)
    tnet = VectorDuelingDQNNet(A, OBS, device="cpu", **kw)
    tnet.load_state_dict(convert.state_dict_for(tnet, params), strict=True)
    return jnet, tnet, params


def _env_output(rng, lead, done_p):
    return dict(
        reward=rng.binomial(1, 0.5, lead).astype(np.float32),
        done=rng.uniform(size=lead) < done_p,
        observation=np.eye(OBS, dtype=np.float32)[rng.randint(0, OBS, lead)],
        abandoned=np.zeros(lead, bool),
        episode_step=np.zeros(lead, np.int32),
    )


def test_discrete_match_env_matches_jax_given_targets():
    B = 6
    env = DiscreteMatchEnv(n_actions=A, horizon=3)
    g = torch.Generator()
    g.manual_seed(0)
    state, obs = env.reset(B, g)
    assert torch.equal(obs, torch.eye(A)[state.target])
    jenv = jax_toy.DiscreteMatchEnv(n_actions=A, horizon=3)
    rng = np.random.RandomState(0)
    for _ in range(4):
        action = torch.from_numpy(rng.randint(0, A, B).astype(np.int32))
        jstate = jax_toy._MatchState(
            t=jnp.asarray(state.t.numpy()),
            target=jnp.asarray(state.target.numpy().astype(np.int32)),
            rng=jax.random.split(jax.random.PRNGKey(1), B),
        )
        jres = jax.vmap(jenv.step)(jstate, jnp.asarray(action.numpy()))
        res = env.step(state, action, g)
        np.testing.assert_array_equal(res.reward.numpy(), jres.reward)
        np.testing.assert_array_equal(res.terminated.numpy(), jres.terminated)
        np.testing.assert_array_equal(res.abandoned.numpy(), jres.abandoned)
        np.testing.assert_array_equal(res.state.t.numpy(), jres.state.t)
        assert torch.equal(res.observation, torch.eye(A)[res.state.target])
        state = res.state
    assert env.action_space.n == A
    assert env.observation_spec().shape == (A,)


@pytest.mark.parametrize("kw", [SMALL_NET, {}], ids=["small", "default"])
def test_dueling_net_step_and_unroll_match_flax(kw):
    jnet, tnet, params = _jax_nets(**kw)
    lstm = kw.get("lstm_size", 64)
    rng = np.random.RandomState(1)
    T, B = 6, 5
    eo = _env_output(rng, (T, B), done_p=0.3)
    prev = rng.randint(0, A, (T, B)).astype(np.int32)
    state = ((rng.normal(size=(B, lstm)).astype(np.float32),
              rng.normal(size=(B, lstm)).astype(np.float32)),)

    # One step.
    step_eo = {k: v[0] for k, v in eo.items()}
    jout, jstate = jnet.apply(params, jnp.asarray(prev[0]),
                              JaxEnvOutput(**step_eo), state)
    tout, tstate = tnet(_t(prev[0]), EnvOutput(**_tree_t(step_eo)),
                        _tree_t(state))
    assert isinstance(tout, QAgentOutput)
    np.testing.assert_allclose(tout.q_values.detach().numpy(), jout.q_values,
                               **NET_TOL)
    np.testing.assert_array_equal(tout.action.numpy(), jout.action)
    assert tout.action.dtype == torch.int32
    for got, want in zip(jax.tree.leaves(_tree_t(jstate)),
                         jax.tree.leaves(tstate)):
        np.testing.assert_allclose(want.detach().numpy(), got.numpy(),
                                   **NET_TOL)

    # Time-major unroll with done resets (JAX: lax.scan of the step).
    jagent = jax_r2d2.R2D2Agent(jnet, jnp.zeros((B,)))
    jouts, jfinal = jagent.unroll(params, jnp.asarray(prev),
                                  JaxEnvOutput(**eo), state)
    touts, tfinal = tnet.unroll(_t(prev), EnvOutput(**_tree_t(eo)),
                                _tree_t(state))
    np.testing.assert_allclose(touts.q_values.detach().numpy(),
                               jouts.q_values, **NET_TOL)
    np.testing.assert_array_equal(touts.action.numpy(), jouts.action)
    for got, want in zip(jax.tree.leaves(tfinal), jax.tree.leaves(jfinal)):
        np.testing.assert_allclose(got.detach().numpy(), want, **NET_TOL)


def test_epsilon_greedy_policy_step_matches_jax_with_injected_noise():
    jnet, tnet, params = _jax_nets(**SMALL_NET)
    B = 8
    eps = np.array([1.0, 0.0, 0.5, 0.5, 0.9, 0.1, 1.0, 0.0], np.float32)
    rng = np.random.RandomState(2)
    eo = _env_output(rng, (B,), done_p=0.2)
    prev = rng.randint(0, A, B).astype(np.int32)
    state = tnet.initial_state(B)
    jagent = jax_r2d2.R2D2Agent(jnet, jnp.asarray(eps))
    key = jax.random.PRNGKey(3)
    jout, _ = jagent.policy_step(params, jnp.asarray(prev),
                                 JaxEnvOutput(**eo),
                                 jax.tree.map(lambda x: jnp.asarray(x.numpy()),
                                              state), key)
    # The draws policy_step makes from its key.
    rand_rng, pick_rng = jax.random.split(key)
    random_actions = jax.random.randint(rand_rng, (B,), 0, A, jnp.int32)
    uniform = jax.random.uniform(pick_rng, (B,))
    agent = r2d2.R2D2Agent(tnet, torch.from_numpy(eps))
    with torch.no_grad():
        out, _ = agent.policy_step(_t(prev), EnvOutput(**_tree_t(eo)), state,
                                   random_actions=_t(random_actions),
                                   uniform=_t(uniform))
    np.testing.assert_array_equal(out.action.numpy(), jout.action)
    np.testing.assert_allclose(out.q_values.numpy(), jout.q_values,
                               **NET_TOL)
    # Without injected noise the generator draws: epsilon 0 is greedy.
    greedy = torch.argmax(out.q_values, dim=-1)
    g = torch.Generator()
    g.manual_seed(0)
    with torch.no_grad():
        drawn, _ = agent.policy_step(_t(prev), EnvOutput(**_tree_t(eo)),
                                     state, g)
    assert torch.equal(drawn.action[eps == 0], greedy[eps == 0].int())
    np.testing.assert_allclose(
        r2d2.training_env_epsilons(5).numpy(),
        np.asarray(jax_r2d2.training_env_epsilons(5)), rtol=1e-6)


def _jax_learner(num_envs=8, num_eval_envs=2, unroll_length=6, burn_in=2,
                 batch_size=8, buffer_size=32, min_size=12, target="nstep",
                 clip_norm=40.0, lr=1e-3, n_steps=3):
    env = JaxBatchedEnv(jax_toy.DiscreteMatchEnv(n_actions=A, horizon=10),
                        num_envs)
    net = JaxVectorDuelingDQNNet(num_actions=A, **SMALL_NET)
    num_training = num_envs - num_eval_envs
    epsilons = jnp.concatenate([
        jax_r2d2.training_env_epsilons(num_training),
        jnp.full((num_eval_envs,), 1e-3),
    ])
    agent = jax_r2d2.R2D2Agent(net, epsilons)
    engine = JaxRolloutEngine(env, agent, unroll_length,
                              num_overlapping_steps=burn_in)
    config = jax_r2d2.R2D2Config(
        discounting=0.9, n_steps=n_steps, burn_in=burn_in,
        replay_buffer_size=buffer_size, replay_buffer_min_size=min_size,
        batch_size=batch_size, update_target_every_n_step=2,
        num_eval_envs=num_eval_envs, target=target,
    )
    optimizer = optax.chain(optax.clip_by_global_norm(clip_norm),
                            optax.adam(lr))
    return jax_r2d2.R2D2Learner(engine, agent, config, optimizer), config


def _port_learner(config, num_envs=8, unroll_length=6, clip_norm=40.0,
                  lr=1e-3, net_kw=SMALL_NET, seed=0):
    """The port's learner with the JAX config's knobs, on the CPU."""
    env = BatchedEnv(DiscreteMatchEnv(n_actions=A, horizon=10), num_envs,
                     device="cpu", seed=seed)
    net = VectorDuelingDQNNet(A, OBS, device="cpu", seed=seed, **net_kw)
    num_training = num_envs - config.num_eval_envs
    epsilons = torch.cat([r2d2.training_env_epsilons(num_training),
                          torch.full((config.num_eval_envs,), 1e-3)])
    agent = r2d2.R2D2Agent(net, epsilons)
    engine = RolloutEngine(env, agent, unroll_length,
                           num_overlapping_steps=config.burn_in, seed=seed)
    tconfig = r2d2.R2D2Config(**{
        f.name: getattr(config, f.name)
        for f in r2d2.R2D2Config.__dataclass_fields__.values()
    })
    return r2d2.R2D2Learner(
        engine, agent, tconfig,
        functools.partial(optim.ClippedAdam, learning_rate=lr,
                          clip_norm=clip_norm),
        seed=seed,
    )


def _torch_unroll(unroll):
    ts = unroll.timesteps
    return Unroll(
        agent_state=_tree_t(unroll.agent_state),
        timesteps=Timestep(
            prev_action=_t(ts.prev_action),
            env_output=EnvOutput(*map(_t, ts.env_output)),
            agent_output=QAgentOutput(*map(_t, ts.agent_output)),
        ),
    )


def _torch_items(items):
    return r2d2.StoredUnroll(
        agent_state=_tree_t(items.agent_state),
        prev_actions=_t(items.prev_actions),
        env_outputs=EnvOutput(*map(_t, items.env_outputs)),
        agent_outputs=QAgentOutput(*map(_t, items.agent_outputs)),
    )


def test_discrete_engine_starts_from_an_int32_zero_action():
    _, config = _jax_learner()
    state = _port_learner(config).engine.init()
    first = state.carry_timesteps.prev_action[0]
    assert first.dtype == torch.int32
    assert torch.equal(first, torch.zeros(8, dtype=torch.int32))


@pytest.mark.parametrize("target", ["nstep", "retrace"])
def test_unroll_to_items_and_initial_priorities_match_jax(target):
    jlearner, config = _jax_learner(target=target)
    jstate = jax.jit(jlearner.init)(jax.random.PRNGKey(0))
    _, unroll = jax.jit(jlearner.engine.rollout)(jstate.params,
                                                 jstate.rollout)
    jitems = jax_r2d2.unroll_to_items(unroll, 6)
    want = jax_r2d2.initial_priorities(config, jitems)

    items = r2d2.unroll_to_items(_torch_unroll(unroll), 6)
    for got, ref in zip(jax.tree.leaves(items), jax.tree.leaves(jitems)):
        np.testing.assert_array_equal(got.numpy(), ref)
    assert items.prev_actions.shape == (6, 2 + 6 + 1)  # eval envs dropped
    got = r2d2.initial_priorities(_port_learner(config).config, items)
    np.testing.assert_allclose(got.numpy(), want, **NET_TOL)


def _named(net, tree):
    want = convert.state_dict_for(net, tree)
    return {n: want[n].numpy() for n, _ in net.named_parameters()}


SLICE_CASES = {
    # The R2D2 path of this slice, with the clip active.
    "nstep-burn-in": dict(target="nstep", burn_in=2, clip_norm=0.05),
    "retrace-no-burn-in": dict(target="retrace", burn_in=0, clip_norm=40.0),
}


@pytest.mark.parametrize("case", sorted(SLICE_CASES))
def test_train_on_batch_matches_jax(case):
    spec = SLICE_CASES[case]
    jlearner, config = _jax_learner(
        target=spec["target"], burn_in=spec["burn_in"],
        clip_norm=spec["clip_norm"])
    jstate = jax.jit(jlearner.init)(jax.random.PRNGKey(0))
    warmup = jax.jit(jlearner.warmup_step)
    for _ in range(2):
        jstate = warmup(jstate)
    # A target network that differs from the online one.
    target_params = jlearner.agent.init_params(
        jax.random.PRNGKey(9), jnp.zeros((8,), jnp.int32),
        jlearner.engine.env.reset(jax.random.PRNGKey(1))[1])
    carry = (jstate.params, target_params, jstate.opt_state, jstate.replay,
             jax.random.PRNGKey(4))
    # The draw _train_on_batch makes from its key.
    _, sample_rng = jax.random.split(carry[-1])
    jidx, jweights, jitems = jlearner.replay.sample(
        jstate.replay, sample_rng, config.batch_size,
        config.priority_exponent)
    (params, _, _, jreplay, _), jlogs = jax.jit(jlearner._train_on_batch)(
        carry, None)

    def jax_loss(p):
        tm = jax.tree.map(lambda t: jnp.swapaxes(t, 0, 1),
                          (jitems.prev_actions, jitems.env_outputs,
                           jitems.agent_outputs))
        loss, _ = jax_r2d2.compute_loss_and_priorities(
            jlearner.agent, p, target_params, jitems.agent_state, *tm,
            gamma=config.discounting, burn_in=config.burn_in,
            n_steps=config.n_steps, target=config.target)
        return jnp.mean(loss * jweights)

    jgrads = jax.jit(jax.grad(jax_loss))(jstate.params)

    # The port: same weights, same buffer, JAX's indices.
    learner = _port_learner(config, clip_norm=spec["clip_norm"])
    learner.net.load_state_dict(convert.state_dict_for(
        learner.net, jax.tree.map(np.asarray, jstate.params)))
    learner.target_net.load_state_dict(convert.state_dict_for(
        learner.target_net, jax.tree.map(np.asarray, target_params)))
    buffer = _torch_items(
        jlearner.replay._unflatten_batch(jstate.replay.buffer))
    replay = ReplayState(
        buffer=buffer, priorities=_t(jstate.replay.priorities),
        insert_index=int(jstate.replay.insert_index),
        num_inserted=int(jstate.replay.num_inserted))
    state = learner.init()._replace(replay=replay)
    indices = _t(jidx)

    _, weights, items = learner.replay.sample(
        replay, None, config.batch_size, config.priority_exponent,
        indices=indices)
    np.testing.assert_allclose(weights.numpy(), jweights, rtol=1e-5)
    tm = r2d2._time_major(
        (items.prev_actions, items.env_outputs, items.agent_outputs))
    loss, _ = r2d2.compute_loss_and_priorities(
        learner.net, learner.target_net, items.agent_state, *tm,
        gamma=config.discounting, burn_in=config.burn_in,
        n_steps=config.n_steps, target=config.target)
    grads = torch.autograd.grad(torch.mean(loss * weights),
                                learner.parameters())
    names = [n for n, _ in learner.net.named_parameters()]
    want = _named(learner.net, jax.tree.map(np.asarray, jgrads))
    for name, got in zip(names, grads):
        np.testing.assert_allclose(got.numpy(), want[name], **TOL,
                                   err_msg=f"grad {name}")

    state, logs = learner.train_on_batch(state, indices=indices)
    assert set(logs) == set(jlogs)
    for k in logs:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), **TOL,
                                   err_msg=k)
    np.testing.assert_allclose(state.replay.priorities.numpy(),
                               jreplay.priorities, **TOL)
    want = _named(learner.net, jax.tree.map(np.asarray, params))
    for name, got in learner.net.named_parameters():
        np.testing.assert_allclose(got.detach().numpy(), want[name], **TOL,
                                   err_msg=f"updated {name}")


def test_target_network_updates_on_schedule():
    _, config = _jax_learner(min_size=4, batch_size=4, num_eval_envs=0)
    learner = _port_learner(config)
    state = learner.warmup_step(learner.init())

    def max_diff():
        return max(float((a - b).abs().max().detach()) for a, b in zip(
            learner.net.parameters(), learner.target_net.parameters()))

    assert max_diff() == 0
    state, _ = learner.train_step(state)  # step 1: no target update
    assert state.step == 1 and max_diff() > 0
    state, _ = learner.train_step(state)  # step 2: target <- online
    assert state.step == 2 and max_diff() == 0
    assert not any(p.requires_grad for p in learner.target_net.parameters())


def test_warmup_fills_buffer_with_training_envs_only():
    _, config = _jax_learner(num_envs=8, num_eval_envs=2)
    learner = _port_learner(config)
    state = learner.init()
    assert state.replay.num_inserted == 0
    state = learner.warmup_step(state)
    assert state.replay.num_inserted == 6
    assert state.replay.insert_index == 6
    # Eval envs keep their own episode window.
    assert state.stats.return_acc.shape == (6,)
    assert state.eval_stats.return_acc.shape == (2,)


def test_r2d2_learns_discrete_match():
    _, config = _jax_learner(
        num_envs=32, num_eval_envs=4, unroll_length=6, burn_in=2,
        batch_size=32, buffer_size=512, min_size=64)
    config = r2d2.R2D2Config(**{
        **{f: getattr(config, f) for f in r2d2.R2D2Config.__dataclass_fields__},
        "update_target_every_n_step": 25,
    })
    learner = _port_learner(
        config, num_envs=32, net_kw=dict(mlp_sizes=(32,), lstm_size=16,
                                         hidden_size=32))
    state = learner.init()
    while state.replay.num_inserted < config.replay_buffer_min_size:
        state = learner.warmup_step(state)
    state, _ = learner.train_many(state, 25)
    early = float(state.stats.sum_return) / max(
        float(state.stats.num_episodes), 1.0)
    state = state._replace(
        stats=episode_stats.reset_window(state.stats),
        eval_stats=episode_stats.reset_window(state.eval_stats))
    state, logs = learner.train_many(state, 275)
    late = float(state.stats.sum_return) / float(state.stats.num_episodes)
    state = state._replace(
        eval_stats=episode_stats.reset_window(state.eval_stats))
    state, logs = learner.train_many(state, 50)
    eval_return = float(state.eval_stats.sum_return) / float(
        state.eval_stats.num_episodes)
    # Horizon 10: optimal return 10, random ~2.5.
    assert math.isfinite(float(logs["losses/td"]))
    assert late > early + 2.0, (early, late)
    assert eval_return > 8.0, eval_return


def test_train_main_r2d2_on_cpu():
    learner, state, metrics = train.main([
        "--device=cpu", "--agent=r2d2", "--env=discrete_match",
        "--num_envs=12", "--num_eval_envs=2", "--unroll_length=5",
        "--burn_in=2", "--batch_size=4", "--replay_buffer_size=40",
        "--replay_buffer_min_size=15", "--total_environment_frames=180",
        "--steps_per_call=1", "--log_every_steps=1",
        "--train_batches_per_step=2", "--lr_decay_multiplier=0.5",
        "--debug_asserts",
    ])
    assert state.step == 3
    assert state.replay.num_inserted == 40  # 2 warmups + 3 steps of 10
    assert all(math.isfinite(float(v)) for v in metrics.values())
    assert "eval_episodes/mean_return" not in metrics or math.isfinite(
        metrics["eval_episodes/mean_return"])
    net = learner.net
    assert isinstance(net, VectorDuelingDQNNet)
    assert (net.torso.output_size, net.lstm_size) == (64, 64)
    assert learner.config.burn_in == 2 and learner.config.n_steps == 5
    # Linear decay over 3 steps x 2 batches, as optax counts updates.
    assert learner.optimizer.count == 6
    assert learner.optimizer.learning_rate() == pytest.approx(1.5e-4)
    from seed_rl_torch.utils import debug_asserts
    assert debug_asserts.enabled()
    debug_asserts.enable(False)


@pytest.mark.parametrize("flags", [
    ["--agent=r2d2", "--env=toy"],
    ["--agent=vtrace", "--env=discrete_match"],
    ["--agent=r2d2", "--env=discrete_match", "--run_mode=actor"],
])
def test_train_main_refuses_what_is_not_ported(flags):
    with pytest.raises(NotImplementedError, match="not ported"):
        train.main(["--device=cpu"] + flags)


def test_train_main_r2d2_agent_module_that_does_not_import():
    """``--agent_module`` is ported: a dotted name that names no module
    raises ImportError (before the learner is built)."""
    with pytest.raises(ImportError):
        train.main(["--device=cpu", "--agent=r2d2", "--env=discrete_match",
                    "--agent_module=custom_ppo_composition"])


def test_train_main_r2d2_eval_takes_the_greedy_step(monkeypatch):
    """--run_mode=eval acts greedily: every step is deterministic, and two
    evaluations agree."""
    steps = []
    policy_step = r2d2.R2D2Agent.policy_step

    def recording(self, *args, deterministic=False, **kw):
        steps.append(deterministic)
        return policy_step(self, *args, deterministic=deterministic, **kw)

    argv = ["--device=cpu", "--agent=r2d2", "--env=discrete_match",
            "--num_envs=4", "--unroll_length=5", "--burn_in=2",
            "--replay_buffer_size=64", "--replay_buffer_min_size=8",
            "--run_mode=eval", "--eval_episodes=8"]
    monkeypatch.setattr(r2d2.R2D2Agent, "policy_step", recording)
    results = []
    for _ in range(2):
        steps.clear()
        _, state, metrics = train.main(argv)
        # The learner's init primes its rollout with overlap + 1 sampled
        # steps; every step of the evaluation is greedy.
        init_steps = 2 + 1
        assert not any(steps[:init_steps])
        assert len(steps) > init_steps and all(steps[init_steps:])
        results.append(metrics)
    assert results[0] == results[1]
    assert results[0]["eval/num_episodes"] >= 8
    assert results[0]["eval/restored_step"] == state.step == 0


def test_train_main_r2d2_needs_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device=cpu"):
        train.main(["--agent=r2d2", "--env=discrete_match"])
