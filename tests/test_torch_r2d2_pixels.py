"""R2D2 from pixels in seed_rl_torch against the JAX package.

- ``DuelingLSTMDQNNet`` (flax params carried over with models/convert.py)
  gives the same Q values, greedy actions, LSTM state and frame history,
  one step and unrolled with ``done`` resets, on 36x36 Catch frames with
  LSTM 32, within rtol 1e-4 / atol 1e-5 (the convolutions sum in another
  order);
- the whole slice: the JAX R2D2 learner fills its replay from Catch frames
  (the stored agent state is the LSTM state and the uint8 frame history),
  then its buffer, its sampled indices, its online and (different) target
  parameters go through JAX ``compute_loss_and_priorities`` + optax clip +
  Adam and through the port's ``train_on_batch`` with burn-in, the n-step
  targets from kernel B2's plain version on the CPU. Insert priorities,
  loss, logs, sampled priorities and every gradient agree within rtol
  1e-4 / atol 1e-5; the parameters after one Adam step within rtol 1e-3 /
  atol 1e-4, for the reason tests/test_torch_pixel_vtrace.py states (Adam's
  first step turns a summation-order difference in a gradient element near
  eps into a share of the learning rate);
- the CLI's R2D2 pixel branch on the CPU, and its refusals.
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
from seed_rl_tpu.envs.catch import CatchEnv as JaxCatchEnv
from seed_rl_tpu.models import atari as jax_atari
from seed_rl_tpu.rollout import RolloutEngine as JaxRolloutEngine
from seed_rl_tpu.types import EnvOutput as JaxEnvOutput
from seed_rl_torch import optim, train
from seed_rl_torch.agents import r2d2
from seed_rl_torch.envs import BatchedEnv, CatchEnv
from seed_rl_torch.models import AgentState, DuelingLSTMDQNNet, convert
from seed_rl_torch.replay import ReplayState
from seed_rl_torch.rollout import RolloutEngine, Timestep, Unroll
from seed_rl_torch.types import EnvOutput, QAgentOutput

TOL = dict(rtol=1e-4, atol=1e-5)
# The parameters after one Adam step (see the module docstring).
UPDATED_TOL = dict(rtol=1e-3, atol=1e-4)
A, FRAME, LSTM = 3, (36, 36), 32
CATCH = dict(rows=6, cols=6, cell_pixels=6, balls_per_episode=2)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread, so that the other test
    processes sharing the cores do not stall every op's thread barrier
    (see tests/test_torch_ppo.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


def _agent_state(state):
    return AgentState(*(jax.tree.map(_t, part) for part in state))


def _nets(key=0):
    jnet = jax_atari.DuelingLSTMDQNNet(num_actions=A, frame_shape=FRAME,
                                       lstm_size=LSTM)
    B = 2
    env_output = JaxEnvOutput(
        reward=jnp.zeros((B,)), done=jnp.zeros((B,), bool),
        observation=jnp.zeros((B,) + FRAME + (1,), jnp.uint8),
        abandoned=jnp.zeros((B,), bool),
        episode_step=jnp.zeros((B,), jnp.int32),
    )
    params = jnet.init(jax.random.PRNGKey(key), jnp.zeros((B,), jnp.int32),
                       env_output, jnet.initial_state(B))
    params = jax.tree.map(np.asarray, params)
    tnet = DuelingLSTMDQNNet(A, frame_shape=FRAME, lstm_size=LSTM,
                             device="cpu")
    tnet.load_state_dict(convert.state_dict_for(tnet, params), strict=True)
    return jnet, tnet, params


def test_dueling_lstm_dqn_net_step_and_unroll_match_flax():
    jnet, tnet, params = _nets()
    rng = np.random.RandomState(1)
    T, B = 7, 4
    eo = dict(
        reward=rng.normal(size=(T, B)).astype(np.float32),
        done=rng.uniform(size=(T, B)) < 0.3,
        observation=rng.randint(0, 256, (T, B) + FRAME + (1,)).astype(
            np.uint8),
        abandoned=np.zeros((T, B), bool),
        episode_step=np.zeros((T, B), np.int32),
    )
    prev = rng.randint(0, A, (T, B)).astype(np.int32)
    state = jax_atari.AgentState(
        core_state=((rng.normal(size=(B, LSTM)).astype(np.float32),
                     rng.normal(size=(B, LSTM)).astype(np.float32)),),
        frame_stacking_state=rng.randint(0, 256, (B,) + FRAME + (3,)).astype(
            np.uint8),
    )
    assert tnet.initial_state(B).frame_stacking_state.shape == (
        (B,) + FRAME + (3,))

    def check_state(got, want):
        got, want = jax.tree.leaves(got), jax.tree.leaves(want)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       **TOL)

    step_eo = {k: v[0] for k, v in eo.items()}
    jout, jstate = jnet.apply(params, jnp.asarray(prev[0]),
                              JaxEnvOutput(**step_eo), state)
    with torch.no_grad():
        tout, tstate = tnet(_t(prev[0]), EnvOutput(**jax.tree.map(_t, step_eo)),
                            _agent_state(state))
    assert isinstance(tout, QAgentOutput) and tout.action.dtype == torch.int32
    np.testing.assert_allclose(tout.q_values.numpy(), jout.q_values, **TOL)
    np.testing.assert_array_equal(tout.action.numpy(), jout.action)
    check_state(tstate, jstate)

    jouts, jfinal = jnet.apply(params, jnp.asarray(prev), JaxEnvOutput(**eo),
                               state, method=jnet.unroll_time_major)
    with torch.no_grad():
        touts, tfinal = tnet.unroll(_t(prev), EnvOutput(**jax.tree.map(_t, eo)),
                                    _agent_state(state))
    np.testing.assert_allclose(touts.q_values.numpy(), jouts.q_values, **TOL)
    np.testing.assert_array_equal(touts.action.numpy(), jouts.action)
    check_state(tfinal, jfinal)
    # The unroll computes what stepping the net computes.
    with torch.no_grad():
        s, q = _agent_state(state), []
        for t in range(T):
            out, s = tnet(_t(prev[t]), EnvOutput(
                *(_t(eo[k][t]) for k in EnvOutput._fields)), s)
            q.append(out.q_values)
    torch.testing.assert_close(torch.stack(q), touts.q_values, **TOL)


def _jax_learner(num_envs=5, num_eval_envs=1, unroll_length=6, burn_in=2,
                 batch_size=6, buffer_size=16, min_size=8, clip_norm=0.05,
                 lr=1e-3):
    env = JaxBatchedEnv(JaxCatchEnv(**CATCH), num_envs)
    net = jax_atari.DuelingLSTMDQNNet(num_actions=A, frame_shape=FRAME,
                                      lstm_size=LSTM)
    num_training = num_envs - num_eval_envs
    epsilons = jnp.concatenate([jax_r2d2.training_env_epsilons(num_training),
                                jnp.full((num_eval_envs,), 1e-3)])
    agent = jax_r2d2.R2D2Agent(net, epsilons)
    engine = JaxRolloutEngine(env, agent, unroll_length,
                              num_overlapping_steps=burn_in)
    config = jax_r2d2.R2D2Config(
        discounting=0.9, n_steps=3, burn_in=burn_in,
        replay_buffer_size=buffer_size, replay_buffer_min_size=min_size,
        batch_size=batch_size, num_eval_envs=num_eval_envs,
    )
    optimizer = optax.chain(optax.clip_by_global_norm(clip_norm),
                            optax.adam(lr))
    return jax_r2d2.R2D2Learner(engine, agent, config, optimizer), config


def _port_learner(config, num_envs=5, unroll_length=6, clip_norm=0.05,
                  lr=1e-3):
    env = BatchedEnv(CatchEnv(**CATCH), num_envs, device="cpu")
    net = DuelingLSTMDQNNet(A, frame_shape=FRAME, lstm_size=LSTM,
                            device="cpu")
    num_training = num_envs - config.num_eval_envs
    epsilons = torch.cat([r2d2.training_env_epsilons(num_training),
                          torch.full((config.num_eval_envs,), 1e-3)])
    agent = r2d2.R2D2Agent(net, epsilons)
    engine = RolloutEngine(env, agent, unroll_length,
                           num_overlapping_steps=config.burn_in)
    tconfig = r2d2.R2D2Config(**{
        f: getattr(config, f) for f in r2d2.R2D2Config.__dataclass_fields__
    })
    return r2d2.R2D2Learner(
        engine, agent, tconfig,
        functools.partial(optim.ClippedAdam, learning_rate=lr,
                          clip_norm=clip_norm))


def _torch_items(items):
    return r2d2.StoredUnroll(
        agent_state=_agent_state(items.agent_state),
        prev_actions=_t(items.prev_actions),
        env_outputs=EnvOutput(*map(_t, items.env_outputs)),
        agent_outputs=QAgentOutput(*map(_t, items.agent_outputs)),
    )


def _torch_unroll(unroll):
    ts = unroll.timesteps
    return Unroll(
        agent_state=_agent_state(unroll.agent_state),
        timesteps=Timestep(
            prev_action=_t(ts.prev_action),
            env_output=EnvOutput(*map(_t, ts.env_output)),
            agent_output=QAgentOutput(*map(_t, ts.agent_output)),
        ),
    )


def _named(net, tree):
    want = convert.state_dict_for(net, jax.tree.map(np.asarray, tree))
    return {n: want[n].numpy() for n, _ in net.named_parameters()}


def test_r2d2_train_on_batch_from_catch_frames_matches_jax():
    jlearner, config = _jax_learner()
    jstate = jax.jit(jlearner.init)(jax.random.PRNGKey(0))
    warmup = jax.jit(jlearner.warmup_step)
    for _ in range(2):
        jstate = warmup(jstate)
    learner = _port_learner(config)

    # Insert priorities of one mid-stream unroll, from the behaviour net.
    _, unroll = jax.jit(jlearner.engine.rollout)(jstate.params,
                                                 jstate.rollout)
    assert bool(jnp.any(unroll.timesteps.env_output.done))
    jitems = jax_r2d2.unroll_to_items(unroll, 4)
    items = r2d2.unroll_to_items(_torch_unroll(unroll), 4)
    for got, want in zip(jax.tree.leaves(items), jax.tree.leaves(jitems)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert items.agent_state.frame_stacking_state.shape == (4,) + FRAME + (3,)
    np.testing.assert_allclose(
        r2d2.initial_priorities(learner.config, items).numpy(),
        jax_r2d2.initial_priorities(config, jitems), **TOL)

    # A target network that differs from the online one.
    target_params = jlearner.agent.init_params(
        jax.random.PRNGKey(9), jnp.zeros((5,), jnp.int32),
        jlearner.engine.env.reset(jax.random.PRNGKey(1))[1])
    carry = (jstate.params, target_params, jstate.opt_state, jstate.replay,
             jax.random.PRNGKey(4))
    _, sample_rng = jax.random.split(carry[-1])  # _train_on_batch's draw
    jidx, jweights, jbatch = jlearner.replay.sample(
        jstate.replay, sample_rng, config.batch_size, config.priority_exponent)
    (params, _, _, jreplay, _), jlogs = jax.jit(jlearner._train_on_batch)(
        carry, None)

    def jax_loss(p):
        tm = jax.tree.map(lambda t: jnp.swapaxes(t, 0, 1),
                          (jbatch.prev_actions, jbatch.env_outputs,
                           jbatch.agent_outputs))
        loss, _ = jax_r2d2.compute_loss_and_priorities(
            jlearner.agent, p, target_params, jbatch.agent_state, *tm,
            gamma=config.discounting, burn_in=config.burn_in,
            n_steps=config.n_steps)
        return jnp.mean(loss * jweights)

    jgrads = jax.jit(jax.grad(jax_loss))(jstate.params)

    # The port: same weights, same buffer, JAX's indices.
    learner.net.load_state_dict(convert.state_dict_for(
        learner.net, jax.tree.map(np.asarray, jstate.params)))
    learner.target_net.load_state_dict(convert.state_dict_for(
        learner.target_net, jax.tree.map(np.asarray, target_params)))
    replay = ReplayState(
        buffer=_torch_items(
            jlearner.replay._unflatten_batch(jstate.replay.buffer)),
        priorities=_t(jstate.replay.priorities),
        insert_index=int(jstate.replay.insert_index),
        num_inserted=int(jstate.replay.num_inserted))
    assert replay.buffer.agent_state.frame_stacking_state.dtype == torch.uint8
    state = learner.init()._replace(replay=replay)
    indices = _t(jidx)
    _, weights, batch = learner.replay.sample(
        replay, None, config.batch_size, config.priority_exponent,
        indices=indices)
    np.testing.assert_allclose(weights.numpy(), jweights, rtol=1e-5)
    loss, _ = r2d2.compute_loss_and_priorities(
        learner.net, learner.target_net, batch.agent_state,
        *r2d2._time_major((batch.prev_actions, batch.env_outputs,
                           batch.agent_outputs)),
        gamma=config.discounting, burn_in=config.burn_in,
        n_steps=config.n_steps)
    grads = torch.autograd.grad(torch.mean(loss * weights),
                                learner.parameters())
    want = _named(learner.net, jgrads)
    names = [n for n, _ in learner.net.named_parameters()]
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
    want = _named(learner.net, params)
    for name, got in learner.net.named_parameters():
        np.testing.assert_allclose(got.detach().numpy(), want[name],
                                   **UPDATED_TOL, err_msg=f"updated {name}")


@pytest.mark.parametrize("env,actions", [("catch", 3),
                                         ("synthetic_atari", 18)])
def test_train_main_r2d2_from_pixels_on_cpu(env, actions):
    learner, state, metrics = train.main([
        "--device=cpu", "--agent=r2d2", f"--env={env}", "--num_envs=4",
        "--num_eval_envs=1", "--unroll_length=4", "--burn_in=2",
        "--batch_size=2", "--replay_buffer_size=8",
        "--replay_buffer_min_size=6", "--total_environment_frames=32",
        "--steps_per_call=1", "--log_every_steps=1",
    ])
    # 2 warmup inserts of 3 training envs, then 2 steps.
    assert state.step == 2 and state.replay.num_inserted == 8
    assert all(math.isfinite(float(v)) for v in metrics.values())
    net = learner.net
    assert isinstance(net, DuelingLSTMDQNNet)
    assert (net.num_actions, net.lstm_size, net.stack_size) == (actions, 512,
                                                                4)
    history = state.replay.buffer.agent_state.frame_stacking_state
    assert history.shape == (8, 84, 84, 3) and history.dtype == torch.uint8


@pytest.mark.parametrize("flags,error", [
    (["--env=catch", "--conv_net=impala_deep"], ValueError),
    (["--env=synthetic_atari", "--conv_net=atari"], ValueError),
    (["--env=catch", "--remat_torso"], ValueError),
    (["--env=synthetic_atari_host", "--normalize_observations"],
     NotImplementedError),
    (["--env=catch", "--normalize_observations"], NotImplementedError),
])
def test_train_main_r2d2_refuses_pixel_options(flags, error):
    with pytest.raises(error):
        train.main(["--device=cpu", "--agent=r2d2"] + flags)
