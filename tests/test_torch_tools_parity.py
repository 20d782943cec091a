"""The tools' builders against the JAX scripts' (``scripts/*.py``, imported
by file path; they are not edited), one train step each on the CPU.

The JAX learner makes the data (an unroll of its engine, or its replay)
and its parameters are carried over with ``models/convert.py``; both
learners then take one step on the same data with the same draws (JAX's
permutations, sample indices and loss noise, injected into the port's):

- ``bench_scaling.build_learner("mlp", ...)``: one V-trace update, the
  metrics and the parameters after the clip + Adam step within
  ``tests/test_torch_vtrace_agent.py``'s rtol 1e-4 / atol 1e-5.
- ``bench_scaling.build_learner("atari", ...)`` builds AtariPolicyNet in
  bf16, as the script does, and so do ``profile_ppo_atari.make_learner``
  (conv PPO, one shuffled minibatch step) and ``profile_sac_visual.build``
  (VisualActorCritic with a bf16 torso, one train batch): bf16 keeps 8
  significant bits and XLA and PyTorch round and accumulate in other
  orders, so these are held at ``tests/test_torch_compute_dtype.py``'s
  bf16 limits: the metrics within rtol 2e-2 / atol 2e-3, each gradient
  handed to the optimizer (before its clip) within ``GRAD_REL`` = 5e-2 of
  the JAX gradient's norm, leaf by leaf, and the parameters after one
  Adam step within 2 lr + 1e-6 (Adam's first step moves each weight by
  at most lr, whatever the gradient's rounding, so this last check holds
  only the step's size: the gradients hold its direction). The
  optimizer's clip norm and learning rate are the script's.
  The f32 V-trace, PPO and SAC steps are held at f32 limits in
  ``tests/test_torch_{vtrace_agent,ppo,sac}.py``; the mlp model's
  gradients here are held at rtol 1e-4 / atol 1e-5.
"""

import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
import torch.utils._pytree as pytree

from seed_rl_torch.agents import sac
from seed_rl_torch.models import AgentState, convert
from seed_rl_torch.replay import ReplayState
from seed_rl_torch.rollout import Timestep, Unroll
from seed_rl_torch.tools import bench_scaling, profile_ppo_atari
from seed_rl_torch.tools import profile_sac_visual
from seed_rl_torch.types import AgentOutput, EnvOutput
from seed_rl_torch.utils import episode_stats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_LOSS_TOL = dict(rtol=2e-2, atol=2e-3)
GRAD_REL = 5e-2


@pytest.fixture(autouse=True)
def one_torch_thread(monkeypatch):
    """One intra-op thread (see tests/test_torch_ppo.py); no persistent
    JAX cache for the scripts that enable one."""
    monkeypatch.setenv("SEED_RL_TPU_CACHE_DIR", "")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _t(x):
    return torch.tensor(np.asarray(x))


def _agent_state(state):
    from seed_rl_tpu.models import atari as jax_atari

    if isinstance(state, jax_atari.AgentState):
        return AgentState(*(jax.tree.map(_t, part) for part in state))
    return jax.tree.map(_t, state)


def _unroll(unroll):
    ts = unroll.timesteps
    return Unroll(
        agent_state=_agent_state(unroll.agent_state),
        timesteps=Timestep(prev_action=_t(ts.prev_action),
                           env_output=EnvOutput(*map(_t, ts.env_output)),
                           agent_output=AgentOutput(*map(_t,
                                                         ts.agent_output))))


def _close_metrics(got, want, tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), **tol,
                                   err_msg=k)


def _record_jax_grads(learner):
    """Wraps the JAX learner's optimizer: the gradients it is handed, as
    numpy trees, one per update."""
    seen, inner = [], learner.optimizer

    def update(grads, state, params=None):
        jax.debug.callback(
            lambda g: seen.append(jax.tree.map(np.asarray, g)), grads)
        return inner.update(grads, state, params)

    learner.optimizer = optax.GradientTransformation(inner.init, update)
    return seen


def _record_torch_grads(optimizer):
    """Wraps ``optim.ClippedAdam.step``: the gradients it is handed, in
    ``optimizer.params``' order (None for a parameter without one), one
    list per update."""
    seen, step = [], optimizer.step

    def recording_step():
        seen.append([None if p.grad is None else p.grad.detach().clone()
                     for p in optimizer.params])
        return step()

    optimizer.step = recording_step
    return seen


def _grads_close(optimizer, recorded, net, want_net, extras, bf16, what):
    """The port's one recorded update against JAX's gradients:
    ``want_net`` by the net's parameter names, then ``extras``, pairs of
    (the port's parameter, JAX's gradient leaf), in the optimizer's order.
    bf16: within GRAD_REL of the leaf's norm; f32: F32_TOL."""
    (grads,) = recorded
    named = list(net.named_parameters())
    params = [p for _, p in named] + [p for p, _ in extras]
    assert len(params) == len(optimizer.params) == len(grads)
    assert all(a is b for a, b in zip(params, optimizer.params))
    wants = [(name, want_net[name].numpy()) for name, _ in named] + [
        (f"extra {i}", np.asarray(w)) for i, (_, w) in enumerate(extras)]
    for (name, want), got in zip(wants, grads, strict=True):
        got = (np.zeros_like(want) if got is None
               else got.float().numpy().reshape(want.shape))
        if bf16:
            err = np.linalg.norm(got - want)
            assert err <= GRAD_REL * max(np.linalg.norm(want), 1e-8), (
                f"{what} {name}: |diff| {err:.3e}, |want| "
                f"{np.linalg.norm(want):.3e}")
        else:
            np.testing.assert_allclose(got, want, **F32_TOL,
                                       err_msg=f"{what} {name}")


def _params_close(net, tree, what, lr=None):
    want = convert.state_dict_for(net, jax.tree.map(np.asarray, tree))
    for name, got in net.named_parameters():
        tol = F32_TOL if lr is None else dict(rtol=0, atol=2 * lr + 1e-6)
        np.testing.assert_allclose(got.detach().numpy(), want[name].numpy(),
                                   **tol, err_msg=f"{what} {name}")


@pytest.mark.parametrize("model", ["mlp", "atari"])
def test_bench_scaling_builder_matches_the_scripts(model):
    num_envs, unroll_length, lr = 4, 3, 3e-4
    jl = _jax_script("bench_scaling").build_learner(model, num_envs,
                                                    unroll_length)
    jstate = jl.init(jax.random.PRNGKey(0))
    jgrads = _record_jax_grads(jl)
    rollout = jax.jit(jl.engine.rollout)
    net_params = jstate.params["net"]
    _, unroll = rollout(net_params, rollout(net_params, jstate.rollout)[0])
    loss_rng = jax.random.PRNGKey(7)
    jnew, jmetrics = jax.jit(jl.update)(jstate, unroll, loss_rng)

    tl = bench_scaling.build_learner(model, num_envs, unroll_length, "cpu")
    assert tl.config == type(tl.config)()  # VTraceConfig()'s defaults
    assert (tl.optimizer.clip_norm, tl.optimizer.learning_rate()) == (40, lr)
    tgrads = _record_torch_grads(tl.optimizer)
    assert tl.frames_per_step == jl.frames_per_step
    state_dict, entropy_cost = convert.vtrace_params(
        tl.agent.net, jax.tree.map(np.asarray, jstate.params))
    tl.agent.net.load_state_dict(state_dict, strict=True)
    with torch.no_grad():
        tl.entropy_cost.copy_(entropy_cost)
    # The tanh-normal entropy estimate's draw; the categorical's is exact.
    noise = (_t(jax.random.normal(loss_rng, (unroll_length, num_envs, 3),
                                  jnp.float32)) if model == "mlp" else None)
    new, metrics = tl.update(tl.init(), _unroll(unroll), entropy_noise=noise)
    bf16 = model == "atari"
    _close_metrics(metrics, jmetrics, BF16_LOSS_TOL if bf16 else F32_TOL)
    want_net, want_entropy = convert.vtrace_params(tl.agent.net, jgrads[0])
    _grads_close(tl.optimizer, tgrads, tl.agent.net, want_net,
                 [(tl.entropy_cost, want_entropy)], bf16, "gradient")
    _params_close(tl.agent.net, jnew.params["net"], "updated",
                  lr if bf16 else None)
    assert new.step == int(jnew.step) == 1


def test_profile_ppo_atari_make_learner_matches_the_scripts(monkeypatch):
    """One shuffle-mode update of 1 epoch x 1 minibatch (one Adam step),
    JAX's permutation injected."""
    num_envs, unroll_length, lr = 4, 3, 3e-4
    monkeypatch.setenv("PPO_PROFILE_ENVS", str(num_envs))
    jscript = _jax_script("profile_ppo_atari")
    monkeypatch.setattr(jscript, "UNROLL", unroll_length)
    jl, jengine = jscript.make_learner("shuffle", epochs=1, batches=1)
    jstate = jax.jit(jl.init)(jax.random.PRNGKey(0))
    jgrads = _record_jax_grads(jl)
    rollout = jax.jit(jengine.rollout)
    agent_params = jl.rollout_params(jstate)
    _, unroll = rollout(agent_params, rollout(agent_params,
                                              jstate.rollout)[0])
    step_rng = jax.random.PRNGKey(11)
    jnew, jlogs = jax.jit(jl.update)(jstate, unroll, step_rng)
    _, perm_rng = jax.random.split(step_rng)
    permutation = _t(jax.random.permutation(perm_rng, num_envs))

    tl, _ = profile_ppo_atari.make_learner(
        "shuffle", 1, 1, num_envs=num_envs, unroll=unroll_length,
        device="cpu")
    assert tl.config == type(tl.config)(epochs_per_step=1,
                                        batch_mode="shuffle",
                                        batches_per_step=1)
    assert (tl.optimizer.clip_norm, tl.optimizer.learning_rate()) == (0.5,
                                                                      lr)
    tgrads = _record_torch_grads(tl.optimizer)
    tl.agent.net.load_state_dict(convert.state_dict_for(
        tl.agent.net, jax.tree.map(np.asarray, jstate.params["net"])),
        strict=True)
    with torch.no_grad():
        for p, v in zip(jax.tree.leaves(tl.loss_params),
                        jax.tree.leaves(jstate.params["loss"])):
            p.copy_(_t(v))
    state = tl.init()._replace(
        norm_state=jax.tree.map(_t, jstate.norm_state),
        stats=episode_stats.EpisodeStatsState(*map(_t, jstate.stats)))
    new, logs = tl.update(state, _unroll(unroll), permutations=[permutation])
    assert tl.optimizer.count == 1
    _close_metrics(logs, jlogs, BF16_LOSS_TOL)
    (jgrad,) = jgrads
    _grads_close(
        tl.optimizer, tgrads, tl.agent.net,
        convert.state_dict_for(tl.agent.net, jgrad["net"]),
        list(zip(jax.tree.leaves(tl.loss_params),
                 jax.tree.leaves(jgrad["loss"]), strict=True)),
        True, "gradient")
    _params_close(tl.agent.net, jnew.params["net"], "updated", lr)
    for got, want in zip(jax.tree.leaves(new.norm_state),
                         jax.tree.leaves(jnew.norm_state)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **BF16_LOSS_TOL, err_msg="PopArt state")


def test_profile_sac_visual_build_matches_the_scripts():
    """One train batch on the JAX learner's replay, its sample indices and
    loss noise injected; polyak 0.995 moves the target each batch."""
    num_envs, unroll, batch, lr = 4, 2, 4, 3e-4
    jl, jstate, jconfig = _jax_script("profile_sac_visual").build(
        num_envs=num_envs, unroll=unroll, batch_size=batch, minibatches=1)
    tl, tstate, tconfig = profile_sac_visual.build(
        num_envs, unroll, batch, 1, device="cpu")
    assert jconfig == type(jconfig)(**vars(tconfig))
    assert (tl.optimizer.clip_norm, tl.optimizer.learning_rate()) == (40, lr)
    jgrads = _record_jax_grads(jl)
    tgrads = _record_torch_grads(tl.optimizer)
    assert tstate.replay.num_inserted >= 64
    jreplay = jstate.replay
    rng = jax.random.PRNGKey(3)
    carry = (jstate.params, jstate.target_net_params, jstate.opt_state,
             jreplay, rng, jnp.asarray(0, jnp.int32))
    (jparams, jtarget, *_), jmetrics = jax.jit(
        lambda c: jl._train_on_batch(c, None))(carry)

    _, sample_rng, loss_rng = jax.random.split(rng, 3)
    limit = min(int(jreplay.num_inserted), jconfig.replay_buffer_size)
    indices = _t(jax.random.randint(sample_rng, (batch,), 0, limit))
    keys = jax.random.split(loss_rng, 4)

    def normal(key, steps):
        return _t(jax.random.normal(key, (steps, batch, 1), jnp.float32))

    noise = sac.SACNoise(normal(keys[0], unroll), normal(keys[1], unroll),
                         normal(keys[2], unroll + 1),
                         normal(keys[3], unroll + 1))
    # JAX's items flatten their trailing dims; the port's keep them.
    leaves, spec = pytree.tree_flatten(tstate.replay.buffer)
    buffer = pytree.tree_unflatten(
        [_t(j).reshape(t.shape) for j, t in zip(
            jax.tree.leaves(jreplay.buffer), leaves, strict=True)],
        spec)
    replay = ReplayState(
        buffer=buffer,
        priorities=_t(jreplay.priorities),
        insert_index=int(jreplay.insert_index),
        num_inserted=int(jreplay.num_inserted))
    for net, tree in ((tl.net, jstate.params["net"]),
                      (tl.target_agent.net, jstate.target_net_params)):
        net.load_state_dict(convert.state_dict_for(
            net, jax.tree.map(np.asarray, tree)), strict=True)
    with torch.no_grad():
        tl.entropy_cost.copy_(_t(jstate.params["entropy_cost"]))
    state = tstate._replace(replay=replay, batches=0)
    state, metrics = tl.train_on_batch(state, indices=indices, noise=noise)
    assert state.batches == 1
    _close_metrics(metrics, jmetrics, BF16_LOSS_TOL)
    (jgrad,) = jgrads
    _grads_close(tl.optimizer, tgrads, tl.net,
                 convert.state_dict_for(tl.net, jgrad["net"]),
                 [(tl.entropy_cost, jgrad["entropy_cost"])], True,
                 "gradient")
    _params_close(tl.net, jparams["net"], "updated", lr)
    _params_close(tl.target_agent.net, jtarget, "target", lr)
    np.testing.assert_allclose(float(tl.entropy_cost.detach()),
                               float(jparams["entropy_cost"]), rtol=0,
                               atol=2 * lr + 1e-6)
