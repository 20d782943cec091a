"""The on-policy (PPO-family) learner of seed_rl_torch against the JAX
package (mirroring tests/test_ppo_learner.py).

- ``ContinuousControlNet`` (flax params carried over with
  models/convert.py) gives flax's outputs, stateless and with LSTM cells
  unrolled over ``done`` resets, within rtol 1e-5 / atol 1e-6.
- ``GeneralizedOnPolicyLoss`` on one JAX unroll with abandoned steps,
  PopArt with compensation, a clipped Huber value loss, V-MPO and a
  Lagrange entropy constraint on a tanh-normal policy (the entropy a
  one-sample estimate from injected noise): loss, logs, every gradient,
  the new PopArt state and compensation agree within rtol 1e-4 / atol
  1e-5 (sums in another order).
- One full ``PPOLearner.update`` in each of the four batch modes, with
  JAX's permutations and its regularizer noise injected: logs, the
  parameters (net and loss-owned), the PopArt and observation statistics
  and the episode statistics after the update agree within rtol 1e-3 /
  atol 1e-4. The minibatch steps chain up to 4 Adam steps, and Adam's
  step is lr * m / (sqrt(v) + eps): a gradient element near eps in size
  turns a float32 summation-order difference into a share of lr.
- A parameter the loss stops reaching keeps stepping as optax moves it.
- The split modes refuse a recurrent net; minibatches must divide the
  batch. The learning tests reach tests/test_ppo_learner.py's
  thresholds; the CLI trains every ported combination on the CPU.
"""

import functools
import math
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from seed_rl_tpu import distributions as jpd
from seed_rl_tpu.agent import PolicyAgent as JaxPolicyAgent
from seed_rl_tpu.agents.ppo import constraints as jconstraints
from seed_rl_tpu.agents.ppo import continuous_control_agent as jcca
from seed_rl_tpu.agents.ppo import generalized_onpolicy_loss as jgol
from seed_rl_tpu.agents.ppo import input_normalization as jin
from seed_rl_tpu.agents.ppo import learner as jlearner_mod
from seed_rl_tpu.agents.ppo import policy_losses as jlosses
from seed_rl_tpu.agents.ppo import policy_regularizers as jreg
from seed_rl_tpu.envs import BatchedEnv as JaxBatchedEnv
from seed_rl_tpu.envs import ToyEnv as JaxToyEnv
from seed_rl_tpu.ops import advantages as jadv
from seed_rl_tpu.ops import popart as jpopart
from seed_rl_tpu.ops import running_statistics as jrs
from seed_rl_tpu.rollout import RolloutEngine as JaxRolloutEngine
from seed_rl_tpu.types import EnvOutput as JaxEnvOutput
from seed_rl_torch import distributions as tpd
from seed_rl_torch import optim, train
from seed_rl_torch.agent import PolicyAgent
from seed_rl_torch.agents.ppo import constraints, policy_losses
from seed_rl_torch.agents.ppo import continuous_control_agent as cca
from seed_rl_torch.agents.ppo import generalized_onpolicy_loss as gol
from seed_rl_torch.agents.ppo import input_normalization as tin
from seed_rl_torch.agents.ppo import learner as ppo
from seed_rl_torch.agents.ppo import policy_regularizers as treg
from seed_rl_torch.envs import BatchedEnv, DiscreteMatchEnv, ToyEnv
from seed_rl_torch.models import MLPAndLSTM, convert
from seed_rl_torch.ops import advantages, popart, running_statistics as rs
from seed_rl_torch.rollout import RolloutEngine, Timestep, Unroll
from seed_rl_torch.types import AgentOutput, EnvOutput
from seed_rl_torch.utils import episode_stats

NET_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)
# The parameters after a pass of Adam steps (see the module docstring).
UPDATE_TOL = dict(rtol=1e-3, atol=1e-4)
OBS, A = 4, 3


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread, so that the other test
    processes sharing the cores do not stall every op's thread barrier
    (with torch's default, six test workers on 8 cores ran this file's
    CLI cases from frames in ~36 s each, against ~0.3 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, tol=TOL, what=""):
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want), (what, len(got), len(want))
    for g, w in zip(got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64), **tol,
                                   err_msg=what)


NETS = {
    # The CLI's net, narrowed: 2 tanh layers, orthogonal gains, free std.
    "cli": dict(num_layers_policy=2, num_layers_value=2,
                num_units_policy=16, num_units_value=16,
                activation="tanh", kernel_init_gain=math.sqrt(2.0),
                last_kernel_init_policy_gain=0.01,
                last_kernel_init_value_gain=1.0,
                std_independent_of_input=True),
    "shared-layernorm-residual-corrected": dict(
        num_layers_policy=3, num_layers_value=3, num_units_policy=12,
        num_units_value=12, shared=True, use_layer_norm=True,
        residual_connections=True, correct_observations=True),
    "lstm": dict(num_layers_policy=2, num_layers_value=1,
                 num_units_policy=16, num_units_value=8, num_layers_rnn=2,
                 num_units_rnn=8, activation="tanh", kernel_init_gain=1.0,
                 std_independent_of_input=True),
}


def _net_kwargs(spec, module):
    kw = dict(spec)
    if "activation" in kw:
        kw["activation"] = {"tanh": (jnp.tanh, torch.tanh)}[kw["activation"]][
            module is cca]
    return kw


def _nets(spec, param_size=2 * A, seed=0):
    """The flax net and its params, and the port's net with them."""
    jnet = jcca.ContinuousControlNet(
        parametric_distribution_param_size=param_size,
        **_net_kwargs(spec, jcca))
    B = 2
    env_output = JaxEnvOutput(
        reward=jnp.zeros((B,)), done=jnp.zeros((B,), bool),
        observation=jnp.zeros((B, OBS)), abandoned=jnp.zeros((B,), bool),
        episode_step=jnp.zeros((B,), jnp.int32))
    params = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((B, A)),
                       env_output, jnet.initial_state(B))
    params = jax.tree.map(np.asarray, params)
    tnet = cca.ContinuousControlNet(param_size, OBS,
                                    **_net_kwargs(spec, cca), device="cpu")
    tnet.load_state_dict(convert.state_dict_for(tnet, params), strict=True)
    return jnet, tnet, params


@pytest.mark.parametrize("name", sorted(NETS))
def test_continuous_control_net_matches_flax(name):
    jnet, tnet, params = _nets(NETS[name])
    if name.endswith("corrected"):  # a correction away from the identity
        params = jax.tree.map(lambda x: x, params)
        params["params"]["obs_correction_scale"] = np.array(
            [0.5, 2.0, 1.0, -1.0], np.float32)
        params["params"]["obs_correction_bias"] = np.array(
            [0.1, 0.0, -0.3, 0.2], np.float32)
        tnet.load_state_dict(convert.state_dict_for(tnet, params))
    rng = np.random.RandomState(1)
    T, B = 5, 3
    eo = dict(reward=np.zeros((T, B), np.float32),
              done=rng.uniform(size=(T, B)) < 0.3,
              observation=rng.normal(size=(T, B, OBS)).astype(np.float32),
              abandoned=np.zeros((T, B), bool),
              episode_step=np.zeros((T, B), np.int32))
    prev = np.zeros((T, B, A), np.float32)
    state = jax.tree.map(
        lambda x: rng.normal(size=x.shape).astype(np.float32),
        jnet.initial_state(B))
    assert tnet.stateless == jnet.stateless
    jagent = JaxPolicyAgent(jnet, jpd.NormalTanhDistribution(A))
    jout, jstate = jagent.unroll(params, jnp.asarray(prev),
                                 JaxEnvOutput(**eo), state)
    tagent = PolicyAgent(tnet, tpd.NormalTanhDistribution(A))
    with torch.no_grad():
        tout, tstate = tagent.unroll(_t(prev), EnvOutput(**jax.tree.map(
            _t, eo)), jax.tree.map(_t, state))
        step_out, _ = tnet(_t(prev[0]), EnvOutput(
            *(_t(eo[k][0]) for k in EnvOutput._fields)),
            jax.tree.map(_t, state))
    _close(tout, jout, NET_TOL, "unroll")
    _close(tstate, jstate, NET_TOL, "state")
    _close(step_out, jax.tree.map(lambda x: x[0], jout), NET_TOL, "step")


def test_orthogonal_init_gains():
    net = cca.ContinuousControlNet(2 * A, OBS, **_net_kwargs(NETS["cli"], cca),
                                   device="cpu")
    w = net.policy_torso.layers[1].weight.detach()
    torch.testing.assert_close(w @ w.T, 2.0 * torch.eye(16), rtol=0,
                               atol=1e-5)
    w = net.policy_head.weight.detach()  # [3, 16]: orthonormal rows * 0.01
    torch.testing.assert_close(w @ w.T, 1e-4 * torch.eye(A), rtol=0,
                               atol=1e-9)
    assert torch.count_nonzero(net.free_log_std) == 0


def _jax_unroll(num_envs=8, unroll_length=4, spec=NETS["cli"], seed=0):
    """A mid-stream JAX unroll of the toy env and the net's params."""
    jnet, tnet, params = _nets(spec, seed=seed)
    jdist = jpd.NormalTanhDistribution(A)
    jagent = JaxPolicyAgent(jnet, jdist)
    engine = JaxRolloutEngine(JaxBatchedEnv(JaxToyEnv(horizon=3), num_envs),
                              jagent, unroll_length)
    rollout = jax.jit(engine.rollout)
    state = engine.init(params, jax.random.PRNGKey(1))
    state, _ = rollout(params, state)
    _, unroll = rollout(params, state)
    return jnet, tnet, params, jagent, unroll


def _torch_unroll(unroll):
    ts = unroll.timesteps
    return Unroll(
        agent_state=jax.tree.map(_t, unroll.agent_state),
        timesteps=Timestep(
            prev_action=_t(ts.prev_action),
            env_output=EnvOutput(*map(_t, ts.env_output)),
            agent_output=AgentOutput(*map(_t, ts.agent_output))))


def _losses(module, regularizer_module, constraints_module, adv_module,
            popart_module, rs_module, agent, dist):
    return module.GeneralizedOnPolicyLoss(
        agent=agent,
        reward_normalizer=popart_module.PopArt(rs_module.AverageMeanStd(),
                                               compensate=True),
        parametric_action_distribution=dist,
        advantage_estimator=adv_module.VTrace(lambda_=0.9,
                                              max_importance_weight=1.5),
        policy_loss=(policy_losses if module is gol else jlosses).vmpo(0.1),
        discount_factor=0.95,
        regularizer=regularizer_module.KLPolicyRegularizer(
            entropy=constraints_module.LagrangeInequalityCoefficient(
                threshold=-1.0, adjustment_speed=2.0),
            kl_mu_pi=0.2),
        max_abs_reward=0.8,
        huber_delta=0.5,
        value_ppo_style_clip_eps=0.05,
        frame_skip=2,
        reward_scaling=1.5,
    )


def test_generalized_onpolicy_loss_matches_jax():
    jnet, tnet, params, jagent, unroll = _jax_unroll(spec=NETS["lstm"])
    # Some episode ends become abandoned (time limits).
    eo = unroll.timesteps.env_output
    abandoned = np.asarray(eo.done) & (np.arange(eo.done.shape[1]) % 2 == 0)
    unroll = unroll._replace(timesteps=unroll.timesteps._replace(
        env_output=eo._replace(abandoned=jnp.asarray(abandoned))))
    assert abandoned.any() and (np.asarray(eo.done) & ~abandoned).any()
    jdist = jagent.distribution
    jloss_obj = _losses(jgol, jreg, jconstraints, jadv, jpopart, jrs, jagent,
                        jdist)
    tagent = PolicyAgent(tnet, tpd.NormalTanhDistribution(A))
    loss_obj = _losses(gol, treg, constraints, advantages, popart, rs,
                       tagent, tagent.distribution)
    jloss_params = jloss_obj.init_params()
    jloss_params["popart"] = {"compensation_mean": jnp.float32(0.3),
                              "compensation_std": jnp.float32(1.7)}
    jnorm = jloss_obj.init_norm_state()
    jnorm = jloss_obj.reward_normalizer.tracker.update(
        jnorm, jnp.asarray(np.random.RandomState(2).normal(
            size=(20, 1)).astype(np.float32) * 3 + 1))
    ts = unroll.timesteps
    key = jax.random.PRNGKey(5)
    T, B = ts.env_output.reward.shape[0] - 1, ts.env_output.reward.shape[1]
    noise = jax.random.normal(key, (T, B, A), jnp.float32)

    def jax_loss(net_params, loss_params):
        return jloss_obj(net_params, loss_params, jnorm, unroll.agent_state,
                         ts.prev_action, ts.env_output, ts.agent_output,
                         rng=key)

    (jloss, jaux), (jg_net, jg_loss) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(params, jloss_params)

    loss_params = jax.tree.map(
        lambda x: torch.tensor(np.asarray(x)).requires_grad_(True),
        jloss_params)
    tunroll = _torch_unroll(unroll)
    tts = tunroll.timesteps
    loss, aux = loss_obj(
        loss_params, jax.tree.map(_t, jnorm), tunroll.agent_state,
        tts.prev_action, tts.env_output, tts.agent_output,
        noise=_t(noise))
    _close(loss, jloss, what="loss")
    assert set(aux.logs) == set(jaux.logs)
    for k in aux.logs:
        _close(aux.logs[k], jaux.logs[k], what=k)
    _close(aux.norm_state, jaux.norm_state, what="PopArt state")
    _close(aux.loss_params, jaux.loss_params, what="reassigned params")
    inputs = list(tnet.parameters()) + jax.tree.leaves(loss_params)
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    # The value torso feeds nothing behind the LSTM: JAX's zeros.
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(inputs, grads)]
    want = convert.state_dict_for(tnet, jax.tree.map(np.asarray, jg_net))
    for (name, _), g in zip(tnet.named_parameters(), grads):
        _close(g, want[name], what=f"grad {name}")
    _close(list(grads[len(want):]), jax.tree.leaves(jg_loss),
           what="grad of the loss-owned params")


# The four batch modes, each with a loss that exercises what the mode does.
UPDATE_CASES = {
    "split": dict(net="cli", loss="ppo", compensate=False,
                  correct_observations=True),
    "split_with_advantage_recomputation": dict(
        net="cli", loss="vmpo", compensate=True),
    "shuffle": dict(net="lstm", loss="awr", compensate=True),
    "repeat": dict(net="lstm", loss="ppo", compensate=False,
                   lagrange_entropy=True),
}


JAX_MODULES = dict(cca=jcca, pd=jpd, norm=jin, rs=jrs, c=jconstraints,
                   gol=jgol, popart=jpopart, adv=jadv, pl=jlosses, reg=jreg,
                   learner=jlearner_mod)
PORT_MODULES = dict(cca=cca, pd=tpd, norm=tin, rs=rs, c=constraints, gol=gol,
                    popart=popart, adv=advantages, pl=policy_losses,
                    reg=treg, learner=ppo)


def _build(m, net, mode, spec, num_envs=8, unroll_length=4, epochs=2,
           batches=2, lr=3e-3, clip=0.5, repeats=1):
    """tests/test_ppo_learner.py's toy-env PPO learner, from either
    package's modules ``m``, around ``net``."""
    is_jax = m is JAX_MODULES
    dist = m["pd"].NormalTanhDistribution(
        A, gaussian_std_fn=m["pd"].safe_exp_std_fn(1.0, 1e-3))
    agent = m["cca"].NormalizingPolicyAgent(
        net, dist,
        input_normalization=m["norm"].InputNormalization(
            m["rs"].AverageMeanStd(), input_size=OBS),
        input_clipping=10.0)
    entropy = (m["c"].LagrangeInequalityCoefficient(threshold=-2.0)
               if spec.get("lagrange_entropy") else 0.01)
    loss = m["gol"].GeneralizedOnPolicyLoss(
        agent=agent,
        reward_normalizer=m["popart"].PopArt(
            m["rs"].AverageMeanStd(), compensate=spec["compensate"]),
        parametric_action_distribution=dist,
        advantage_estimator=m["adv"].GAE(lambda_=0.95),
        policy_loss={"ppo": lambda: m["pl"].ppo(0.2),
                     "vmpo": lambda: m["pl"].vmpo(0.1),
                     "awr": lambda: m["pl"].awr(1.0, 20.0)}[spec["loss"]](),
        discount_factor=0.9,
        regularizer=m["reg"].KLPolicyRegularizer(entropy=entropy),
        baseline_cost=1.0)
    config = m["learner"].PPOConfig(epochs_per_step=epochs, batch_mode=mode,
                                    batches_per_step=batches,
                                    num_action_repeats=repeats)
    if is_jax:
        engine = JaxRolloutEngine(
            JaxBatchedEnv(JaxToyEnv(horizon=3), num_envs), agent,
            unroll_length)
        return m["learner"].PPOLearner(
            engine, agent, loss, config,
            optax.chain(optax.clip_by_global_norm(clip), optax.adam(lr)))
    engine = RolloutEngine(
        BatchedEnv(ToyEnv(horizon=3), num_envs, device="cpu"), agent,
        unroll_length)
    return m["learner"].PPOLearner(
        engine, agent, loss, config,
        functools.partial(optim.ClippedAdam, learning_rate=lr,
                          clip_norm=clip))


def _learners(mode, spec, **kw):
    """The JAX and the port's learner around the same weights."""
    net_spec = dict(NETS[spec["net"]],
                    correct_observations=spec.get("correct_observations",
                                                  False))
    jnet, tnet, params = _nets(net_spec)
    return (_build(JAX_MODULES, jnet, mode, spec, **kw),
            _build(PORT_MODULES, tnet, mode, spec, **kw), params)


def _port_learner(mode="split", net="cli", units=16, **kw):
    spec = dict(NETS[net], num_units_policy=units, num_units_value=units)
    tnet = cca.ContinuousControlNet(2 * A, OBS, **_net_kwargs(spec, cca),
                                    device="cpu")
    return _build(PORT_MODULES, tnet, mode,
                  dict(loss="ppo", compensate=False), **kw)


def _jax_draws(mode, step_rng, epochs, batches, batch_dim, noise_shape):
    """The permutations and the regularizer noise JAX's update draws from
    ``step_rng``, in order."""
    perms, noises = [], []
    rng = step_rng
    if mode == "split":
        _, rng = jax.random.split(rng)
    for _ in range(epochs):
        if mode == "split_with_advantage_recomputation":
            _, rng = jax.random.split(rng)
        rng, perm_rng = jax.random.split(rng)
        perms.append(np.asarray(jax.random.permutation(perm_rng, batch_dim))
                     if mode != "repeat" else np.arange(batch_dim))
        for _ in range(batches):
            rng, loss_rng = jax.random.split(rng)
            noises.append(np.asarray(jax.random.normal(
                loss_rng, noise_shape, jnp.float32)))
    return perms, noises


@pytest.mark.parametrize("mode", sorted(UPDATE_CASES))
def test_ppo_update_matches_jax(mode):
    spec = UPDATE_CASES[mode]
    epochs, batches, B, T = 2, 2, 8, 4
    jl, tl, params = _learners(mode, spec, num_envs=B, unroll_length=T,
                               epochs=epochs, batches=batches)
    jstate = jax.jit(jl.init)(jax.random.PRNGKey(0))
    jstate = jstate._replace(params=dict(jstate.params, net=params))
    rollout = jax.jit(jl.engine.rollout)
    agent_params = jl.rollout_params(jstate)
    rollout_state, _ = rollout(agent_params, jstate.rollout)
    _, unroll = rollout(agent_params, rollout_state)
    step_rng = jax.random.PRNGKey(11)
    jnew, jlogs = jax.jit(jl.update)(jstate, unroll, step_rng)

    split = mode.startswith("split")
    mb = (T * B if split else B) // batches
    perms, noises = _jax_draws(mode, step_rng, epochs, batches,
                               T * B if split else B,
                               (1, mb, A) if split else (T, mb, A))
    # The port, from the same parameters and statistics.
    tl.agent.net.load_state_dict(convert.state_dict_for(tl.agent.net,
                                                        params))
    with torch.no_grad():
        for p, v in zip(jax.tree.leaves(tl.loss_params),
                        jax.tree.leaves(jstate.params["loss"])):
            p.copy_(_t(v))
    tl.agent.obs_norm = jax.tree.map(_t, jstate.obs_norm)
    state = tl.init()._replace(
        norm_state=jax.tree.map(_t, jstate.norm_state),
        stats=episode_stats.EpisodeStatsState(*map(_t, jstate.stats)))
    new, logs = tl.update(state, _torch_unroll(unroll),
                          permutations=[torch.tensor(p) for p in perms],
                          entropy_noise=[torch.tensor(n) for n in noises])
    assert tl.optimizer.count == epochs * batches
    assert set(logs) == set(jlogs)
    for k in logs:
        _close(logs[k], jlogs[k], UPDATE_TOL, k)
    want = convert.state_dict_for(tl.agent.net,
                                  jax.tree.map(np.asarray, jnew.params["net"]))
    for name, got in tl.agent.net.named_parameters():
        _close(got, want[name], UPDATE_TOL, f"updated {name}")
    _close(tl.loss_params, jnew.params["loss"], UPDATE_TOL, "loss params")
    _close(new.norm_state, jnew.norm_state, UPDATE_TOL, "PopArt state")
    _close(tl.agent.obs_norm, jnew.obs_norm, TOL, "observation statistics")
    _close(new.stats, jnew.stats, TOL, "episode statistics")
    assert new.step == int(jnew.step) == 1


def _jax_loop_steps(frames_per_step, total_environment_frames):
    """The train steps the JAX CLI's loop runs (one a call): it steps while
    ``step * frames_per_step < total_environment_frames``."""
    step = 0
    while step * frames_per_step < total_environment_frames:
        step += 1
    return step


@pytest.mark.parametrize("repeats", [1, 2])
def test_num_action_repeats_counts_frames_as_jax(repeats):
    """``PPOConfig.num_action_repeats`` multiplies the frame count, as JAX
    does (``seed_rl_tpu/agents/ppo/learner.py:90-94``), and leaves the
    minibatches alone: the frames a step, and the steps run for a frame
    budget, equal JAX's (exact: integers)."""
    spec = dict(net="cli", loss="ppo", compensate=False)
    jl, tl, _ = _learners("split", spec, repeats=repeats)
    assert tl.frames_per_step == jl.frames_per_step == 8 * 4 * repeats
    total = 6 * 8 * 4
    state, _ = ppo.learner_loop(tl, total)
    assert state.step == _jax_loop_steps(jl.frames_per_step, total)
    assert state.step == 6 // repeats
    # The split into minibatches is the same: 2 epochs x 2 a step.
    assert tl.optimizer.count == state.step * 2 * 2


def test_unreached_loss_parameter_steps_like_optax():
    """A loss-owned parameter the loss stops reaching keeps stepping on its
    Adam moments, with the one shared update count, as optax moves it
    (torch.optim.Adam alone would skip it)."""
    a = torch.tensor([0.5, -1.0], requires_grad=True)
    b = torch.tensor(2.0, requires_grad=True)
    opt = optim.ClippedAdam([a, b], learning_rate=0.1, clip_norm=1.0)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(0.1))
    params = {"a": jnp.array([0.5, -1.0]), "b": jnp.float32(2.0)}
    state = tx.init(params)

    def jax_loss(p, both):
        loss = jnp.sum(jnp.square(p["a"] - 3.0))
        return loss + (jnp.square(p["b"]) if both else 0.0)

    for step in range(4):
        both = step == 0  # only the first loss reaches b
        opt.zero_grad()
        loss = torch.sum(torch.square(a - 3.0))
        if both:
            loss = loss + torch.square(b)
        loss.backward()
        assert (b.grad is None) == (not both)
        opt.step()
        grads = jax.grad(functools.partial(jax_loss, both=both))(params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        _close([a, b], [params["a"], params["b"]], NET_TOL, f"step {step}")
        if step == 0:
            b_reached = float(b.detach())
    # It moved on its moments after the loss stopped reaching it.
    assert float(b.detach()) < b_reached - 0.1


def test_ppo_learner_refuses_what_the_jax_learner_asserts():
    with pytest.raises(ValueError, match="stateless"):
        _port_learner(mode="split", net="lstm")
    with pytest.raises(ValueError, match="stateless"):
        _port_learner(mode="split_with_advantage_recomputation", net="lstm")
    with pytest.raises(ValueError, match="divide"):
        _port_learner(mode="split", batches=5)  # 8 x 4 transitions
    with pytest.raises(ValueError, match="divide"):
        _port_learner(mode="shuffle", batches=3)  # 8 unrolls
    with pytest.raises(ValueError, match="batch mode"):
        _port_learner(mode="split_everything")


def test_obs_normalization_statistics_update_once_per_step():
    learner = _port_learner()
    state = learner.init()
    assert float(learner.agent.obs_norm.observation_count.sum()) == 0
    state, _ = learner.train_step(state)
    # (T + 1) * B observations tracked per dimension.
    assert float(learner.agent.obs_norm.observation_count[0]) == 5 * 8


def _mean_return(state):
    n = float(state.stats.num_episodes)
    assert n > 0
    return float(state.stats.sum_return) / n


def test_ppo_learns_toy_env_split_mode():
    learner = _port_learner(units=32, num_envs=32, unroll_length=8,
                            epochs=4, batches=4)
    state, _ = learner.train_many(learner.init(), 20)
    early = _mean_return(state)
    state = state._replace(stats=episode_stats.reset_window(state.stats))
    state, metrics = learner.train_many(state, 100)
    late = _mean_return(state)
    assert late > early + 1.0, (early, late)
    assert late > -2.0, late
    assert math.isfinite(float(metrics["GeneralizedOnPolicyLoss/total_loss"]))


def _discrete_learner(policy_loss):
    env = BatchedEnv(DiscreteMatchEnv(n_actions=4), 16, device="cpu", seed=0)
    dist = tpd.CategoricalDistribution(4)
    net = MLPAndLSTM(dist.param_size, 4, mlp_sizes=(32,), lstm_sizes=(16,),
                     seed=0, device="cpu")
    agent = PolicyAgent(net, dist)
    loss = gol.GeneralizedOnPolicyLoss(
        agent=agent,
        reward_normalizer=popart.PopArt(rs.AverageMeanStd(),
                                        compensate=False),
        parametric_action_distribution=dist,
        advantage_estimator=advantages.GAE(lambda_=0.95),
        policy_loss=policy_loss,
        discount_factor=0.9,
        regularizer=treg.KLPolicyRegularizer(entropy=0.0),
        baseline_cost=1.0)
    return ppo.PPOLearner(
        RolloutEngine(env, agent, 8, seed=1), agent, loss,
        ppo.PPOConfig(epochs_per_step=2, batch_mode="shuffle",
                      batches_per_step=2),
        functools.partial(optim.ClippedAdam, learning_rate=1e-2,
                          clip_norm=0.5),
        seed=2)


@pytest.mark.parametrize("loss_factory,min_gain", [
    (lambda: policy_losses.ppo(epsilon=0.2), 1.0),
    # V-MPO's top half and Lagrange temperature learn slower here.
    (lambda: policy_losses.vmpo(e_n=0.1), 0.5),
    (lambda: policy_losses.awr(beta=1.0, w_max=20.0), 1.0),
], ids=["ppo", "vmpo", "awr"])
def test_discrete_ppo_family_learns(loss_factory, min_gain):
    learner = _discrete_learner(loss_factory())
    state, _ = learner.train_many(learner.init(), 15)
    early = _mean_return(state)
    state = state._replace(stats=episode_stats.reset_window(state.stats))
    state, _ = learner.train_many(state, 60)
    late = _mean_return(state)
    # DiscreteMatchEnv: ~2.5 at random (10 steps, 1 in 4 hits), 10 at most.
    assert late > early + min_gain, (early, late)


CLI_CASES = [
    ("toy", [], "split", cca.ContinuousControlNet),
    ("toy_memory", ["--batch_mode=repeat", "--policy_loss=pg"], "repeat",
     cca.ContinuousControlNet),
    ("toy", ["--batch_mode=split_with_advantage_recomputation",
             "--policy_loss=vtrace", "--advantage_estimator=vtrace"],
     "split_with_advantage_recomputation", cca.ContinuousControlNet),
    ("discrete_match", ["--policy_loss=vmpo", "--lambda_=0.9"], "shuffle",
     MLPAndLSTM),
    ("catch", ["--policy_loss=awr", "--ppo_entropy_cost=0.01"], "shuffle",
     None),
    ("synthetic_atari", ["--batch_mode=repeat", "--advantage_estimator=vtrace"],
     "repeat", None),
]


@pytest.mark.parametrize("env,flags,mode,net_type", CLI_CASES)
def test_train_main_ppo_on_cpu(env, flags, mode, net_type):
    from seed_rl_torch.models import AtariPolicyNet

    learner, state, metrics = train.main([
        "--device=cpu", "--agent=ppo", f"--env={env}", "--num_envs=4",
        "--unroll_length=3", "--epochs_per_step=2", "--batches_per_step=2",
        "--total_environment_frames=24", "--steps_per_call=1",
        "--log_every_steps=1", "--lr_decay_multiplier=0.5",
    ] + flags)
    assert state.step == 2
    assert learner.config.batch_mode == mode
    assert all(math.isfinite(float(v)) for v in metrics.values())
    assert isinstance(learner.agent.net, net_type or AtariPolicyNet)
    # Linear decay over 2 steps x 2 epochs x 2 minibatches of updates.
    assert learner.optimizer.count == 8
    assert learner.optimizer.learning_rate() == pytest.approx(1.5e-4)
    if env.startswith("toy"):
        assert isinstance(learner.agent, cca.NormalizingPolicyAgent)
        assert learner.agent.input_clipping == 10.0
        assert learner.agent.net.std_independent_of_input


@pytest.mark.parametrize("flags,error", [
    (["--agent=ppo", "--env=discrete_match", "--batch_mode=split"],
     ValueError),
    (["--agent=ppo", "--env=catch", "--conv_net=impala_deep"], ValueError),
    (["--agent=vtrace", "--env=toy", "--lambda_=0.9"], ValueError),
    (["--agent=ppo", "--env=toy", "--run_mode=actor"], NotImplementedError),
    (["--agent=ppo", "--env=toy", "--normalize_observations"],
     NotImplementedError),
    # Data parallelism is for the device learners (the JAX CLI ignores the
    # flag on host envs).
    (["--agent=ppo", "--env=synthetic_atari_host", "--num_replicas=2"],
     ValueError),
    (["--agent=ppo", "--env=toy", "--run_mode=learner"], NotImplementedError),
])
def test_train_main_ppo_refusals(flags, error):
    with pytest.raises(error):
        train.main(["--device=cpu", "--num_envs=4", "--unroll_length=3",
                    "--total_environment_frames=12"] + flags)


@pytest.mark.parametrize("flag", ["num_checkpoints", "num_saved_models",
                                  "num_snapshots"])
def test_train_main_ppo_action_points(flag, tmp_path, monkeypatch):
    """Each action-point count fires at its 2 marks over 2 steps."""
    from seed_rl_torch.utils import checkpoint as ckpt
    from seed_rl_torch.utils.export import load_policy

    forced = []
    maybe_save = ckpt.CheckpointManager.maybe_save

    def recording(self, step, learner, state, force=False):
        if force:
            forced.append(step)
        return maybe_save(self, step, learner, state, force)

    monkeypatch.setattr(ckpt.CheckpointManager, "maybe_save", recording)
    learner, state, _ = train.main([
        "--device=cpu", "--agent=ppo", "--env=toy", "--num_envs=4",
        "--unroll_length=3", "--epochs_per_step=1", "--batches_per_step=2",
        "--total_environment_frames=24", "--steps_per_call=1",
        f"--logdir={tmp_path}", "--save_checkpoint_secs=1e9", f"--{flag}=2"])
    assert state.step == 2
    # The first offered save comes at once, the last one is forced.
    assert forced == ([1, 2, 2] if flag == "num_checkpoints" else [2])
    exported = (sorted(os.listdir(tmp_path / "saved_models"))
                if flag == "num_saved_models" else [])
    assert exported == (["12", "24"] if flag == "num_saved_models" else [])
    assert [s.frames for s in learner.snapshots] == (
        [12, 24] if flag == "num_snapshots" else [])
    if exported:
        ro = state.rollout
        action, _ = load_policy(str(tmp_path / "saved_models" / "24"))(
            ro.prev_action, ro.env_output, ())
        with torch.no_grad():
            want, _ = learner.agent.policy_step(
                ro.prev_action, ro.env_output, (), deterministic=True)
        assert torch.equal(action, want.action)
