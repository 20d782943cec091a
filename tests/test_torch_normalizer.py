"""Observation normalization in seed_rl_torch against the JAX package
(mirroring tests/test_normalizer.py:18-118; its SAC case is in
tests/test_torch_sac.py).

- ``ops/normalizer.py``: the statistics after seeded batches, and the
  normalized (clipped) outputs, agree with JAX within rtol 1e-5 / atol
  1e-6 and with the numpy ground truth; multi-rank batches, the initial
  clip, the dict concat-and-split and the stop-gradient; dicts whose keys
  were inserted out of sorted order agree with JAX (which concatenates in
  sorted key order) within rtol = atol = 1e-6 and come back in the
  caller's key order; the statistics' width is the sum of the leaves'
  last dimensions, as JAX sizes it.
- One V-trace step with ``NormalizingObservationsAgent`` on the toy env:
  the JAX learner's parameters and statistics (folded from an earlier
  unroll) go through the JAX and the port's ``compute_loss`` / ``update``
  on one unroll; loss, metrics, gradients and the parameters after one
  Adam step agree within rtol 1e-4 / atol 1e-5 (sums in another order),
  and the statistics after the step's fold within rtol 1e-5 / atol 1e-6.
- The CLI's ``--agent=vtrace --env=toy --normalize_observations`` on the
  CPU, and its refusal on a pixel env.
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
from seed_rl_tpu.agent import (
    NormalizingObservationsAgent as JaxNormalizingObservationsAgent,
)
from seed_rl_tpu.agent import PolicyAgent as JaxPolicyAgent
from seed_rl_tpu.agents import vtrace as jax_vtrace
from seed_rl_tpu.envs import BatchedEnv as JaxBatchedEnv
from seed_rl_tpu.envs import ToyEnv as JaxToyEnv
from seed_rl_tpu.models import MLPAndLSTM as JaxMLPAndLSTM
from seed_rl_tpu.ops import normalizer as jnorm
from seed_rl_tpu.rollout import RolloutEngine as JaxRolloutEngine
from seed_rl_torch import distributions as tpd
from seed_rl_torch import optim, train
from seed_rl_torch.agent import NormalizingObservationsAgent, PolicyAgent
from seed_rl_torch.agents import vtrace
from seed_rl_torch.envs import BatchedEnv, ToyEnv
from seed_rl_torch.models import MLPAndLSTM, convert
from seed_rl_torch.ops import normalizer
from seed_rl_torch.rollout import RolloutEngine, Timestep, Unroll
from seed_rl_torch.types import AgentOutput, EnvOutput

STATS_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)


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
    return torch.tensor(np.asarray(x))


def _close(got, want, tol=STATS_TOL):
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **tol)


def test_normalizer_matches_jax_and_numpy():
    rng = np.random.RandomState(0)
    state, jstate = normalizer.init(3), jnorm.init(3)
    seen = []
    for _ in range(4):
        batch = (rng.randn(7, 3) * 2.0 + 1.0).astype(np.float32)
        seen.append(batch)
        state = normalizer.update(state, torch.from_numpy(batch))
        jstate = jnorm.update(jstate, jnp.asarray(batch))
        _close(state, jstate)
    rows = np.concatenate(seen)
    np.testing.assert_allclose(state.mean.numpy(), rows.mean(0), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(state.std.numpy(), rows.std(0), rtol=1e-4,
                               atol=1e-4)
    x = (rng.randn(5, 3) * 4).astype(np.float32)
    got = normalizer.normalize(state, torch.from_numpy(x))
    _close(got, jnorm.normalize(jstate, jnp.asarray(x)))
    np.testing.assert_allclose(
        got.numpy(),
        np.clip((x - rows.mean(0)) / (rows.std(0) + 0.001), -5, 5),
        rtol=1e-4, atol=1e-4)


def test_normalizer_multirank_batches_and_initial_clip():
    state = normalizer.update(
        normalizer.init(2), torch.arange(24, dtype=torch.float32).reshape(
            3, 4, 2))
    assert float(state.steps) == 12.0
    flat = np.arange(24, dtype=np.float32).reshape(12, 2)
    np.testing.assert_allclose(state.mean.numpy(), flat.mean(0), rtol=1e-6)
    # Before any update mean = std = 0: clip(x / eps) = +-5 for |x| >> 0.
    out = normalizer.normalize(normalizer.init(1),
                               torch.tensor([[3.0], [-3.0], [0.0]]))
    torch.testing.assert_close(out[:, 0], torch.tensor([5.0, -5.0, 0.0]))


def test_normalize_observation_dict_concat_split_matches_jax():
    rng = np.random.RandomState(1)
    data = rng.normal(size=(100, 5)).astype(np.float32)
    state = normalizer.update(normalizer.init(5), torch.from_numpy(data))
    jstate = jnorm.update(jnorm.init(5), jnp.asarray(data))
    obs = {"a": rng.normal(size=(4, 2)).astype(np.float32),
           "b": rng.normal(size=(4, 3)).astype(np.float32)}
    got = normalizer.normalize_observation(
        state, {k: torch.from_numpy(v) for k, v in obs.items()})
    want = jnorm.normalize_observation(
        jstate, {k: jnp.asarray(v) for k, v in obs.items()})
    assert got["a"].shape == (4, 2) and got["b"].shape == (4, 3)
    _close(got, want)
    _close(normalizer.update_from_observation(
        state, {k: torch.from_numpy(v) for k, v in obs.items()}),
        jnorm.update_from_observation(jstate, obs))


@pytest.mark.parametrize("order", [("b", "a"), ("c", "a", "b")])
def test_dict_observation_out_of_key_order_matches_jax(order):
    widths = {"a": 2, "b": 3, "c": 1}
    tol = dict(rtol=1e-6, atol=1e-6)
    rng = np.random.RandomState(2)

    def observation(lead):
        return {k: (rng.normal(size=lead + (widths[k],)) * (1 + i)).astype(
            np.float32) for i, k in enumerate(order)}

    width = sum(widths[k] for k in order)
    state, jstate = normalizer.init(width), jnorm.init(width)
    for _ in range(3):
        obs = observation((4, 5))
        state = normalizer.update_from_observation(
            state, {k: torch.from_numpy(v) for k, v in obs.items()})
        jstate = jnorm.update_from_observation(
            jstate, {k: jnp.asarray(v) for k, v in obs.items()})
        _close(state, jstate, tol)
    obs = observation((6,))
    got = normalizer.normalize_observation(
        state, {k: torch.from_numpy(v) for k, v in obs.items()})
    assert tuple(got) == order  # the caller's layout
    want = jnorm.normalize_observation(
        jstate, {k: jnp.asarray(v) for k, v in obs.items()})
    for k in order:
        assert got[k].shape == (6, widths[k])
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **tol, err_msg=k)


def test_normalizer_width_is_the_sum_of_the_leaves_last_dims():
    from seed_rl_torch.envs import BitFlippingEnv, CatchEnv, ToyEnv

    spec = BitFlippingEnv(n_bits=10, horizon=20).observation_spec()
    assert normalizer.observation_width(spec) == 10 + 10 + 21
    obs = {k: jnp.zeros((7, 3) + s.shape) for k, s in spec.items()}
    assert normalizer.observation_width(spec) == jnorm._flat_width(obs)
    assert normalizer.observation_width(ToyEnv().observation_spec()) == (
        ToyEnv().observation_spec().shape[-1])
    # Frames would be normalized per channel, every other axis folded.
    assert normalizer.observation_width(CatchEnv().observation_spec()) == 1


def test_normalizer_statistics_take_no_gradient():
    state = normalizer.update(normalizer.init(2), torch.ones((10, 2)) * 3.0)
    mean = state.mean.clone().requires_grad_(True)
    out = normalizer.normalize(state._replace(mean=mean), torch.ones((1, 2)))
    assert not out.requires_grad


def _torch_unroll(unroll):
    ts = unroll.timesteps
    return Unroll(
        agent_state=jax.tree.map(_t, unroll.agent_state),
        timesteps=Timestep(
            prev_action=_t(ts.prev_action),
            env_output=EnvOutput(*map(_t, ts.env_output)),
            agent_output=AgentOutput(*map(_t, ts.agent_output)),
        ),
    )


def _named(net, params):
    want = convert.state_dict_for(net, params["net"]["policy"])
    return {n: want[n].numpy() for n, _ in net.named_parameters()}


def test_vtrace_step_with_normalized_observations_matches_jax():
    B, T, lr = 8, 5, 1e-3
    jdist = jpd.NormalTanhDistribution(3)
    jagent = JaxNormalizingObservationsAgent(JaxPolicyAgent(
        JaxMLPAndLSTM(6, mlp_sizes=(16,), lstm_sizes=(8,)), jdist))
    jengine = JaxRolloutEngine(JaxBatchedEnv(JaxToyEnv(horizon=3), B),
                               jagent, T)
    config = dict(discounting=0.9, entropy_cost=1e-2)
    jconfig = jax_vtrace.VTraceConfig(**config)
    jlearner = jax_vtrace.VTraceLearner(
        jengine, jagent, jconfig,
        optax.chain(optax.clip_by_global_norm(40.0), optax.adam(lr)))
    jstate = jlearner.init(jax.random.PRNGKey(0))
    rollout = jax.jit(jengine.rollout)
    first_rollout, first = rollout(jstate.params["net"], jstate.rollout)
    # Statistics from an earlier unroll, so the step normalizes for real.
    net_params = jagent.update_observation_normalization(
        jstate.params["net"], first.timesteps.env_output.observation)
    jstate = jstate._replace(params=dict(jstate.params, net=net_params))
    _, unroll = rollout(jstate.params["net"], first_rollout)
    loss_rng = jax.random.PRNGKey(7)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        functools.partial(jax_vtrace.compute_loss, jconfig, jagent, jdist),
        has_aux=True))(jstate.params, unroll, loss_rng)
    jnew, jupdate_metrics = jax.jit(jlearner.update)(jstate, unroll, loss_rng)
    noise = _t(jax.random.normal(loss_rng, (T, B, 3), jnp.float32))

    params = jax.tree.map(np.asarray, jstate.params)
    net = MLPAndLSTM(6, 4, mlp_sizes=(16,), lstm_sizes=(8,), device="cpu")
    net.load_state_dict(convert.state_dict_for(net, params["net"]["policy"]))
    agent = NormalizingObservationsAgent(
        PolicyAgent(net, tpd.NormalTanhDistribution(3)), 4)
    agent.obs_norm = normalizer.NormalizerState(
        *map(_t, params["net"]["obs_norm"]))
    learner = vtrace.VTraceLearner(
        RolloutEngine(BatchedEnv(ToyEnv(horizon=3), B, device="cpu"), agent,
                      T),
        agent, vtrace.VTraceConfig(**config),
        functools.partial(optim.ClippedAdam, learning_rate=lr,
                          clip_norm=40.0))
    with torch.no_grad():
        learner.entropy_cost.copy_(_t(params["entropy_cost"]))
    tunroll = _torch_unroll(unroll)

    loss, metrics = vtrace.compute_loss(
        learner.config, agent, agent.distribution, learner.entropy_cost,
        tunroll, entropy_noise=noise)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   **TOL, err_msg=k)
    grads = torch.autograd.grad(loss, learner.parameters())
    want = _named(net, jax.tree.map(np.asarray, jgrads))
    for (name, _), got in zip(net.named_parameters(), grads):
        np.testing.assert_allclose(got.numpy(), want[name], **TOL,
                                   err_msg=f"grad {name}")

    _, update_metrics = learner.update(learner.init(), tunroll,
                                       entropy_noise=noise)
    for k in jupdate_metrics:
        np.testing.assert_allclose(float(update_metrics[k]),
                                   float(jupdate_metrics[k]), **TOL,
                                   err_msg=k)
    want = _named(net, jax.tree.map(np.asarray, jnew.params))
    for name, got in net.named_parameters():
        np.testing.assert_allclose(got.detach().numpy(), want[name], **TOL,
                                   err_msg=f"updated {name}")
    # The step folded its whole (T+1) x B unroll into the statistics.
    _close(agent.obs_norm, jnew.params["net"]["obs_norm"])
    assert float(agent.obs_norm.steps) == 2 * (T + 1) * B
    # The statistics are among the state a device check looks at.
    assert any(t is agent.obs_norm.sum
               for t in learner.state_tensors(learner.init()))


def test_train_main_vtrace_normalize_observations_on_cpu():
    learner, state, metrics = train.main([
        "--agent=vtrace", "--env=toy", "--normalize_observations",
        "--device=cpu", "--num_envs=8", "--unroll_length=4",
        "--total_environment_frames=64", "--steps_per_call=1",
        "--log_every_steps=1",
    ])
    assert state.step == 2
    assert isinstance(learner.agent, NormalizingObservationsAgent)
    assert float(learner.agent.obs_norm.steps) == 2 * 5 * 8
    assert all(math.isfinite(float(v)) for v in metrics.values())


@pytest.mark.parametrize("flags", [
    ["--agent=vtrace", "--env=catch"],
    ["--agent=vtrace", "--env=synthetic_atari"],
    ["--agent=ppo", "--env=toy"],
])
def test_train_main_refuses_normalize_observations_elsewhere(flags):
    with pytest.raises(NotImplementedError, match="not ported"):
        train.main(["--device=cpu", "--normalize_observations"] + flags)
