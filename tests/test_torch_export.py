"""Policy export of seed_rl_torch (``utils/export.py``), mirroring
tests/test_eval_export.py::test_export_and_reload_policy.

For ``MLPAndLSTM`` (an LSTM carry), ``AtariPolicyNet`` (the frame stack
and an LSTM carry in ``AgentState``) and ``NormalizingPolicyAgent`` with
``ContinuousControlNet`` (observation statistics inside the program),
``export_policy`` then ``load_policy`` from disk, over two chained steps:
- against the port's ``policy_step(deterministic=True)``: actions and new
  states equal;
- against the JAX package's ``agent.policy_step(..., deterministic=True)``
  on the same parameters (converted with models/convert.py): discrete
  actions equal, continuous actions and states within rtol = atol = 1e-5.
A sampling policy (``deterministic=False``) is refused.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.utils._pytree as pytree

from seed_rl_tpu import distributions as jpd
from seed_rl_tpu.agent import PolicyAgent as JaxPolicyAgent
from seed_rl_tpu.agents.ppo import continuous_control_agent as jcca
from seed_rl_tpu.agents.ppo import input_normalization as jin
from seed_rl_tpu.models import MLPAndLSTM as JaxMLPAndLSTM
from seed_rl_tpu.models import atari as jax_atari
from seed_rl_tpu.ops import running_statistics as jrs
from seed_rl_tpu.types import EnvOutput as JaxEnvOutput
from seed_rl_torch import distributions as tpd
from seed_rl_torch.agent import PolicyAgent
from seed_rl_torch.agents.ppo import continuous_control_agent as cca
from seed_rl_torch.agents.ppo import input_normalization as tin
from seed_rl_torch.models import AtariPolicyNet, MLPAndLSTM, convert
from seed_rl_torch.ops import running_statistics as trs
from seed_rl_torch.types import EnvOutput
from seed_rl_torch.utils.export import export_policy, load_policy

TOL = dict(rtol=1e-5, atol=1e-5)
B = 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread (see tests/test_torch_ppo.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _env_output(rng, observation):
    return dict(
        reward=rng.normal(size=(B,)).astype(np.float32),
        done=rng.uniform(size=(B,)) < 0.3,
        observation=observation,
        abandoned=np.zeros((B,), bool),
        episode_step=np.zeros((B,), np.int32),
    )


def _mlp_and_lstm(rng):
    jagent = JaxPolicyAgent(
        JaxMLPAndLSTM(parametric_distribution_param_size=4, mlp_sizes=(16,),
                      lstm_sizes=(8,)), jpd.CategoricalDistribution(4))
    tnet = MLPAndLSTM(4, input_size=5, mlp_sizes=(16,), lstm_sizes=(8,),
                      device="cpu")
    tagent = PolicyAgent(tnet, tpd.CategoricalDistribution(4))

    def inputs():
        return (rng.randint(0, 4, (B,)).astype(np.int32), _env_output(
            rng, rng.normal(size=(B, 5)).astype(np.float32)))

    return jagent, tagent, inputs


def _atari_policy_net(rng):
    kw = dict(frame_shape=(36, 36), stack_size=4, lstm_size=8)
    jagent = JaxPolicyAgent(
        jax_atari.AtariPolicyNet(parametric_distribution_param_size=5, **kw),
        jpd.CategoricalDistribution(5))
    tagent = PolicyAgent(AtariPolicyNet(5, device="cpu", **kw),
                         tpd.CategoricalDistribution(5))

    def inputs():
        return (rng.randint(0, 5, (B,)).astype(np.int32), _env_output(
            rng, rng.randint(0, 256, (B, 36, 36, 1)).astype(np.uint8)))

    return jagent, tagent, inputs


def _normalizing_continuous_control(rng):
    agents = []
    for pd, m, norm, rs, activation in (
            (jpd, jcca, jin, jrs, jnp.tanh), (tpd, cca, tin, trs, torch.tanh)):
        extra = {} if m is jcca else dict(input_size=5, device="cpu")
        net = m.ContinuousControlNet(
            parametric_distribution_param_size=6, num_layers_policy=2,
            num_layers_value=2, num_units_policy=16, num_units_value=16,
            activation=activation, std_independent_of_input=True, **extra)
        agents.append(m.NormalizingPolicyAgent(
            net, pd.NormalTanhDistribution(
                3, gaussian_std_fn=pd.safe_exp_std_fn(1.0, 1e-3)),
            input_normalization=norm.InputNormalization(
                rs.AverageMeanStd(), input_size=5),
            input_clipping=10.0))

    def inputs():
        return (rng.uniform(-1, 1, (B, 3)).astype(np.float32),
                _env_output(rng, 3.0 * rng.normal(size=(B, 5)).astype(
                    np.float32) + 1.0))

    return (*agents, inputs)


CASES = {
    "mlp_and_lstm": _mlp_and_lstm,
    "atari_policy_net": _atari_policy_net,
    "normalizing_continuous_control": _normalizing_continuous_control,
}


def _torch(tree):
    return pytree.tree_map(torch.from_numpy, tree)


def _setup(name):
    """The JAX agent and params, the port's agent holding the same
    parameters (and statistics), and an input maker."""
    rng = np.random.RandomState(0)
    jagent, tagent, inputs = CASES[name](rng)
    prev_action, env_output = inputs()
    params = jagent.init_params(jax.random.PRNGKey(1),
                                jnp.asarray(prev_action),
                                JaxEnvOutput(**env_output))
    net_params = params
    if isinstance(jagent, jcca.NormalizingPolicyAgent):
        observations = 2.0 * rng.normal(size=(3, B, 5)).astype(np.float32)
        params = jagent.update_observation_normalization(
            params, jnp.asarray(observations))
        tagent.obs_norm = type(tagent.obs_norm)(
            *(torch.tensor(np.asarray(x)) for x in params["obs_norm"]))
        net_params = params["net"]
    tagent.net.load_state_dict(convert.state_dict_for(
        tagent.net, jax.tree.map(np.asarray, net_params)), strict=True)
    return jagent, params, tagent, inputs


@pytest.mark.parametrize("name", list(CASES))
def test_exported_policy_matches_the_port_and_jax(name, tmp_path):
    jagent, params, tagent, inputs = _setup(name)
    prev_action, env_output = inputs()
    export_policy(str(tmp_path / "export"), tagent, _torch(prev_action),
                  EnvOutput(**_torch(env_output)))
    policy = load_policy(str(tmp_path / "export"))

    jstate, tstate = jagent.initial_state(B), tagent.initial_state(B)
    estate = tagent.initial_state(B)
    for step in range(2):
        if step:
            prev_action, env_output = inputs()
        action, estate = policy(_torch(prev_action),
                                EnvOutput(**_torch(env_output)), estate)
        with torch.no_grad():
            want, tstate = tagent.policy_step(
                _torch(prev_action), EnvOutput(**_torch(env_output)), tstate,
                deterministic=True)
        assert action.dtype == want.action.dtype
        assert torch.equal(action, want.action)
        got_leaves, got_spec = pytree.tree_flatten(estate)
        want_leaves, want_spec = pytree.tree_flatten(tstate)
        assert got_spec == want_spec
        assert all(torch.equal(g, w) for g, w in zip(got_leaves, want_leaves))

        jout, jstate = jagent.policy_step(
            params, jnp.asarray(prev_action), JaxEnvOutput(**env_output),
            jstate, jax.random.PRNGKey(0), deterministic=True)
        if action.dtype.is_floating_point:
            np.testing.assert_allclose(action.numpy(),
                                       np.asarray(jout.action), **TOL)
        else:
            np.testing.assert_array_equal(action.numpy(),
                                          np.asarray(jout.action))
        jax_leaves = jax.tree.leaves(jstate)
        assert len(jax_leaves) == len(got_leaves)
        for g, w in zip(got_leaves, jax_leaves):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_the_statistics_ride_inside_the_program(tmp_path):
    """The exported program holds the statistics as they were: later
    updates of the agent's own do not reach it."""
    _, _, tagent, inputs = _setup("normalizing_continuous_control")
    prev_action, env_output = (_torch(x) for x in inputs())
    env_output = EnvOutput(**env_output)
    export_policy(str(tmp_path), tagent, prev_action, env_output)
    with torch.no_grad():
        want, _ = tagent.policy_step(prev_action, env_output, (),
                                     deterministic=True)
        tagent.update_observation_normalization(
            10.0 * torch.ones((2, B, 5)))
        moved, _ = tagent.policy_step(prev_action, env_output, (),
                                      deterministic=True)
    assert not torch.equal(moved.action, want.action)
    action, _ = load_policy(str(tmp_path))(prev_action, env_output, ())
    assert torch.equal(action, want.action)


def test_a_sampling_policy_is_not_exported(tmp_path):
    _, _, tagent, inputs = _setup("mlp_and_lstm")
    prev_action, env_output = inputs()
    with pytest.raises(NotImplementedError, match="torch.Generator"):
        export_policy(str(tmp_path), tagent, _torch(prev_action),
                      EnvOutput(**_torch(env_output)), deterministic=False)
