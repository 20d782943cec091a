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

The sampling policy (``deterministic=False``) of those three agents, of
R2D2's epsilon-greedy ``R2D2Agent`` (``VectorDuelingDQNNet``, per-env
epsilons in the program) and of a recurrent ``SACAgent`` on dict
observations, over two chained steps:
- fed the JAX package's own draws (``jax.random.gumbel`` / ``normal``
  for its categorical / normal sample; R2D2's ``randint`` and ``uniform``
  after its key split), against JAX's exported sampling policy
  (``seed_rl_tpu.utils.export``) on the same keys: discrete actions
  equal, continuous actions and states within rtol = atol = 1e-5;
- called with a seeded ``torch.Generator``, against the port's
  ``policy_step(generator=...)`` on a generator of the same seed:
  discrete actions equal, continuous actions and states within rtol =
  atol = 1e-6.
A sampling policy called without a generator raises ``ValueError``.

Every distribution of ``distributions.py`` (categorical, multi-categorical,
tanh-normal, clipped normal, deterministic tanh and a joint of them):
its ``draws`` recipe, drawn as the JAX distribution draws from its key
(a joint one splits it per sub-distribution), gives the JAX sample exactly
(discrete) or within rtol = atol = 1e-5; and a ``PolicyAgent``
(``MLPPolicyNetwork``) over it, exported sampling, equals its own
``policy_step(generator=...)``.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.utils._pytree as pytree

from seed_rl_tpu import distributions as jpd
from seed_rl_tpu.agent import PolicyAgent as JaxPolicyAgent
from seed_rl_tpu.agents import r2d2 as jax_r2d2
from seed_rl_tpu.utils import export as jax_export
from seed_rl_tpu.agents.ppo import continuous_control_agent as jcca
from seed_rl_tpu.agents.ppo import input_normalization as jin
from seed_rl_tpu.models import MLPAndLSTM as JaxMLPAndLSTM
from seed_rl_tpu.models import atari as jax_atari
from seed_rl_tpu.ops import running_statistics as jrs
from seed_rl_tpu.types import EnvOutput as JaxEnvOutput
from seed_rl_torch import distributions as tpd
from seed_rl_torch.agent import PolicyAgent
from seed_rl_torch.agents import r2d2
from seed_rl_torch.agents.ppo import continuous_control_agent as cca
from seed_rl_torch.agents.ppo import input_normalization as tin
from seed_rl_torch.models import (
    AtariPolicyNet,
    MLPAndLSTM,
    MLPPolicyNetwork,
    convert,
)
from seed_rl_torch.ops import running_statistics as trs
from seed_rl_torch.types import EnvOutput
from seed_rl_torch.utils.export import export_policy, load_policy
from test_torch_r2d2 import A as R2D2_ACTIONS
from test_torch_r2d2 import SMALL_NET
from test_torch_r2d2 import _env_output as _r2d2_env_output
from test_torch_r2d2 import _jax_nets as _r2d2_nets
from test_torch_sac import CASES as SAC_CASES
from test_torch_sac import _data as _sac_data
from test_torch_sac import _setup as _sac_setup

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


# --- The sampling policy. ---------------------------------------------


def _categorical_draws(key, jout):
    """jax.random.categorical's Gumbel noise."""
    logits = jout.policy_logits
    return [jax.random.gumbel(key, logits.shape, logits.dtype)]


def _normal_draws(key, jout):
    """A diagonal normal's standard normal noise (tanh-normal sample)."""
    params = jout.policy_logits
    shape = params.shape[:-1] + (params.shape[-1] // 2,)
    return [jax.random.normal(key, shape, params.dtype)]


def _policy_sampling(name):
    """One of the deterministic cases, sampling: (JAX agent, its params,
    the port's agent, an input maker, JAX's draws from a key)."""
    jagent, params, tagent, inputs = _setup(name)
    draws = (_normal_draws if name == "normalizing_continuous_control"
             else _categorical_draws)
    return jagent, params, tagent, inputs, draws


def _r2d2_sampling():
    """Epsilon-greedy R2D2 with epsilons from 0 to 1 across the batch: both
    branches are taken."""
    jnet, tnet, params = _r2d2_nets(**SMALL_NET)
    eps = np.linspace(0.0, 1.0, B).astype(np.float32)
    jagent = jax_r2d2.R2D2Agent(jnet, jnp.asarray(eps))
    tagent = r2d2.R2D2Agent(tnet, torch.from_numpy(eps))
    rng = np.random.RandomState(2)

    def inputs():
        return (rng.randint(0, R2D2_ACTIONS, B).astype(np.int32),
                _r2d2_env_output(rng, (B,), done_p=0.3))

    def draws(key, jout):
        rand_key, pick_key = jax.random.split(key)  # R2D2Agent.policy_step
        return [jax.random.randint(rand_key, (B,), 0, R2D2_ACTIONS,
                                   dtype=jnp.int32),
                jax.random.uniform(pick_key, (B,))]

    return jagent, params, tagent, inputs, draws


def _sac_sampling():
    """A recurrent SAC actor (ActorCriticLSTM) on goal dict observations,
    tanh-normal actions."""
    case = SAC_CASES["lstm"]
    rng = np.random.RandomState(6)
    setup = _sac_setup(case, rng, B)

    def inputs():
        _, prev, eo, _ = _sac_data(case, rng, 1, B, setup.tagent.net)
        return prev[0], {k: pytree.tree_map(lambda x: x[0], v)
                         for k, v in eo.items()}

    return (setup.jagent, setup.jparams["net"], setup.tagent, inputs,
            _normal_draws)


SAMPLING = {
    **{name: functools.partial(_policy_sampling, name) for name in CASES},
    "r2d2_epsilon_greedy": _r2d2_sampling,
    "sac_lstm": _sac_sampling,
}


@functools.lru_cache(maxsize=None)
def _register_jax_agent_state():
    """The JAX package's export_policy registers the NamedTuples it knows,
    not AtariPolicyNet's AgentState, and refuses a program whose state is
    one; the test registers it for jax.export."""
    jax.export.register_namedtuple_serialization(
        jax_atari.AgentState,
        serialized_name="seed_rl_tpu.atari.AgentState")


@functools.lru_cache(maxsize=None)
def _sampling_export(name, directory):
    """The case's agents and input maker, and the port's sampling policy
    exported to ``directory`` and loaded back (once per case)."""
    jagent, params, tagent, inputs, draws = SAMPLING[name]()
    if name == "atari_policy_net":
        _register_jax_agent_state()
    prev_action, env_output = inputs()
    export_policy(directory, tagent, _torch(prev_action),
                  EnvOutput(**_torch(env_output)), deterministic=False)
    return jagent, params, tagent, inputs, draws, load_policy(directory)


@pytest.fixture
def sampling(request, tmp_path_factory):
    name = request.param
    return name, _sampling_export(
        name, str(tmp_path_factory.getbasetemp() / f"sampling_{name}"))


def _assert_states_close(got, want, **tol):
    got, want = pytree.tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


@pytest.mark.parametrize("sampling", list(SAMPLING), indirect=True)
def test_sampling_policy_fed_jax_draws_matches_jax_export(sampling,
                                                          tmp_path):
    name, (jagent, params, tagent, inputs, draws, policy) = sampling
    prev_action, env_output = inputs()
    jax_export.export_policy(str(tmp_path / "jax"), jagent, params,
                             jnp.asarray(prev_action),
                             JaxEnvOutput(**env_output), deterministic=False)
    jpolicy = jax_export.load_policy(str(tmp_path / "jax"))
    jstate, tstate = jagent.initial_state(B), tagent.initial_state(B)
    for step in range(2):
        if step:
            prev_action, env_output = inputs()
        key = jax.random.PRNGKey(10 + step)
        jprev, jeo = jnp.asarray(prev_action), JaxEnvOutput(**env_output)
        jout, _ = jagent.policy_step(params, jprev, jeo, jstate, key,
                                     deterministic=True)
        jax_draws = [torch.tensor(np.asarray(d))
                     for d in draws(key, jout)]
        assert [tuple(d.shape) for d in jax_draws] == [
            d.shape for d in policy.recipe], name
        assert [d.dtype for d in jax_draws] == [d.dtype for d in
                                                 policy.recipe], name
        jaction, jstate = jpolicy(jprev, jeo, jstate, key)
        action, tstate = policy.step(_torch(prev_action),
                                     EnvOutput(**_torch(env_output)), tstate,
                                     jax_draws)
        if action.dtype.is_floating_point:
            np.testing.assert_allclose(action.numpy(), np.asarray(jaction),
                                       **TOL)
        else:
            assert action.dtype == torch.int32
            np.testing.assert_array_equal(action.numpy(),
                                          np.asarray(jaction))
        _assert_states_close(tstate, jstate, **TOL)


@pytest.mark.parametrize("sampling", list(SAMPLING), indirect=True)
def test_sampling_policy_draws_as_policy_step(sampling):
    """The loaded program with a seeded generator equals the port's own
    ``policy_step(generator=...)`` on a generator of the same seed."""
    name, (_, _, tagent, inputs, _, policy) = sampling
    assert not policy.deterministic and policy.recipe
    got_rng = torch.Generator().manual_seed(17)
    want_rng = torch.Generator().manual_seed(17)
    state = want_state = tagent.initial_state(B)
    for _ in range(2):
        prev_action, env_output = (_torch(x) for x in inputs())
        env_output = EnvOutput(**env_output)
        action, state = policy(prev_action, env_output, state, got_rng)
        with torch.no_grad():
            want, want_state = tagent.policy_step(
                prev_action, env_output, want_state, generator=want_rng)
        assert action.dtype == want.action.dtype
        if action.dtype.is_floating_point:
            torch.testing.assert_close(action, want.action, rtol=1e-6,
                                       atol=1e-6)
        else:
            assert torch.equal(action, want.action), name
        for g, w in zip(pytree.tree_leaves(state),
                        pytree.tree_leaves(want_state)):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    # Both generators advanced by the same draws.
    assert torch.equal(got_rng.get_state(), want_rng.get_state())


@pytest.mark.parametrize("sampling", ["mlp_and_lstm"], indirect=True)
def test_a_sampling_policy_needs_a_generator(sampling):
    _, (_, _, tagent, inputs, _, policy) = sampling
    prev_action, env_output = (_torch(x) for x in inputs())
    state = tagent.initial_state(B)
    with pytest.raises(ValueError, match="torch.Generator"):
        policy(prev_action, EnvOutput(**env_output), state)
    with pytest.raises(ValueError, match="torch.Generator"):
        policy(prev_action, EnvOutput(**env_output), state, rng=0)


def test_a_deterministic_policy_ignores_rng(tmp_path):
    _, _, tagent, inputs = _setup("mlp_and_lstm")
    prev_action, env_output = (_torch(x) for x in inputs())
    env_output = EnvOutput(**env_output)
    export_policy(str(tmp_path), tagent, prev_action, env_output)
    policy = load_policy(str(tmp_path))
    assert policy.deterministic and policy.recipe == []
    state = tagent.initial_state(B)
    rng = torch.Generator().manual_seed(1)
    before = rng.get_state()
    action, _ = policy(prev_action, env_output, state, rng)
    assert torch.equal(rng.get_state(), before)
    assert torch.equal(action, policy(prev_action, env_output, state)[0])


# name -> (JAX distribution, the port's); 3 actions a dim, 2 dims.
DISTRIBUTIONS = {
    "categorical": lambda pd: pd.CategoricalDistribution(3),
    "multi_categorical": lambda pd: pd.MultiCategoricalDistribution(2, 3),
    "normal_tanh": lambda pd: pd.NormalTanhDistribution(2),
    "normal_clipped": lambda pd: pd.NormalClippedDistribution(2),
    "deterministic_tanh": lambda pd: pd.DeterministicTanhDistribution(2),
    "joint": lambda pd: pd.JointDistribution([
        pd.CategoricalDistribution(3), pd.NormalTanhDistribution(2),
        pd.DeterministicTanhDistribution(1)]),
}


def _jax_draws(dist, params, key):
    """The noise JAX's ``dist.sample(params, key)`` draws, as a tree of the
    port's ``draws`` recipe."""
    if isinstance(dist, jpd.JointDistribution):
        keys = jax.random.split(key, len(dist._dists))
        return [_jax_draws(d, p, k) for d, p, k in
                zip(dist._dists, dist._split_params(params), keys)]
    if isinstance(dist, jpd.MultiCategoricalDistribution):
        logits = dist._logits(params)
        return jax.random.gumbel(key, logits.shape, logits.dtype)
    if isinstance(dist, jpd.CategoricalDistribution):
        return jax.random.gumbel(key, params.shape, params.dtype)
    if isinstance(dist, jpd.DeterministicTanhDistribution):
        return None
    shape = params.shape[:-1] + (params.shape[-1] // 2,)
    return jax.random.normal(key, shape, params.dtype)


def _shapes(tree):
    """A recipe's or a noise tree's (shape, dtype) leaves, in its tree."""
    if tree is None:
        return None
    if isinstance(tree, (tpd.Draw, torch.Tensor)):
        return tuple(tree.shape), tree.dtype
    return [_shapes(t) for t in tree]


@pytest.mark.parametrize("name", list(DISTRIBUTIONS))
def test_distribution_draws_give_the_jax_sample(name):
    jdist, tdist = DISTRIBUTIONS[name](jpd), DISTRIBUTIONS[name](tpd)
    rng = np.random.RandomState(3)
    params = rng.normal(size=(B, tdist.param_size)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = jdist.sample(jnp.asarray(params), key)
    noise = jax.tree.map(lambda x: torch.tensor(np.asarray(x)),
                         _jax_draws(jdist, jnp.asarray(params), key))
    recipe = tdist.draws(torch.from_numpy(params))
    # The recipe's tree, shapes and dtypes are those of JAX's draws.
    assert _shapes(recipe) == _shapes(noise)
    got = tdist.sample(torch.from_numpy(params), noise=noise)
    if got.dtype.is_floating_point:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", list(DISTRIBUTIONS))
def test_each_distributions_sampling_export_draws_as_policy_step(name,
                                                                 tmp_path):
    dist = DISTRIBUTIONS[name](tpd)
    agent = PolicyAgent(MLPPolicyNetwork(dist.param_size, input_size=5,
                                         mlp_sizes=(8,), device="cpu"),
                        dist)
    rng = np.random.RandomState(4)
    prev_action = torch.zeros((B,), dtype=torch.int32)
    env_output = EnvOutput(**_torch(_env_output(
        rng, rng.normal(size=(B, 5)).astype(np.float32))))
    export_policy(str(tmp_path), agent, prev_action, env_output,
                  deterministic=False)
    policy = load_policy(str(tmp_path))
    assert len(policy.recipe) == {"deterministic_tanh": 0, "joint": 2}.get(
        name, 1)
    got_rng = torch.Generator().manual_seed(9)
    want_rng = torch.Generator().manual_seed(9)
    action, _ = policy(prev_action, env_output, (), got_rng)
    with torch.no_grad():
        want, _ = agent.policy_step(prev_action, env_output, (),
                                    generator=want_rng)
    torch.testing.assert_close(action, want.action, rtol=1e-6, atol=1e-6)
    assert torch.equal(got_rng.get_state(), want_rng.get_state())
