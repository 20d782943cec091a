"""The port's external-actor pipeline (seed_rl_torch.runtime) against JAX.

Held against seed_rl_tpu on inputs made from a numpy seed:
- ``HostUnrollStore``: the same completed ids and unrolls, with a burn-in
  overlap, a reset and a dict observation built in another key order;
- ``get_non_dying_envs``: the same masks;
- the bridge: one fixed sequence of handler batches (envs in any order, a
  duplicate request from a dying actor, a run_id change) through both
  bridges, each agent wrapped in a test-side adapter that acts by the
  policy's mode, the parameters carried over by models/convert.py: the
  same actions, recurrent state and unrolls (logits and baselines within
  rtol 1e-4 / atol 1e-5, the rest exactly); the V-trace update on each
  bridge's batch agrees within rtol 1e-4 / atol 1e-5;
- R2D2's epsilon-greedy step by global env id, with JAX's uniform and
  random-action draws injected, gives JAX's actions.

Then the behaviour of tests/test_actor_runtime.py and the inference-stage
cases of tests/test_profiling_snapshots.py on the port, and the trap of
parameters that change in place: the bridge acts on what was published.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seed_rl_tpu import distributions as jpd
from seed_rl_tpu.agent import PolicyAgent as JaxPolicyAgent
from seed_rl_tpu.agents import r2d2 as jax_r2d2
from seed_rl_tpu.agents import vtrace as jax_vtrace
from seed_rl_tpu.envs import BatchedEnv as JaxBatchedEnv
from seed_rl_tpu.envs import DiscreteMatchEnv as JaxDiscreteMatchEnv
from seed_rl_tpu.models import MLPAndLSTM as JaxMLPAndLSTM
from seed_rl_tpu.models.dueling_mlp import (
    VectorDuelingDQNNet as JaxVectorDuelingDQNNet,
)
from seed_rl_tpu.rollout import RolloutEngine as JaxRolloutEngine
from seed_rl_tpu.runtime import actor as jax_actor
from seed_rl_tpu.runtime.unroll_store import HostUnrollStore as JaxStore
from seed_rl_tpu.types import EnvOutput as JaxEnvOutput
from seed_rl_torch import distributions as tpd
from seed_rl_torch import optim
from seed_rl_torch.agent import PolicyAgent
from seed_rl_torch.agents import r2d2, vtrace
from seed_rl_torch.envs import BatchedEnv, DiscreteMatchEnv
from seed_rl_torch.models import MLPAndLSTM, VectorDuelingDQNNet, convert
from seed_rl_torch.rollout import RolloutEngine
from seed_rl_torch.runtime import specs
from seed_rl_torch.runtime.actor import (
    BridgeClient,
    InferenceBridge,
    actor_loop,
    get_non_dying_envs,
)
from seed_rl_torch.runtime.inference_server import InferenceServer
from seed_rl_torch.runtime.specs import array_spec
from seed_rl_torch.runtime.unroll_store import HostUnrollStore
from seed_rl_torch.types import AgentOutput, EnvOutput
from seed_rl_torch.utils.evaluator import Evaluator
from seed_rl_torch.utils.profiling import ExportingTimer, InferenceReturn

TOL = dict(rtol=1e-4, atol=1e-5)
JOIN_S = 30


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _join(threads):
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a thread hung"


def _to_jax_specs(tree):
    return jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s.shape, np.dtype(s.dtype)), tree,
        is_leaf=lambda x: isinstance(x, specs.ArraySpec))


def _assert_leaves(got, want, exact=True, what=""):
    got, want = specs.leaves_of(got), jax.tree.leaves(want)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        if exact or not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(g, w, err_msg=f"{what} leaf {i}")
        else:
            np.testing.assert_allclose(g, w, **TOL,
                                       err_msg=f"{what} leaf {i}")


def test_unroll_store_matches_jax_with_overlap_reset_and_dict_keys():
    rng = np.random.default_rng(0)
    num_envs, unroll, overlap = 5, 4, 2
    # The port's spec dict is built in another key order than its values.
    port_specs = (array_spec((), np.int32), EnvOutput(
        reward=array_spec((), np.float32), done=array_spec((), bool),
        observation={"pos": array_spec((3,), np.float32),
                     "img": array_spec((2, 2), np.uint8)},
        abandoned=array_spec((), bool),
        episode_step=array_spec((), np.int32)))
    port = HostUnrollStore(num_envs, unroll, port_specs, overlap)
    ref = JaxStore(num_envs, unroll, _to_jax_specs(port_specs), overlap)
    completions = 0
    for step in range(40):
        if step == 17:
            port.reset(np.array([1, 3]))
            ref.reset(np.array([1, 3]))
        ids = rng.permutation(num_envs)[:rng.integers(1, num_envs + 1)]
        n = len(ids)
        obs = {"img": rng.integers(0, 255, (n, 2, 2)).astype(np.uint8),
               "pos": rng.normal(size=(n, 3)).astype(np.float32)}
        values = (rng.integers(0, 4, n).astype(np.int32), EnvOutput(
            reward=rng.normal(size=n).astype(np.float32),
            done=rng.random(n) < 0.3,
            observation=obs,
            abandoned=rng.random(n) < 0.1,
            episode_step=rng.integers(0, 9, n).astype(np.int32)))
        jax_values = (values[0], JaxEnvOutput(*values[1]))
        got_ids, got = port.append(ids, values)
        want_ids, want = ref.append(ids, jax_values)
        np.testing.assert_array_equal(got_ids, want_ids)
        if len(want_ids):
            completions += 1
            _assert_leaves(got, want, what=f"step {step}")
            assert got[1].observation["img"].shape == (
                len(want_ids), overlap + unroll + 1, 2, 2)
        else:
            assert got is None
    assert completions >= 5
    with pytest.raises(ValueError, match="duplicate"):
        port.append(np.array([0, 0]), values)


def test_unroll_store_completion_and_overlap():
    store = HostUnrollStore(num_envs=3, unroll_length=4,
                            timestep_specs=array_spec((2,), np.float32),
                            num_overlapping_steps=1)
    env_ids = np.array([0, 1])
    for t in range(5):
        done_ids, unrolls = store.append(env_ids,
                                         np.full((2, 2), t, np.float32))
        if t < 4:
            assert len(done_ids) == 0
    np.testing.assert_array_equal(done_ids, [0, 1])
    assert unrolls.shape == (2, 6, 2)
    # The zero overlap prefix, then steps 0..4.
    np.testing.assert_array_equal(unrolls[0, :, 0], [0, 0, 1, 2, 3, 4])
    for t in range(5, 9):
        done_ids, unrolls = store.append(env_ids,
                                         np.full((2, 2), t, np.float32))
    np.testing.assert_array_equal(unrolls[0, :, 0], [3, 4, 5, 6, 7, 8])
    store.reset(np.array([0]))
    done_ids, _ = store.append(np.array([0]), np.ones((1, 2), np.float32))
    assert len(done_ids) == 0


def test_get_non_dying_envs_matches_jax():
    rng = np.random.default_rng(1)
    np.testing.assert_array_equal(
        get_non_dying_envs(np.array([1, 2, 2, 3]), np.array([5, 6, 7, 8])),
        [True, False, True, True])
    for _ in range(50):
        env_ids = rng.integers(0, 6, rng.integers(1, 12))
        run_ids = rng.integers(1, 4, len(env_ids))
        keep = get_non_dying_envs(env_ids, run_ids)
        np.testing.assert_array_equal(
            keep, jax_actor.get_non_dying_envs(env_ids, run_ids))
        assert len(np.unique(env_ids)) == keep.sum()


class _JaxModeAgent:
    """JAX agent that acts by its policy's mode (draws nothing)."""

    def __init__(self, inner):
        self.inner = inner

    def initial_state(self, batch_size):
        return self.inner.initial_state(batch_size)

    def policy_step(self, params, prev_action, env_output, core_state, rng):
        return self.inner.policy_step(params, prev_action, env_output,
                                      core_state, rng, deterministic=True)


class _ModeAgent:
    """The port's counterpart of ``_JaxModeAgent``."""

    def __init__(self, inner):
        self.inner = inner
        self.net = inner.net

    def initial_state(self, batch_size):
        return self.inner.initial_state(batch_size)

    def policy_step(self, prev_action, env_output, core_state,
                    generator=None):
        return self.inner.policy_step(prev_action, env_output, core_state,
                                      generator, deterministic=True)


OBS, ACTIONS = 4, 4


def _policy_agents():
    """A JAX MLPAndLSTM agent and the port's with the same parameters."""
    jnet = JaxMLPAndLSTM(ACTIONS, mlp_sizes=(16,), lstm_sizes=(8,))
    jagent = JaxPolicyAgent(jnet, jpd.CategoricalDistribution(ACTIONS))
    params = jagent.init_params(jax.random.PRNGKey(3),
                                jnp.zeros((1,), jnp.int32), _jax_rows(1))
    tnet = MLPAndLSTM(ACTIONS, OBS, mlp_sizes=(16,), lstm_sizes=(8,),
                      device="cpu")
    tnet.load_state_dict(convert.state_dict_for(
        tnet, jax.tree.map(np.asarray, params)))
    return jagent, params, PolicyAgent(tnet,
                                       tpd.CategoricalDistribution(ACTIONS))


def _jax_rows(n):
    return JaxEnvOutput(reward=jnp.zeros((n,)), done=jnp.zeros((n,), bool),
                        observation=jnp.zeros((n, OBS)),
                        abandoned=jnp.zeros((n,), bool),
                        episode_step=jnp.zeros((n,), jnp.int32))


def _timestep_specs():
    env_output = EnvOutput(
        reward=array_spec((), np.float32), done=array_spec((), bool),
        observation=array_spec((OBS,), np.float32),
        abandoned=array_spec((), bool),
        episode_step=array_spec((), np.int32))
    agent_output = AgentOutput(action=array_spec((), np.int32),
                               policy_logits=array_spec((ACTIONS,),
                                                        np.float32),
                               baseline=array_spec((), np.float32))
    return (array_spec((), np.int32), env_output, agent_output)


def _handler_batches(num_envs, steps, seed):
    """A fixed sequence of (env_ids, run_ids, EnvOutput rows): actors A
    (even envs) and B (odd envs) in shuffled subsets; at step 9 a batch
    holds env 1 twice, its dying actor's request first, then its
    replacement's with a new run_id."""
    rng = np.random.default_rng(seed)
    runs = np.where(np.arange(num_envs) % 2 == 0, 11, 22).astype(np.int64)
    batches = []
    for step in range(steps):
        ids = rng.permutation(num_envs)[:rng.integers(2, num_envs + 1)]
        run_ids = runs[ids]
        if step == 9:
            runs[1] = 33
            ids = np.concatenate([ids[ids != 1], [1, 1]])
            run_ids = np.concatenate([runs[ids[:-2]], [22, 33]])
        n = len(ids)
        rows = EnvOutput(
            reward=rng.normal(size=n).astype(np.float32),
            done=rng.random(n) < 0.2,
            observation=rng.normal(size=(n, OBS)).astype(np.float32),
            abandoned=np.zeros(n, bool),
            episode_step=rng.integers(0, 20, n).astype(np.int32))
        batches.append((ids.astype(np.int64), run_ids.astype(np.int64), rows))
    return batches


def _both_bridges(num_envs, unroll_length, overlap=0):
    jagent, params, tagent = _policy_agents()
    jspecs = _to_jax_specs(_timestep_specs())
    jbridge = jax_actor.InferenceBridge(
        _JaxModeAgent(jagent), params_fn=lambda: params, num_envs=num_envs,
        unroll_length=unroll_length, timestep_specs=jspecs,
        num_overlapping_steps=overlap)
    tbridge = InferenceBridge(
        _ModeAgent(tagent), num_envs=num_envs, unroll_length=unroll_length,
        timestep_specs=_timestep_specs(), num_overlapping_steps=overlap,
        device="cpu")
    return jagent, params, tagent, jbridge, tbridge


def test_bridge_handler_sequence_matches_jax():
    num_envs, unroll_length, overlap = 6, 3, 1
    jagent, params, tagent, jbridge, tbridge = _both_bridges(
        num_envs, unroll_length, overlap)
    # The port hands each batch's kept timesteps and restarted envs to
    # on_timesteps; JAX tells of restarts through on_unroll_lost.
    calls = []
    tbridge.on_timesteps = lambda *args: calls.append(args)
    restarts = []
    for step, (ids, run_ids, rows) in enumerate(
            _handler_batches(num_envs, 24, seed=5)):
        jax_restarts = []
        jbridge.on_unroll_lost = lambda r: jax_restarts.extend(
            np.asarray(r).tolist())
        (got,) = tbridge.handler(ids, (run_ids, rows))
        (want,) = jbridge.handler(ids, (run_ids, JaxEnvOutput(*rows)))
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=f"step {step}")
        kept_ids, kept_rows, restarted = calls[-1]
        keep = jax_actor.get_non_dying_envs(ids, run_ids)
        np.testing.assert_array_equal(kept_ids, ids[keep])
        np.testing.assert_array_equal(kept_rows.reward, rows.reward[keep])
        assert restarted.tolist() == jax_restarts
        restarts += restarted.tolist()
    # The replacement's request won. Each env's first request starts a
    # run (run_ids start at 0); then env 1 restarted, and only env 1.
    assert tbridge.run_ids[1] == 33
    np.testing.assert_array_equal(tbridge.run_ids, jbridge.run_ids)
    assert sorted(restarts[:num_envs]) == list(range(num_envs))
    assert restarts[num_envs:] == [1]
    _assert_leaves(tbridge._agent_states, jbridge._agent_states,
                   exact=False, what="recurrent state")
    np.testing.assert_array_equal(tbridge._prev_actions,
                                  jbridge._prev_actions)
    # Every queued unroll: the same env ids, first states and timesteps.
    assert tbridge.unroll_queue.qsize() == jbridge.unroll_queue.qsize() > 2
    assert tbridge.completed_unrolls == jbridge.completed_unrolls
    while not jbridge.unroll_queue.empty():
        t_ids, t_first, t_unrolls = tbridge.unroll_queue.get_nowait()
        j_ids, j_first, j_unrolls = jbridge.unroll_queue.get_nowait()
        np.testing.assert_array_equal(t_ids, j_ids)
        _assert_leaves(t_first, j_first, exact=False, what="first states")
        _assert_leaves(t_unrolls, j_unrolls, exact=False, what="unrolls")


def test_vtrace_update_on_bridge_batches_matches_jax():
    """The same handler sequence through both bridges, then each one's
    next_unroll_batch through its package's V-trace update."""
    num_envs, unroll_length, batch = 6, 3, 4
    jagent, params, tagent, jbridge, tbridge = _both_bridges(
        num_envs, unroll_length)
    for ids, run_ids, rows in _handler_batches(num_envs, 24, seed=7):
        tbridge.handler(ids, (run_ids, rows))
        jbridge.handler(ids, (run_ids, JaxEnvOutput(*rows)))
    t_ids, tunroll = tbridge.next_unroll_batch(batch, timeout=5,
                                               with_env_ids=True)
    j_ids, junroll = jbridge.next_unroll_batch(batch, timeout=5,
                                               with_env_ids=True)
    np.testing.assert_array_equal(t_ids, j_ids)
    assert tunroll.timesteps.env_output.observation.shape == (
        unroll_length + 1, batch, OBS)
    _assert_leaves(tunroll, junroll, exact=False, what="unroll batch")

    clip, lr = 40.0, 1e-3
    jlearner = jax_vtrace.VTraceLearner(
        JaxRolloutEngine(JaxBatchedEnv(JaxDiscreteMatchEnv(n_actions=4),
                                       batch), jagent, unroll_length),
        jagent, jax_vtrace.VTraceConfig(),
        optax.chain(optax.clip_by_global_norm(clip), optax.adam(lr)))
    jstate = jlearner.init(jax.random.PRNGKey(0))
    jstate = jstate._replace(params=dict(jstate.params, net=params))
    jnew, jmetrics = jax.jit(jlearner.update)(jstate, junroll,
                                              jax.random.PRNGKey(1))

    tlearner = vtrace.VTraceLearner(
        RolloutEngine(BatchedEnv(DiscreteMatchEnv(n_actions=4), batch,
                                 device="cpu"), tagent, unroll_length),
        tagent, vtrace.VTraceConfig(),
        functools.partial(optim.ClippedAdam, learning_rate=lr,
                          clip_norm=clip))
    with torch.no_grad():
        tlearner.entropy_cost.copy_(convert.vtrace_params(
            tagent.net, jax.tree.map(np.asarray, jstate.params))[1])
    tnew, tmetrics = tlearner.update(tlearner.init(), tunroll)
    assert set(tmetrics) == set(jmetrics)
    for k in tmetrics:
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]),
                                   **TOL, err_msg=k)
    want, want_ec = convert.vtrace_params(
        tagent.net, jax.tree.map(np.asarray, jnew.params))
    for name, p in tagent.net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   **TOL, err_msg=name)
    np.testing.assert_allclose(float(tlearner.entropy_cost.detach()),
                               float(want_ec), **TOL)
    assert tnew.step == int(jnew.step) == 1


def test_r2d2_epsilon_by_env_id_matches_jax():
    """Batch rows take the epsilon of their global env id; JAX's draws are
    injected into the port's step."""
    num_envs, batch = 8, 5
    epsilons = np.linspace(0.05, 0.95, num_envs).astype(np.float32)
    jnet = JaxVectorDuelingDQNNet(num_actions=4, mlp_sizes=(16,),
                                  lstm_size=8, hidden_size=8)
    jagent = jax_r2d2.R2D2Agent(jnet, jnp.asarray(epsilons))
    rng = np.random.default_rng(2)
    rows = JaxEnvOutput(
        reward=jnp.asarray(rng.normal(size=batch), jnp.float32),
        done=jnp.asarray(rng.random(batch) < 0.3),
        observation=jnp.asarray(rng.normal(size=(batch, 3)), jnp.float32),
        abandoned=jnp.zeros((batch,), bool),
        episode_step=jnp.zeros((batch,), jnp.int32))
    prev = jnp.asarray(rng.integers(0, 4, batch), jnp.int32)
    params = jagent.init_params(jax.random.PRNGKey(0), prev, rows)
    tnet = VectorDuelingDQNNet(4, 3, mlp_sizes=(16,), lstm_size=8,
                               hidden_size=8, device="cpu")
    tnet.load_state_dict(convert.state_dict_for(
        tnet, jax.tree.map(np.asarray, params)))
    tagent = r2d2.R2D2Agent(tnet, torch.as_tensor(epsilons))
    env_ids = np.array([7, 0, 5, 2, 6])
    state = jagent.initial_state(batch)
    tstate = specs.map_tree(lambda x: torch.tensor(np.asarray(x)), state)
    trows = EnvOutput(*(torch.tensor(np.asarray(x)) for x in rows))
    random_seen = differs = 0
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        jout, jstate = jagent.policy_step(
            params, prev, rows, state, key,
            env_ids=jnp.asarray(env_ids, jnp.int32))
        # JAX's own draws from the key (agents/r2d2.py:policy_step).
        rand_key, pick_key = jax.random.split(key)
        random_actions = np.asarray(jax.random.randint(
            rand_key, (batch,), 0, 4, dtype=jnp.int32))
        uniform = np.asarray(jax.random.uniform(pick_key, (batch,)))
        with torch.no_grad():
            tout, tnew_state = tagent.policy_step(
                torch.tensor(np.asarray(prev)), trows, tstate,
                env_ids=torch.as_tensor(env_ids),
                random_actions=torch.tensor(random_actions),
                uniform=torch.tensor(uniform))
        np.testing.assert_array_equal(tout.action.numpy(),
                                      np.asarray(jout.action))
        np.testing.assert_allclose(tout.q_values.numpy(),
                                   np.asarray(jout.q_values), **TOL)
        _assert_leaves(tnew_state, jstate, exact=False, what="state")
        # Row i by position would take env i's epsilon: the ids matter.
        greedy = tout.q_values.numpy().argmax(-1)
        by_position = np.where(uniform < epsilons[:batch], random_actions,
                               greedy)
        random_seen += int((uniform < epsilons[env_ids]).sum())
        differs += not np.array_equal(by_position, tout.action.numpy())
    assert random_seen > 0 and differs > 0


def test_bridge_acts_on_published_parameters():
    """Parameters change in place (the optimizer's step); the bridge acts
    on what was published. A twin bridge on a copy of the agent as it was
    at the start replays the handler calls bitwise (sampled actions,
    logits, state) until the training agent is published."""
    _, _, agent = _policy_agents()
    _, _, twin_agent = _policy_agents()
    bridge = InferenceBridge(agent, num_envs=6, unroll_length=3,
                             timestep_specs=_timestep_specs(), device="cpu",
                             seed=4)
    twin = InferenceBridge(twin_agent, num_envs=6, unroll_length=3,
                           timestep_specs=_timestep_specs(), device="cpu",
                           seed=4)
    batches = _handler_batches(6, 8, seed=9)

    def call(b, batch):
        ids, run_ids, rows = batch
        return b.handler(ids, (run_ids, rows))[0]

    for batch in batches[:3]:
        np.testing.assert_array_equal(call(bridge, batch),
                                      call(twin, batch))
    with torch.no_grad():  # an optimizer step, not yet published
        for p in agent.net.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator()
                               .manual_seed(1)))
    for batch in batches[3:5]:
        np.testing.assert_array_equal(call(bridge, batch),
                                      call(twin, batch))
    _assert_leaves(bridge._agent_states, twin._agent_states)
    bridge.publish()
    twin_agent.net.load_state_dict(agent.net.state_dict())
    twin.publish()
    for batch in batches[5:]:
        np.testing.assert_array_equal(call(bridge, batch),
                                      call(twin, batch))
    _assert_leaves(bridge._agent_states, twin._agent_states)
    # The training agent's new values reached the bridge's copy.
    for got, want in zip(bridge.behaviour.agent.net.parameters(),
                         agent.net.parameters()):
        assert torch.equal(got, want)


class _ScriptedEnvGroup:
    """Deterministic batched env: the observation counts steps, episodes
    of length 5."""

    def __init__(self, num_envs=2, obs_dim=OBS):
        self.num_envs = num_envs
        self.obs_dim = obs_dim
        self.t = np.zeros(num_envs, np.int32)

    def reset(self):
        self.t[:] = 0
        return self._output(np.zeros(self.num_envs, np.float32))

    def _output(self, reward):
        obs = np.tile(self.t[:, None].astype(np.float32), (1, self.obs_dim))
        done = self.t >= 5
        out = EnvOutput(reward=reward, done=done.copy(), observation=obs,
                        abandoned=np.zeros(self.num_envs, bool),
                        episode_step=self.t.copy())
        self.t[done] = 0
        return out

    def step(self, actions):
        self.t += 1
        return self._output(np.ones(self.num_envs, np.float32))

    def close(self):
        pass


def _bridge_and_server(num_envs, unroll_length, batch_size):
    _, _, agent = _policy_agents()
    bridge = InferenceBridge(agent, num_envs=num_envs,
                             unroll_length=unroll_length,
                             timestep_specs=_timestep_specs(), device="cpu")
    env_output_specs = _timestep_specs()[1]
    server = InferenceServer(
        [bridge.handler], (array_spec((), np.int64), env_output_specs),
        (array_spec((), np.int32),), batch_size=batch_size,
        flush_timeout_ms=100)
    return bridge, server, agent


def test_actor_to_learner_round_trip():
    num_envs, unroll_length = 4, 5
    bridge, server, agent = _bridge_and_server(num_envs, unroll_length, 4)
    client = BridgeClient(server)
    threads = [threading.Thread(
        target=actor_loop, args=(lambda: _ScriptedEnvGroup(2), client),
        kwargs=dict(num_steps=15, env_id_offset=offset))
        for offset in (0, 2)]
    try:
        for t in threads:
            t.start()
        unroll = bridge.next_unroll_batch(batch_size=4, timeout=30)
        _join(threads)
    finally:
        server.shutdown()
    ts = unroll.timesteps
    assert ts.env_output.observation.shape == (unroll_length + 1, 4, OBS)
    # Re-running the policy from the stored first state reproduces the
    # stored outputs of the first unroll.
    (logits, _), _ = agent.unroll(ts.prev_action, ts.env_output,
                                  unroll.agent_state)
    np.testing.assert_allclose(logits.detach().numpy(),
                               ts.agent_output.policy_logits.numpy(), **TOL)


def test_restart_protocol_resets_unroll_store():
    bridge, server, _ = _bridge_and_server(2, 4, 2)
    client = BridgeClient(server)
    try:
        actor_loop(lambda: _ScriptedEnvGroup(2), client, num_steps=3)
        assert bridge.unroll_queue.qsize() == 0
        old_run_ids = bridge.run_ids.copy()
        assert np.all(old_run_ids != 0)
        # A restarted actor (new run_id): its rows reset, so a completion
        # needs unroll_length + 1 appends again.
        actor_loop(lambda: _ScriptedEnvGroup(2), client, num_steps=4)
        assert np.all(bridge.run_ids != old_run_ids)
        assert bridge.unroll_queue.qsize() == 0
        actor_loop(lambda: _ScriptedEnvGroup(2), client, num_steps=5)
        assert bridge.unroll_queue.qsize() >= 1
    finally:
        server.shutdown()


def test_evaluator_prefix_aggregation():
    """Reference eval_utils.py:30-113 bucket-by-prefix semantics."""
    written = {}
    ev = Evaluator(log_episode_frequency=2,
                   summary_writer_fn=lambda k, v: written.__setitem__(k, v))
    ev.add((b"training/", 10, 1.0, 2.0))
    assert ev.process() == {}
    ev.add(("training/", 20, 3.0, 4.0))
    ev.add(("eval_actors/", 5, 10.0, 10.0))
    stats = ev.process()
    assert stats["training/episode_returns"] == 2.0
    assert stats["training/episode_returns_std"] == 1.0
    assert stats["training/episode_num_frames"] == 15.0
    assert stats["training/episode_raw_returns"] == 3.0
    assert "eval_actors/episode_returns" not in stats
    ev.add(("eval_actors/", 7, 20.0, 20.0))
    stats = ev.process()
    assert stats["eval_actors/episode_returns"] == 15.0
    assert written["eval_actors/episode_returns"] == 15.0
    ev.add_many((np.array(["training/", "training/"]), np.array([1, 2]),
                 np.array([1.0, 2.0]), np.array([1.0, 2.0])))
    ev.reset()
    assert ev.process() == {}


def test_add_unroll_add_stats_pending_minimize():
    """PPO's external-actor surface (reference learner.py:908-1121)."""
    _, _, agent = _policy_agents()
    training_iterations = [0]
    ev = Evaluator(log_episode_frequency=1)
    bridge = InferenceBridge(
        agent, num_envs=2, unroll_length=3,
        timestep_specs=array_spec((2,), np.float32),
        store_unrolls_on_inference=False, evaluator=ev,
        virtual_batch_size=2,
        training_iterations_fn=lambda: training_iterations[0], device="cpu")
    client = BridgeClient(None, bridge=bridge)
    assert not client.pending_minimize()
    prev_actions = np.arange(16, dtype=np.int32).reshape(4, 4)
    env_obs = np.arange(32, dtype=np.float32).reshape(4, 4, 2)
    agent_out = np.ones((4, 4), np.float32)
    client.add_unroll((), (prev_actions, env_obs, agent_out))
    assert bridge.completed_unrolls == 4
    assert client.pending_minimize()  # 4 unrolls / 2 = 2 batches pending
    training_iterations[0] = 2
    assert not client.pending_minimize()
    unroll = bridge.next_unroll_batch(batch_size=4, timeout=5)
    np.testing.assert_array_equal(
        unroll.timesteps.env_output[:, 0].numpy(), env_obs[0])
    np.testing.assert_array_equal(
        unroll.timesteps.prev_action[:, 2].numpy(), prev_actions[2])
    client.add_stats(("training/", 11, 5.0, 5.0))
    assert ev.process()["training/episode_returns"] == 5.0


def test_store_unrolls_on_inference_off():
    """With storage off the handler returns actions and queues nothing."""
    _, _, agent = _policy_agents()
    bridge = InferenceBridge(agent, num_envs=2, unroll_length=2,
                             timestep_specs=_timestep_specs(),
                             store_unrolls_on_inference=False, device="cpu")
    rows = _ScriptedEnvGroup(2).reset()
    for _ in range(9):
        (actions,) = bridge.handler(np.array([0, 1]),
                                    (np.array([7, 7], np.int64), rows))
        assert actions.shape == (2,)
    assert bridge.unroll_queue.qsize() == 0
    assert bridge.completed_unrolls == 0


def test_actor_loop_concurrent_calls_and_per_thread_clients():
    """Concurrent per-env calls: actions land on the right envs, each pool
    thread gets its own client, and the serial loop gives the same."""
    made = []

    class _EchoClient:
        def __init__(self):
            made.append(self)
            self.calls = 0

        def inference(self, env_id, run_id, row, raw_reward):
            self.calls += 1
            return np.int64(env_id)

        def close(self):
            self.closed = True

    class _RecordingEnv(_ScriptedEnvGroup):
        def __init__(self, num_envs):
            super().__init__(num_envs=num_envs)
            self.received = []

        def step(self, actions):
            self.received.append(np.asarray(actions).copy())
            return super().step(actions)

    n = 8
    env = _RecordingEnv(n)
    assert actor_loop(lambda: env, client=None, num_steps=3,
                      env_id_offset=100, client_factory=_EchoClient) == 3
    for actions in env.received:
        np.testing.assert_array_equal(actions, 100 + np.arange(n))
    assert 1 <= len(made) <= n
    assert sum(c.calls for c in made) == 3 * n
    assert all(c.closed for c in made)
    env2 = _RecordingEnv(n)
    shared = _EchoClient()
    assert actor_loop(lambda: env2, client=shared, num_steps=2,
                      env_id_offset=100, inference_threads=0) == 2
    for actions in env2.received:
        np.testing.assert_array_equal(actions, 100 + np.arange(n))


def test_actor_run_ids_are_fresh_per_life():
    """Each life of an env group draws its own run_id from an unseeded
    generator: a fixed numpy seed does not repeat it."""
    seen = []

    class _Client:
        def inference(self, env_id, run_id, row, raw_reward):
            seen.append(int(run_id))
            return np.int32(0)

    for _ in range(2):
        np.random.seed(0)
        actor_loop(lambda: _ScriptedEnvGroup(1), _Client(), num_steps=1)
    assert len(seen) == 2 and seen[0] != seen[1] and min(seen) > 0


def test_exporting_timer_windows_and_flush():
    exported = []
    timer = ExportingTimer("t", 3, lambda name, avg: exported.append(
        (name, avg)))
    for _ in range(7):
        with timer:
            pass
    assert len(exported) == 2  # two complete windows of 3
    assert all(name == "t" and avg >= 0 for name, avg in exported)
    assert timer.last_average == exported[-1][1]
    timer.flush()  # the partial window of 1
    assert len(exported) == 3
    timer.flush()  # nothing measured since
    assert len(exported) == 3


@pytest.mark.parametrize("stage", [
    InferenceReturn.INSTANTLY, InferenceReturn.BEFORE_INFERENCE,
    InferenceReturn.AFTER_INFERENCE, InferenceReturn.AFTER_UNROLL, None,
])
def test_inference_bridge_profile_stages(stage):
    _, _, agent = _policy_agents()
    bridge = InferenceBridge(agent, num_envs=4, unroll_length=3,
                             timestep_specs=_timestep_specs(),
                             profile_inference_return=stage, device="cpu")
    rows = _ScriptedEnvGroup(4).reset()
    for _ in range(4):  # enough steps to complete an unroll at END
        (actions,) = bridge.handler(np.arange(4),
                                    (np.ones((4,), np.int64), rows))
        assert actions.shape == (4,)
    assert bridge.unroll_queue.empty() == (stage is not None)
    assert (bridge.handler_batches == 4) == (stage is None)


def test_behaviour_copy_takes_the_observation_statistics():
    """``normalizer.init`` gives sum, sumsq, mean and std one zero tensor;
    a copy refreshed in place would hold the std in all four. The copy
    takes the published statistics whole (SAC and V-trace normalize
    observations on the host and remote paths)."""
    from seed_rl_torch.agents import sac
    from seed_rl_torch.models import ActorCriticMLP
    from seed_rl_torch.rollout_host import BehaviourPolicy

    dist = tpd.NormalTanhDistribution(2)
    agent = sac.SACAgent(ActorCriticMLP(dist.param_size,
                                        array_spec((3,), np.float32),
                                        mlp_sizes=(8,), device="cpu"),
                         dist, 3)
    copy = BehaviourPolicy(agent)
    agent.update_observation_normalization(
        torch.arange(12, dtype=torch.float32).reshape(4, 3))
    copy.publish(agent)
    copy.refresh()
    for got, want in zip(copy.agent.obs_norm, agent.obs_norm):
        assert torch.equal(got, want)
    assert not torch.equal(copy.agent.obs_norm.sum, copy.agent.obs_norm.std)
    # A later fold in the training agent leaves the copy's alone.
    agent.update_observation_normalization(torch.ones(2, 3))
    assert float(copy.agent.obs_norm.steps) == 4.0
