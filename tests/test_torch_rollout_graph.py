"""The rollout as one CUDA graph (``seed_rl_torch/rollout.py``).

On the CPU the graph path's own logic runs with a stand-in for the graph
(``graph_fakes.DirectCall``), held equal to the eager loop: the static
inputs, the clones handed out, the agent's rebound tensors, the counters
and the spans. What the rollout shares with every graphed body (the CPU,
a refused capture, running out of memory) is held in
``tests/test_torch_cuda_graph.py``.

The tests marked ``cuda`` hold the real graph against the eager loop on
the card; they skip where torch sees no CUDA device. This file imports no
JAX:

    python -m pytest tests/test_torch_rollout_graph.py -m cuda -q
"""

import pytest
import torch
import torch.utils._pytree as pytree

from seed_rl_torch import bench
from seed_rl_torch import distributions as pd
from seed_rl_torch.agent import NormalizingObservationsAgent, PolicyAgent
from seed_rl_torch.agents import r2d2
from seed_rl_torch.envs import BatchedEnv, ToyEnv
from seed_rl_torch.envs.synthetic import SyntheticAtariEnv, SyntheticDmLabEnv
from seed_rl_torch.models import DuelingLSTMDQNNet, ImpalaDeep, MLPAndLSTM
from seed_rl_torch.ops import normalizer
from seed_rl_torch.rollout import RolloutEngine
from seed_rl_torch.utils import profiling
from graph_fakes import graphed as _graphed

CPU = torch.device("cpu")
ROLLOUTS = 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread (see tests/test_torch_ppo.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# Small widths of the benchmark's two agents: V-trace over ImpalaDeep with no
# overlap, R2D2 over DuelingLSTMDQNNet with a burn-in overlap and eval envs.
def _vtrace(device, seed=7, num_envs=3, unroll=4):
    env = BatchedEnv(SyntheticDmLabEnv(frame_shape=(12, 16),
                                       episode_length=6),
                     num_envs, device=device, seed=seed)
    net = ImpalaDeep(9, (12, 16, 3), lstm_size=16, seed=0, device=device)
    agent = PolicyAgent(net, pd.CategoricalDistribution(9))
    return RolloutEngine(env, agent, unroll, seed=seed + 1)


def _r2d2(device, seed=11, num_envs=4, unroll=5, burn_in=2):
    env = BatchedEnv(SyntheticAtariEnv(frame_shape=(36, 36),
                                       episode_length=7),
                     num_envs, device=device, seed=seed)
    net = DuelingLSTMDQNNet(18, (36, 36), lstm_size=16, seed=0,
                            device=device)
    epsilons = torch.cat([r2d2.training_env_epsilons(num_envs - 1, device),
                          torch.full((1,), 0.5, device=device)])
    agent = r2d2.R2D2Agent(net, epsilons)
    return RolloutEngine(env, agent, unroll, num_overlapping_steps=burn_in,
                         seed=seed + 1)


def _normalizing(device, seed=5):
    env = BatchedEnv(ToyEnv(), 3, device=device, seed=seed)
    dist = pd.get_parametric_distribution_for_action_space(env.action_space)
    width = env.observation_spec().shape[0]
    net = MLPAndLSTM(dist.param_size, width, (8,), (8,), seed=0,
                     device=device)
    agent = NormalizingObservationsAgent(PolicyAgent(net, dist), width)
    return RolloutEngine(env, agent, 3, seed=seed + 1)


ENGINES = {"vtrace": _vtrace, "r2d2": _r2d2}


def _rollouts(engine, n=ROLLOUTS, between=None):
    """``n`` rollouts from ``engine.init()``; ``between(k)`` runs before
    rollout k > 0. Returns the unrolls and the last state."""
    state, unrolls = engine.init(), []
    for k in range(n):
        if between is not None and k:
            between(k)
        state, unroll = engine.rollout(state)
        unrolls.append(unroll)
    return unrolls, state


def _assert_trees_equal(a, b):
    leaves_a, spec_a = pytree.tree_flatten(a)
    leaves_b, spec_b = pytree.tree_flatten(b)
    assert spec_a == spec_b
    for x, y in zip(leaves_a, leaves_b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _next_draws(engine):
    return (torch.rand(8, generator=engine.generator,
                       device=engine.device),
            torch.rand(8, generator=engine.env.generator,
                       device=engine.device))


@pytest.mark.parametrize("agent", sorted(ENGINES))
def test_the_graph_path_gives_the_eager_loop_s_unrolls(agent):
    make = ENGINES[agent]
    eager = make(CPU)
    graphed = _graphed(make(CPU))
    want, want_state = _rollouts(eager)
    got, got_state = _rollouts(graphed)
    for g, w in zip(got, want):
        _assert_trees_equal(g, w)
    _assert_trees_equal(got_state, want_state)
    # Each generator left where the eager loop leaves it.
    _assert_trees_equal(_next_draws(graphed), _next_draws(eager))
    # Eager first, captured on the second call, replayed from then on.
    assert graphed.captures == 1
    assert graphed.graph_replays == ROLLOUTS - 1
    assert graphed.capture_failures == 0


# One step past the overlap (V-trace's unroll of 1, R2D2's burn-in of
# unroll - 1): the state the next unroll stores is taken at the rollout's
# first step, where the agent state is still the graph's static input.
FIRST_STEP_STORES = {
    "vtrace_unroll_1": lambda device: _vtrace(device, unroll=1),
    "r2d2_burn_in_unroll_minus_1": lambda device: _r2d2(device, unroll=3,
                                                        burn_in=2),
}


@pytest.mark.parametrize("agent", sorted(FIRST_STEP_STORES))
def test_a_state_stored_at_the_first_step_is_the_eager_loop_s(agent):
    make = FIRST_STEP_STORES[agent]
    want, want_state = _rollouts(make(CPU), 6)
    got, got_state = _rollouts(_graphed(make(CPU)), 6)
    for g, w in zip(got, want):
        _assert_trees_equal(g, w)
    _assert_trees_equal(got_state, want_state)
    # The stored states differ from unroll to unroll.
    assert not torch.equal(pytree.tree_leaves(want[-1].agent_state)[0],
                           pytree.tree_leaves(want[-2].agent_state)[0])


@pytest.mark.parametrize("agent", sorted(ENGINES))
def test_kept_unrolls_are_the_caller_s_own(agent):
    # The benchmark's check keeps the first three unrolls by reference and
    # reads them after the third step: a static buffer handed out would
    # make every kept unroll the last.
    make = ENGINES[agent]
    got, _ = _rollouts(_graphed(make(CPU)), 3)
    want, _ = _rollouts(make(CPU), 3)
    for g, w in zip(got, want):
        _assert_trees_equal(g, w)
    frames = [u.timesteps.env_output.observation for u in got]
    logits = [pytree.tree_leaves(u.timesteps.agent_output)[-1] for u in got]
    for i in range(3):
        for j in range(i):
            assert (frames[i].untyped_storage().data_ptr()
                    != frames[j].untyped_storage().data_ptr())
            assert not torch.equal(frames[i], frames[j])
            assert not torch.equal(logits[i], logits[j])


def _span_names(monkeypatch, engine, n):
    """The spans of ``n`` rollouts after ``engine.init()``, one list a
    rollout."""
    names = []
    real = profiling.record_function

    def spy(name, args=None):
        names[-1].append(name[len(profiling.PREFIX):])
        return real(name, args)

    monkeypatch.setattr(profiling, "record_function", spy)
    state = engine.init()
    with profiling.recording():
        for _ in range(n):
            names.append([])
            state, _ = engine.rollout(state)
    return names


def test_the_eager_loop_s_spans_are_unchanged(monkeypatch):
    engine = _vtrace(CPU)
    step = ["rollout.policy_step", "torso", "rollout.env_step"]
    for names in _span_names(monkeypatch, engine, 2):
        assert names == ["rollout"] + step * engine.unroll_length


def test_the_graph_path_s_spans(monkeypatch):
    engine = _graphed(_vtrace(CPU))
    step = ["rollout.policy_step", "torso", "rollout.env_step"]
    eager, captured, replayed = _span_names(monkeypatch, engine, 3)
    assert eager == ["rollout"] + step * engine.unroll_length
    # The capture runs the body's spans once; a replay records none.
    assert captured == (["rollout", "rollout.capture"]
                        + step * engine.unroll_length
                        + ["rollout.graph_replay"])
    assert replayed == ["rollout", "rollout.graph_replay"]


def _fold(engine, at=None):
    """Rebinds ``engine``'s ``obs_norm`` to new statistics before rollout
    k (every k, or ``at``), as the V-trace learner's step does."""
    def between(k):
        if at is None or k == at:
            agent = engine.agent
            agent.obs_norm = normalizer.update(
                agent.obs_norm,
                torch.full((2, 4), float(k), device=engine.device))
    return between


def _both(*folds):
    def between(k):
        for fold in folds:
            fold(k)
    return between


def test_rebound_statistics_are_copied_into_the_captured_ones():
    eager, graphed = _normalizing(CPU), _graphed(_normalizing(CPU))
    captured = []
    fold = _fold(graphed)

    def between(k):
        if k == 2:  # the statistics of the capture, on call 2
            captured.append(graphed.agent.obs_norm)
        fold(k)

    want, _ = _rollouts(eager, between=_fold(eager))
    got, _ = _rollouts(graphed, between=between)
    for g, w in zip(got, want):
        _assert_trees_equal(g, w)
    assert graphed.captures == 1
    assert graphed.graph_replays == ROLLOUTS - 1
    # They hold the last fold's values, in their own memory.
    now = graphed.agent.obs_norm
    _assert_trees_equal(captured[0], now)
    assert captured[0].mean.data_ptr() != now.mean.data_ptr()


def test_statistics_captured_as_one_tensor_are_captured_again():
    # ``normalizer.init`` makes sum, sumsq, mean and std one tensor of
    # zeros: a fold gives them four, which one captured tensor cannot hold.
    eager, graphed = _normalizing(CPU), _graphed(_normalizing(CPU))
    want, _ = _rollouts(eager, 5, between=_fold(eager, at=2))
    got, _ = _rollouts(graphed, 5, between=_fold(graphed, at=2))
    for g, w in zip(got, want):
        _assert_trees_equal(g, w)
    # Captured on call 2; on call 3 the graph no longer fits: eager, then
    # captured again on call 4 and replayed on call 5.
    assert graphed.captures == 2
    assert graphed.graph_replays == 3


def test_a_rebound_tensor_still_in_use_is_captured_again():
    def make():
        engine = _normalizing(CPU)
        engine.agent.kept = normalizer.update(
            normalizer.init(4), torch.full((2, 4), 3.0))
        return engine

    def swap(engine):
        def between(k):
            if k == 2:
                agent = engine.agent
                # The captured statistics stay in the agent: a copy into
                # them would change what it holds.
                agent.kept, agent.obs_norm = agent.obs_norm, agent.kept
        return between

    eager, graphed = make(), _graphed(make())
    want, _ = _rollouts(eager, 5, between=_both(_fold(eager, at=1),
                                                swap(eager)))
    got, _ = _rollouts(graphed, 5, between=_both(_fold(graphed, at=1),
                                                 swap(graphed)))
    for g, w in zip(got, want):
        _assert_trees_equal(g, w)
    assert graphed.captures == 2
    assert graphed.graph_replays == 3


# -- on the card --------------------------------------------------------------

CARD_LEARNERS = {
    "vtrace": lambda device: bench.dmlab_vtrace_learner(
        device, num_envs=16, unroll_length=8),
    "r2d2": lambda device: bench.r2d2_atari_learner(
        device, num_envs=16, unroll=10, burn_in=4, replay_buffer_size=16,
        batch_size=4),
}


def _card_engines(name, device):
    """The benchmark's nets at full width over a few envs: an eager engine
    and a graphed one, built alike."""
    eager = CARD_LEARNERS[name](device).engine
    eager._graph_class = None
    return eager, CARD_LEARNERS[name](device).engine


@pytest.mark.cuda
@pytest.mark.parametrize("agent", sorted(CARD_LEARNERS))
def test_graphed_rollouts_are_the_eager_loop_s_on_the_card(cuda, agent):
    eager, graphed = _card_engines(agent, cuda)
    want, want_state = _rollouts(eager)
    got, got_state = _rollouts(graphed)
    assert graphed.captures == 1
    assert graphed.graph_replays == ROLLOUTS - 1
    for g, w in zip(got, want):
        ts_g, ts_w = g.timesteps, w.timesteps
        # The draws and what the envs made of them: bit for bit.
        _assert_trees_equal(ts_g.prev_action, ts_w.prev_action)
        _assert_trees_equal(ts_g.env_output, ts_w.env_output)
        # The same kernels: the same outputs and carried state.
        _assert_trees_equal(ts_g.agent_output, ts_w.agent_output)
        _assert_trees_equal(g.agent_state, w.agent_state)
    _assert_trees_equal(got_state, want_state)
    _assert_trees_equal(_next_draws(graphed), _next_draws(eager))


@pytest.mark.cuda
def test_new_weights_reach_the_replay_on_the_card(cuda):
    eager, graphed = _card_engines("vtrace", cuda)
    torch.manual_seed(0)
    weights = {n: t + 0.01 * torch.randn_like(t)
               for n, t in eager.agent.net.state_dict().items()}

    def between(engine):
        def load(k):
            if k == 2:
                engine.agent.net.load_state_dict(weights)
        return load

    want, _ = _rollouts(eager, between=between(eager))
    got, _ = _rollouts(graphed, between=between(graphed))
    assert graphed.captures == 1
    for g, w in zip(got, want):
        _assert_trees_equal(g, w)


@pytest.mark.cuda
def test_rebound_statistics_reach_the_replay_on_the_card(cuda):
    eager, graphed = _normalizing(cuda), _normalizing(cuda)
    eager._graph_class = None
    want, _ = _rollouts(eager, between=_fold(eager))
    got, _ = _rollouts(graphed, between=_fold(graphed))
    assert graphed.captures == 1
    assert graphed.graph_replays == ROLLOUTS - 1
    for g, w in zip(got, want):
        _assert_trees_equal(g, w)


@pytest.mark.cuda
def test_one_graph_replay_span_a_rollout_on_the_card(cuda, monkeypatch):
    _, graphed = _card_engines("r2d2", cuda)
    names = _span_names(monkeypatch, graphed, ROLLOUTS)
    assert [n.count("rollout.graph_replay") for n in names] == [0] + [1] * (
        ROLLOUTS - 1)
    assert [n.count("rollout.capture") for n in names] == [0, 1] + [0] * (
        ROLLOUTS - 2)
    assert all(n.count("rollout.policy_step") == 0 for n in names[2:])
