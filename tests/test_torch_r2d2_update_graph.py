"""R2D2's batch update as one CUDA graph (``R2D2Update.optimize``,
``seed_rl_torch/agents/r2d2.py``).

On the CPU the graph path's own logic runs with a stand-in for the graph
(``graph_fakes.DirectCall``, whose replay writes the gradients among its
results into the captured outputs), held equal to the eager update: the
priorities, the loss, each batch's own gradients and the parameters after
Adam; the target net's and loaded weights reaching the next replay; the
captures and the spans. An update under an active mesh reduction never
captures. What the update shares with every graphed body (the CPU, a
refused capture, running out of memory) is held in
``tests/test_torch_cuda_graph.py``.

The tests marked ``cuda`` hold the real graph against the eager update on
the card, bit for bit, for ``R2D2Learner`` and ``R2D2HostLearner``; they
skip where torch sees no CUDA device. This file imports no JAX:

    python -m pytest tests/test_torch_r2d2_update_graph.py -m cuda -q
"""

import functools

import pytest
import torch
import torch.utils._pytree as pytree

from seed_rl_torch import bench, optim
from seed_rl_torch.agents import r2d2
from seed_rl_torch.envs import BatchedEnv
from seed_rl_torch.envs.synthetic import SyntheticAtariEnv
from seed_rl_torch.models import DuelingLSTMDQNNet
from seed_rl_torch.ops.cuda import nstep_kernel, run_count
from seed_rl_torch.parallel import collectives
from seed_rl_torch.rollout import RolloutEngine
from seed_rl_torch.utils import profiling
from graph_fakes import DirectCall, graphed

CPU = torch.device("cpu")
BATCHES = 4


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


class OneRankMesh:
    """A mesh whose reductions are active and, over its one rank, the
    identity."""

    collective = True

    def sum(self, x):
        return x

    def average_(self, tensors):
        pass


# A small DuelingLSTMDQNNet over 36 x 36 frames, with a burn-in.
def _learner(device, seed=11, learning_rate=1e-3):
    num_envs = 5
    env = BatchedEnv(SyntheticAtariEnv(frame_shape=(36, 36),
                                       episode_length=7),
                     num_envs, device=device, seed=seed)
    net = DuelingLSTMDQNNet(18, (36, 36), lstm_size=16, seed=0,
                            device=device)
    agent = r2d2.R2D2Agent(net, r2d2.training_env_epsilons(num_envs, device))
    engine = RolloutEngine(env, agent, 5, num_overlapping_steps=2,
                           seed=seed + 1)
    config = r2d2.R2D2Config(
        n_steps=3, burn_in=2, replay_buffer_size=16,
        replay_buffer_min_size=10, batch_size=4,
        update_target_every_n_step=1000)
    return r2d2.R2D2Learner(
        engine, agent, config,
        functools.partial(optim.ClippedAdam, learning_rate=learning_rate,
                          clip_norm=40.0), seed=seed + 2)


def _host_learner(device, like):
    """An ``R2D2HostLearner`` over a net built as ``like``'s."""
    net = DuelingLSTMDQNNet(18, (36, 36), lstm_size=16, seed=0,
                            device=device)
    agent = r2d2.R2D2Agent(net, like.agent.epsilons)
    return r2d2.R2D2HostLearner(
        agent, like.config,
        functools.partial(optim.ClippedAdam, learning_rate=1e-3,
                          clip_norm=40.0), like.num_envs, 5)


def _graphed(learner, graph_class=DirectCall):
    return graphed(learner, graph_class, params=learner.parameters())


def _batches(source, n=BATCHES, batch=None):
    """``n`` batches (items, weights) sampled from ``source``'s filled
    replay, of ``batch`` items each (the config's by default)."""
    state = bench.warm_replay(source)
    out = []
    for _ in range(n):
        _, weights, items = source.replay.sample(
            state.replay, source.generator, batch or source.config.batch_size,
            source.config.priority_exponent)
        out.append((items, weights))
    return out


def _run(learner, batches, between=None):
    """Each batch through ``learner.optimize``; ``between(k)`` runs before
    batch k > 0. Returns per batch the priorities, the logs, the
    gradients Adam stepped with and the parameters after."""
    out = []
    for k, (items, weights) in enumerate(batches):
        if between is not None and k:
            between(k)
        priorities, logs = learner.optimize(items, weights)
        params = learner.parameters()
        out.append((priorities, logs,
                    [None if p.grad is None else p.grad.clone()
                     for p in params],
                    [p.detach().clone() for p in params]))
    return out


def _assert_trees_equal(a, b):
    leaves_a, spec_a = pytree.tree_flatten(a)
    leaves_b, spec_b = pytree.tree_flatten(b)
    assert spec_a == spec_b
    for x, y in zip(leaves_a, leaves_b):
        if x is None or y is None:
            assert x is y
            continue
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


LEARNERS = {
    "learner": lambda device, source: _learner(device),
    "host": _host_learner,
}


@pytest.mark.parametrize("kind", sorted(LEARNERS))
def test_graphed_batches_are_the_eager_ones(kind):
    source = _learner(CPU)
    batches = _batches(source)
    eager = LEARNERS[kind](CPU, source)
    graphed = _graphed(LEARNERS[kind](CPU, source))
    want = _run(eager, batches)
    got = _run(graphed, batches)
    for g, w in zip(got, want):
        _assert_trees_equal(g, w)
    # The loss moved the parameters, and every leaf had a gradient.
    assert not torch.equal(got[-1][3][0], got[0][3][0])
    assert all(g is not None for g in got[-1][2])
    # Eager first, captured on the second batch, replayed from then on.
    assert graphed.captures == 1
    assert graphed.graph_replays == BATCHES - 1
    assert graphed.capture_failures == 0


def test_each_replay_s_gradients_are_its_batch_s_alone():
    # With the parameters held still, one batch given again gives the same
    # gradients: a replay's are not added to the previous batch's.
    source = _learner(CPU)
    (items, weights), = _batches(source, 1)
    graphed = _graphed(_learner(CPU, learning_rate=0.0))
    got = _run(graphed, [(items, weights)] * BATCHES)
    for g in got[1:]:
        _assert_trees_equal(g, got[0])
    assert graphed.graph_replays == BATCHES - 1


def _loaded(learner):
    """``load_checkpoint_state`` with both nets' weights moved, before
    batch 3; ``sync_target`` and cleared gradients before batch 2."""
    state = learner.init()
    torch.manual_seed(3)
    tree = learner.checkpoint_state(state)
    for net in ("params", "target_params"):
        tree[net]["net"] = {n: t + 0.01 * torch.randn_like(t)
                            for n, t in tree[net]["net"].items()}

    def between(k):
        if k == 2:
            learner.sync_target()
            # Gradients cleared after a step reach Adam all the same.
            learner.optimizer.zero_grad()
        if k == 3:
            learner.load_checkpoint_state(state, tree)
    return between


def test_a_synced_target_and_loaded_weights_reach_the_next_replay():
    source = _learner(CPU)
    batches = _batches(source)
    eager, graphed = _learner(CPU), _graphed(_learner(CPU))
    want = _run(eager, batches, between=_loaded(eager))
    got = _run(graphed, batches, between=_loaded(graphed))
    for g, w in zip(got, want):
        _assert_trees_equal(g, w)
    # Written in place: the capture still fits.
    assert graphed.captures == 1
    assert graphed.graph_replays == BATCHES - 1


def test_a_changed_batch_shape_captures_again():
    source = _learner(CPU)
    batches = _batches(source, 3) + _batches(source, 3, batch=2)
    eager, graphed = _learner(CPU), _graphed(_learner(CPU))
    want = _run(eager, batches)
    got = _run(graphed, batches)
    for g, w in zip(got, want):
        _assert_trees_equal(g, w)
    # Eager, captured, replayed at 4 items; the same again at 2.
    assert graphed.captures == 2
    assert graphed.graph_replays == 4


def test_a_rebound_target_tensor_captures_again():
    """The seam's one rule for a tensor rebound since the capture: its
    values are copied into the captured one, and the graph is kept."""
    source = _learner(CPU)
    batches = _batches(source, 5)

    def rebind(learner):
        def between(k):
            if k == 2:
                target = learner.target_net
                target.load_state_dict(
                    {n: t + 0.01 for n, t in target.state_dict().items()},
                    assign=True)
        return between

    eager, graphed = _learner(CPU), _graphed(_learner(CPU))
    want = _run(eager, batches, between=rebind(eager))
    got = _run(graphed, batches, between=rebind(graphed))
    for g, w in zip(got, want):
        _assert_trees_equal(g, w)
    # Captured on batch 2; on batch 3 the new target's values are copied
    # into the captured tensors, and batches 3 to 5 replay.
    assert graphed.captures == 1
    assert graphed.graph_replays == 4


def test_an_active_mesh_reduction_never_captures():
    source = _learner(CPU)
    batches = _batches(source)
    on_cpu = _learner(CPU)
    meshed = _graphed(_learner(CPU))
    with collectives.over(OneRankMesh()):
        want = _run(on_cpu, batches)
        got = _run(meshed, batches)
    for g, w in zip(got, want):
        _assert_trees_equal(g, w)
    assert meshed.captures == 0
    assert meshed.graph_replays == 0
    assert meshed._graph is None


def test_the_graph_path_s_spans(monkeypatch):
    source = _learner(CPU)
    batches = _batches(source, 3)
    learner = _graphed(_learner(CPU))
    names = []
    real = profiling.record_function

    def spy(name, args=None):
        short = name[len(profiling.PREFIX):]
        if short.startswith("update"):
            names[-1].append(short)
        return real(name, args)

    monkeypatch.setattr(profiling, "record_function", spy)
    with profiling.recording():
        for items, weights in batches:
            names.append([])
            learner.optimize(items, weights)
    body = ["update.loss", "update.burn_in", "update.backward"]
    eager, captured, replayed = names
    assert eager == body + ["update.optimizer"]
    # The capture runs the body's spans once; a replay records none.
    assert captured == (["update.capture"] + body
                        + ["update.graph_replay", "update.optimizer"])
    assert replayed == ["update.graph_replay", "update.optimizer"]


# -- on the card --------------------------------------------------------------

# The benchmark's net at full width: over a few envs and a small batch, and
# at the shapes of the cell ``r2d2_atari.ratio010`` (batch 64, unroll 80,
# burn-in 40) over fewer envs.
CARD_SHAPES = {
    "small": dict(num_envs=16, unroll=10, burn_in=4, replay_buffer_size=16,
                  batch_size=4),
    "cell": dict(num_envs=64, unroll=80, burn_in=40, replay_buffer_size=128,
                 batch_size=64),
}


def _card_learner(device, shape):
    return bench.r2d2_atari_learner(device, **CARD_SHAPES[shape])


def _card_host_learner(device, like):
    net = DuelingLSTMDQNNet(18, dtype=torch.bfloat16,
                            core_dtype=torch.bfloat16, seed=0, device=device)
    return r2d2.R2D2HostLearner(
        r2d2.R2D2Agent(net, like.agent.epsilons), like.config,
        functools.partial(optim.ClippedAdam, learning_rate=1e-4,
                          clip_norm=80.0), like.num_envs,
        like.engine.unroll_length)


CARD_LEARNERS = {
    "learner": lambda device, source, shape: _card_learner(device, shape),
    "host": lambda device, source, shape: _card_host_learner(device, source),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
@pytest.mark.parametrize("kind", sorted(CARD_LEARNERS))
def test_graphed_batches_are_the_eager_ones_on_the_card(cuda, kind, shape):
    source = _card_learner(cuda, shape)
    batches = _batches(source)
    eager = CARD_LEARNERS[kind](cuda, source, shape)
    eager._graph_class = None
    graphed = CARD_LEARNERS[kind](cuda, source, shape)

    def sync(learner):
        def between(k):
            if k == 3:
                learner.sync_target()
        return between

    want = _run(eager, batches, between=sync(eager))
    run_count.reset()
    got = _run(graphed, batches, between=sync(graphed))
    # B2 ran once a batch, counted on the card: eagerly, then in each
    # replay.
    assert run_count.read(nstep_kernel.KERNEL_NAME) == BATCHES
    assert graphed.captures == 1
    assert graphed.graph_replays == BATCHES - 1
    assert graphed.capture_failures == 0
    for g, w in zip(got, want):
        _assert_trees_equal(g, w)
    assert not torch.equal(got[-1][3][0], got[0][3][0])
