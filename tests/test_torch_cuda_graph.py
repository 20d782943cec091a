"""What every graphed body shares through ``seed_rl_torch/cuda_graph.py``,
held once for both of its users: ``RolloutEngine``'s rollout and R2D2's
batch update (``R2D2Update.optimize``).

On the CPU nothing is captured; with a stand-in for the graph
(``graph_fakes``), a capture that CUDA refuses leaves the body eager for
good, with one warning, and running out of memory in a capture raises, for
both kinds of error. Each user's own graph path is held in
``tests/test_torch_rollout_graph.py`` and
``tests/test_torch_r2d2_update_graph.py``. This file imports no JAX.
"""

import functools
from typing import Callable, NamedTuple

import pytest
import torch

import test_torch_r2d2_update_graph as update_graph
import test_torch_rollout_graph as rollout_graph
from graph_fakes import OutOfMemory, Refusing

CPU = torch.device("cpu")
CALLS = 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread (see tests/test_torch_ppo.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class User(NamedTuple):
    """A user of the seam on the CPU: ``make()`` builds it, ``run(owner,
    n)`` returns its outputs over ``n`` calls (rollouts from a fresh
    ``init``; the update on its first ``n`` batches), and
    ``graphed(owner, graph_class)`` gives it a stand-in for the graph."""

    make: Callable
    run: Callable
    graphed: Callable


def _rollout(agent):
    return User(lambda: rollout_graph.ENGINES[agent](CPU),
                lambda engine, n: rollout_graph._rollouts(engine, n)[0],
                rollout_graph._graphed)


def _update():
    batches = update_graph._batches(update_graph._learner(CPU), CALLS)
    return User(lambda: update_graph._learner(CPU),
                lambda learner, n: update_graph._run(learner, batches[:n]),
                update_graph._graphed)


USERS = {"rollout": lambda: _rollout("r2d2"), "update": _update}
ON_THE_CPU = {"rollout-vtrace": lambda: _rollout("vtrace"),
              "rollout-r2d2": lambda: _rollout("r2d2"),
              "update": _update}


def _assert_outputs_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        update_graph._assert_trees_equal(g, w)


@pytest.mark.parametrize("user", sorted(ON_THE_CPU))
def test_nothing_on_the_cpu_is_captured(user):
    user = ON_THE_CPU[user]()
    owner = user.make()
    assert owner._graph_class is None
    user.run(owner, 3)
    assert owner.captures == 0
    assert owner.graph_replays == 0
    assert owner._graph is None


@pytest.mark.parametrize("user", sorted(USERS))
def test_a_refused_capture_leaves_the_body_eager(user):
    user = USERS[user]()
    owner = user.graphed(user.make(), Refusing)
    with pytest.warns(RuntimeWarning, match="runs eagerly") as warned:
        got = user.run(owner, CALLS)
    assert len([w for w in warned if "runs eagerly" in str(w.message)]) == 1
    _assert_outputs_equal(got, user.run(user.make(), CALLS))
    assert owner.capture_failures == 1
    assert owner.captures == 0
    assert owner.graph_replays == 0
    assert owner._graph_class is None


@pytest.mark.parametrize("error", [
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 56 MiB"),
    RuntimeError("CUDA error: out of memory"),
], ids=["allocator", "cuda"])
@pytest.mark.parametrize("user", sorted(USERS))
def test_running_out_of_memory_in_a_capture_raises(user, error):
    user = USERS[user]()
    owner = user.graphed(user.make(),
                         functools.partial(OutOfMemory, error=error))
    user.run(owner, 1)
    with pytest.raises(RuntimeError, match="previous error") as raised:
        user.run(owner, 1)
    assert raised.value.__context__ is error
    assert owner.capture_failures == 0
    assert owner.captures == 0
    assert owner._graph_class is not None
