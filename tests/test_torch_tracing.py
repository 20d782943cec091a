"""The port's spans (``seed_rl_torch/utils/profiling.py``): off by default
and then nothing at all, on under ``recording()`` with the span tree of a
V-trace and an R2D2 train step, and no change to what a step computes.

The learners are ``seed_rl_torch.bench``'s (bf16 ImpalaDeep and
DuelingLSTMDQNNet on synthetic frames) at a few envs and steps.
"""

import json

import pytest
import torch
import torch.utils._pytree as pytree
from torch.profiler import ProfilerActivity, profile

from seed_rl_torch import bench, train
from seed_rl_torch.utils import profiling

CPU = torch.device("cpu")
T = 3  # unroll length
BURN_IN = 2


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread (see tests/test_torch_ppo.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _vtrace(remat=False):
    learner = bench.dmlab_vtrace_learner(CPU, num_envs=2, unroll_length=T,
                                         remat=remat)
    return learner, learner.init()


def _r2d2():
    learner = bench.r2d2_atari_learner(CPU, num_envs=3, unroll=T + BURN_IN,
                                       burn_in=BURN_IN, replay_buffer_size=8,
                                       batch_size=2)
    return learner, bench.warm_replay(learner)


LEARNERS = {"vtrace": _vtrace, "r2d2": _r2d2}


class _Spy:
    """Stands in for ``profiling.record_function``: keeps each range's
    name and args, and enters the real one."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = profiling.record_function

        def spy(name, args=None):
            self.calls.append((name, args))
            return real(name, args)

        monkeypatch.setattr(profiling, "record_function", spy)


def _tree(prof):
    """The program's spans as nested ``(name, children)`` tuples in start
    order, each under its nearest enclosing program span
    (``cpu_parent``)."""
    events = sorted((e for e in prof.events()
                     if e.name.startswith(profiling.PREFIX)),
                    key=lambda e: e.time_range.start)
    children = {id(e): [] for e in events}
    roots = []
    for e in events:
        parent = e.cpu_parent
        while parent is not None and id(parent) not in children:
            parent = parent.cpu_parent
        (children[id(parent)] if parent is not None else roots).append(e)

    def node(e):
        return (e.name[len(profiling.PREFIX):],
                tuple(node(c) for c in children[id(e)]))

    return tuple(node(e) for e in roots)


def _leaf(name, *children):
    return (name, tuple(children))


def _rollout(steps):
    step = (_leaf("rollout.policy_step", _leaf("torso")),
            _leaf("rollout.env_step"))
    return _leaf("rollout", *(step * steps))


def _expected(agent, remat=False):
    if agent == "vtrace":
        backward = (_leaf("torso"),) if remat else ()
        return (_leaf(
            "train_step", _rollout(T),
            _leaf("update",
                  _leaf("update.loss", _leaf("torso")),
                  _leaf("update.backward", *backward),
                  _leaf("update.optimizer"))),)
    # R2D2: both nets' burn-in, then both nets' suffix, a torso each.
    return (_leaf(
        "train_step", _rollout(T + BURN_IN),
        _leaf("replay.priorities"),
        _leaf("replay.insert"),
        _leaf("update",
              _leaf("replay.sample", _leaf("replay.gather")),
              _leaf("update.loss",
                    _leaf("update.burn_in", _leaf("torso"), _leaf("torso")),
                    _leaf("torso"), _leaf("torso")),
              _leaf("update.backward"),
              _leaf("update.optimizer"),
              _leaf("replay.update_priorities"))),)


def test_span_is_one_shared_no_op_while_not_recording():
    assert not profiling._recording
    assert profiling.span("rollout") is profiling.span("update", 3)
    with profiling.span("rollout") as entered:
        assert entered is None
    with profiling.recording():
        assert profiling.span("rollout") is not profiling.span("rollout")
    assert profiling.span("rollout") is profiling.span("torso")


@pytest.mark.parametrize("agent", sorted(LEARNERS))
def test_a_step_enters_no_range_while_not_recording(agent, monkeypatch):
    learner, state = LEARNERS[agent]()
    spy = _Spy(monkeypatch)
    learner.train_many(state, 1)
    assert spy.calls == []


@pytest.mark.parametrize("agent,remat", [("vtrace", False),
                                         ("vtrace", True),
                                         ("r2d2", False)])
def test_a_recorded_step_gives_the_span_tree(agent, remat, monkeypatch):
    learner, state = (_vtrace(remat) if agent == "vtrace"
                      else LEARNERS[agent]())
    step = state.step
    spy = _Spy(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.recording():
            learner.train_step(state)
    assert not profiling._recording
    assert _tree(prof) == _expected(agent, remat)
    # The root carries the learner's step; no other span has args.
    assert spy.calls[0] == ("seed_rl_torch.train_step", str(step))
    assert all(args is None for _, args in spy.calls[1:])


def _outputs(agent, record):
    torch.manual_seed(0)
    learner, state = LEARNERS[agent]()
    if record:
        with profile(activities=[ProfilerActivity.CPU]), \
                profiling.recording():
            state, metrics = learner.train_many(state, 2)
    else:
        state, metrics = learner.train_many(state, 2)
    replay = getattr(state, "replay", None)
    return (metrics, [p.detach() for p in learner.parameters()],
            [] if replay is None else [replay.priorities])


@pytest.mark.parametrize("agent", sorted(LEARNERS))
def test_recording_leaves_every_output_bitwise_as_it_was(agent):
    off, on = _outputs(agent, False), _outputs(agent, True)
    for a, b in zip(pytree.tree_leaves(off), pytree.tree_leaves(on)):
        assert torch.equal(a, b)
    assert len(pytree.tree_leaves(off)) == len(pytree.tree_leaves(on))


def test_profile_run_mode_writes_the_spans_to_its_trace(tmp_path, capsys):
    train.main(["--device=cpu", "--agent=vtrace", "--env=toy",
                "--num_envs=4", "--unroll_length=3", "--steps_per_call=1",
                "--log_every_steps=1", f"--logdir={tmp_path}",
                "--total_environment_frames=24", "--run_mode=profile",
                "--profile_calls=1"])
    capsys.readouterr()
    with open(tmp_path / "profile" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"seed_rl_torch.train_step", "seed_rl_torch.rollout",
            "seed_rl_torch.update.backward"} <= names
    assert not profiling._recording
