"""PPO's action points in seed_rl_torch (``utils/action_points.py`` and
``agents/ppo/learner.py::learner_loop``), mirroring
tests/test_profiling_snapshots.py.

- ``ActionPointSchedule`` fires the same lists as the JAX package's over a
  grid of frame totals, counts and jumping frame sequences (exact: the
  marks are the same float64 linspace).
- ``snapshot_ppo_state`` / ``restore_ppo_state``: CPU copies that share no
  memory with the learner; a fresh learner warm-started from one holds the
  trained variables and keeps its own rollout, and trains on.
- ``learner_loop`` fires checkpoints and saved models at most once a call
  and snapshots once per mark, and exports only with a logdir.
"""

import os

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from seed_rl_tpu.utils.action_points import (
    ActionPointSchedule as JaxActionPointSchedule,
)
from seed_rl_torch import train
from seed_rl_torch.agents.ppo import learner as ppo
from seed_rl_torch.utils import checkpoint as ckpt
from seed_rl_torch.utils.action_points import (
    ActionPointSchedule,
    LearnerState,
    restore_ppo_state,
    snapshot_ppo_state,
)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread (see tests/test_torch_ppo.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frame_sequences(total, seed):
    """Non-decreasing frame counts from 0 past ``total``: even steps, jumps
    across several marks, repeats and a final overshoot."""
    rng = np.random.RandomState(seed)
    even = list(range(0, total + 1, max(1, total // 16)))
    jumps = np.cumsum(rng.randint(0, max(2, total // 3), size=12)).tolist()
    return [even, jumps + [total * 3], [total // 2, total // 2, total,
                                        total]]


@pytest.mark.parametrize("total", [7, 100, 1000, 2_000_000])
@pytest.mark.parametrize("counts", [
    {"checkpoint": 4, "saved_model": 2, "snapshot": 0},
    {"checkpoint": 1, "saved_model": 10, "snapshot": 3},
    {"checkpoint": 0, "saved_model": 0, "snapshot": 0},
    {"snapshot": 13, "checkpoint": 7},
])
def test_schedule_fires_what_jax_fires(total, counts):
    for seed, frames in enumerate(_frame_sequences(total, seed=total)):
        got_schedule = ActionPointSchedule(total, counts)
        want_schedule = JaxActionPointSchedule(total, counts)
        for f in frames:
            assert got_schedule.due(f) == want_schedule.due(f), (seed, f)


def test_action_point_schedule_fires_each_mark_once():
    sched = ActionPointSchedule(
        1000, {"checkpoint": 4, "saved_model": 2, "snapshot": 0})
    fired = []
    for frames in [100, 250, 250, 400, 500, 600, 990, 1000]:
        for a in sched.due(frames):
            fired.append((frames, a))
    # checkpoint marks: 250, 500, 750, 1000; saved_model marks: 500, 1000.
    assert fired == [
        (250, "checkpoint"),
        (500, "checkpoint"),
        (500, "saved_model"),
        (990, "checkpoint"),
        (1000, "checkpoint"),
        (1000, "saved_model"),
    ]


def test_action_point_schedule_fires_per_jumped_mark():
    sched = ActionPointSchedule(100, {"checkpoint": 10})
    assert sched.due(95) == ["checkpoint"] * 9
    assert sched.due(100) == ["checkpoint"]
    assert sched.due(100000) == []


def _ppo(num_envs=8, **kw):
    flags = {"epochs_per_step": 1, "batches_per_step": 2, "unroll_length": 4,
             **kw}
    return train.main(["--device=cpu", "--agent=ppo", "--env=toy",
                       f"--num_envs={num_envs}", "--steps_per_call=1",
                       "--log_every_steps=1"]
                      + [f"--{k}={v}" for k, v in flags.items()])


def _tensors(tree):
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def test_ppo_snapshot_restore_round_trip():
    learner, state, _ = _ppo(total_environment_frames=0)
    state, _ = learner.train_step(state)
    snap = snapshot_ppo_state(learner, state, frames=32)
    assert isinstance(snap, LearnerState) and snap.frames == 32
    assert snap.step == 1
    # CPU copies, sharing nothing with the learner's tensors.
    live = _tensors(learner.checkpoint_state(state))
    copies = _tensors(snap)
    assert copies and all(t.device.type == "cpu" for t in copies)
    pointers = {t.untyped_storage().data_ptr() for t in live}
    assert not pointers & {t.untyped_storage().data_ptr() for t in copies}
    want = [t.clone() for t in learner.parameters()]

    fresh, fresh_state, _ = _ppo(total_environment_frames=0)
    warm = restore_ppo_state(fresh, fresh_state, snap)
    for got, w in zip(fresh.parameters(), want):
        assert torch.equal(got, w)
    assert warm.step == state.step
    for got, w in zip(_tensors(warm.rollout), _tensors(fresh_state.rollout)):
        assert torch.equal(got, w)
    # The warm-started learner trains on, and the snapshot stays as taken.
    nxt, _ = fresh.train_step(warm)
    assert nxt.step == state.step + 1
    for got, w in zip(_tensors(snap.params), want):
        assert torch.equal(got, w)
    assert not torch.equal(next(iter(fresh.parameters())), want[0])


class _CountingManager(ckpt.CheckpointManager):
    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.forced = []

    def maybe_save(self, step, learner, state, force=False):
        if force:
            self.forced.append(step)
        return super().maybe_save(step, learner, state, force)


@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_learner_loop_fires_the_action_points(steps_per_call, tmp_path):
    learner, state, _ = _ppo(total_environment_frames=0)
    manager = _CountingManager(str(tmp_path), save_checkpoint_secs=1e9)
    total = 4 * learner.frames_per_step
    state, _ = ppo.learner_loop(
        learner, total, checkpoint=manager, steps_per_call=steps_per_call,
        num_checkpoints=4, num_saved_models=4, num_snapshots=4,
        logdir=str(tmp_path))
    assert state.step == 4
    calls = range(steps_per_call, 5, steps_per_call)
    # Checkpoints and exports once a call; the last save forced at the end.
    assert manager.forced == list(calls) + [4]
    exported = sorted(int(d) for d in os.listdir(tmp_path / "saved_models"))
    assert exported == [c * learner.frames_per_step for c in calls]
    # One snapshot per mark, however many marks a call crosses.
    assert [s.frames for s in learner.snapshots] == [
        f for c in calls for f in [c * learner.frames_per_step]
        * steps_per_call]


def test_saved_models_need_a_logdir():
    learner, state, _ = _ppo(total_environment_frames=64,
                             num_saved_models=2, num_snapshots=1,
                             num_checkpoints=2)
    assert state.step == 2
    assert len(learner.snapshots) == 1
