"""Checkpoints of seed_rl_torch (``utils/checkpoint.py``), mirroring the
JAX package's checkpoint tests and holding the port to its own contract.

- ``ClippedAdam``: 3 steps, a state dict through ``torch.save`` and a
  weights-only load into a new optimizer over new parameters, then 2 steps,
  equal 5 uninterrupted steps bitwise.
- Resume exactness: for V-trace on ``toy``, R2D2 on ``discrete_match``,
  SAC on ``toy`` and on ``bit_flipping`` with HER, and PPO on ``toy``, a
  CLI run of 4 steps equals, bitwise, a run of 2 steps on a logdir and a
  second run on it with a 4-step budget (a learner built anew that
  restores and trains 2 more): parameters, optimizer, train state and
  generators, everything a checkpoint holds.
- Mirrors of ``test_vtrace_learner_loop_with_checkpoint``,
  ``test_fused_replay_state_in_checkpoint`` (R2D2 and SAC) and
  ``test_warm_start_restore_across_env_counts`` (PPO, 8 -> 4 envs).
- Mechanics: a restore into another structure raises ``ValueError`` with
  the JAX package's advice; the ``save_checkpoint_secs`` cadence (time
  patched); ``max_to_keep``; a weights-only load of the file.
"""

import io
import math
import os

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from seed_rl_torch import optim, train
from seed_rl_torch.agents import vtrace as vtrace_agent
from seed_rl_torch.utils import checkpoint as ckpt
from seed_rl_torch.utils.metrics import MetricsLogger


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread, so that the other test
    processes sharing the cores do not stall every op's thread barrier
    (see tests/test_torch_ppo.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BASE = ["--device=cpu", "--num_envs=4", "--unroll_length=3",
        "--steps_per_call=1", "--log_every_steps=1"]
REPLAY = ["--replay_buffer_size=64", "--replay_buffer_min_size=8",
          "--batch_size=4"]
# name -> (flags, env frames a step)
RUNS = {
    "vtrace_toy": (["--agent=vtrace", "--env=toy"], 12),
    "r2d2_discrete_match": (["--agent=r2d2", "--env=discrete_match",
                             "--burn_in=1", "--update_target_every_n_step=3",
                             *REPLAY], 12),
    "sac_toy": (["--agent=sac", "--env=toy", "--unroll_length=2", *REPLAY],
                8),
    "sac_bit_flipping_her": (["--agent=sac", "--env=bit_flipping",
                              "--her_window_length=4", "--unroll_length=2",
                              *REPLAY], 16),
    "ppo_toy": (["--agent=ppo", "--env=toy", "--epochs_per_step=2",
                 "--batches_per_step=2"], 12),
}


def _main(name, logdir, steps, *extra):
    flags, frames = RUNS[name]
    return train.main(BASE + flags + [f"--logdir={logdir}",
                                      f"--total_environment_frames="
                                      f"{steps * frames}", *extra])


def _saved(learner, state):
    return ckpt.to_saveable(learner.checkpoint_state(state))


def _assert_trees_equal(got, want):
    got_leaves, got_spec = pytree.tree_flatten(got)
    want_leaves, want_spec = pytree.tree_flatten(want)
    assert got_spec == want_spec
    for g, w in zip(got_leaves, want_leaves):
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w)
        else:
            assert g == w


def _differs(got, want):
    return any(not torch.equal(g, w) for g, w in zip(
        pytree.tree_leaves(got), pytree.tree_leaves(want))
        if isinstance(w, torch.Tensor))


def test_clipped_adam_state_round_trip_is_bitwise(tmp_path):
    def make(params):
        return optim.ClippedAdam(params, learning_rate=1e-2, clip_norm=1.0,
                                 end_learning_rate=1e-3, transition_steps=4)

    def step(params, opt):
        opt.zero_grad()
        sum(torch.sum(p ** 3) for p in params).backward()
        opt.step()

    g = torch.Generator().manual_seed(0)
    init = [torch.randn((5,), generator=g), torch.randn((2, 3), generator=g)]
    straight = [torch.nn.Parameter(t.clone()) for t in init]
    straight_opt = make(straight)
    for _ in range(5):
        step(straight, straight_opt)

    params = [torch.nn.Parameter(t.clone()) for t in init]
    opt = make(params)
    assert opt.state_dict()["count"] == 0
    for _ in range(3):
        step(params, opt)
    torch.save({"params": [p.detach() for p in params],
                "opt": opt.state_dict()}, tmp_path / "opt.pt")
    saved = torch.load(tmp_path / "opt.pt", weights_only=True)
    params = [torch.nn.Parameter(t) for t in saved["params"]]
    opt = make(params)
    opt.load_state_dict(saved["opt"])
    assert opt.count == 3 and opt.learning_rate() == pytest.approx(3.25e-3)
    for _ in range(2):
        step(params, opt)
    for got, want in zip(params, straight):
        assert torch.equal(got, want)
    _assert_trees_equal(ckpt.to_saveable(opt.state_dict()),
                        ckpt.to_saveable(straight_opt.state_dict()))


@pytest.mark.parametrize("name", list(RUNS))
def test_resumed_run_equals_the_uninterrupted_run(name, tmp_path):
    learner, state, _ = _main(name, tmp_path / "straight", 4)
    want = _saved(learner, state)

    first, state2, _ = _main(name, tmp_path / "resumed", 2)
    assert state2.step == 2
    halfway = _saved(first, state2)
    resumed, state, _ = _main(name, tmp_path / "resumed", 4)
    assert resumed is not first and state.step == 4
    got = _saved(resumed, state)
    _assert_trees_equal(got, want)
    # The comparison sees a difference where there is one.
    assert _differs(halfway, want)


def _vtrace_learner(num_envs=8, unroll_length=5):
    learner, state, _ = train.main([
        "--device=cpu", "--agent=vtrace", "--env=toy",
        f"--num_envs={num_envs}", f"--unroll_length={unroll_length}",
        "--total_environment_frames=0"])
    return learner


def test_vtrace_learner_loop_with_checkpoint(tmp_path):
    learner = _vtrace_learner()
    manager = ckpt.CheckpointManager(str(tmp_path), save_checkpoint_secs=1e9)
    logger = MetricsLogger(logdir=str(tmp_path / "tb"))
    state, _ = vtrace_agent.learner_loop(
        learner, total_environment_frames=8 * 5 * 4, logger=logger,
        checkpoint=manager, steps_per_call=2)
    logger.close()
    assert state.step == 4
    manager.close()

    # Resume restores the step counter and the parameters.
    fresh = _vtrace_learner()
    restored = ckpt.CheckpointManager(str(tmp_path),
                                      save_checkpoint_secs=1e9).restore_or(
        fresh, fresh.init())
    assert restored.step == 4
    for got, want in zip(fresh.parameters(), learner.parameters()):
        assert torch.equal(got, want)


@pytest.mark.parametrize("agent", ["r2d2", "sac"])
def test_fused_replay_state_in_checkpoint(agent, tmp_path):
    """The replay rides the checkpoint: a restore resumes with the exact
    buffer, priorities and cursors, and trains on without a warm-up."""
    flags = (["--agent=r2d2", "--env=discrete_match", "--burn_in=1"]
             if agent == "r2d2" else ["--agent=sac", "--env=toy",
                                      "--unroll_length=2"])
    argv = ["--device=cpu", "--num_envs=8", "--unroll_length=5",
            "--replay_buffer_size=64", "--replay_buffer_min_size=4",
            "--batch_size=4", "--total_environment_frames=0", *flags]
    learner, state, _ = train.main(argv)
    state, _ = learner.train_step(state)

    manager = ckpt.CheckpointManager(str(tmp_path), save_checkpoint_secs=0.0)
    assert manager.maybe_save(state.step, learner, state)
    manager.close()

    fresh, fresh_state, _ = train.main(argv)
    assert fresh_state.replay.num_inserted == 8  # its own warm-up
    restored = ckpt.CheckpointManager(str(tmp_path)).restore_or(
        fresh, fresh.init())
    assert restored.replay.num_inserted == state.replay.num_inserted
    assert restored.replay.insert_index == state.replay.insert_index
    _assert_trees_equal(ckpt.to_saveable(restored.replay),
                        ckpt.to_saveable(state.replay))
    nxt, logs = fresh.train_step(restored)
    assert nxt.step == state.step + 1
    assert all(math.isfinite(float(v)) for v in logs.values())


def _ppo_learner(num_envs):
    learner, state, _ = train.main([
        "--device=cpu", "--agent=ppo", "--env=toy",
        f"--num_envs={num_envs}", "--unroll_length=4",
        "--epochs_per_step=1", "--batches_per_step=2",
        "--total_environment_frames=0"])
    return learner, state


def test_warm_start_restore_across_env_counts(tmp_path):
    """--init_checkpoint semantics: agent variables restored, env state
    fresh, across a change of num_envs."""
    src, state = _ppo_learner(8)
    state, _ = src.train_step(state)
    manager = ckpt.CheckpointManager(str(tmp_path), save_checkpoint_secs=0.0)
    assert manager.maybe_save(state.step, src, state, force=True)

    dst, fresh = _ppo_learner(4)
    warm = ckpt.restore_from(str(tmp_path), dst, fresh)
    assert warm.step == state.step
    for got, want in zip(dst.parameters(), src.parameters()):
        assert torch.equal(got, want)
    _assert_trees_equal(ckpt.to_saveable(dst.optimizer.state_dict()),
                        ckpt.to_saveable(src.optimizer.state_dict()))
    _assert_trees_equal(ckpt.to_saveable(dst.agent.obs_norm),
                        ckpt.to_saveable(src.agent.obs_norm))
    _assert_trees_equal(ckpt.to_saveable(warm.norm_state),
                        ckpt.to_saveable(state.norm_state))
    # Env-bound state keeps the fresh 4-env shapes.
    assert pytree.tree_leaves(warm.rollout.env_output)[0].shape[0] == 4
    assert warm.stats.return_acc.shape == (4,)
    nxt, _ = dst.train_step(warm)
    assert nxt.step == state.step + 1


@pytest.mark.parametrize("other", [
    ["--agent=vtrace", "--env=toy_memory"],  # another observation width
    ["--agent=ppo", "--env=toy", "--epochs_per_step=1",
     "--batches_per_step=2"],  # another learner
    ["--agent=vtrace", "--env=toy", "--normalize_observations"],
])
def test_restore_into_another_structure_raises(other, tmp_path):
    argv = ["--device=cpu", "--num_envs=4", "--unroll_length=3",
            "--steps_per_call=1", f"--logdir={tmp_path}",
            "--total_environment_frames=12"]
    train.main(argv + ["--agent=vtrace", "--env=toy"])
    with pytest.raises(ValueError, match="--init_checkpoint"):
        train.main(argv + other)


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def time(self):
        return self.now


def test_save_cadence_follows_save_checkpoint_secs(tmp_path, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(ckpt.time, "time", clock.time)
    learner = _vtrace_learner(num_envs=4, unroll_length=3)
    state = learner.init()
    manager = ckpt.CheckpointManager(str(tmp_path), save_checkpoint_secs=60,
                                     max_to_keep=10)
    saved = []
    for step in range(1, 8):
        clock.now += 25.0
        saved.append(manager.maybe_save(step, learner, state))
    # The first call saves at once, then every 60 s.
    assert saved == [True, False, False, True, False, False, True]
    assert manager.maybe_save(8, learner, state, force=True)
    assert manager.latest_step() == 8
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["1", "4", "7", "8"]
    # A restore starts the clock again.
    fresh = ckpt.CheckpointManager(str(tmp_path), save_checkpoint_secs=60)
    fresh.restore_or(learner, learner.init())
    clock.now += 59.0
    assert not fresh.maybe_save(9, learner, state)
    clock.now += 1.0
    assert fresh.maybe_save(9, learner, state)


def test_max_to_keep(tmp_path):
    learner = _vtrace_learner(num_envs=4, unroll_length=3)
    state = learner.init()
    manager = ckpt.CheckpointManager(str(tmp_path), save_checkpoint_secs=0,
                                     max_to_keep=2)
    for step in (3, 5, 9, 12):
        assert manager.maybe_save(step, learner, state)
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["12", "9"]
    assert ckpt.CheckpointManager(str(tmp_path)).latest_step() == 12
    assert not os.path.exists(tmp_path / "ckpt" / "12"
                              / (ckpt.FILE_NAME + ".tmp"))


def test_checkpoint_file_loads_weights_only(tmp_path):
    learner, state, _ = _main("r2d2_discrete_match", tmp_path, 1)
    path = tmp_path / "ckpt" / str(state.step) / ckpt.FILE_NAME
    with open(path, "rb") as f:
        saved = torch.load(io.BytesIO(f.read()), weights_only=True)
    assert set(saved) == {"replay", "rollout", "stats", "eval_stats", "step",
                          "params", "target_params", "opt_state",
                          "generators"}
    assert saved["step"] == 1
    # NamedTuples are stored as dicts keyed by field, tuples as lists.
    assert set(saved["replay"]) == {"buffer", "priorities", "insert_index",
                                    "num_inserted"}
    assert set(saved["rollout"]["env_output"]) == {
        "reward", "done", "observation", "abandoned", "episode_step"}
    assert isinstance(saved["generators"], list)
    leaves = [x for x in pytree.tree_leaves(saved)
              if isinstance(x, torch.Tensor)]
    assert all(x.device.type == "cpu" for x in leaves)
    _assert_trees_equal(saved, _saved(learner, state))
    np.testing.assert_array_equal(
        saved["replay"]["priorities"].numpy(),
        state.replay.priorities.numpy())


def test_restore_or_without_a_checkpoint_keeps_the_state(tmp_path):
    learner = _vtrace_learner(num_envs=4, unroll_length=3)
    state = learner.init()
    before = _saved(learner, state)
    off = ckpt.CheckpointManager(None)
    assert off.restore_or(learner, state) is state
    assert not off.maybe_save(1, learner, state, force=True)
    empty = ckpt.CheckpointManager(str(tmp_path))
    assert empty.latest_step() is None
    assert empty.restore_or(learner, state) is state
    _assert_trees_equal(_saved(learner, state), before)
    with pytest.raises(FileNotFoundError):
        ckpt.restore_from(str(tmp_path / "nothing"), learner, state)
