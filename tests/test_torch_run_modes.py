"""The CLI's run modes and checkpoint flags in seed_rl_torch, and the
deterministic policy steps that ``--run_mode=eval`` takes.

- ``R2D2Agent.policy_step(deterministic=True)`` (``VectorDuelingDQNNet``)
  and ``SACAgent.policy_step(deterministic=True)`` (MLP, LSTM, visual;
  continuous and discrete; with observation statistics), on parameters
  converted from JAX, against the JAX package's: discrete actions equal;
  continuous actions, Q values and carries within rtol = atol = 1e-5. The
  deterministic R2D2 step draws nothing from its generator.
- ``--logdir`` training, then ``--run_mode=eval`` on it, for all four
  agents: one JSON line, with ``eval/restored_step``, at least
  ``--eval_episodes`` episodes, the same numbers twice.
- ``--run_mode=profile`` writes a Chrome trace and one JSON line.
- ``--init_checkpoint`` warm-starts a run with another ``num_envs``; a
  restart on its own logdir then resumes from there.
- What stays refused: ``--run_mode=actor`` on a device env, more than one
  replica, PPO's action-point counts elsewhere, and the host-env flags
  where the JAX CLI ignores them (``--checkpoint_replay`` and
  ``--replay_ratio`` outside R2D2 and SAC on host envs,
  ``--pipeline_host_rollouts`` on device envs) or asserts
  (``--run_mode=profile`` on host envs).
"""

import json
import math
import os
import tempfile

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.utils._pytree as pytree

from seed_rl_tpu.agents import r2d2 as jax_r2d2
from seed_rl_tpu.types import EnvOutput as JaxEnvOutput
from seed_rl_torch import train
from seed_rl_torch.agents import r2d2
from seed_rl_torch.types import EnvOutput
from seed_rl_torch.utils import checkpoint as ckpt
from test_torch_r2d2 import SMALL_NET
from test_torch_r2d2 import _env_output as _r2d2_env_output
from test_torch_r2d2 import _jax_nets as _r2d2_nets
from test_torch_sac import CASES as SAC_CASES
from test_torch_sac import _data as _sac_data
from test_torch_sac import _setup as _sac_setup
from test_torch_sac import _to_jax as _sac_to_jax
from test_torch_sac import _to_torch as _sac_to_torch

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread (see tests/test_torch_ppo.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_close(got, want, exact=False):
    got = pytree.tree_leaves(got)
    want = jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if exact or not g.dtype.is_floating_point:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_deterministic_r2d2_step_is_greedy_as_jax():
    jnet, tnet, params = _r2d2_nets(**SMALL_NET)
    B = 8
    rng = np.random.RandomState(4)
    eo = _r2d2_env_output(rng, (B,), done_p=0.3)
    prev = rng.randint(0, 4, B).astype(np.int32)
    state = pytree.tree_map(
        lambda t: torch.from_numpy(rng.normal(size=t.shape).astype(
            np.float32)), tnet.initial_state(B))
    eps = np.ones((B,), np.float32)  # all-random unless deterministic
    jout, jstate = jax_r2d2.R2D2Agent(jnet, jnp.asarray(eps)).policy_step(
        params, jnp.asarray(prev), JaxEnvOutput(**eo),
        jax.tree.map(lambda t: jnp.asarray(t.numpy()), state),
        jax.random.PRNGKey(0), deterministic=True)
    agent = r2d2.R2D2Agent(tnet, torch.from_numpy(eps))
    g = torch.Generator().manual_seed(5)
    before = g.get_state()
    with torch.no_grad():
        out, new_state = agent.policy_step(
            torch.from_numpy(prev),
            EnvOutput(**pytree.tree_map(torch.from_numpy, eo)), state, g,
            deterministic=True)
    assert torch.equal(g.get_state(), before)  # no draw
    assert out.action.dtype == torch.int32
    _assert_close(out.action, jout.action, exact=True)
    assert torch.equal(out.action, torch.argmax(out.q_values, -1).int())
    _assert_close(out.q_values, jout.q_values)
    _assert_close(new_state, jstate)


@pytest.mark.parametrize("name", ["mlp_tanh_v", "lstm", "visual_catch",
                                  "mlp_categorical_pg",
                                  "her_mlp_normalized"])
def test_deterministic_sac_step_takes_the_mode_as_jax(name):
    case = SAC_CASES[name]
    rng = np.random.RandomState(6)
    B = 5
    setup = _sac_setup(case, rng, B)
    data = _sac_data(case, rng, 1, B, setup.tagent.net)
    jstate0, jprev, jeo, _ = _sac_to_jax(data)
    tstate0, tprev, teo, _ = _sac_to_torch(data)
    jout, jstate = setup.jagent.policy_step(
        setup.jparams["net"], jprev[0], jax.tree.map(lambda x: x[0], jeo),
        jstate0, jax.random.PRNGKey(0), deterministic=True)
    with torch.no_grad():
        out, state = setup.tagent.policy_step(
            tprev[0], pytree.tree_map(lambda x: x[0], teo), tstate0,
            deterministic=True)
    _assert_close(out.action, jout.action)
    _assert_close(state, jstate)
    if not case.discrete:  # the mode, inside the tanh's open interval
        assert bool(torch.all(out.action.abs() < 1.0))


# name -> (flags, frames a step); 4 envs x 3 steps unless set.
AGENTS = {
    "vtrace": (["--agent=vtrace", "--env=toy"], 12),
    "r2d2": (["--agent=r2d2", "--env=discrete_match", "--burn_in=1",
              "--replay_buffer_size=64", "--replay_buffer_min_size=8",
              "--batch_size=4"], 12),
    "sac": (["--agent=sac", "--env=bit_flipping", "--her_window_length=4",
             "--unroll_length=2", "--replay_buffer_size=64",
             "--replay_buffer_min_size=8", "--batch_size=4"], 16),
    "ppo": (["--agent=ppo", "--env=toy", "--epochs_per_step=1",
             "--batches_per_step=2"], 12),
}
BASE = ["--device=cpu", "--num_envs=4", "--unroll_length=3",
        "--steps_per_call=1", "--log_every_steps=1"]


def _argv(agent, logdir, steps, *extra):
    flags, frames = AGENTS[agent]
    return BASE + flags + [f"--logdir={logdir}",
                           f"--total_environment_frames={steps * frames}",
                           *extra]


def _json_lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


@pytest.mark.parametrize("agent", list(AGENTS))
def test_eval_restores_and_prints_one_json_line(agent, tmp_path, capsys):
    learner, state, _ = train.main(_argv(agent, tmp_path, 2))
    capsys.readouterr()
    runs = []
    for _ in range(2):
        _, restored, metrics = train.main(
            _argv(agent, tmp_path, 2, "--run_mode=eval",
                  "--eval_episodes=6"))
        (line,) = _json_lines(capsys)
        assert line == metrics
        runs.append(line)
    assert runs[0] == runs[1]
    assert runs[0]["eval/restored_step"] == state.step == restored.step
    assert runs[0]["eval/num_episodes"] >= 6
    assert set(runs[0]) == {"eval/num_episodes", "eval/mean_return",
                            "eval/mean_length", "eval/restored_step"}
    assert all(math.isfinite(v) for v in runs[0].values())


def test_eval_without_a_checkpoint_evaluates_the_fresh_policy(tmp_path,
                                                              capsys):
    train.main(_argv("vtrace", tmp_path, 2, "--run_mode=eval",
                     "--eval_episodes=4"))
    (line,) = _json_lines(capsys)
    assert line["eval/restored_step"] == 0
    assert not os.path.exists(tmp_path / "ckpt")


@pytest.mark.parametrize("agent", ["vtrace", "r2d2"])
def test_profile_writes_a_trace_and_one_json_line(agent, tmp_path, capsys):
    learner, state, result = train.main(
        _argv(agent, tmp_path, 2, "--run_mode=profile", "--profile_calls=2",
              "--steps_per_call=2"))
    (line,) = [x for x in _json_lines(capsys)]
    assert line == result
    assert line["profile_dir"] == str(tmp_path / "profile")
    assert (line["calls"], line["steps_per_call"]) == (2, 2)
    assert line["frames_per_sec"] > 0
    # One warm call and the traced ones, after the replay's warm-up.
    assert state.step == 6
    with open(tmp_path / "profile" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    assert not os.path.exists(tmp_path / "ckpt")


def test_profile_without_a_logdir_writes_under_the_temp_dir(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    flags, frames = AGENTS["vtrace"]
    train.main(BASE + flags + ["--run_mode=profile", "--profile_calls=1"])
    (line,) = _json_lines(capsys)
    assert line["profile_dir"] == str(tmp_path / "seed_rl_torch" / "profile")
    assert os.path.isfile(tmp_path / "seed_rl_torch" / "profile"
                          / "trace.json")


def test_init_checkpoint_warm_starts_then_resumes_its_own(tmp_path):
    src, src_state, _ = train.main(_argv("ppo", tmp_path / "src", 2))
    src_params = [p.detach().clone() for p in src.parameters()]
    # Another num_envs: 8 envs x 3 steps = 24 frames a step, so a budget of
    # 48 frames ends at the warm-started step 2 without training.
    def dst_run(frames):
        return train.main(_argv("ppo", tmp_path / "dst", 0) + [
            "--num_envs=8", f"--init_checkpoint={tmp_path / 'src'}",
            f"--total_environment_frames={frames}"])

    dst, state, _ = dst_run(48)
    assert state.step == 2
    for got, want in zip(dst.parameters(), src_params):
        assert torch.equal(got, want)
    assert dst.optimizer.count == src.optimizer.count
    assert state.rollout.env_output.reward.shape == (8,)
    assert ckpt.CheckpointManager(str(tmp_path / "dst")).latest_step() == 2
    # A restart on its own logdir resumes from there, not the source.
    again, state, _ = dst_run(72)
    assert state.step == 3
    assert again.optimizer.count == src.optimizer.count + 2


@pytest.mark.parametrize("flags,error", [
    (["--agent=vtrace", "--env=toy", "--run_mode=actor"],
     NotImplementedError),
    (["--agent=sac", "--env=catch_continuous", "--run_mode=actor"],
     NotImplementedError),
    # Data parallelism is for training (the JAX CLI ignores the flag in the
    # other run modes).
    (["--agent=r2d2", "--env=discrete_match", "--run_mode=eval",
      "--num_replicas=2"], ValueError),
    (["--agent=vtrace", "--env=toy", "--num_snapshots=2"], ValueError),
    (["--agent=r2d2", "--env=discrete_match", "--num_checkpoints=1"],
     ValueError),
    (["--agent=sac", "--env=toy", "--num_saved_models=1"], ValueError),
    # The host-env flags where the JAX CLI ignores them, or asserts.
    (["--agent=r2d2", "--env=discrete_match", "--checkpoint_replay"],
     ValueError),
    (["--agent=ppo", "--env=synthetic_atari_host", "--checkpoint_replay"],
     ValueError),
    (["--agent=sac", "--env=toy", "--replay_ratio=0.5"], ValueError),
    (["--agent=vtrace", "--env=toy", "--pipeline_host_rollouts"],
     ValueError),
    (["--agent=vtrace", "--env=synthetic_atari_host", "--run_mode=profile"],
     ValueError),
    (["--agent=r2d2", "--env=synthetic_atari_host",
      "--train_batches_per_step=2"], ValueError),
    (["--agent=ppo", "--env=synthetic_atari_host", "--num_checkpoints=1"],
     ValueError),
    (["--agent=r2d2", "--env=mujoco", "--num_envs=1"], ValueError),
])
def test_what_stays_refused(flags, error, tmp_path):
    with pytest.raises(error):
        train.main(["--device=cpu", f"--logdir={tmp_path}"] + flags)
    assert not os.listdir(tmp_path)
