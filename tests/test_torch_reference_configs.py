"""The port's reference-config launch scripts (seed_rl_torch/
reference_configs/), mirroring tests/test_reference_configs.py.

Each script runs ``python -m seed_rl_torch.train`` (the fleet's, ``python
-m seed_rl_torch.fleet``) with the flags of its JAX twin in
scripts/reference_configs/. These tests run the scripts themselves with
``--device=cpu`` and the JAX tests' tiny overrides (later flags win) and,
where the simulator is absent (ale_py, deepmind_lab), the same stand-ins:
synthetic_atari_host for Atari, synthetic_atari for DmLab. Each run gets a
fresh logdir and one torch thread.
"""

import os
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "seed_rl_torch", "reference_configs")
JAX_CONFIGS = os.path.join(REPO, "scripts", "reference_configs")


def _run_script(name, arg, overrides, logdir, timeout=240, extra_env=None):
    env = {
        **os.environ,
        "PYTHONPATH": REPO,
        "LOGDIR": str(logdir),
        "OMP_NUM_THREADS": "1",
        **(extra_env or {}),
    }
    proc = subprocess.run(
        ["bash", os.path.join(CONFIGS, name), arg, "--device=cpu"]
        + overrides,
        cwd=REPO, env=env, capture_output=True, timeout=timeout)
    assert proc.returncode == 0, (
        proc.stdout.decode()[-2000:] + proc.stderr.decode()[-2000:])
    return proc.stdout.decode() + proc.stderr.decode()


def _flags(path):
    """The ``--flag=value`` words of a launcher's command, in order."""
    with open(path) as f:
        command = f.read().split("\nexec ", 1)[1]
    words = command.replace("\\\n", " ").split()
    return [w for w in words if w.startswith("--")]


@pytest.mark.parametrize("name", sorted(os.listdir(JAX_CONFIGS)))
def test_each_launcher_passes_its_jax_twins_flags(name):
    """Same flags and values, in the same order; the port's module."""
    port = os.path.join(CONFIGS, name)
    assert _flags(port) == _flags(os.path.join(JAX_CONFIGS, name))
    with open(port) as f:
        text = f.read()
    launcher = ("seed_rl_torch.fleet" if name.endswith("_fleet.sh")
                else "seed_rl_torch.train")
    assert f"exec python -m {launcher}" in text
    assert "LOGDIR=${LOGDIR:-/tmp/seed_rl_torch/" in text
    assert "seed_rl_tpu" not in text
    assert os.access(port, os.X_OK)


def test_mujoco_ppo_reference_config_launches(tmp_path):
    _run_script("train_mujoco_ppo.sh", "HalfCheetah-v5", [
        "--num_envs=8", "--batches_per_step=2", "--epochs_per_step=1",
        "--total_environment_frames=256",
    ], tmp_path)
    assert os.path.isdir(tmp_path / "ckpt")


def test_mujoco_sac_reference_config_launches(tmp_path):
    _run_script("train_mujoco_sac.sh", "HalfCheetah-v5", [
        "--num_envs=4", "--batch_size=16", "--replay_buffer_size=512",
        "--replay_buffer_min_size=32", "--total_environment_frames=160",
    ], tmp_path)
    assert os.path.isdir(tmp_path / "ckpt")


def test_atari_r2d2_reference_config_launches(tmp_path):
    # ale_py absent: synthetic host Atari runs the same pipeline (threaded
    # host stepping, host-RAM replay, the replay ratio).
    _run_script("train_atari_r2d2.sh", "Pong", [
        "--env=synthetic_atari_host", "--num_envs=4", "--num_eval_envs=1",
        "--unroll_length=6", "--burn_in=2", "--n_steps=2", "--batch_size=4",
        "--replay_buffer_size=64", "--replay_buffer_min_size=8",
        "--total_environment_frames=360",
    ], tmp_path)
    assert os.path.isdir(tmp_path / "ckpt")


def test_dmlab_vtrace_reference_config_launches(tmp_path):
    # deepmind_lab absent: the synthetic device env runs the same fused
    # rollout and update (conv + LSTM over uint8 frames).
    _run_script("train_dmlab_vtrace.sh", "explore_goal_locations_small", [
        "--env=synthetic_atari", "--num_envs=8", "--unroll_length=6",
        "--steps_per_call=2", "--total_environment_frames=384",
    ], tmp_path)
    assert os.path.isdir(tmp_path / "ckpt")


def test_atari_r2d2_fleet_config_launches(tmp_path):
    """The fleet: a learner and actor processes over synthetic host Atari
    train to the frame budget and exit 0."""
    _run_script("train_atari_r2d2_fleet.sh", "Pong", [
        "--env=synthetic_atari_host", "--num_eval_envs=1",
        "--unroll_length=5", "--burn_in=2", "--n_steps=2", "--batch_size=2",
        "--replay_ratio=1.0", "--replay_buffer_size=32",
        "--replay_buffer_min_size=2", "--total_environment_frames=40",
    ], tmp_path, extra_env={"WORKERS": "1", "ACTORS_PER_WORKER": "2",
                            "ENVS_PER_ACTOR": "2"})
    assert os.path.isdir(tmp_path / "ckpt")
