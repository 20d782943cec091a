"""Scale-out through the CLI and across processes, on the CPU over gloo.

Mirrors tests/test_multihost.py: two OS processes join one process group
through ``parallel.init_multi_host`` (``tests/torch_dp_workers.py`` run as a
script, JAX blocked) and train V-trace and R2D2 through the CLI's learners;
their metrics agree bitwise. Then the user's path: ``train.main`` with
``--device=cpu --num_replicas=2`` spawns the second rank itself, returns
rank 0's ``DistributedLearner`` and matches ``--num_replicas=1``
(parameters, metrics, priorities within rtol 1e-4 / atol 1e-5); a two-rank
checkpoint holds the one-rank layout and resumes into two ranks and into
one, which agree with each other; and the refusals where the JAX CLI
ignores the flag, or could not run it.
"""

import math
import os
import shutil
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from seed_rl_torch import train
from seed_rl_torch.parallel import DistributedLearner, init_multi_host

TOL = dict(rtol=1e-4, atol=1e-5)
HERE = os.path.dirname(os.path.abspath(__file__))
R2D2 = ["--device=cpu", "--agent=r2d2", "--env=discrete_match",
        "--num_envs=16", "--num_eval_envs=2", "--unroll_length=4",
        "--burn_in=1", "--n_steps=2", "--replay_buffer_size=64",
        "--replay_buffer_min_size=16", "--batch_size=8",
        "--steps_per_call=1", "--log_every_steps=2"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Rank 0 runs in this process, beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _params(learner):
    inner = getattr(learner, "learner", learner)
    return [p.detach().numpy().copy() for p in inner.parameters()]


def _close(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, **TOL)


def test_two_process_group_trains_identically():
    port = str(_free_port())
    block = textwrap.dedent("""
        import runpy, sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "seed_rl_tpu"):
                    raise ImportError(f"{name} is blocked")
        sys.meta_path.insert(0, Block())
        sys.argv = sys.argv[1:]
        runpy.run_path(sys.argv[0], run_name="__main__")
    """)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    worker = os.path.join(HERE, "torch_dp_workers.py")
    procs = [subprocess.Popen(
        [sys.executable, "-c", block, worker, str(i), port],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        cwd=os.path.dirname(HERE), text=True) for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out

    def lines(tag):
        found = sorted(tuple(line.split()[1:]) for out in outs
                       for line in out.splitlines()
                       if line.startswith(tag + " "))
        assert len(found) == 2, outs
        assert [v[0] for v in found] == ["0", "1"]
        assert found[0][1:] == found[1][1:], found  # bitwise equal
        return found[0][1:]

    loss, entropy, step = lines("METRICS")
    assert math.isfinite(float(loss)) and math.isfinite(float(entropy))
    assert step == "3"
    td, priority, weight, step = lines("R2D2_METRICS")
    assert math.isfinite(float(td)) and step == "2"


def test_cli_two_replicas_match_one():
    argv = ["--device=cpu", "--agent=vtrace", "--env=toy", "--num_envs=16",
            "--unroll_length=4", "--total_environment_frames=192",
            "--steps_per_call=1", "--log_every_steps=1"]
    one, one_state, one_metrics = train.main(argv + ["--num_replicas=1"])
    two, two_state, two_metrics = train.main(argv + ["--num_replicas=2"])
    assert not isinstance(one, DistributedLearner)
    assert isinstance(two, DistributedLearner) and two.mesh.size == 2
    assert two.engine.env.num_envs == 8
    assert two_state.step == one_state.step == 3
    _close(_params(two), _params(one))
    for k, v in one_metrics.items():
        np.testing.assert_allclose(float(two_metrics[k]), float(v), **TOL,
                                   err_msg=k)


def test_two_rank_checkpoint_resumes_into_two_and_one_rank(tmp_path):
    """R2D2 (with its replay and uneven eval envs) saves on two ranks in
    the one-rank layout; the same checkpoint resumes on two ranks and on
    one, and both land where one rank's uninterrupted run does."""
    two_dir, one_dir = tmp_path / "two", tmp_path / "one"
    first, first_state, _ = train.main(R2D2 + [
        "--num_replicas=2", f"--logdir={two_dir}",
        "--total_environment_frames=128"])
    assert first_state.step == 2
    saved = torch.load(two_dir / "ckpt" / "2" / "checkpoint.pt",
                       weights_only=True)
    # The global layout: every env, every replay slot.
    assert saved["rollout"]["env_output"]["reward"].shape == (16,)
    assert saved["stats"]["return_acc"].shape == (14,)
    assert saved["eval_stats"]["return_acc"].shape == (2,)
    assert saved["replay"]["priorities"].shape == (64,)
    assert saved["replay"]["buffer"]["prev_actions"].shape[0] == 64
    shutil.copytree(two_dir, one_dir)

    full = R2D2 + ["--total_environment_frames=256"]
    two, two_state, two_metrics = train.main(
        full + ["--num_replicas=2", f"--logdir={two_dir}"])
    one, one_state, one_metrics = train.main(
        full + ["--num_replicas=1", f"--logdir={one_dir}"])
    straight, straight_state, _ = train.main(full + ["--num_replicas=1"])
    assert two_state.step == one_state.step == straight_state.step == 4
    _close(_params(two), _params(one))
    _close(_params(one), _params(straight))
    np.testing.assert_allclose(two_state.replay.priorities.numpy(),
                               one_state.replay.priorities.numpy(), **TOL)
    for k, v in one_metrics.items():
        np.testing.assert_allclose(float(two_metrics[k]), float(v), **TOL,
                                   err_msg=k)


@pytest.mark.parametrize("flags", [
    ["--env=synthetic_atari_host"],
    ["--env=toy", "--run_mode=eval"],
    ["--env=toy", "--run_mode=profile"],
    ["--env=synthetic_atari_host", "--run_mode=learner"],
    ["--env=synthetic_atari_host", "--run_mode=actor"],
])
def test_replicas_refused_where_the_jax_cli_ignores_them(flags):
    with pytest.raises(ValueError, match="num_replicas=2"):
        train.main(["--device=cpu", "--agent=vtrace", "--num_replicas=2"]
                   + flags)


def test_replicas_refused_beyond_the_devices_and_without_gloo(monkeypatch):
    args = train.parse_args(["--agent=vtrace", "--env=toy",
                             "--num_replicas=2"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs as many CUDA devices"):
        train.num_replicas(args, torch.device("cuda"))
    monkeypatch.setattr(torch.distributed, "is_gloo_available",
                        lambda: False)
    with pytest.raises(ValueError, match="gloo"):
        train.num_replicas(args, torch.device("cpu"))
    with pytest.raises(ValueError, match=">= 0"):
        train.num_replicas(train.parse_args(
            ["--agent=vtrace", "--env=toy", "--num_replicas=-1"]),
            torch.device("cpu"))


def test_default_replicas():
    """0 means every local CUDA device, one on the CPU; host envs and the
    other run modes run on one device whatever the machine has."""
    args = train.parse_args(["--agent=vtrace", "--env=toy"])
    assert train.num_replicas(args, torch.device("cpu")) == 1
    host = train.parse_args(["--agent=vtrace",
                             "--env=synthetic_atari_host"])
    assert train.num_replicas(host, torch.device("cpu")) == 1


def test_init_multi_host_is_a_no_op_on_one_process():
    init_multi_host("localhost:1", num_processes=1, process_id=0)
    assert not torch.distributed.is_initialized()
