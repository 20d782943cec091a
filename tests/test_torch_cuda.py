"""Tests of the port that need an NVIDIA card: the CUDA kernels themselves.

Marked ``cuda``; each skips where torch sees no CUDA device. This file
imports no JAX, so it also runs on a machine with the card and no JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import math

import numpy as np
import pytest
import torch

from seed_rl_torch.ops import vtrace as plain
from seed_rl_torch.ops.cuda import vtrace_kernel

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(T, B, seed, device):
    rng = np.random.RandomState(seed)
    arrays = [
        rng.uniform(-1, 1, (T, B)), rng.uniform(-1, 1, (T, B)),
        rng.binomial(1, 0.9, (T, B)) * 0.99, rng.normal(size=(T, B)),
        rng.normal(size=(T, B)), rng.normal(size=(B,)),
    ]
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in arrays]


@pytest.mark.parametrize("T,B,lam,clip_rho,clip_pg", [
    (32, 1024, 1.0, 1.0, 1.0),
    (12, 256, 0.95, 1.0, 1.0),
    (5, 128, 1.0, None, None),
    (7, 37, 0.9, 2.0, 0.5),
    (1, 1, 1.0, 1.0, 1.0),
])
def test_vtrace_kernel_matches_plain(cuda, T, B, lam, clip_rho, clip_pg):
    args = _inputs(T, B, T + B, cuda)
    kwargs = dict(clip_rho_threshold=clip_rho,
                  clip_pg_rho_threshold=clip_pg, lambda_=lam)
    before = vtrace_kernel.launches
    got = vtrace_kernel.from_importance_weights(*args, **kwargs)
    want = plain.from_importance_weights(*args, **kwargs)
    torch.cuda.synchronize()
    assert vtrace_kernel.launches == before + 1
    torch.testing.assert_close(got.vs, want.vs, **TOL)
    torch.testing.assert_close(got.pg_advantages, want.pg_advantages, **TOL)


def test_vtrace_kernel_refuses_what_it_does_not_take(cuda):
    args = _inputs(4, 8, 0, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        strided = [a.t().contiguous().t() for a in args[:5]] + [args[5]]
        vtrace_kernel.from_importance_weights(*strided)
    with pytest.raises(ValueError):
        vtrace_kernel.from_importance_weights(*args[:5], args[5][:3])
    with pytest.raises(ValueError, match="one CUDA device"):
        vtrace_kernel.from_importance_weights(*args[:5], args[5].cpu())
    with pytest.raises(TypeError):
        vtrace_kernel.from_importance_weights(
            *args[:3], args[3].to(torch.int32), *args[4:])


def test_vtrace_train_step_runs_on_the_card(cuda):
    from seed_rl_torch import train

    vtrace_kernel.launches = 0
    learner, state, metrics = train.main([
        "--agent=vtrace", "--env=toy", "--num_envs=256",
        "--unroll_length=8", "--total_environment_frames=4096",
        "--steps_per_call=1", "--log_every_steps=1",
    ])
    assert state.step == 2 and vtrace_kernel.launches == 2
    assert all(math.isfinite(float(v)) for v in metrics.values())
    for t in learner.parameters() + learner.state_tensors(state):
        assert t.device.type == "cuda"
