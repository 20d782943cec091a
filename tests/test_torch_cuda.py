"""Tests of the port that need an NVIDIA card: the CUDA kernels themselves
and short training runs through them.

Marked ``cuda``; each skips where torch sees no CUDA device. This file
imports no JAX, so it also runs on a machine with the card and no JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import math

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from seed_rl_torch.ops import value_ops
from seed_rl_torch.ops import vtrace as plain
from seed_rl_torch.ops.cuda import nstep_kernel, vtrace_kernel

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-5, atol=1e-5)
# Shared memory one block may use on an H100.
BLOCK_SMEM_BYTES = 227 * 1024


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


# (T, B, lambda_, clip_rho_threshold, clip_pg_rho_threshold): the V-trace
# path's shape, the tests/test_pallas_vtrace.py cases, B off the kernel's
# 32-column tile, T = 1, and T across the kernel's 32-row chunks (with the
# clips off, and at B = 37 and 1).
VTRACE_CASES = [
    (32, 1024, 1.0, 1.0, 1.0),
    (12, 256, 0.95, 1.0, 1.0),
    (5, 128, 1.0, None, None),
    (7, 37, 0.9, 2.0, 0.5),
    (1, 1, 1.0, 1.0, 1.0),
    (200, 1000, 1.0, 1.0, 1.0),
    (70, 37, 0.9, None, None),
    (33, 1, 1.0, 1.0, 1.0),
]


@pytest.mark.parametrize("T,B,lam,clip_rho,clip_pg", VTRACE_CASES)
def test_vtrace_kernel_matches_plain(cuda, T, B, lam, clip_rho, clip_pg):
    args = _inputs(T, B, T + B, cuda)
    kwargs = dict(clip_rho_threshold=clip_rho,
                  clip_pg_rho_threshold=clip_pg, lambda_=lam)
    before = vtrace_kernel.launches
    got = vtrace_kernel.from_importance_weights(*args, **kwargs)
    want = plain.from_importance_weights(*args, **kwargs)
    torch.cuda.synchronize()
    assert vtrace_kernel.launches == before + 1
    assert vtrace_kernel.launch_shape(T, B).smem_bytes <= BLOCK_SMEM_BYTES
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


def _nstep_inputs(T, B, A, seed, device, done_dtype=torch.bool):
    rng = np.random.RandomState(seed)
    return dict(
        q_values=torch.tensor(rng.normal(size=(T, B, A)), dtype=torch.float32,
                              device=device),
        target_q_values=torch.tensor(rng.normal(size=(T, B, A)),
                                     dtype=torch.float32, device=device),
        online_argmax_action=torch.tensor(rng.randint(0, A, (T, B)),
                                          dtype=torch.int32, device=device),
        replay_action=torch.tensor(rng.randint(0, A, (T, B)),
                                   dtype=torch.int32, device=device),
        rewards=torch.tensor(rng.normal(size=(T, B)), dtype=torch.float32,
                             device=device),
        done=torch.tensor(rng.binomial(1, 0.1, (T, B)), dtype=done_dtype,
                          device=device),
    )


# (T, B, A, n_steps, gamma, eta): the R2D2 loss and insert shapes, the
# tests/test_pallas_nstep.py cases, n >= T with an odd B, T = 2, T - 1
# across the kernel's 128-row chunks, B off its 16-column tile, and n - 1
# past its 64-row staged halo.
NSTEP_CASES = [
    (81, 64, 4, 5, 0.997, 0.9),
    (81, 610, 4, 5, 0.997, 0.9),
    (11, 256, 6, 5, 0.997, 0.9),
    (7, 64, 4, 3, 0.99, 0.7),
    (3, 37, 4, 5, 0.997, 0.9),
    (2, 1, 4, 1, 0.997, 0.9),
    (300, 70, 4, 5, 0.997, 0.9),
    (81, 37, 4, 5, 0.997, 0.9),
    (40, 1, 3, 5, 0.99, 0.9),
    (6, 64, 4, 8, 0.99, 0.9),
    (300, 16, 4, 100, 0.997, 0.9),
]


@pytest.mark.parametrize("done_dtype", [torch.bool, torch.float32])
@pytest.mark.parametrize("T,B,A,n,gamma,eta", NSTEP_CASES)
def test_nstep_kernel_matches_plain(cuda, T, B, A, n, gamma, eta,
                                    done_dtype):
    kwargs = _nstep_inputs(T, B, A, T + B, cuda, done_dtype)
    q = kwargs.pop("q_values")
    q_kernel = q.clone().requires_grad_(True)
    q_plain = q.clone().requires_grad_(True)
    kw = dict(gamma=gamma, n_steps=n, eta=eta)
    before = nstep_kernel.launches
    loss, pri = nstep_kernel.td_loss_and_priorities(q_kernel, **kwargs, **kw)
    want_loss, want_pri = value_ops.td_loss_and_priorities(
        q_plain, **kwargs, **kw)
    torch.cuda.synchronize()
    assert nstep_kernel.launches == before + 1
    assert nstep_kernel.launch_shape(T, B, n).smem_bytes <= BLOCK_SMEM_BYTES
    torch.testing.assert_close(loss, want_loss, **TOL)
    torch.testing.assert_close(pri, want_pri, **TOL)
    (g_kernel,) = torch.autograd.grad(loss.sum(), q_kernel)
    (g_plain,) = torch.autograd.grad(want_loss.sum(), q_plain)
    torch.testing.assert_close(g_kernel, g_plain, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("launch_shape,want", [
    # The V-trace path, unroll 32 x 1024 envs: 32 blocks of 32 columns.
    (lambda: vtrace_kernel.launch_shape(32, 1024), (32, 256, 24_832)),
    # The R2D2 loss (unroll 80 + 1, batch 64) and insert (610 training
    # envs): blocks of 16 columns.
    (lambda: nstep_kernel.launch_shape(81, 64, 5), (4, 256, 21_888)),
    (lambda: nstep_kernel.launch_shape(81, 610, 5), (39, 256, 21_888)),
    # The largest plans, as the source notes state them.
    (lambda: vtrace_kernel.launch_shape(4096, 1), (1, 256, 45_312)),
    (lambda: nstep_kernel.launch_shape(4096, 1, 100), (1, 256, 42_560)),
])
def test_launch_shape_is_what_the_source_notes_state(cuda, launch_shape,
                                                     want):
    assert tuple(launch_shape()) == want


def test_nstep_kernel_refuses_what_it_does_not_take(cuda):
    kwargs = _nstep_inputs(4, 8, 3, 0, cuda)
    kw = dict(gamma=0.99, n_steps=2)
    with pytest.raises(ValueError, match="T >= 2"):
        nstep_kernel.td_loss_and_priorities(
            **{k: v[:1] for k, v in kwargs.items()}, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        strided = kwargs["rewards"].t().contiguous().t()
        nstep_kernel.td_loss_and_priorities(
            **dict(kwargs, rewards=strided), **kw)
    with pytest.raises(ValueError, match="one CUDA device"):
        nstep_kernel.td_loss_and_priorities(
            **dict(kwargs, rewards=kwargs["rewards"].cpu()), **kw)
    with pytest.raises(TypeError):
        nstep_kernel.td_loss_and_priorities(
            **dict(kwargs, rewards=kwargs["rewards"].to(torch.int32)), **kw)


def test_r2d2_train_step_runs_on_the_card(cuda):
    from seed_rl_torch import train

    nstep_kernel.launches = 0
    learner, state, metrics = train.main([
        "--agent=r2d2", "--env=discrete_match", "--num_envs=64",
        "--num_eval_envs=4", "--unroll_length=10", "--burn_in=4",
        "--batch_size=16", "--replay_buffer_size=256",
        "--replay_buffer_min_size=100", "--train_batches_per_step=2",
        "--total_environment_frames=1280", "--steps_per_call=1",
        "--log_every_steps=1",
    ])
    # 2 warmup rollouts, then 2 steps of 1 insert + 2 batches.
    assert state.step == 2 and nstep_kernel.launches == 2 + 2 * 3
    assert all(math.isfinite(float(v)) for v in metrics.values())
    tensors = (learner.parameters() + list(learner.target_net.parameters())
               + learner.state_tensors(state))
    for t in tensors:
        assert t.device.type == "cuda"


# The pool's input [N, C, H, W] at each stack of ImpalaDeep on 84x84
# frames: SAME pads (0, 1), (0, 1) and (1, 1).
POOL_SHAPES = [(8, 16, 84, 84), (8, 32, 42, 42), (8, 32, 21, 21)]


@pytest.mark.parametrize("memory_format",
                         [torch.contiguous_format, torch.channels_last])
@pytest.mark.parametrize("shape", POOL_SHAPES)
def test_pool_routes_ties_on_the_card_as_on_the_cpu(cuda, shape,
                                                    memory_format):
    from seed_rl_torch.ops.pooling import max_pool_same

    rng = np.random.RandomState(sum(shape))
    # A few levels, so most windows tie; cotangents on a 1/8 grid sum
    # exactly in any order, so only the routing is compared.
    x = torch.tensor(np.round(rng.normal(size=shape) * 2) / 2,
                     dtype=torch.float32)
    out_shape = shape[:2] + tuple(-(-n // 2) for n in shape[2:])
    ct = torch.tensor(np.round(rng.normal(size=out_shape) * 8) / 8,
                      dtype=torch.float32)
    results = []
    for device, fmt in (("cpu", torch.contiguous_format), (cuda, memory_format)):
        xd = x.to(device).to(memory_format=fmt).requires_grad_(True)
        out = max_pool_same(xd)
        (grad,) = torch.autograd.grad(out, xd, ct.to(device))
        results.append((out.detach().cpu(), grad.cpu()))
    (want_out, want_grad), (out, grad) = results
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    torch.testing.assert_close(grad, want_grad, rtol=0, atol=0)


def _pixel_net(kind, device):
    from seed_rl_torch.models import AtariPolicyNet, ImpalaDeep

    if kind == "atari":  # the CLI's net at full width
        return AtariPolicyNet(18, stack_size=4, lstm_size=256, seed=3,
                              device=device)
    return ImpalaDeep(18, (84, 84, 1), seed=3, device=device)


@pytest.mark.parametrize("kind", ["atari", "impala_deep"])
def test_pixel_nets_on_the_card_match_the_cpu(cuda, kind):
    """Full-width forward on the card vs the CPU, same weights (one seed).

    With TF32 off the card computes in f32 and differs only in summation
    order: rtol 1e-4 / atol 1e-5. With PyTorch's default, cuDNN runs the
    convolutions in TF32 (10-bit mantissa, ~5e-4 relative per product)
    through three conv layers (ImpalaDeep: fifteen): rtol = atol = 1e-2.
    """
    from seed_rl_torch.types import EnvOutput

    B, T = 8, 3
    rng = np.random.RandomState(4)
    eo = EnvOutput(
        reward=torch.tensor(rng.normal(size=(T, B)), dtype=torch.float32),
        done=torch.tensor(rng.uniform(size=(T, B)) < 0.3),
        observation=torch.tensor(rng.randint(0, 256, (T, B, 84, 84, 1)),
                                 dtype=torch.uint8),
        abandoned=torch.zeros(T, B, dtype=torch.bool),
        episode_step=torch.zeros(T, B, dtype=torch.int32),
    )
    prev = torch.tensor(rng.randint(0, 18, (T, B)), dtype=torch.int32)
    cpu_net, card_net = _pixel_net(kind, "cpu"), _pixel_net(kind, cuda)
    with torch.no_grad():
        want, want_state = cpu_net.unroll(prev, eo, cpu_net.initial_state(B))
        on_card = [x.to(cuda) for x in (prev, *eo)]
        card_eo = EnvOutput(*on_card[1:])
        tf32 = torch.backends.cudnn.allow_tf32
        for allow, tol in ((False, dict(rtol=1e-4, atol=1e-5)),
                           (tf32, dict(rtol=1e-2, atol=1e-2))):
            torch.backends.cudnn.allow_tf32 = allow
            try:
                got, state = card_net.unroll(on_card[0], card_eo,
                                             card_net.initial_state(B))
            finally:
                torch.backends.cudnn.allow_tf32 = tf32
            for g, w in zip(got, want):
                torch.testing.assert_close(g.cpu(), w, **tol)
            for g, w in zip(pytree.tree_leaves(state),
                            pytree.tree_leaves(want_state)):
                torch.testing.assert_close(g.cpu(), w, **tol)


@pytest.mark.parametrize("argv", [
    ["--env=catch"],
    ["--env=synthetic_atari"],
    ["--env=catch", "--conv_net=impala_deep", "--remat_torso"],
    ["--env=synthetic_atari", "--conv_net=impala_deep", "--remat_torso"],
])
def test_pixel_vtrace_launches_the_kernel_once_per_step(cuda, argv):
    from seed_rl_torch import train

    vtrace_kernel.launches = 0
    learner, state, metrics = train.main([
        "--agent=vtrace", *argv, "--num_envs=64", "--unroll_length=8",
        "--total_environment_frames=1024", "--steps_per_call=1",
        "--log_every_steps=1",
    ])
    assert state.step == 2 and vtrace_kernel.launches == 2
    assert all(math.isfinite(float(v)) for v in metrics.values())
    for t in learner.parameters() + learner.state_tensors(state):
        assert t.device.type == "cuda"
