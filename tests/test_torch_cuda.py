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
from seed_rl_torch.ops.cuda import nstep_kernel, run_count, vtrace_kernel

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
    before = run_count.read(vtrace_kernel.KERNEL_NAME)
    got = vtrace_kernel.from_importance_weights(*args, **kwargs)
    want = plain.from_importance_weights(*args, **kwargs)
    torch.cuda.synchronize()
    assert run_count.read(vtrace_kernel.KERNEL_NAME) == before + 1
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

    run_count.reset()
    learner, state, metrics = train.main([
        "--agent=vtrace", "--env=toy", "--num_envs=256",
        "--unroll_length=8", "--total_environment_frames=4096",
        "--steps_per_call=1", "--log_every_steps=1",
    ])
    assert state.step == 2 and run_count.read(vtrace_kernel.KERNEL_NAME) == 2
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
    before = run_count.read(nstep_kernel.KERNEL_NAME)
    loss, pri = nstep_kernel.td_loss_and_priorities(q_kernel, **kwargs, **kw)
    want_loss, want_pri = value_ops.td_loss_and_priorities(
        q_plain, **kwargs, **kw)
    torch.cuda.synchronize()
    assert run_count.read(nstep_kernel.KERNEL_NAME) == before + 1
    assert nstep_kernel.launch_shape(T, B, n).smem_bytes <= BLOCK_SMEM_BYTES
    torch.testing.assert_close(loss, want_loss, **TOL)
    torch.testing.assert_close(pri, want_pri, **TOL)
    (g_kernel,) = torch.autograd.grad(loss.sum(), q_kernel)
    (g_plain,) = torch.autograd.grad(want_loss.sum(), q_plain)
    torch.testing.assert_close(g_kernel, g_plain, rtol=1e-3, atol=1e-4)


def _vtrace_call(device):
    args = _inputs(33, 64, 5, device)
    return vtrace_kernel.KERNEL_NAME, lambda: tuple(
        vtrace_kernel.from_importance_weights(*args))


def _nstep_call(device):
    kwargs = _nstep_inputs(11, 64, 4, 5, device, torch.bool)
    return nstep_kernel.KERNEL_NAME, lambda: (
        nstep_kernel.td_loss_and_priorities(**kwargs, gamma=0.997,
                                            n_steps=5))


@pytest.mark.parametrize("call", [_vtrace_call, _nstep_call],
                         ids=["vtrace", "nstep"])
def test_nstep_kernel_counts_each_replay_of_a_captured_launch(cuda, call):
    # The host makes one launch, at the capture; the card counts the eager
    # call and each replay, for B1 and B2 alike.
    kernel, fn = call(cuda)
    want = fn()
    runs = run_count.read(kernel)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fn()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert run_count.read(kernel) == runs + 3
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    run_count.reset()
    graph.replay()
    assert run_count.read(kernel) == 1


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

    run_count.reset()
    learner, state, metrics = train.main([
        "--agent=r2d2", "--env=discrete_match", "--num_envs=64",
        "--num_eval_envs=4", "--unroll_length=10", "--burn_in=4",
        "--batch_size=16", "--replay_buffer_size=256",
        "--replay_buffer_min_size=100", "--train_batches_per_step=2",
        "--total_environment_frames=1280", "--steps_per_call=1",
        "--log_every_steps=1",
    ])
    # 2 warmup rollouts, then 2 steps of 1 insert + 2 batches (counted on
    # the card: the update's graph replays B2).
    assert state.step == 2 and run_count.read(nstep_kernel.KERNEL_NAME) == 2 + 2 * 3
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

    run_count.reset()
    learner, state, metrics = train.main([
        "--agent=vtrace", *argv, "--num_envs=64", "--unroll_length=8",
        "--total_environment_frames=1024", "--steps_per_call=1",
        "--log_every_steps=1",
    ])
    assert state.step == 2 and run_count.read(vtrace_kernel.KERNEL_NAME) == 2
    assert all(math.isfinite(float(v)) for v in metrics.values())
    for t in learner.parameters() + learner.state_tensors(state):
        assert t.device.type == "cuda"


def test_dueling_lstm_dqn_net_on_the_card_matches_the_cpu(cuda):
    """DuelingLSTMDQNNet at full width (LSTM 512, 18 actions) on the card vs
    the CPU, same weights, at the tolerances of the pixel nets above."""
    from seed_rl_torch.models import DuelingLSTMDQNNet
    from seed_rl_torch.types import EnvOutput

    B, T = 8, 3
    rng = np.random.RandomState(5)
    eo = EnvOutput(
        reward=torch.tensor(rng.normal(size=(T, B)), dtype=torch.float32),
        done=torch.tensor(rng.uniform(size=(T, B)) < 0.3),
        observation=torch.tensor(rng.randint(0, 256, (T, B, 84, 84, 1)),
                                 dtype=torch.uint8),
        abandoned=torch.zeros(T, B, dtype=torch.bool),
        episode_step=torch.zeros(T, B, dtype=torch.int32),
    )
    prev = torch.tensor(rng.randint(0, 18, (T, B)), dtype=torch.int32)
    cpu_net = DuelingLSTMDQNNet(18, seed=3, device="cpu")
    card_net = DuelingLSTMDQNNet(18, seed=3, device=cuda)
    with torch.no_grad():
        want, want_state = cpu_net.unroll(prev, eo, cpu_net.initial_state(B))
        card_eo = EnvOutput(*(x.to(cuda) for x in eo))
        tf32 = torch.backends.cudnn.allow_tf32
        for allow, tol in ((False, dict(rtol=1e-4, atol=1e-5)),
                           (tf32, dict(rtol=1e-2, atol=1e-2))):
            torch.backends.cudnn.allow_tf32 = allow
            try:
                got, state = card_net.unroll(prev.to(cuda), card_eo,
                                             card_net.initial_state(B))
            finally:
                torch.backends.cudnn.allow_tf32 = tf32
            torch.testing.assert_close(got.q_values.cpu(), want.q_values,
                                       **tol)
            for g, w in zip(pytree.tree_leaves(state),
                            pytree.tree_leaves(want_state)):
                torch.testing.assert_close(g.cpu(), w, **tol)
            if not allow:  # in f32 the greedy actions agree too
                assert torch.equal(got.action.cpu(), want.action)


@pytest.mark.parametrize("env", ["catch", "synthetic_atari"])
def test_r2d2_from_pixels_launches_the_kernel_per_insert_and_batch(cuda,
                                                                  env):
    from seed_rl_torch import train
    from seed_rl_torch.models import DuelingLSTMDQNNet

    run_count.reset()
    learner, state, metrics = train.main([
        "--agent=r2d2", f"--env={env}", "--num_envs=16", "--num_eval_envs=2",
        "--unroll_length=10", "--burn_in=4", "--batch_size=8",
        "--replay_buffer_size=64", "--replay_buffer_min_size=28",
        "--train_batches_per_step=2", "--total_environment_frames=320",
        "--steps_per_call=1", "--log_every_steps=1",
    ])
    # 2 warmup inserts of 14 training envs, then 2 steps of 1 insert + 2
    # batches, counted on the card.
    assert isinstance(learner.net, DuelingLSTMDQNNet)
    assert state.step == 2 and run_count.read(nstep_kernel.KERNEL_NAME) == 2 + 2 * 3
    assert all(math.isfinite(float(v)) for v in metrics.values())
    tensors = (learner.parameters() + list(learner.target_net.parameters())
               + learner.state_tensors(state))
    for t in tensors:
        assert t.device.type == "cuda"


def _ppo_learner(kind, device):
    """A one-minibatch PPO learner around the CLI's net for ``kind``, with
    the same weights on every device."""
    import functools

    from seed_rl_torch import distributions as pd
    from seed_rl_torch import optim
    from seed_rl_torch.agent import PolicyAgent
    from seed_rl_torch.agents.ppo import learner as ppo, policy_losses
    from seed_rl_torch.agents.ppo.continuous_control_agent import (
        ContinuousControlNet,
        NormalizingPolicyAgent,
    )
    from seed_rl_torch.agents.ppo.generalized_onpolicy_loss import (
        GeneralizedOnPolicyLoss,
    )
    from seed_rl_torch.agents.ppo.input_normalization import (
        InputNormalization,
    )
    from seed_rl_torch.agents.ppo.policy_regularizers import (
        KLPolicyRegularizer,
    )
    from seed_rl_torch.envs import BatchedEnv, SyntheticAtariEnv, ToyEnv
    from seed_rl_torch.models import AtariPolicyNet
    from seed_rl_torch.ops.advantages import GAE
    from seed_rl_torch.ops.popart import PopArt
    from seed_rl_torch.ops.running_statistics import AverageMeanStd
    from seed_rl_torch.rollout import RolloutEngine

    if kind == "continuous":
        env = BatchedEnv(ToyEnv(), 16, device=device)
        dist = pd.get_parametric_distribution_for_action_space(
            env.action_space,
            pd.continuous_action_config(action_gaussian_std_fn="safe_exp"))
        net = ContinuousControlNet(
            dist.param_size, 4, num_layers_policy=2, num_layers_value=2,
            num_units_policy=64, num_units_value=64, activation=torch.tanh,
            kernel_init_gain=2 ** 0.5, last_kernel_init_policy_gain=0.01,
            last_kernel_init_value_gain=1.0, std_independent_of_input=True,
            seed=4, device=device)
        agent = NormalizingPolicyAgent(
            net, dist, InputNormalization(AverageMeanStd(), 4), 10.0)
        mode = "split"
    else:
        env = BatchedEnv(SyntheticAtariEnv(), 8, device=device)
        dist = pd.get_parametric_distribution_for_action_space(
            env.action_space)
        net = AtariPolicyNet(dist.param_size, stack_size=4, lstm_size=256,
                             seed=4, device=device)
        agent = PolicyAgent(net, dist)
        mode = "shuffle"
    loss = GeneralizedOnPolicyLoss(
        agent=agent, reward_normalizer=PopArt(AverageMeanStd(), False),
        parametric_action_distribution=dist,
        advantage_estimator=GAE(lambda_=0.95),
        policy_loss=policy_losses.ppo(0.2), discount_factor=0.99,
        regularizer=KLPolicyRegularizer(entropy=0.01), baseline_cost=1.0)
    return ppo.PPOLearner(
        RolloutEngine(env, agent, 6), agent, loss,
        ppo.PPOConfig(epochs_per_step=1, batch_mode=mode,
                      batches_per_step=1),
        functools.partial(optim.ClippedAdam, learning_rate=1e-4,
                          clip_norm=0.5))


@pytest.mark.parametrize("kind", ["continuous", "atari"])
def test_ppo_minibatch_step_on_the_card_matches_the_cpu(cuda, kind):
    """One PPO minibatch step (the CLI's net for a continuous and a pixel
    env) on the card vs the CPU on one unroll, with the permutation and the
    entropy noise injected and TF32 off: logs within rtol 1e-4 / atol 1e-5
    (sums in another order), parameters after the Adam step within rtol
    1e-3 / atol 1e-4 (a gradient element near Adam's eps turns a summation
    difference into a share of the learning rate)."""
    cpu, card = _ppo_learner(kind, "cpu"), _ppo_learner(kind, cuda)
    _, unroll = cpu.engine.rollout(cpu.engine.init())
    batch = unroll.timesteps.env_output.reward.shape[1]
    T = unroll.timesteps.env_output.reward.shape[0] - 1
    mb = T * batch if kind == "continuous" else batch
    perm = torch.randperm(mb, generator=torch.Generator().manual_seed(0))
    noise_shape = (1, mb, 3) if kind == "continuous" else None
    noise = (torch.randn(noise_shape,
                         generator=torch.Generator().manual_seed(1))
             if noise_shape else None)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        results = []
        for learner, device in ((cpu, "cpu"), (card, cuda)):
            on = pytree.tree_map(lambda t: t.to(device), unroll)
            state, logs = learner.update(
                learner.init(), on, permutations=[perm.to(device)],
                entropy_noise=[None if noise is None else noise.to(device)])
            results.append((logs, learner.parameters()))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (want_logs, want_params), (logs, params) = results
    assert card.optimizer.count == 1
    for k in want_logs:
        torch.testing.assert_close(logs[k].cpu(), want_logs[k], rtol=1e-4,
                                   atol=1e-5, msg=k)
    for got, want in zip(params, want_params):
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.detach().cpu(), want.detach(),
                                   rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("argv,net", [
    (["--env=toy"], "ActorCriticMLP"),
    (["--env=bit_flipping", "--sac_net=lstm", "--her_window_length=4",
      "--normalize_observations"], "ActorCriticLSTM"),
    (["--env=catch_continuous", "--bootstrap_net=q"], "VisualActorCritic"),
])
def test_sac_train_step_runs_on_the_card(cuda, argv, net):
    """One SAC train step per net through the CLI, on the card by default:
    every tensor on the card, finite metrics, one update and one polyak
    move a step, and no hand kernel launched (SAC's path has none)."""
    from seed_rl_torch import train

    run_count.reset()
    learner, state, metrics = train.main([
        "--agent=sac", "--num_envs=16", "--unroll_length=2",
        "--batch_size=32", "--replay_buffer_size=256",
        "--replay_buffer_min_size=32", "--total_environment_frames=32",
        "--steps_per_call=1", "--log_every_steps=1", *argv,
    ])
    assert type(learner.net).__name__ == net
    assert state.step == 1 and state.batches == 1
    assert learner.optimizer.count == 1
    assert run_count.read(vtrace_kernel.KERNEL_NAME) == 0
    assert run_count.read(nstep_kernel.KERNEL_NAME) == 0
    assert all(math.isfinite(float(v)) for v in metrics.values())
    for t in learner.parameters() + learner.state_tensors(state):
        assert t.device.type == "cuda"
