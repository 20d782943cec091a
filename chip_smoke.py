"""Smoke test of the PyTorch port (seed_rl_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. print the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build every CUDA kernel from seed_rl_torch/csrc, one nvcc each, all
     started together (vtrace_kernel, nstep_kernel);
  3. hold each kernel against its plain PyTorch version on the card, and
     print its launch (blocks, threads, rows per chunk, shared memory per
     block, at most 227 KB): V-trace at 9 shapes, the n-step targets and
     priorities at 11, each with done as bool and as f32 (loss,
     priorities within rtol = atol = 1e-5, and the gradient of the summed
     loss in the Q values within rtol 1e-3 / atol 1e-4); then the SAME max
     pool of ImpalaDeep's three stacks (PyTorch's own max_pool2d, no kernel
     of the port): on inputs quantised to a few levels, so that windows
     tie, its values and gradient on the card must equal the CPU's exactly,
     in NCHW and channels_last;
  4. time each kernel and its plain version with CUDA events at the main
     path's shapes, its device-only time with torch.profiler, beside the
     least time the card could take for the same work and the device time
     of an empty kernel (the launch floor); the first, row-serial design's
     device time, from an earlier run of this script, is printed beside it
     for comparison;
  5. train V-trace on the toy env through seed_rl_torch.train.main at the
     default MLPAndLSTM width (num_envs=1024, unroll_length=32), with the
     launch counts reset just before; check one V-trace launch per train
     step, everything on the card, finite metrics, and the kernel against
     its plain version on the run's own unroll; time the step, its rollout
     and update halves, its device busy time, launches and idle share
     (torch.profiler), and print the peak device memory;
  6. train R2D2 on discrete_match through seed_rl_torch.train.main at the
     default VectorDuelingDQNNet width with the reference Atari R2D2 knobs
     (640 envs, 30 of them eval, unroll 80, burn-in 40, batch 64, n 5,
     gamma 0.997, lr 1e-4, clip 80, a 10k-unroll replay): 2 warmup
     rollouts, then 4 train steps, with the n-step launch count reset just
     before; check one launch per insert and per train batch, everything
     on the card, finite metrics, and the kernel against its plain version
     on the run's own sampled batch (loss and priorities, and the gradient
     of the summed loss in the Q values); time the step and its halves;
  7. V-trace from pixels at full width, as phase 5: synthetic Atari frames
     (84x84x1 uint8, 18 actions) with AtariPolicyNet (4 stacked frames,
     LSTM 256) at 1024 envs x unroll 32, bench.py's vtrace_atari shape;
  8. V-trace on Catch frames with --conv_net=impala_deep (ImpalaDeep, LSTM
     256) at 256 envs x unroll 20, the README's Catch quick-start shape, as
     phase 5; then a deterministic evaluation of the trained policy over at
     least 256 episodes on the card, twice from one seed: the two results
     must be equal;
  9. R2D2 from pixels, as phase 6 with the same knobs and a 10k-unroll
     replay of frames: synthetic Atari frames (84x84x1 uint8, 18 actions)
     with DuelingLSTMDQNNet (4 stacked frames, LSTM 512), f32; the replay's
     size is printed;
 10. PPO on the toy env with the reference HalfCheetah PPO knobs: 128 envs
     x unroll 16, split, 10 epochs x 32 minibatches, lr 3e-4, clip 0.5, the
     CLI's 2x64 tanh ContinuousControlNet behind observation normalization;
     checks 320 optimizer updates and 17 x 128 observations folded into the
     statistics per train step, everything on the card, finite metrics;
     times the step, its rollout and update halves, the device busy time,
     launches and idle share, and prints the peak memory;
 11. PPO from pixels, as phase 10: synthetic Atari frames with
     AtariPolicyNet (LSTM 256), 512 envs x unroll 32, shuffle, 2 epochs x
     8 minibatches, entropy cost 0.01 (bench.py's ppo_atari shape);
 12. SAC from frames at bench.py's bench_sac_visual shape: ContinuousCatch
     (84x84x1 uint8 frames, a Box(1) paddle velocity), 512 envs x unroll
     2, batch 1024, a 16384-unroll replay of frames, polyak 0.995, lr
     3e-4, clip 40, one batch a step (the CLI's), VisualActorCritic at its
     full width (Nature torso, heads of 256, 2 critics), f32; checks one
     optimizer update and one polyak move per train step, everything on
     the card, finite metrics and alpha inside its clip, then holds the
     loss, its metrics and its gradients on the card against the same
     code on the CPU on a batch sampled from the run's replay (TF32 off,
     the loss's noise injected); times the step and its halves (rollout +
     insert, train batch), profiles one step, prints the replay's size,
     the peak memory and the path's seconds;
 13. recurrent SAC with HER, as phase 12: bit_flipping (dict
     observations), ActorCriticLSTM (LSTM 256, MLPs of 256, 4 nets, the
     desired goal withheld from the LSTMs), HER windows of 16 cut to
     unrolls of 2, 256 envs, batch 256, a 4096-window replay;
 14. checkpoints, logs, export and the eval and profile run modes, each
     path through seed_rl_torch.train.main into a temporary --logdir, the
     launch counts reset just before each call:
     (a) V-trace on synthetic Atari frames with AtariPolicyNet at 1024 envs
         x unroll 32 (phase 7's shape): 2 steps with a checkpoint after
         each (--save_checkpoint_secs=0), whose file, loaded back, must
         equal the run's final state bitwise (every tensor of the net, the
         optimizer, the rollout, the statistics and the generators); a
         second call on the logdir with a 4-step budget must resume at step
         2 and train exactly 2 more, with 2 V-trace launches; the event
         file must hold scalar records; --run_mode=eval must print
         eval/restored_step 4 over at least --eval_episodes episodes;
         --run_mode=profile --profile_calls=2 must write its trace (3
         V-trace launches: a warm call and 2 traced ones); then the trained
         agent is exported with export_policy on the card and loaded back
         with load_policy: on the rollout's own env_output, its actions
         must equal policy_step(deterministic=True)'s and its new state be
         within 1e-5;
     (b) R2D2 on discrete_match at phase 6's knobs: 2 warm-ups and 2 steps,
         then a resume for 2 more: the replay restored (items, priorities,
         num_inserted, cursors) must equal the saved one bitwise, no
         warm-up may run after the restore, and the n-step launches must
         be the inserts and batches after it (4); then --run_mode=eval with
         the greedy step;
     (c) PPO on the toy env at phase 10's knobs, 2 steps with
         --num_checkpoints=2 --num_saved_models=2 --num_snapshots=2: 2
         checkpoint saves at their marks, 2 saved models and 2 snapshots;
         the last saved model, loaded back, must give the agent's
         deterministic actions (its input statistics inside the program)
         within 1e-5;
     (d) SAC on catch_continuous with VisualActorCritic at phase 12's
         knobs: the 16384-unroll replay of frames checkpointed and resumed,
         checked as in (b); then --run_mode=eval with the mode action.
     Each path prints the checkpoint's size on disk, the save and restore
     seconds, the export and load seconds and its own seconds, beside the
     card's name and power limit;
 15. the host data paths (host-process envs, policy steps on the card),
     each through seed_rl_torch.train.main on synthetic_atari_host (numpy
     envs on a thread pool), the launch counts reset just before each call:
     (a) R2D2 at phase 6's knobs with DuelingLSTMDQNNet (LSTM 512), the
         replay in host RAM (phase 9's 10k unrolls, or the largest multiple
         of 1000 that fits a quarter of MemAvailable), --replay_ratio=0.75:
         4 cycles, the first only filling the replay, plain and then with
         --pipeline_host_rollouts; the batches of each cycle must be the
         owed formula's, B2 launched once per insert and per batch, the
         written-back priorities finite, the learner on the card, and B2
         equal to its plain version on a batch of the run's own replay;
     (b) V-trace with AtariPolicyNet at phase 7's shape, 3 steps plain (one
         B1 launch each, B1 against its plain version on the run's last
         unroll) and 3 pipelined (4 launches: the last unroll is trained
         on), then --run_mode=eval on 32 host envs from the plain run's
         parameters, twice: the two results must be equal;
     (c) PPO with AtariPolicyNet at phase 11's knobs, 2 steps;
     (d) SAC through host_offpolicy_loop on HostToyEnv (this script's numpy
         toy env, Box actions), ActorCriticMLP (256, 256), replay ratio 4,
         3 cycles;
     (e) (a)'s path with --logdir --checkpoint_replay: 2 cycles, then a
         resumed call of 2: the restored learner state and replay must
         equal the saved ones bitwise; the replay's GB and its save and
         restore seconds are printed.
     Each path prints its cycle's ms split into host env stepping, policy
     steps, copies, items, insert, sample wait and train ms per batch,
     env frames/s, launches per cycle, the device idle share over one
     profiled cycle, peak device memory and process RSS;
 16. print the V-trace and n-step launches of each path, and the kernels
     line (JSON): for each kernel, at its main-path shape, the wrapper's ms
     per call, the kernel's device-only ms, the plain version's ms, the
     bound and the launch floor (the V-trace kernel: [32, 1024], and the
     Catch path's [20, 256] under "catch"; the n-step kernel: the loss
     shape, and the insert shape under "insert"); V-trace's launches are
     those of all three V-trace paths and of phases 14's and 15's, the
     n-step kernel's those of both R2D2 paths and of phases 14's and 15's.
     The PPO and SAC paths launch neither kernel: the PPO advantage
     estimators are plain PyTorch and SAC has no recursion over time, as
     in the JAX package.
The TF32 settings of convolutions and matrix products are printed once;
the script and the port leave PyTorch's defaults as they are.
The last line of standard output is the device JSON:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

It exits non-zero and prints no result where torch sees no CUDA device, or
where the seed_rl_torch package is absent.
"""

import glob
import json
import math
import os
import struct
import subprocess
import sys
import tempfile
import threading
import time

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

# H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# Shared memory one block may use on an H100.
BLOCK_SMEM_BYTES = 227 * 1024

VTRACE_TOL = 1e-5
# (T, B, lambda_, clip_rho_threshold, clip_pg_rho_threshold)
VTRACE_CASES = (
    (32, 1024, 1.0, 1.0, 1.0),  # the main path below: unroll 32, 1024 envs
    (10, 64, 1.0, 1.0, 1.0),  # the README quick-start shape
    (12, 256, 0.95, 1.0, 1.0),
    (5, 128, 1.0, None, None),
    (1, 37, 1.0, 1.0, 1.0),
    (20, 256, 1.0, 1.0, 1.0),  # the Catch path: unroll 20, 256 envs
    # T across the kernel's 32-row chunks, also with the clips off and at
    # B off its 32-column tile.
    (200, 1000, 1.0, 1.0, 1.0),
    (70, 37, 0.9, None, None),
    (33, 1, 1.0, 1.0, 1.0),
)
# Arithmetic of one [t, b] element in csrc/vtrace_kernel.cu (exp counted
# as one): log-ratio, exp, 3 clips, lambda, delta 4, recursion 3, vs 1,
# pg advantage 4.
VTRACE_OPS_PER_ELEMENT = 18



class VTracePath(NamedTuple):
    """One V-trace path driven through seed_rl_torch.train.main."""

    flags: Tuple[str, ...]  # besides the agent, sizes, budget and logging
    envs: int
    unroll: int
    steps: int  # train steps inside train.main
    timed_steps: int  # steps per timed loop afterwards
    net: str  # as printed


VTRACE_PATHS = {
    "toy": VTracePath(("--env=toy",), 1024, 32, 4, 10,
                      "MLPAndLSTM (64,64)+(64,)"),
    "synthetic_atari": VTracePath(
        ("--env=synthetic_atari",), 1024, 32, 4, 5,
        "AtariPolicyNet, 4 stacked 84x84 frames, LSTM 256, 18 actions"),
    "catch_impala_deep": VTracePath(
        ("--env=catch", "--conv_net=impala_deep", "--entropy_cost=0.01",
         "--learning_rate=1e-3"), 256, 20, 4, 5,
        "ImpalaDeep, 84x84x1 frames, LSTM 256, 3 actions"),
}
# The V-trace kernel's shapes [T, B] on those paths (phase 4 times both).
VTRACE_MAIN_SHAPE, VTRACE_CATCH_SHAPE = (32, 1024), (20, 256)
EVAL_EPISODES = 256

# Phase 3: the pool's input [N, C, H, W] at each stack of ImpalaDeep on
# 84x84 frames: SAME pads (0, 1), (0, 1) and (1, 1).
POOL_SHAPES = ((64, 16, 84, 84), (64, 32, 42, 42), (64, 32, 21, 21))

NSTEP_TOL = 1e-5
NSTEP_GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
# (T, B, A, n_steps, gamma, eta): the R2D2 loss shape (unroll 80 + 1 after
# the burn-in, batch 64), the insert shape (610 training envs), the
# tests/test_pallas_nstep.py cases, n >= T with an odd B, T = 2, T - 1
# across the kernel's 128-row chunks, B off its 16-column tile, and n - 1
# past its 64-row staged halo.
NSTEP_LOSS_SHAPE, NSTEP_INSERT_SHAPE = (81, 64), (81, 610)
NSTEP_CASES = (
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
)
# Arithmetic of one [t, b] element in csrc/nstep_kernel.cu (sqrt and
# division counted as one): h^-1 11, the n-step nesting 3 per step (n = 5),
# h 7, |TD|, max and sum 4.
NSTEP_OPS_PER_ELEMENT = 11 + 3 * 5 + 7 + 4

R2D2_ENVS, R2D2_EVAL_ENVS, R2D2_UNROLL, R2D2_BURN_IN = 640, 30, 80, 40
R2D2_WARMUPS, R2D2_STEPS, R2D2_BATCHES_PER_STEP = 2, 4, 1
R2D2_REPLAY = 10_000  # unrolls
# The R2D2 paths (phases 6 and 9): env -> the net, as printed.
R2D2_PATHS = {
    "discrete_match": "VectorDuelingDQNNet (64,)+64+64",
    "synthetic_atari": "DuelingLSTMDQNNet, 4 stacked 84x84 frames, LSTM "
                       "512, 18 actions",
}
R2D2_TIMED_STEPS = 5


def _r2d2_argv(env):
    return [
        "--agent=r2d2", f"--env={env}",
        f"--num_envs={R2D2_ENVS}", f"--num_eval_envs={R2D2_EVAL_ENVS}",
        f"--unroll_length={R2D2_UNROLL}", f"--burn_in={R2D2_BURN_IN}",
        "--batch_size=64", "--n_steps=5", "--discounting=0.997",
        "--learning_rate=1e-4", "--clip_norm=80",
        f"--replay_buffer_size={R2D2_REPLAY}",
        "--replay_buffer_min_size="
        f"{R2D2_WARMUPS * (R2D2_ENVS - R2D2_EVAL_ENVS)}",
        f"--total_environment_frames={R2D2_STEPS * R2D2_ENVS * R2D2_UNROLL}",
        f"--train_batches_per_step={R2D2_BATCHES_PER_STEP}",
        "--steps_per_call=1", "--log_every_steps=1",
    ]


class PPOPath(NamedTuple):
    """One PPO path driven through seed_rl_torch.train.main."""

    flags: Tuple[str, ...]  # besides the agent, sizes, budget and logging
    envs: int
    unroll: int
    epochs: int
    minibatches: int
    net: str  # as printed


PPO_PATHS = {
    # scripts/reference_configs/train_mujoco_ppo.sh:17-21 on the toy env.
    "ppo_toy": PPOPath(
        ("--env=toy", "--batch_mode=split", "--learning_rate=3e-4",
         "--clip_norm=0.5"), 128, 16, 10, 32,
        "ContinuousControlNet 2x64 tanh, free std, input normalization"),
    # bench.py's ppo_atari shape.
    "ppo_synthetic_atari": PPOPath(
        ("--env=synthetic_atari", "--batch_mode=shuffle",
         "--ppo_entropy_cost=0.01", "--learning_rate=3e-4",
         "--clip_norm=0.5"), 512, 32, 2, 8,
        "AtariPolicyNet, 4 stacked 84x84 frames, LSTM 256, 18 actions"),
}
# Train steps inside train.main, and timed afterwards, on both PPO paths.
PPO_STEPS, PPO_TIMED_STEPS = 2, 2


class SACPath(NamedTuple):
    """One SAC path driven through seed_rl_torch.train.main."""

    flags: Tuple[str, ...]  # besides the agent, envs, budget and logging
    envs: int
    rollout: int  # steps a rollout: the unroll, or the HER window
    net: str  # as printed


SAC_PATHS = {
    # bench.py:500-516 (bench_sac_visual) at the CLI's one batch a step.
    "sac_catch_continuous": SACPath(
        ("--env=catch_continuous", "--unroll_length=2", "--batch_size=1024",
         "--replay_buffer_size=16384", "--replay_buffer_min_size=512",
         "--polyak=0.995", "--learning_rate=3e-4", "--clip_norm=40"),
        512, 2, "VisualActorCritic, Nature torso, heads (256,), 2 critics, "
        "84x84x1 frames"),
    "sac_bit_flipping_her": SACPath(
        ("--env=bit_flipping", "--sac_net=lstm", "--her_window_length=16",
         "--unroll_length=2", "--batch_size=256",
         "--replay_buffer_size=4096", "--replay_buffer_min_size=256"),
        256, 16, "ActorCriticLSTM, LSTM 256, MLPs (256,), 4 nets, HER "
        "windows of 16 cut to unrolls of 2"),
}
# Train steps inside train.main, and timed afterwards, on both SAC paths;
# the batch of the card-vs-CPU loss check.
SAC_STEPS, SAC_TIMED_STEPS, SAC_CHECK_BATCH = 3, 5, 32
# The card's loss and metrics against the CPU's; the gradients at rtol
# 1e-3: cuDNN and cuBLAS reduce over the batch in another order, and a
# gradient element that is a difference of near-equal sums keeps the
# absolute error of the sums, not their relative one.
SAC_TOL = dict(rtol=1e-4, atol=1e-5)
SAC_GRAD_TOL = dict(rtol=1e-3, atol=1e-5)

# Phase 14: train steps before the checkpoint, the budget of the resumed
# call (in steps), the traced calls of --run_mode=profile, and the
# tolerance of an exported policy's new state against the agent's (and of
# its continuous actions; discrete ones must be equal).
CKPT_STEPS, RESUME_STEPS, PROFILE_CALLS = 2, 4, 2
EXPORT_TOL = 1e-5
CKPT_EVAL_EPISODES = 32  # the CLI's default

# Device time (torch.profiler, 20 launches) of each kernel's first design,
# one thread per column walking every row in series, as this script
# measured it in its last run with that design on an NVIDIA H100 80GB HBM3
# at its 700 W power limit. That design is no longer in the tree: phase 4
# prints these beside the current design's times, marked as not measured
# in this run, and the kernels line leaves them out.
FIRST_DESIGN_DEVICE_MS = {"vtrace": 0.009692, "nstep loss": 0.072696,
                          "nstep insert": 0.078411}


def _vtrace_inputs(T, B, seed, device):
    rng = np.random.RandomState(seed)
    arrays = [
        rng.uniform(-1, 1, (T, B)),  # target log-probs
        rng.uniform(-1, 1, (T, B)),  # behaviour log-probs
        rng.binomial(1, 0.9, (T, B)) * 0.99,  # discounts
        rng.normal(size=(T, B)),  # rewards
        rng.normal(size=(T, B)),  # values
        rng.normal(size=(B,)),  # bootstrap
    ]
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in arrays]


def _vtrace_bound_ms(T, B):
    bytes_moved = ((5 * T + 1) * B + 2 * T * B) * 4
    ops = VTRACE_OPS_PER_ELEMENT * T * B
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_FLOPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else
                                   "operations")


def _cuda_ms(fn, iters, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _nstep_inputs(T, B, A, seed, device, done_dtype=torch.bool):
    rng = np.random.RandomState(seed)

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    def i32(a):
        return torch.tensor(a, dtype=torch.int32, device=device)

    return dict(
        q_values=f32(rng.normal(size=(T, B, A))),
        target_q_values=f32(rng.normal(size=(T, B, A))),
        online_argmax_action=i32(rng.randint(0, A, (T, B))),
        replay_action=i32(rng.randint(0, A, (T, B))),
        rewards=f32(rng.normal(size=(T, B))),
        done=torch.tensor(rng.binomial(1, 0.1, (T, B)), dtype=done_dtype,
                          device=device),
    )


def _nstep_bound_ms(T, B, done):
    # Three [T, B] f32 inputs and done (1 byte an element as bool, 4 as f32)
    # read, [T-1, B] targets and [B] priorities written.
    bytes_moved = ((3 * 4 + done.element_size()) * T * B
                   + ((T - 1) * B + B) * 4)
    ops = NSTEP_OPS_PER_ELEMENT * T * B
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_FLOPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else
                                   "operations")


def _nstep_compare(kernel_args, plain_args, kw, what):
    """Kernel vs plain on one input set: returns (max |err| of loss and
    priorities, kernel outputs, plain outputs); raises beyond the
    tolerance."""
    from seed_rl_torch.ops import value_ops
    from seed_rl_torch.ops.cuda import nstep_kernel

    got = nstep_kernel.td_loss_and_priorities(*kernel_args, **kw)
    want = value_ops.td_loss_and_priorities(*plain_args, **kw)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, w in zip(("loss", "priorities"), got, want):
        torch.testing.assert_close(g, w, rtol=NSTEP_TOL, atol=NSTEP_TOL)
        e = float((g - w).detach().abs().max())
        err = max(err, e)
        print(f"nstep {what}: {name} max|err|={e:.3e} (tol {NSTEP_TOL})")
    return err, got, want


def check_nstep_kernel(device):
    """Phase 3: the n-step kernel vs its plain version, with the gradient
    of the summed loss in the Q values; returns max |err|."""
    from seed_rl_torch.ops.cuda import nstep_kernel

    max_err = 0.0
    cases = [(case, dtype) for case in NSTEP_CASES
             for dtype in (torch.bool, torch.float32)]
    for seed, ((T, B, A, n, gamma, eta), done_dtype) in enumerate(cases):
        inputs = _nstep_inputs(T, B, A, seed, device, done_dtype)
        q = inputs.pop("q_values")
        q_kernel = q.clone().requires_grad_(True)
        q_plain = q.clone().requires_grad_(True)
        what = (f"T={T} B={B} A={A} n={n} gamma={gamma} eta={eta} done "
                f"{str(done_dtype).split('.')[-1]}")
        plan = nstep_kernel.launch_plan(T, n)
        _print_launch(f"nstep {what}", nstep_kernel.launch_shape(T, B, n),
                      f"{plan.chunk} rows per chunk, window {plan.window}")
        kw = dict(gamma=gamma, n_steps=n, eta=eta)
        err, (loss, _), (want_loss, _) = _nstep_compare(
            [q_kernel, *inputs.values()], [q_plain, *inputs.values()], kw,
            what)
        max_err = max(max_err, err)
        (g_kernel,) = torch.autograd.grad(loss.sum(), q_kernel)
        (g_plain,) = torch.autograd.grad(want_loss.sum(), q_plain)
        torch.testing.assert_close(g_kernel, g_plain, **NSTEP_GRAD_TOL)
        print(f"nstep {what}: dloss/dq max|err|="
              f"{float((g_kernel - g_plain).abs().max()):.3e} "
              f"(tol {NSTEP_GRAD_TOL})")
    return max_err


def _print_launch(what, shape, chunking):
    """Phase 3: one shape's launch; raises past a block's shared memory."""
    print(f"{what}: launch {shape.blocks} blocks of {shape.threads} threads, "
          f"{chunking}, {shape.smem_bytes} B shared memory per block")
    if shape.smem_bytes > BLOCK_SMEM_BYTES:
        raise RuntimeError(f"{what}: {shape.smem_bytes} B of shared memory "
                           f"per block, past {BLOCK_SMEM_BYTES}")


def _timing(T, B, kernel_ms, device_ms, plain_ms, bound_ms, bound_by,
            floor_ms):
    """One shape's phase-4 numbers, under the kernels line's keys: ``ms``
    is the wrapper's call (CUDA events), ``device_ms`` the kernel alone and
    ``launch_floor_ms`` an empty kernel (torch.profiler; None where it
    shows no device rows)."""
    return {"shape": [T, B], "ms": kernel_ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "launch_floor_ms": floor_ms}


def _shown(ms):
    return "not measured (no profiler rows)" if ms is None else f"{ms:.6f} ms"


def time_launch_floor(device):
    """Phase 4: the device time of one empty kernel (one block of 32
    threads), the least any launch costs; None where the profiler shows no
    device rows."""
    from seed_rl_torch.ops.cuda import vtrace_kernel

    floor_ms = _profiled_device_ms(
        lambda: vtrace_kernel.launch_floor(device), "launch_floor")
    print(f"launch floor: an empty kernel on the device {_shown(floor_ms)} "
          f"(torch.profiler, 20 launches)")
    return floor_ms


def _profiled_device_ms(fn, key, iters=20):
    """Device-only time per launch of the kernels whose name holds ``key``
    (torch.profiler), or None where the profiler shows no device rows."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as p:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in _device_kernels(p) if key in e.key]
    if not rows:
        return None
    return rows[0].self_device_time_total / rows[0].count / 1e3


def time_nstep_kernel(device, floor_ms):
    """Phase 4: the n-step kernel and its plain version at both shapes of
    the R2D2 path; returns each shape's numbers by name."""
    from seed_rl_torch.ops import value_ops
    from seed_rl_torch.ops.cuda import nstep_kernel

    results = {}
    for name, (T, B) in (("loss", NSTEP_LOSS_SHAPE),
                         ("insert", NSTEP_INSERT_SHAPE)):
        inputs = _nstep_inputs(T, B, 4, 0, device)
        kw = dict(gamma=0.997, n_steps=5)
        kernel_ms = _cuda_ms(
            lambda: nstep_kernel.td_loss_and_priorities(**inputs, **kw),
            iters=200)
        plain_ms = _cuda_ms(
            lambda: value_ops.td_loss_and_priorities(**inputs, **kw),
            iters=20)
        device_ms = _profiled_device_ms(
            lambda: nstep_kernel.td_loss_and_priorities(**inputs, **kw),
            "nstep")
        bound_ms, bound_by = _nstep_bound_ms(T, B, inputs["done"])
        print(f"nstep {name} T={T} B={B}: wrapper+kernel {kernel_ms:.6f} ms "
              f"per call (CUDA events over back-to-back calls), kernel alone "
              f"on the device {_shown(device_ms)} (torch.profiler; first "
              f"design {FIRST_DESIGN_DEVICE_MS[f'nstep {name}']:.6f} ms in "
              f"an earlier run, not measured here), launch floor "
              f"{_shown(floor_ms)}, bound {bound_ms:.6f} ms ({bound_by}), "
              f"plain {plain_ms:.6f} ms")
        results[name] = _timing(T, B, kernel_ms, device_ms, plain_ms,
                                bound_ms, bound_by, floor_ms)
    return results


def check_vtrace_kernel(device):
    """Phase 3: kernel vs plain version on every case; returns max |err|."""
    from seed_rl_torch.ops import vtrace as plain
    from seed_rl_torch.ops.cuda import vtrace_kernel

    max_err = 0.0
    for seed, (T, B, lam, clip_rho, clip_pg) in enumerate(VTRACE_CASES):
        plan = vtrace_kernel.launch_plan(T)
        _print_launch(f"vtrace T={T} B={B}", vtrace_kernel.launch_shape(T, B),
                      f"{plan.chunk} rows per chunk, {plan.buffers} staging "
                      f"buffer(s)")
        args = _vtrace_inputs(T, B, seed, device)
        kwargs = dict(clip_rho_threshold=clip_rho,
                      clip_pg_rho_threshold=clip_pg, lambda_=lam)
        got = vtrace_kernel.from_importance_weights(*args, **kwargs)
        want = plain.from_importance_weights(*args, **kwargs)
        torch.cuda.synchronize()
        for name, g, w in zip(("vs", "pg_advantages"), got, want):
            torch.testing.assert_close(g, w, rtol=VTRACE_TOL, atol=VTRACE_TOL)
            err = float((g - w).abs().max())
            max_err = max(max_err, err)
            print(f"vtrace T={T} B={B} lambda={lam} clip={clip_rho}: "
                  f"{name} max|err|={err:.3e} (tol {VTRACE_TOL})")
    return max_err


def time_vtrace_kernel(device, floor_ms):
    """Phase 4: kernel and plain times at the V-trace paths' shapes; returns
    each shape's numbers by name."""
    from seed_rl_torch.ops import vtrace as plain
    from seed_rl_torch.ops.cuda import vtrace_kernel

    results = {}
    for name, (T, B) in (("main", VTRACE_MAIN_SHAPE),
                         ("catch", VTRACE_CATCH_SHAPE)):
        args = _vtrace_inputs(T, B, 0, device)
        kernel_ms = _cuda_ms(
            lambda: vtrace_kernel.from_importance_weights(*args), iters=200)
        plain_ms = _cuda_ms(
            lambda: plain.from_importance_weights(*args), iters=20)
        bound_ms, bound_by = _vtrace_bound_ms(T, B)
        device_ms = _profiled_device_ms(
            lambda: vtrace_kernel.from_importance_weights(*args), "vtrace")
        first = (f"; first design {FIRST_DESIGN_DEVICE_MS['vtrace']:.6f} ms "
                 f"in an earlier run, not measured here"
                 if name == "main" else "")
        print(f"vtrace T={T} B={B}: kernel {kernel_ms:.6f} ms per call "
              f"(CUDA events over back-to-back calls), kernel alone on the "
              f"device {_shown(device_ms)} (torch.profiler, 20 launches"
              f"{first}), launch floor {_shown(floor_ms)}, bound "
              f"{bound_ms:.6f} ms ({bound_by}), plain {plain_ms:.6f} ms")
        results[name] = _timing(T, B, kernel_ms, device_ms, plain_ms,
                                bound_ms, bound_by, floor_ms)
    return results


def check_pool(device):
    """Phase 3: ImpalaDeep's SAME max pool on the card against the CPU, on
    inputs quantised to a few levels (ties in most windows): values and
    gradients must be equal. The cotangents lie on a 1/8 grid, so sums of
    them are exact in any order and only the routing of ties is compared."""
    from seed_rl_torch.ops.pooling import max_pool_same

    for seed, shape in enumerate(POOL_SHAPES):
        rng = np.random.RandomState(seed)
        x = torch.tensor(np.round(rng.normal(size=shape) * 2) / 2,
                         dtype=torch.float32)
        out_shape = shape[:2] + tuple(-(-n // 2) for n in shape[2:])
        ct = torch.tensor(np.round(rng.normal(size=out_shape) * 8) / 8,
                          dtype=torch.float32)
        results = {}
        for where, fmt in (("cpu", torch.contiguous_format),
                           ("cuda", torch.contiguous_format),
                           ("cuda channels_last", torch.channels_last)):
            dev = torch.device("cpu") if where == "cpu" else device
            xd = x.to(dev).to(memory_format=fmt).requires_grad_(True)
            out = max_pool_same(xd)
            (grad,) = torch.autograd.grad(out, xd, ct.to(dev))
            results[where] = (out.detach().cpu(), grad.cpu())
        want_out, want_grad = results.pop("cpu")
        for where, (out, grad) in results.items():
            torch.testing.assert_close(out, want_out, rtol=0, atol=0)
            torch.testing.assert_close(grad, want_grad, rtol=0, atol=0)
        print(f"pool {list(shape)} -> {list(out_shape)}, inputs on "
              f"{torch.unique(x).numel()} levels: values and gradient on the "
              f"card ({', '.join(results)}) equal the CPU's exactly "
              f"({int(torch.count_nonzero(want_grad))} inputs take gradient)")


def _peak_memory_gb():
    return torch.cuda.max_memory_allocated() / 1e9


def run_vtrace(card, name):
    """Phases 5, 7 and 8: one V-trace path through the CLI entry point, with
    the launch counts reset just before it; returns (the path's V-trace
    launches, max |kernel - plain| on the run's own unroll, the learner)."""
    from seed_rl_torch import train
    from seed_rl_torch.agents import vtrace as vtrace_agent
    from seed_rl_torch.ops import vtrace as plain
    from seed_rl_torch.ops.cuda import vtrace_kernel

    path = VTRACE_PATHS[name]
    argv = [
        "--agent=vtrace", *path.flags,
        f"--num_envs={path.envs}", f"--unroll_length={path.unroll}",
        f"--total_environment_frames={path.steps * path.envs * path.unroll}",
        "--steps_per_call=1", "--log_every_steps=1",
    ]
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    start = time.perf_counter()
    learner, state, metrics = train.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    launches = vtrace_kernel.launches
    if state.step != path.steps:
        raise RuntimeError(f"{name}: trained {state.step} steps, want "
                           f"{path.steps}")
    if launches != state.step:
        raise RuntimeError(
            f"{name}: vtrace kernel launched {launches} times in "
            f"{state.step} train steps")
    bad = {k: float(v) for k, v in metrics.items()
           if not math.isfinite(float(v))}
    if bad:
        raise RuntimeError(f"{name}: non-finite metrics: {bad}")
    tensors = list(learner.parameters()) + learner.state_tensors(state)
    off_card = [t.device for t in tensors if t.device.type != "cuda"]
    if off_card:
        raise RuntimeError(f"{name}: {len(off_card)} tensors off the card")
    print(f"{name} train: {state.step} steps in {wall_s:.3f} s including "
          f"setup; vtrace launches {launches}; "
          f"losses/total={float(metrics['losses/total']):.6f}; "
          f"{len(tensors)} tensors on cuda")

    # The kernel on this run's own data, against the plain version.
    rollout, unroll = learner.engine.rollout(state.rollout)
    state = state._replace(rollout=rollout)
    with torch.no_grad():
        inputs, _ = vtrace_agent.vtrace_inputs(
            learner.config, learner.agent, learner.agent.distribution, unroll)
    got = vtrace_kernel.from_importance_weights(
        **inputs, lambda_=learner.config.lambda_)
    want = plain.from_importance_weights(
        **inputs, lambda_=learner.config.lambda_)
    torch.cuda.synchronize()
    err = 0.0
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=VTRACE_TOL, atol=VTRACE_TOL)
        err = max(err, float((g - w).abs().max()))
    print(f"{name}: vtrace on the run's own unroll "
          f"{list(inputs['rewards'].shape)} matches the plain version, "
          f"max|err|={err:.3e} (tol {VTRACE_TOL})")

    state, step_s, (rollout_s, update_s) = time_train_steps(
        state, *_rollout_and_update(learner), path.timed_steps)
    print(f"{name} train step on {card}: {step_s * 1e3:.3f} ms, "
          f"{learner.frames_per_step / step_s:.1f} env frames/s "
          f"(num_envs={path.envs}, unroll_length={path.unroll}, {path.net})")
    print(f"{name} per step: rollout {rollout_s * 1e3:.3f} ms, update (loss, "
          f"backward, clip, Adam, stats) {update_s * 1e3:.3f} ms")
    profile_device_time(learner, state, step_s, name)
    _print_path_end(name, start)
    return launches, err, learner


def run_eval_twice(learner):
    """Phase 8: the trained policy, deterministic, on fresh Catch envs on
    the card, twice from one seed; the two results must be equal."""
    from seed_rl_torch.envs import BatchedEnv, CatchEnv
    from seed_rl_torch.evaluation import run_eval

    path = VTRACE_PATHS["catch_impala_deep"]
    device = learner.device
    results = []
    for _ in range(2):
        env = BatchedEnv(CatchEnv(), path.envs, device=device)
        t0 = time.perf_counter()
        metrics = run_eval(env, learner.agent, EVAL_EPISODES,
                           unroll_length=path.unroll, seed=0)
        torch.cuda.synchronize()
        print(f"eval: {metrics} in {time.perf_counter() - t0:.3f} s "
              f"({path.envs} Catch envs on {device}, deterministic policy)")
        results.append(metrics)
    if results[0]["eval/num_episodes"] < EVAL_EPISODES:
        raise RuntimeError(f"eval completed {results[0]['eval/num_episodes']}"
                           f" episodes, want >= {EVAL_EPISODES}")
    if results[0] != results[1]:
        raise RuntimeError(f"eval is not repeatable: {results}")
    print("eval: the two deterministic runs from one seed are equal")


def _reset_launch_counts():
    """Every kernel's launch count to 0, just before a path is driven."""
    from seed_rl_torch.ops.cuda import nstep_kernel, vtrace_kernel

    vtrace_kernel.launches = nstep_kernel.launches = 0


def run_r2d2(card, env):
    """Phases 6 and 9: R2D2 through the CLI entry point, at the reference
    knobs; returns (the path's n-step launches, max |kernel - plain| on
    the run's own batch)."""
    from seed_rl_torch import train
    from seed_rl_torch.ops.cuda import nstep_kernel

    name = f"r2d2 {env}"
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    start = time.perf_counter()
    learner, state, metrics = train.main(_r2d2_argv(env))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    launches = nstep_kernel.launches
    want = R2D2_WARMUPS + state.step * (1 + R2D2_BATCHES_PER_STEP)
    if state.step != R2D2_STEPS:
        raise RuntimeError(f"{name}: trained {state.step} steps, want "
                           f"{R2D2_STEPS}")
    if launches != want:
        raise RuntimeError(
            f"{name}: nstep kernel launched {launches} times, want {want} "
            f"({R2D2_WARMUPS} warmup inserts + {state.step} x (1 insert + "
            f"{R2D2_BATCHES_PER_STEP} batches))")
    bad = {k: float(v) for k, v in metrics.items()
           if not math.isfinite(float(v))}
    if bad:
        raise RuntimeError(f"{name}: non-finite metrics: {bad}")
    tensors = (learner.parameters() + list(learner.target_net.parameters())
               + learner.state_tensors(state))
    off_card = [t.device for t in tensors if t.device.type != "cuda"]
    if off_card:
        raise RuntimeError(f"{name}: {len(off_card)} tensors off the card")
    replay_mb = sum(t.numel() * t.element_size() for t in
                    pytree.tree_leaves(state.replay.buffer)) / 1e6
    print(f"{name} train: {R2D2_WARMUPS} warmup rollouts + {state.step} steps "
          f"in {wall_s:.3f} s including setup; nstep launches {launches}; "
          f"losses/td={float(metrics['losses/td']):.6f}; {len(tensors)} "
          f"tensors on cuda; replay {state.replay.num_inserted} unrolls, "
          f"{replay_mb:.1f} MB")

    config = learner.config
    _, _, items = learner.replay.sample(
        state.replay, learner.generator, config.batch_size,
        config.priority_exponent)
    err = check_nstep_on_batch(name, learner, items)

    # A step is one rollout + insert and one train batch.
    state, step_s, (insert_s, batch_s) = time_train_steps(
        state, learner.warmup_step,
        lambda s: learner.train_on_batch(s)[0], R2D2_TIMED_STEPS)
    print(f"{name} train step on {card}: {step_s * 1e3:.3f} ms, "
          f"{learner.frames_per_step / step_s:.1f} env frames/s "
          f"(num_envs={R2D2_ENVS}, unroll_length={R2D2_UNROLL}, burn_in="
          f"{R2D2_BURN_IN}, batch 64, {R2D2_PATHS[env]})")
    print(f"{name} per step on {card}: rollout + insert "
          f"{insert_s * 1e3:.3f} ms, train batch (sample, burn-in + unrolls, "
          f"loss, backward, clip, Adam, priorities) {batch_s * 1e3:.3f} ms")
    profile_device_time(learner, state, step_s, name)
    _print_path_end(name, start)
    return launches, err


def check_nstep_on_batch(name, learner, items):
    """The n-step kernel on a batch of a run's own replay items, against
    the plain version, with the gradient of the summed loss in the online
    Q values; loss and priorities must be finite. Returns max |err|."""
    from seed_rl_torch.agents import r2d2

    config = learner.config
    with torch.no_grad():
        q, *args = r2d2.loss_inputs(
            learner.net, learner.target_net, items.agent_state,
            *r2d2._time_major((items.prev_actions, items.env_outputs,
                               items.agent_outputs)),
            burn_in=config.burn_in)
    q_kernel, q_plain = (q.clone().requires_grad_(True) for _ in range(2))
    kw = dict(gamma=config.discounting, n_steps=config.n_steps,
              rescaling_eps=config.value_function_rescaling_epsilon)
    err, (loss, pri), (want_loss, _) = _nstep_compare(
        [q_kernel, *args], [q_plain, *args], kw,
        f"{name} on the run's own sampled batch {list(q.shape[:2])}")
    if not (torch.isfinite(loss).all() and torch.isfinite(pri).all()):
        raise RuntimeError(f"{name}: non-finite loss or priorities")
    (g_kernel,) = torch.autograd.grad(loss.sum(), q_kernel)
    (g_plain,) = torch.autograd.grad(want_loss.sum(), q_plain)
    torch.testing.assert_close(g_kernel, g_plain, **NSTEP_GRAD_TOL)
    print(f"nstep {name} on the run's own sampled batch: dloss/dq max|err|="
          f"{float((g_kernel - g_plain).abs().max()):.3e} "
          f"(tol {NSTEP_GRAD_TOL})")
    return err


def run_ppo(card, name):
    """Phases 10 and 11: one PPO path through the CLI entry point, with the
    launch counts reset just before it; returns the path's launches of the
    hand kernels (none: its advantages are plain PyTorch)."""
    from seed_rl_torch import train
    from seed_rl_torch.ops.cuda import nstep_kernel, vtrace_kernel

    path = PPO_PATHS[name]
    updates_per_step = path.epochs * path.minibatches
    argv = [
        "--agent=ppo", *path.flags,
        f"--num_envs={path.envs}", f"--unroll_length={path.unroll}",
        f"--epochs_per_step={path.epochs}",
        f"--batches_per_step={path.minibatches}",
        f"--total_environment_frames={PPO_STEPS * path.envs * path.unroll}",
        "--steps_per_call=1", "--log_every_steps=1",
    ]
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    start = time.perf_counter()
    learner, state, metrics = train.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    launches = {"vtrace": vtrace_kernel.launches,
                "nstep": nstep_kernel.launches}
    if state.step != PPO_STEPS:
        raise RuntimeError(f"{name}: trained {state.step} steps, want "
                           f"{PPO_STEPS}")
    if learner.optimizer.count != state.step * updates_per_step:
        raise RuntimeError(
            f"{name}: {learner.optimizer.count} optimizer updates in "
            f"{state.step} steps, want {updates_per_step} per step")
    obs_norm = getattr(learner.agent, "obs_norm", ())
    if obs_norm:
        want = state.step * (path.unroll + 1) * path.envs
        counts = obs_norm.observation_count
        if not bool(torch.all(counts == want)):
            raise RuntimeError(f"{name}: observation counts "
                               f"{counts.tolist()}, want {want}")
    bad = {k: float(v) for k, v in metrics.items()
           if not math.isfinite(float(v))}
    if bad:
        raise RuntimeError(f"{name}: non-finite metrics: {bad}")
    tensors = learner.parameters() + learner.state_tensors(state)
    off_card = [t.device for t in tensors if t.device.type != "cuda"]
    if off_card:
        raise RuntimeError(f"{name}: {len(off_card)} tensors off the card")
    folded = int(obs_norm.observation_count[0]) if obs_norm else 0
    total_loss = float(metrics["GeneralizedOnPolicyLoss/total_loss"])
    print(f"{name} train: {state.step} steps in {wall_s:.3f} s including "
          f"setup; {learner.optimizer.count} optimizer updates "
          f"({path.epochs} epochs x {path.minibatches} minibatches a step, "
          f"batch mode {learner.config.batch_mode}); {folded} observations "
          f"folded per dim; hand-kernel launches {launches}; "
          f"total_loss={total_loss:.6f}; {len(tensors)} tensors on cuda")

    state, step_s, (rollout_s, update_s) = time_train_steps(
        state, *_rollout_and_update(learner), PPO_TIMED_STEPS)
    print(f"{name} train step on {card}: {step_s * 1e3:.3f} ms, "
          f"{learner.frames_per_step / step_s:.1f} env frames/s "
          f"(num_envs={path.envs}, unroll_length={path.unroll}, {path.net})")
    print(f"{name} per step: rollout {rollout_s * 1e3:.3f} ms, update "
          f"({updates_per_step} minibatch steps: loss, backward, clip, Adam) "
          f"{update_s * 1e3:.3f} ms")
    profile_device_time(learner, state, step_s, name)
    _print_path_end(name, start)
    return launches


def run_sac(card, name):
    """Phases 12 and 13: one SAC path through the CLI entry point, with the
    launch counts reset just before it; returns the path's launches of the
    hand kernels (none)."""
    from seed_rl_torch import train
    from seed_rl_torch.agents import sac
    from seed_rl_torch.ops.cuda import nstep_kernel, vtrace_kernel

    path = SAC_PATHS[name]
    argv = [
        "--agent=sac", *path.flags, f"--num_envs={path.envs}",
        f"--total_environment_frames={SAC_STEPS * path.envs * path.rollout}",
        "--steps_per_call=1", "--log_every_steps=1",
    ]
    # Count the polyak moves inside train.main.
    moves = []
    move_target = sac.SACUpdate._move_target

    def counted(learner):
        moves.append(learner)
        move_target(learner)

    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    start = time.perf_counter()
    sac.SACUpdate._move_target = counted
    try:
        learner, state, metrics = train.main(argv)
        torch.cuda.synchronize()
    finally:
        sac.SACUpdate._move_target = move_target
    wall_s = time.perf_counter() - start
    launches = {"vtrace": vtrace_kernel.launches,
                "nstep": nstep_kernel.launches}
    if state.step != SAC_STEPS:
        raise RuntimeError(f"{name}: trained {state.step} steps, want "
                           f"{SAC_STEPS}")
    if learner.optimizer.count != state.step or len(moves) != state.step:
        raise RuntimeError(
            f"{name}: {learner.optimizer.count} optimizer updates and "
            f"{len(moves)} polyak moves in {state.step} steps, want one each "
            "a step")
    bad = {k: float(v) for k, v in metrics.items()
           if not math.isfinite(float(v))}
    if bad:
        raise RuntimeError(f"{name}: non-finite metrics: {bad}")
    bound = 20.0 / learner.config.entropy_cost_adjustment_speed
    entropy_cost = float(learner.entropy_cost.detach())
    if not -bound <= entropy_cost <= bound:
        raise RuntimeError(f"{name}: entropy-cost parameter {entropy_cost} "
                           f"outside its clip +-{bound}")
    tensors = learner.parameters() + learner.state_tensors(state)
    off_card = [t.device for t in tensors if t.device.type != "cuda"]
    if off_card:
        raise RuntimeError(f"{name}: {len(off_card)} tensors off the card")
    replay_mb = sum(t.numel() * t.element_size() for t in
                    pytree.tree_leaves(state.replay.buffer)) / 1e6
    print(f"{name} train: warmup + {state.step} steps in {wall_s:.3f} s "
          f"including setup; "
          f"{learner.optimizer.count} optimizer updates, {len(moves)} polyak "
          f"moves; alpha {float(metrics['policy/entropy_cost']):.6f} "
          f"(parameter {entropy_cost:.6f}, clip +-{bound}); hand-kernel "
          f"launches {launches}; losses/total="
          f"{float(metrics['losses/total']):.6f}; {len(tensors)} tensors on "
          f"cuda; replay {state.replay.num_inserted} unrolls, "
          f"{replay_mb:.1f} MB")
    check_sac_loss_against_cpu(learner, state, name)

    # A step is one rollout + insert and one train batch.
    state, step_s, (insert_s, batch_s) = time_train_steps(
        state, learner.warmup_step,
        lambda s: learner.train_on_batch(s)[0], SAC_TIMED_STEPS)
    print(f"{name} train step on {card}: {step_s * 1e3:.3f} ms, "
          f"{learner.frames_per_step / step_s:.1f} env frames/s "
          f"(num_envs={path.envs}, {path.rollout} steps a rollout, batch "
          f"{learner.config.batch_size}, {path.net})")
    print(f"{name} per step: rollout + insert {insert_s * 1e3:.3f} ms, train "
          f"batch (sample, loss, backward, clip, Adam, polyak) "
          f"{batch_s * 1e3:.3f} ms")
    profile_device_time(learner, state, step_s, name)
    _print_path_end(name, start)
    return launches


def check_sac_loss_against_cpu(learner, state, name):
    """The SAC loss, its metrics and its gradients on the card against the
    same code on the CPU, on a batch sampled from the run's replay, with the
    loss's noise injected and TF32 off on the card."""
    import copy

    from seed_rl_torch.agents import sac

    config = learner.config
    _, _, items = learner.replay.sample(
        state.replay, learner.generator, SAC_CHECK_BATCH, 0)
    batch = sac._time_major(
        (items.prev_actions, items.env_outputs, items.agent_actions))
    dist = learner.agent.distribution
    width = (dist.param_size // 2 if dist.reparametrizable
             else dist.param_size)
    g = torch.Generator().manual_seed(0)
    steps = config.unroll_length
    noise = sac.SACNoise(*(
        torch.randn((t, SAC_CHECK_BATCH, width), generator=g)
        for t in (steps, steps, steps + 1, steps + 1)))
    results = []
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for device in (learner.device, torch.device("cpu")):
            agent, target = learner.agent, learner.target_agent
            entropy_cost = learner.entropy_cost
            if device.type == "cpu":
                agent, target = copy.deepcopy((agent, target))
                for a in (agent, target):
                    a.net.to(device)
                    if a.normalize_observations:
                        a.obs_norm = pytree.tree_map(
                            lambda t: t.to(device), a.obs_norm)
                entropy_cost = torch.nn.Parameter(entropy_cost.detach().cpu())
            loss, metrics = sac.compute_loss(
                config, agent, target, entropy_cost,
                *pytree.tree_map(lambda t: t.to(device),
                                 (items.agent_state,) + batch),
                noise=pytree.tree_map(lambda t: t.to(device), noise))
            grads = torch.autograd.grad(
                loss, list(agent.net.parameters()) + [entropy_cost])
            results.append((metrics, grads))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32[0]
        torch.backends.cuda.matmul.allow_tf32 = tf32[1]
    (metrics, grads), (want_metrics, want_grads) = results
    err = 0.0
    for k, want in want_metrics.items():
        torch.testing.assert_close(metrics[k].cpu(), want, **SAC_TOL, msg=k)
    for got, want in zip(grads, want_grads):
        torch.testing.assert_close(got.cpu(), want, **SAC_GRAD_TOL)
        err = max(err, float((got.cpu() - want).abs().max()))
    print(f"{name}: loss and {len(want_metrics)} metrics (tol {SAC_TOL}) "
          f"and {len(grads)} gradients (tol {SAC_GRAD_TOL}, max|err|="
          f"{err:.3e}) on the card match the CPU on a batch of "
          f"{SAC_CHECK_BATCH} sampled from the run's replay (TF32 off)")


class CheckpointRecorder:
    """While a phase-14 call runs, wraps ``CheckpointManager.maybe_save``
    and ``restore_or`` and ``export_policy``: each save's step, whether it
    was forced, and its seconds; each restore's step and seconds, and a CPU
    copy of the restored replay taken before training writes into it; each
    export's seconds."""

    def __enter__(self):
        from seed_rl_torch.utils import checkpoint as ckpt
        from seed_rl_torch.utils import export

        self.saves, self.restores, self.exports = [], [], []
        manager = ckpt.CheckpointManager
        self._saved = (manager.maybe_save, manager.restore_or,
                       export.export_policy)
        maybe_save, restore_or, export_policy = self._saved

        def timed_save(mgr, step, learner, state, force=False):
            t0 = time.perf_counter()
            if maybe_save(mgr, step, learner, state, force):
                self.saves.append((step, force, time.perf_counter() - t0))
                return True
            return False

        def timed_restore(mgr, learner, state):
            t0 = time.perf_counter()
            state = restore_or(mgr, learner, state)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            replay = getattr(state, "replay", None)
            self.restores.append((state.step, seconds, None if replay is None
                                  else ckpt.to_saveable(replay)))
            return state

        def timed_export(*args, **kw):
            t0 = time.perf_counter()
            export_policy(*args, **kw)
            self.exports.append(time.perf_counter() - t0)

        manager.maybe_save, manager.restore_or = timed_save, timed_restore
        export.export_policy = timed_export
        return self

    def __exit__(self, *exc):
        from seed_rl_torch.utils import checkpoint as ckpt
        from seed_rl_torch.utils import export

        manager = ckpt.CheckpointManager
        manager.maybe_save, manager.restore_or, export.export_policy = (
            self._saved)


def _assert_trees_equal(got, want, what):
    """Bitwise equality of two trees of tensors and ints; returns the
    number of tensors compared."""
    got_leaves, got_spec = pytree.tree_flatten(got)
    want_leaves, want_spec = pytree.tree_flatten(want)
    if got_spec != want_spec:
        raise RuntimeError(f"{what}: the structures differ")
    tensors = 0
    for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
        if isinstance(w, torch.Tensor):
            tensors += 1
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise RuntimeError(f"{what}: tensor {i} differs")
        elif g != w:
            raise RuntimeError(f"{what}: leaf {i} is {g!r}, want {w!r}")
    return tensors


def _event_records(path):
    """The TFRecord records in an event file, its framing checked."""
    with open(path, "rb") as f:
        data = f.read()
    pos = records = 0
    while pos < len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        pos += 8 + 4 + length + 4
        records += 1
    if pos != len(data):
        raise RuntimeError(f"{path}: the last record is cut")
    return records


def _launches():
    from seed_rl_torch.ops.cuda import nstep_kernel, vtrace_kernel

    return {"vtrace": vtrace_kernel.launches, "nstep": nstep_kernel.launches}


def _finite(name, metrics):
    bad = {k: float(v) for k, v in metrics.items()
           if not math.isfinite(float(v))}
    if bad:
        raise RuntimeError(f"{name}: non-finite metrics: {bad}")


def _run(argv):
    """One call of seed_rl_torch.train.main under a CheckpointRecorder,
    the launch counts reset just before; returns (learner, state, metrics,
    recorder, launches)."""
    from seed_rl_torch import train

    _reset_launch_counts()
    with CheckpointRecorder() as recorder:
        learner, state, metrics = train.main(argv)
        torch.cuda.synchronize()
    return learner, state, metrics, recorder, _launches()


def _train_and_resume(name, argv, logdir, frames_per_step, want_launches,
                      smi):
    """Trains CKPT_STEPS steps into ``logdir``, holds the checkpoint file
    against the run's final state, then resumes with a RESUME_STEPS
    budget; checks each call's kernel launches against ``want_launches``
    (one dict per call). Returns (the resumed learner and state, the saved
    tree, the resumed call's recorder)."""
    from seed_rl_torch.utils import checkpoint as ckpt

    calls = []
    for steps in (CKPT_STEPS, RESUME_STEPS):
        learner, state, metrics, recorder, launches = _run(
            argv + [f"--total_environment_frames={steps * frames_per_step}"])
        if state.step != steps:
            raise RuntimeError(f"{name}: ended at step {state.step}, want "
                               f"{steps}")
        _finite(name, metrics)
        calls.append((learner, state, recorder, launches))
        if steps == CKPT_STEPS:
            step = ckpt.CheckpointManager(logdir).latest_step()
            path = os.path.join(logdir, "ckpt", str(step), ckpt.FILE_NAME)
            t0 = time.perf_counter()
            saved = torch.load(path, map_location="cpu", weights_only=True)
            load_s = time.perf_counter() - t0
            tensors = _assert_trees_equal(
                saved, ckpt.to_saveable(learner.checkpoint_state(state)),
                f"{name}: the checkpoint of step {step}")
            save_s = recorder.saves[-1][2]
            print(f"{name}: checkpoint of step {step}: "
                  f"{os.path.getsize(path) / 1e6:.3f} MB on disk, "
                  f"{len(recorder.saves)} saves (the last "
                  f"{save_s:.3f} s), loaded back in {load_s:.3f} s: its "
                  f"{tensors} tensors equal the run's final state bitwise "
                  f"({smi})")
    got = [c[3] for c in calls]
    if got != want_launches:
        raise RuntimeError(f"{name}: kernel launches {got}, want "
                           f"{want_launches}")
    learner, state, recorder, _ = calls[1]
    restored_step, restore_s, _ = recorder.restores[0]
    if restored_step != CKPT_STEPS:
        raise RuntimeError(f"{name}: resumed at step {restored_step}, want "
                           f"{CKPT_STEPS}")
    print(f"{name}: resumed at step {restored_step} in {restore_s:.3f} s and "
          f"trained {state.step - restored_step} more steps; kernel "
          f"launches per call {got} ({smi})")
    return learner, state, saved, recorder


def _check_replay_round_trip(name, state, saved, recorder, per_rollout):
    """The replay restored equals the saved one bitwise, and no warm-up
    ran after the restore."""
    replay = recorder.restores[0][2]
    tensors = _assert_trees_equal(replay, saved["replay"],
                                  f"{name}: the restored replay")
    inserted = saved["replay"]["num_inserted"] + (
        RESUME_STEPS - CKPT_STEPS) * per_rollout
    if state.replay.num_inserted != inserted:
        raise RuntimeError(f"{name}: {state.replay.num_inserted} items "
                           f"inserted after the resume, want {inserted}: a "
                           "warm-up ran after the restore")
    mb = sum(t.numel() * t.element_size() for t in
             pytree.tree_leaves(saved["replay"]["buffer"])) / 1e6
    print(f"{name}: the restored replay ({tensors} tensors, {mb:.1f} MB; "
          f"num_inserted {replay['num_inserted']}, insert_index "
          f"{replay['insert_index']}) equals the saved one bitwise; no "
          "warm-up after the restore")


def _eval(name, argv, smi):
    """--run_mode=eval on the logdir: restored at RESUME_STEPS, at least
    CKPT_EVAL_EPISODES episodes, no kernel launch."""
    episodes = CKPT_EVAL_EPISODES
    t0 = time.perf_counter()
    _, _, metrics, _, launches = _run(
        argv + ["--run_mode=eval", f"--eval_episodes={episodes}"])
    if metrics["eval/restored_step"] != RESUME_STEPS:
        raise RuntimeError(f"{name}: eval restored step "
                           f"{metrics['eval/restored_step']}")
    if metrics["eval/num_episodes"] < episodes:
        raise RuntimeError(f"{name}: eval ran {metrics['eval/num_episodes']}"
                           f" episodes, want >= {episodes}")
    _finite(name, metrics)
    if any(launches.values()):
        raise RuntimeError(f"{name}: eval launched {launches}")
    print(f"{name}: --run_mode=eval printed its line in "
          f"{time.perf_counter() - t0:.3f} s ({smi})")


def _check_policy(name, policy, agent, rollout, tol):
    """The loaded policy against ``agent.policy_step(deterministic=True)``
    on the rollout's own inputs; returns the max |error| of the state (and
    of continuous actions)."""
    batch = rollout.prev_action.shape[0]
    core = agent.initial_state(batch)
    action, state = policy(rollout.prev_action, rollout.env_output, core)
    with torch.no_grad():
        want, want_state = agent.policy_step(
            rollout.prev_action, rollout.env_output, core,
            deterministic=True)
    err = 0.0
    if action.dtype.is_floating_point:
        err = float((action - want.action).abs().max())
    elif not torch.equal(action, want.action):
        raise RuntimeError(f"{name}: exported actions differ")
    for got, w in zip(pytree.tree_leaves(state),
                      pytree.tree_leaves(want_state)):
        err = max(err, float((got.float() - w.float()).abs().max()))
    if not err <= tol:
        raise RuntimeError(f"{name}: exported policy off by {err} "
                           f"(tol {tol})")
    return err


def run_checkpoint_vtrace(smi, logdir):
    """Phase 14 (a); returns its V-trace launches."""
    from seed_rl_torch.utils.export import export_policy, load_policy

    name = "ckpt vtrace synthetic_atari"
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    path = VTRACE_PATHS["synthetic_atari"]
    frames = path.envs * path.unroll
    argv = ["--agent=vtrace", *path.flags, f"--num_envs={path.envs}",
            f"--unroll_length={path.unroll}", "--steps_per_call=1",
            "--log_every_steps=1", f"--logdir={logdir}",
            "--save_checkpoint_secs=0"]
    steps = [{"vtrace": CKPT_STEPS, "nstep": 0},
             {"vtrace": RESUME_STEPS - CKPT_STEPS, "nstep": 0}]
    learner, state, _, _ = _train_and_resume(name, argv, logdir, frames,
                                             steps, smi)
    files = sorted(glob.glob(os.path.join(logdir, "events.out.tfevents.*")))
    records = [_event_records(f) for f in files]
    if len(files) != 2 or min(records) < 2:
        raise RuntimeError(f"{name}: event files {files}, records {records}")
    print(f"{name}: event files of both calls hold {records} records "
          f"({sum(os.path.getsize(f) for f in files)} bytes)")
    argv += [f"--total_environment_frames={RESUME_STEPS * frames}"]
    _eval(name, argv, smi)

    t0 = time.perf_counter()
    _, _, result, _, launches = _run(
        argv + ["--run_mode=profile", f"--profile_calls={PROFILE_CALLS}"])
    trace = os.path.join(result["profile_dir"], "trace.json")
    if launches != {"vtrace": 1 + PROFILE_CALLS, "nstep": 0} or not (
            os.path.getsize(trace) > 0):
        raise RuntimeError(f"{name}: profile launched {launches}, trace "
                           f"{trace}")
    print(f"{name}: --run_mode=profile traced {PROFILE_CALLS} calls at "
          f"{result['frames_per_sec']:.1f} env frames/s (traced) into "
          f"{os.path.getsize(trace) / 1e6:.1f} MB in "
          f"{time.perf_counter() - t0:.3f} s; vtrace launches {launches}")

    export_dir = os.path.join(logdir, "export")
    t0 = time.perf_counter()
    export_policy(export_dir, learner.agent, state.rollout.prev_action,
                  state.rollout.env_output)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    policy = load_policy(export_dir)
    load_s = time.perf_counter() - t0
    err = _check_policy(name, policy, learner.agent, state.rollout,
                        EXPORT_TOL)
    print(f"{name}: exported in {export_s:.3f} s, loaded in {load_s:.3f} s: "
          f"actions equal to policy_step(deterministic=True)'s on the "
          f"rollout's {path.envs} env outputs, state max|err|={err:.3e} "
          f"(tol {EXPORT_TOL}) ({smi})")
    _print_path_end(name, start)
    return RESUME_STEPS + 1 + PROFILE_CALLS


def run_checkpoint_r2d2(smi, logdir):
    """Phase 14 (b); returns its n-step launches."""
    name = "ckpt r2d2 discrete_match"
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    argv = _r2d2_argv("discrete_match") + [f"--logdir={logdir}"]
    per_rollout = R2D2_ENVS - R2D2_EVAL_ENVS
    moved = RESUME_STEPS - CKPT_STEPS
    want = [{"vtrace": 0, "nstep": R2D2_WARMUPS + CKPT_STEPS * 2},
            {"vtrace": 0, "nstep": moved * 2}]
    _, state, saved, recorder = _train_and_resume(
        name, argv, logdir, R2D2_ENVS * R2D2_UNROLL, want, smi)
    _check_replay_round_trip(name, state, saved, recorder, per_rollout)
    _eval(name, argv + ["--total_environment_frames="
                        f"{RESUME_STEPS * R2D2_ENVS * R2D2_UNROLL}"], smi)
    _print_path_end(name, start)
    return sum(w["nstep"] for w in want)


def run_checkpoint_ppo(smi, logdir):
    """Phase 14 (c): PPO's action points."""
    from seed_rl_torch.utils import checkpoint as ckpt
    from seed_rl_torch.utils.export import load_policy

    name = "ckpt ppo toy"
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    path = PPO_PATHS["ppo_toy"]
    frames = path.envs * path.unroll
    learner, state, metrics, recorder, launches = _run([
        "--agent=ppo", *path.flags, f"--num_envs={path.envs}",
        f"--unroll_length={path.unroll}", f"--epochs_per_step={path.epochs}",
        f"--batches_per_step={path.minibatches}",
        f"--total_environment_frames={CKPT_STEPS * frames}",
        "--steps_per_call=1", "--log_every_steps=1", f"--logdir={logdir}",
        "--num_checkpoints=2", "--num_saved_models=2", "--num_snapshots=2"])
    _finite(name, metrics)
    forced = [step for step, force, _ in recorder.saves if force]
    exported = sorted(int(d) for d in os.listdir(
        os.path.join(logdir, "saved_models")))
    snapshots = [s.frames for s in learner.snapshots]
    marks = [frames, 2 * frames]
    # The two marks' saves, then the loop's last one (forced, at step 2).
    if (forced != [1, 2, 2] or len(recorder.saves) != 3 or exported != marks
            or snapshots != marks or any(launches.values())):
        raise RuntimeError(
            f"{name}: saves {recorder.saves}, saved models {exported}, "
            f"snapshots {snapshots}, launches {launches}; want saves at "
            f"steps 1 and 2 and the last, models and snapshots at {marks}")
    t0 = time.perf_counter()
    policy = load_policy(os.path.join(logdir, "saved_models", str(marks[-1])))
    load_s = time.perf_counter() - t0
    err = _check_policy(name, policy, learner.agent, state.rollout,
                        EXPORT_TOL)
    size = os.path.getsize(os.path.join(logdir, "ckpt", str(CKPT_STEPS),
                                        ckpt.FILE_NAME))
    print(f"{name}: checkpoints at steps {sorted(set(forced))} "
          f"({size / 1e6:.3f} MB on disk, the last save "
          f"{recorder.saves[-1][2]:.3f} s), saved models at {exported} "
          f"frames (exports "
          f"{', '.join(f'{s:.3f}' for s in recorder.exports)} s), "
          f"{len(snapshots)} snapshots; the "
          f"last model loaded in {load_s:.3f} s gives the agent's "
          f"deterministic actions within {err:.3e} (tol {EXPORT_TOL}), its "
          f"input statistics inside ({smi})")
    _print_path_end(name, start)


def run_checkpoint_sac(smi, logdir):
    """Phase 14 (d): the replay of frames through a checkpoint."""
    name = "ckpt sac catch_continuous"
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    path = SAC_PATHS["sac_catch_continuous"]
    argv = ["--agent=sac", *path.flags, f"--num_envs={path.envs}",
            "--steps_per_call=1", "--log_every_steps=1", f"--logdir={logdir}"]
    none = {"vtrace": 0, "nstep": 0}
    _, state, saved, recorder = _train_and_resume(
        name, argv, logdir, path.envs * path.rollout, [none, none], smi)
    _check_replay_round_trip(name, state, saved, recorder, path.envs)
    _eval(name, argv + ["--total_environment_frames="
                        f"{RESUME_STEPS * path.envs * path.rollout}"], smi)
    _print_path_end(name, start)


def run_checkpoint_paths(smi):
    """Phase 14; returns its V-trace and n-step launches."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        vtrace = run_checkpoint_vtrace(smi, os.path.join(root, "vtrace"))
        nstep = run_checkpoint_r2d2(smi, os.path.join(root, "r2d2"))
        run_checkpoint_ppo(smi, os.path.join(root, "ppo"))
        run_checkpoint_sac(smi, os.path.join(root, "sac"))
    return vtrace, nstep


# Phase 15: the host data paths. R2D2 at the Atari R2D2 knobs of phases 6
# and 9 on host envs; the replay in host RAM at phase 9's 10k unrolls, cut
# to the largest multiple of 1000 that fits a quarter of MemAvailable.
# A call runs HOST_R2D2_CYCLES cycles: the minimum size is one cycle's
# items + 1, so the first cycle only fills the replay.
HOST_R2D2_CYCLES, HOST_RESUME_CYCLES, HOST_R2D2_BATCH = 4, 2, 64
HOST_R2D2_TRAINING = R2D2_ENVS - R2D2_EVAL_ENVS
HOST_R2D2_MIN = HOST_R2D2_TRAINING + 1
HOST_REPLAY_RATIO = 0.75  # the JAX CLI's default
HOST_REPLAY_UNROLLS = 10_000
# One replay item at that shape: 121 steps of an 84x84 uint8 frame, int32
# previous and played actions, f32 reward, bool done and abandoned, int32
# episode step and 18 f32 Q values; the 84x84x3 frame history and the LSTM
# 512's (c, h).
HOST_REPLAY_ITEM_BYTES = (121 * (84 * 84 + 4 + 4 + 1 + 1 + 4 + 4 + 18 * 4)
                          + 84 * 84 * 3 + 2 * 512 * 4)
# V-trace at phase 7's shape, 3 steps plain and 3 pipelined, then a
# deterministic eval of HOST_EVAL_EPISODES 1000-step episodes on
# HOST_EVAL_ENVS envs, twice.
HOST_VTRACE_ENVS, HOST_VTRACE_UNROLL, HOST_VTRACE_STEPS = 1024, 32, 3
HOST_EVAL_ENVS = HOST_EVAL_EPISODES = 32
# SAC on the script's own host env: envs, unroll, batch, replay ratio (the
# reference SAC's), cycles.
HOST_SAC_ENVS, HOST_SAC_UNROLL, HOST_SAC_BATCH = 256, 1, 256
HOST_SAC_RATIO, HOST_SAC_CYCLES = 4.0, 3


class HostToyEnv:
    """A numpy twin of the toy env with gymnasium's API: match the observed
    random target with a Box(3) action, 3-step episodes."""

    def __init__(self, n_actions=3, horizon=3):
        from seed_rl_torch.envs.spaces import Box

        self.n_actions, self.horizon = n_actions, horizon
        self.observation_space = Box(-np.inf, np.inf, (n_actions + 1,))
        self.action_space = Box(-1.0, 1.0, (n_actions,))
        self._rng = np.random.RandomState(0)

    def _obs(self):
        self._target = self._rng.uniform(-1, 1, self.n_actions).astype(
            np.float32)
        return np.concatenate([self._target, [0.0]]).astype(np.float32)

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self.t = 0
        return self._obs(), {}

    def step(self, action):
        reward = -float(np.sum((action - self._target) ** 2))
        self.t += 1
        return self._obs(), reward, self.t >= self.horizon, False, {}

    def close(self):
        pass


def _host_replay_unrolls():
    """HOST_REPLAY_UNROLLS, or the largest multiple of 1000 whose items fit
    a quarter of MemAvailable; and MemAvailable in bytes."""
    with open("/proc/meminfo") as f:
        avail = next(int(line.split()[1]) * 1024 for line in f
                     if line.startswith("MemAvailable:"))
    unrolls = HOST_REPLAY_UNROLLS
    if unrolls * HOST_REPLAY_ITEM_BYTES > avail / 4:
        unrolls = int(avail / 4 // HOST_REPLAY_ITEM_BYTES // 1000 * 1000)
    if unrolls < (HOST_R2D2_CYCLES + 1) * HOST_R2D2_TRAINING:
        raise RuntimeError(f"{avail / 1e9:.1f} GB available: too little "
                           "host RAM for the host R2D2 replay")
    return unrolls, avail


def _rss_gb():
    """The process's resident set now (VmRSS, or "not measured" where the
    kernel does not report it) and at its peak (getrusage), GB."""
    import resource

    now = "not measured"
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                now = f"{int(line.split()[1]) * 1024 / 1e9:.2f}"
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9
    return now, peak


def _owed_batches(cycles, training, batch, ratio, min_size, size):
    """The batches host_offpolicy_loop owes each cycle (its float carry)."""
    owed, inserted, out = 0.0, 0, []
    for _ in range(cycles):
        inserted = min(inserted + training, size)
        n = 0
        if inserted >= min_size:
            owed += ratio * training / batch
            for _ in range(int(owed)):
                owed -= 1.0
                n += 1
        out.append(n)
    return out


class HostTimer:
    """While a phase-15 call runs, wraps the host data path's methods and
    sums their host seconds: inside rollouts, host env stepping, the copies
    (observations up; actions down, after waiting for the policy step,
    which counts as policy time) and whole rollouts; items with their
    initial priorities, inserts, sample waits, train batches (with the
    priority write-back that waits for them), updates, replay saves and
    restores. Marks the time of each insert (off-policy) or update
    (on-policy), and counts batches per insert. With ``profile_rollout``
    the device activity from the start of that rollout to the start of the
    next, or to the end of the call (one cycle on a plain run's main
    thread), is profiled; the window's wall time is taken before the
    profiler stops, and its events are summed after the call."""

    def __init__(self, profile_rollout=None):
        self.profile_rollout = profile_rollout
        self.window_ms = None

    def _patch(self, owner, name, make):
        original = getattr(owner, name)
        self._saved.append((owner, name, original))
        setattr(owner, name, make(original))

    def _timed(self, key, before=None, after=None, only_in_rollout=False):
        timer = self

        def make(original):
            def wrapped(*args, **kw):
                if only_in_rollout and not getattr(timer._local, "active",
                                                   False):
                    return original(*args, **kw)
                if before is not None:
                    before(*args)
                t0 = time.perf_counter()
                result = original(*args, **kw)
                timer.s[key] += time.perf_counter() - t0
                if after is not None:
                    after(result, *args)
                return result
            return wrapped
        return make

    def __enter__(self):
        from seed_rl_torch.agents import r2d2, sac, vtrace
        from seed_rl_torch.agents.ppo import learner as ppo
        from seed_rl_torch.envs.host import HostBatchedEnv
        from seed_rl_torch.replay_host import HostReplayBuffer
        from seed_rl_torch.rollout_host import HostRolloutEngine

        self.s = dict.fromkeys(
            ("env", "copy", "policy_wait", "rollout", "items", "insert",
             "sample_wait", "train", "update", "save", "restore"), 0.0)
        self.batches, self.marks, self.rollouts, self.saves = [], [], 0, 0
        self.replay = self.last_unroll = self._prof = None
        self._profiling = False
        self._saved, self._local = [], threading.local()

        def to_host(original):
            def copy_down(engine, action):
                if not getattr(self._local, "active", False):
                    return original(engine, action)
                t0 = time.perf_counter()
                if action.is_cuda:
                    torch.cuda.current_stream().synchronize()
                t1 = time.perf_counter()
                out = original(engine, action)
                self.s["policy_wait"] += t1 - t0
                self.s["copy"] += time.perf_counter() - t1
                return out
            return copy_down

        def rollout_start(engine, state):
            self.rollouts += 1
            self._local.active = True
            if self.rollouts == self.profile_rollout:
                torch.cuda.synchronize()
                self._prof = torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA])
                self._prof.start()
                self._profiling = True
                self._t0 = time.perf_counter()
            elif self._profiling:
                self._stop_profile()

        def rollout_end(result, engine, state):
            self._local.active = False
            self.last_unroll = result[1]

        def inserted(result, replay, items, priorities):
            self.replay = replay
            self.batches.append(0)
            self.marks.append(time.perf_counter())

        def trained(result, *args):
            self.batches[-1] += 1

        def update_start(*args):
            self.marks.append(time.perf_counter())

        def saved(*args):
            self.saves += 1

        engine = HostRolloutEngine
        self._patch(HostBatchedEnv, "step",
                    self._timed("env", only_in_rollout=True))
        self._patch(engine, "_to_device",
                    self._timed("copy", only_in_rollout=True))
        self._patch(engine, "_to_host", to_host)
        self._patch(engine, "rollout",
                    self._timed("rollout", rollout_start, rollout_end))
        for learner in (r2d2.R2D2HostLearner, sac.SACHostLearner):
            self._patch(learner, "make_items_and_priorities",
                        self._timed("items"))
            self._patch(learner, "train_on_batch",
                        self._timed("train", after=trained))
        for learner in (vtrace.VTraceLearner, ppo.PPOLearner):
            self._patch(learner, "update",
                        self._timed("update", before=update_start))
        self._patch(HostReplayBuffer, "insert",
                    self._timed("insert", after=inserted))
        self._patch(HostReplayBuffer, "wait_sample",
                    self._timed("sample_wait"))
        self._patch(HostReplayBuffer, "update_priorities",
                    self._timed("train"))
        self._patch(HostReplayBuffer, "save", self._timed("save",
                                                          after=saved))
        self._patch(HostReplayBuffer, "restore", self._timed("restore"))
        return self

    def _stop_profile(self):
        torch.cuda.synchronize()
        self.window_ms = (time.perf_counter() - self._t0) * 1e3
        self._prof.stop()
        self._profiling = False

    def __exit__(self, *exc):
        if self._profiling:
            self._stop_profile()
        for owner, name, original in reversed(self._saved):
            setattr(owner, name, original)

    def report(self, name, frames_per_cycle, launches, smi):
        """Prints the cycle's split: the cycle's wall time (the profiled
        window, or without one the last interval between inserts, or
        updates: a rollout and the training of a cycle), rollout parts per
        rollout, main-thread parts per cycle. Returns the cycle's ms."""
        s, cycles = self.s, len(self.marks)
        if self.window_ms is not None:
            cycle_ms, source = self.window_ms, "the profiled cycle"
        else:
            cycle_ms = float(np.diff(self.marks)[-1]) * 1e3
            source = "the main thread's last cycle"
        rollouts = max(self.rollouts, 1)

        def per(key, n=cycles):
            return s[key] / n * 1e3

        policy = (s["rollout"] - s["env"] - s["copy"]) / rollouts * 1e3
        parts = (f"a rollout {per('rollout', rollouts):.1f} ms: host env "
                 f"stepping {per('env', rollouts):.1f} ms, policy steps "
                 f"{policy:.1f} ms (of which waiting for the device before "
                 f"the action copy {per('policy_wait', rollouts):.1f} ms), "
                 f"copies {per('copy', rollouts):.1f} ms")
        if self.batches:
            batches = sum(self.batches)
            parts += (f"; a cycle's items + initial priorities "
                      f"{per('items'):.1f} ms, insert {per('insert'):.1f} "
                      f"ms, sample wait {per('sample_wait'):.1f} ms; train "
                      f"{s['train'] / max(batches, 1) * 1e3:.1f} ms per "
                      f"batch, {batches / cycles:.2f} batches per cycle")
        else:
            parts += f"; update {per('update'):.1f} ms"
        rss, hwm = _rss_gb()
        print(f"{name}: cycle {cycle_ms:.1f} ms ({source}; averaged over "
              f"{self.rollouts} rollouts and {cycles} cycles: {parts}); "
              f"{frames_per_cycle / cycle_ms * 1e3:.1f} env frames/s; "
              f"hand-kernel launches per cycle "
              f"{ {k: v / cycles for k, v in launches.items()} }; peak "
              f"device memory {_peak_memory_gb():.3f} GB; process RSS "
              f"{rss} GB (peak {hwm:.2f} GB) ({smi})")
        if self.window_ms is not None:
            kernels = _device_kernels(self._prof)
            busy = sum(e.self_device_time_total for e in kernels) / 1e3
            count = sum(e.count for e in kernels)
            print(f"{name} profiler: one cycle of {self.window_ms:.1f} ms "
                  f"holds {busy:.3f} ms of device work in {count:.0f} "
                  f"launches: idle share {1 - busy / self.window_ms:.3f} "
                  f"({smi})")
        return cycle_ms


def _host_r2d2_argv(replay_unrolls, cycles):
    return [
        "--agent=r2d2", "--env=synthetic_atari_host",
        f"--num_envs={R2D2_ENVS}", f"--num_eval_envs={R2D2_EVAL_ENVS}",
        f"--unroll_length={R2D2_UNROLL}", f"--burn_in={R2D2_BURN_IN}",
        f"--batch_size={HOST_R2D2_BATCH}", "--n_steps=5",
        "--discounting=0.997", "--learning_rate=1e-4", "--clip_norm=80",
        f"--replay_buffer_size={replay_unrolls}",
        f"--replay_buffer_min_size={HOST_R2D2_MIN}",
        f"--replay_ratio={HOST_REPLAY_RATIO}",
        f"--total_environment_frames={cycles * R2D2_ENVS * R2D2_UNROLL}",
        "--log_every_steps=1",
    ]


def _check_host_offpolicy(name, learner, state, timer, launches, want):
    """Batches per cycle as owed, one B2 launch per insert and per batch,
    finite written-back priorities, the learner's tensors on the card."""
    if timer.batches != want:
        raise RuntimeError(f"{name}: batches per cycle {timer.batches}, the "
                           f"owed formula's {want}")
    if state.step != sum(want):
        raise RuntimeError(f"{name}: step {state.step}, want {sum(want)}")
    if launches != {"vtrace": 0, "nstep": len(want) + sum(want)}:
        raise RuntimeError(f"{name}: kernel launches {launches}, want one "
                           f"B2 per insert ({len(want)}) and per batch "
                           f"({sum(want)})")
    replay = timer.replay
    priorities = replay._priorities[:replay.num_inserted]
    if not np.isfinite(priorities).all():
        raise RuntimeError(f"{name}: non-finite priorities")
    tensors = learner.parameters() + learner.state_tensors(state)
    off_card = [t.device for t in tensors if t.device.type != "cuda"]
    if off_card:
        raise RuntimeError(f"{name}: {len(off_card)} tensors off the card")


def run_host_r2d2(smi, replay_unrolls):
    """Phase 15 (a): R2D2 on synthetic_atari_host through train.main,
    plain then pipelined; returns (B2 launches, max |kernel - plain|)."""
    from seed_rl_torch import train

    want = _owed_batches(HOST_R2D2_CYCLES, HOST_R2D2_TRAINING,
                         HOST_R2D2_BATCH, HOST_REPLAY_RATIO, HOST_R2D2_MIN,
                         replay_unrolls)
    frames = R2D2_ENVS * R2D2_UNROLL
    total, err = 0, 0.0
    for mode, extra in (("plain", []), ("pipelined",
                                        ["--pipeline_host_rollouts"])):
        name = f"host r2d2 synthetic_atari_host {mode}"
        torch.cuda.reset_peak_memory_stats()
        _reset_launch_counts()
        start = time.perf_counter()
        # Plain: profile the third cycle (a trained one), rollout to
        # rollout; the pipelined run's rollouts run on another thread.
        with HostTimer(profile_rollout=3 if mode == "plain" else None) as t:
            learner, state, logs = train.main(
                _host_r2d2_argv(replay_unrolls, HOST_R2D2_CYCLES) + extra)
            torch.cuda.synchronize()
        launches = _launches()
        total += launches["nstep"]
        _check_host_offpolicy(name, learner, state, t, launches, want)
        _finite(name, logs)
        replay = t.replay
        print(f"{name}: {HOST_R2D2_CYCLES} cycles ({R2D2_ENVS} envs, "
              f"{R2D2_EVAL_ENVS} eval, unroll {R2D2_UNROLL} + burn-in "
              f"{R2D2_BURN_IN}), batches per cycle {t.batches} as owed "
              f"({HOST_REPLAY_RATIO} x {HOST_R2D2_TRAINING} / "
              f"{HOST_R2D2_BATCH} a cycle); "
              f"B2 launches {launches['nstep']}; replay {replay.num_inserted}"
              f" of {replay.size} unrolls, {replay.nbytes() / 1e9:.3f} GB "
              f"allocated in host RAM; losses/td="
              f"{float(logs['losses/td']):.6f} ({smi})")
        t.report(name, frames, launches, smi)
        if mode == "plain":
            _, _, items = replay.sample(HOST_R2D2_BATCH,
                                        learner.priority_exponent)
            err = check_nstep_on_batch(name, learner, items)
        del replay, t, learner
        _print_path_end(name, start)
    return total, err


def run_host_vtrace(smi, logdir):
    """Phase 15 (b): V-trace on synthetic_atari_host through train.main,
    plain (into ``logdir``) then pipelined, then --run_mode=eval twice from
    the plain run's parameters; returns (B1 launches, max |kernel -
    plain|)."""
    from seed_rl_torch import train
    from seed_rl_torch.agents import vtrace as vtrace_agent
    from seed_rl_torch.ops import vtrace as plain
    from seed_rl_torch.ops.cuda import vtrace_kernel

    envs, unroll, steps = HOST_VTRACE_ENVS, HOST_VTRACE_UNROLL, \
        HOST_VTRACE_STEPS
    base = ["--agent=vtrace", "--env=synthetic_atari_host",
            f"--num_envs={envs}", f"--unroll_length={unroll}",
            f"--total_environment_frames={steps * envs * unroll}",
            "--log_every_steps=1"]
    total, err = 0, 0.0
    for mode, extra in (("plain", [f"--logdir={logdir}"]),
                        ("pipelined", ["--pipeline_host_rollouts"])):
        name = f"host vtrace synthetic_atari_host {mode}"
        torch.cuda.reset_peak_memory_stats()
        _reset_launch_counts()
        start = time.perf_counter()
        with HostTimer(profile_rollout=2 if mode == "plain" else None) as t:
            learner, state, metrics = train.main(base + extra)
            torch.cuda.synchronize()
        launches = _launches()
        total += launches["vtrace"]
        # Pipelined, the last collected unroll is trained on too.
        want = steps + (mode == "pipelined")
        if state.step != want or launches != {"vtrace": want, "nstep": 0}:
            raise RuntimeError(f"{name}: {state.step} steps, launches "
                               f"{launches}; want {want} steps, one B1 each")
        _finite(name, metrics)
        tensors = list(learner.parameters()) + learner.state_tensors(state)
        if any(x.device.type != "cuda" for x in tensors):
            raise RuntimeError(f"{name}: tensors off the card")
        t.report(name, envs * unroll, launches, smi)
        if mode == "plain":
            with torch.no_grad():
                inputs, _ = vtrace_agent.vtrace_inputs(
                    learner.config, learner.agent,
                    learner.agent.distribution, t.last_unroll)
            got = vtrace_kernel.from_importance_weights(**inputs)
            ref = plain.from_importance_weights(**inputs)
            torch.cuda.synchronize()
            for g, w in zip(got, ref):
                torch.testing.assert_close(g, w, rtol=VTRACE_TOL,
                                           atol=VTRACE_TOL)
                err = max(err, float((g - w).abs().max()))
            print(f"{name}: vtrace on the run's last unroll "
                  f"{list(inputs['rewards'].shape)} matches the plain "
                  f"version, max|err|={err:.3e} (tol {VTRACE_TOL})")
        del t, learner
        _print_path_end(name, start)

    results = []
    for _ in range(2):
        t0 = time.perf_counter()
        _reset_launch_counts()
        _, _, metrics = train.main([
            "--agent=vtrace", "--env=synthetic_atari_host",
            f"--num_envs={HOST_EVAL_ENVS}", f"--unroll_length={unroll}",
            "--run_mode=eval", f"--eval_episodes={HOST_EVAL_EPISODES}",
            f"--init_checkpoint={logdir}"])
        if any(_launches().values()):
            raise RuntimeError(f"host eval launched {_launches()}")
        print(f"host vtrace eval: {metrics} in {time.perf_counter() - t0:.3f}"
              f" s ({HOST_EVAL_ENVS} host envs, the plain run's parameters, "
              f"deterministic) ({smi})")
        results.append(metrics)
    if results[0]["eval/num_episodes"] < HOST_EVAL_EPISODES:
        raise RuntimeError(f"host eval ran {results[0]} episodes")
    if results[0] != results[1]:
        raise RuntimeError(f"host eval is not repeatable: {results}")
    print("host vtrace eval: the two runs from one seed are equal")
    return total, err


def run_host_ppo(smi):
    """Phase 15 (c): PPO on synthetic_atari_host at phase 11's knobs."""
    from seed_rl_torch import train

    path = PPO_PATHS["ppo_synthetic_atari"]
    name = "host ppo synthetic_atari_host"
    argv = ["--agent=ppo", "--env=synthetic_atari_host",
            *path.flags[1:], f"--num_envs={path.envs}",
            f"--unroll_length={path.unroll}",
            f"--epochs_per_step={path.epochs}",
            f"--batches_per_step={path.minibatches}",
            "--total_environment_frames="
            f"{PPO_STEPS * path.envs * path.unroll}",
            "--log_every_steps=1"]
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    start = time.perf_counter()
    # Profile the second step, to the end of the call.
    with HostTimer(profile_rollout=2) as t:
        learner, state, metrics = train.main(argv)
        torch.cuda.synchronize()
    launches = _launches()
    updates = PPO_STEPS * path.epochs * path.minibatches
    if state.step != PPO_STEPS or learner.optimizer.count != updates:
        raise RuntimeError(f"{name}: {state.step} steps, "
                           f"{learner.optimizer.count} updates")
    if any(launches.values()):
        raise RuntimeError(f"{name}: launched {launches}")
    _finite(name, metrics)
    t.report(name, path.envs * path.unroll, launches, smi)
    _print_path_end(name, start)


def run_host_sac(smi, device):
    """Phase 15 (d): SACHostLearner through host_offpolicy_loop on
    HostToyEnv, ActorCriticMLP at its default width, replay ratio 4."""
    import functools

    from seed_rl_torch import distributions as pd
    from seed_rl_torch import optim
    from seed_rl_torch.agents import sac
    from seed_rl_torch.envs.host import HostBatchedEnv
    from seed_rl_torch.host_offpolicy import host_offpolicy_loop
    from seed_rl_torch.models import ActorCriticMLP
    from seed_rl_torch.replay_host import HostReplayBuffer
    from seed_rl_torch.rollout_host import HostRolloutEngine

    name = "host sac HostToyEnv"
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    start = time.perf_counter()
    envs, unroll, batch = HOST_SAC_ENVS, HOST_SAC_UNROLL, HOST_SAC_BATCH
    env = HostBatchedEnv(lambda i: HostToyEnv(), envs, num_threads=16)
    try:
        dist = pd.get_parametric_distribution_for_action_space(
            env.action_space)
        net = ActorCriticMLP(dist.param_size, env.observation_spec(),
                             n_critics=2, device=device)
        agent = sac.SACAgent(net, dist)
        config = sac.SACConfig(batch_size=batch, unroll_length=unroll,
                               replay_buffer_min_size=envs)
        learner = sac.SACHostLearner(
            agent, config, functools.partial(
                optim.ClippedAdam, learning_rate=3e-4, clip_norm=40.0),
            envs, unroll, seed=2)
        engine = HostRolloutEngine(env, agent, unroll, device=device, seed=1)
        replay = HostReplayBuffer(config.replay_buffer_size, 0.0,
                                  device=device)
        with HostTimer(profile_rollout=2) as t:
            state, logs = host_offpolicy_loop(
                learner, engine, replay,
                HOST_SAC_CYCLES * envs * unroll, replay_ratio=HOST_SAC_RATIO,
                replay_buffer_min_size=envs)
            torch.cuda.synchronize()
    finally:
        env.close()
    want = _owed_batches(HOST_SAC_CYCLES, envs, batch, HOST_SAC_RATIO, envs,
                         config.replay_buffer_size)
    if t.batches != want or state.step != sum(want) or (
            learner.optimizer.count != sum(want)):
        raise RuntimeError(f"{name}: batches {t.batches}, want {want}")
    if any(_launches().values()):
        raise RuntimeError(f"{name}: launched {_launches()}")
    _finite(name, logs)
    tensors = learner.parameters() + learner.state_tensors(state)
    if any(x.device.type != "cuda" for x in tensors):
        raise RuntimeError(f"{name}: tensors off the card")
    print(f"{name}: {HOST_SAC_CYCLES} cycles of {envs} envs x {unroll}, "
          f"batches per cycle {t.batches} as owed (ratio {HOST_SAC_RATIO}, "
          f"batch {batch}), ActorCriticMLP (256, 256), 2 critics; "
          f"losses/total={float(logs['losses/total']):.6f} ({smi})")
    t.report(name, envs * unroll, _launches(), smi)
    _print_path_end(name, start)


def run_host_resume(smi, replay_unrolls, logdir):
    """Phase 15 (e): (a)'s path with --logdir --checkpoint_replay: 2
    cycles, a save, then a resume of 2 cycles; the restored learner state
    and replay must equal the saved ones bitwise. Returns B2 launches."""
    from seed_rl_torch import train
    from seed_rl_torch.replay_host import HostReplayBuffer
    from seed_rl_torch.utils import checkpoint as ckpt

    name = "host r2d2 resume"
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    argv = _host_r2d2_argv(replay_unrolls, HOST_RESUME_CYCLES) + [
        f"--logdir={logdir}", "--checkpoint_replay"]
    frames = R2D2_ENVS * R2D2_UNROLL
    _reset_launch_counts()
    with HostTimer() as first:
        learner, state, _ = train.main(argv)
        torch.cuda.synchronize()
    launches = [_launches()]
    saved = ckpt.to_saveable(learner.checkpoint_state(state))
    saved_replay = first.replay
    del learner

    checked = []
    restore = HostReplayBuffer.restore

    def compare_restore(replay, directory):
        if not restore(replay, directory):
            return False
        n = saved_replay.num_inserted
        if (replay.num_inserted, replay.insert_index) != (
                n, saved_replay.insert_index):
            raise RuntimeError(f"{name}: restored cursors differ")
        if not np.array_equal(replay._priorities, saved_replay._priorities):
            raise RuntimeError(f"{name}: restored priorities differ")
        # Rows past num_inserted were never written in either: zeros.
        for got, want in zip(replay._storage, saved_replay._storage,
                             strict=True):
            if (got.dtype != want.dtype or got.shape != want.shape
                    or not np.array_equal(got[:n], want[:n])):
                raise RuntimeError(f"{name}: a restored replay leaf differs")
        checked.append(replay.nbytes())
        return True

    restored = []
    restore_or = ckpt.CheckpointManager.restore_or

    def record_restore(manager, learner, state):
        state = restore_or(manager, learner, state)
        restored.append(ckpt.to_saveable(learner.checkpoint_state(state)))
        return state

    _reset_launch_counts()
    HostReplayBuffer.restore = compare_restore
    ckpt.CheckpointManager.restore_or = record_restore
    try:
        with HostTimer() as second:
            learner, state, _ = train.main(argv)
            torch.cuda.synchronize()
    finally:
        HostReplayBuffer.restore = restore
        ckpt.CheckpointManager.restore_or = restore_or
    launches.append(_launches())
    if not checked or len(restored) != 1:
        raise RuntimeError(f"{name}: nothing restored")
    tensors = _assert_trees_equal(restored[0], saved,
                                  f"{name}: the restored learner state")
    want = [
        _owed_batches(HOST_RESUME_CYCLES, HOST_R2D2_TRAINING,
                      HOST_R2D2_BATCH, HOST_REPLAY_RATIO, HOST_R2D2_MIN,
                      replay_unrolls),
        # Restored full enough to train from the first cycle; the owed
        # carry starts at 0 again, as in the JAX package.
        _owed_batches(HOST_RESUME_CYCLES, HOST_R2D2_TRAINING,
                      HOST_R2D2_BATCH, HOST_REPLAY_RATIO, 0, replay_unrolls)]
    got = [first.batches, second.batches]
    want_launches = [{"vtrace": 0, "nstep": len(w) + sum(w)} for w in want]
    if got != want or launches != want_launches:
        raise RuntimeError(f"{name}: batches {got}, launches {launches}; "
                           f"want {want}, {want_launches}")
    if second.replay.num_inserted != (
            2 * HOST_RESUME_CYCLES * HOST_R2D2_TRAINING):
        raise RuntimeError(f"{name}: {second.replay.num_inserted} items "
                           "after the resume")
    gb = saved_replay.nbytes() * saved_replay.num_inserted / (
        saved_replay.size * 1e9)
    print(f"{name}: saved the replay ({saved_replay.num_inserted} unrolls, "
          f"{gb:.3f} GB at the last save) in {first.s['save']:.3f} s over "
          f"{first.saves} saves, restored it in "
          f"{second.s['restore']:.3f} s: equal to the saved one bitwise "
          f"({len(saved_replay._storage)} leaves, priorities, cursors); "
          f"the learner state's {tensors} tensors equal bitwise; batches "
          f"per cycle {got}, B2 launches {launches} ({smi})")
    _print_path_end(name, start)
    return sum(x["nstep"] for x in launches)


def run_host_paths(smi, device):
    """Phase 15; returns (B1 launches, B2 launches, B1 max err, B2 max
    err)."""
    unrolls, avail = _host_replay_unrolls()
    print(f"host replay: {unrolls} unrolls x {HOST_REPLAY_ITEM_BYTES} bytes "
          f"= {unrolls * HOST_REPLAY_ITEM_BYTES / 1e9:.2f} GB, within a "
          f"quarter of MemAvailable {avail / 1e9:.1f} GB ({smi})")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_host_") as root:
        nstep, nstep_err = run_host_r2d2(smi, unrolls)
        vtrace, vtrace_err = run_host_vtrace(smi, os.path.join(root, "vt"))
        run_host_ppo(smi)
        run_host_sac(smi, device)
        nstep += run_host_resume(smi, unrolls, os.path.join(root, "r2d2"))
    return vtrace, nstep, vtrace_err, nstep_err


def _rollout_and_update(learner):
    """An on-policy train step's two halves: the rollout, then the update
    on its unroll."""
    def rollout(state):
        rollout_state, unroll = learner.engine.rollout(state.rollout)
        return state._replace(rollout=rollout_state), unroll

    def update(carry):
        return learner.update(*carry)[0]

    return rollout, update


def time_train_steps(state, first_half, second_half, steps):
    """Time ``steps`` train steps, each as its two halves with a synchronize
    after each half, on a path that train.main has already warmed; returns
    the state, the mean step time and the mean time of each half (s)."""
    spent = [0.0, 0.0]
    for _ in range(steps):
        t0 = time.perf_counter()
        carry = first_half(state)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state = second_half(carry)
        torch.cuda.synchronize()
        spent[0] += t1 - t0
        spent[1] += time.perf_counter() - t1
    halves = tuple(s / steps for s in spent)
    return state, sum(halves), halves


def _print_path_end(name, start):
    print(f"{name}: peak device memory {_peak_memory_gb():.3f} GB "
          f"(torch.cuda.max_memory_allocated); the path took "
          f"{time.perf_counter() - start:.1f} s in all")


def _device_kernels(prof):
    """Kernel rows of a profile; annotation ranges that also appear as host
    ops (e.g. ``Optimizer.step#Adam.step``) would count their kernels twice."""
    from torch.autograd import DeviceType

    rows = prof.key_averages()
    host = {e.key for e in rows if e.device_type == DeviceType.CPU}
    return [e for e in rows
            if e.device_type == DeviceType.CUDA and e.key not in host]


def profile_device_time(learner, state, step_s, what):
    """Device busy time of one train step from torch.profiler, and the idle
    share against the unprofiled step time. Only the device activity is
    traced: with the host's operators too, summing the PPO toy step's
    events took 95 s of the script's 212 s on an H100."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        learner.train_step(state)
        torch.cuda.synchronize()
    kernels = _device_kernels(p)
    profile_s = time.perf_counter() - t0
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    if busy_us == 0:
        print(f"{what} profiler: no device time recorded; device busy share "
              "not measured")
        return
    print(f"{what} profiler: device busy {busy_us / 1e3:.3f} ms per step over "
          f"{launches:.0f} kernel launches; idle share "
          f"{1 - busy_us / 1e6 / step_s:.3f} of the {step_s * 1e3:.3f} ms step"
          f" (profiled and summed in {profile_s:.1f} s)")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms/step "
              f"{e.count:6.0f}x  {e.key[:90]}")


def main():
    start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device visible to torch", file=sys.stderr)
        return 1
    from seed_rl_torch.ops.cuda import build  # fails outside a checkout

    device = torch.device("cuda", 0)
    device_name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    # The precision convolutions and matrix products run at: PyTorch's
    # defaults, which neither this script nor the port changes.
    print(f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}"
          f" (convolutions), torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} (matrix products)")

    t0 = time.perf_counter()
    build.build(["vtrace_kernel", "nstep_kernel"])
    print(f"built kernels in {time.perf_counter() - t0:.1f} s")
    for name, log in build.build_logs.items():
        print(f"--- nvcc {name}\n{log.strip()}")

    vtrace_err = check_vtrace_kernel(device)
    nstep_err = check_nstep_kernel(device)
    check_pool(device)
    floor_ms = time_launch_floor(device)
    vtrace_times = time_vtrace_kernel(device, floor_ms)
    nstep_times = time_nstep_kernel(device, floor_ms)
    print(f"phases 1-4 (build, kernel checks, kernel timings) done at "
          f"{time.perf_counter() - start:.1f} s")
    vtrace_launches, nstep_launches = {}, {}
    vtrace_launches["toy"], err, _ = run_vtrace(smi, "toy")
    vtrace_err = max(vtrace_err, err)
    nstep_launches["discrete_match"], err = run_r2d2(smi, "discrete_match")
    nstep_err = max(nstep_err, err)
    for name in ("synthetic_atari", "catch_impala_deep"):
        vtrace_launches[name], err, learner = run_vtrace(smi, name)
        vtrace_err = max(vtrace_err, err)
    run_eval_twice(learner)
    nstep_launches["synthetic_atari"], err = run_r2d2(smi, "synthetic_atari")
    nstep_err = max(nstep_err, err)
    ppo_launches = {name: run_ppo(smi, name) for name in PPO_PATHS}
    sac_launches = {name: run_sac(smi, name) for name in SAC_PATHS}
    t0 = time.perf_counter()
    vtrace_launches["checkpoints"], nstep_launches["checkpoints"] = (
        run_checkpoint_paths(smi))
    print(f"phase 14 (checkpoints, logs, export, eval, profile) took "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    (vtrace_launches["host"], nstep_launches["host"], vtrace_host_err,
     nstep_host_err) = run_host_paths(smi, device)
    vtrace_err = max(vtrace_err, vtrace_host_err)
    nstep_err = max(nstep_err, nstep_host_err)
    print(f"phase 15 (the host data paths) took "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"vtrace launches per path: {vtrace_launches} (one per train "
          f"step); nstep launches per path: {nstep_launches} (one per insert "
          f"and per train batch); PPO paths: {ppo_launches}; SAC paths: "
          f"{sac_launches}")

    kernels = []
    for name, replaces, launches, err, times, extra in (
        # The [32, 1024] shape's numbers at the top level, the Catch
        # path's [20, 256] under "catch".
        ("vtrace", "seed_rl_tpu/ops/pallas/vtrace_kernel.py:29",
         sum(vtrace_launches.values()), vtrace_err, vtrace_times["main"],
         {"catch": vtrace_times["catch"]}),
        # The loss shape's numbers at the top level, the insert shape's
        # under "insert".
        ("nstep", "seed_rl_tpu/ops/pallas/nstep_kernel.py:36",
         sum(nstep_launches.values()), nstep_err, nstep_times["loss"],
         {"insert": nstep_times["insert"]}),
    ):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"seed_rl_torch/csrc/{name}_kernel.cu",
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": err,
            **times,
            # No single PyTorch call computes V-trace or the n-step targets.
            "library_ms": None,
            **extra,
        })
    print(f"chip_smoke.py: all phases passed in "
          f"{time.perf_counter() - start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
