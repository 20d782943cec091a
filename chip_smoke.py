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
     kernels' run counts reset just before; check one V-trace run per train
     step (counted on the card, as every count of a hand kernel here is:
     ops/cuda/run_count.py), everything on the card, finite metrics, and
     the kernel against its plain version on the run's own unroll; time
     the step, its rollout
     and update halves, its device busy time, launches and idle share
     (torch.profiler), and print the peak device memory;
  6. train R2D2 on discrete_match through seed_rl_torch.train.main at the
     default VectorDuelingDQNNet width with the reference Atari R2D2 knobs
     (640 envs, 30 of them eval, unroll 80, burn-in 40, batch 64, n 5,
     gamma 0.997, lr 1e-4, clip 80, a 10k-unroll replay): 2 warmup
     rollouts, then 4 train steps, with the run counts reset just before;
     check one n-step run per insert and per train batch (each replay of
     the update's CUDA graph counts as it runs), everything
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
         within 1e-5; then its sampling policy (deterministic=False), whose
         draws the loaded policy makes from a torch.Generator on the card:
         its actions must equal policy_step(generator=...)'s on a
         generator of the same seed and its new state be within 1e-5;
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
         2 cycles, the first only filling the replay, plain and then with
         --pipeline_host_rollouts; the batches of each cycle must be the
         owed formula's, B2 launched once per insert and per batch, the
         written-back priorities finite, the learner on the card, and B2
         equal to its plain version on a batch of the run's own replay;
     (b) V-trace with AtariPolicyNet at phase 7's shape, 2 steps plain (one
         B1 launch each, B1 against its plain version on the run's last
         unroll) and 2 pipelined (3 launches: the last unroll is trained
         on), then --run_mode=eval on 32 host envs from the plain run's
         parameters, twice: the two results must be equal;
     (c) PPO with AtariPolicyNet at phase 11's knobs, 2 steps;
     (d) SAC through host_offpolicy_loop on HostToyEnv (this script's numpy
         toy env, Box actions), ActorCriticMLP (256, 256), replay ratio 4,
         3 cycles;
     (e) (a)'s path with --logdir --checkpoint_replay and a minimum size
         of one cycle's items: 1 cycle (filling the replay, then training
         on it), then a resumed call of 1 (training from the restored
         replay): the restored learner state (the trained online and
         target nets, Adam's state, the step) and replay (items, the
         priorities the batches wrote back, cursors) must equal the saved
         ones bitwise, and the saved step must be past 0; the replay's GB
         and its save and restore seconds are printed.
     Each path prints its cycle's ms split into host env stepping, policy
     steps, copies, items, insert, sample wait and train ms per batch,
     env frames/s, launches per cycle, the device idle share over one
     profiled cycle, peak device memory and process RSS;
 16. the remote-actor paths: the learner in this process through
     seed_rl_torch.train.main(--run_mode=learner) on the card (SAC through
     remote.run_remote_offpolicy_learner), its actors processes of the
     CLI's actor loop (remote.actor_main) through this script's
     remote_atari_actor on synthetic_atari_host with episodes of 40 steps
     (SAC's: remote_sac_actor on HostToyEnv), 32 envs each, at a unix
     socket in the temp directory; the launch counts reset just before
     each path:
     (a) V-trace with AtariPolicyNet, the learner named with the device
         env synthetic_atari (its specs only: it builds no batched env),
         its 4 actors (128 envs) on synthetic_atari_host, unroll 32, 3
         updates: one B1 launch each, B1 against its plain version on the
         last unroll updated on;
     (b) R2D2 at phase 6's knobs with DuelingLSTMDQNNet, 4 actors,
         --replay_ratio=0.75 (insertion batches of 85), a 1000-unroll host
         replay that trains from its second insert, 5 inserts: actor 0 is
         killed (SIGKILL) after the first insert and replaced on its env
         ids, and the learner holds its later inserts until an episode of
         the replacement's is counted; B2 once per insert and per batch,
         and against its plain version on a batch of the replay;
     (c) PPO with AtariPolicyNet at phase 11's knobs, 2 actors, 2 steps;
     (d) SAC with ActorCriticMLP (256, 256), 2 actors, batch 256, ratio 4,
         5 inserts.
     Each path holds the learner's completed returns against the actors'
     own, life by life, exactly (the replaced actor's running episodes
     left out), requires every actor to stop cleanly without having
     initialised CUDA, and prints the server's requests/s, batches/s and
     batch fill, the handler's ms per batch in three parts, the learner's
     waits for unrolls, its update or train-batch ms, env frames/s
     trained (less (b)'s hold of the inserts), the device idle share over one profiled update or cycle,
     peak device memory and RSS, and the actors' inference and env-step
     timings;
 17. data-parallel scale-out, each path through seed_rl_torch.train.main,
     first on one rank (no process group), then on two ranks that share
     cuda:0 over gloo (NCCL refuses two ranks on one device; gloo is named,
     not fallen back to), from the same seed, TF32 off in both:
     (a) V-trace on synthetic Atari frames with AtariPolicyNet, 1024 envs x
         unroll 32 (512 a rank), 2 steps;
     (b) R2D2 on discrete_match at phase 6's knobs (640 envs with 30 eval:
         rank 1 holds 290 training and 30 eval envs; a 10k-unroll replay,
         5k slots a rank), 2 warm-ups and 2 steps;
     (c) PPO on the toy env at phase 10's knobs but 2 epochs a step (of
         its 10; each epoch is 32 gloo all-reduces through the host), 1
         step;
     (d) SAC on catch_continuous at phase 12's knobs, 2 steps.
     Each must match the one-rank run (the parameters within 2e-3 of their
     movement, every metric within rtol 1e-4 / atol 1e-5), hold its
     replicated tensors bitwise equal on both ranks, and, on (a) and (b),
     launch B1 or B2 on every rank and match the plain version on the
     rank's own unroll, insert and share of a batch within 1e-5. Each rank
     prints its envs and replay slots, its step ms, gradient all-reduce ms,
     idle share and peak memory; (b) also a checkpoint, gathered to rank
     0's CPU, and the device memory the gather took. (e) V-trace on the toy
     env at phase 5's shape in a one-rank NCCL group: its all-reduce calls
     and NCCL's kernel of the gradient average must appear in the profile
     of a step;
 18. the port's bench, seed_rl_torch.bench, on the card: each of its
     seven workloads (bench.py's: PPO on the toy env, visual SAC on
     continuous Catch, V-trace with GFootball on synthetic Football
     frames, conv PPO, V-trace with ImpalaDeep on synthetic DmLab frames,
     V-trace with AtariPolicyNet, R2D2 with DuelingLSTMDQNNet, the torsos
     in bf16) at bench.py's widths, with one window of one call after the
     warm-up call, the launch counts reset just before; every line must
     carry bench.py's metric name in bench.py's order, a finite value > 0,
     a spread, 0 < mfu <= 1 and a null vs_baseline. One V-trace launch per
     train step and one n-step launch per insert and per batch; B1 on the
     first unroll of each V-trace workload and B2 on R2D2's last sampled
     batch, recorded as the paths ran, against their plain versions within
     phase 3's limits; and on one batch of frames, the bf16 AtariPolicyNet
     and DuelingLSTMDQNNet run every convolution and their torso and LSTM
     matrix products in bf16 (the heads in f32), and their outputs differ
     from the same nets' in f32 by more than f32 noise and less than a bf16
     limit;
 19. the CLI's last branches and the port's tooling, each through
     seed_rl_torch.train.main (or the tool's own main) on the card, f32, at
     full width, printing each path's seconds, step ms and peak GB:
     (a) PPO on the toy env with --agent_module=seed_rl_torch/examples/
         custom_ppo_composition.py at phase 10's knobs, 1 step: the
         composed 3x128 ContinuousControlNet, a finite loss, and the
         optimizer's learning rate after the step equal to the cosine
         schedule at its update count;
     (b) SAC on discrete_match, 256 envs, batch 256, 3 steps;
     (c) SAC on catch_continuous with --normalize_observations at phase
         12's shape, 2 steps: one statistic for the frames' channel;
     (b) and (c) hold their loss, metrics and gradients on the card
         against the CPU on a batch of their replay, as phase 12 does;
     (d) V-trace on synthetic_atari_host with --normalize_observations,
         256 envs x unroll 32, 2 cycles: one V-trace launch an update, B1
         on the run's last unroll against its plain version;
     (e) C6, uint16 frames gathered on the card: a PPO learner with
         GFootball over 256 synthetic Football envs, unroll 32, 2 epochs x
         8 split minibatches, 1 step; then the rollout's frames into a
         device PrioritizedReplay and a prioritized sample, bit for bit the
         same sample taken on the CPU;
     (f) the R2D2 replay soak harness (python -m
         seed_rl_torch.tools.soak_r2d2_replay) at 2000 unrolls for 10 s,
         its JSON line printed: one n-step launch for its items and one a
         train batch, B2 on its last batch against its plain version;
 20. the measurement tools of seed_rl_torch/tools/, in a child process of
     this script (a fresh profiler: after phases 14-19's traces, this
     process's recorded part of a row's kernels), each through its main
     on the card, in this order, at reduced sizes (TOOLS_ARGS), the launch
     counts reset just before each, printing each tool's lines and
     seconds: bench_r2d2 (64 envs x 80, 1 call), bench_football (256 x
     32, 2 calls), sweep_bench (256 x 32 x 1 and 1024 x 32 x 2),
     profile_bench (256 x 32), profile_torso (T 32, B 256),
     profile_impala (64 x 32), exp_pool_vjp (2112 frames, the step at 64
     x 32), exp_bwd_decomp and exp_packed_conv (2112 frames),
     profile_ppo_atari (64 x 4) and profile_sac_visual (torso batches 256
     and 8448, sweep 128 x 2 and 256 x 4), 1 iteration a row;
     bench_batcher (64 clients, batch 128, 2 s), bench_fleet (2 actors
     of 8 synthetic_atari_host envs, 2560 frames) and bench_scaling (1
     and 2 gloo ranks on cuda:0, the mlp model, 2 calls). Every rate must
     be finite and > 0
     and each tool's profiled rows must have a device time (one or two
     short kernels may record none; those rows are named; every row of
     exp_packed_conv must have one); profile_impala's mfu against the
     H100's bf16 peak must lie in (0, 1); exp_pool_vjp's two pools must
     give equal outputs and input gradients within 1e-5; exp_packed_conv's
     packed convs must equal the plain one within two bf16 steps of its
     largest output (2 x 2^-7 x max |plain|); bench_scaling's summary must
     carry the JAX script's keys and the shared-card note.
     One V-trace launch per train step, update or loss and one n-step
     launch per insert and per batch in this process (TOOLS_LAUNCHES); B1
     on the first unroll of each V-trace tool and B2 on bench_r2d2's last
     batch against their plain versions within phase 3's limits;
 21. print the V-trace and n-step launches of each path, and the kernels
     line (JSON): for each kernel, at its main-path shape, the wrapper's ms
     per call, the kernel's device-only ms, the plain version's ms, the
     bound and the launch floor (the V-trace kernel: [32, 1024], and the
     Catch path's [20, 256] under "catch"; the n-step kernel: the loss
     shape, and the insert shape under "insert"); V-trace's launches are
     those of all three V-trace paths and of phases 14's to 20's, the
     n-step kernel's those of both R2D2 paths and of phases 14's to 20's,
     with phase 17's shapes on the ranks under "scale_out_shapes".
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
import signal
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
PPO_STEPS, PPO_TIMED_STEPS = 2, 1


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
EXPORT_SEED = 1234  # the sampling policy's generators
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
    launches = _launches()["vtrace"]
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
    """Both hand kernels' run counts (``ops/cuda/run_count.py``, kept on
    the card) to 0, just before a path is driven."""
    from seed_rl_torch.ops.cuda import run_count

    run_count.reset()


def run_r2d2(card, env):
    """Phases 6 and 9: R2D2 through the CLI entry point, at the reference
    knobs; returns (the path's n-step launches, max |kernel - plain| on
    the run's own batch)."""
    from seed_rl_torch import train

    name = f"r2d2 {env}"
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    start = time.perf_counter()
    learner, state, metrics = train.main(_r2d2_argv(env))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    launches = _launches()["nstep"]
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
    kw = dict(gamma=config.discounting, n_steps=config.n_steps,
              rescaling_eps=config.value_function_rescaling_epsilon)
    return _check_nstep_batch(name, q, args, kw)


def _check_nstep_batch(name, q, args, kw):
    """The n-step kernel on a batch's loss inputs (online Q ``q``, then the
    rest of ``loss_inputs``), against the plain version, with the gradient
    of the summed loss in ``q``; loss and priorities must be finite.
    Returns max |err|."""
    q_kernel, q_plain = (q.clone().requires_grad_(True) for _ in range(2))
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
    launches = _launches()
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
    launches = _launches()
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
    """Both hand kernels' runs since ``_reset_launch_counts``, counted on
    the card: a replay of a CUDA graph that captured a launch counts as a
    run."""
    from seed_rl_torch.ops.cuda import nstep_kernel, run_count, vtrace_kernel

    return {"vtrace": run_count.read(vtrace_kernel.KERNEL_NAME),
            "nstep": run_count.read(nstep_kernel.KERNEL_NAME)}


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


def _check_sampling_policy(name, policy, agent, rollout, tol):
    """The loaded sampling policy, drawing from a generator on the card,
    against ``agent.policy_step(generator=...)`` on a generator of the
    same seed, on the rollout's own inputs; returns the max |error| of
    the state. Both generators must advance alike."""
    batch = rollout.prev_action.shape[0]
    core = agent.initial_state(batch)
    device = rollout.prev_action.device
    got_rng = torch.Generator(device=device).manual_seed(EXPORT_SEED)
    want_rng = torch.Generator(device=device).manual_seed(EXPORT_SEED)
    action, state = policy(rollout.prev_action, rollout.env_output, core,
                           got_rng)
    with torch.no_grad():
        want, want_state = agent.policy_step(
            rollout.prev_action, rollout.env_output, core,
            generator=want_rng)
    if policy.deterministic or not torch.equal(action, want.action):
        raise RuntimeError(f"{name}: sampled actions differ")
    if not torch.equal(got_rng.get_state(), want_rng.get_state()):
        raise RuntimeError(f"{name}: the generators advanced apart")
    err = 0.0
    for got, w in zip(pytree.tree_leaves(state),
                      pytree.tree_leaves(want_state)):
        err = max(err, float((got.float() - w.float()).abs().max()))
    if not err <= tol:
        raise RuntimeError(f"{name}: exported sampling policy off by {err} "
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
    sampling_dir = os.path.join(logdir, "export_sampling")
    t0 = time.perf_counter()
    export_policy(sampling_dir, learner.agent, state.rollout.prev_action,
                  state.rollout.env_output, deterministic=False)
    export_s = time.perf_counter() - t0
    policy = load_policy(sampling_dir)
    err = _check_sampling_policy(name, policy, learner.agent, state.rollout,
                                 EXPORT_TOL)
    print(f"{name}: sampling policy exported in {export_s:.3f} s "
          f"({len(policy.recipe)} draw(s): "
          f"{[(d.kind, d.shape) for d in policy.recipe]}): actions equal "
          f"to policy_step(generator=...)'s on a generator of the same "
          f"seed, state max|err|={err:.3e} (tol {EXPORT_TOL}) ({smi})")
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
# items + 1, so the first cycle only fills the replay. The resume path's
# minimum is one cycle's items: its first cycle fills the replay and
# trains, so the state it saves is a trained one.
HOST_R2D2_CYCLES, HOST_RESUME_CYCLES, HOST_R2D2_BATCH = 2, 1, 64
HOST_R2D2_TRAINING = R2D2_ENVS - R2D2_EVAL_ENVS
HOST_R2D2_MIN = HOST_R2D2_TRAINING + 1
HOST_RESUME_MIN = HOST_R2D2_TRAINING
HOST_REPLAY_RATIO = 0.75  # the JAX CLI's default
HOST_REPLAY_UNROLLS = 10_000
# One replay item at that shape: 121 steps of an 84x84 uint8 frame, int32
# previous and played actions, f32 reward, bool done and abandoned, int32
# episode step and 18 f32 Q values; the 84x84x3 frame history and the LSTM
# 512's (c, h).
HOST_REPLAY_ITEM_BYTES = (121 * (84 * 84 + 4 + 4 + 1 + 1 + 4 + 4 + 18 * 4)
                          + 84 * 84 * 3 + 2 * 512 * 4)
# V-trace at phase 7's shape, 2 steps plain and 2 pipelined, then a
# deterministic eval of HOST_EVAL_EPISODES 1000-step episodes on
# HOST_EVAL_ENVS envs, twice.
HOST_VTRACE_ENVS, HOST_VTRACE_UNROLL, HOST_VTRACE_STEPS = 1024, 32, 2
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


def _host_r2d2_argv(replay_unrolls, cycles, min_size=HOST_R2D2_MIN):
    return [
        "--agent=r2d2", "--env=synthetic_atari_host",
        f"--num_envs={R2D2_ENVS}", f"--num_eval_envs={R2D2_EVAL_ENVS}",
        f"--unroll_length={R2D2_UNROLL}", f"--burn_in={R2D2_BURN_IN}",
        f"--batch_size={HOST_R2D2_BATCH}", "--n_steps=5",
        "--discounting=0.997", "--learning_rate=1e-4", "--clip_norm=80",
        f"--replay_buffer_size={replay_unrolls}",
        f"--replay_buffer_min_size={min_size}",
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
    """Phase 15 (e): (a)'s path with --logdir --checkpoint_replay:
    HOST_RESUME_CYCLES cycles, a save, then a resume of as many; the
    restored learner state and replay must equal the saved ones bitwise.
    Returns B2 launches."""
    from seed_rl_torch import train
    from seed_rl_torch.replay_host import HostReplayBuffer
    from seed_rl_torch.utils import checkpoint as ckpt

    name = "host r2d2 resume"
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    argv = _host_r2d2_argv(replay_unrolls, HOST_RESUME_CYCLES,
                           HOST_RESUME_MIN) + [
        f"--logdir={logdir}", "--checkpoint_replay"]
    frames = R2D2_ENVS * R2D2_UNROLL
    _reset_launch_counts()
    with HostTimer() as first:
        learner, state, _ = train.main(argv)
        torch.cuda.synchronize()
    launches = [_launches()]
    if state.step == 0:
        raise RuntimeError(f"{name}: nothing trained before the save: a "
                           "fresh learner would equal the saved state")
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
                      HOST_R2D2_BATCH, HOST_REPLAY_RATIO, HOST_RESUME_MIN,
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


# Phase 16: the remote-actor paths. The learner runs in this process on
# the card through seed_rl_torch.train.main(--run_mode=learner ...); its
# actors are processes of this script's remote_atari_actor (the CLI's actor
# mode, remote.actor_main, on synthetic_atari_host's numpy Atari frames
# with episodes of REMOTE_EPISODE steps, so that the learner's returns can
# be held against the actors' own), REMOTE_ACTOR_ENVS envs each, at a
# unix socket in the temp directory. The paths:
# (a) V-trace, 4 actors, unroll 32, 3 updates; (b) R2D2 at the R2D2 knobs
# (unroll 80 + burn-in 40, batch 64, n 5, gamma 0.997, --replay_ratio 0.75:
# insertion batches of 85), a 1000-unroll host replay, 2 inserts before
# training, 4 cycles after the first, one actor killed after the first
# insert and replaced on its env ids; (c) PPO at phase 11's knobs, 2 actors,
# 2 steps; (d) SAC on HostToyEnv (this script's actors), ActorCriticMLP
# (256, 256), batch 256, replay ratio 4, 4 cycles after the first.
REMOTE_ACTOR_ENVS, REMOTE_EPISODE = 32, 40
REMOTE_VTRACE_ACTORS, REMOTE_VTRACE_UNROLL, REMOTE_VTRACE_UPDATES = 4, 32, 3
REMOTE_R2D2_ACTORS, REMOTE_R2D2_REPLAY, REMOTE_R2D2_BATCH = 4, 1000, 64
REMOTE_R2D2_INSERTION = round(REMOTE_R2D2_BATCH / HOST_REPLAY_RATIO)  # 85
REMOTE_R2D2_MIN = 2 * REMOTE_R2D2_INSERTION
REMOTE_PPO_ACTORS = 2
REMOTE_SAC_ACTORS, REMOTE_SAC_BATCH, REMOTE_SAC_RATIO = 2, 256, 4.0
REMOTE_SAC_INSERTION = round(REMOTE_SAC_BATCH / REMOTE_SAC_RATIO)  # 64
REMOTE_TRAIN_CYCLES = 4  # off-policy cycles after the first


class RemoteFleet:
    """The actor processes of one phase-16 path: started with their
    output in files, stopped with SIGTERM (each prints its steps, timings
    and whether CUDA was initialised) or killed with SIGKILL."""

    def __init__(self, name, directory):
        self.name, self.directory = name, directory
        from seed_rl_torch.runtime.transport import unique_socket_path

        self.address = unique_socket_path(f"chip_smoke_{name[:1]}")
        self.lives = []  # (env_id_offset, process, stdout path)

    def start(self, argv, offset):
        out = os.path.join(self.directory,
                           f"{self.name}_{len(self.lives)}.out")
        with open(out, "w") as stdout, open(out + ".err", "w") as stderr:
            proc = subprocess.Popen(
                [sys.executable, *argv], stdout=stdout, stderr=stderr,
                cwd=os.path.dirname(os.path.abspath(__file__)),
                env={**os.environ, "PYTHONPATH": os.path.dirname(
                    os.path.abspath(__file__))})
        self.lives.append((offset, proc, out))

    def start_atari(self, offset):
        self.start(["-c", "import chip_smoke; chip_smoke.remote_atari_actor("
                    f"{self.address!r}, {offset}, {REMOTE_ACTOR_ENVS})"],
                   offset)

    def kill(self, index):
        proc = self.lives[index][1]
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)

    def stop(self):
        """Stops every actor still running, once it can stop cleanly (its
        ``actor_started`` line); returns ({env id: [returns of each life, in
        order]}, the final records). Fails if an actor that was not killed
        gives no final record, exits non-zero or initialised CUDA."""
        deadline = time.time() + 120
        for _, proc, out in self.lives:
            while proc.poll() is None and time.time() < deadline:
                with open(out) as f:
                    if "actor_started" in f.readline():
                        break
                time.sleep(0.1)
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for _, proc, _ in self.lives:
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=60)
                raise RuntimeError(f"{self.name}: an actor ignored SIGTERM")
        lives, finals = {}, []
        for offset, proc, out in self.lives:
            episodes, final = {}, None
            with open(out) as f:
                for line in f:
                    record = json.loads(line)
                    if "actor_episode" in record:
                        ep = record["actor_episode"]
                        episodes.setdefault(ep["env_id"], []).append(
                            ep["return"])
                    elif "actor" in record:
                        final = record["actor"]
            for env_id in range(offset, offset + REMOTE_ACTOR_ENVS):
                lives.setdefault(env_id, []).append(episodes.get(env_id, []))
            if proc.returncode == -signal.SIGKILL:
                continue
            if proc.returncode != 0 or final is None:
                with open(out + ".err") as f:
                    err = f.read()[-3000:]
                raise RuntimeError(f"{self.name}: an actor exited "
                                   f"{proc.returncode}:\n{err}")
            if final["cuda_initialized"]:
                raise RuntimeError(f"{self.name}: an actor initialised CUDA")
            finals.append(final)
        return lives, finals

    def close(self):
        for _, proc, _ in self.lives:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)


def remote_atari_actor(address, offset, num_envs):
    """Phase 16 (a)-(c)'s actor process: --run_mode=actor's loop over
    synthetic_atari_host envs whose episodes last REMOTE_EPISODE steps."""
    from seed_rl_torch.envs.host import HostBatchedEnv
    from seed_rl_torch.envs.synthetic import SyntheticAtariGymEnv
    from seed_rl_torch.remote import actor_main

    actor_main(lambda: HostBatchedEnv(
        lambda i: SyntheticAtariGymEnv(episode_length=REMOTE_EPISODE),
        num_envs, num_threads=min(num_envs, 16)), address,
        env_id_offset=offset)


def remote_sac_actor(address, offset, num_envs):
    """Phase 16 (d)'s actor process: HostToyEnv envs against the learner."""
    from seed_rl_torch.envs.host import HostBatchedEnv
    from seed_rl_torch.remote import actor_main

    actor_main(lambda: HostBatchedEnv(lambda i: HostToyEnv(), num_envs,
                                      num_threads=min(num_envs, 16)),
               address, env_id_offset=offset)


def _split_lives(returns, lives):
    """How many of each actor life's returns the learner's ``returns``
    hold, when they are, life by life in order, all of that life's or all
    but its last (whose done-carrying request the learner may not have
    served); None otherwise."""
    if not lives:
        return [] if not returns else None
    life = lives[0]
    for k in (len(life), len(life) - 1):
        if k >= 0 and returns[:k] == life[:k]:
            rest = _split_lives(returns[k:], lives[1:])
            if rest is not None:
                return [k] + rest
    return None


def _check_returns(name, stats, lives):
    """The learner's completed returns against the actors': exactly equal,
    life by life. Returns (episodes matched, per-life counts by env)."""
    matched, splits = 0, {}
    for env_id, returns in stats.completed_returns.items():
        split = _split_lives(list(returns), lives.get(env_id, []))
        if split is None:
            raise RuntimeError(f"{name}: env {env_id}'s learner returns "
                               f"{list(returns)} are not its actors' "
                               f"{lives.get(env_id)}")
        matched += sum(split)
        splits[env_id] = split
    if not matched:
        raise RuntimeError(f"{name}: the learner completed no episode")
    return matched, splits


class RemoteTimer:
    """While a phase-16 learner runs, wraps the remote runtime's methods:
    keeps the bridge, the server's stats and serving seconds, the learner's
    wait for unrolls and its updates or train batches (each ending in a
    synchronize), the last unroll updated on, the replay and its inserts;
    gives the learner's episode stats a long memory; profiles the device
    from the start of update or cycle ``REMOTE_PROFILED`` to the next. With
    ``hold`` the learner's later inserts wait (at most 120 s) until the
    handler has counted an episode of a replaced actor, so that the learner
    still serves then."""

    def __init__(self, profiled, hold=False):
        self.profiled, self.hold = profiled, hold

    def _patch(self, owner, name, make):
        original = getattr(owner, name)
        self._saved.append((owner, name, original))
        setattr(owner, name, make(original))

    def __enter__(self):
        from seed_rl_torch import remote
        from seed_rl_torch.agents import r2d2, sac, vtrace
        from seed_rl_torch.agents.ppo import learner as ppo
        from seed_rl_torch.replay_host import HostReplayBuffer
        from seed_rl_torch.runtime.actor import InferenceBridge
        from seed_rl_torch.runtime.inference_server import InferenceServer

        self._saved = []
        self.bridge = self.replay = self.last_unroll = self.stats = None
        self.server_stats, self.serve_s = None, None
        self.wait_s, self.update_s = [], []
        self.update_ends, self.inserts = [], 0
        self.first_insert = threading.Event()
        self.replacement_started = threading.Event()
        self.replacement_counted = threading.Event()
        self.held_s = 0.0
        self.window_ms, self._prof = None, None
        timer = self

        def bridge_init(init):
            def wrapped(bridge, *args, **kw):
                init(bridge, *args, **kw)
                timer.bridge = bridge
            return wrapped

        def serve(original):
            def wrapped(server, *args, **kw):
                original(server, *args, **kw)
                timer._t_serve = time.perf_counter()
            return wrapped

        def shutdown(original):
            def wrapped(server):
                if timer.server_stats is None:
                    timer.serve_s = time.perf_counter() - timer._t_serve
                    timer.server_stats = server.stats
                    timer.batch_size = server.batch_size
                return original(server)
            return wrapped

        def next_batch(original):
            def wrapped(bridge, *args, **kw):
                cycle = len(timer.wait_s) + 1
                if cycle == timer.profiled:
                    torch.cuda.synchronize()
                    timer._prof = torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA])
                    timer._prof.start()
                    timer._t0 = time.perf_counter()
                elif cycle == timer.profiled + 1:
                    timer._stop_profile()
                t0 = time.perf_counter()
                out = original(bridge, *args, **kw)
                timer.wait_s.append(time.perf_counter() - t0)
                return out
            return wrapped

        def timed_update(original):
            def wrapped(learner, state, unroll, *args, **kw):
                timer.last_unroll = unroll
                t0 = time.perf_counter()
                out = original(learner, state, unroll, *args, **kw)
                torch.cuda.synchronize()
                timer.update_s.append(time.perf_counter() - t0)
                timer.update_ends.append(time.perf_counter())
                return out
            return wrapped

        def timed_batch(original):
            def wrapped(*args, **kw):
                t0 = time.perf_counter()
                out = original(*args, **kw)
                torch.cuda.synchronize()
                timer.update_s.append(time.perf_counter() - t0)
                return out
            return wrapped

        def insert(original):
            def wrapped(replay, items, priorities):
                if timer.hold and timer.first_insert.is_set():
                    t0 = time.perf_counter()
                    timer.replacement_counted.wait(timeout=120)
                    timer.held_s += time.perf_counter() - t0
                timer.replay = replay
                timer.inserts += 1
                timer.first_insert.set()
                out = original(replay, items, priorities)
                timer.update_ends.append(time.perf_counter())
                return out
            return wrapped

        def stats_init(init):
            def wrapped(stats, num_envs, keep_last=16):
                init(stats, num_envs, keep_last=10**6)
                if timer.stats is None:
                    timer.stats = stats  # the training envs'
            return wrapped

        def accounting(original):
            def wrapped(*args, **kw):
                hook = original(*args, **kw)
                restarted_seen = set()

                def on_timesteps(env_ids, env_output, restarted):
                    if timer.replacement_started.is_set():
                        restarted_seen.update(restarted.tolist())
                    hook(env_ids, env_output, restarted)
                    if restarted_seen & set(
                            env_ids[env_output.done].tolist()):
                        timer.replacement_counted.set()
                return on_timesteps
            return wrapped

        self._patch(InferenceBridge, "__init__", bridge_init)
        self._patch(InferenceBridge, "next_unroll_batch", next_batch)
        self._patch(InferenceServer, "serve", serve)
        self._patch(InferenceServer, "shutdown", shutdown)
        for learner in (vtrace.VTraceLearner, ppo.PPOLearner):
            self._patch(learner, "update", timed_update)
        for learner in (r2d2.R2D2HostLearner, sac.SACHostLearner):
            self._patch(learner, "train_on_batch", timed_batch)
        self._patch(HostReplayBuffer, "insert", insert)
        self._patch(remote.PerEnvEpisodeStats, "__init__", stats_init)
        self._patch(remote, "episode_accounting", accounting)
        return self

    def _stop_profile(self):
        torch.cuda.synchronize()
        self.window_ms = (time.perf_counter() - self._t0) * 1e3
        self._prof.stop()

    def __exit__(self, *exc):
        if self._prof is not None and self.window_ms is None:
            self._stop_profile()
        for owner, name, original in reversed(self._saved):
            setattr(owner, name, original)

    def report(self, name, frames_per_update, launches, finals, smi):
        """Prints the path's server, handler, learner, device and actor
        numbers."""
        stats, secs = self.server_stats, self.serve_s
        fill = stats["total_requests"] / max(stats["total_batches"], 1)
        bridge = self.bridge
        batches = max(bridge.handler_batches, 1)
        h = {k: v / batches * 1e3 for k, v in bridge.handler_seconds.items()}
        print(f"{name} server: {stats['total_requests']} requests and "
              f"{stats['total_batches']} batches in {secs:.1f} s of serving: "
              f"{stats['total_requests'] / secs:.1f} requests/s, "
              f"{stats['total_batches'] / secs:.1f} batches/s, mean batch "
              f"fill {fill:.1f} of --inference_batch_size {self.batch_size}; "
              f"{stats.get('connections', 0)} connections ({smi})")
        total = sum(h.values())
        print(f"{name} handler: {total:.2f} ms per batch: restart "
              f"bookkeeping, gather and upload "
              f"{h['gather_upload']:.2f} ms, policy step "
              f"{h['policy']:.2f} ms, "
              f"download, scatter and store {h['store']:.2f} ms "
              f"({bridge.handler_batches} full batches, "
              f"{bridge.handler_rows / batches:.1f} rows each) ({smi})")
        n = len(self.update_s)
        ends = self.update_ends
        # The harness's hold of the inserts (path (b)) lies between the
        # first insert and the last: it is not the learner's time.
        rate = (frames_per_update * (len(ends) - 1)
                / (ends[-1] - ends[0] - self.held_s)
                if len(ends) > 1 else float("nan"))
        rss, hwm = _rss_gb()
        print(f"{name} learner: waits for unrolls "
              f"{[round(w * 1e3, 1) for w in self.wait_s]} ms per update or "
              f"cycle; {n} updates or train batches of "
              f"{np.mean(self.update_s) * 1e3 if n else float('nan'):.1f} ms "
              f"each (ending in a synchronize); {rate:.1f} env frames/s "
              f"trained from the first update or insert to the last, less "
              f"the {self.held_s:.1f} s the inserts were held; B1 "
              f"launches {launches['vtrace']}, B2 launches "
              f"{launches['nstep']}; peak device memory "
              f"{_peak_memory_gb():.3f} GB; process RSS {rss} GB (peak "
              f"{hwm:.2f} GB) ({smi})")
        if self.window_ms is not None:
            kernels = _device_kernels(self._prof)
            busy = sum(e.self_device_time_total for e in kernels) / 1e3
            count = sum(e.count for e in kernels)
            print(f"{name} profiler: update or cycle {self.profiled}, "
                  f"{self.window_ms:.1f} ms from its wait for unrolls to the "
                  f"next's (or the run's end), holds {busy:.3f} ms of device "
                  f"work in "
                  f"{count:.0f} launches (the handler's policy steps "
                  f"included): idle share {1 - busy / self.window_ms:.3f} "
                  f"({smi})")
        timings = {key: [f[key] for f in finals if key in f]
                   for key in ("actor/elapsed_inference_s",
                               "actor/elapsed_env_step_s")}
        print(f"{name} actors: {len(finals)} stopped cleanly, none "
              f"initialised CUDA; steps {[f['steps'] for f in finals]}; "
              + "; ".join(f"{key} {np.mean(v) * 1e3:.2f} ms (mean of "
                          f"{len(v)})" for key, v in timings.items() if v)
              + f" ({smi})")


def _remote_flags(agent, fleet, envs, unroll, extra=(),
                  env="synthetic_atari_host"):
    return [f"--agent={agent}", f"--env={env}",
            f"--num_envs={envs}", f"--unroll_length={unroll}",
            f"--server_address={fleet.address}",
            "--log_every_steps=1", *extra]


def _check_vtrace_on_unroll(name, learner, unroll):
    from seed_rl_torch.agents import vtrace as vtrace_agent

    with torch.no_grad():
        inputs, _ = vtrace_agent.vtrace_inputs(
            learner.config, learner.agent, learner.agent.distribution,
            unroll)
    return _check_vtrace_inputs(f"{name}: vtrace on the run's last unroll",
                                inputs)


def _check_vtrace_inputs(what, inputs):
    """The V-trace kernel on keyword ``inputs`` against the plain version;
    returns max |err|."""
    from seed_rl_torch.ops import vtrace as plain
    from seed_rl_torch.ops.cuda import vtrace_kernel

    got = vtrace_kernel.from_importance_weights(**inputs)
    ref = plain.from_importance_weights(**inputs)
    torch.cuda.synchronize()
    err = 0.0
    for g, w in zip(got, ref):
        torch.testing.assert_close(g, w, rtol=VTRACE_TOL, atol=VTRACE_TOL)
        err = max(err, float((g - w).abs().max()))
    print(f"{what} {list(inputs['rewards'].shape)} matches the plain "
          f"version, max|err|={err:.3e} (tol {VTRACE_TOL})")
    return err


def _run_remote_path(name, fleet, learn, profiled, hold=False, during=None):
    """Drives one learner with its actors started; returns the timer,
    the learner call's result, the launches, the lives and the finals."""
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    replacer = None
    try:
        with RemoteTimer(profiled, hold=hold) as t:
            if during is not None:
                replacer = threading.Thread(target=during, args=(t,))
                replacer.start()
            result = learn()
            torch.cuda.synchronize()
        launches = _launches()
    finally:
        if replacer is not None:
            replacer.join(timeout=180)
        try:
            lives, finals = fleet.stop()
        finally:
            fleet.close()
    if replacer is not None and replacer.is_alive():
        raise RuntimeError(f"{name}: the actor replacement hung")
    return t, result, launches, lives, finals


def run_remote_vtrace(smi, directory):
    """Phase 16 (a); returns (B1 launches, max |kernel - plain|)."""
    from seed_rl_torch import train

    from seed_rl_torch.remote import SpecHostEnv

    name = "remote vtrace synthetic_atari"
    start = time.perf_counter()
    envs = REMOTE_VTRACE_ACTORS * REMOTE_ACTOR_ENVS
    fleet = RemoteFleet("vtrace", directory)
    # The learner named with the device env: its specs serve the actors'
    # synthetic_atari_host envs.
    flags = _remote_flags("vtrace", fleet, envs, REMOTE_VTRACE_UNROLL,
                          env="synthetic_atari")
    for k in range(REMOTE_VTRACE_ACTORS):
        fleet.start_atari(k * REMOTE_ACTOR_ENVS)
    frames = REMOTE_VTRACE_UPDATES * envs * REMOTE_VTRACE_UNROLL
    t, (learner, state, metrics), launches, lives, finals = _run_remote_path(
        name, fleet, lambda: train.main(
            ["--run_mode=learner", *flags,
             f"--total_environment_frames={frames}"]), profiled=2)
    if state.step != REMOTE_VTRACE_UPDATES or launches != {
            "vtrace": REMOTE_VTRACE_UPDATES, "nstep": 0}:
        raise RuntimeError(f"{name}: {state.step} updates, launches "
                           f"{launches}; want one B1 per update")
    if not isinstance(learner.engine.env, SpecHostEnv):
        raise RuntimeError(f"{name}: the learner's env is "
                           f"{type(learner.engine.env).__name__}")
    _finite(name, metrics)
    matched, _ = _check_returns(name, t.stats, lives)
    print(f"{name}: the learner on synthetic_atari's specs "
          f"{learner.engine.env.observation_spec()}, its "
          f"{REMOTE_VTRACE_ACTORS} actor processes x "
          f"{REMOTE_ACTOR_ENVS} synthetic_atari_host envs, AtariPolicyNet "
          f"(LSTM 256), unroll "
          f"{REMOTE_VTRACE_UNROLL}, {state.step} updates; the learner's "
          f"{matched} completed returns equal the actors' own ({smi})")
    t.report(name, envs * REMOTE_VTRACE_UNROLL, launches, finals, smi)
    err = _check_vtrace_on_unroll(name, learner, t.last_unroll)
    _print_path_end(name, start)
    return launches["vtrace"], err


def run_remote_r2d2(smi, directory):
    """Phase 16 (b): R2D2 with an actor killed after the first insert and
    replaced on its env ids; returns (B2 launches, max |kernel - plain|)."""
    from seed_rl_torch import train

    name = "remote r2d2 synthetic_atari_host"
    start = time.perf_counter()
    envs = REMOTE_R2D2_ACTORS * REMOTE_ACTOR_ENVS
    cycles = 1 + REMOTE_TRAIN_CYCLES
    fleet = RemoteFleet("r2d2", directory)
    flags = _remote_flags("r2d2", fleet, envs, R2D2_UNROLL, (
        f"--burn_in={R2D2_BURN_IN}", f"--batch_size={REMOTE_R2D2_BATCH}",
        "--n_steps=5", "--discounting=0.997", "--learning_rate=1e-4",
        "--clip_norm=80", f"--replay_buffer_size={REMOTE_R2D2_REPLAY}",
        f"--replay_buffer_min_size={REMOTE_R2D2_MIN}",
        f"--replay_ratio={HOST_REPLAY_RATIO}"))
    for k in range(REMOTE_R2D2_ACTORS):
        fleet.start_atari(k * REMOTE_ACTOR_ENVS)
    frames = cycles * REMOTE_R2D2_INSERTION * R2D2_UNROLL
    replaced = {}

    def replace_actor(t):
        if not t.first_insert.wait(timeout=120):
            return
        fleet.kill(0)
        replaced["at"] = time.perf_counter() - start
        t.replacement_started.set()
        fleet.start_atari(0)

    t, (learner, state, logs), launches, lives, finals = _run_remote_path(
        name, fleet, lambda: train.main(
            ["--run_mode=learner", *flags,
             f"--total_environment_frames={frames}"]),
        profiled=3, hold=True, during=replace_actor)
    want = _owed_batches(cycles, REMOTE_R2D2_INSERTION, REMOTE_R2D2_BATCH,
                         HOST_REPLAY_RATIO, REMOTE_R2D2_MIN,
                         REMOTE_R2D2_REPLAY)
    if state.step != sum(want) or t.inserts != cycles or launches != {
            "vtrace": 0, "nstep": cycles + sum(want)}:
        raise RuntimeError(f"{name}: {t.inserts} inserts, {state.step} "
                           f"batches, launches {launches}; want {cycles}, "
                           f"{sum(want)} ({want}) and one B2 each")
    if "at" not in replaced or not t.replacement_counted.is_set():
        raise RuntimeError(f"{name}: no actor was replaced, or no episode "
                           "of the replacement was counted")
    _finite(name, logs)
    matched, splits = _check_returns(name, t.stats, lives)
    from_replacement = sum(s[1] for e, s in splits.items()
                           if e < REMOTE_ACTOR_ENVS and len(s) > 1)
    if not from_replacement:
        raise RuntimeError(f"{name}: no learner return from the replacement")
    replay = t.replay
    print(f"{name}: {REMOTE_R2D2_ACTORS} actor processes x "
          f"{REMOTE_ACTOR_ENVS} envs, DuelingLSTMDQNNet (LSTM 512), unroll "
          f"{R2D2_UNROLL} + burn-in {R2D2_BURN_IN}, insertion batches of "
          f"{REMOTE_R2D2_INSERTION}, {t.inserts} inserts, batches {want}; "
          f"actor 0 killed at {replaced['at']:.1f} s and replaced on env ids "
          f"0-{REMOTE_ACTOR_ENVS - 1}; the learner held its inserts "
          f"{t.held_s:.1f} s for the replacement's first episode; the "
          f"learner's {matched} completed returns equal the actors' own, "
          f"{from_replacement} of them the replacement's, and none mixes "
          f"two lives; replay {replay.num_inserted} of {replay.size} "
          f"unrolls, {replay.nbytes() / 1e9:.3f} GB in host RAM ({smi})")
    t.report(name, REMOTE_R2D2_INSERTION * R2D2_UNROLL, launches, finals, smi)
    _, _, items = replay.sample(REMOTE_R2D2_BATCH, learner.priority_exponent)
    err = check_nstep_on_batch(name, learner, items)
    _print_path_end(name, start)
    return launches["nstep"], err


def run_remote_ppo(smi, directory):
    """Phase 16 (c): PPO at phase 11's knobs, 2 actors."""
    from seed_rl_torch import train

    path = PPO_PATHS["ppo_synthetic_atari"]
    name = "remote ppo synthetic_atari_host"
    start = time.perf_counter()
    envs = REMOTE_PPO_ACTORS * REMOTE_ACTOR_ENVS
    fleet = RemoteFleet("ppo", directory)
    flags = _remote_flags("ppo", fleet, envs, path.unroll, (
        *path.flags[1:], f"--epochs_per_step={path.epochs}",
        f"--batches_per_step={path.minibatches}"))
    for k in range(REMOTE_PPO_ACTORS):
        fleet.start_atari(k * REMOTE_ACTOR_ENVS)
    t, (learner, state, metrics), launches, lives, finals = _run_remote_path(
        name, fleet, lambda: train.main(
            ["--run_mode=learner", *flags,
             f"--total_environment_frames={PPO_STEPS * envs * path.unroll}"]),
        profiled=2)
    updates = PPO_STEPS * path.epochs * path.minibatches
    if state.step != PPO_STEPS or learner.optimizer.count != updates or any(
            launches.values()):
        raise RuntimeError(f"{name}: {state.step} steps, "
                           f"{learner.optimizer.count} updates, launches "
                           f"{launches}")
    _finite(name, metrics)
    matched, _ = _check_returns(name, t.stats, lives)
    print(f"{name}: {REMOTE_PPO_ACTORS} actor processes x "
          f"{REMOTE_ACTOR_ENVS} envs, AtariPolicyNet (LSTM 256), "
          f"{path.epochs} x {path.minibatches} minibatches, {state.step} "
          f"steps; the learner's {matched} completed returns equal the "
          f"actors' own ({smi})")
    t.report(name, envs * path.unroll, launches, finals, smi)
    _print_path_end(name, start)


def run_remote_sac(smi, directory, device):
    """Phase 16 (d): SACHostLearner through run_remote_offpolicy_learner,
    its actors on HostToyEnv."""
    import functools

    from seed_rl_torch import distributions as pd
    from seed_rl_torch import optim, remote
    from seed_rl_torch.agents import sac
    from seed_rl_torch.envs.host import HostBatchedEnv
    from seed_rl_torch.models import ActorCriticMLP
    from seed_rl_torch.replay_host import HostReplayBuffer

    name = "remote sac HostToyEnv"
    start = time.perf_counter()
    envs = REMOTE_SAC_ACTORS * REMOTE_ACTOR_ENVS
    cycles = 1 + REMOTE_TRAIN_CYCLES
    fleet = RemoteFleet("sac", directory)
    for k in range(REMOTE_SAC_ACTORS):
        offset = k * REMOTE_ACTOR_ENVS
        fleet.start(["-c", "import chip_smoke; chip_smoke.remote_sac_actor("
                     f"{fleet.address!r}, {offset}, {REMOTE_ACTOR_ENVS})"],
                    offset)
    spec_env = HostBatchedEnv(lambda i: HostToyEnv(), 1)
    dist = pd.get_parametric_distribution_for_action_space(
        spec_env.action_space)
    obs_spec = spec_env.observation_spec()
    spec_env.close()
    agent = sac.SACAgent(ActorCriticMLP(dist.param_size, obs_spec,
                                        n_critics=2, device=device), dist)
    config = sac.SACConfig(batch_size=REMOTE_SAC_BATCH, unroll_length=1,
                           replay_buffer_min_size=2 * REMOTE_SAC_INSERTION)
    learner = sac.SACHostLearner(
        agent, config, functools.partial(optim.ClippedAdam,
                                         learning_rate=3e-4, clip_norm=40.0),
        REMOTE_SAC_INSERTION, 1, seed=2)
    replay = HostReplayBuffer(config.replay_buffer_size, 0.0, device=device)
    t, (state, logs), launches, lives, finals = _run_remote_path(
        name, fleet, lambda: remote.run_remote_offpolicy_learner(
            agent, learner, replay, obs_spec, fleet.address,
            cycles * REMOTE_SAC_INSERTION, unroll_length=1, num_envs=envs,
            replay_ratio=REMOTE_SAC_RATIO,
            replay_buffer_min_size=config.replay_buffer_min_size,
            example_action=np.zeros(spec_env.action_space.shape,
                                    np.float32),
            unroll_timeout=120.0), profiled=3)
    want = _owed_batches(cycles, REMOTE_SAC_INSERTION, REMOTE_SAC_BATCH,
                         REMOTE_SAC_RATIO, config.replay_buffer_min_size,
                         config.replay_buffer_size)
    if state.step != sum(want) or t.inserts != cycles or any(
            launches.values()):
        raise RuntimeError(f"{name}: {t.inserts} inserts, {state.step} "
                           f"batches, launches {launches}; want {cycles}, "
                           f"{want}")
    _finite(name, logs)
    tensors = learner.parameters() + learner.state_tensors(state)
    if any(x.device.type != "cuda" for x in tensors):
        raise RuntimeError(f"{name}: tensors off the card")
    matched, _ = _check_returns(name, t.stats, lives)
    print(f"{name}: {REMOTE_SAC_ACTORS} actor processes x "
          f"{REMOTE_ACTOR_ENVS} envs, ActorCriticMLP (256, 256), insertion "
          f"batches of {REMOTE_SAC_INSERTION}, batches {want} of "
          f"{REMOTE_SAC_BATCH}; the learner's {matched} completed returns "
          f"equal the actors' own ({smi})")
    t.report(name, REMOTE_SAC_INSERTION, launches, finals, smi)
    _print_path_end(name, start)


def run_remote_paths(smi, device):
    """Phase 16; returns (B1 launches, B2 launches, B1 max err, B2 max
    err)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_remote_") as root:
        vtrace, vtrace_err = run_remote_vtrace(smi, root)
        nstep, nstep_err = run_remote_r2d2(smi, root)
        run_remote_ppo(smi, root)
        run_remote_sac(smi, root, device)
    return vtrace, nstep, vtrace_err, nstep_err


# Phase 17: data-parallel scale-out. The script needs one card, and NCCL
# refuses two ranks on one device, so (a)-(d) run two ranks on cuda:0 over
# gloo (named, not a fallback): the tensors stay on the card and gloo
# moves them through the host. Each path runs once on one rank (no group)
# and once on two, from the same seed, with TF32 off in both; (e) wraps a
# learner in a one-rank NCCL group, whose all-reduce calls its profile
# shows.
SCALE_OUT_RANKS = 2
# PPO's epochs a step here (phase 10 runs 10): each minibatch step is one
# all-reduce through the host, ~30 ms on two ranks.
SCALE_OUT_PPO_EPOCHS = 2


class ScaleOutPath(NamedTuple):
    argv: Tuple[str, ...]
    agent: str
    steps: int  # train steps inside train.main
    net: str  # as printed


def _scale_out_paths():
    atari = VTRACE_PATHS["synthetic_atari"]
    ppo = PPO_PATHS["ppo_toy"]
    sac_path = SAC_PATHS["sac_catch_continuous"]
    r2d2_steps, vtrace_steps, ppo_steps, sac_steps = 2, 2, 1, 2
    return {
        "vtrace synthetic_atari": ScaleOutPath((
            "--agent=vtrace", *atari.flags, f"--num_envs={atari.envs}",
            f"--unroll_length={atari.unroll}",
            "--total_environment_frames="
            f"{vtrace_steps * atari.envs * atari.unroll}",
            "--steps_per_call=1", "--log_every_steps=1"), "vtrace",
            vtrace_steps, atari.net),
        "r2d2 discrete_match": ScaleOutPath((
            *_r2d2_argv("discrete_match"),
            "--total_environment_frames="
            f"{r2d2_steps * R2D2_ENVS * R2D2_UNROLL}"), "r2d2", r2d2_steps,
            R2D2_PATHS["discrete_match"]),
        "ppo toy": ScaleOutPath((
            "--agent=ppo", *ppo.flags, f"--num_envs={ppo.envs}",
            f"--unroll_length={ppo.unroll}",
            f"--epochs_per_step={SCALE_OUT_PPO_EPOCHS}",
            f"--batches_per_step={ppo.minibatches}",
            f"--total_environment_frames={ppo_steps * ppo.envs * ppo.unroll}",
            "--steps_per_call=1", "--log_every_steps=1"), "ppo", ppo_steps,
            ppo.net),
        "sac catch_continuous": ScaleOutPath((
            "--agent=sac", *sac_path.flags, f"--num_envs={sac_path.envs}",
            "--total_environment_frames="
            f"{sac_steps * sac_path.envs * sac_path.rollout}",
            "--steps_per_call=1", "--log_every_steps=1"), "sac", sac_steps,
            sac_path.net),
    }


# Two ranks against one: the metrics of the last call within rtol 1e-4 /
# atol 1e-5, as on the CPU, and the parameters within 2e-3 of their own
# movement from the initial values (global norms). Both runs start from
# the same parameters and draw the same noise, but a rank's convolutions
# and matrix products run at half the batch, in other algorithms and sum
# orders (f32, TF32 off); Adam's first steps turn those ~1e-7 relative
# gradient differences into parameter differences of up to 1.4e-4 of the
# movement (V-trace on synthetic Atari, the largest of six H100 runs).
SCALE_OUT_METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
SCALE_OUT_PARAM_TOL = 2e-3
SCALE_OUT_TIMED_STEPS = 1


def _tf32(enabled):
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled


def _replicated(learner, state):
    """A rank's replicated tensors, by name: the parameters, the optimizer
    moments, the target net, the statistics, the priorities and the
    generators."""
    inner = getattr(learner, "learner", learner)
    named = {f"param {i}": p for i, p in enumerate(inner.parameters())}
    opt = inner.optimizer.state_dict()
    named.update({f"opt {k} {i}": t for k in ("exp_avg", "exp_avg_sq")
                  for i, t in enumerate(opt[k])})
    target = getattr(inner, "target_net", None) or getattr(
        getattr(inner, "target_agent", None), "net", None)
    if target is not None:
        named.update({f"target {i}": p
                      for i, p in enumerate(target.parameters())})
    stats = getattr(inner.agent, "obs_norm", None) or ()
    named.update({f"obs_norm {i}": t
                  for i, t in enumerate(pytree.tree_leaves(stats))})
    named.update({f"norm_state {i}": t for i, t in enumerate(
        pytree.tree_leaves(getattr(state, "norm_state", ())))})
    if hasattr(state, "replay"):
        named["priorities"] = state.replay.priorities
    engine = inner.engine
    named.update({f"generator {i}": g.get_state() for i, g in enumerate(
        (engine.env.generator, engine.generator, inner.generator))})
    return named


def _digests(named):
    import hashlib

    return {k: hashlib.sha256(t.detach().cpu().contiguous().numpy()
                              .tobytes()).hexdigest()
            for k, t in named.items()}


def _scale_out_kernels(name, learner, state):
    """On two ranks: B1 on the rank's own unroll, B2 on its own insert and
    on its share of a sampled batch, each against its plain version;
    returns {kernel: (max |err|, shapes)}."""
    from seed_rl_torch.agents import r2d2
    from seed_rl_torch.agents import vtrace as vtrace_agent
    from seed_rl_torch.ops import vtrace as plain
    from seed_rl_torch.ops.cuda import vtrace_kernel

    inner = learner.learner
    out = {}
    if isinstance(inner, vtrace_agent.VTraceLearner):
        _, unroll = inner.engine.rollout(state.rollout)
        with torch.no_grad():
            inputs, _ = vtrace_agent.vtrace_inputs(
                inner.config, inner.agent, inner.agent.distribution, unroll)
        got = vtrace_kernel.from_importance_weights(
            **inputs, lambda_=inner.config.lambda_)
        want = plain.from_importance_weights(
            **inputs, lambda_=inner.config.lambda_)
        torch.cuda.synchronize()
        err = 0.0
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=VTRACE_TOL, atol=VTRACE_TOL)
            err = max(err, float((g - w).abs().max()))
        out["vtrace"] = (err, [list(inputs["rewards"].shape)])
    if isinstance(inner, r2d2.R2D2Learner):
        config = inner.config
        _, unroll = inner.engine.rollout(state.rollout)
        items = r2d2.unroll_to_items(unroll, inner.num_training_envs)
        (rewards, done), (action, q) = pytree.tree_map(
            lambda t: t[config.burn_in:], r2d2._time_major((
                (items.env_outputs.reward, items.env_outputs.done),
                (items.agent_outputs.action, items.agent_outputs.q_values))))
        args = [q, q, action, action, rewards, done]
        kw = dict(gamma=config.discounting, n_steps=config.n_steps,
                  rescaling_eps=config.value_function_rescaling_epsilon)
        insert_err, _, _ = _nstep_compare(
            args, args, kw, f"{name} on this rank's insert "
            f"{list(q.shape[:2])}")
        # Every rank draws the same indices and gathers the global batch.
        _, _, batch = inner.replay.sample(
            state.replay, inner.generator, config.batch_size,
            config.priority_exponent)
        part = learner.mesh.shard(config.batch_size)
        batch = pytree.tree_map(lambda t: t[part], batch)
        batch_err = check_nstep_on_batch(name, inner, batch)
        out["nstep"] = (max(insert_err, batch_err),
                        [list(q.shape[:2]),
                         [q.shape[0], part.stop - part.start]])
    return out


# PPO's step on two ranks launches ~174k device events, which the profiler
# takes ~50 s to sum: its idle share is taken over the step's rollout and
# its first epoch of minibatch steps.
SCALE_OUT_PPO_WINDOW = PPO_PATHS["ppo_toy"].minibatches


class _Window:
    """Calls ``at_end`` once, right after the ``window``-th PPO minibatch
    step of the learner inside the block (never without a window)."""

    def __init__(self, learner, window, at_end):
        self.inner, self.window, self.at_end = learner.learner, window, at_end

    def __enter__(self):
        if self.window:
            step, calls = self.inner._minibatch_step, [0]

            def counted(*args, **kwargs):
                out = step(*args, **kwargs)
                calls[0] += 1
                if calls[0] == self.window:
                    torch.cuda.synchronize()
                    self.at_end()
                return out

            self.inner._minibatch_step = counted
        return self

    def __exit__(self, *exc):
        if self.window:
            del self.inner._minibatch_step


def _timed_scale_out_steps(learner, state, steps, window=None):
    """``steps`` train steps of a DistributedLearner, synchronised; returns
    (state, s per step, gradient all-reduce s per step, all-reduces per
    step, s from the first step's start to the end of its ``window``-th
    minibatch step, or None)."""
    mesh = learner.mesh
    spent, ends = [], []
    average = mesh.average_

    def timed(tensors):
        torch.cuda.synchronize()
        t = time.perf_counter()
        average(tensors)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t)

    mesh.average_ = timed
    try:
        with _Window(learner, window, lambda: ends.append(
                time.perf_counter())):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                state, _ = learner.train_step(state)
            torch.cuda.synchronize()
    finally:
        del mesh.average_
    step_s = (time.perf_counter() - t0) / steps
    window_s = ends[0] - t0 if ends else None
    return state, step_s, sum(spent) / steps, len(spent) / steps, window_s


def _scale_out_idle(learner, state, what, wall_s, window=None):
    """This rank's device idle share: the device busy time of one train
    step (torch.profiler, device activity only), or with ``window`` of the
    step up to the end of its ``window``-th PPO minibatch step, against
    ``wall_s``, the unprofiled time of the same span; None where the
    profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    stopped = []

    def stop():
        stopped.append(True)
        prof.stop()

    prof.start()
    with _Window(learner, window, stop):
        learner.train_step(state)
        torch.cuda.synchronize()
    if not stopped:
        prof.stop()
    kernels = _device_kernels(prof)
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    span = (f"the step's first {window} minibatch steps" if window
            else "one step")
    if not busy_s:
        print(f"{what}: no device time recorded; idle share not measured")
        return None
    idle = 1 - busy_s / wall_s
    print(f"{what}: device busy {busy_s * 1e3:.3f} ms over "
          f"{sum(e.count for e in kernels):.0f} kernel launches in "
          f"{span} ({wall_s * 1e3:.3f} ms unprofiled); idle share "
          f"{idle:.3f}")
    return idle


def _scale_out_checkpoint(learner, state):
    """A two-rank checkpoint of (b): rank 0 gathers the global tree to its
    CPU one leaf at a time; returns the device memory it took above the
    resident state, the global replay's size and the gathered buffer's
    slots (GB, GB, slots). Resets the peak memory statistic."""
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tree = learner.checkpoint_state(state)
    torch.cuda.synchronize()
    extra_gb = (torch.cuda.max_memory_allocated() - resident) / 2**30
    buffer = pytree.tree_leaves(tree["replay"].buffer)
    replay_gb = sum(t.numel() * t.element_size() for t in buffer) / 2**30
    where = {t.device.type for t in buffer}
    want = "cpu" if learner.mesh.rank == 0 else "meta"
    if where != {want}:
        raise RuntimeError(f"checkpoint rank {learner.mesh.rank}: the "
                           f"gathered replay lies on {where}, want {want}")
    print(f"scale-out checkpoint rank {learner.mesh.rank}: the global "
          f"replay of {buffer[0].shape[0]} unrolls is {replay_gb:.3f} GB "
          f"({want}); the gather took {extra_gb:.4f} GB of device memory "
          "above the resident state")
    return extra_gb, replay_gb, buffer[0].shape[0]


def scale_out_rank(mesh, smi, paths):
    """Phase 17 (a)-(d) on one rank of the gloo group: each path through
    train.main on this rank's share, the launch counts reset just before;
    returns per path the launches, the kernels' errors and shapes, the
    replicated tensors' digests, step and all-reduce ms, idle share, peak
    GB, the metrics (and, on rank 0, the parameters)."""
    from seed_rl_torch import train

    _tf32(False)
    out = {}
    for name, path in paths.items():
        torch.cuda.reset_peak_memory_stats()
        _reset_launch_counts()
        start = time.perf_counter()
        learner, state, metrics = train.main(
            [*path.argv, f"--num_replicas={mesh.size}"], mesh=mesh)
        torch.cuda.synchronize()
        launches = _launches()
        wall_s = time.perf_counter() - start
        _finite(f"{name} rank {mesh.rank}", metrics)
        inner = learner.learner
        tensors = list(inner.parameters()) + inner.state_tensors(state)
        if any(t.device != mesh.device for t in tensors):
            raise RuntimeError(f"{name} rank {mesh.rank}: tensors off "
                               f"{mesh.device}")
        result = dict(
            launches=launches, steps=state.step, wall_s=wall_s,
            metrics={k: float(v) for k, v in metrics.items()},
            digests=_digests(_replicated(learner, state)),
            num_envs=inner.engine.env.num_envs,
            slots=(pytree.tree_leaves(state.replay.buffer)[0].shape[0]
                   if hasattr(state, "replay") else None),
            kernels=_scale_out_kernels(name, learner, state))
        if mesh.rank == 0:
            result["params"] = [p.detach().cpu().clone()
                                for p in inner.parameters()]
        window = SCALE_OUT_PPO_WINDOW if path.agent == "ppo" else None
        state, step_s, reduce_s, reduces, window_s = _timed_scale_out_steps(
            learner, state, SCALE_OUT_TIMED_STEPS, window)
        result.update(step_ms=step_s * 1e3, allreduce_ms=reduce_s * 1e3,
                      allreduces=reduces)
        result["idle"] = _scale_out_idle(
            learner, state, f"scale-out {name} rank {mesh.rank}",
            window_s if window else step_s, window)
        result["peak_gb"] = _peak_memory_gb()
        if path.agent == "r2d2":
            result["checkpoint"] = _scale_out_checkpoint(learner, state)
        print(f"scale-out {name} rank {mesh.rank}: {state.step} steps; "
              f"{result['num_envs']} envs"
              + (f", {result['slots']} replay slots" if result["slots"]
                 else "")
              + f"; step {result['step_ms']:.3f} ms, gradient all-reduce "
              f"{result['allreduce_ms']:.3f} ms ({reduces:.0f} a step), idle "
              f"share {result['idle']}, peak {result['peak_gb']:.3f} GB; "
              f"launches {launches} ({smi})", flush=True)
        out[name] = result
    return out


def _one_rank_reference(name, path):
    """A path on one rank (no group), TF32 off; returns (initial
    parameters, final parameters, metrics, launches)."""
    from seed_rl_torch import optim, train

    initial = []
    init = optim.ClippedAdam.__init__

    def snapshot(self, params, *args, **kwargs):
        params = list(params)
        initial[:] = [p.detach().cpu().clone() for p in params]
        init(self, params, *args, **kwargs)

    _reset_launch_counts()
    optim.ClippedAdam.__init__ = snapshot
    try:
        learner, state, metrics = train.main([*path.argv, "--num_replicas=1"])
        torch.cuda.synchronize()
    finally:
        optim.ClippedAdam.__init__ = init
    if state.step != path.steps:
        raise RuntimeError(f"{name}: one rank trained {state.step} steps, "
                           f"want {path.steps}")
    return (initial, [p.detach().cpu().clone()
                      for p in learner.parameters()],
            {k: float(v) for k, v in metrics.items()}, _launches())


def _check_scale_out(name, path, reference, ranks):
    initial, want, want_metrics, _ = reference
    got = ranks[0]["params"]
    diff = math.sqrt(sum(float((g - w).double().square().sum())
                         for g, w in zip(got, want)))
    moved = math.sqrt(sum(float((w - i).double().square().sum())
                          for w, i in zip(want, initial)))
    ratio = diff / moved
    worst = max(float((g - w).abs().max()) for g, w in zip(got, want))
    print(f"scale-out {name}: 2 ranks vs 1, parameters |p2 - p1| / |p1 - "
          f"p0| = {ratio:.3e} (tol {SCALE_OUT_PARAM_TOL}), max|p2 - p1| = "
          f"{worst:.3e}")
    if not ratio <= SCALE_OUT_PARAM_TOL:
        raise RuntimeError(f"{name}: two ranks' parameters differ from one "
                           f"rank's by {ratio:.3e} of their movement")
    metrics = ranks[0]["metrics"]
    if set(metrics) != set(want_metrics):
        raise RuntimeError(f"{name}: metrics {sorted(metrics)} vs "
                           f"{sorted(want_metrics)}")
    # |two - one| against atol + rtol * |one|, per metric; the worst.
    share, worst_key = max(
        (abs(metrics[k] - v) / (SCALE_OUT_METRIC_TOL["atol"]
                                + SCALE_OUT_METRIC_TOL["rtol"] * abs(v)), k)
        for k, v in want_metrics.items())
    print(f"scale-out {name}: metrics against {SCALE_OUT_METRIC_TOL}: "
          f"worst {worst_key} at {share:.3e} of its tolerance (two ranks "
          f"{metrics[worst_key]!r}, one {want_metrics[worst_key]!r})")
    if not share <= 1:
        raise RuntimeError(f"{name}: metric {worst_key} "
                           f"{metrics[worst_key]} on two ranks, "
                           f"{want_metrics[worst_key]} on one")
    digests = [r["digests"] for r in ranks]
    unequal = [k for k in digests[0] if digests[0][k] != digests[1][k]]
    if unequal or set(digests[0]) != set(digests[1]):
        raise RuntimeError(f"{name}: replicated tensors differ across "
                           f"ranks: {unequal}")
    print(f"scale-out {name}: {len(digests[0])} replicated tensors bitwise "
          "equal on both ranks (sha256)")
    total = {"vtrace": 0, "nstep": 0}
    for rank, r in enumerate(ranks):
        if r["steps"] != path.steps:
            raise RuntimeError(f"{name} rank {rank}: {r['steps']} steps")
        for kernel, (err, shapes) in r["kernels"].items():
            if r["launches"][kernel] == 0:
                raise RuntimeError(f"{name} rank {rank}: {kernel} never "
                                   "launched")
            print(f"scale-out {name} rank {rank}: {kernel} launched "
                  f"{r['launches'][kernel]} times; on this rank's data "
                  f"{shapes} max|kernel - plain| = {err:.3e} (tol 1e-5)")
        for kernel in total:
            total[kernel] += r["launches"][kernel]
    return total


def run_nccl_one_rank(smi):
    """Phase 17 (e): V-trace on the toy env (phase 5's shape) in a one-rank
    NCCL group: the loss's means, the gradient average and the episode
    window go through NCCL's all-reduce, whose calls the profile of a step
    must show, and the gradient average (NCCL's own average, a scaled sum)
    a device kernel of NCCL's (one rank's in-place sums launch none: they
    are already done; ``scripts/torch_nccl_one_card.py``); returns the
    path's V-trace launches."""
    import torch.distributed as dist

    from seed_rl_torch import parallel, train
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    path = VTRACE_PATHS["toy"]
    steps = 2
    argv = ["--agent=vtrace", *path.flags, f"--num_envs={path.envs}",
            f"--unroll_length={path.unroll}",
            f"--total_environment_frames={steps * path.envs * path.unroll}",
            "--steps_per_call=1", "--log_every_steps=1", "--num_replicas=1"]
    start = time.perf_counter()
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{parallel.mesh.free_port()}",
        world_size=1, rank=0)
    try:
        mesh = parallel.make_mesh(1)
        _reset_launch_counts()
        learner, state, metrics = train.main(argv, mesh=mesh)
        torch.cuda.synchronize()
        launches = _launches()["vtrace"]
        _finite("nccl one rank", metrics)
        if launches != steps or dist.get_backend() != "nccl":
            raise RuntimeError(f"nccl one rank: {launches} V-trace launches "
                               f"on {dist.get_backend()}")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            learner.train_step(state)
            torch.cuda.synchronize()
        nccl = [e for e in prof.key_averages()
                if "nccl" in e.key.lower() or "onerank" in e.key.lower()]
        backend = mesh.backend
    finally:
        dist.destroy_process_group()
    calls = sum(e.count for e in nccl if e.key == "nccl:all_reduce")
    on_card = sum(e.count for e in nccl
                  if e.device_type == DeviceType.CUDA)
    if not calls or not on_card:
        raise RuntimeError(f"nccl one rank: {calls} NCCL all-reduce calls "
                           f"and {on_card} NCCL kernels in the profile of a "
                           "step")
    for e in nccl:
        key = e.key if len(e.key) <= 90 else "..." + e.key[-87:]
        print(f"nccl one rank: {e.count:.0f}x {key} ({e.device_type}),"
              f" host {e.cpu_time_total / 1e3:.3f} ms, device "
              f"{e.device_time_total / 1e3:.3f} ms a step")
    print(f"nccl one rank: {mesh} over {backend}, {steps} steps, "
          f"{launches} V-trace launches, losses/total="
          f"{float(metrics['losses/total']):.6f}; the path took "
          f"{time.perf_counter() - start:.1f} s ({smi})")
    return launches


def time_global_draws(smi, device):
    """What drawing at the global shape costs a rank of (a): a step of 512
    of 1024 synthetic-Atari envs draws the envs' reset seeds (int32) and
    the Gumbel noise of its actions (f32, 18 actions); each rank draws all
    1024 rows and keeps its 512, where a draw of its own would make 512.
    CUDA events, 200 draws each."""
    from seed_rl_torch.parallel import draws

    envs, actions = VTRACE_PATHS["synthetic_atari"].envs, 18
    g = torch.Generator(device=device)
    g.manual_seed(0)
    half = draws.ShardedGenerator(g, envs, slice(0, envs // 2))

    def step_draws(generator):
        draws.randint(0, 255, (envs // 2,), generator, device=device,
                      dtype=torch.int32)
        draws.rand((envs // 2, actions), generator, device=device)

    global_ms = _cuda_ms(lambda: step_draws(half), 200)
    local_ms = _cuda_ms(lambda: step_draws(g), 200)
    print(f"scale-out draws: a rank's step of synthetic Atari draws takes "
          f"{global_ms:.6f} ms at the global shape ({envs} rows, its "
          f"{envs // 2} kept) against {local_ms:.6f} ms for its own rows "
          f"alone ({smi})")


def run_scale_out(smi, device):
    """Phase 17 (the ranks of (a)-(d) on ``device``); returns (B1
    launches, B2 launches, B1 max err, B2 max err, the kernels' shapes on
    the ranks)."""
    from seed_rl_torch import parallel

    paths = _scale_out_paths()
    if device.type == "cuda":
        time_global_draws(smi, device)
    _tf32(False)
    try:
        references = {}
        for name, path in paths.items():
            t0 = time.perf_counter()
            references[name] = _one_rank_reference(name, path)
            print(f"scale-out {name}: one rank, {path.steps} steps in "
                  f"{time.perf_counter() - t0:.1f} s ({path.net})",
                  flush=True)
        t0 = time.perf_counter()
        ranks = parallel.spawn(
            scale_out_rank, SCALE_OUT_RANKS, device, backend="gloo",
            devices=[device] * SCALE_OUT_RANKS, args=(smi, paths),
            timeout_secs=600)
        print(f"scale-out: {SCALE_OUT_RANKS} ranks on {device} over gloo ran "
              f"{len(paths)} paths in {time.perf_counter() - t0:.1f} s")
    finally:
        _tf32(True)
    launches = {"vtrace": 0, "nstep": 0}
    errs = {"vtrace": 0.0, "nstep": 0.0}
    shapes = {"vtrace": [], "nstep": []}
    for name, path in paths.items():
        per_rank = [r[name] for r in ranks]
        total = _check_scale_out(name, path, references[name], per_rank)
        for kernel in launches:
            launches[kernel] += total[kernel]
        for r in per_rank:
            for kernel, (err, kernel_shapes) in r["kernels"].items():
                errs[kernel] = max(errs[kernel], err)
                shapes[kernel].extend(kernel_shapes)
    if device.type == "cuda":
        launches["vtrace"] += run_nccl_one_rank(smi)
    return launches["vtrace"], launches["nstep"], errs["vtrace"], \
        errs["nstep"], shapes


# Phase 18: the port's bench. bench.py's metric names, in its main's
# order, with its tracking flags (the root bench.py is JAX code: this
# script does not import it). No scaling line on one card.
BENCH_METRICS = (
    ("ppo_vector_obs_tracking_fps_per_chip", True),
    ("sac_visual_catch_env_frames_per_sec_per_chip", True),
    ("football_vtrace_env_frames_per_sec_per_chip", False),
    ("ppo_atari_env_frames_per_sec_per_chip", False),
    ("dmlab_vtrace_env_frames_per_sec_per_chip", False),
    ("vtrace_atari_env_frames_per_sec_per_chip", False),
    ("r2d2_atari_env_frames_per_sec_per_chip", False),
)
# One V-trace launch per train step: the warm-up call and one call of 1,
# 1 and 2 steps on Football, DmLab and Atari frames. One n-step launch per
# insert and per batch: R2D2's warm-up insert (640 unrolls reach the
# replay's minimum of 8), then 2 steps of an insert and a batch.
BENCH_VTRACE_LAUNCHES = {"bench_football": 2, "bench_dmlab_vtrace": 2,
                         "bench_vtrace": 4}
BENCH_NSTEP_LAUNCHES = 1 + 2 * 2
BENCH_R2D2_BATCH = 64
# A bf16 net's outputs against the same net in f32 on one batch: more
# than f32 noise, less than a bf16 limit (of the f32 output's largest
# magnitude).
BENCH_F32_NOISE = 1e-5
BENCH_BF16_LIMIT = 5e-2
BENCH_TORSO_BATCH = 64


class BenchRecorder:
    """While phase 18 runs, wraps the two kernels' entry points as the
    agents call them and keeps, per workload, a copy of the V-trace
    kernel's first inputs and of the n-step kernel's last inputs at the
    R2D2 batch's width. The wrapped functions call the wrappers, which
    count their own launches; nothing here launches a kernel."""

    def __init__(self):
        self.workload = None
        self.vtrace = {}
        self.nstep = {}

    @staticmethod
    def _copy(args, kwargs):
        def copy(x):
            return x.detach().clone() if isinstance(x, torch.Tensor) else x

        return [copy(a) for a in args], {k: copy(v) for k, v in
                                         kwargs.items()}

    def __enter__(self):
        from seed_rl_torch.ops.cuda import nstep_kernel, vtrace_kernel

        self._originals = (vtrace_kernel.from_importance_weights,
                           nstep_kernel.td_loss_and_priorities_dispatch)
        vtrace_fn, nstep_fn = self._originals

        def vtrace(*args, **kwargs):
            if self.workload not in self.vtrace:
                self.vtrace[self.workload] = self._copy(args, kwargs)
            return vtrace_fn(*args, **kwargs)

        def nstep(*args, **kwargs):
            if args[0].shape[1] == BENCH_R2D2_BATCH:
                self.nstep[self.workload] = self._copy(args, kwargs)
            return nstep_fn(*args, **kwargs)

        vtrace_kernel.from_importance_weights = vtrace
        nstep_kernel.td_loss_and_priorities_dispatch = nstep
        return self

    def __exit__(self, *exc):
        from seed_rl_torch.ops.cuda import nstep_kernel, vtrace_kernel

        (vtrace_kernel.from_importance_weights,
         nstep_kernel.td_loss_and_priorities_dispatch) = self._originals


def _check_bench_line(line, want_metric, want_tracking):
    if line["metric"] != want_metric:
        raise RuntimeError(f"bench: line {line['metric']!r} where bench.py "
                           f"prints {want_metric!r}")
    if line.get("tracking", False) != want_tracking:
        raise RuntimeError(f"bench {want_metric}: tracking "
                           f"{line.get('tracking')}, want {want_tracking}")
    value, mfu = line["value"], line["mfu"]
    if not (math.isfinite(value) and value > 0):
        raise RuntimeError(f"bench {want_metric}: value {value}")
    if not 0 < mfu <= 1:
        raise RuntimeError(f"bench {want_metric}: mfu {mfu}")
    if line["vs_baseline"] is not None or "spread" not in line:
        raise RuntimeError(f"bench {want_metric}: {line}")


def _check_bench_vtrace(name, args, kwargs):
    """B1 on a workload's own first unroll (f32 inputs from a bf16 net)."""
    dtypes = {x.dtype for x in kwargs.values()
              if isinstance(x, torch.Tensor)}
    if args or dtypes != {torch.float32}:
        raise RuntimeError(f"bench {name}: V-trace inputs {args}, {dtypes}")
    return _check_vtrace_inputs(
        f"bench {name}: vtrace on its own unroll (f32 inputs from a bf16 "
        "net)", kwargs)


def _check_bench_nstep(name, args, kwargs):
    """B2 on R2D2's own sampled batch (f32 inputs from a bf16 net)."""
    q, *rest = args
    if {x.dtype for x in (q, rest[0], rest[3])} != {torch.float32}:
        raise RuntimeError(f"bench {name}: n-step inputs not f32")
    return _check_nstep_batch(f"bench {name}", q, rest, kwargs)


def check_bf16_torsos(device):
    """On one batch of frames, the bench's bf16 AtariPolicyNet and
    DuelingLSTMDQNNet (torso and LSTM in bf16, as bench.py builds them)
    run every convolution and their torso and LSTM matrix products in
    bf16 and their heads in f32, and their outputs differ from the same
    nets' in f32 by more than f32 noise and less than a bf16 limit."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from seed_rl_torch.models import AtariPolicyNet, DuelingLSTMDQNNet
    from seed_rl_torch.types import EnvOutput

    class OpDtypes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in ("convolution", "addmm", "mm", "bmm"):
                self.seen.append((name, args[0].dtype if name != "addmm"
                                  else args[1].dtype))
            return func(*args, **(kwargs or {}))

    gen = torch.Generator(device=device).manual_seed(0)
    b = BENCH_TORSO_BATCH
    eo = EnvOutput(
        reward=torch.randn(b, generator=gen, device=device),
        done=torch.zeros(b, dtype=torch.bool, device=device),
        observation=torch.randint(0, 256, (b, 84, 84, 1), generator=gen,
                                  device=device, dtype=torch.uint8),
        abandoned=torch.zeros(b, dtype=torch.bool, device=device),
        episode_step=torch.zeros(b, dtype=torch.int32, device=device))
    prev = torch.randint(0, 18, (b,), generator=gen, device=device,
                         dtype=torch.int32)
    bf16 = torch.bfloat16
    nets = {
        # (net, its heads' matrix products, run in f32)
        "AtariPolicyNet": (lambda **kw: AtariPolicyNet(
            18, stack_size=4, lstm_size=256, seed=0, device=device, **kw),
            2),
        "DuelingLSTMDQNNet": (lambda **kw: DuelingLSTMDQNNet(
            18, seed=0, device=device, **kw), 4),
    }
    for name, (make, head_products) in nets.items():
        net, net_f32 = make(dtype=bf16, core_dtype=bf16), make()
        net_f32.load_state_dict(net.state_dict())
        state = net.initial_state(b)
        state = state._replace(frame_stacking_state=torch.randint(
            0, 256, state.frame_stacking_state.shape, generator=gen,
            device=device, dtype=torch.uint8))
        with torch.no_grad():
            with OpDtypes() as ops:
                out, _ = net(prev, eo, state)
            out_f32, _ = net_f32(prev, eo, state)
        torch.cuda.synchronize()
        convs = [d for op, d in ops.seen if op == "convolution"]
        products = [d for op, d in ops.seen if op != "convolution"]
        n_bf16 = sum(d == bf16 for d in products)
        n_f32 = sum(d == torch.float32 for d in products)
        # The torso's Dense and the LSTM's two products in bf16.
        if (len(convs) != 3 or set(convs) != {bf16} or n_bf16 != 3
                or n_f32 != head_products):
            raise RuntimeError(f"{name} (bf16): ops {ops.seen}")
        leaves = [x for x in pytree.tree_leaves(out)
                  if torch.is_floating_point(x)]
        leaves_f32 = [x for x in pytree.tree_leaves(out_f32)
                      if torch.is_floating_point(x)]
        diff = max(float((a - c).abs().max())
                   for a, c in zip(leaves, leaves_f32))
        scale = max(float(c.abs().max()) for c in leaves_f32)
        if not BENCH_F32_NOISE * scale < diff < BENCH_BF16_LIMIT * scale:
            raise RuntimeError(
                f"{name}: bf16 output differs from f32 by {diff:.3e} at "
                f"scale {scale:.3e}; want within ({BENCH_F32_NOISE}, "
                f"{BENCH_BF16_LIMIT}) of it")
        print(f"bench {name} in bf16 on {b} frames: convolutions "
              f"{len(convs)} in bf16, matrix products {n_bf16} in bf16 "
              f"(torso Dense, LSTM) and {n_f32} in f32 (heads); outputs "
              f"differ from the f32 net's by max {diff:.3e} = "
              f"{diff / scale:.3e} of their scale (limits {BENCH_F32_NOISE}"
              f", {BENCH_BF16_LIMIT})")


def run_bench(smi, device):
    """Phase 18: seed_rl_torch.bench's workloads on the card, one window of
    one call each; returns (V-trace launches, n-step launches, max |err|
    of each kernel on the bench's own data, the bench's lines)."""
    import contextlib
    import io

    from seed_rl_torch import bench

    lines, launches = [], {}
    with BenchRecorder() as recorder:
        for fn in bench.WORKLOADS:
            recorder.workload = fn.__name__
            _reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                line = fn(device, calls=1, windows=1)
            torch.cuda.synchronize()
            launches[fn.__name__] = tuple(_launches().values())
            if line is None:
                if out.getvalue():
                    raise RuntimeError(f"bench {fn.__name__} printed "
                                       f"{out.getvalue()!r} and no line")
                print(f"bench {fn.__name__}: no line "
                      f"({torch.cuda.device_count()} card)")
                continue
            if json.loads(out.getvalue()) != line:
                raise RuntimeError(f"bench {fn.__name__}: printed "
                                   f"{out.getvalue()!r}, returned {line}")
            lines.append(line)
            print(f"bench line: {json.dumps(line)} ({fn.__name__}, "
                  f"{time.perf_counter() - t0:.1f} s with set-up; launches "
                  f"vtrace {launches[fn.__name__][0]}, nstep "
                  f"{launches[fn.__name__][1]}; peak {_peak_memory_gb():.3f}"
                  f" GB; {smi})")
    if len(lines) != len(BENCH_METRICS):
        raise RuntimeError(f"bench: {len(lines)} lines, want "
                           f"{len(BENCH_METRICS)}")
    for line, (metric, tracking) in zip(lines, BENCH_METRICS):
        _check_bench_line(line, metric, tracking)
    for fn_name, (vtrace_n, nstep_n) in launches.items():
        want = (BENCH_VTRACE_LAUNCHES.get(fn_name, 0),
                BENCH_NSTEP_LAUNCHES if fn_name == "bench_r2d2" else 0)
        if (vtrace_n, nstep_n) != want:
            raise RuntimeError(f"bench {fn_name}: launches (vtrace, nstep) "
                               f"{(vtrace_n, nstep_n)}, want {want}")
    if set(recorder.vtrace) != set(BENCH_VTRACE_LAUNCHES):
        raise RuntimeError(f"bench: V-trace inputs of {set(recorder.vtrace)}")
    vtrace_err = max(_check_bench_vtrace(name, *recorded)
                     for name, recorded in recorder.vtrace.items())
    nstep_err = _check_bench_nstep("bench_r2d2",
                                   *recorder.nstep["bench_r2d2"])
    check_bf16_torsos(device)
    return (sum(v for v, _ in launches.values()),
            sum(n for _, n in launches.values()), vtrace_err, nstep_err,
            lines)


# Phase 19: the CLI's last branches (--agent_module, SAC on
# discrete_match, --normalize_observations on frames), C6 and the soak
# harness. PPO at phase 10's knobs with the example composition; SAC on
# discrete_match at phase 13's envs and batch; visual SAC at phase 12's
# shape; V-trace on host frames (LAST_VTRACE_*), the Football PPO learner
# and replay (LAST_FOOTBALL_*), the soak's arguments.
LAST_EXAMPLE = "seed_rl_torch/examples/custom_ppo_composition.py"
LAST_EXAMPLE_DECAY_STEPS = 10_000
LAST_PPO_STEPS = 1
LAST_SAC_DISCRETE_ENVS, LAST_SAC_DISCRETE_BATCH = 256, 256
LAST_SAC_STEPS = {"discrete_match": 3, "catch_continuous": 2}
LAST_VTRACE_ENVS, LAST_VTRACE_UNROLL, LAST_VTRACE_CYCLES = 256, 32, 2
LAST_FOOTBALL_ENVS, LAST_FOOTBALL_UNROLL = 256, 32
LAST_FOOTBALL_EPOCHS, LAST_FOOTBALL_MINIBATCHES = 2, 8
LAST_FOOTBALL_REPLAY, LAST_FOOTBALL_SAMPLE = 512, 64
LAST_SOAK_ARGS = ["--buffer_size=2000", "--seconds=10"]


class StepTimer:
    """While a phase-19 call runs, times each call of ``owner``'s
    ``method`` (a train step) to a synchronize after it."""

    def __init__(self, owner, method="train_step"):
        self.owner, self.method, self.s = owner, method, []

    def __enter__(self):
        original = self.original = getattr(self.owner, self.method)

        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = original(*args, **kw)
            torch.cuda.synchronize()
            self.s.append(time.perf_counter() - t0)
            return out

        setattr(self.owner, self.method, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.method, self.original)

    def ms(self):
        """The last step's ms (the first ones hold the warm-up)."""
        return self.s[-1] * 1e3 if self.s else float("nan")


def _last_path_end(name, start, step_ms, smi, what="step"):
    print(f"{name}: {what} {step_ms:.3f} ms; peak device memory "
          f"{_peak_memory_gb():.3f} GB; {time.perf_counter() - start:.1f} s "
          f"in all ({smi})")


def _on_card(name, learner, state):
    tensors = learner.parameters() + learner.state_tensors(state)
    off_card = [t.device for t in tensors if t.device.type != "cuda"]
    if off_card:
        raise RuntimeError(f"{name}: {len(off_card)} tensors off the card")


def run_last_agent_module(smi):
    """Phase 19 (a): PPO on the toy env with the example --agent_module."""
    from seed_rl_torch import train
    from seed_rl_torch.agents.ppo import learner as ppo
    from seed_rl_torch.agents.ppo.continuous_control_agent import (
        ContinuousControlNet,
    )

    path = PPO_PATHS["ppo_toy"]
    name = "agent_module ppo toy"
    argv = ["--agent=ppo", *path.flags, f"--num_envs={path.envs}",
            f"--unroll_length={path.unroll}",
            f"--epochs_per_step={path.epochs}",
            f"--batches_per_step={path.minibatches}",
            "--total_environment_frames="
            f"{LAST_PPO_STEPS * path.envs * path.unroll}",
            f"--agent_module={LAST_EXAMPLE}", "--steps_per_call=1",
            "--log_every_steps=1"]
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    start = time.perf_counter()
    with StepTimer(ppo.PPOLearner) as timer:
        learner, state, metrics = train.main(argv)
        torch.cuda.synchronize()
    launches = _launches()
    net = learner.agent.net
    widths = [layer.out_features for layer in net.policy_torso.layers]
    if not isinstance(net, ContinuousControlNet) or widths != [128] * 3:
        raise RuntimeError(f"{name}: composed net {type(net).__name__} "
                           f"{widths}, want ContinuousControlNet 3x128")
    count = learner.optimizer.count
    if state.step != LAST_PPO_STEPS or count != (
            LAST_PPO_STEPS * path.epochs * path.minibatches):
        raise RuntimeError(f"{name}: {state.step} steps, {count} updates")
    lr = learner.optimizer.learning_rate()
    want_lr = 3e-4 * 0.5 * (1 + math.cos(
        math.pi * min(count, LAST_EXAMPLE_DECAY_STEPS)
        / LAST_EXAMPLE_DECAY_STEPS))
    if not math.isclose(lr, want_lr, rel_tol=1e-12):
        raise RuntimeError(f"{name}: learning rate {lr} after {count} "
                           f"updates, the cosine schedule's {want_lr}")
    if any(launches.values()):
        raise RuntimeError(f"{name}: launched {launches}")
    _finite(name, metrics)
    _on_card(name, learner, state)
    print(f"{name}: ContinuousControlNet 3x128 tanh composed by "
          f"{LAST_EXAMPLE}; {count} AdamW updates (weight decay "
          f"{learner.optimizer._adam.defaults['weight_decay']}), learning "
          f"rate {lr:.9e} = the cosine schedule at {count}; total_loss="
          f"{float(metrics['GeneralizedOnPolicyLoss/total_loss']):.6f}; "
          f"launches {launches}")
    _last_path_end(name, start, timer.ms(), smi)


def run_last_sac(smi, env):
    """Phase 19 (b), (c): SAC on discrete_match, and on catch_continuous
    with --normalize_observations."""
    from seed_rl_torch import train
    from seed_rl_torch.agents import sac

    steps = LAST_SAC_STEPS[env]
    if env == "discrete_match":
        name = "sac discrete_match"
        envs, rollout = LAST_SAC_DISCRETE_ENVS, 2
        flags = ["--env=discrete_match", "--unroll_length=2",
                 f"--batch_size={LAST_SAC_DISCRETE_BATCH}",
                 "--replay_buffer_size=4096", "--replay_buffer_min_size=256",
                 "--target_entropy=auto"]
    else:
        name = "sac catch_continuous normalized"
        path = SAC_PATHS["sac_catch_continuous"]
        envs, rollout = path.envs, path.rollout
        flags = [*path.flags, "--normalize_observations"]
    argv = ["--agent=sac", *flags, f"--num_envs={envs}",
            f"--total_environment_frames={steps * envs * rollout}",
            "--steps_per_call=1", "--log_every_steps=1"]
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    start = time.perf_counter()
    with StepTimer(sac.SACLearner) as timer:
        learner, state, metrics = train.main(argv)
        torch.cuda.synchronize()
    launches = _launches()
    if state.step != steps or learner.optimizer.count != steps:
        raise RuntimeError(f"{name}: {state.step} steps, "
                           f"{learner.optimizer.count} updates")
    if any(launches.values()):
        raise RuntimeError(f"{name}: launched {launches}")
    _finite(name, metrics)
    _on_card(name, learner, state)
    obs_norm = learner.agent.obs_norm
    if env == "discrete_match":
        if learner.config.target_entropy != -1.0 or (
                learner.net.action_dim != 1):
            raise RuntimeError(f"{name}: target entropy "
                               f"{learner.config.target_entropy}, action "
                               f"dim {learner.net.action_dim}")
        detail = "ActorCriticMLP, a one-dimensional discrete action"
    else:
        if tuple(obs_norm.mean.shape) != (1,) or not float(
                obs_norm.steps) > 0:
            raise RuntimeError(f"{name}: statistics of shape "
                               f"{tuple(obs_norm.mean.shape)} over "
                               f"{float(obs_norm.steps)} samples")
        detail = (f"VisualActorCritic behind one statistic per channel "
                  f"(mean {float(obs_norm.mean[0]):.4f}, std "
                  f"{float(obs_norm.std[0]):.4f} over "
                  f"{float(obs_norm.steps):.0f} pixels)")
    print(f"{name}: {state.step} steps; {detail}; losses/total="
          f"{float(metrics['losses/total']):.6f}; launches {launches}")
    check_sac_loss_against_cpu(learner, state, name)
    _last_path_end(name, start, timer.ms(), smi)


def run_last_vtrace_host(smi):
    """Phase 19 (d): V-trace on synthetic_atari_host with
    --normalize_observations; returns (B1 launches, max |err|)."""
    from seed_rl_torch import train

    name = "vtrace synthetic_atari_host normalized"
    envs, unroll, cycles = (LAST_VTRACE_ENVS, LAST_VTRACE_UNROLL,
                            LAST_VTRACE_CYCLES)
    argv = ["--agent=vtrace", "--env=synthetic_atari_host",
            "--normalize_observations", f"--num_envs={envs}",
            f"--unroll_length={unroll}",
            f"--total_environment_frames={cycles * envs * unroll}",
            "--log_every_steps=1"]
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    start = time.perf_counter()
    with HostTimer() as t:
        learner, state, metrics = train.main(argv)
        torch.cuda.synchronize()
    launches = _launches()
    if state.step != cycles or launches != {"vtrace": cycles, "nstep": 0}:
        raise RuntimeError(f"{name}: {state.step} cycles, launches "
                           f"{launches}; want one B1 a cycle")
    _finite(name, metrics)
    _on_card(name, learner, state)
    obs_norm = learner.agent.obs_norm
    want = cycles * (unroll + 1) * envs * 84 * 84
    if tuple(obs_norm.mean.shape) != (1,) or float(obs_norm.steps) != want:
        raise RuntimeError(f"{name}: statistics of shape "
                           f"{tuple(obs_norm.mean.shape)} over "
                           f"{float(obs_norm.steps)} samples, want {want}")
    print(f"{name}: {cycles} cycles through the host loop, "
          f"{type(learner.agent.net).__name__} stacking float32 normalized "
          f"frames; one "
          f"statistic per channel (mean {float(obs_norm.mean[0]):.4f}, std "
          f"{float(obs_norm.std[0]):.4f} over {want} pixels); launches "
          f"{launches}")
    err = _check_vtrace_on_unroll(name, learner, t.last_unroll)
    _last_path_end(name, start, (t.s["rollout"] + t.s["update"])
                   / cycles * 1e3, smi, what="cycle (rollout + update)")
    return launches["vtrace"], err


def run_last_football(smi, device):
    """Phase 19 (e): C6 on the card; PPO on synthetic Football's uint16
    frames, then a device replay of them sampled as on the CPU."""
    import functools

    from seed_rl_torch import distributions as pd
    from seed_rl_torch import optim
    from seed_rl_torch.agent import PolicyAgent
    from seed_rl_torch.agents.ppo import policy_losses
    from seed_rl_torch.agents.ppo.generalized_onpolicy_loss import (
        GeneralizedOnPolicyLoss,
    )
    from seed_rl_torch.agents.ppo.learner import PPOConfig, PPOLearner
    from seed_rl_torch.agents.ppo.policy_regularizers import (
        KLPolicyRegularizer,
    )
    from seed_rl_torch.envs import BatchedEnv
    from seed_rl_torch.envs.synthetic import SyntheticFootballEnv
    from seed_rl_torch.models import GFootball
    from seed_rl_torch.ops.advantages import GAE
    from seed_rl_torch.ops.popart import PopArt
    from seed_rl_torch.ops.running_statistics import AverageMeanStd
    from seed_rl_torch.replay import PrioritizedReplay
    from seed_rl_torch.rollout import RolloutEngine

    name = "ppo football (uint16 frames)"
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    start = time.perf_counter()
    env = BatchedEnv(SyntheticFootballEnv(), LAST_FOOTBALL_ENVS,
                     device=device)
    dist = pd.CategoricalDistribution(env.action_space.n)
    net = GFootball(dist.param_size, tuple(env.observation_spec().shape),
                    seed=0, device=device)
    agent = PolicyAgent(net, dist)
    loss = GeneralizedOnPolicyLoss(
        agent=agent,
        reward_normalizer=PopArt(AverageMeanStd(), compensate=False),
        parametric_action_distribution=dist,
        advantage_estimator=GAE(lambda_=0.95),
        policy_loss=policy_losses.ppo(epsilon=0.2), discount_factor=0.99,
        regularizer=KLPolicyRegularizer(entropy=0.01), baseline_cost=1.0)
    learner = PPOLearner(
        RolloutEngine(env, agent, LAST_FOOTBALL_UNROLL, seed=1), agent, loss,
        PPOConfig(epochs_per_step=LAST_FOOTBALL_EPOCHS, batch_mode="split",
                  batches_per_step=LAST_FOOTBALL_MINIBATCHES),
        functools.partial(optim.ClippedAdam, learning_rate=3e-4,
                          clip_norm=0.5), seed=2)
    state = learner.init()
    rollout_state, unroll = learner.engine.rollout(state.rollout)
    frames = unroll.timesteps.env_output.observation
    if frames.dtype != torch.uint16:
        raise RuntimeError(f"{name}: frames of {frames.dtype}")
    t0 = time.perf_counter()
    state, metrics = learner.update(state._replace(rollout=rollout_state),
                                    unroll)
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - t0) * 1e3
    updates = LAST_FOOTBALL_EPOCHS * LAST_FOOTBALL_MINIBATCHES
    if state.step != 1 or learner.optimizer.count != updates:
        raise RuntimeError(f"{name}: {state.step} steps, "
                           f"{learner.optimizer.count} updates")
    _finite(name, metrics)
    if any(_launches().values()):
        raise RuntimeError(f"{name}: launched {_launches()}")
    print(f"{name}: one update of {updates} split minibatches over "
          f"{list(frames.shape)} uint16 frames on the card; total_loss="
          f"{float(metrics['GeneralizedOnPolicyLoss/total_loss']):.6f}")

    # Each env's unroll of frames, one replay item, then a prioritized
    # sample: on the card, and on the CPU with the card's indices.
    items = {"frames": frames.transpose(0, 1).contiguous()}
    gen = torch.Generator(device=device).manual_seed(3)
    priorities = torch.rand(LAST_FOOTBALL_ENVS, generator=gen, device=device)
    samples = []
    for where in (device, torch.device("cpu")):
        replay = PrioritizedReplay(LAST_FOOTBALL_REPLAY, 0.6)
        rstate = replay.init_state({"frames": items["frames"][0].to(where)})
        for _ in range(2):  # wraps the ring
            rstate, _ = replay.insert(
                rstate, {"frames": items["frames"].to(where)},
                priorities.to(where))
        # The card draws; the CPU takes the card's indices.
        indices, weights, sample = replay.sample(
            rstate, gen, LAST_FOOTBALL_SAMPLE, priority_exp=0.9,
            indices=samples[0][0] if samples else None)
        samples.append((indices.cpu(), weights.cpu(),
                        sample["frames"].cpu()))
    torch.cuda.synchronize()
    (i_card, w_card, f_card), (i_cpu, w_cpu, f_cpu) = samples
    if f_card.dtype != torch.uint16 or not torch.equal(
            f_card.view(torch.int16), f_cpu.view(torch.int16)):
        raise RuntimeError(f"{name}: the card's sampled frames differ from "
                           "the CPU's")
    want = items["frames"].cpu()[i_card % LAST_FOOTBALL_ENVS]
    if not torch.equal(f_card.view(torch.int16), want.view(torch.int16)):
        raise RuntimeError(f"{name}: sampled frames are not the inserted")
    torch.testing.assert_close(w_card, w_cpu, rtol=1e-5, atol=0)
    print(f"{name}: {LAST_FOOTBALL_SAMPLE} of {LAST_FOOTBALL_REPLAY} replay "
          f"items of {list(items['frames'].shape[1:])} uint16 frames sampled"
          f" on the card equal the CPU's sample bit for bit")
    _last_path_end(name, start, update_ms, smi, what="update")


def run_last_soak(smi):
    """Phase 19 (f): the R2D2 replay soak harness; returns (B2 launches,
    max |err| on its last batch)."""
    from seed_rl_torch.agents import r2d2
    from seed_rl_torch.tools import soak_r2d2_replay

    name = "soak r2d2 replay"
    last = {}
    train_on_batch = r2d2.R2D2HostLearner.train_on_batch

    def recorded(learner, state, items, weights):
        last.update(learner=learner, items=items)
        return train_on_batch(learner, state, items, weights)

    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    start = time.perf_counter()
    r2d2.R2D2HostLearner.train_on_batch = recorded
    try:
        result = soak_r2d2_replay.main(LAST_SOAK_ARGS)
        torch.cuda.synchronize()
    finally:
        r2d2.R2D2HostLearner.train_on_batch = train_on_batch
    launches = _launches()
    # One launch for the items' priorities, one a train batch: the warm
    # one, the sustained ones and the staged one.
    want = 1 + 1 + result["train_batches"] + 1
    if launches != {"vtrace": 0, "nstep": want}:
        raise RuntimeError(f"{name}: launches {launches}, want {want} B2")
    if not (result["train_batches"] > 0 and math.isfinite(
            result["sustained_env_frames_per_sec"])):
        raise RuntimeError(f"{name}: {result}")
    print(f"{name}: the JSON line above is the harness's ({smi}); B2 "
          f"launches {launches['nstep']}")
    err = check_nstep_on_batch(name, last["learner"], last["items"])
    _last_path_end(name, start, result["stage_ms"]["train"], smi,
                   what="train batch")
    return launches["nstep"], err


def run_last_branches(smi, device):
    """Phase 19; returns (B1 launches, B2 launches, B1 max err, B2 max
    err)."""
    run_last_agent_module(smi)
    run_last_sac(smi, "discrete_match")
    run_last_sac(smi, "catch_continuous")
    vtrace, vtrace_err = run_last_vtrace_host(smi)
    run_last_football(smi, device)
    nstep, nstep_err = run_last_soak(smi)
    return vtrace, nstep, vtrace_err, nstep_err


# Phase 20: the measurement tools of seed_rl_torch/tools/, each through
# its main on the card, in ROADMAP's order, at the sizes below: fewer
# envs, frames, calls and iterations than their defaults, and smaller
# sweeps (their full sizes: PERF.md section 5).
TOOLS_ITERS = "--iters=1"
TOOLS_ARGS = (
    ("bench_r2d2", ["--num_envs=64", "--calls=1"]),
    ("bench_football", ["256", "32", "--calls=2"]),
    ("sweep_bench", ["256,32,1", "1024,32,2", "--calls=2"]),
    ("profile_bench", ["--num_envs=256", TOOLS_ITERS]),
    ("profile_torso", ["--B=256", TOOLS_ITERS]),
    ("profile_impala", ["--envs=64", TOOLS_ITERS]),
    ("exp_pool_vjp", ["--n=2112", "--envs=64", TOOLS_ITERS]),
    ("exp_bwd_decomp", ["--n=2112", TOOLS_ITERS]),
    # Before the tools that start processes on the card: after them, the
    # profiler in this process recorded no device time on most of its
    # one-kernel rows.
    ("exp_packed_conv", ["--n=2112", TOOLS_ITERS]),
    ("profile_ppo_atari", ["--num_envs=64", "--unroll=4", "--iters=1"]),
    ("profile_sac_visual", [TOOLS_ITERS, "--torso_batches=256,8448",
                            "--sweep=128x2,256x4"]),
    ("bench_batcher", ["64", "128", "2"]),
    ("bench_fleet", ["2560", "2", "--env=synthetic_atari_host",
                     "--warmup_frames=0"]),
    ("bench_scaling", ["--replicas=1,2", "--backend=gloo", "--calls=2"]),
)
# One V-trace launch a train step, update or loss; one n-step launch an
# insert and a batch. A profiled row runs a warm-up call, its iterations
# and two traced calls. bench_fleet's learner launches in its own process
# and bench_scaling's rank 1 in its own: neither is counted here.
_ROW = 1 + 1 + 2  # warm-up + --iters=1 + the two traced calls
TOOLS_LAUNCHES = {
    "bench_r2d2": (0, 1 + 2 * (1 + 1)),
    "bench_football": (1 + 2, 0),
    "sweep_bench": ((1 + 2) * 1 + (1 + 2) * 2, 0),
    "profile_bench": (4 * _ROW, 0),
    "profile_impala": (4 * _ROW, 0),
    "exp_pool_vjp": (2 * _ROW, 0),
    # Rank 0 of one rank, then of two: (warm-up + 2 calls) x 2 steps.
    "bench_scaling": (2 * (1 + 2) * 2, 0),
}
TOOLS_POOL_GRAD_TOL = 1e-5


def _positive_rates(name, *rates):
    if not all(r is not None and math.isfinite(r) and r > 0 for r in rates):
        raise RuntimeError(f"tool {name}: rates {rates}")


def _rows_measured(name, rows):
    """Every row's rate is positive, and the profiler saw the device's
    work on the tool's rows (a row of one or two short kernels may record
    none: its device time is then not measured and is named here)."""
    rows = list(rows)
    for row in rows:
        _positive_rates(name, row.ms, *([row.fps] if row.fps else []))
    missing = [row.name for row in rows if row.busy_ms is None]
    if len(missing) == len(rows):
        raise RuntimeError(f"tool {name}: no row has a device time")
    if missing:
        print(f"tool {name}: device time not measured on {missing}")


def _check_packed_conv(result):
    """exp_packed_conv: every row timed on the device, within its bound,
    and both packed convs equal to the plain one within two bf16 steps of
    its largest output."""
    eps = torch.finfo(torch.bfloat16).eps
    for shape, got in result["shapes"].items():
        rows = got["rows"].values()
        _positive_rates("exp_packed_conv", *(row.ms for row in rows))
        missing = [row.name for row in rows if row.busy_ms is None]
        if missing:
            raise RuntimeError(f"tool exp_packed_conv: no device time on "
                               f"{shape}'s rows {missing}")
        for key, b in got["bounds"].items():
            if not 0 < b["share"] <= 1:
                raise RuntimeError(f"tool exp_packed_conv: {shape} {key} at "
                                   f"{b['share']} of its bound")
        limit = 2 * eps * got["plain_max_abs"]
        errs = (got["max_err_1d"], got["max_err_2d"])
        if not all(e <= limit for e in errs):
            raise RuntimeError(f"tool exp_packed_conv: {shape}'s packed "
                               f"convs off by {errs} (limit {limit:.3e})")
        print(f"tool exp_packed_conv: {shape} max|packed - plain| "
              f"{errs[0]:.3e} / {errs[1]:.3e} (limit {limit:.3e})")


def _check_tool(name, result):
    """The checks of one tool's result on the card (phase 20)."""
    from seed_rl_torch.tools import bench_scaling

    if name == "bench_r2d2":
        if result["metric"] != "r2d2_atari_env_frames_per_sec_per_chip":
            raise RuntimeError(f"tool {name}: {result}")
        _positive_rates(name, result["value"])
    elif name == "bench_football":
        _positive_rates(name, result["value"], result["ms_per_step"])
    elif name == "sweep_bench":
        _positive_rates(name, *result.values())
    elif name in ("profile_bench", "profile_torso"):
        _rows_measured(name, result["rows"])
    elif name == "profile_impala":
        _rows_measured(name, [*result["stages"].values(),
                              *result["torso"].values()])
        if not 0 < result["mfu"] < 1 or result["peak"] != "bf16":
            raise RuntimeError(f"tool {name}: mfu {result['mfu']} against "
                               f"the {result['peak']} peak")
    elif name == "exp_pool_vjp":
        _rows_measured(name, [*result["pool"].values(),
                              *result["torso"].values(),
                              *result["train_step"].values()])
        for shape, agreement in result["agreement"].items():
            if not (agreement["outputs_equal"] and agreement[
                    "grad_max_abs_diff"] <= TOOLS_POOL_GRAD_TOL):
                raise RuntimeError(f"tool {name}: the arms differ at "
                                   f"{shape}: {agreement}")
    elif name == "exp_bwd_decomp":
        _rows_measured(name, result["rows"].values())
    elif name == "profile_ppo_atari":
        _rows_measured(name, result["rows"].values())
    elif name == "profile_sac_visual":
        _rows_measured(name, [*result["stages"].values(),
                              *result["torso"].values(),
                              *result["sweep"].values()])
        _positive_rates(name, *result["accounting"].values())
    elif name == "bench_batcher":
        _positive_rates(name, result["calls_per_sec"],
                        result["batches_per_sec"], result["mean_fill"])
    elif name == "bench_fleet":
        if [line["actors"] for line in result] != [2]:
            raise RuntimeError(f"tool {name}: {result}")
        for line in result:
            if line["platform"] != "cuda":
                raise RuntimeError(f"tool {name}: {line}")
            _positive_rates(name, line["value"], line["batcher_mean_fill"],
                            line["window_secs"])
    elif name == "exp_packed_conv":
        _check_packed_conv(result)
    elif name == "bench_scaling":
        keys = {"metric", "value", "unit", "platform", "frames_per_sec",
                "note", "card"}
        if (set(result) != keys
                or result["metric"] != "scaling_efficiency_1_to_2_replicas"
                or result["note"] != bench_scaling.SHARED_CARD_NOTE):
            raise RuntimeError(f"tool {name}: {result}")
        _positive_rates(name, result["value"],
                        *result["frames_per_sec"].values())


def run_tools(smi):
    """Phase 20 (each tool on the card, its default); returns (B1
    launches, B2 launches, B1 max err, B2 max err)."""
    import importlib

    launches = {}
    with BenchRecorder() as recorder:
        for name, argv in TOOLS_ARGS:
            tool = importlib.import_module(f"seed_rl_torch.tools.{name}")
            recorder.workload = name
            # The earlier tools' cached memory back to the card: bench_fleet
            # and bench_scaling start processes that need it.
            torch.cuda.empty_cache()
            _reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            print(f"--- tool {name} {' '.join(argv)}", flush=True)
            result = tool.main(argv)
            torch.cuda.synchronize()
            launches[name] = tuple(_launches().values())
            _check_tool(name, result)
            print(f"tool {name}: {time.perf_counter() - t0:.1f} s, launches "
                  f"(vtrace, nstep) {launches[name]}, peak "
                  f"{_peak_memory_gb():.3f} GB ({smi})", flush=True)
    for name, got in launches.items():
        want = TOOLS_LAUNCHES.get(name, (0, 0))
        if got != want:
            raise RuntimeError(f"tool {name}: launches (vtrace, nstep) "
                               f"{got}, want {want}")
    if set(recorder.vtrace) != {n for n, (v, _) in TOOLS_LAUNCHES.items()
                                if v}:
        raise RuntimeError(f"tools: V-trace inputs of {set(recorder.vtrace)}")
    vtrace_err = max(_check_vtrace_inputs(
        f"tool {name}: vtrace on its own unroll", kwargs)
        for name, (_, kwargs) in recorder.vtrace.items())
    nstep_err = _check_bench_nstep("bench_r2d2 tool",
                                   *recorder.nstep["bench_r2d2"])
    return (sum(v for v, _ in launches.values()),
            sum(n for _, n in launches.values()), vtrace_err, nstep_err)


def run_tools_in_child(smi):
    """Phase 20 in a child process of this script, whose rows start from a
    fresh profiler: in this process, after the traces of phases 14-19,
    torch.profiler recorded part of a row's kernels, or none. Returns the
    child's ``run_tools`` result (its launches counted there, each count
    reset just before each tool). This process first hands its cached
    device memory back: the child and the fleet's learner process need
    the card's memory beside it."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 20: this process keeps "
          f"{torch.cuda.memory_reserved() / 1e9:.3f} GB of device memory "
          "reserved beside the tools' process", flush=True)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--tools", smi],
        stdout=subprocess.PIPE, text=True, timeout=900)
    sys.stdout.write(proc.stdout)
    sys.stdout.flush()
    if proc.returncode != 0:
        raise RuntimeError(f"phase 20's process exited {proc.returncode}")
    return tuple(json.loads(proc.stdout.strip().splitlines()[-1]))


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
    share against the unprofiled step time (returned; None where the
    profiler recorded no device time). Only the device activity is
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
        return None
    idle = 1 - busy_us / 1e6 / step_s
    print(f"{what} profiler: device busy {busy_us / 1e3:.3f} ms per step over "
          f"{launches:.0f} kernel launches; idle share "
          f"{idle:.3f} of the {step_s * 1e3:.3f} ms step"
          f" (profiled and summed in {profile_s:.1f} s)")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms/step "
              f"{e.count:6.0f}x  {e.key[:90]}")
    return idle


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
    t0 = time.perf_counter()
    (vtrace_launches["remote"], nstep_launches["remote"], vtrace_remote_err,
     nstep_remote_err) = run_remote_paths(smi, device)
    vtrace_err = max(vtrace_err, vtrace_remote_err)
    nstep_err = max(nstep_err, nstep_remote_err)
    print(f"phase 16 (the remote-actor paths) took "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    (vtrace_launches["scale_out"], nstep_launches["scale_out"],
     vtrace_scale_err, nstep_scale_err, scale_shapes) = run_scale_out(
        smi, device)
    vtrace_err = max(vtrace_err, vtrace_scale_err)
    nstep_err = max(nstep_err, nstep_scale_err)
    print(f"phase 17 (scale-out) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    (vtrace_launches["bench"], nstep_launches["bench"], vtrace_bench_err,
     nstep_bench_err, _) = run_bench(smi, device)
    vtrace_err = max(vtrace_err, vtrace_bench_err)
    nstep_err = max(nstep_err, nstep_bench_err)
    print(f"phase 18 (the bench) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    (vtrace_launches["last_branches"], nstep_launches["last_branches"],
     vtrace_last_err, nstep_last_err) = run_last_branches(smi, device)
    vtrace_err = max(vtrace_err, vtrace_last_err)
    nstep_err = max(nstep_err, nstep_last_err)
    print(f"phase 19 (the last CLI branches and tooling) took "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    (vtrace_launches["tools"], nstep_launches["tools"], vtrace_tools_err,
     nstep_tools_err) = run_tools_in_child(smi)
    vtrace_err = max(vtrace_err, vtrace_tools_err)
    nstep_err = max(nstep_err, nstep_tools_err)
    print(f"phase 20 (the measurement tools) took "
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
         {"catch": vtrace_times["catch"],
          "scale_out_shapes": scale_shapes["vtrace"]}),
        # The loss shape's numbers at the top level, the insert shape's
        # under "insert".
        ("nstep", "seed_rl_tpu/ops/pallas/nstep_kernel.py:36",
         sum(nstep_launches.values()), nstep_err, nstep_times["loss"],
         {"insert": nstep_times["insert"],
          "scale_out_shapes": scale_shapes["nstep"]}),
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
    if sys.argv[1:2] == ["--tools"]:  # phase 20's process
        print(json.dumps(run_tools(sys.argv[2])))
        sys.exit(0)
    sys.exit(main())
