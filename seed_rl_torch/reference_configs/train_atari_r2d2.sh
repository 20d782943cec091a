#!/bin/bash
# The reference's R2D2 Atari cloud config (gcp/train_atari.sh:24-111) on
# seed_rl_torch's CLI, with the flags of scripts/reference_configs/
# train_atari_r2d2.sh.
#
# Reference knobs: 640 envs (32 workers x 20 actors), batch 64, unroll 80,
# burn-in 40, replay 100k unrolls (min 5k), replay_ratio 0.75, lr 1e-4,
# clip_norm 80, 50e9 frames, 30 eval actors, eval epsilon 1e-3.
#
# --env=atari runs the host pipeline: thread-pooled ALE stepping and a
# host-RAM replay at the full 100k-unroll scale (>85 GB), under the
# replay-ratio contract (--replay_ratio=0.75). The learner trains on the
# CUDA device; --device=cpu after the game trains on the CPU.
#
# Needs ale_py for real Atari; --env=synthetic_atari_host runs the same
# host pipeline on synthetic frames.
#
# Usage: train_atari_r2d2.sh [GAME] [flags...]   (later flags win)
set -euo pipefail
GAME=${1:-Pong}
LOGDIR=${LOGDIR:-/tmp/seed_rl_torch/atari_r2d2_${GAME}}

exec python -m seed_rl_torch.train \
    --agent=r2d2 --env=atari --game="$GAME" \
    --num_envs=640 --num_eval_envs=30 \
    --unroll_length=80 --burn_in=40 \
    --batch_size=64 --replay_ratio=0.75 \
    --replay_buffer_size=100000 --replay_buffer_min_size=5000 \
    --learning_rate=1e-4 --clip_norm=80 \
    --discounting=0.997 --n_steps=5 \
    --update_target_every_n_step=2500 \
    --total_environment_frames=50000000000 \
    --logdir="$LOGDIR" "${@:2}"
