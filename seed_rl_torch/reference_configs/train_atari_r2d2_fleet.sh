#!/bin/bash
# The reference's R2D2 Atari cloud data-plane shape (gcp/train_atari.sh:
# 24-111) on seed_rl_torch's fleet launcher, with the flags of
# scripts/reference_configs/train_atari_r2d2_fleet.sh: one learner on the
# CUDA device serving epsilon-by-env-id inference and training from a
# host-RAM replay of 100k unrolls under replay_ratio 0.75, and
# WORKERS x ACTORS_PER_WORKER actor processes of ENVS_PER_ACTOR envs each
# (640 envs in all by default) stepping ALE on the CPU.
#
# train_atari_r2d2.sh steps all envs in one process; this script spreads
# the env stepping over actor processes.
#
# Needs ale_py for real Atari; --env=synthetic_atari_host runs the same
# fleet on synthetic frames. Flags after the game go to the learner and
# every actor (--device=cpu trains on the CPU).
#
# Usage: train_atari_r2d2_fleet.sh [GAME] [flags...]   (later flags win)
set -euo pipefail
GAME=${1:-Pong}
LOGDIR=${LOGDIR:-/tmp/seed_rl_torch/atari_r2d2_fleet_${GAME}}
WORKERS=${WORKERS:-32}
ACTORS_PER_WORKER=${ACTORS_PER_WORKER:-4}
ENVS_PER_ACTOR=${ENVS_PER_ACTOR:-5}

exec python -m seed_rl_torch.fleet \
    --agent=r2d2 --env=atari \
    --workers="$WORKERS" --actors_per_worker="$ACTORS_PER_WORKER" \
    --envs_per_actor="$ENVS_PER_ACTOR" \
    --logdir="$LOGDIR" \
    -- \
    --game="$GAME" \
    --num_eval_envs=30 \
    --unroll_length=80 --burn_in=40 \
    --batch_size=64 --replay_ratio=0.75 \
    --replay_buffer_size=100000 --replay_buffer_min_size=5000 \
    --learning_rate=1e-4 --clip_norm=80 \
    --discounting=0.997 --n_steps=5 \
    --update_target_every_n_step=2500 \
    --total_environment_frames=50e9 \
    "${@:2}"
