#!/bin/bash
# The reference's tuned PPO HalfCheetah baseline
# (mujoco/local_baseline_HalfCheetah-v2.sh:20-34 + mujoco/gin/ppo.gin) on
# seed_rl_torch's CLI, with the flags of
# scripts/reference_configs/train_mujoco_ppo.sh.
#
# Reference knobs: 2M frames, 2048-transition steps, 64-transition
# minibatches (32 a step), 10 epochs, unroll 16, lr 3e-4 (no decay),
# clip_norm 0.5, PPO eps 0.2, GAE lambda .95, gamma .99, PopArt reward
# normalization (no compensation), input normalization + clip 10,
# orthogonal init, tanh 2x64 nets. 2048 transitions / unroll 16 = 128
# envs. Needs gymnasium and mujoco; --device=cpu after the env name trains
# on the CPU.
#
# Usage: train_mujoco_ppo.sh [ENV_NAME] [flags...]   (later flags win)
set -euo pipefail
ENV_NAME=${1:-HalfCheetah-v5}
LOGDIR=${LOGDIR:-/tmp/seed_rl_torch/mujoco_ppo_${ENV_NAME}}

exec python -m seed_rl_torch.train \
    --agent=ppo --env=mujoco --env_name="$ENV_NAME" \
    --num_envs=128 --unroll_length=16 \
    --epochs_per_step=10 --batches_per_step=32 --batch_mode=split \
    --learning_rate=3e-4 --clip_norm=0.5 \
    --total_environment_frames=2000000 \
    --logdir="$LOGDIR" "${@:2}"
