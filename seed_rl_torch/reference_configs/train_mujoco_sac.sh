#!/bin/bash
# The reference's SAC MuJoCo config (mujoco/sac_main.py + agents/sac/
# learner.py flag defaults) on seed_rl_torch's CLI, with the flags of
# scripts/reference_configs/train_mujoco_sac.sh.
#
# Reference knobs: batch 256, lr 3e-4, replay 1e6 transitions (uniform),
# replay_ratio 4, unroll_length 1, gamma .99, 2x256 MLP actor and critics
# (2 critics), polyak 0.9 every minibatch, V-function bootstrap. Host envs
# and a host-RAM replay (the reference keeps its replay in learner RAM).
# Needs gymnasium and mujoco; --device=cpu after the env name trains on
# the CPU.
#
# Usage: train_mujoco_sac.sh [ENV_NAME] [flags...]   (later flags win)
set -euo pipefail
ENV_NAME=${1:-HalfCheetah-v5}
LOGDIR=${LOGDIR:-/tmp/seed_rl_torch/mujoco_sac_${ENV_NAME}}

exec python -m seed_rl_torch.train \
    --agent=sac --env=mujoco --env_name="$ENV_NAME" \
    --num_envs=8 --unroll_length=1 \
    --batch_size=256 --replay_ratio=4 \
    --replay_buffer_size=1000000 --replay_buffer_min_size=1000 \
    --learning_rate=3e-4 --clip_norm=40 \
    --discounting=0.99 --polyak=0.9 \
    --total_environment_frames=1000000 \
    --logdir="$LOGDIR" "${@:2}"
