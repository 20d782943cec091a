#!/bin/bash
# The reference's DmLab V-trace / IMPALA config (gcp/train_dmlab.sh; SEED
# paper section A.1) on seed_rl_torch's CLI, with the flags of
# scripts/reference_configs/train_dmlab_vtrace.sh: the ImpalaDeep resnet
# torso, 512 envs x unroll 32, lr 4e-4 decayed linearly to 0, Adam with
# beta1 0 and epsilon 3.125e-7, on the CUDA device (--device=cpu after the
# level for the CPU). Needs deepmind_lab.
#
# Usage: train_dmlab_vtrace.sh [LEVEL] [flags...]   (later flags win)
set -euo pipefail
LEVEL=${1:-explore_goal_locations_small}
LOGDIR=${LOGDIR:-/tmp/seed_rl_torch/dmlab_vtrace_${LEVEL}}

exec python -m seed_rl_torch.train \
    --agent=vtrace --env=dmlab --game="$LEVEL" \
    --num_envs=512 --unroll_length=32 \
    --learning_rate=4e-4 --clip_norm=40 \
    --lr_decay_multiplier=0 --adam_beta1=0 --adam_epsilon=3.125e-7 \
    --discounting=0.99 --entropy_cost=0.0025 \
    --total_environment_frames=10000000000 \
    --logdir="$LOGDIR" "${@:2}"
