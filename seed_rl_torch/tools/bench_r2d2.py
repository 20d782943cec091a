"""R2D2 throughput at the reference cloud shape (gcp/train_atari.sh).

The port of ``scripts/bench_r2d2.py``: 256 envs, unroll 80, burn-in 40,
batch 64, a prioritized replay of 512 unrolls (minimum 8), n 5, the
target net every 2500 batches, the bf16 DuelingLSTMDQNNet on synthetic
84x84 Atari frames, built by ``seed_rl_torch.bench.r2d2_atari_learner``.
Each train step is a rollout, an insert and a batch, so it launches the
n-step kernel (``csrc/nstep_kernel.cu``) twice: at [81, 256] for the
insert's priorities and at [81, 64] for the batch's loss.

Run:  python -m seed_rl_torch.tools.bench_r2d2 [--device=cpu]
          [--num_envs=256] [--calls=8]

Prints the script's JSON line, ``metric``
``r2d2_atari_env_frames_per_sec_per_chip``, ``value`` (env frames/s over
``calls`` calls after one warm-up call, closed by a synchronize),
``unit`` and ``vs_baseline`` (null: the script's anchor is another
accelerator's figure), with ``card`` (nvidia-smi's name and power limit)
added.
"""

import argparse
import json
import time

from seed_rl_torch.tools import _timing

# The reference cloud shape: unroll, burn-in, replay unrolls, batch.
UNROLL, BURN_IN, REPLAY_BUFFER_SIZE, BATCH_SIZE = 80, 40, 512, 64


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _timing.add_device_flag(p)
    p.add_argument("--num_envs", type=int, default=256)
    p.add_argument("--calls", type=int, default=8)
    return p.parse_args(argv)


def main(argv=None):
    """Prints the JSON line and returns it."""
    from seed_rl_torch.bench import r2d2_atari_learner, warm_replay

    args = parse_args(argv)
    device = _timing.device_from(args.device)
    learner = r2d2_atari_learner(device, args.num_envs, UNROLL, BURN_IN,
                                 REPLAY_BUFFER_SIZE, BATCH_SIZE)
    state = warm_replay(learner)
    state, _ = learner.train_many(state, 1)
    _timing.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(args.calls):
        state, _ = learner.train_many(state, 1)
    _timing.synchronize(device)
    dt = time.perf_counter() - t0
    fps = args.calls * args.num_envs * UNROLL / dt
    line = {"metric": "r2d2_atari_env_frames_per_sec_per_chip",
            "value": fps, "unit": "frames/s", "vs_baseline": None,
            "card": _timing.card(device)}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
