"""Sweep the V-trace x AtariPolicyNet bench configuration; fps per config.

The port of ``scripts/sweep_bench.py``: for each ``envs,unroll,
steps_per_call`` spec, the learner of ``bench.py::build_learner`` (here
``seed_rl_torch.bench.vtrace_atari_learner``: the bf16 AtariPolicyNet on
synthetic Atari frames, one V-trace kernel launch a train step) runs one
warm-up call and ``--calls`` timed calls of ``steps_per_call`` train steps,
closed by a synchronize.

Run:  python -m seed_rl_torch.tools.sweep_bench [SPEC ...] [--device=cpu]
          [--calls=6]

A SPEC is ``envs,unroll,steps_per_call``, as the script takes them (it
runs none without one); without one, ``GRID``, around ``bench.py``'s
vtrace_atari shape (1024 envs, unroll 32, 2 steps a call). Prints the
script's line per spec, ``envs=... unroll=... spc=... -> ...k fps``,
then the card's name and power limit.
"""

import argparse
import time

from seed_rl_torch.tools import _timing

GRID = ("256,32,1", "512,32,1", "1024,32,1", "1024,32,2", "1024,64,1",
        "2048,32,1")


def measure(device, num_envs, unroll_length, steps_per_call, calls=6):
    """Env frames/s of one configuration; prints its line."""
    from seed_rl_torch.bench import vtrace_atari_learner

    learner = vtrace_atari_learner(device, num_envs, unroll_length)
    state, _ = learner.train_many(learner.init(), steps_per_call)
    _timing.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(calls):
        state, _ = learner.train_many(state, steps_per_call)
    _timing.synchronize(device)
    dt = time.perf_counter() - t0
    fps = calls * steps_per_call * num_envs * unroll_length / dt
    print(f"envs={num_envs:5d} unroll={unroll_length:3d} "
          f"spc={steps_per_call} -> {fps / 1e3:7.1f}k fps", flush=True)
    return fps


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("specs", nargs="*", default=list(GRID))
    _timing.add_device_flag(p)
    p.add_argument("--calls", type=int, default=6)
    return p.parse_args(argv)


def main(argv=None):
    """Returns ``{spec: frames/s}``."""
    args = parse_args(argv)
    device = _timing.device_from(args.device)
    results = {}
    for spec in args.specs:
        envs, unroll, spc = (int(x) for x in spec.split(","))
        results[spec] = measure(device, envs, unroll, spc, args.calls)
    print(_timing.card(device), flush=True)
    return results


if __name__ == "__main__":
    main()
