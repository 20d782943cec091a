"""GFootball-resnet V-trace throughput on synthetic packed SMM frames.

The port of ``scripts/bench_football.py``: the reference's Football agent
consumes bit-packed SMM observations (72x96x4 bool planes packed to
[72, 96, 1] uint16 on the wire) and unpacks them on the device; this
measures that path (the device ``unpackbits``, the 4-stack GFootball
resnet in bf16, V-trace with the V-trace kernel, ``csrc/vtrace_kernel.cu``)
on one card, built by ``seed_rl_torch.bench.football_vtrace_learner``
over the synthetic Football env (``envs/synthetic.py``).

Run:  python -m seed_rl_torch.tools.bench_football [num_envs] [unroll]
          [--device=cpu] [--calls=8]

Prints the script's line, ``football_vtrace_env_frames_per_sec_per_chip:
<frames/s> (<ms> ms/step)``, over ``calls`` train steps after one warm-up
step, then the card's name and power limit.
"""

import argparse
import time

from seed_rl_torch.tools import _timing


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("num_envs", type=int, nargs="?", default=256)
    p.add_argument("unroll", type=int, nargs="?", default=32)
    _timing.add_device_flag(p)
    p.add_argument("--calls", type=int, default=8)
    return p.parse_args(argv)


def main(argv=None):
    """Returns ``{"metric", "value" (frames/s), "ms_per_step", "card"}``."""
    from seed_rl_torch.bench import football_vtrace_learner

    args = parse_args(argv)
    device = _timing.device_from(args.device)
    learner = football_vtrace_learner(device, args.num_envs, args.unroll)
    state, _ = learner.train_many(learner.init(), 1)
    _timing.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(args.calls):
        state, _ = learner.train_many(state, 1)
    _timing.synchronize(device)
    dt = (time.perf_counter() - t0) / args.calls
    fps = args.num_envs * args.unroll / dt
    card = _timing.card(device)
    print(f"football_vtrace_env_frames_per_sec_per_chip: {fps:,.0f} "
          f"({dt * 1e3:.0f} ms/step)", flush=True)
    print(card, flush=True)
    return {"metric": "football_vtrace_env_frames_per_sec_per_chip",
            "value": fps, "ms_per_step": dt * 1e3, "card": card}


if __name__ == "__main__":
    main()
