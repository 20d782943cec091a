"""Weak-scaling efficiency harness: env frames/s against the replica count.

The port of ``scripts/bench_scaling.py``. BASELINE.md's scale-out target
is at least 80% env-steps/s scaling efficiency from 1 to N replicas. Each
count runs the fused V-trace step (rollout + update) data-parallel over
that many ranks (``seed_rl_torch.parallel``: ``parallel.spawn``, a
``BatchedEnv`` sharded by rank, ``DistributedLearner``, the gradient
all-reduce), the envs weak-scaled at ``--envs_per_replica`` a replica, and
reports rank 0's frames/s (global frames over its synchronized time) and
the efficiency against the smallest count.

``--backend=nccl`` (the default on the card) puts rank r on ``cuda:r``;
NCCL refuses two ranks on one card, so more ranks than cards raise there.
``--backend=gloo`` runs the collectives through the host and may put
several ranks on one card (rank r on ``cuda:(r mod cards)``): on one H100
that checks the code path, not hardware scaling, and the summary says so
in ``note``, as the script does for its virtual CPU devices. On the CPU
(``--device=cpu``) every rank runs on the CPU over gloo.

Models (``build_learner``, the script's): ``mlp``, an MLPPolicyNetwork
(64, 64) with a tanh-normal policy on the toy env (horizon 20); ``atari``,
the bf16 AtariPolicyNet (LSTM 256) on synthetic Atari frames
(``seed_rl_torch.bench.vtrace_atari_learner``). Both launch the V-trace
kernel once a train step on each rank.

Run:  python -m seed_rl_torch.tools.bench_scaling [--replicas=1,2,4]
          [--model=mlp|atari] [--envs_per_replica=64] [--unroll=16]
          [--steps_per_call=2] [--calls=4] [--backend=nccl|gloo]
          [--device=cpu]

Each rank runs on the caller's torch thread count.

``--replicas`` defaults to the powers of two up to the card count (1 on
the CPU). Prints one line a count and the script's summary JSON line
(``metric``, ``value``, ``unit``, ``platform``, ``frames_per_sec``, and
``note`` where ranks share a device), with ``card`` added.
"""

import argparse
import json
import time

import torch

from seed_rl_torch.tools import _timing

SHARED_CARD_NOTE = (
    "the ranks share one card (gloo collectives through the host): this "
    "checks the data-parallel code path, not hardware scaling; weak-scaling "
    "efficiency is only meaningful with a card a rank")
CPU_NOTE = (
    "CPU ranks share one host's cores: this validates the data-parallel "
    "code path, not hardware scaling; weak-scaling efficiency is only "
    "meaningful on real cards")


def build_learner(model, num_envs, unroll_length, device="cuda", mesh=None):
    """The script's V-trace learner over ``num_envs`` envs (this rank's
    share of them under ``mesh``)."""
    from seed_rl_torch import bench

    device = torch.device(device)
    if model == "atari":
        return bench.vtrace_atari_learner(device, num_envs, unroll_length,
                                          mesh)
    if model != "mlp":
        raise ValueError(f"unknown model {model!r}")
    from seed_rl_torch import distributions as pd
    from seed_rl_torch.envs import BatchedEnv, ToyEnv
    from seed_rl_torch.models import MLPPolicyNetwork

    dist = pd.NormalTanhDistribution(3)
    net = MLPPolicyNetwork(dist.param_size, 4, mlp_sizes=(64, 64), seed=0,
                           device=device)
    env = BatchedEnv(ToyEnv(horizon=20), num_envs, device=device, mesh=mesh)
    return bench._vtrace_learner(env, net, dist, unroll_length)


def rank_fps(mesh, model, envs_per_replica, unroll, steps_per_call, calls):
    """One rank's run (``parallel.spawn``'s function): env frames/s of the
    whole mesh over this rank's time."""
    from seed_rl_torch.parallel import DistributedLearner

    num_envs = envs_per_replica * mesh.size
    learner = DistributedLearner(
        build_learner(model, num_envs, unroll, mesh.device, mesh), mesh)
    state, _ = learner.train_many(learner.init(), steps_per_call)  # warm-up
    _timing.synchronize(mesh.device)
    if mesh.collective:
        mesh.barrier()
    t0 = time.perf_counter()
    for _ in range(calls):
        state, _ = learner.train_many(state, steps_per_call)
    _timing.synchronize(mesh.device)
    dt = time.perf_counter() - t0
    return calls * steps_per_call * num_envs * unroll / dt


def rank_devices(n, device, backend):
    """The device of each of ``n`` ranks."""
    device = torch.device(device)
    if device.type != "cuda":
        return ["cpu"] * n
    cards = torch.cuda.device_count()
    if backend == "nccl" and n > cards:
        raise ValueError(f"{n} NCCL ranks need as many cards; there are "
                         f"{cards} (NCCL refuses two ranks on one card: "
                         "--backend=gloo shares them)")
    return [f"cuda:{r % cards}" for r in range(n)]


def measure(model, n_replicas, envs_per_replica, unroll, steps_per_call,
            calls, backend="nccl", device="cuda"):
    """Rank 0's env frames/s of one count; each rank runs on this
    process's torch thread count."""
    from seed_rl_torch import parallel

    devices = rank_devices(n_replicas, device, backend)
    return parallel.spawn(
        rank_fps, n_replicas, devices[0], backend=backend, devices=devices,
        args=(model, envs_per_replica, unroll, steps_per_call, calls),
        threads=torch.get_num_threads())[0]


def measure_all(model, replicas, envs_per_replica, unroll, steps_per_call,
                calls, backend="nccl", device="cuda"):
    """``{count: frames/s}``; prints one line a count."""
    results = {}
    for n in replicas:
        fps = measure(model, n, envs_per_replica, unroll, steps_per_call,
                      calls, backend, device)
        results[n] = fps
        eff = fps / (results[replicas[0]] * n / replicas[0])
        print(f"replicas={n:3d} envs={envs_per_replica * n:6d} "
              f"-> {fps / 1e3:9.1f}k frames/s  efficiency={eff:6.1%}",
              flush=True)
    return results


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--replicas", default=None,
                   help="comma list, e.g. 1,2,4 (default: the powers of two "
                        "up to the card count; 1 on the CPU)")
    p.add_argument("--model", default="mlp", choices=["mlp", "atari"])
    p.add_argument("--envs_per_replica", type=int, default=64)
    p.add_argument("--unroll", type=int, default=16)
    p.add_argument("--steps_per_call", type=int, default=2)
    p.add_argument("--calls", type=int, default=4)
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="default: nccl on the card, gloo on the CPU")
    _timing.add_device_flag(p)
    return p.parse_args(argv)


def main(argv=None):
    """Prints the lines and returns the summary."""
    args = parse_args(argv)
    device = _timing.device_from(args.device)
    backend = args.backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type != "cuda" and backend != "gloo":
        raise ValueError("CPU ranks run over gloo")
    if args.replicas:
        # Sorted and deduplicated: the efficiency is against the smallest
        # count.
        replicas = sorted({int(x) for x in args.replicas.split(",")})
    else:
        cards = torch.cuda.device_count() if device.type == "cuda" else 1
        replicas, n = [], 1
        while n <= cards:
            replicas.append(n)
            n *= 2
    results = measure_all(args.model, replicas, args.envs_per_replica,
                          args.unroll, args.steps_per_call, args.calls,
                          backend, args.device)
    n_max = replicas[-1]
    eff = results[n_max] / (results[replicas[0]] * n_max / replicas[0])
    summary = {
        "metric": f"scaling_efficiency_{replicas[0]}_to_{n_max}_replicas",
        "value": eff,
        "unit": "fraction",
        "platform": device.type,
        "frames_per_sec": {str(k): v for k, v in results.items()},
    }
    if device.type != "cuda":
        summary["note"] = CPU_NOTE
    elif n_max > torch.cuda.device_count():
        summary["note"] = SHARED_CARD_NOTE
    summary["card"] = _timing.card(device)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
