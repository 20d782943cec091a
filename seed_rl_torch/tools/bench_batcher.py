"""Throughput of the native dynamic batcher behind the inference server.

The port of ``scripts/bench_batcher.py``. The reference's gRPC inference
layer claims "up to a million QPS" (grpc/README.md:7); this measures the
same surface here: the C++ batcher (``seed_rl_torch/csrc/batcher.cc``,
built by g++ at first use) behind ``runtime/inference_server.py``'s
``InferenceServer``, with N client threads each making blocking per-step
``inference(env_id, obs) -> action`` calls (a 4-float observation, a 1-int
result, the MuJoCo-class wire shape) against a trivial handler, isolating
the batching, slot and wake-up costs from any policy compute. It runs on
the host only: the handler touches no device, so the tool takes no
``--device``.

Run:  python -m seed_rl_torch.tools.bench_batcher [num_clients]
          [batch_size] [seconds]

Defaults 256 clients, batch 128, 5 s. Prints the script's line,
``clients=N batch=B: <calls/s> QPS (<batches> batches, mean fill <f>)``,
with the batches/s added inside the parentheses.
"""

import argparse
import threading
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("num_clients", type=int, nargs="?", default=256)
    p.add_argument("batch_size", type=int, nargs="?", default=128)
    p.add_argument("seconds", type=float, nargs="?", default=5.0)
    return p.parse_args(argv)


def main(argv=None):
    """Returns ``{"clients", "batch_size", "calls_per_sec",
    "batches_per_sec", "batches", "mean_fill", "seconds"}``."""
    from seed_rl_torch.runtime.inference_server import InferenceServer
    from seed_rl_torch.runtime.specs import array_spec

    args = parse_args(argv)
    server = InferenceServer(
        handlers=[lambda env_ids, obs: np.zeros((len(env_ids), 1),
                                                np.int32)],
        request_specs=array_spec((4,), np.float32),
        result_specs=array_spec((1,), np.int32),
        batch_size=args.batch_size,
        flush_timeout_ms=5,
    )
    stop = threading.Event()
    counts = [0] * args.num_clients

    def client(i):
        obs = np.arange(4, dtype=np.float32)
        while not stop.is_set():
            server.inference(i, obs)
            counts[i] += 1

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(args.num_clients)]
    try:
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        time.sleep(args.seconds)
        stop.set()
        for t in threads:
            t.join(timeout=5)
        dt = time.perf_counter() - t0
        stats = server.stats
    finally:
        stop.set()
        server.shutdown()
    stuck = [t.name for t in threads if t.is_alive()]
    if stuck:
        raise RuntimeError(f"client threads did not stop: {stuck}")
    total = sum(counts)
    reqs, batches = stats["total_requests"], stats["total_batches"]
    result = {"clients": args.num_clients, "batch_size": args.batch_size,
              "calls_per_sec": total / dt, "batches_per_sec": batches / dt,
              "batches": batches, "mean_fill": reqs / max(batches, 1),
              "seconds": dt}
    print(f"clients={args.num_clients} batch={args.batch_size}: "
          f"{total / dt:,.0f} QPS ({batches} batches, "
          f"{batches / dt:,.1f} batches/s, mean fill "
          f"{result['mean_fill']:.1f})", flush=True)
    return result


if __name__ == "__main__":
    main()
