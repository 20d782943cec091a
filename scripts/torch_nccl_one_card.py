"""What NCCL does on a machine with one card.

1. Spawns two ranks over NCCL, both on cuda:0 (``seed_rl_torch.parallel.
   spawn``), and runs one all-reduce on each; prints each rank's outcome,
   the exception NCCL raises in its own words where it refuses.
2. In a one-rank NCCL group in this process, profiles an in-place
   all-reduce sum, an all-reduce average and an all-gather of 1 MiB each
   (``torch.profiler``), and prints the device kernels each launched: one
   rank's in-place sum is already done, so NCCL may launch nothing.

Both beside the card's name and power limit. Run from the root of a
checkout on a machine with one CUDA card, under a time limit (a rank that
is not refused could wait for the other):

    NCCL_DEBUG=WARN timeout 120 python3 scripts/torch_nccl_one_card.py
"""

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from seed_rl_torch import parallel  # noqa: E402


def all_reduce_once(mesh):
    x = torch.ones(4, device=mesh.device)
    try:
        torch.distributed.all_reduce(x)
        torch.cuda.synchronize(mesh.device)
        return f"rank {mesh.rank}: the all-reduce ran: {x.tolist()}"
    except Exception as exc:  # the refusal is what this script reports
        return f"rank {mesh.rank}: {type(exc).__name__}: {exc}"


def one_rank_kernels():
    """{collective: [(device kernel, launches, device us)]} in a one-rank
    NCCL group."""
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{parallel.mesh.free_port()}",
        world_size=1, rank=0)
    x = torch.ones(1 << 18, device="cuda")
    out = torch.empty_like(x)
    collectives = {
        "all_reduce sum, in place": lambda: dist.all_reduce(x),
        "all_reduce avg, in place": lambda: dist.all_reduce(
            x, op=dist.ReduceOp.AVG),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(out,
                                                                      x),
    }
    found = {}
    try:
        for name, call in collectives.items():
            call()  # the communicator's first use sets it up
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    call()
                torch.cuda.synchronize()
            found[name] = [(e.key, e.count, e.device_time_total)
                           for e in prof.key_averages()
                           if e.device_type == DeviceType.CUDA]
    finally:
        dist.destroy_process_group()
    return found


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    print(f"torch {torch.__version__}, NCCL "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}")
    outcomes = parallel.spawn(all_reduce_once, 2, "cuda", backend="nccl",
                              devices=["cuda:0", "cuda:0"], timeout_secs=60)
    for line in outcomes:
        print(line, flush=True)
    for name, kernels in one_rank_kernels().items():
        print(f"one rank, 10 x {name}: "
              + ("; ".join(f"{k} x{n} ({us:.1f} us)" for k, n, us in kernels)
                 or "no device activity"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
