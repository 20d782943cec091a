"""The readings the limits of ``correct`` are set from, at a cell's own size.

    python3 perfbench/readings.py --workload <name> --seeds 1,2,3 \
        [--control] [--faults frozen,half_batch,altered]

For each seed it builds the cell, drives its first train steps as a run's
set-up does, and prints the numbers a run compares (``reference/*.py::
compare``): the program's against the plain reference; with ``--control``
the control's, the reference computed a type below the configuration's
(``reference/common.py::Precision.control``) on the same unrolls; with
``--faults`` the program's once more with each fault of
``builders/<builder>.py::FAULTS`` planted. One JSON line a reading goes to
standard output. The benchmark's runs never run this; it needs the card.
"""

import argparse
import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--faults", default="")
    return parser.parse_args(argv)


def readings(workload, seeds, control, fault_names, device, out=sys.stdout):
    import torch

    from perfbench.harness import cell as cells
    from perfbench.harness import runner
    from perfbench.reference import common

    bench = cells.benchmark()
    spec = cells.workload(bench, workload)
    config = cells.config(bench, spec["config"])
    traffic = cells.traffic(spec["traffic"])
    builder = cells.module("builders", config["builder"])
    reference = cells.module("reference", config["reference"])
    if device.type == "cuda":
        from seed_rl_torch.ops.cuda import build
        build.build(config["kernels"])
    # The port's settings, which the program runs at; the reference runs
    # without TF32, as in a run.
    defaults = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
    lines = []

    def program_side(seed, fault):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = defaults
        cell = builder.build(config, traffic, seed, device, reference)
        undo = builder.FAULTS[fault](cell) if fault else None
        try:
            got = builder.check_steps(cell, config["check_steps"])
        finally:
            if undo is not None:
                undo()
        runner.release(cell, device)
        return got

    def emit(seed, kind, numbers):
        line = {"workload": workload, "seed": seed, "kind": kind,
                "numbers": numbers}
        lines.append(line)
        print(json.dumps(line), file=out, flush=True)

    for seed in seeds:
        program, inputs = program_side(seed, None)
        followed = reference.follow(config, traffic, inputs,
                                    common.Precision(), device)
        emit(seed, "program", reference.compare(program, followed))
        if control:
            low = reference.follow(config, traffic, inputs,
                                   common.Precision.control(config), device)
            emit(seed, "control", reference.compare(low, followed))
        for fault in fault_names:
            faulty, faulty_inputs = program_side(seed, fault)
            followed = reference.follow(config, traffic, faulty_inputs,
                                        common.Precision(), device)
            emit(seed, fault, reference.compare(faulty, followed))
    return lines


def main(argv=None) -> int:
    args = parse_args(argv)
    os.environ["SEED_RL_TORCH_BUILD_DIR"] = str(ROOT / "perfbench" / ".cache")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("readings.py needs a CUDA device", file=sys.stderr)
        return 3
    seeds = [int(s) for s in args.seeds.split(",")]
    faults = [f for f in args.faults.split(",") if f]
    readings(args.workload, seeds, args.control, faults,
             torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
