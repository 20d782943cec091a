"""One run of one cell: set-up, the measured window, an optional trace, the
check against the plain reference, and the result line.

Set-up builds the cell (its weights drawn on the device from the seed),
builds the hand kernels (``SEED_RL_TORCH_BUILD_DIR``, set by ``run.py``),
and drives the first train steps, whose outputs the check reads; those
steps warm every shape the window runs. The window then calls the learner's
``train_many(state, 1)`` until ``--seconds`` have passed on the host clock,
with no synchronize inside it, and ends when the device has caught up.
A ``--trace 1`` run then profiles ``profile_steps`` more steps twice (the
traffic mix says how many; ``trace.py``). Only after the device memory's peak is read and the
program is freed does the reference retrace the first steps.
"""

import gc
import json
import sys
import time
from typing import Dict, List, Optional

import torch

from perfbench.harness import cell as cells
from perfbench.harness import spans as span_marks
from perfbench.harness import stats
from perfbench.harness import trace as traces

# Top-level modules no run may hold once its window has closed, and
# modules of the port the benchmark does not use.
FORBIDDEN_TOP = ("jax", "jaxlib", "flax", "seed_rl_tpu")
FORBIDDEN_MODULES = ("seed_rl_torch.bench", "seed_rl_torch.tools",
                     "seed_rl_torch.utils.flops")


class Run:
    """What a per-layer reader reads (``layer_metrics/<name>.py``)."""

    def __init__(self, cell, steps, window_s, span_ms, trace):
        self.cell = cell
        self.steps = steps
        self.window_s = window_s
        self.span_ms: Dict[str, List[float]] = span_ms
        self.trace: Optional[traces.Reading] = trace


def forbidden_modules() -> List[str]:
    found = [m for m in sys.modules
             if m.split(".")[0] in FORBIDDEN_TOP
             or any(m == f or m.startswith(f + ".")
                    for f in FORBIDDEN_MODULES)]
    return sorted(found)


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(cell, seconds: float, device):
    """Train steps until ``seconds`` have passed, then waits for the
    device. Returns (steps, wall seconds, span ms by name, the p90 of the
    intervals between updates' completion in ms, window losses)."""
    marks = span_marks.Spans(device)
    for owner, method, name in cell.spans:
        marks.wrap(owner, method, name)
    learner, state, losses = cell.learner, cell.state, []
    _synchronize(device)
    origin = span_marks.mark(device)
    t0 = time.perf_counter()
    end = t0 + seconds
    steps = 0
    while True:
        state, metrics = learner.train_many(state, 1)
        losses.append(metrics[cell.loss_key])
        steps += 1
        if time.perf_counter() >= end:
            break
    _synchronize(device)
    wall = time.perf_counter() - t0
    marks.unwrap()
    cell.state = state
    ends = marks.ends_ms("update", origin)
    intervals = [b - a for a, b in zip([0.0] + ends, ends)]
    span_ms = {name: marks.durations_ms(name) for name in marks.marks}
    return (steps, wall, span_ms, stats.percentile(intervals, 90),
            torch.stack(losses))


def profile(cell, steps: int, device) -> Optional[traces.Reading]:
    """``steps`` more train steps under ``torch.profiler``, spans named:
    once with device activity only, once with the host's operators too
    (``trace.py``)."""
    from torch.profiler import ProfilerActivity, record_function

    kinds = [[ProfilerActivity.CPU]]
    if device.type == "cuda":
        kinds = [[ProfilerActivity.CUDA],
                 [ProfilerActivity.CPU, ProfilerActivity.CUDA]]
    marks = span_marks.Spans(device)
    for owner, method, name in cell.spans:
        marks.wrap(owner, method, name)
    state, profs = cell.state, []
    for activities in kinds:
        _synchronize(device)
        with torch.profiler.profile(activities=activities) as prof:
            with record_function(traces.WINDOW):
                for _ in range(steps):
                    state, _ = cell.learner.train_many(state, 1)
                _synchronize(device)
        profs.append(prof)
    marks.unwrap()
    cell.state = state
    return traces.read(profs[0], profs[-1], steps)


def run(args, start: float, device: Optional[torch.device] = None,
        plant=None, root=cells.ROOT, out=sys.stdout, err=sys.stderr) -> int:
    """Runs the cell ``args.workload`` once and prints its result line.

    ``device`` None: the cell's chips, or exit 3 when torch sees fewer.
    ``plant(cell)``: a fault put under the built cell for its first steps,
    which returns its undoing (``faults.py``; the tests'). ``root``: the
    checkout whose ``BENCHMARK.json`` and ``perfbench/`` files name the
    cell's parts."""
    bench = cells.benchmark(root)
    spec = cells.workload(bench, args.workload)
    if device is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < spec["chips"]:
            print(f"perfbench: {args.workload} needs {spec['chips']} CUDA "
                  f"device(s); torch sees {have}", file=err)
            return 3
        device = torch.device("cuda", 0)
    config = cells.config(bench, spec["config"], root)
    traffic = cells.traffic(spec["traffic"], root)
    builder = cells.module("builders", config["builder"], root)
    reference = cells.module("reference", config["reference"], root)
    if device.type == "cuda":
        from seed_rl_torch.ops.cuda import build
        build.build(config["kernels"])
    cell = builder.build(config, traffic, args.seed, device, reference)
    undo = plant(cell) if plant is not None else None
    try:
        program, inputs = builder.check_steps(cell, config["check_steps"])
    finally:
        if undo is not None:
            undo()
    _synchronize(device)
    setup_s = time.perf_counter() - start

    steps, wall, span_ms, interval_p90, losses = window(
        cell, args.seconds, device)
    failed = int((~torch.isfinite(losses)).sum())
    reading = (profile(cell, traffic["profile_steps"], device)
               if args.trace else None)
    layer_run = Run(cell, steps, wall, span_ms, reading)
    layer_values = {}
    if args.trace:
        for metric in cells.metrics_of(bench, args.workload, "per_layer"):
            value = cells.module("layer_metrics", metric["name"],
                                 root).read(layer_run)
            if value is not None:
                layer_values[metric["name"]] = (value, metric["unit"])
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")

    frames_per_step = cell.frames_per_step
    layer_run = None
    release(cell, device)
    del cell
    numbers = judge(config, traffic, program, inputs, device, reference)
    limits = config["limits"]
    correct = failed == 0 and all(numbers[n] <= limits[n] for n in limits)

    found = forbidden_modules()
    if found:
        print(f"perfbench: the run holds modules it must not: {found}",
              file=err)
        return 4
    if args.trace:
        metrics = {n: {"value": v, "unit": u}
                   for n, (v, u) in layer_values.items()}
    else:
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        metrics = {
            "env_frames_per_s": {"value": steps * frames_per_step / wall,
                                 "unit": units["env_frames_per_s"]},
            "update_interval_ms_p90": {
                "value": interval_p90, "unit": units["update_interval_ms_p90"]},
            "setup_s": {"value": setup_s, "unit": units["setup_s"]},
        }
    line = {
        "correct": bool(correct),
        "attempted": steps,
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": kind, "count": spec["chips"],
                   "memory_peak_bytes": peak},
    }
    if reading is not None:
        line["device"]["busy_s"] = reading.busy_s
        line["device"]["window_s"] = reading.window_s
        line["breakdown"] = {
            "device_ops": [list(x) for x in reading.device_ops],
            "idle_gaps": [list(x) for x in reading.idle_gaps]}
    line["check"] = {n: {"value": numbers[n], "limit": limits[n]}
                     for n in limits}
    for n in limits:
        print(f"check {n} {numbers[n]!r} limit {limits[n]!r}", file=err)
    print(json.dumps(line), file=out, flush=True)
    return 0


def release(cell, device):
    """Frees the program's state on the device, for the reference, which
    runs without TF32 (its float32 is float32)."""
    cell.learner = cell.state = None
    cell.spans = []
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def judge(config, traffic, program, inputs, device, reference):
    """The gaps of the program's readings from the reference's."""
    from perfbench.reference import common

    followed = reference.follow(config, traffic, inputs, common.Precision(),
                                device)
    return reference.compare(program, followed)
