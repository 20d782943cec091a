"""The program's own spans read from one ``torch.profiler`` trace, layer by
layer: launches, host syncs, device time and device idle under each span.

``seed_rl_torch.utils.profiling`` names the layers of a train step
(``seed_rl_torch.<name>`` ranges, off unless ``recording()`` is on).
``reading(run)`` drives the cell's ``profile_steps`` more train steps under
``recording()`` and one trace with the host's operators and the device,
once per run, and keeps the table on the ``Run``. A program without the
spans (no ``recording``) gives None, and so does a trace that holds none.

The trace is read in one pass over ``kineto_results.events()``. The rules:

- A launch is a kernel (not a ``Memcpy`` or ``Memset``). Its launch call
  is the CUDA API call (a host event named ``cuda...`` or ``cu...``) that
  shares the kernel's correlation id; its launching thread is that of the
  host range whose correlation id is the kernel's linked one and which
  holds the call (the profiler's own events may share the id), else the
  call's own. It belongs to the innermost program span open on that
  thread at the launch call; where no span is open on that thread
  (autograd's backward thread), to the innermost span open then on the
  thread of ``train_step`` (the thread that called ``backward``). A kernel
  whose call is missing is placed at its operator's start.
- A host sync is a ``cudaStreamSynchronize``, ``cudaDeviceSynchronize`` or
  ``cudaEventSynchronize`` runtime call, or a blocking ``cudaMemcpy``,
  placed as a launch is. Only those inside ``train_step`` count.
- Device idle is the gaps in the union of device intervals (kernels,
  copies, sets). A span's idle is the part of its extent, on the thread of
  ``train_step``, that the union does not cover.

A span's numbers take in its children's: a launch counts for the span it
belongs to and each span that encloses it, once a name. A span opened on
another thread (a checkpointed torso's recompute in the backward) is
enclosed by the span open then on the thread of ``train_step``.

    python3 -m perfbench.harness.program_trace --workload <cell> --seed <n>

prints the table (per train step, by span name) as one JSON object.
"""

import argparse
import bisect
import json
import os
import pathlib
import sys
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import DeviceType

from perfbench.harness import stats
from perfbench.harness.trace import NOT_KERNELS

PREFIX = "seed_rl_torch."
ROOT_SPAN = "train_step"
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")
OUTSIDE = "(outside)"


class Event(NamedTuple):
    """One trace event, as the reading needs it. ``kind``: ``span`` (a
    program span), ``op`` (another host range), ``runtime`` (a CUDA API
    call), ``kernel`` or ``device`` (a copy or a set). Times in
    ns."""

    kind: str
    name: str
    thread: int
    start: int
    end: int
    corr: int = 0  # the event's own correlation id
    linked: int = 0  # the launching operator's, on runtime calls and kernels


def _events_of(kineto_events) -> List[Event]:
    """Kineto's events as ``Event``s; device ranges that mirror a host
    range, and copies of host names, are left out."""
    host, device = [], []
    for e in kineto_events:
        name = e.name()
        start = e.start_ns()
        row = (name, e.start_thread_id(), start, start + e.duration_ns(),
               e.correlation_id(), e.linked_correlation_id())
        if e.device_type() == DeviceType.CPU:
            host.append(row)
        elif e.device_type() == DeviceType.CUDA:
            device.append(row)
    host_names = {row[0] for row in host}
    out = []
    for name, thread, start, end, corr, linked in host:
        if name.startswith(PREFIX):
            kind = "span"
        elif name.startswith("cu") and "::" not in name:
            kind = "runtime"  # CUDA's API calls, cuda* and cu*
        else:
            kind = "op"
        out.append(Event(kind, name, thread, start, end, corr, linked))
    for name, thread, start, end, corr, linked in device:
        if name in host_names or name.startswith((PREFIX, "perfbench.")):
            continue
        kind = "device" if name.startswith(NOT_KERNELS) else "kernel"
        out.append(Event(kind, name, thread, start, end, corr, linked))
    return out


class _Timeline:
    """The innermost span open at each instant of one thread's timeline,
    and each span's parent there."""

    def __init__(self, spans: List[int], events: List[Event]):
        # At one instant: closings first, then the longer span opens first.
        # A span of no length opens nothing.
        spans = [i for i in spans if events[i].end > events[i].start]
        bounds = sorted([(events[i].start, 1, -events[i].end, i)
                         for i in spans]
                        + [(events[i].end, 0, 0, i) for i in spans])
        self.times: List[int] = []
        self.innermost: List[Optional[int]] = []
        self.parent: Dict[int, Optional[int]] = {}
        stack: List[int] = []
        for t, opening, _, i in bounds:
            if opening:
                self.parent[i] = stack[-1] if stack else None
                stack.append(i)
            else:
                stack.remove(i)
            self.times.append(t)
            self.innermost.append(stack[-1] if stack else None)

    def at(self, t: int) -> Optional[int]:
        k = bisect.bisect_right(self.times, t) - 1
        return self.innermost[k] if k >= 0 else None


class _Busy:
    """The union of device intervals, and how much of a range it covers."""

    def __init__(self, intervals):
        merged = stats.union(intervals)
        self.starts = [a for a, _ in merged]
        self.ends = [b for _, b in merged]
        self.before = [0]  # covered time before each merged interval
        for a, b in merged:
            self.before.append(self.before[-1] + b - a)

    def _upto(self, t):
        k = bisect.bisect_right(self.starts, t)
        if k == 0:
            return 0
        return self.before[k - 1] + min(t, self.ends[k - 1]) - self.starts[
            k - 1]

    def covered(self, a, b):
        return self._upto(b) - self._upto(a)


def table(events: List[Event]) -> Optional[Dict[str, Dict[str, float]]]:
    """Per train step, for each span name: ``calls``, ``host_ms``,
    ``launches``, ``self_launches``, ``syncs``, ``device_ms`` and
    ``idle_ms``; ``(outside)`` holds the launches, syncs and device ms
    outside every span. None where the events hold no ``train_step``."""
    spans = [i for i, e in enumerate(events) if e.kind == "span"]
    roots = [i for i in spans if events[i].name == PREFIX + ROOT_SPAN]
    if not roots:
        return None
    main = events[roots[0]].thread
    by_thread: Dict[int, List[int]] = {}
    for i in spans:
        by_thread.setdefault(events[i].thread, []).append(i)
    timelines = {t: _Timeline(s, events) for t, s in by_thread.items()}
    on_main = timelines[main]

    # Each span's enclosing names (its own too), up through the main
    # thread's span open where a chain on another thread starts.
    enclosing: Dict[Optional[int], frozenset] = {None: frozenset()}

    def names_of(i):
        if i not in enclosing:
            timeline = timelines[events[i].thread]
            parent = timeline.parent.get(i, timeline.at(events[i].start))
            if parent is None and events[i].thread != main:
                parent = on_main.at(events[i].start)
            enclosing[i] = names_of(parent) | {events[i].name[len(PREFIX):]}
        return enclosing[i]

    for i in sorted(spans, key=lambda i: events[i].start):
        names_of(i)

    # Host ranges by correlation id; the profiler's own host events may
    # share an operator's id, so an id can name more than one.
    ops: Dict[int, List[Event]] = {}
    for e in events:
        if e.kind in ("op", "span") and e.corr:
            ops.setdefault(e.corr, []).append(e)
    calls = {e.corr: e for e in events if e.kind == "runtime" and e.corr}

    def place(thread, t):
        timeline = timelines.get(thread)
        inner = timeline.at(t) if timeline is not None else None
        return inner if inner is not None else on_main.at(t)

    def owner(e: Event) -> Optional[int]:
        """The span a kernel's launch or a runtime call belongs to."""
        call = e if e.kind == "runtime" else calls.get(e.corr)
        candidates = ops.get(e.linked, []) if e.linked else []
        if call is None:
            if not candidates:
                return place(main, e.start)
            return place(candidates[0].thread, candidates[0].start)
        # The launching operator holds its launch call.
        for op in candidates:
            if op.start <= call.start <= op.end:
                return place(op.thread, call.start)
        return place(call.thread, call.start)

    rows: Dict[str, Dict[str, float]] = {}

    def row(name):
        return rows.setdefault(name, dict.fromkeys(
            ("calls", "host_ms", "launches", "self_launches", "syncs",
             "device_ms", "idle_ms"), 0.0))

    for i in spans:
        r = row(events[i].name[len(PREFIX):])
        r["calls"] += 1
        r["host_ms"] += (events[i].end - events[i].start) / 1e6
    busy = _Busy([(e.start, e.end) for e in events
                  if e.kind in ("kernel", "device")])
    for i in by_thread[main]:
        e = events[i]
        row(e.name[len(PREFIX):])["idle_ms"] += (
            (e.end - e.start) - busy.covered(e.start, e.end)) / 1e6
    for e in events:
        if e.kind == "kernel":
            i = owner(e)
            names = enclosing.get(i, frozenset()) or {OUTSIDE}
            for name in names:
                row(name)["launches"] += 1
                row(name)["device_ms"] += (e.end - e.start) / 1e6
            row(events[i].name[len(PREFIX):] if i is not None
                else OUTSIDE)["self_launches"] += 1
        elif e.kind == "runtime" and e.name in SYNCS:
            names = enclosing.get(owner(e), frozenset())
            if ROOT_SPAN in names:
                for name in names:
                    row(name)["syncs"] += 1
    steps = len(roots)
    return {name: {k: v / steps for k, v in r.items()}
            for name, r in sorted(rows.items())}


def trace(cell, steps: int, device):
    """``steps`` more train steps of ``cell`` under ``recording()`` and one
    trace of the host's operators and the device; returns the table, or
    None where the program has no spans."""
    try:
        from seed_rl_torch.utils.profiling import recording
    except ImportError:
        return None
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    state = cell.state
    with torch.profiler.profile(activities=activities) as prof:
        with recording():
            for _ in range(steps):
                state, _ = cell.learner.train_many(state, 1)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    cell.state = state
    return table(_events_of(prof.profiler.kineto_results.events()))


def reading(run) -> Optional[Dict[str, Dict[str, float]]]:
    """The table of ``run``'s cell over as many steps as its trace
    (``run.trace``), traced at the first call and kept on the run; None
    without a trace."""
    if not hasattr(run, "program_spans"):
        run.program_spans = None
        if run.trace is not None:
            cell = run.cell
            device = cell.learner.parameters()[0].device
            run.program_spans = trace(cell, run.trace.steps, device)
    return run.program_spans


def value(run, name: str, key: str) -> Optional[float]:
    """``key`` of span ``name`` per train step, or None where the run's
    trace holds no such span."""
    spans = reading(run)
    if spans is None or name not in spans:
        return None
    return spans[name][key]


def cell_table(workload: str, seed: int, device, root: pathlib.Path):
    """The table of ``workload`` built from ``seed`` on ``device``, over its
    ``profile_steps`` after the check's steps have warmed every shape."""
    from perfbench.harness import cell as cells

    bench = cells.benchmark(root)
    spec = cells.workload(bench, workload)
    config = cells.config(bench, spec["config"], root)
    traffic = cells.traffic(spec["traffic"], root)
    if device.type == "cuda":
        from seed_rl_torch.ops.cuda import build
        build.build(config["kernels"])
    builder = cells.module("builders", config["builder"], root)
    reference = cells.module("reference", config["reference"], root)
    cell = builder.build(config, traffic, seed, device, reference)
    cell.state, _ = cell.learner.train_many(cell.state,
                                            config["check_steps"])
    return trace(cell, traffic["profile_steps"], device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    args = parser.parse_args(argv)
    root = pathlib.Path(__file__).resolve().parents[2]
    cache = root / "perfbench" / ".cache"
    os.environ["SEED_RL_TORCH_BUILD_DIR"] = str(cache)
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    if not torch.cuda.is_available():
        print("program_trace: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    spans = cell_table(args.workload, args.seed, device, root)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "device": torch.cuda.get_device_name(device),
                      "spans": spans}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
