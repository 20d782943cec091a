"""Spans recorded from the benchmark's side, around the program's calls.

``Spans.wrap(owner, method, name)`` shadows one instance's method by a
wrapper that records a mark on the device's timeline before and after the
call (a CUDA event on the current stream; on the CPU, the host clock) and
opens a ``torch.profiler.record_function`` range named ``perfbench.<name>``
that a traced run sees. Nothing waits for the device: the events are read
once the window has closed (``durations_ms``). ``unwrap`` restores the
instance.
"""

import time
from collections import defaultdict
from typing import Dict, List

import torch
from torch.profiler import record_function


class _HostMark:
    """A host-clock stand-in for a CUDA event, for runs on the CPU."""

    def __init__(self):
        self.t = time.perf_counter()

    def elapsed_time(self, later: "_HostMark") -> float:
        return (later.t - self.t) * 1e3


def mark(device: torch.device):
    """A mark on ``device``'s timeline (the current stream's position)."""
    if device.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event
    return _HostMark()


class Spans:
    """The marks of each named span, in call order."""

    def __init__(self, device: torch.device):
        self.device = device
        self.marks: Dict[str, List[tuple]] = defaultdict(list)
        self._wrapped: List[tuple] = []

    def wrap(self, owner, method: str, name: str):
        original = getattr(owner, method)
        marks = self.marks[name]
        label = f"perfbench.{name}"

        def wrapped(*args, **kwargs):
            start = mark(self.device)
            with record_function(label):
                out = original(*args, **kwargs)
            marks.append((start, mark(self.device)))
            return out

        setattr(owner, method, wrapped)
        self._wrapped.append((owner, method))

    def unwrap(self):
        for owner, method in reversed(self._wrapped):
            delattr(owner, method)
        self._wrapped.clear()

    def durations_ms(self, name: str) -> List[float]:
        """Each call's span on the device's timeline, in ms. Call after the
        device has caught up."""
        return [a.elapsed_time(b) for a, b in self.marks.get(name, ())]

    def ends_ms(self, name: str, origin) -> List[float]:
        """When each call's span closed, in ms after the mark ``origin``."""
        return [origin.elapsed_time(b) for _, b in self.marks.get(name, ())]
