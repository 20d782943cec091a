"""Reads two ``torch.profiler`` traces of the same number of train steps.

The first records device activity only, so the host pays nothing for the
trace and the device's idle time is the program's own. Its window runs
from the first device activity of the traced steps to the end of the
last; kernels, copies and sets give ``busy_s``, the union of their
intervals, and kernels alone count as launches.

The second records the host's operators too, which slows a host-bound
step, and gives what needs the host's side: the convolutions' device time
(ATen's ``convolution`` and ``convolution_backward`` ops, their own kernels
and their children's), and the longest idle gaps on the device, each named
by the innermost benchmark span (``perfbench.<name>``, ``spans.py``) open on
the host at its middle, else ``other``.
"""

from typing import Dict, List, NamedTuple, Optional, Tuple

from torch.autograd import DeviceType

from perfbench.harness import stats

WINDOW = "perfbench.traced_window"
CONV_OPS = ("aten::convolution", "aten::convolution_backward")
NOT_KERNELS = ("Memcpy", "Memset")
TOP = 10
NAME_CHARS = 160


class Reading(NamedTuple):
    window_s: float
    busy_s: float
    steps: int
    launches: int
    conv_device_s: float
    kernel_s: Dict[str, float]  # device seconds by kernel name
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]

    def kernel_seconds(self, part: str) -> Optional[float]:
        """Device seconds of the kernels whose names hold ``part``, or None
        where none ran."""
        found = [s for name, s in self.kernel_s.items() if part in name]
        return sum(found) if found else None


def _device(events):
    """Device activity, without the host ranges the profiler mirrors onto
    the device's timeline."""
    host = {e.name for e in events if e.device_type == DeviceType.CPU}
    return [e for e in events if e.device_type == DeviceType.CUDA
            and e.name not in host and not e.name.startswith("perfbench.")]


def _intervals(events):
    return [(e.time_range.start, e.time_range.end) for e in events]


def read(device_prof, host_prof, steps: int) -> Reading:
    device = _device(list(device_prof.events()))
    intervals = _intervals(device)
    w0 = min((a for a, _ in intervals), default=0.0)
    w1 = max((b for _, b in intervals), default=0.0)
    kernel_s: Dict[str, float] = {}
    launches = 0
    for e in device:
        if not e.name.startswith(NOT_KERNELS):
            launches += 1
        kernel_s[e.name] = (kernel_s.get(e.name, 0.0)
                            + (e.time_range.end - e.time_range.start) / 1e6)

    events = list(host_prof.events())
    window = next(e for e in events if e.name == WINDOW
                  and e.device_type == DeviceType.CPU)
    spans = [(e.time_range.start, e.time_range.end, e.name[len("perfbench."):])
             for e in events if e.device_type == DeviceType.CPU
             and e.name.startswith("perfbench.") and e.name != WINDOW]

    def span_at(t):
        open_ = [s for s in spans if s[0] <= t <= s[1]]
        return max(open_)[2] if open_ else "other"

    idle = sorted(((b - a) / 1e6, span_at((a + b) / 2)) for a, b in stats.gaps(
        _intervals(_device(events)), window.time_range.start,
        window.time_range.end))[::-1][:TOP]
    conv_us = sum(row.device_time_total for row in host_prof.key_averages()
                  if row.key in CONV_OPS)
    ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
    return Reading(
        window_s=(w1 - w0) / 1e6,
        busy_s=stats.covered(intervals) / 1e6,
        steps=steps,
        launches=launches,
        conv_device_s=conv_us / 1e6,
        kernel_s=kernel_s,
        device_ops=[(name[:NAME_CHARS], s) for name, s in ops],
        idle_gaps=[(name, s) for s, name in idle],
    )
