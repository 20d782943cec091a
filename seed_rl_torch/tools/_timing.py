"""Timing shared by the measurement tools of ``seed_rl_torch/tools/``.

Every tool runs on the card unless its caller passes ``--device=cpu``
(``add_device_flag``, ``device_from``); without CUDA the card's default
raises, it does not fall back to the CPU.

``timeit`` times a call on the host clock between two
``torch.cuda.synchronize()``: one warm-up call (it builds the kernels and
fills the allocator), then ``iters`` calls in a row, so the time is the
steady state's, each call's work included. On the card it then runs two
more calls under ``torch.profiler`` (device activity only) for the device
busy ms and kernel launches a call and the idle share of PERF.md section
2: ``1 - busy / the unprofiled call's time``. On the CPU those are not
measured (None). Callables that carry state (a train step) keep it in
their closure, so each timed call continues from the last.

The JAX scripts chained scalars through their calls and fetched once,
because their relay backend did not block in ``block_until_ready``; a
synchronize blocks on the card, so none of that is copied here.
"""

import argparse
import time
from typing import Callable, NamedTuple, Optional

import torch

def add_device_flag(parser: argparse.ArgumentParser):
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")


def device_from(name: str) -> torch.device:
    """The device a tool runs on; the card's default raises without CUDA."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device=cpu to run on "
                               "the CPU")
        from seed_rl_torch.ops.cuda import build

        build.build(["vtrace_kernel", "nstep_kernel"])
    return device


def synchronize(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card(device: torch.device) -> str:
    """``name, power.limit`` of the cards (nvidia-smi), or ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    from seed_rl_torch.bench import card_description

    return card_description()


class Data:
    """Random inputs drawn on ``device`` from a generator seeded with
    ``seed`` (on the card a 3.7 GB input is drawn in milliseconds; on the
    host it takes seconds)."""

    def __init__(self, device: torch.device, seed: int = 0):
        self.device = device
        self.generator = torch.Generator(device=device).manual_seed(seed)

    def randn(self, shape, dtype=torch.float32) -> torch.Tensor:
        """Standard normal ``dtype`` values; a 4-d tensor channels_last."""
        x = torch.randn(shape, generator=self.generator,
                        device=self.device).to(dtype)
        if x.dim() == 4:
            x = x.contiguous(memory_format=torch.channels_last)
        return x

    def frames(self, shape) -> torch.Tensor:
        """uint8 frames in [0, 256)."""
        return torch.randint(0, 256, shape, generator=self.generator,
                             device=self.device, dtype=torch.uint8)


class Row(NamedTuple):
    """One timed row: ms a call, frames/s (None without frames), the
    device's busy ms and kernel launches a call, and the idle share (None
    where not measured)."""

    name: str
    ms: float
    fps: Optional[float] = None
    busy_ms: Optional[float] = None
    launches: Optional[float] = None
    idle: Optional[float] = None


PROFILED_CALLS = 2


def device_busy(fn: Callable[[], object], device: torch.device):
    """Device busy ms and kernel launches a call of ``fn``, over
    ``PROFILED_CALLS`` calls (the profiler's kernel rows, device activity
    only; one call of a single short kernel was seen to record nothing);
    (None, None) off the card or where the profiler recorded no device
    time."""
    if device.type != "cuda":
        return None, None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_CALLS):
            fn()
        torch.cuda.synchronize(device)
    rows = prof.key_averages()
    # Annotation ranges also listed as host ops would count twice.
    host = {e.key for e in rows if e.device_type == DeviceType.CPU}
    kernels = [e for e in rows
               if e.device_type == DeviceType.CUDA and e.key not in host]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        return None, None
    return (busy_us / 1e3 / PROFILED_CALLS,
            sum(e.count for e in kernels) / PROFILED_CALLS)


def timeit(name: str, fn: Callable[[], object], device: torch.device,
           iters: int = 20, frames: Optional[int] = None,
           width: int = 46) -> Row:
    """Times ``fn()`` (see the module docstring), prints one row and
    returns it. ``frames``: frames a call, for the frames/s column."""
    fn()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    synchronize(device)
    dt = (time.perf_counter() - t0) / iters
    busy, launches = device_busy(fn, device)
    row = Row(name, dt * 1e3, frames / dt if frames else None, busy,
              launches, None if busy is None else 1 - busy / (dt * 1e3))
    text = f"{name:{width}s} {row.ms:8.2f} ms"
    if row.fps is not None:
        text += f" ({row.fps / 1e3:7.0f}k fps)"
    if busy is not None:
        text += (f"  device busy {busy:.2f} ms, {launches:.0f} launches, "
                 f"idle {row.idle:.3f}")
    print(text, flush=True)
    return row
