"""The port's profiling: spans on the profiler's timeline, and the
wall-clock helpers of the remote-actor runtime.

Spans name the layers of a train step on ``torch.profiler``'s timeline,
the clock that also stamps the device's kernels:

- ``span(name, args=None)``: a context manager. Off (the default), it is
  one shared no-op context returned after a single check of a module
  flag: no ``record_function``, no string built, nothing allocated. On,
  it enters ``torch.profiler.record_function("seed_rl_torch." + name)``,
  so a trace holds the span with its start, end and parent (the span it
  nests in); ``args`` goes to the range as a string. The root span
  ``train_step`` carries the learner's step number.
- ``recording()``: turns the spans on while the ``with`` block runs, in
  every thread (autograd's backward thread too). Recording is explicit:
  a profiler that runs outside ``recording()`` sees none of the spans.
  ``train.py --run_mode=profile`` records them into its Chrome trace.

The spans (the learners, ``rollout.py``, ``replay.py``, ``optim.py`` and
the torsos in ``models/``): ``train_step``; ``rollout`` with
``rollout.policy_step`` and ``rollout.env_step`` for each env step (the
eager loop's, and a capture's once, under ``rollout.capture``), or with
``rollout.graph_replay`` where a CUDA graph replays the steps;
``torso`` (every forward, a checkpointed torso's recompute too);
``core`` (GTrXL's layers, acting and learning) with ``core.memory``
(acting's episode mask and memory writes, ``models/gtrxl.py``);
``update`` with ``update.loss`` (R2D2: ``update.burn_in`` first),
``update.backward`` and ``update.optimizer`` (R2D2 on the card: the
first two once under ``update.capture``, then ``update.graph_replay``
where a CUDA graph replays the batch's forward and backward);
``replay.insert``,
``replay.priorities``, ``replay.sample``, ``replay.gather`` and
``replay.update_priorities``.

The remote-actor runtime's wall-clock helpers port
``seed_rl_tpu/utils/profiling.py`` (the reference's
common/profiling.py and the PPO ``--profile_inference_return`` switch,
agents/policy_gradient/learner_config.py:24-29):

- ``ExportingTimer``: a context manager summing wall-clock durations and
  exporting the window's average every ``aggregation_window_size`` uses
  (reference profiling.py:42-76) to a callback; ``flush`` exports a
  partial window, so a short run still reports what it measured.
- ``InferenceReturn``: early-return stages of ``InferenceBridge.handler``.
  With ``profile_inference_return`` set the handler returns zero actions at
  that stage, so each stage's cost (batching only / + state gather / + the
  policy step / + the unroll store) is the difference of two throughputs,
  the reference's method.

Device time inside the policy step is the profiler's to show
(``torch.profiler``, under the spans), not these host clocks'.
"""

import contextlib
import enum
import time
from typing import Callable, Iterator, Optional

from torch.profiler import record_function

PREFIX = "seed_rl_torch."
_OFF = contextlib.nullcontext()
_recording = False


def span(name: str, args=None):
    """A span named ``name`` while ``recording()`` is on; else the shared
    no-op context."""
    if not _recording:
        return _OFF
    return record_function(PREFIX + name,
                           None if args is None else str(args))


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Turns the spans on for the ``with`` block."""
    global _recording
    previous, _recording = _recording, True
    try:
        yield
    finally:
        _recording = previous


class InferenceReturn(enum.Enum):
    """Early-return stages (reference learner_config.py:24-29)."""

    INSTANTLY = 1  # request batching and dispatch only
    BEFORE_INFERENCE = 2  # + run_id bookkeeping and the state gather
    AFTER_INFERENCE = 3  # + the policy step
    AFTER_UNROLL = 4  # + the unroll-store append
    END = 5  # the full handler (no early return)


class ExportingTimer:
    """``with timer:`` accumulator exporting windowed wall-clock averages."""

    def __init__(
        self,
        name: str,
        aggregation_window_size: int = 100,
        export_fn: Optional[Callable[[str, float], None]] = None,
    ):
        self.name = name
        self.window = aggregation_window_size
        self.export_fn = export_fn
        self.last_average: Optional[float] = None
        self._sum = 0.0
        self._count = 0
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sum += time.perf_counter() - self._t0
        self._count += 1
        if self._count >= self.window:
            self.flush()
        return False

    def flush(self) -> None:
        """Exports the current window's average, if it holds a measurement,
        and starts a new window."""
        if not self._count:
            return
        self.last_average = self._sum / self._count
        if self.export_fn is not None:
            self.export_fn(self.name, self.last_average)
        self._sum = 0.0
        self._count = 0
