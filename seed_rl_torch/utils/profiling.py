"""Wall-clock profiling helpers of the remote-actor runtime.

Port of ``seed_rl_tpu/utils/profiling.py`` (the reference's
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
(``torch.profiler``), not these host clocks'.
"""

import enum
import time
from typing import Callable, Optional


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
