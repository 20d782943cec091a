"""Episode-info aggregation keyed by eval-name prefix.

Port of ``seed_rl_tpu/utils/evaluator.py``, the reference ``Evaluator``
(agents/policy_gradient/eval_utils.py:30-113): actors (or the learner's own
episode accounting) report finished episodes as ``EpisodeInfo(eval_name,
episode_num_frames, episode_returns, episode_raw_returns)``; ``process()``
groups them by ``eval_name`` (e.g. ``'training/'`` vs ``'eval_actors/'``)
and, once a bucket holds at least ``log_episode_frequency`` episodes, emits
``{name}{field}`` mean and ``{name}{field}_std`` entries and clears the
bucket. A thread-safe queue stands in for the reference's
StructuredFIFOQueue.
"""

import collections
import queue
import threading
from typing import Callable, Dict, Optional

import numpy as np

EpisodeInfo = collections.namedtuple(
    "EpisodeInfo",
    "eval_name episode_num_frames episode_returns episode_raw_returns",
)

# Fields aggregated by process() (all but eval_name), in reference order.
_AGG_FIELDS = EpisodeInfo._fields[1:]


class Evaluator:
    """Thread-safe finished-episode aggregator.

    Args:
      print_episode_summaries: log each episode as it is processed.
      log_episode_frequency: minimum bucket size before a summary is
        emitted (reference eval_utils.py:33-34).
      summary_writer_fn: optional ``fn(name, value)`` called for every
        emitted scalar (the tf.summary.scalar seam).
    """

    def __init__(
        self,
        print_episode_summaries: bool = False,
        log_episode_frequency: int = 1,
        summary_writer_fn: Optional[Callable[[str, float], None]] = None,
    ):
        self.log_episode_frequency = log_episode_frequency
        self.print_episode_summaries = print_episode_summaries
        self._summary_writer_fn = summary_writer_fn
        self._queue: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        # eval_name -> {field -> list of values} (pending, below frequency).
        self._eval_data: Dict[str, Dict[str, list]] = collections.defaultdict(
            lambda: {f: [] for f in _AGG_FIELDS}
        )

    def add(self, data) -> None:
        """Queues one finished episode (EpisodeInfo-shaped tuple)."""
        self._queue.put(EpisodeInfo(*data))

    def add_many(self, data) -> None:
        """Queues a batch: EpisodeInfo-shaped tuple with a leading dim."""
        info = EpisodeInfo(*data)
        for row in zip(*info):
            self._queue.put(EpisodeInfo(*row))

    def reset(self) -> None:
        with self._lock:
            while True:
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    break
            self._eval_data.clear()

    def process(self) -> Dict[str, float]:
        """Drains the queue; returns newly-complete {name: value} summaries."""
        with self._lock:
            while True:
                try:
                    info = self._queue.get_nowait()
                except queue.Empty:
                    break
                name = (
                    info.eval_name.decode("utf-8")
                    if isinstance(info.eval_name, bytes)
                    else str(info.eval_name)
                )
                if self.print_episode_summaries:
                    print(
                        f"Return: {float(info.episode_returns)} Raw return: "
                        f"{float(info.episode_raw_returns)} "
                        f'(key_prefix="{name}") '
                        f"Frames: {int(info.episode_num_frames)}"
                    )
                bucket = self._eval_data[name]
                for field in _AGG_FIELDS:
                    bucket[field].append(float(getattr(info, field)))

            stats: Dict[str, float] = {}
            for name, bucket in self._eval_data.items():
                for field in _AGG_FIELDS:
                    values = bucket[field]
                    if len(values) >= self.log_episode_frequency:
                        arr = np.asarray(values, np.float32)
                        values.clear()
                        stats[name + field] = float(arr.mean())
                        stats[name + field + "_std"] = float(arr.std())
            if self._summary_writer_fn is not None:
                for key, value in stats.items():
                    self._summary_writer_fn(key, value)
            return stats
