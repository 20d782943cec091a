"""Console metrics logging with the env-frames/s throughput metric.

Port of ``seed_rl_tpu/utils/metrics.py``. Train steps return a flat
``{name: scalar tensor}`` dict; this turns it into floats on the host at
the logging cadence (each conversion waits for the device). TensorBoard
writing waits for the utils slice, with checkpointing.
"""

import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, console_every_secs: float = 30.0):
        self._console_every = console_every_secs
        self._last_console = 0.0
        self._last_speed_time = None
        self._last_speed_frames = 0

    def log(self, step: int, metrics: Dict[str, float],
            frames: Optional[int] = None):
        metrics = {k: float(v) for k, v in metrics.items()}
        if frames is not None:
            now = time.time()
            if self._last_speed_time is not None:
                dt = now - self._last_speed_time
                if dt > 0:
                    metrics["speed/env_frames_per_sec"] = (
                        frames - self._last_speed_frames
                    ) / dt
            self._last_speed_time = now
            self._last_speed_frames = frames

        now = time.time()
        if now - self._last_console >= self._console_every:
            self._last_console = now
            parts = [f"step={step}"]
            if frames is not None:
                parts.append(f"frames={frames}")
            for key in sorted(metrics):
                parts.append(f"{key}={metrics[key]:.4g}")
            print("[seed_rl_torch] " + " ".join(parts), flush=True)
