"""The port's MetricsLogger (``seed_rl_torch/utils/metrics.py``) against
the JAX package's.

The same ``log`` calls go into the JAX ``MetricsLogger`` (which writes
through ``tensorboardX``) and the port's (which writes the event file
itself). Both files are read back with TensorBoard's ``EventAccumulator``:
the tags, the steps and the float32 values must be equal. The
wall-clock-derived ``speed/env_frames_per_sec`` is compared by tag and
step only. The CRC32C of the TFRecord framing is held to published check
values.
"""

import os

import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_accumulator import (
    EventAccumulator,
)

from seed_rl_tpu.utils.metrics import MetricsLogger as JaxMetricsLogger
from seed_rl_torch.utils import metrics

SPEED = "speed/env_frames_per_sec"

# (step, {tag: value}, frames)
CALLS = [
    (1, {"losses/total": 0.5, "policy/entropy": 1.0 / 3.0}, 640),
    (2, {"losses/total": -1.25e-7, "policy/entropy": 1.1,
         "episodes/mean_return": -123.456}, 1280),
    (5, {"losses/total": 3.0e38, "grad/norm": 0.0}, None),
    (10, {"losses/total": 7.0, "V/L2_error": 1e-30}, 6400),
    (0, {"eval/restored_step": 4.0}, None),
]


def _scalars(logdir):
    acc = EventAccumulator(str(logdir), size_guidance={"scalars": 0})
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def _log_all(logger, as_value):
    for step, values, frames in CALLS:
        logger.log(step, {k: as_value(v) for k, v in values.items()},
                   frames=frames)
    logger.flush()
    logger.close()


def test_scalars_match_the_jax_logger(tmp_path):
    _log_all(JaxMetricsLogger(str(tmp_path / "jax"), console_every_secs=1e9),
             np.float32)
    _log_all(metrics.MetricsLogger(str(tmp_path / "torch"),
                                   console_every_secs=1e9),
             lambda v: torch.tensor(v, dtype=torch.float32))
    want, got = _scalars(tmp_path / "jax"), _scalars(tmp_path / "torch")
    assert sorted(got) == sorted(want)
    assert SPEED in got
    for tag in want:
        if tag == SPEED:
            assert [s for s, _ in got[tag]] == [s for s, _ in want[tag]]
        else:
            assert got[tag] == want[tag], tag
    assert got["losses/total"][2] == (5, float(np.float32(3.0e38)))


def test_event_file_name_and_first_record(tmp_path):
    writer = metrics.EventFileWriter(str(tmp_path))
    writer.close()
    (name,) = os.listdir(tmp_path)
    assert name.startswith("events.out.tfevents.")
    with open(tmp_path / name, "rb") as f:
        data = f.read()
    length = int.from_bytes(data[:8], "little")
    assert len(data) == 8 + 4 + length + 4
    assert b"brain.Event:2" in data[12:12 + length]


def test_two_loggers_on_one_logdir_keep_both_files(tmp_path):
    """A resumed run logs into the logdir of the run it resumes."""
    for step in (1, 2):
        logger = metrics.MetricsLogger(str(tmp_path), console_every_secs=1e9)
        logger.log(step, {"x": float(step)})
        logger.close()
    assert len(os.listdir(tmp_path)) == 2
    assert _scalars(tmp_path)["x"] == [(1, 1.0), (2, 2.0)]


def test_no_logdir_writes_nothing_and_prints_progress(tmp_path, capsys):
    logger = metrics.MetricsLogger(console_every_secs=0)
    logger.log(3, {"a": torch.tensor(2.0)}, frames=30)
    logger.close()
    assert "[seed_rl_torch] step=3 frames=30 a=2" in capsys.readouterr().out


@pytest.mark.parametrize("data,want", [
    (b"", 0x00000000),
    (b"123456789", 0xE3069283),
    (bytes(32), 0x8A9136AA),  # RFC 3720, B.4
    (b"\xff" * 32, 0x62A8AB43),
    (bytes(range(32)), 0x46DD794E),
])
def test_crc32c_check_values(data, want):
    assert metrics.crc32c(data) == want
