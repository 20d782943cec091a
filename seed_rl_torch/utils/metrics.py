"""Metrics logging: TensorBoard scalars and console progress, with the
env-frames/s throughput metric.

Port of ``seed_rl_tpu/utils/metrics.py``. Train steps return a flat
``{name: scalar tensor}`` dict; this turns it into floats on the host at
the logging cadence (each conversion waits for the device) and, with a
``logdir``, writes each as a TensorBoard scalar.

The JAX package writes its event file through ``tensorboardX``. This one
writes the same file with ``struct`` alone, so that it needs nothing
beyond torch and numpy: TFRecord framing (the length, the masked CRC32C of
the length, the payload, the masked CRC32C of the payload) around
hand-encoded ``Event`` protos, a first one holding ``file_version:
"brain.Event:2"`` and then one per scalar (``wall_time``, ``step``,
``summary.value {tag, simple_value}``), in ``events.out.tfevents.<time>.
<host>`` under ``logdir``.
"""

import os
import socket
import struct
import time
from typing import Dict, Optional


def _crc32c_table():
    table = []
    for byte in range(256):
        crc = byte
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
        table.append(crc)
    return table


_CRC32C_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as TFRecord frames use it."""
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC32C_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> bytes:
    crc = crc32c(data)
    masked = (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF
    return struct.pack("<I", masked)


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # int64 on the wire, two's complement
    out = bytearray()
    while True:
        low, n = n & 0x7F, n >> 7
        out.append(low | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _bytes_field(number: int, payload: bytes) -> bytes:
    """A length-delimited proto field (wire type 2)."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int, field: bytes) -> bytes:
    """An ``Event``: wall_time (1, double), step (2, int64) and one more
    field, already encoded."""
    return (b"\x09" + struct.pack("<d", wall_time) + b"\x10" + _varint(step)
            + field)


def _scalar_event(wall_time: float, step: int, tag: str,
                  value: float) -> bytes:
    """An ``Event`` whose summary (5) holds one value (1): tag (1) and
    simple_value (2, float)."""
    value_proto = (_bytes_field(1, tag.encode("utf-8")) + b"\x15"
                   + struct.pack("<f", value))
    return _event(wall_time, step, _bytes_field(5, _bytes_field(1,
                                                                value_proto)))


class EventFileWriter:
    """Appends TensorBoard scalar events to a new file under ``logdir``."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        base = os.path.join(logdir, "events.out.tfevents."
                            f"{int(time.time()):010d}.{socket.gethostname()}")
        path, n = base, 0
        while os.path.exists(path):  # another writer this second
            n += 1
            path = f"{base}.{n}"
        self._file = open(path, "wb")
        self._write(_event(time.time(), 0, _bytes_field(3, b"brain.Event:2")))

    def _write(self, event: bytes):
        header = struct.pack("<Q", len(event))
        self._file.write(header + _masked_crc(header) + event
                         + _masked_crc(event))

    def add_scalar(self, tag: str, value: float, step: int):
        self._write(_scalar_event(time.time(), step, tag, value))

    def flush(self):
        self._file.flush()

    def close(self):
        self._file.close()


class MetricsLogger:
    def __init__(self, logdir: Optional[str] = None,
                 console_every_secs: float = 30.0):
        self._writer = EventFileWriter(logdir) if logdir else None
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

        if self._writer is not None:
            for key, value in metrics.items():
                self._writer.add_scalar(key, value, step)

        now = time.time()
        if now - self._last_console >= self._console_every:
            self._last_console = now
            parts = [f"step={step}"]
            if frames is not None:
                parts.append(f"frames={frames}")
            for key in sorted(metrics):
                parts.append(f"{key}={metrics[key]:.4g}")
            print("[seed_rl_torch] " + " ".join(parts), flush=True)

    def flush(self):
        if self._writer is not None:
            self._writer.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()
