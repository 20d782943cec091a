"""Opt-in contract checks for the on-device paths (``--debug_asserts``).

Port of ``seed_rl_tpu/utils/debug_asserts.py``. The JAX package compiles
its checks out of the jitted step unless enabled and then surfaces them
through ``checkify``. PyTorch runs eagerly, so here a check is a plain
call:

- ``check(cond, msg)``: ``cond`` is a zero-argument callable returning a
  bool or a one-element tensor. Disabled (the default), nothing is
  evaluated, so the main path pays no computation and no host sync.
  Enabled, ``cond()`` is evaluated at once, which waits for the device,
  and a false result raises ``AssertionError(msg)``.
- ``enable(on)``: turns the checks on or off for the process.

Contract points live in ``replay.py`` (insert-priority validity, ring
bounds, sampling from a non-empty buffer).
"""

from typing import Callable

_ENABLED = False


def enable(on: bool = True) -> None:
    """Globally enable (or disable) the contract checks."""
    global _ENABLED
    _ENABLED = bool(on)


def enabled() -> bool:
    return _ENABLED


def check(cond: Callable[[], object], msg: str) -> None:
    """Contract point: evaluates ``cond()`` and raises only when enabled."""
    if _ENABLED and not bool(cond()):
        raise AssertionError(msg)
