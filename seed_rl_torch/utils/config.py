"""Learner-config validation and the learner-to-actor config push.

Port of ``seed_rl_tpu/utils/config.py`` (the reference's common/utils.py):
- ``validate_learner_config`` (:989-1002): checks the env counts and
  auto-tunes the inference batch size to ``max(env_batch_size, num_envs //
  (2 * num_hosts))``: small enough that two full batches are in flight per
  host, large enough to amortize a dispatch;
- ``serialize_config`` / ``apply_config`` (:1074-1110): the learner is the
  source of configuration truth; actors fetch its non-default settings at
  (re)connect and adopt them (the reference's ``update_config``, called at
  actor.py:75). The payload is a plain dict of the dataclass fields that
  differ from their defaults.

Where the JAX package asserts, these raise ``ValueError``: the values come
from a command line or over a socket.
"""

import dataclasses
from typing import Any, Dict, Optional


def validate_learner_config(
    num_envs: int,
    env_batch_size: int,
    inference_batch_size: Optional[int] = None,
    num_hosts: int = 1,
) -> int:
    """Validates sizes; returns the (possibly auto-tuned) inference batch.

    ``inference_batch_size`` of -1 or None selects ``max(env_batch_size,
    num_envs // (2 * num_hosts))``; the batch must be an exact multiple of
    the actor-side env batch (so actor batches pack evenly) and at most
    the per-host env count.
    """
    if num_envs <= 0 or env_batch_size <= 0:
        raise ValueError("num_envs and env_batch_size must be positive")
    if inference_batch_size is None or inference_batch_size == -1:
        inference_batch_size = max(env_batch_size,
                                   num_envs // (2 * num_hosts))
    if inference_batch_size <= 0:
        raise ValueError("the inference batch size must be positive")
    if inference_batch_size % env_batch_size:
        raise ValueError(
            f"Learner-side batch size (={inference_batch_size}) must be exact "
            f"multiple of the actor-side batch size (={env_batch_size}).")
    if num_envs < inference_batch_size * num_hosts:
        raise ValueError(
            "Inference batch size is bigger than the number of environments.")
    return inference_batch_size


def serialize_config(config: Any) -> Dict[str, Any]:
    """The fields of a dataclass config that differ from their defaults."""
    if not dataclasses.is_dataclass(config):
        raise TypeError(f"not a dataclass: {config!r}")
    out = {}
    for field in dataclasses.fields(config):
        value = getattr(config, field.name)
        default = (field.default_factory()
                   if field.default_factory is not dataclasses.MISSING
                   else field.default)
        if value != default:
            out[field.name] = value
    return out


def apply_config(config: Any, overrides: Dict[str, Any]) -> Any:
    """``config`` with the pushed overrides applied (the actor-side
    ``update_config``)."""
    if not dataclasses.is_dataclass(config):
        raise TypeError(f"not a dataclass: {config!r}")
    unknown = set(overrides) - {f.name for f in dataclasses.fields(config)}
    if unknown:
        raise ValueError(f"unknown config keys pushed: {sorted(unknown)}")
    return dataclasses.replace(config, **overrides)
