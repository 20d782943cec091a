"""Advantage estimators of the generalized on-policy loss.

Port of ``seed_rl_tpu/ops/advantages.py``:
- ``vtrace``: V-trace with explicit terminated / abandoned handling.
  Termination zeroes the next-step bootstrap; abandonment zeroes the
  temporal difference (the advantage is zero and the target is the current
  value); neither propagates future TDs across an episode's end.
- ``gae``: V-trace with zero log-ratios (unit importance weights).
- ``n_step``: n-step returns; the last n-1 steps are padded with
  ``done_abandoned = True``, which falls back to shorter returns.

Pure functions over time-major ``[T(+1), B]`` tensors; their outputs are
outside the autograd graph. The backward recursion is a loop over T on the
device. This is the plain PyTorch version: the JAX package computes it with
``lax.scan``, not with its Pallas V-trace kernel.
"""

import math
from typing import Optional, Tuple

import torch


@torch.no_grad()
def vtrace(
    values: torch.Tensor,
    rewards: torch.Tensor,
    done_terminated: torch.Tensor,
    done_abandoned: torch.Tensor,
    discount_factor: float,
    target_action_log_probs: torch.Tensor,
    behaviour_action_log_probs: torch.Tensor,
    lambda_: float = 1.0,
    max_importance_weight: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """V-trace value targets and advantages (abandoned-episode aware).

    Args:
      values: f32[T+1, B] value estimates for steps i..i+T.
      rewards: f32[T, B] rewards after the actions at steps i..i+T-1.
      done_terminated: bool[T, B] the episode properly terminated there.
      done_abandoned: bool[T, B] the episode was abandoned (time limit).
      discount_factor: scalar discount.
      target_action_log_probs, behaviour_action_log_probs: f32[T, B].
      lambda_: 1-step (0) ... n-step (1) mixing.
      max_importance_weight: importance weights are clipped to this value.

    Returns:
      (targets f32[T, B], advantages f32[T, B]).
    """
    values = values.to(torch.float32)
    rewards = rewards.to(torch.float32)
    log_rhos = torch.clamp(
        target_action_log_probs - behaviour_action_log_probs,
        max=math.log(max_importance_weight))
    rhos = torch.exp(log_rhos)
    not_terminated = (~done_terminated).to(torch.float32)
    not_abandoned = (~done_abandoned).to(torch.float32)

    deltas = (rewards + discount_factor * (not_terminated * values[1:])
              - values[:-1]) * not_abandoned
    propagate = not_terminated * not_abandoned

    acc = torch.zeros_like(values[0])
    advantages = []
    for t in reversed(range(rewards.shape[0])):
        advantage = deltas[t] + propagate[t] * discount_factor * lambda_ * acc
        acc = rhos[t] * advantage
        advantages.append(advantage)
    advantages = torch.stack(advantages[::-1])
    targets = values[:-1] + rhos * advantages
    return targets, advantages


def gae(
    values: torch.Tensor,
    rewards: torch.Tensor,
    done_terminated: torch.Tensor,
    done_abandoned: torch.Tensor,
    discount_factor: float,
    target_action_log_probs: Optional[torch.Tensor] = None,
    behaviour_action_log_probs: Optional[torch.Tensor] = None,
    lambda_: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalized Advantage Estimator: V-trace with unit importance
    weights."""
    del target_action_log_probs, behaviour_action_log_probs
    zeros = torch.zeros_like(rewards, dtype=torch.float32)
    return vtrace(values, rewards, done_terminated, done_abandoned,
                  discount_factor, zeros, zeros, lambda_=lambda_,
                  max_importance_weight=1.0)


@torch.no_grad()
def n_step(
    values: torch.Tensor,
    rewards: torch.Tensor,
    done_terminated: torch.Tensor,
    done_abandoned: torch.Tensor,
    discount_factor: float,
    n: int,
    target_action_log_probs: Optional[torch.Tensor] = None,
    behaviour_action_log_probs: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """N-step return targets with abandoned-aware padding: the last n-1
    steps are padded with abandon = True, which substitutes the current
    value, so they fall back to shorter returns."""
    del target_action_log_probs, behaviour_action_log_probs
    values = values.to(torch.float32)
    rewards = rewards.to(torch.float32)
    unroll_length, batch = rewards.shape
    eff_n = min(n, unroll_length)
    pad = eff_n - 1

    def padded(x, fill):
        return torch.cat([x, torch.full((pad, batch), fill, dtype=x.dtype,
                                        device=x.device)])

    nvalues = padded(values, 0.0)
    nterm = padded(done_terminated, False)
    naband = padded(done_abandoned, True)
    nrewards = padded(rewards, 0.0)

    future_value = nvalues[eff_n:]
    window = unroll_length
    for i in range(eff_n):
        start = eff_n - i - 1
        not_terminated = (~nterm[start:start + window]).to(torch.float32)
        not_abandoned = (~naband[start:start + window]).to(torch.float32)
        one_step = (nrewards[start:start + window]
                    + discount_factor * not_terminated * future_value)
        future_value = (not_abandoned * one_step + (1.0 - not_abandoned)
                        * nvalues[start:start + window])
    return future_value, future_value - values[:-1]


class GAE:
    """Estimator object of the generalized on-policy loss."""

    def __init__(self, lambda_: float):
        self.lambda_ = lambda_

    def __call__(self, values, rewards, done_terminated, done_abandoned,
                 discount_factor, target_action_log_probs,
                 behaviour_action_log_probs):
        return gae(values, rewards, done_terminated, done_abandoned,
                   discount_factor, lambda_=self.lambda_)


class VTrace:
    def __init__(self, lambda_: float, max_importance_weight: float = 1.0):
        self.lambda_ = lambda_
        self.max_importance_weight = max_importance_weight

    def __call__(self, values, rewards, done_terminated, done_abandoned,
                 discount_factor, target_action_log_probs,
                 behaviour_action_log_probs):
        return vtrace(values, rewards, done_terminated, done_abandoned,
                      discount_factor, target_action_log_probs,
                      behaviour_action_log_probs, lambda_=self.lambda_,
                      max_importance_weight=self.max_importance_weight)


class NStep:
    def __init__(self, n: int):
        self.n = n

    def __call__(self, values, rewards, done_terminated, done_abandoned,
                 discount_factor, target_action_log_probs,
                 behaviour_action_log_probs):
        return n_step(values, rewards, done_terminated, done_abandoned,
                      discount_factor, self.n)
