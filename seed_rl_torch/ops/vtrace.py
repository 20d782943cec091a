"""V-trace (IMPALA) targets as a plain reverse loop over time.

Port of ``seed_rl_tpu/ops/vtrace.py``: clipped importance weights rho/c, a
backward-in-time accumulation of temporal differences, and policy-gradient
advantages against the one-step-shifted v_s targets. The JAX package runs
the recursion as a reversed ``lax.scan``; here it is a Python loop.

This is the plain version of the hand-written CUDA kernel in
``seed_rl_torch/ops/cuda/vtrace_kernel.py``: the wrapper there takes it for
CPU tensors, and ``chip_smoke.py`` holds the kernel against it on the card.

See "IMPALA: Scalable Distributed Deep-RL with Importance Weighted
Actor-Learner Architectures", https://arxiv.org/abs/1802.01561.
"""

from typing import NamedTuple, Optional

import torch


class VTraceReturns(NamedTuple):
    vs: torch.Tensor
    pg_advantages: torch.Tensor


@torch.no_grad()
def from_importance_weights(
    target_action_log_probs: torch.Tensor,
    behaviour_action_log_probs: torch.Tensor,
    discounts: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
    clip_rho_threshold: Optional[float] = 1.0,
    clip_pg_rho_threshold: Optional[float] = 1.0,
    lambda_: float = 1.0,
) -> VTraceReturns:
    """V-trace from log importance weights.

    Args:
      target_action_log_probs: f32[T, B] log pi(a|x) under the target policy.
      behaviour_action_log_probs: f32[T, B] log mu(a|x) under the behaviour
        policy.
      discounts: f32[T, B] discounts encountered when following mu (0 on
        episode end).
      rewards: f32[T, B] rewards following the behaviour policy.
      values: f32[T, B] value estimates wrt. the target policy.
      bootstrap_value: f32[B] value estimate at time T.
      clip_rho_threshold: rho-bar in the paper; None disables clipping.
      clip_pg_rho_threshold: clip for the policy-gradient rho; None disables.
      lambda_: mix between 1-step (0) and n-step (1) bootstrapping.

    Returns:
      VTraceReturns(vs=f32[T, B], pg_advantages=f32[T, B]), both outside the
      autograd graph.
    """
    f32 = torch.float32
    target_action_log_probs = target_action_log_probs.to(f32)
    behaviour_action_log_probs = behaviour_action_log_probs.to(f32)
    discounts = discounts.to(f32)
    rewards = rewards.to(f32)
    values = values.to(f32)
    bootstrap_value = bootstrap_value.to(f32)

    rhos = torch.exp(target_action_log_probs - behaviour_action_log_probs)
    if clip_rho_threshold is not None:
        clipped_rhos = torch.clamp(rhos, max=clip_rho_threshold)
    else:
        clipped_rhos = rhos
    cs = lambda_ * torch.clamp(rhos, max=1.0)

    # values shifted by one: [v_1, ..., v_T, bootstrap].
    values_t_plus_1 = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = clipped_rhos * (rewards + discounts * values_t_plus_1 - values)

    vs_minus_v_xs = torch.empty_like(values)
    acc = torch.zeros_like(bootstrap_value)
    for t in reversed(range(values.shape[0])):
        acc = deltas[t] + discounts[t] * cs[t] * acc
        vs_minus_v_xs[t] = acc
    vs = vs_minus_v_xs + values

    vs_t_plus_1 = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    if clip_pg_rho_threshold is not None:
        clipped_pg_rhos = torch.clamp(rhos, max=clip_pg_rho_threshold)
    else:
        clipped_pg_rhos = rhos
    pg_advantages = clipped_pg_rhos * (
        rewards + discounts * vs_t_plus_1 - values
    )
    return VTraceReturns(vs=vs, pg_advantages=pg_advantages)
