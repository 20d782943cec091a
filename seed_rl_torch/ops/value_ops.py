"""R2D2 value-function ops: rescaling, n-step Bellman targets, priorities.

Port of ``seed_rl_tpu/ops/value_ops.py``, in plain PyTorch with the same
arithmetic in the same order, so float32 results agree with the JAX package
to rounding:
- ``value_function_rescaling`` h and its inverse;
- ``n_step_bellman_target`` over a ``T+n`` padded window, the last n-1
  targets falling back to shorter returns that reuse the final Q_target;
- ``retrace_target`` (a reverse loop over time) and
  ``retrace_loss_and_priorities``;
- ``td_loss_and_priorities``: the sequence double-DQN loss and the
  priorities eta*max|TD| + (1-eta)*mean|TD|.

``td_loss_and_priorities`` is the plain version of the n-step kernel
(``ops/cuda/nstep_kernel.py``): the CPU path takes it, and ``chip_smoke.py``
holds the kernel against it on the card. Targets and priorities are
stop-gradient; the loss is differentiable in ``q_values``.
"""

from typing import Tuple

import torch


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt, on every device.

    PyTorch's vectorised CPU sqrt is off by one ulp for ~1% of inputs, and
    h^-1 squares a difference that cancels to ~1e-3 of its operands, so one
    ulp there moves a target by ~1e-4. A float64 sqrt rounded to float32 is
    the IEEE result, which XLA, the CUDA kernel and the card's sqrt give.
    """
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded once: on the card PyTorch turns a division by a
    Python scalar into a multiplication by its rounded reciprocal."""
    return x / x.new_tensor(c)


def value_function_rescaling(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """h(x) = sign(x)*(sqrt(|x|+1)-1) + eps*x."""
    return torch.sign(x) * (_sqrt(torch.abs(x) + 1.0) - 1.0) + eps * x


def inverse_value_function_rescaling(
    x: torch.Tensor, eps: float = 1e-3
) -> torch.Tensor:
    """h^{-1}(x); exact inverse of ``value_function_rescaling``."""
    return torch.sign(x) * (
        torch.square(
            _div(_sqrt(1.0 + 4.0 * eps * (torch.abs(x) + 1.0 + eps)) - 1.0,
                 2.0 * eps)
        )
        - 1.0
    )


def gather_actions(values: torch.Tensor, actions: torch.Tensor):
    """``values[t, b, actions[t, b]]`` for [T, B, A] values."""
    return torch.gather(values, 2, actions.long().unsqueeze(-1)).squeeze(-1)


def n_step_bellman_target(
    rewards: torch.Tensor,
    done: torch.Tensor,
    q_target: torch.Tensor,
    gamma: float,
    n_steps: int,
) -> torch.Tensor:
    """n-step Bellman targets over a [T, B] sequence.

    For n_steps=1: ``r_t + gamma * (1-done_t) * Q_target(s_{t+1}, a*)``. In
    general a sum of up-to-n discounted rewards plus the bootstrapped
    Q_target, with the product-of-not-done masking; the last n-1 targets use
    shorter returns reusing the final q_target (divided by gamma^k so the
    discounting in the recursion cancels).

    Args:
      rewards: f32[T, B].
      done: bool[T, B]; true if the episode ended just after reward r_t.
      q_target: f32[T, B] = Q_target(s_{t+1}, a*).
      gamma: discount.
      n_steps: lookahead.

    Returns:
      f32[T, B] targets.
    """
    rewards = rewards.to(torch.float32)
    q_target = q_target.to(torch.float32)
    zero_row = torch.zeros_like(rewards[0:1])
    bellman_target = torch.cat(
        [torch.zeros_like(q_target[0:1]), q_target]
        + [_div(q_target[-1:], gamma**k) for k in range(1, n_steps)],
        dim=0,
    )
    done_f = torch.cat([done.to(torch.float32)] + [zero_row] * n_steps, dim=0)
    rewards = torch.cat([rewards] + [zero_row] * n_steps, dim=0)
    for _ in range(n_steps):
        rewards = rewards[:-1]
        done_f = done_f[:-1]
        bellman_target = rewards + gamma * (1.0 - done_f) * bellman_target[1:]
    return bellman_target


def retrace_target(
    rewards: torch.Tensor,
    done: torch.Tensor,
    q_target_max: torch.Tensor,
    q_target_replay: torch.Tensor,
    trace_coefficients: torch.Tensor,
    gamma: float,
) -> torch.Tensor:
    """Retrace(lambda) targets over a [T, B] sequence (unrescaled space).

    Backward recursion with the n-step targets' post-transition indexing:

      G[t] = r[t] + gamma*(1-d[t]) * ( M[t] + c[t]*(G[t+1] - Q[t]) )

    seeded with G[T] := Q[T-1]; see the JAX package's docstring for the
    derivation (greedy target policy, c-bar = 1 clip).

    Args:
      rewards: f32[T, B].
      done: bool[T, B].
      q_target_max: f32[T, B] — h^{-1}(Q_target(o_t, argmax_a Q_online)).
      q_target_replay: f32[T, B] — h^{-1}(Q_target(o_t, a_t)).
      trace_coefficients: f32[T, B] — c_t in [0, lambda].
      gamma: discount.

    Returns:
      f32[T, B]; the target for Q(o_t, a_t) is G[t+1].
    """
    rewards = rewards.to(torch.float32)
    not_done = 1.0 - done.to(torch.float32)
    trace = trace_coefficients.to(torch.float32)
    g = q_target_replay[-1]
    targets = [None] * rewards.shape[0]
    for t in range(rewards.shape[0] - 1, -1, -1):
        g = rewards[t] + gamma * not_done[t] * (
            q_target_max[t] + trace[t] * (g - q_target_replay[t])
        )
        targets[t] = g
    return torch.stack(targets)


def _loss_and_priorities(targets, replay_q, eta):
    abs_td_errors = torch.abs(targets - replay_q)
    priorities = eta * torch.amax(abs_td_errors, dim=0) + (
        1.0 - eta
    ) * torch.mean(abs_td_errors, dim=0)
    loss = 0.5 * torch.sum(torch.square(abs_td_errors), dim=0)
    return loss, priorities.detach()


def retrace_loss_and_priorities(
    q_values: torch.Tensor,
    target_q_values: torch.Tensor,
    online_argmax_action: torch.Tensor,
    replay_action: torch.Tensor,
    rewards: torch.Tensor,
    done: torch.Tensor,
    gamma: float,
    lambda_: float = 0.95,
    eta: float = 0.9,
    rescaling_eps: float = 1e-3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequence double-DQN loss with Retrace(lambda) targets (R2D2 shapes).

    ``td_loss_and_priorities``'s signature plus ``lambda_``: the targets are
    the clipped-trace Retrace recursion on h-rescaled values; priorities use
    the same eta*max+mean formula.
    """
    replay_q = gather_actions(q_values, replay_action)
    with torch.no_grad():
        q_target_max = inverse_value_function_rescaling(
            gather_actions(target_q_values, online_argmax_action),
            rescaling_eps,
        )
        q_target_replay = inverse_value_function_rescaling(
            gather_actions(target_q_values, replay_action), rescaling_eps
        )
        trace = lambda_ * (replay_action == online_argmax_action).to(
            torch.float32
        )
        targets = retrace_target(
            rewards, done, q_target_max, q_target_replay, trace, gamma
        )
        targets = value_function_rescaling(targets[1:], rescaling_eps)
    return _loss_and_priorities(targets, replay_q[:-1], eta)


def td_loss_and_priorities(
    q_values: torch.Tensor,
    target_q_values: torch.Tensor,
    online_argmax_action: torch.Tensor,
    replay_action: torch.Tensor,
    rewards: torch.Tensor,
    done: torch.Tensor,
    gamma: float,
    n_steps: int,
    eta: float = 0.9,
    rescaling_eps: float = 1e-3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequence double-DQN loss + replay priorities (R2D2).

    Args:
      q_values: f32[T, B, A] online-network Q values (trained).
      target_q_values: f32[T, B, A] target-network Q values.
      online_argmax_action: int[T, B] argmax_a Q_online(s, a) (double DQN).
      replay_action: int[T, B] action actually played.
      rewards: f32[T, B].
      done: bool[T, B].
      gamma: discount.
      n_steps: Bellman lookahead.
      eta: max/mean mixing for priorities.
      rescaling_eps: epsilon of the value rescaling.

    Returns:
      (loss f32[B] — 0.5 * sum_t TD^2, priorities f32[B]).
    """
    replay_q = gather_actions(q_values, replay_action)
    with torch.no_grad():
        qtarget_max = inverse_value_function_rescaling(
            gather_actions(target_q_values, online_argmax_action),
            rescaling_eps,
        )
        bellman_target = n_step_bellman_target(
            rewards, done, qtarget_max, gamma, n_steps
        )
        # replay_q[t] is Q(s_{t+1}, a_{t+1}) in env-step indexing (the
        # unroll stores post-transition observations): shift targets by one.
        bellman_target = value_function_rescaling(
            bellman_target[1:], rescaling_eps
        )
    return _loss_and_priorities(bellman_target, replay_q[:-1], eta)
