"""Streaming observation normalization (V-trace style).

Port of ``seed_rl_tpu/ops/normalizer.py``: element-wise mean/std tracked
through sum / sum-of-squares / count accumulators; normalization is
``clip((x - mean) / (std + eps), clip_range)`` with the statistics outside
the gradient. ``agent.py::NormalizingObservationsAgent`` applies it to
``env_output.observation`` before the network sees it, and the learner
folds the statistics once per training step.

The JAX package's ``axis_name`` (increments summed over a mesh axis) waits
for scale-out; one device sees the whole batch.
"""

from typing import NamedTuple, Tuple

import torch
import torch.utils._pytree as pytree


class NormalizerState(NamedTuple):
    steps: torch.Tensor  # f32 scalar
    sum: torch.Tensor  # f32[size]
    sumsq: torch.Tensor  # f32[size]
    mean: torch.Tensor  # f32[size]
    std: torch.Tensor  # f32[size]


def init(size: int, device=None) -> NormalizerState:
    zeros = torch.zeros((size,), device=device)
    return NormalizerState(
        steps=torch.zeros((), device=device),
        sum=zeros, sumsq=zeros, mean=zeros, std=zeros,
    )


def update(state: NormalizerState, batch: torch.Tensor) -> NormalizerState:
    """Folds a batch (``[..., size]``) into the statistics."""
    flat = batch.to(torch.float32).reshape(-1, batch.shape[-1])
    steps = state.steps + float(flat.shape[0])
    total = state.sum + torch.sum(flat, dim=0)
    totalsq = state.sumsq + torch.sum(torch.square(flat), dim=0)
    mean = total / steps
    std = torch.sqrt(torch.clamp(totalsq / steps - torch.square(mean),
                                 min=0.0))
    return NormalizerState(
        steps=steps, sum=total, sumsq=totalsq, mean=mean, std=std)


def normalize(
    state: NormalizerState,
    x: torch.Tensor,
    eps: float = 0.001,
    clip_range: Tuple[float, float] = (-5.0, 5.0),
) -> torch.Tensor:
    """``clip((x - mean) / (std + eps))``, not differentiable in the
    statistics."""
    out = (x.to(torch.float32) - state.mean.detach()) / (
        state.std.detach() + eps)
    return torch.clamp(out, clip_range[0], clip_range[1])


def _concat(observation) -> Tuple[torch.Tensor, list, pytree.TreeSpec]:
    leaves, spec = pytree.tree_flatten(observation)
    widths = [leaf.shape[-1] for leaf in leaves]
    concat = torch.cat([leaf.to(torch.float32) for leaf in leaves], dim=-1)
    return concat, widths, spec


def normalize_observation(state: NormalizerState, observation, eps=0.001,
                          clip_range=(-5.0, 5.0)):
    """Normalizes a (possibly dict) observation leaf-wise along one concat:
    the statistics are tracked over the concatenation of all leaves."""
    concat, widths, spec = _concat(observation)
    normalized = normalize(state, concat, eps, clip_range)
    return pytree.tree_unflatten(
        list(torch.split(normalized, widths, dim=-1)), spec)


def update_from_observation(state: NormalizerState,
                            observation) -> NormalizerState:
    return update(state, _concat(observation)[0])
