"""Streaming observation normalization (V-trace and SAC).

Port of ``seed_rl_tpu/ops/normalizer.py``: element-wise mean/std tracked
through sum / sum-of-squares / count accumulators; normalization is
``clip((x - mean) / (std + eps), clip_range)`` with the statistics outside
the gradient. ``agent.py::NormalizingObservationsAgent`` and
``agents/sac.py::SACAgent`` apply it to ``env_output.observation`` before
the network sees it, and the learners fold the statistics once per
training step. A dict observation is concatenated along its last axis in
sorted key order, as ``jax.tree.leaves`` orders it.

The JAX package's ``axis_name`` (increments summed over a mesh axis) is
``parallel.collectives``: under a mesh the count and sums of every rank's
batch are added, so the statistics stay replicated.
"""

from typing import NamedTuple, Tuple

import torch
import torch.utils._pytree as pytree

from seed_rl_torch.parallel import collectives
from seed_rl_torch.utils import tree


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
    steps = state.steps + float(collectives.count(flat, 0))
    total = state.sum + collectives.sum(flat, dim=0)
    totalsq = state.sumsq + collectives.sum(torch.square(flat), dim=0)
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
    """The leaves concatenated in ``jax.tree.leaves`` order (dict keys
    sorted), their widths, and the spec of the sorted tree."""
    leaves, spec = pytree.tree_flatten(tree.sorted_dicts(observation))
    widths = [leaf.shape[-1] for leaf in leaves]
    concat = torch.cat([leaf.to(torch.float32) for leaf in leaves], dim=-1)
    return concat, widths, spec


def observation_width(spec) -> int:
    """The statistics' size for observations of ``spec`` (a ``TensorSpec``
    or a dict of them): the sum of the leaves' last dimensions, every other
    axis being folded into the batch."""
    if isinstance(spec, dict):
        return sum(observation_width(s) for s in spec.values())
    return int(spec.shape[-1])


def normalize_observation(state: NormalizerState, observation, eps=0.001,
                          clip_range=(-5.0, 5.0)):
    """Normalizes a (possibly dict) observation leaf-wise along one concat:
    the statistics are tracked over the concatenation of all leaves, in
    sorted key order; the result keeps the caller's layout."""
    concat, widths, spec = _concat(observation)
    normalized = normalize(state, concat, eps, clip_range)
    return tree.in_layout_of(pytree.tree_unflatten(
        list(torch.split(normalized, widths, dim=-1)), spec), observation)


def update_from_observation(state: NormalizerState,
                            observation) -> NormalizerState:
    return update(state, _concat(observation)[0])
