"""The numbers that decide ``correct``: gaps between the program's readings
and the reference's.

- ``tensor_gap``: max |program - reference| / max |reference|, the widest
  gap of a tensor against the reference's scale;
- ``scalar_gap``: |program - reference| / |reference|;
- ``leaf_norm_gap``: by the worst leaf, |‖program‖ - ‖reference‖| over the
  larger of the reference's norm of that leaf and of the median leaf (the
  gap of the norms, not the norm of the difference);
- ``cosine_gap``: 1 - the cosine between two gradients, all leaves
  together: what the norms cannot see, the gradient's direction;
- ``moving_leaves``: the leaves whose reference gradient is at least a
  thousandth of the median leaf's; the others move under Adam by round-off
  alone and are left out of the change.
"""

import statistics
from typing import Dict, Iterable, Optional

import torch


def tensor_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    program = program.to(torch.float64)
    reference = reference.to(program.device, torch.float64)
    scale = float(reference.abs().max())
    if scale == 0.0:
        scale = 1.0
    return float((program - reference).abs().max()) / scale


def scalar_gap(program: float, reference: float) -> float:
    return abs(program - reference) / max(abs(reference), 1e-30)


def leaf_norm_gap(program: Dict[str, float], reference: Dict[str, float],
                  leaves: Optional[Iterable[str]] = None) -> float:
    names = list(reference if leaves is None else leaves)
    median = statistics.median(reference[n] for n in reference)
    return max((abs(program[n] - reference[n]) / max(reference[n], median,
                                                     1e-30)
                for n in names), default=0.0)


def cosine_gap(program: Dict[str, torch.Tensor],
               reference: Dict[str, torch.Tensor]) -> float:
    """1 - the cosine between two gradients, every leaf together."""
    dot = p_sq = r_sq = 0.0
    for name, r in reference.items():
        r = r.detach().double().cpu().flatten()
        p = program[name].detach().double().cpu().flatten()
        dot += float(p @ r)
        p_sq += float(p @ p)
        r_sq += float(r @ r)
    return 1.0 - dot / max((p_sq * r_sq) ** 0.5, 1e-300)


def moving_leaves(grad_norms: Dict[str, float]):
    median = statistics.median(grad_norms.values())
    return [n for n, g in grad_norms.items() if g >= 1e-3 * median]
