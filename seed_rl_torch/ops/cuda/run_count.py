"""The hand kernels' runs, counted on the card: a wrapper calls ``add``
after each launch, on the launch's stream, so a CUDA graph that captured
a launch counts each replay as it runs. ``read`` is a host sync; ``reset``
zeroes in place, so a captured graph keeps adding to the same counter.
"""

from typing import Dict, Tuple

import torch

_counts: Dict[Tuple[str, torch.device], torch.Tensor] = {}


def add(kernel: str, device: torch.device) -> None:
    """1 more run of ``kernel`` on ``device``, counted on the current
    stream."""
    count = _counts.get((kernel, device))
    if count is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            # Made under a capture, the counter would be zeroed by each
            # replay.
            raise RuntimeError(
                f"the first launch of {kernel} on a device cannot be "
                f"captured: launch it eagerly first")
        count = _counts[kernel, device] = torch.zeros(
            (), dtype=torch.int64, device=device)
    count.add_(1)


def read(kernel: str) -> int:
    """``kernel``'s runs on every device since the last ``reset()``."""
    return sum(int(count.item()) for (name, _), count in _counts.items()
               if name == kernel)


def reset() -> None:
    """Every kernel's count on every device to 0."""
    for count in _counts.values():
        count.zero_()
