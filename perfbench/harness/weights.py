"""Weights made on the device from the run's seed.

One ``torch.Generator`` on the device, seeded with the run's seed, draws
one standard normal tensor for every weight at once; each weight takes its
slice scaled to ``1 / sqrt(fan_in)`` (fan-in: every axis but the first).
Biases (1-D leaves) start at zero, as flax's initializers leave them. The
parameters stay float32, the type the program keeps and serves them in
(its layers cast them at use).

The shapes are the reference's (``reference/<name>.py::parameter_shapes``);
``load`` copies the draws into the program's modules by name and refuses a
program whose parameters differ in name or shape.
"""

import math
from typing import Dict, Tuple

import torch


def draw(shapes: Dict[str, Tuple[int, ...]], seed: int,
         device: torch.device) -> Dict[str, torch.Tensor]:
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    total = sum(math.prod(s) for s in shapes.values() if len(s) > 1)
    flat = torch.randn(total, generator=generator, device=device)
    out, offset = {}, 0
    for name, shape in shapes.items():
        if len(shape) == 1:
            out[name] = torch.zeros(shape, device=device)
            continue
        n = math.prod(shape)
        fan_in = n // shape[0]
        out[name] = (flat[offset:offset + n] / math.sqrt(fan_in)).view(shape)
        offset += n
    return out


@torch.no_grad()
def load(module: torch.nn.Module, params: Dict[str, torch.Tensor]):
    """Copies ``params`` into ``module``'s parameters of the same names."""
    own = dict(module.named_parameters())
    if own.keys() != params.keys():
        raise ValueError(
            f"the program's parameters {sorted(own)} are not the "
            f"reference's {sorted(params)}")
    for name, value in params.items():
        if own[name].shape != value.shape:
            raise ValueError(f"{name}: the program's shape "
                             f"{tuple(own[name].shape)}, the reference's "
                             f"{tuple(value.shape)}")
        own[name].copy_(value)
