"""Random draws by global index, so that a shard sees its slice of the
one-rank draw.

A rank that holds envs ``[lo, hi)`` of ``B`` must act, reset and explore
exactly as those envs do in a one-rank run. The rule here is the simplest
exact one: every rank draws at the global shape from an identically seeded
generator and keeps its own part. ``ShardedGenerator`` carries that part
(the axis, the global size and a slice or an index tensor) beside the
generator, and ``rand`` / ``randn`` / ``randint`` take either kind of
generator: a plain ``torch.Generator`` (or None) draws as ``torch.rand``
does. The generators advance by the global draw on every rank, so they stay
equal across ranks.
"""

from typing import Optional, Union

import torch


class ShardedGenerator:
    """``generator`` with the part of a global draw that this rank keeps.

    Args:
      generator: the rank's generator, seeded as on every other rank.
      total: the global size of the sharded axis.
      keep: this rank's part of that axis, a slice or an index tensor.
      axis: the sharded axis of a draw (0 for ``[B, ...]`` rollout draws,
        1 for a loss's ``[T, B, ...]`` noise).
    """

    def __init__(self, generator: torch.Generator, total: int,
                 keep: Union[slice, torch.Tensor], axis: int = 0):
        self.generator = generator
        self.total = total
        self.keep = keep
        self.axis = axis

    @property
    def device(self) -> torch.device:
        return self.generator.device

    def kept(self) -> int:
        if isinstance(self.keep, slice):
            return len(range(*self.keep.indices(self.total)))
        return int(self.keep.numel())

    def draw(self, fn, shape, **kwargs) -> torch.Tensor:
        """``fn(global_shape, generator=..., **kwargs)``, this rank's part."""
        shape = tuple(shape)
        if shape[self.axis] != self.kept():
            raise ValueError(f"a draw of {shape} holds {shape[self.axis]} "
                             f"on axis {self.axis}; this rank keeps "
                             f"{self.kept()} of {self.total}")
        full = list(shape)
        full[self.axis] = self.total
        out = fn(tuple(full), generator=self.generator, **kwargs)
        if isinstance(self.keep, slice):
            start, stop, _ = self.keep.indices(self.total)
            return out.narrow(self.axis, start, stop - start)
        return out.index_select(self.axis, self.keep.to(out.device))


def _draw(fn, shape, generator, **kwargs):
    if isinstance(generator, ShardedGenerator):
        return generator.draw(fn, shape, **kwargs)
    return fn(tuple(shape), generator=generator, **kwargs)


def rand(shape, generator: Optional[Union[torch.Generator,
                                          ShardedGenerator]], **kwargs):
    """``torch.rand`` of ``shape``, or this rank's part of the global draw."""
    return _draw(torch.rand, shape, generator, **kwargs)


def randn(shape, generator, **kwargs):
    """``torch.randn`` of ``shape``, or this rank's part of the global
    draw."""
    return _draw(torch.randn, shape, generator, **kwargs)


def randint(low: int, high: int, shape, generator, **kwargs):
    """``torch.randint`` of ``shape``, or this rank's part of the global
    draw."""
    return _draw(lambda s, **kw: torch.randint(low, high, s, **kw), shape,
                 generator, **kwargs)
