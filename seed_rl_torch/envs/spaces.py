"""The port's own action-space description (no gymnasium needed).

``Box``, ``Discrete`` and ``MultiDiscrete``, for the tensor envs and the
host-env wrappers (``envs/host.py``). Code that reads spaces
(``distributions.get_parametric_distribution_for_action_space``,
``rollout.zero_action_for_space``) duck-types on ``n``, ``nvec``,
``spaces`` and ``low``/``high``, so gymnasium spaces work there too.
"""

from typing import Optional, Sequence, Tuple

import numpy as np


class Box:
    """A bounded real array space, like ``gymnasium.spaces.Box``: ``low``
    and ``high`` are scalars broadcast to ``shape``, or arrays that give
    the shape."""

    def __init__(self, low, high, shape: Optional[Tuple[int, ...]] = None,
                 dtype=np.float32):
        if shape is None:
            shape = np.shape(low)
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.low = np.broadcast_to(np.asarray(low, dtype), self.shape).copy()
        self.high = np.broadcast_to(np.asarray(high, dtype),
                                    self.shape).copy()

    def __repr__(self):
        return f"Box({self.low.min()}, {self.high.max()}, {self.shape})"


class Discrete:
    """The actions ``0 .. n-1``, like ``gymnasium.spaces.Discrete``."""

    def __init__(self, n: int):
        self.n = int(n)

    def __repr__(self):
        return f"Discrete({self.n})"


class MultiDiscrete:
    """One discrete choice per dimension, ``0 .. nvec[i]-1``, like
    ``gymnasium.spaces.MultiDiscrete``."""

    def __init__(self, nvec: Sequence[int]):
        self.nvec = np.asarray(nvec, np.int64)
        self.shape = self.nvec.shape

    def __repr__(self):
        return f"MultiDiscrete({self.nvec.tolist()})"
