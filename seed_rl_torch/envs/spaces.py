"""The port's own action-space description (no gymnasium needed).

Only what the port's tensor envs need: ``Box`` and ``Discrete``. Code
that reads spaces (``distributions.get_parametric_distribution_for_action_space``,
``rollout.zero_action_for_space``) duck-types on ``n``, ``nvec``,
``spaces`` and ``low``/``high``, so gymnasium spaces work there too.
"""

from typing import Tuple

import numpy as np


class Box:
    """A bounded real vector space, like ``gymnasium.spaces.Box``."""

    def __init__(self, low: float, high: float, shape: Tuple[int, ...]):
        self.shape = tuple(int(s) for s in shape)
        self.low = np.full(self.shape, low, np.float32)
        self.high = np.full(self.shape, high, np.float32)

    def __repr__(self):
        return f"Box({self.low.min()}, {self.high.max()}, {self.shape})"


class Discrete:
    """The actions ``0 .. n-1``, like ``gymnasium.spaces.Discrete``."""

    def __init__(self, n: int):
        self.n = int(n)

    def __repr__(self):
        return f"Discrete({self.n})"
