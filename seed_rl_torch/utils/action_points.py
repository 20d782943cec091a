"""Frame-count action points and in-memory learner snapshots.

Port of ``seed_rl_tpu/utils/action_points.py``:
- ``ActionPointSchedule``: named actions at ``linspace(0, total_frames,
  n + 1)[1:]`` frame marks, so the last lands on the last frame; each
  fires once per mark, the first time the frame count reaches it (a call
  that jumps several marks fires it once for each).
- ``LearnerState`` snapshots: CPU copies of what a warm start needs (the
  net and loss-owned parameters, the input statistics, the PopArt state,
  the optimizer and the step), taken and given back through the learner's
  ``checkpoint_state`` / ``load_checkpoint_state`` without touching disk.
"""

from typing import Any, Dict, List, NamedTuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from seed_rl_torch.utils.checkpoint import load_into, to_saveable


class ActionPointSchedule:
    """Fires named actions at linspace frame marks, each exactly once."""

    def __init__(self, total_frames: int, counts: Dict[str, int]):
        self._marks: Dict[str, np.ndarray] = {}
        self._next: Dict[str, int] = {}
        for name, n in counts.items():
            if n > 0:
                self._marks[name] = np.linspace(0, total_frames, n + 1)[1:]
                self._next[name] = 0

    def due(self, frames: int) -> List[str]:
        """Actions whose next mark is <= ``frames`` (consumes the marks),
        one entry per mark crossed."""
        fired = []
        for name, marks in self._marks.items():
            i = self._next[name]
            while i < len(marks) and frames >= marks[i]:
                fired.append(name)
                i += 1
            self._next[name] = i
        return fired


class LearnerState(NamedTuple):
    """A CPU snapshot of a PPO learner's training variables, in the
    layout a checkpoint stores them."""

    params: Any
    obs_norm: Any
    norm_state: Any
    opt_state: Any
    step: int
    frames: int


def snapshot_ppo_state(learner, state, frames: int) -> LearnerState:
    """Copies the training variables of ``learner`` at ``state`` to the
    CPU."""
    tree = learner.checkpoint_state(state)
    return LearnerState(
        *(to_saveable(tree[f]) for f in LearnerState._fields[:-2]),
        step=state.step, frames=frames)


def restore_ppo_state(learner, state, snapshot: LearnerState):
    """Warm-starts ``learner`` from ``snapshot``; returns ``state`` with the
    snapshot's step and its own rollout and episode statistics, as a warm
    start from a checkpoint does."""
    saved = pytree.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
        snapshot._asdict())
    del saved["frames"]
    return load_into(learner, state, saved, fields=tuple(saved))
