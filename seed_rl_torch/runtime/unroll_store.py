"""Host-side per-env unroll accumulation for external actors.

Port of ``seed_rl_tpu/runtime/unroll_store.py``, the reference's
``UnrollStore`` (common/utils.py:119-257) in numpy: a per-env ring of
``overlap + unroll_length + 1`` timesteps; ``append`` scatters one timestep
for a batch of env ids and returns the unrolls that completed; a completed
row keeps its last ``overlap + 1`` timesteps (the burn-in carry-over,
utils.py:240-256); ``reset`` zeroes the rows of restarted envs.

Leaves are taken in ``jax.tree`` order (``runtime/specs.py``: dict keys
sorted), so a dict observation built in any key order lands in the same
buffers as the JAX package's.
"""

from typing import Any, Tuple

import numpy as np

from seed_rl_torch.runtime import specs as specs_lib


class HostUnrollStore:
    def __init__(self, num_envs: int, unroll_length: int, timestep_specs,
                 num_overlapping_steps: int = 0):
        self.num_envs = num_envs
        self.unroll_length = unroll_length
        self.overlap = num_overlapping_steps
        self._full_length = num_overlapping_steps + unroll_length + 1
        leaves, self._structure = specs_lib.flatten(timestep_specs)
        self._buffers = [
            np.zeros((num_envs, self._full_length) + tuple(s.shape),
                     np.dtype(s.dtype))
            for s in leaves
        ]
        # The next slot to write, per env; starts after the zeroed overlap
        # prefix, as the reference's does (:214-218).
        self._index = np.full((num_envs,), num_overlapping_steps, np.int64)

    def append(self, env_ids: np.ndarray, timesteps) -> Tuple[np.ndarray, Any]:
        """Appends one timestep for each env id; returns completed unrolls.

        Args:
          env_ids: i64[batch] unique env ids.
          timesteps: a tree matching the specs, leaves [batch, ...].

        Returns:
          (completed_env_ids i64[k], unroll tree with leaves
          [k, overlap+unroll_length+1, ...], or None when k is 0).
        """
        if len(np.unique(env_ids)) != len(env_ids):
            # The reference asserts the same (utils.py:173-176).
            raise ValueError("duplicate env ids in append")
        leaves = specs_lib.leaves_of(timesteps)
        if len(leaves) != len(self._buffers):
            raise ValueError(f"{len(leaves)} leaves for a store of "
                             f"{len(self._buffers)}")
        idx = self._index[env_ids]
        for buf, leaf in zip(self._buffers, leaves):
            buf[env_ids, idx] = leaf
        self._index[env_ids] = idx + 1

        completed_ids = env_ids[self._index[env_ids] == self._full_length]
        if len(completed_ids) == 0:
            return completed_ids, None
        unroll_leaves = [buf[completed_ids] for buf in self._buffers]
        # Carry the last overlap+1 timesteps to the front.
        keep = self.overlap + 1
        for buf in self._buffers:
            buf[completed_ids, :keep] = buf[completed_ids, -keep:]
        self._index[completed_ids] = keep
        return completed_ids, specs_lib.unflatten(self._structure,
                                                  unroll_leaves)

    def reset(self, env_ids: np.ndarray):
        """Zero the rows of restarted envs (actor restart protocol)."""
        for buf in self._buffers:
            buf[env_ids] = 0
        self._index[env_ids] = self.overlap
