"""Prioritized replay on the device.

Port of ``seed_rl_tpu/replay.py::PrioritizedReplay``: FIFO wrap-around
insertion, priority^exp categorical sampling over the filled prefix,
importance weights ``((1/limit)/p[i])^beta`` normalised by their max, and
``update_priorities``. ``HindsightExperienceReplay`` waits for the SAC
slice.

Differences from the JAX package, none of them in the results:
- The buffer is updated in place: ``insert`` and ``update_priorities``
  write into the state's tensors and return a state that shares them, so
  a 10k-unroll buffer is never copied. Do not keep an old ``ReplayState``
  expecting it to be unchanged.
- ``insert_index`` and ``num_inserted`` are host ints. They depend only on
  how many items were inserted, never on data, so the warmup loop reads
  them without waiting for the device.
- Leaves keep their natural ``[size, *item_shape]`` shape (the JAX package
  flattens multi-axis items to dodge a TPU layout problem).
- ``sample`` draws with ``torch.multinomial`` from the caller's
  ``torch.Generator``, or takes injected ``indices`` (the tests feed the
  JAX draw).
"""

from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from seed_rl_torch.utils import debug_asserts


class ReplayState(NamedTuple):
    buffer: Any  # pytree, leaves [size, ...]
    priorities: torch.Tensor  # f32[size]
    insert_index: int  # next slot (mod size)
    num_inserted: int  # items inserted, saturating at size


class PrioritizedReplay:
    def __init__(self, size: int, importance_sampling_exponent: float):
        self.size = size
        self.importance_sampling_exponent = importance_sampling_exponent

    def init_state(self, example_item) -> ReplayState:
        """``example_item``: pytree of one item (no leading batch dim); the
        buffer is made on the item's device."""
        buffer = pytree.tree_map(
            lambda x: torch.zeros(
                (self.size,) + tuple(x.shape), dtype=x.dtype, device=x.device
            ),
            example_item,
        )
        leaves = pytree.tree_leaves(buffer)
        return ReplayState(
            buffer=buffer,
            priorities=torch.zeros(
                (self.size,), dtype=torch.float32, device=leaves[0].device
            ),
            insert_index=0,
            num_inserted=0,
        )

    def insert(
        self, state: ReplayState, values, priorities: torch.Tensor
    ) -> Tuple[ReplayState, torch.Tensor]:
        """FIFO insert of a batch; returns (state, inserted indices).

        The ring slots are consecutive, so the write is one slice copy per
        leaf, or two where the batch wraps around the end.
        """
        batch = priorities.shape[0]
        if batch > self.size:
            raise ValueError(
                f"cannot insert {batch} items into a buffer of {self.size}")
        start = state.insert_index
        debug_asserts.check(
            lambda: bool(torch.all(torch.isfinite(priorities)))
            and bool(torch.all(priorities >= 0.0)),
            "replay.insert: priorities must be finite and >= 0",
        )
        debug_asserts.check(
            lambda: 0 <= start < self.size,
            "replay.insert: insert_index out of ring bounds",
        )
        first = min(batch, self.size - start)
        spans = [(start, 0, first)]
        if first < batch:
            spans.append((0, first, batch - first))
        leaves = pytree.tree_leaves(state.buffer) + [state.priorities]
        new = pytree.tree_leaves(values) + [priorities]
        if len(leaves) != len(new):
            raise ValueError("inserted items do not match the buffer layout")
        with torch.no_grad():
            for slot, offset, count in spans:
                for leaf, value in zip(leaves, new):
                    leaf[slot:slot + count] = value[offset:offset + count]
        device = state.priorities.device
        indices = (start + torch.arange(batch, device=device)) % self.size
        return ReplayState(
            buffer=state.buffer,
            priorities=state.priorities,
            insert_index=(start + batch) % self.size,
            num_inserted=min(state.num_inserted + batch, self.size),
        ), indices

    def sample(
        self,
        state: ReplayState,
        generator: Optional[torch.Generator],
        num_samples: int,
        priority_exp: float,
        indices: Optional[torch.Tensor] = None,
    ):
        """Returns (indices i64[n], weights f32[n], items pytree[n, ...]).

        ``indices`` replaces the draw from ``generator``; the weights are
        computed for them as for a draw.
        """
        limit = min(state.num_inserted, self.size)
        debug_asserts.check(lambda: limit > 0, "replay.sample: buffer is empty")
        device = state.priorities.device
        if priority_exp == 0:
            if indices is None:
                indices = torch.randint(
                    0, max(limit, 1), (num_samples,), generator=generator,
                    device=device,
                )
            weights = torch.ones((num_samples,), dtype=torch.float32,
                                 device=device)
        else:
            logits = priority_exp * torch.log(
                torch.clamp(state.priorities[:max(limit, 1)], min=1e-30)
            )
            log_probs = torch.log_softmax(logits, dim=0)
            if indices is None:
                indices = torch.multinomial(
                    torch.exp(log_probs), num_samples, replacement=True,
                    generator=generator,
                )
            probs = torch.exp(log_probs[indices.long()])
            weights = (
                (1.0 / max(float(limit), 1.0)) / probs
            ) ** self.importance_sampling_exponent
            weights = weights / torch.max(weights)
        indices = indices.to(device=device, dtype=torch.long)
        items = pytree.tree_map(lambda b: b[indices], state.buffer)
        return indices, weights, items

    def update_priorities(
        self, state: ReplayState, indices: torch.Tensor, priorities
    ) -> ReplayState:
        """Writes ``priorities`` at ``indices`` (in place)."""
        with torch.no_grad():
            state.priorities[indices.long()] = priorities.to(torch.float32)
        return state
