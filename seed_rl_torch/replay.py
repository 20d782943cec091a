"""Prioritized and hindsight experience replay on the device.

Port of ``seed_rl_tpu/replay.py``:
- ``PrioritizedReplay``: FIFO wrap-around insertion, priority^exp
  categorical sampling over the filled prefix, importance weights
  ``((1/limit)/p[i])^beta`` normalised by their max, and
  ``update_priorities``;
- ``HindsightExperienceReplay``: 'future'-strategy goal substitution with
  probability p inside each sampled window, rewards recomputed with
  ``compute_reward_fn``, and a random ``unroll_length + 1``-step window cut
  from each sampled item.

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
  JAX draw); the hindsight replay's three draws can be injected too.

On a mesh (``parallel``) the items are sharded by ring slot, as the JAX
package's ``DistributedLearner`` shards them: rank r stores slots ``[r*S/N,
(r+1)*S/N)`` and its buffer's leaves are ``[S/N, ...]``. The priorities and
both cursors are replicated. An insert takes the rank's own new items,
gathers every rank's (in global env order) and writes those that land in
the rank's slots; every rank draws the same global indices, and ``sample``
gathers the sampled items from their owners, so every rank holds the whole
global batch (and the hindsight replay relabels it with the same draws).
"""

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from seed_rl_torch.parallel.mesh import Mesh
from seed_rl_torch.utils import debug_asserts, tree
from seed_rl_torch.utils.profiling import span


class ReplayState(NamedTuple):
    buffer: Any  # pytree, leaves [size, ...]
    priorities: torch.Tensor  # f32[size]
    insert_index: int  # next slot (mod size)
    num_inserted: int  # items inserted, saturating at size


# A rank's share (``parallel/dp.py``): its ring slots of the items; the
# priorities and cursors are replicated.
REPLAY_SHARDS = ReplayState(buffer=0, priorities=None, insert_index=None,
                            num_inserted=None)


class PrioritizedReplay:
    """``size`` items, of which this rank of ``mesh`` stores ``slots``
    (all of them on one rank, the default)."""

    def __init__(self, size: int, importance_sampling_exponent: float,
                 mesh=None):
        self.size = size
        self.importance_sampling_exponent = importance_sampling_exponent
        # The one-rank mesh's collectives are the identity; its device is
        # never read.
        self.mesh = mesh if mesh is not None else Mesh(0, 1, "cpu")
        self.slots = self.mesh.shard(size)

    def init_state(self, example_item) -> ReplayState:
        """``example_item``: pytree of one item (no leading batch dim); the
        buffer (this rank's slots) is made on the item's device."""
        stored = self.slots.stop - self.slots.start
        buffer = pytree.tree_map(
            lambda x: torch.zeros(
                (stored,) + tuple(x.shape), dtype=x.dtype, device=x.device
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
        leaf, or two where the batch wraps around the end. ``values`` and
        ``priorities`` are the rank's own items; the batch is every rank's,
        in rank order.
        """
        with span("replay.insert"):
            values = pytree.tree_map(self.mesh.all_gather, values)
            priorities = self.mesh.all_gather(priorities)
            batch = priorities.shape[0]
            if batch > self.size:
                raise ValueError(f"cannot insert {batch} items into a "
                                 f"buffer of {self.size}")
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
            # Sorted dict keys on both sides: a dict built in another key order
            # still lands leaf by leaf.
            leaves = tree.sorted_leaves(state.buffer)
            new = tree.sorted_leaves(values)
            if len(leaves) != len(new):
                raise ValueError(
                    "inserted items do not match the buffer layout")
            lo, hi = self.slots.start, self.slots.stop
            with torch.no_grad():
                for slot, offset, count in spans:
                    state.priorities[slot:slot + count] = priorities[
                        offset:offset + count]
                    # The part of the span in this rank's slots.
                    first, last = max(slot, lo), min(slot + count, hi)
                    if first >= last:
                        continue
                    src = offset + first - slot
                    for leaf, value in zip(leaves, new):
                        leaf[first - lo:last - lo] = value[
                            src:src + last - first]
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
        with span("replay.sample"):
            limit = min(state.num_inserted, self.size)
            debug_asserts.check(lambda: limit > 0,
                                "replay.sample: buffer is empty")
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
            return indices, weights, self.gather(state, indices)

    def gather(self, state: ReplayState, indices: torch.Tensor):
        """The items at global ``indices``: each rank takes those it
        stores, and every rank gets all of them, in ``indices``' order."""
        with span("replay.gather"):
            if self.mesh.size == 1:
                # One rank stores every slot: the masked indexing below has a
                # data-dependent shape, a host sync this path does not pay.
                return tree.take(state.buffer, indices)
            lo, hi = self.slots.start, self.slots.stop
            mine = (indices >= lo) & (indices < hi)
            local = indices[mine] - lo
            parts = pytree.tree_map(self.mesh.all_gather,
                                    tree.take(state.buffer, local))
            # The gathered rows are the owners' in rank order, each in batch
            # order; the owner of a slot is slot // (S/N).
            owner = torch.div(indices, hi - lo, rounding_mode="floor")
            order = torch.argsort(owner, stable=True)
            position = torch.empty_like(order)
            position[order] = torch.arange(order.numel(), device=order.device)
            return tree.take(parts, position)

    def update_priorities(
        self, state: ReplayState, indices: torch.Tensor, priorities
    ) -> ReplayState:
        """Writes ``priorities`` at ``indices`` (in place). Where an index
        repeats, its last value wins, on every device: a scatter on the card
        picks among duplicates in no fixed order, and replicated priorities
        must be written alike on every rank."""
        with span("replay.update_priorities"):
            idx = indices.long()
            order = torch.argsort(idx, stable=True)
            ordered = idx[order]
            last = torch.ones_like(ordered, dtype=torch.bool)
            last[:-1] = ordered[1:] != ordered[:-1]
            keep = order[last]
            with torch.no_grad():
                state.priorities[idx[keep]] = priorities.to(
                    torch.float32)[keep]
            return state


class HERDraws(NamedTuple):
    """The hindsight replay's draws for a batch of ``n`` windows of ``H``
    steps, each in place of the sampler's own."""

    goal_uniform: Optional[torch.Tensor] = None  # f32[n, H] in [0, 1)
    mask_uniform: Optional[torch.Tensor] = None  # f32[n, H] in [0, 1)
    window_start: Optional[torch.Tensor] = None  # int[n] in [0, H - unroll)


class HindsightExperienceReplay(PrioritizedReplay):
    """Future-strategy HER over windows with dict observations.

    Items are structures with ``env_outputs.observation`` dicts holding
    ``achieved_goal`` and ``desired_goal``, stored item-major ``[H, ...]``
    per slot; ``sample`` relabels goals and cuts ``unroll_length + 1``-step
    unrolls out of the windows. The item's ``agent_state`` is kept as
    stored: the state before the window's first step, whatever step the cut
    starts at, as in the JAX package.
    """

    def __init__(
        self,
        size: int,
        importance_sampling_exponent: float,
        compute_reward_fn: Callable,
        unroll_length: int,
        substitution_probability: float,
        mesh=None,
    ):
        super().__init__(size, importance_sampling_exponent, mesh)
        self.compute_reward_fn = compute_reward_fn
        self.unroll_length = unroll_length
        self.substitution_probability = substitution_probability

    def sample(
        self,
        state: ReplayState,
        generator: Optional[torch.Generator],
        num_samples: int,
        priority_exp: float,
        indices: Optional[torch.Tensor] = None,
        draws: HERDraws = HERDraws(),
    ):
        indices, weights, sampled = super().sample(
            state, generator, num_samples, priority_exp, indices=indices)
        env_outputs = sampled.env_outputs
        observation = dict(env_outputs.observation)
        achieved = observation["achieved_goal"]
        desired = observation["desired_goal"]
        batch_size, horizon = achieved.shape[:2]
        if horizon < self.unroll_length + 1:
            raise ValueError(f"windows of {horizon} steps cannot hold an "
                             f"unroll of {self.unroll_length} + 1")
        device = achieved.device

        def goal_reward(desired_goal):
            # reward[:, t] is for the transition t-1 -> t; t = 0 holds a
            # placeholder 0.
            reward = self.compute_reward_fn(achieved[:, 1:],
                                            desired_goal[:, :-1])
            return torch.cat([torch.zeros_like(reward[:, :1]), reward], dim=1)

        def uniform(given):
            if given is not None:
                return given.to(device=device, dtype=torch.float32)
            return torch.rand((batch_size, horizon), generator=generator,
                              device=device)

        old_goal_reward = goal_reward(desired)
        # Future-strategy goal index: uniform in (t, horizon).
        low = torch.clamp(torch.arange(horizon, device=device) + 1,
                          max=horizon - 1)
        goal_index = (low + uniform(draws.goal_uniform) * (horizon - low)).to(
            torch.int64).clamp(0, horizon - 1)
        substituted = torch.gather(
            achieved, 1,
            goal_index[..., None].expand(-1, -1, achieved.shape[-1]))
        not_done = (~env_outputs.done).to(desired.dtype)
        # No substitution at an episode's last step: no next state is
        # stored for it.
        mask = ((uniform(draws.mask_uniform) < self.substitution_probability)
                .to(desired.dtype) * not_done)[..., None]
        observation["desired_goal"] = mask * substituted + (1 - mask) * desired
        reward = env_outputs.reward + (
            goal_reward(observation["desired_goal"]) - old_goal_reward
        ) * (~env_outputs.done).to(torch.float32)
        sampled = sampled._replace(env_outputs=env_outputs._replace(
            observation=observation, reward=reward))

        start = draws.window_start
        if start is None:
            start = torch.randint(0, horizon - self.unroll_length,
                                  (batch_size,), generator=generator,
                                  device=device)
        window = (start.to(device=device, dtype=torch.int64)[:, None]
                  + torch.arange(self.unroll_length + 1, device=device))
        rows = torch.arange(batch_size, device=device)[:, None]

        def cut(t):
            if t.dim() < 2 or t.shape[1] != horizon:
                return t
            return t[rows, window]

        agent_state = sampled.agent_state
        sampled = pytree.tree_map(cut, sampled)._replace(
            agent_state=agent_state)
        return indices, weights, sampled
