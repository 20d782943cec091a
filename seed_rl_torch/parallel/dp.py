"""Data-parallel learners over a mesh of ranks.

Port of ``seed_rl_tpu/parallel/dp.py``. The JAX package wraps a fused
learner in one global-array program: envs and replay items carry a
sharding, parameters are replicated and XLA inserts the gradient
all-reduce. Here each rank is a process that builds the learner over its
share of the envs (``BatchedEnv(..., mesh=mesh)``; the learner then shards
its replay and its batches itself) and wraps it in ``DistributedLearner``,
which runs every call inside ``collectives.over(mesh)``: batch statistics
are global, the gradients are averaged before the clip, and the result
equals the one-rank program's.

What a rank holds (the JAX package's sharding rules, from an explicit list
of fields per learner instead of path patterns, so that no per-env field is
replicated by accident):
- the rollout state (every field per env; ``rollout.ROLLOUT_SHARDS``) and
  the episode accumulators (``episode_stats.SHARDS``): the rank's envs,
  ``[r*B/N, (r+1)*B/N)``;
- the replay's items (``replay.REPLAY_SHARDS``): ring slots
  ``[r*S/N, (r+1)*S/N)``;
- the episode windows: the rank's partial sums, added at log time;
- everything else (parameters, optimizer state, counters, priorities, the
  generators, observation and PopArt statistics): replicated, bitwise
  equal on every rank.

Each learner names its per-rank fields in ``SHARDED_FIELDS`` (a spec per
train-state field: an int is the env or item axis of every leaf under it,
``"sum"`` a partial sum, a NamedTuple of specs one per field) and the rest
in ``REPLICATED_FIELDS``; a field in neither raises.

Checkpoints hold the global state in the one-rank layout
(``checkpoint_state`` gathers it on rank 0, one leaf at a time, each leaf
on the CPU as soon as it is whole), so a checkpoint from N ranks restores
into one rank and the other way round, as the JAX package's global arrays
allow; ``load_checkpoint_state`` cuts each rank's share out of a global
tree.
"""

from typing import Any, Dict

import torch
import torch.utils._pytree as pytree

from seed_rl_torch.parallel import collectives
from seed_rl_torch.parallel.mesh import Mesh

SUM = "sum"  # a per-rank partial sum (episode windows)


def _spec_items(spec, tree):
    """(child spec, child of ``tree``) per field of a NamedTuple spec;
    ``tree`` is the NamedTuple or its saved dict."""
    for field in spec._fields:
        child = tree[field] if isinstance(tree, dict) else getattr(tree,
                                                                   field)
        yield field, getattr(spec, field), child


def _rebuild(spec, tree, children: Dict[str, Any]):
    if isinstance(tree, dict):
        return dict(tree, **children)
    return tree._replace(**children)


def _global_leaf(t: torch.Tensor, axis: int, mesh: Mesh, layout: bool):
    """A sharded leaf's global value on rank 0's CPU, else (on the other
    ranks, or for the ``layout`` alone) a meta tensor of its global
    shape."""
    if not layout:
        return mesh.gather_to_host(t, axis)
    shape = list(t.shape)
    shape[axis] = sum(mesh.all_gather_counts(shape[axis]))
    return torch.empty(shape, dtype=t.dtype, device="meta")


def gather_global(spec, tree, mesh: Mesh, layout: bool = False):
    """The global value of a rank's ``tree`` laid out by ``spec``: on rank
    0 each sharded leaf gathered to the CPU, one leaf at a time; on the
    other ranks, or with ``layout``, a meta tensor of its global shape."""
    if spec is None:
        return tree
    if hasattr(spec, "_fields"):
        return _rebuild(spec, tree, {
            field: gather_global(sub, child, mesh, layout)
            for field, sub, child in _spec_items(spec, tree)})
    if spec == SUM:
        return tree if layout else pytree.tree_map(mesh.sum, tree)
    return pytree.tree_map(
        lambda t: _global_leaf(t, spec, mesh, layout), tree)


def localize(spec, saved, local, mesh: Mesh):
    """This rank's part of ``saved`` (a global tree laid out by ``spec``),
    shaped as the rank's own ``local`` tree."""
    if spec is None:
        return saved
    if hasattr(spec, "_fields"):
        return _rebuild(spec, saved, {
            field: localize(sub, saved[field] if isinstance(saved, dict)
                            else getattr(saved, field), child, mesh)
            for field, sub, child in _spec_items(spec, local)})
    saved_leaves, saved_spec = pytree.tree_flatten(saved)
    local_leaves = pytree.tree_leaves(local)
    if len(saved_leaves) != len(local_leaves):
        raise ValueError("checkpoint entry does not match this learner's "
                         "layout")
    out = []
    for full, mine in zip(saved_leaves, local_leaves):
        if spec == SUM:
            out.append(full if mesh.rank == 0 else torch.zeros_like(full))
            continue
        counts = mesh.all_gather_counts(mine.shape[spec])
        start = sum(counts[:mesh.rank])
        out.append(full.narrow(spec, start, counts[mesh.rank]).to(
            mine.device, copy=True))
    return pytree.tree_unflatten(out, saved_spec)


class DistributedLearner:
    """Runs a fused device learner (V-trace, PPO, R2D2, SAC) on one rank of
    a mesh.

    ``learner`` must have been built over this rank's share of the envs
    (its ``BatchedEnv`` made with ``mesh``), on ``mesh.device``. The
    wrapper has the JAX surface (``init``, ``train_step``, ``train_many``,
    ``warmup_step``, ``frames_per_step``, ``engine``, ``config``), so the
    learner loops take it unchanged, and checkpoints in the global layout.
    """

    def __init__(self, learner, mesh: Mesh):
        env_mesh = getattr(learner.engine.env, "mesh", None)
        if mesh.size > 1 and env_mesh is not mesh:
            raise ValueError("the learner's envs must be this mesh's share "
                             "(BatchedEnv(..., mesh=mesh))")
        for name in ("SHARDED_FIELDS", "REPLICATED_FIELDS"):
            if not hasattr(learner, name):
                raise ValueError(f"{type(learner).__name__} does not name "
                                 "its per-rank fields; it cannot run "
                                 "sharded")
        self.learner = learner
        self.mesh = mesh

    @property
    def frames_per_step(self):
        return self.learner.frames_per_step

    @property
    def engine(self):
        return self.learner.engine

    @property
    def config(self):
        return self.learner.config

    @property
    def device(self):
        return self.learner.device

    @property
    def agent(self):
        return self.learner.agent

    @property
    def snapshots(self):
        """PPO's action-point snapshots (``learner_loop`` appends the
        global state's)."""
        return self.learner.snapshots

    def _call(self, fn, *args, **kwargs):
        with collectives.over(self.mesh):
            return fn(*args, **kwargs)

    def init(self):
        return self._call(self.learner.init)

    def warmup_step(self, state):
        return self._call(self.learner.warmup_step, state)

    def train_step(self, state):
        return self._call(self.learner.train_step, state)

    def train_many(self, state, num_steps: int):
        return self._call(self.learner.train_many, state, num_steps)

    def _check_fields(self, state):
        named = (set(self.learner.SHARDED_FIELDS)
                 | set(self.learner.REPLICATED_FIELDS))
        if named != set(state._fields):
            raise ValueError(
                f"{type(self.learner).__name__}'s train state has the fields "
                f"{sorted(state._fields)}; its sharding names "
                f"{sorted(named)}")

    def checkpoint_state(self, state, layout: bool = False
                         ) -> Dict[str, Any]:
        """The learner's checkpoint tree with every per-rank field in the
        one-rank layout (a collective): gathered to the CPU on rank 0, and
        on the other ranks meta tensors of the global shapes, as everywhere
        with ``layout`` (a restore's template, which moves no data)."""
        self._check_fields(state)
        tree = self.learner.checkpoint_state(state)
        for field, spec in self.learner.SHARDED_FIELDS.items():
            tree[field] = gather_global(spec, tree[field], self.mesh, layout)
        return tree

    def checkpoint_layout(self, state) -> Dict[str, Any]:
        """``checkpoint_state``'s structure, shapes and dtypes, its sharded
        leaves as meta tensors."""
        return self.checkpoint_state(state, layout=True)

    def load_checkpoint_state(self, state, tree: Dict[str, Any]):
        """Loads a global tree (``checkpoint_state``'s, whole or its
        warm-start fields): each rank takes its share; returns the train
        state."""
        self._check_fields(state)
        local = self.learner.checkpoint_state(state)
        tree = dict(tree)
        for field, spec in self.learner.SHARDED_FIELDS.items():
            if field in tree:
                tree[field] = localize(spec, tree[field], local[field],
                                       self.mesh)
        return self.learner.load_checkpoint_state(state, tree)
