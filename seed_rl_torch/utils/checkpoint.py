"""Checkpoints on ``torch.save``, with the JAX package's save/restore
semantics.

Port of ``seed_rl_tpu/utils/checkpoint.py`` (which uses Orbax): keep the
latest ``max_to_keep`` checkpoints, save on a time cadence
(``save_checkpoint_secs``, the first call at once), restore on start from
``<logdir>/ckpt`` for preemption recovery, else warm-start from
``init_checkpoint``.

What a checkpoint holds comes from the learner: its ``checkpoint_state(
state)`` returns a dict of live tensors, ints and trees (module state dicts,
the optimizer, the train state's fields, the generators' states), and its
``load_checkpoint_state(state, tree)`` takes back a tree of the same
structure, or of only the ``WARM_START_FIELDS``, and returns the new train
state. Before a load the saved tree is checked against the learner's own,
leaf by leaf (structure, shapes, dtypes); a mismatch raises ``ValueError``.

On disk, one file per step, ``<logdir>/ckpt/<step>/checkpoint.pt``: a
nested dict of CPU tensors, ints and lists, with NamedTuples stored as
dicts keyed by field name (as Orbax stores them), written to a temporary
name and then moved into place. It loads with ``torch.load(...,
weights_only=True)``.

Not ported, on purpose: ``keep_period_hours`` (the JAX manager takes it
and ignores it) and the legacy key renames (no checkpoint of this package
ever carried flax's ``ImpalaResNetTorso_0`` scope).
"""

import os
import shutil
import time
from typing import Any, Iterable, List, Optional

import torch

FILE_NAME = "checkpoint.pt"

# What a warm start carries: the parameters, the target parameters, the
# optimizer, the observation and PopArt statistics and the step; never the
# rollout, replay, episode statistics or generators, so it works across
# ``num_envs`` and replay sizes.
WARM_START_FIELDS = (
    "params",
    "target_net_params",
    "target_params",
    "opt_state",
    "norm_state",
    "obs_norm",
    "step",
)


def to_saveable(tree: Any) -> Any:
    """A copy of ``tree`` on the CPU: NamedTuples become dicts keyed by
    field, tuples become lists, and every tensor a compact copy that
    shares no memory with the original."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if hasattr(tree, "_fields"):
        return {f: to_saveable(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, dict):
        return {k: to_saveable(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_saveable(v) for v in tree]
    return tree


def repack(template: Any, saved: Any, path: str = "") -> Any:
    """``saved`` in ``template``'s structure (NamedTuples and tuples
    rebuilt), each tensor on its template's device; raises ``ValueError``
    where the structure, a shape or a dtype differs."""
    def fail(why):
        raise ValueError(f"checkpoint entry {path or '<root>'}: {why}")

    if isinstance(template, torch.Tensor):
        if not isinstance(saved, torch.Tensor):
            fail(f"expected a tensor, found {type(saved).__name__}")
        if saved.shape != template.shape or saved.dtype != template.dtype:
            fail(f"saved {saved.dtype}{list(saved.shape)}, this run has "
                 f"{template.dtype}{list(template.shape)}")
        return saved.to(template.device)
    if hasattr(template, "_fields") or isinstance(template, dict):
        keys = template._fields if hasattr(template, "_fields") else (
            list(template))
        if not isinstance(saved, dict) or set(saved) != set(keys):
            found = sorted(saved) if isinstance(saved, dict) else saved
            fail(f"expected the keys {sorted(keys)}, found {found}")
        items = [repack(template[k] if isinstance(template, dict)
                        else getattr(template, k), saved[k], f"{path}.{k}")
                 for k in keys]
        if isinstance(template, dict):
            return dict(zip(keys, items))
        return type(template)(*items)
    if isinstance(template, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(
                template):
            fail(f"expected a sequence of {len(template)}, found {saved!r}")
        return type(template)(repack(t, s, f"{path}[{i}]")
                              for i, (t, s) in enumerate(zip(template, saved)))
    if type(saved) is not type(template):
        fail(f"expected {type(template).__name__}, found {saved!r}")
    return saved


def load_into(learner, state, saved: dict, fields: Optional[Iterable[str]]
              = None):
    """Loads ``saved`` (a tree from ``checkpoint_state``, e.g. as stored)
    into ``learner`` and returns the new train state; ``fields`` limits
    the load to those top-level entries (a warm start)."""
    template = learner.checkpoint_state(state)
    if fields is None:
        keys = list(template)
        if set(saved) != set(keys):
            raise ValueError(f"checkpoint holds {sorted(saved)}, this "
                             f"learner's {sorted(keys)}")
    else:
        keys = [k for k in template if k in fields]
        missing = [k for k in keys if k not in saved]
        if missing:
            raise ValueError(f"checkpoint lacks {missing}")
    tree = {k: repack(template[k], saved[k], k) for k in keys}
    return learner.load_checkpoint_state(state, tree)


def _generators(learner) -> List[torch.Generator]:
    """A learner's random streams: its envs', its rollout engine's and its
    own, those it has (host envs draw from their own numpy generators, and
    a host off-policy learner's engine is the loop's)."""
    engine = getattr(learner, "engine", None)
    env = getattr(engine, "env", None)
    return [g for g in (getattr(env, "generator", None),
                        getattr(engine, "generator", None),
                        getattr(learner, "generator", None))
            if g is not None]


def generator_states(learner) -> List[torch.Tensor]:
    return [g.get_state() for g in _generators(learner)]


def load_train_state(learner, state, tree: dict):
    """``state`` with each of its fields that ``tree`` holds, and the
    learner's generators set from ``tree`` where it holds them (not on a
    warm start)."""
    if "generators" in tree:
        for g, saved in zip(_generators(learner), tree["generators"]):
            g.set_state(saved)
    return state._replace(**{f: tree[f] for f in state._fields if f in tree})


def _steps(directory: str) -> List[int]:
    """The steps with a complete checkpoint under ``directory``, sorted."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(name) for name in os.listdir(directory)
                  if name.isdigit() and os.path.isfile(
                      os.path.join(directory, name, FILE_NAME)))


def _load(directory: str, step: int, device) -> dict:
    return torch.load(os.path.join(directory, str(step), FILE_NAME),
                      map_location=device, weights_only=True)


class CheckpointManager:
    """Time-cadenced saves under ``<directory>/ckpt`` and restore on start.

    ``directory=None`` turns saving and restoring off (``init_checkpoint``
    still warm-starts).
    """

    def __init__(
        self,
        directory: Optional[str],
        save_checkpoint_secs: float = 1800.0,
        max_to_keep: int = 1,
        init_checkpoint: Optional[str] = None,
    ):
        self._dir = (None if not directory else
                     os.path.join(os.path.abspath(directory), "ckpt"))
        self._save_secs = save_checkpoint_secs
        self._max_to_keep = max_to_keep
        # Warm-start source, used only when there is nothing to resume from.
        self._init_checkpoint = init_checkpoint
        # The first maybe_save saves at once, as the reference's
        # ``last_ckpt_time = 0``.
        self._last_save = 0.0

    def latest_step(self) -> Optional[int]:
        steps = _steps(self._dir) if self._dir else []
        return steps[-1] if steps else None

    def restore_or(self, learner, state):
        """The latest checkpoint loaded into ``learner`` and ``state``;
        else a warm start from ``init_checkpoint``; else ``state``."""
        step = self.latest_step()
        if step is None:
            if self._init_checkpoint:
                return restore_from(self._init_checkpoint, learner, state)
            return state
        try:
            restored = load_into(learner, state,
                                 _load(self._dir, step, learner.device))
        except ValueError as exc:
            raise ValueError(
                "restore-on-start failed: the checkpoint in the logdir has a "
                "different train-state structure than this run "
                "(config/optimizer change?). Use a fresh --logdir, delete "
                "the stale ckpt/ directory, or warm-start params only via "
                f"--init_checkpoint. Original error: {exc}") from exc
        self._last_save = time.time()
        return restored

    def maybe_save(self, step: int, learner, state,
                   force: bool = False) -> bool:
        """Saves ``learner.checkpoint_state(state)`` at ``step`` when
        forced or ``save_checkpoint_secs`` have passed since the last save;
        returns whether it saved."""
        if self._dir is None:
            return False
        now = time.time()
        if not force and now - self._last_save < self._save_secs:
            return False
        target = os.path.join(self._dir, str(step))
        os.makedirs(target, exist_ok=True)
        path = os.path.join(target, FILE_NAME)
        torch.save(to_saveable(learner.checkpoint_state(state)),
                   path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in _steps(self._dir)[:-self._max_to_keep]:
            shutil.rmtree(os.path.join(self._dir, str(old)))
        self._last_save = now
        return True

    def close(self):
        """Saves are synchronous: nothing is left to wait for."""


def restore_from(path: str, learner, state, warm_start_only: bool = True):
    """Restore from the latest checkpoint under ``<path>/ckpt``.

    With ``warm_start_only`` (the default, as ``--init_checkpoint`` uses
    it) only ``WARM_START_FIELDS`` are read; the rollout, replay, episode
    statistics and generators keep their fresh values.
    """
    directory = os.path.join(os.path.abspath(path), "ckpt")
    steps = _steps(directory)
    if not steps:
        raise FileNotFoundError(f"No checkpoint under {path}")
    saved = _load(directory, steps[-1], learner.device)
    return load_into(learner, state, saved,
                     WARM_START_FIELDS if warm_start_only else None)
