"""Faults planted under a built cell, to see ``correct`` come out false.

Each takes the cell its builder made and returns a function that undoes
it. ``builders/<name>.py::FAULTS`` lists the faults its cells can have:
- ``frozen``: a step that returns its state unchanged (Adam's update is
  skipped);
- ``half_batch``: half of the batch left out, the means of the loss taken
  over the rest;
- ``altered``: the hand kernel's answer altered where it is produced;
  R2D2 has one more such answer, ``unweighted``: the replay's importance
  weights (``builders/r2d2.py``).
There is no exchange between chips to leave out: every cell is on one.
"""

import importlib


def frozen(cell):
    adam = cell.learner.optimizer._adam
    adam.step = lambda closure=None: None
    return lambda: delattr(adam, "step")


class _HalfMean:
    """Stands in for ``seed_rl_torch.parallel.collectives`` in an agent's
    module: ``mean`` over the first half of the batch (last) axis."""

    def __init__(self, collectives):
        self._collectives = collectives

    def __getattr__(self, name):
        return getattr(self._collectives, name)

    @staticmethod
    def mean(x):
        if x.dim() == 0:
            return x
        return x[..., :max(x.shape[-1] // 2, 1)].mean()


def half_batch(agent_module: str):
    def plant(cell):
        del cell
        module = importlib.import_module(agent_module)
        original = module.collectives
        module.collectives = _HalfMean(original)
        return lambda: setattr(module, "collectives", original)
    return plant


def replace(module_name: str, attribute: str, make):
    """Plants ``make(original)`` as ``module_name.attribute``."""
    def plant(cell):
        del cell
        module = importlib.import_module(module_name)
        original = getattr(module, attribute)
        setattr(module, attribute, make(original))
        return lambda: setattr(module, attribute, original)
    return plant
