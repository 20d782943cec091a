"""What the builders share to drive a built cell and read the program's
side of the check.

- ``seeds``: the generators' seeds a run derives from its ``--seed``;
- ``record``: shadows one instance's method by a call that hands its
  output to a reader (``Spans.wrap`` in ``spans.py`` times such a call);
- ``to_cpu``: a reading taken off the device, leaf by leaf;
- ``DTYPES``: the torch types a configuration's ``compute_dtypes`` name.
"""

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def seeds(seed: int, n: int):
    """``n`` seeds derived from the run's, one a generator."""
    return [(seed * 1_000_003 + i) % 2**63 for i in range(n)]


def record(owner, method, keep, with_args=False):
    """Shadows ``owner.method`` by a call that hands its output to
    ``keep`` (with its arguments, ``with_args``); ``del owner.method``
    undoes it."""
    original = getattr(owner, method)

    def recording(*args, **kwargs):
        out = original(*args, **kwargs)
        keep(out, *args[1:], **kwargs) if with_args else keep(out)
        return out

    setattr(owner, method, recording)


def to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(t) for t in tree)
    return tree
