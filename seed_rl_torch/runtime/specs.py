"""Array specs and tree helpers of the remote-actor runtime, without torch.

The learner sends its request and result signatures to every actor that
connects (``inference_server.InferenceServer.serve``). They travel as a
pickle of ``ArraySpec`` leaves (a shape tuple and a numpy dtype name) inside
the port's own NamedTuples, so an actor process unpickles them with this
module and ``seed_rl_torch.types``, which import nothing but numpy.

``flatten`` and ``unflatten`` walk a tree in ``jax.tree``'s leaf order:
dict keys sorted, NamedTuple fields in declaration order, tuples and lists
in order, ``None`` an empty subtree. The byte layout of a request is the
concatenation of its leaves in that order, so the same values give the JAX
package's bytes whatever order a dict was built in.
"""

import io
import pickle
from typing import Any, Callable, List, NamedTuple, Tuple

import numpy as np


class ArraySpec(NamedTuple):
    """The shape and numpy dtype name of one array leaf."""

    shape: Tuple[int, ...]
    dtype: str


def array_spec(shape, dtype) -> ArraySpec:
    return ArraySpec(tuple(int(d) for d in shape), np.dtype(dtype).name)


def spec_of(x) -> ArraySpec:
    """The ``ArraySpec`` of an array-like leaf (numpy or torch)."""
    if hasattr(x, "numpy") and hasattr(x, "detach"):  # a torch tensor
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    return array_spec(x.shape, x.dtype)


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, structure) in ``jax.tree`` order; ``ArraySpec`` is a leaf."""
    leaves: List[Any] = []

    def walk(node):
        if isinstance(node, ArraySpec):
            leaves.append(node)
            return ("leaf",)
        if node is None:
            return ("none",)
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", tuple(keys), tuple(walk(node[k]) for k in keys))
        if _is_namedtuple(node):
            return ("namedtuple", type(node), tuple(walk(x) for x in node))
        if isinstance(node, (tuple, list)):
            return (type(node), tuple(walk(x) for x in node))
        leaves.append(node)
        return ("leaf",)

    return leaves, walk(tree)


def unflatten(structure, leaves):
    """The inverse of ``flatten`` (dicts come back with sorted keys)."""
    it = iter(leaves)

    def build(node):
        kind = node[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(c) for k, c in zip(node[1], node[2])}
        if kind == "namedtuple":
            return node[1](*(build(c) for c in node[2]))
        return kind(build(c) for c in node[1])

    out = build(structure)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def leaves_of(tree) -> List[Any]:
    return flatten(tree)[0]


def map_tree(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure)."""
    leaves, structure = flatten(tree)
    others = [leaves_of(t) for t in rest]
    for other in others:
        if len(other) != len(leaves):
            raise ValueError("trees of different structure")
    return unflatten(structure,
                     [fn(*xs) for xs in zip(leaves, *others)])


class _HandshakeUnpickler(pickle.Unpickler):
    """Loads the handshake's specs and config: plain Python values and the
    port's own types, nothing else."""

    def find_class(self, module, name):
        if module == "seed_rl_torch" or module.startswith("seed_rl_torch."):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"the handshake names a foreign type {module}.{name}")


def loads_handshake(blob: bytes):
    return _HandshakeUnpickler(io.BytesIO(blob)).load()
