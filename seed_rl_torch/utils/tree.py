"""Pytree helpers that follow ``jax.tree``'s leaf order.

``torch.utils._pytree`` flattens a dict in insertion order; ``jax.tree``
sorts its keys. Code that concatenates the leaves of a (possibly dict)
observation flattens it through ``sorted_dicts`` so that it sees the
leaves in the JAX package's order, whatever order the caller built the
dict in.

``take`` gathers rows of every leaf by index, through the signed view of
the unsigned types wider than uint8: PyTorch has no CUDA ``index`` or
``index_put`` for uint16 (the synthetic Football env's packed frames).
"""

import torch
import torch.utils._pytree as pytree

# The signed type of each unsigned type that CUDA's indexing and selects
# lack; a gather or a select only moves bits, so it goes through this view.
SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32,
               torch.uint64: torch.int64}


def sorted_dicts(tree):
    """``tree`` with every dict rebuilt with its keys in sorted order."""
    if isinstance(tree, dict):
        return {k: sorted_dicts(tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(sorted_dicts(x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(sorted_dicts(x) for x in tree)
    return tree


def sorted_leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    return pytree.tree_leaves(sorted_dicts(tree))


def in_layout_of(tree, like):
    """``tree`` (built by ``sorted_dicts``) with every dict's keys back in
    the order of the matching dict of ``like``."""
    if isinstance(like, dict):
        return {k: in_layout_of(tree[k], v) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(in_layout_of(a, b) for a, b in zip(tree, like)))
    if isinstance(like, (tuple, list)):
        return type(like)(in_layout_of(a, b) for a, b in zip(tree, like))
    return tree


def take(tree, index: torch.Tensor, dim: int = 0):
    """``t[..., index]`` on axis ``dim`` of every leaf of ``tree``, bit for
    bit plain indexing, with uint16/32/64 leaves indexed through their
    signed view."""
    key = (slice(None),) * dim + (index,)

    def rows(t):
        signed = SIGNED_VIEW.get(t.dtype)
        if signed is None:
            return t[key]
        return t.view(signed)[key].view(t.dtype)

    return pytree.tree_map(rows, tree)
