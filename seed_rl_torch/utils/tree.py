"""Pytree helpers that follow ``jax.tree``'s leaf order.

``torch.utils._pytree`` flattens a dict in insertion order; ``jax.tree``
sorts its keys. Code that concatenates the leaves of a (possibly dict)
observation flattens it through ``sorted_dicts`` so that it sees the
leaves in the JAX package's order, whatever order the caller built the
dict in.
"""

import torch.utils._pytree as pytree


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
