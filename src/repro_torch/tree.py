"""Walks of parameter trees: nested dicts, tuples and lists of tensors.

Leaf order is jax's pytree order (dict keys sorted, sequence items by
index, depth first): the order of the optimizer's walk, the grad norm's
sum and the checkpoints' leaves.
"""

from __future__ import annotations

from typing import Callable, Iterator, List

import torch

Tensor = torch.Tensor


def tree_leaves(tree) -> List[Tensor]:
    """The tensors of ``tree`` in jax's pytree order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree):
    """``fn`` over every tensor of ``tree``, the structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_unflatten(tree, leaves: Iterator[Tensor]):
    """``tree``'s structure filled from ``leaves`` in :func:`tree_leaves`
    order."""
    if isinstance(tree, dict):
        return {k: tree_unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_unflatten(v, leaves) for v in tree)
    return next(leaves)
