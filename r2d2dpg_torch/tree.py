"""A minimal ``tree_map`` over the port's containers.

The JAX package threads pytrees through ``jax.tree_util``; the port's
containers are dataclasses, dicts and tuples of tensors (or, on the host
side of the replay shards, numpy arrays), and ``tree_map`` walks them the
same way (an empty tuple is the feedforward nets' empty carry and maps to
itself).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over same-structured trees of tensors or
    numpy arrays."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree, *rest)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(
            tree,
            **{
                f.name: tree_map(
                    fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest)
                )
                for f in dataclasses.fields(tree)
            },
        )
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    raise TypeError(f"tree_map: unsupported node {type(tree).__name__}")



def tree_leaves(tree: Any) -> list:
    """The tensors of ``tree`` in ``tree_map``'s order; ``None``, numbers
    and strings (a state's counters) are no leaves."""
    if tree is None or isinstance(tree, (int, float, str)):
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in tree_leaves(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    raise TypeError(f"tree_leaves: unsupported node {type(tree).__name__}")


def tree_nbytes(tree: Any) -> int:
    """Bytes of the tensors of ``tree``."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def tree_with_leaves(tree: Any, leaves: list) -> Any:
    """``tree`` with its tensors replaced, in ``tree_leaves`` order, by
    ``leaves``; the rest (counters, ``None``) is kept."""
    it = iter(leaves)

    def go(node):
        if node is None or isinstance(node, (int, float, str)):
            return node
        if isinstance(node, torch.Tensor):
            return next(it)
        if dataclasses.is_dataclass(node):
            return dataclasses.replace(
                node, **{f.name: go(getattr(node, f.name))
                         for f in dataclasses.fields(node)})
        if isinstance(node, dict):
            return {k: go(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(go(v) for v in node)
        raise TypeError(f"tree_with_leaves: unsupported node {type(node).__name__}")

    out = go(tree)
    if next(it, None) is not None:
        raise ValueError("tree_with_leaves: more leaves than the tree holds")
    return out
