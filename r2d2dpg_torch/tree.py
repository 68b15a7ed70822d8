"""A minimal ``tree_map`` over the port's containers.

The JAX package threads pytrees through ``jax.tree_util``; the port's
containers are dataclasses, dicts and tuples of tensors, and ``tree_map``
walks them the same way (an empty tuple is the feedforward nets'
empty carry and maps to itself).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over same-structured trees of tensors."""
    if isinstance(tree, torch.Tensor):
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
