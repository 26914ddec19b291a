"""Parameter trees: nested dicts and lists of tensors (the JAX package's
pytrees, with None for an absent subtree such as a unidirectional
encoder's backward LSTM)."""
from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """The tree with ``fn`` applied to every leaf; dicts keep their keys,
    lists and tuples become lists, None stays None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return None if tree is None else fn(tree)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a tree, dict keys in sorted order as ``jax.tree_util``
    orders them."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]
