"""Nested dicts and lists of tensors (the port's parameter, gradient and
optimizer-state trees): the few ``jax.tree`` operations the port needs.
Dicts keep their insertion order, lists their index order; anything else
is a leaf."""
from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple

__all__ = ["tree_map", "tree_leaves", "tree_paths", "tree_map_with_path"]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``,
    which have its structure; the result has it too."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_paths(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs, paths joined by "/" (``layers/0/attn/wq/w``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map_with_path(fn: Callable, tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` over the leaves, paths as ``tree_paths``'s."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, f"{prefix}{i}/")
                for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)
