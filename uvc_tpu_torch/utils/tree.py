"""Nested-dict parameter trees: the port's stand-in for JAX pytrees."""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf by leaf over trees of nested dicts of the same
    structure (keys in the first tree's order)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves_with_path(tree: Any, path: Tuple[str, ...] = ()
                          ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) pairs in the tree's order."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out.extend(tree_leaves_with_path(v, path + (str(k),)))
        return out
    return [(path, tree)]


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_unflatten(like: Any, leaves: list) -> Any:
    """The tree of ``like``'s structure holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
