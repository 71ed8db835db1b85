"""Parameter trees of nested dicts, lists and tuples: the port's stand-in
for JAX pytrees.

As in JAX, a ``None`` in the tree walked is a node with no leaves: it stays
``None`` and never reaches ``fn``.  A ``None`` in a later tree of
``tree_map`` (a weight-mask tree's unmasked leaves) is passed to ``fn``
as a leaf.  A path holds the dict keys and the list / tuple indices as
strings, so ``".".join(path)`` is the dotted path the JAX package's
``_path_str`` gives (``ablation_blocks.3.qkv.kernel``).
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _rebuild(node, values):
    """A list / tuple / named tuple of ``node``'s type holding ``values``."""
    if hasattr(node, "_fields"):
        return type(node)(*values)
    return type(node)(values)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf by leaf over trees of the same structure (dict
    keys in the first tree's order)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [tree_map(fn, v, *(r[i] for r in rest))
                               for i, v in enumerate(tree)])
    return fn(tree, *rest)


def tree_leaves_with_path(tree: Any, path: Tuple[str, ...] = ()
                          ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) pairs in the tree's order; ``None`` has none."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(path, tree)]
    out = []
    for k, v in items:
        out.extend(tree_leaves_with_path(v, path + (str(k),)))
    return out


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_unflatten(like: Any, leaves: list) -> Any:
    """The tree of ``like``'s structure holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def leaf_at(tree: Any, path: Tuple[str, ...]) -> Any:
    """The node at ``path`` (as ``tree_leaves_with_path`` gives it)."""
    for k in path:
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree
