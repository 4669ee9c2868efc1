"""Nested-dict trees of tensors: the port's stand-in for ``jax.tree_util``.

Params and caches are plain nested dicts, as in ``repro``.  Leaves are
visited in sorted-key order, which is the order ``jax.tree_util`` uses
for dicts, so leaf lists line up across the two packages.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

Path = Tuple[str, ...]


def flatten(tree: Any) -> Tuple[List[Any], List[Path]]:
    """(leaves, paths) in sorted-key order; a non-dict is one leaf."""
    leaves: List[Any] = []
    paths: List[Path] = []
    _walk(tree, (), leaves, paths)
    return leaves, paths


def _walk(node: Any, path: Path, leaves: List[Any], paths: List[Path]
          ) -> None:
    # A module-level function, not a closure: a recursive closure refers
    # to itself through its cell, and that cycle would keep every leaf
    # (whole cache arenas on the card) alive until the garbage collector
    # runs.
    if isinstance(node, dict):
        for key in sorted(node):
            _walk(node[key], path + (key,), leaves, paths)
    else:
        leaves.append(node)
        paths.append(path)


def unflatten(paths: List[Path], leaves: List[Any]) -> Any:
    """Inverse of ``flatten``."""
    if len(paths) == 1 and paths[0] == ():
        return leaves[0]
    root: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return root


def leaves(tree: Any) -> List[Any]:
    return flatten(tree)[0]


def map_tree(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)
