"""Nested trees of tensors: the port's stand-in for ``jax.tree_util``.

Params and caches are plain nested dicts, as in ``repro``; a tuple or a
list is a node too (the bucketed error-feedback state is a tuple of
per-bucket residuals, as in the reference).  Dict leaves are visited in
sorted-key order and sequence items in order, which is the order
``jax.tree_util`` uses, so leaf lists line up across the two packages.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

Path = Tuple[Any, ...]      # dict keys (str) and sequence positions (int)


def flatten(tree: Any) -> Tuple[List[Any], List[Path]]:
    """(leaves, paths) in sorted-key order; a non-container is one leaf."""
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
    elif isinstance(node, (tuple, list)):
        for i, item in enumerate(node):
            _walk(item, path + (i,), leaves, paths)
    else:
        leaves.append(node)
        paths.append(path)


def unflatten(paths: List[Path], leaves: List[Any]) -> Any:
    """Inverse of ``flatten`` (sequence nodes come back as tuples)."""
    if len(paths) == 1 and paths[0] == ():
        return leaves[0]
    root: Dict[Any, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return _seal(root)


def _seal(node: Any) -> Any:
    """Turn the int-keyed dicts ``unflatten`` built back into tuples."""
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return tuple(_seal(node[i]) for i in range(len(node)))
    return {k: _seal(v) for k, v in node.items()}


def leaves(tree: Any) -> List[Any]:
    return flatten(tree)[0]


def map_tree(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (tuple, list)):
        return tuple(map_tree(fn, t, *(r[i] for r in rest))
                     for i, t in enumerate(tree))
    return fn(tree, *rest)
