"""Trees of tensors: the port's stand-in for ``jax.tree_util``.

Parameters, optimizer state and checkpoints are plain dicts, tuples and
lists with tensors (or numpy arrays) at the leaves.  :func:`tree_map`
keeps a dict's insertion order.  :func:`flatten_with_path` and
:func:`unflatten_like` walk a dict in sorted key order, the order in
which JAX flattens one, so everything that depends on the order of the
leaves agrees with the reference leaf for leaf: the checkpoint's
positional ``a{i}`` arrays, the float32 sum of ``optim.global_norm``
(whose rounding feeds the clip scale) and the paths the decay mask reads.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional, Tuple

Path = Tuple[Any, ...]   # dict keys (str) and sequence indexes (int)


def tree_map(fn, tree, is_leaf: Optional[Callable[[Any], bool]] = None):
    """``fn`` on every leaf of a tree of dicts, tuples and lists; a node
    for which ``is_leaf`` holds is a leaf (a sharding spec is a tuple)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, is_leaf) for v in tree)
    return fn(tree)


def flatten_with_path(tree, prefix: Path = (),
                      is_leaf: Optional[Callable[[Any], bool]] = None) -> List[Tuple[Path, Any]]:
    """``(path, leaf)`` pairs in JAX's flatten order: a dict's keys
    sorted, a tuple's or list's items in order."""
    if is_leaf is not None and is_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in flatten_with_path(tree[k], prefix + (k,), is_leaf)]
    if isinstance(tree, (tuple, list)):
        return [pair for i, v in enumerate(tree)
                for pair in flatten_with_path(v, prefix + (i,), is_leaf)]
    return [(prefix, tree)]


def leaves(tree, is_leaf: Optional[Callable[[Any], bool]] = None) -> list:
    """The leaves in JAX's flatten order."""
    return [leaf for _, leaf in flatten_with_path(tree, is_leaf=is_leaf)]


def unflatten_like(like, new_leaves: Iterable):
    """A tree of ``like``'s structure (and its dicts' key order) whose
    leaves are ``new_leaves``, taken in JAX's flatten order."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
