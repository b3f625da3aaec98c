"""Parameter trees: a tensor, or dicts / tuples / lists of trees.

Leaves are flattened in ``jax.tree_util``'s order (dict keys sorted, then
depth first), so a leaf-by-leaf accumulation runs in the same order as
the JAX package's (``kernels/ops.tree_delta_sqnorms`` depends on it).
"""
from __future__ import annotations

from typing import Any, Callable


def _flatten(x, leaves: list):
    if isinstance(x, dict):
        keys = tuple(sorted(x))
        return (dict, keys, tuple(_flatten(x[k], leaves) for k in keys))
    if type(x) in (tuple, list):
        return (type(x), len(x), tuple(_flatten(v, leaves) for v in x))
    leaves.append(x)
    return None


def _unflatten(d, it):
    if d is None:
        return next(it)
    kind, meta, children = d
    if kind is dict:
        return {k: _unflatten(c, it) for k, c in zip(meta, children)}
    return kind(_unflatten(c, it) for c in children)


# The recursion lives in module-level functions, not in closures: a
# closure that calls itself is a reference cycle, and one holding the
# leaves would keep whole parameter banks alive on the card until the
# cyclic garbage collector happened to run.
def tree_flatten(tree) -> tuple[list, Any]:
    """``(leaves, treedef)``; ``treedef`` rebuilds the structure."""
    leaves: list = []
    treedef = _flatten(tree, leaves)
    return leaves, treedef


def tree_unflatten(treedef, leaves):
    """Inverse of :func:`tree_flatten`."""
    it = iter(leaves)
    out = _unflatten(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree structure holds")
    return out


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leaf-wise over trees of one structure."""
    leaves, treedef = tree_flatten(tree)
    others = []
    for r in rest:
        r_leaves, r_def = tree_flatten(r)
        if r_def != treedef:
            raise ValueError("tree structures differ")
        others.append(r_leaves)
    return tree_unflatten(treedef,
                          [fn(*xs) for xs in zip(leaves, *others)])
