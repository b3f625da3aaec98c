"""Tree utilities shared by the CHB core (port of ``repro.core.util``)."""
from __future__ import annotations

import torch

from ..tree import tree_leaves, tree_map


def tree_sqnorm(tree) -> torch.Tensor:
    """Global squared l2 norm over every leaf (f32 scalar).

    Leaves accumulate left to right in tree order, each leaf's sum in f32.
    """
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros(())
    return sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves)


def scalar_in(s, dtype: torch.dtype, device=None):
    """A hyperparameter rounded once to ``dtype``.

    A host scalar comes back as the Python float of the rounded value
    (exact in ``dtype``, so multiplying a tensor of that dtype by it
    involves no second rounding and no host-to-device copy); a tensor
    comes back as a 0-d tensor of ``dtype`` on ``device``.
    """
    if isinstance(s, torch.Tensor):
        return s.to(dtype=dtype, device=device)
    return float(torch.tensor(float(s), dtype=torch.float64).to(dtype))


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_stack_zeros(tree, m: int):
    """Zeros tree with an extra leading axis of size ``m``."""
    return tree_map(
        lambda x: torch.zeros((m,) + tuple(x.shape), dtype=x.dtype,
                              device=x.device), tree)


def tree_count_params(tree) -> int:
    return sum(x.numel() for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def tree_worker_slice(tree, m):
    """Select worker ``m`` from a tree whose leaves have leading axis M."""
    return tree_map(lambda x: x[m], tree)


def sum_leading(x: torch.Tensor) -> torch.Tensor:
    """Left fold over the worker axis in index order: ((x0 + x1) + x2)...

    The fold runs in f32 for a sub-f32 bank and rounds once to its dtype,
    as the JAX package's ``jnp.sum(axis=0)`` accumulates bf16 (its bits on
    such a bank); an f32 or f64 bank folds in its own dtype. Starting from
    ``x[0]`` (not from zeros) keeps a leaf whose every worker slice is
    -0.0 at -0.0, exactly like the fused kernels' fold.
    """
    acc = x[0].to(torch.promote_types(x.dtype, torch.float32), copy=True)
    for m in range(1, x.shape[0]):
        acc = acc + x[m]
    return acc.to(x.dtype)


def tree_sum_leading(tree):
    """Sum each leaf over its leading (worker) axis, as a left fold."""
    return tree_map(sum_leading, tree)


def tree_cast(tree, dtype):
    return tree_map(lambda x: x.to(dtype), tree)
