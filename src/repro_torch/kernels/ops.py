"""Tree-level dispatch onto the kernels (port of ``repro/kernels/ops.py``'s
``tree_delta_sqnorms``, ``tree_fused_dense_step``, ``tree_int8_stats`` and
``tree_fused_int8_step``): what the ``backend="cuda"`` optimizer runs.

Per-leaf (M,) partials accumulate leaf by leaf, ``acc = acc + partial``
in f32, in tree order, exactly as the JAX dispatch does.
"""
from __future__ import annotations

import torch

from ..core.quantize import int8_scale
from ..tree import tree_flatten, tree_leaves, tree_unflatten
from . import censor, fused_step


def tree_delta_sqnorms(grads, bank) -> torch.Tensor:
    """(M,) per-worker ||g_m - ghat_m||^2 over a whole tree (B1 per leaf)."""
    leaves_g = tree_leaves(grads)
    leaves_h = tree_leaves(bank)
    acc = torch.zeros((leaves_h[0].shape[0],), dtype=torch.float32,
                      device=leaves_h[0].device)
    for g, h in zip(leaves_g, leaves_h):
        acc = acc + censor.censor_delta_sqnorm_batched(g, h)
    return acc


def tree_fused_dense_step(grads, bank, params, prev_params, mask, alpha,
                          beta):
    """B2 per leaf. Returns ``(new_ghat, agg, new_params)`` trees."""
    leaves_t, treedef = tree_flatten(params)
    outs = [fused_step.fused_dense_step(g, h, t, tp, mask, alpha, beta)
            for g, h, t, tp in zip(tree_leaves(grads), tree_leaves(bank),
                                   leaves_t, tree_leaves(prev_params))]
    return tuple(tree_unflatten(treedef, [o[i] for o in outs])
                 for i in range(3))


def tree_int8_stats(grads, bank, err):
    """B5 per leaf. Returns ``(dsq, scales)``: the (M,) f32 eq.-(8)
    left-hand side and a tree of (M,) f32 per-leaf int8 scales
    ``where(amax > 0, amax / 127, 1)``."""
    leaves_g, treedef = tree_flatten(grads)
    leaves_h = tree_leaves(bank)
    acc = torch.zeros((leaves_h[0].shape[0],), dtype=torch.float32,
                      device=leaves_h[0].device)
    scales = []
    for g, h, e in zip(leaves_g, leaves_h, tree_leaves(err)):
        sq, amax = fused_step.int8_stats_batched(g, h, e)
        acc = acc + sq
        scales.append(int8_scale(amax))
    return acc, tree_unflatten(treedef, scales)


def tree_fused_int8_step(grads, bank, err, params, prev_params, mask,
                         scales, alpha, beta):
    """B6 per leaf. Returns ``(new_ghat, new_err, agg, new_params)``."""
    leaves_t, treedef = tree_flatten(params)
    outs = [fused_step.fused_int8_step(g, h, e, t, tp, mask, s, alpha, beta)
            for g, h, e, t, tp, s in zip(
                tree_leaves(grads), tree_leaves(bank), tree_leaves(err),
                leaves_t, tree_leaves(prev_params), tree_leaves(scales))]
    return tuple(tree_unflatten(treedef, [o[i] for o in outs])
                 for i in range(4))
