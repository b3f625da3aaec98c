"""Tree-level dispatch onto the kernels (port of ``repro/kernels/ops.py``'s
``tree_delta_sqnorms``, ``tree_sqnorms``, ``tree_sqnorm_row``,
``tree_censor_bank_advance``,
``tree_bank_advance``, ``tree_int8_roundtrip_ef``, ``tree_topk_pack_ef``,
``tree_residual_ef``, ``tree_fused_dense_step``, ``tree_int8_stats``,
``tree_fused_int8_step`` and ``tree_hb_update``), and the port's own
``tree_fold_workers``: what the ``backend="cuda"`` optimizer runs.

Per-leaf (M,) partials accumulate leaf by leaf, ``acc = acc + partial``
in f32, in tree order, exactly as the JAX dispatch does.

Also the single-tensor entry points of ``repro/kernels/ops.py``
(``censor_delta_sqnorm``, ``censor_select``, ``hb_param_update``,
``flash_attention_fwd``) with the JAX signatures. ``use_pallas=True``
means the card's kernel, as the spec loader reads ``"pallas"`` as
``"cuda"``: the kernel wrapper, which runs the kernel on CUDA tensors and
its plain version on CPU tensors. ``use_pallas=False`` runs the plain
version from ``ref`` on either device. There is no ``jit``: PyTorch runs
eagerly, and ``alpha``/``beta`` reach B3 as runtime arguments.
"""
from __future__ import annotations

import torch

from ..core.quantize import int8_scale
from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from . import (censor, flash_attention, fused_step, hb_update, lowrank_ef,
               quantize_ef, ref, topk_pack)


def tree_delta_sqnorms(grads, bank) -> torch.Tensor:
    """(M,) per-worker ||g_m - ghat_m||^2 over a whole tree (B1 per leaf)."""
    leaves_g = tree_leaves(grads)
    leaves_h = tree_leaves(bank)
    acc = torch.zeros((leaves_h[0].shape[0],), dtype=torch.float32,
                      device=leaves_h[0].device)
    for g, h in zip(leaves_g, leaves_h):
        acc = acc + censor.censor_delta_sqnorm_batched(g, h)
    return acc


def tree_sqnorms(pending) -> torch.Tensor:
    """(M,) per-worker ||x_m||^2 of a materialized pending tree (B8 per
    leaf)."""
    leaves = tree_leaves(pending)
    acc = torch.zeros((leaves[0].shape[0],), dtype=torch.float32,
                      device=leaves[0].device)
    for x in leaves:
        acc = acc + censor.sqnorm_batched(x)
    return acc


def tree_sqnorm_row(pending_row) -> torch.Tensor:
    """One worker's () f32 ||x||^2 (the ``fed.runner`` entry point): B8 at
    M = 1 per leaf, summed leaf by leaf in tree order. A worker's B8 output
    comes from the same elements in the same order at any M, so the row
    equals the batched step's slice bit for bit, and so does the censor
    decision."""
    leaves = tree_leaves(pending_row)
    acc = torch.zeros((1,), dtype=torch.float32, device=leaves[0].device)
    for x in leaves:
        acc = acc + censor.sqnorm_batched(x[None])
    return acc[0]


def tree_censor_bank_advance(grads, bank, mask):
    """``ghat + mask * (g - ghat)`` per leaf (B4)."""
    return tree_map(lambda g, h: censor.censor_bank_advance(g, h, mask),
                    grads, bank)


def tree_bank_advance(bank, payload, mask):
    """``ghat + mask * payload`` per leaf (B9)."""
    return tree_map(lambda h, q: censor.bank_advance(h, q, mask),
                    bank, payload)


def tree_int8_roundtrip_ef(pending, err, mask):
    """B7a then B7b per leaf: the per-worker abs-max, the scales
    ``where(amax > 0, amax / 127, 1)`` (``core.quantize.int8_scale``), then
    the payload and the next error-feedback leaf in one pass. Returns
    ``(payload, new_err)`` trees."""
    leaves_p, treedef = tree_flatten(pending)
    outs = [quantize_ef.quantize_ef_batched(
        p, e, mask, int8_scale(quantize_ef.absmax_batched(p)))
        for p, e in zip(leaves_p, tree_leaves(err))]
    return tuple(tree_unflatten(treedef, [o[i] for o in outs])
                 for i in range(2))


def tree_topk_pack_ef(pending, err, keep, mask):
    """B10 per leaf. Returns ``(payload, new_err)`` trees."""
    leaves_p, treedef = tree_flatten(pending)
    outs = [topk_pack.select_pack_ef_batched(p, e, kp, mask)
            for p, e, kp in zip(leaves_p, tree_leaves(err),
                                tree_leaves(keep))]
    return tuple(tree_unflatten(treedef, [o[i] for o in outs])
                 for i in range(2))


def tree_residual_ef(pending, payload, err, mask):
    """``mask*(pending - payload) + (1 - mask)*err`` per leaf (B11)."""
    return tree_map(lambda p, q, e: lowrank_ef.residual_ef_batched(
        p, q, e, mask), pending, payload, err)


def tree_hb_update(params, prev_params, agg, alpha, beta):
    """The eq.-(4) server update per leaf (B3); gd is ``beta = 0``."""
    return tree_map(lambda t, tp, g: hb_update.hb_update(t, g, tp, alpha,
                                                         beta),
                    params, prev_params, agg)


def tree_fold_workers(bank):
    """The worker sum ``sum_m ghat_m`` per leaf, as ``tree_sum_leading``'s
    left fold bit for bit (``fold_workers``)."""
    return tree_map(fused_step.fold_workers, bank)


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


# ---------------------------------------------- single-tensor entry points
def censor_delta_sqnorm(g, ghat, use_pallas: bool = True):
    """() f32 ||g - ghat||^2, both cast to f32 first (B12a)."""
    if use_pallas:
        return censor.censor_delta_sqnorm(g, ghat)
    return ref.censor_delta_sqnorm(g, ghat)


def censor_select(g, ghat, transmit, use_pallas: bool = True):
    """ghat' = transmit ? g : ghat, in ghat's dtype (B12b)."""
    if use_pallas:
        return censor.censor_select(g, ghat, transmit)
    return ref.censor_select(g, ghat, transmit)


def hb_param_update(theta, nabla, theta_prev, alpha, beta,
                    use_pallas: bool = True):
    """The eq.-(4) update (B3); ``alpha``/``beta`` are runtime arguments,
    so a hyperparameter grid builds nothing new."""
    if use_pallas:
        return hb_update.hb_update(theta, nabla, theta_prev, alpha, beta)
    return ref.hb_update(theta, nabla, theta_prev, alpha, beta)


def flash_attention_fwd(q, k, v, causal: bool = True, window=None,
                        q_block: int = 512, kv_block: int = 512,
                        use_pallas: bool = True):
    """Attention forward, q (B, H, Lq, d), k/v (B, K, S, d) (B14).

    ``q_block`` and ``kv_block`` are accepted for the JAX signature and
    unused: the CUDA kernel picks its own tiles and takes any Lq and S.
    """
    del q_block, kv_block
    if use_pallas:
        return flash_attention.flash_attention(q, k, v, causal=causal,
                                               window=window)
    return ref.flash_attention_fwd(q, k, v, causal=causal, window=window)
