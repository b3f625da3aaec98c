"""B2, B5, B6: the fused CHB step on the card.

Wraps ``csrc/fused_step.cu`` (port of ``repro/kernels/fused_step.py``). A
composed step is two sweeps per leaf: a reduction feeding the censor
decision (B1 for dense, :func:`int8_stats_batched` for int8), then one
fused pass (:func:`fused_dense_step` / :func:`fused_int8_step`) for the
bank advance, the eq.-(5) worker sum and the eq.-(4) update. CPU tensors
run ``ref``'s plain versions; CUDA tensors launch the kernels.

B2 and B6 have two designs, picked by the bank's shape
(``common.fold_path``): one pass, a thread a column walking the workers,
where the columns fill the card or M is small; and for tall banks (M >> n)
the per-element work on the whole card, then the worker fold per column
tile from shared memory (two launches, one count). Both give the same bits.

``alpha``/``beta`` reach the kernels as runtime arguments, so no
hyperparameter value is compiled into a kernel. Inside
:func:`force_staged` the optimizer runs the staged kernels instead (B1, B4
and B3 for dense; B8, B7a, B7b, B9 and B3 for int8), which give the same
bits with more passes.
"""
from __future__ import annotations

import contextlib

import torch

from . import ref
from .build import REDUCE_CHUNK, launch
from .censor import _ptr
from .common import (KERNEL_DTYPES, check_bank, check_worker_vector,
                     count_launch, fold_path, grid_chunks, on_card, sm_count)

FOLD_PATHS = ("one_pass", "tall")


_FUSION_ENABLED = True


def fusion_enabled() -> bool:
    """Whether the ``cuda`` backend runs dense and int8 on the fused route.

    Read at every step: flipping it changes the steps taken after the flip.
    """
    return _FUSION_ENABLED


@contextlib.contextmanager
def force_staged():
    """Run the staged per-stage kernels instead of the fused ones.

    For A/B comparison: both routes give the same bits at f32 and f64, the
    staged one just moves more bytes.
    """
    global _FUSION_ENABLED
    prev = _FUSION_ENABLED
    _FUSION_ENABLED = False
    try:
        yield
    finally:
        _FUSION_ENABLED = prev


def _check_step(name, g, ghat, theta, theta_prev, *banks):
    shape = tuple(g.shape)
    if g.dim() < 1 or any(tuple(x.shape) != shape for x in (ghat, *banks)):
        raise ValueError(f"{name}: bank operands must share one (M, ...) "
                         f"shape, got {[tuple(x.shape) for x in (g, ghat, *banks)]}")
    if tuple(theta.shape) != shape[1:] or tuple(theta_prev.shape) != shape[1:]:
        raise ValueError(f"{name}: theta and theta_prev must have shape "
                         f"{shape[1:]}")
    return check_bank(name, g, ghat, theta, theta_prev, *banks)


def fused_dense_step(g: torch.Tensor, ghat: torch.Tensor,
                     theta: torch.Tensor, theta_prev: torch.Tensor,
                     mask: torch.Tensor, alpha, beta):
    """Everything after the censor decision for one dense leaf.

    Returns ``(new_ghat, agg, new_theta)``: ``ghat + mask*(g - ghat)``,
    its left-fold worker sum, and ``(t - alpha*agg) + beta*(t - t_prev)``.
    """
    name = "fused_dense_step"
    _check_step(name, g, ghat, theta, theta_prev)
    m, n = g.shape[0], theta.numel()
    check_worker_vector(name, "mask", mask, m)
    if n == 0:
        return ghat.clone(), theta.clone(), theta.clone()
    if not on_card(name, g, ghat, theta, theta_prev, mask):
        return ref.fused_dense_step(g, ghat, theta, theta_prev, mask,
                                    alpha, beta)
    return dense_on_card(g, ghat, theta, theta_prev, mask, alpha, beta,
                         _path(g, m, n))


def _path(g: torch.Tensor, m: int, n: int) -> str:
    return fold_path(m, n, sm_count(g.device.index))


def _launcher(name: str, path: str, dtype: torch.dtype) -> str:
    if path not in FOLD_PATHS:
        raise ValueError(f"{name}: path must be one of {FOLD_PATHS}, got "
                         f"{path!r}")
    tall = "_tall" if path == "tall" else ""
    return f"{name}{tall}_{KERNEL_DTYPES[dtype]}"


def dense_on_card(g, ghat, theta, theta_prev, mask, alpha, beta,
                  path: str):
    """B2 on checked CUDA operands by ``path`` (one of ``FOLD_PATHS``).
    :func:`fused_dense_step` takes the path ``common.fold_path`` picks;
    the card's checks call both on one input."""
    name = "fused_dense_step"
    m, n = g.shape[0], theta.numel()
    new_ghat = torch.empty_like(ghat)
    agg = torch.empty_like(theta)
    new_theta = torch.empty_like(theta)
    fn = _launcher(name, path, g.dtype)
    count_launch(name)
    launch("fused_step", fn, g.device, _ptr(g), _ptr(ghat), _ptr(theta),
           _ptr(theta_prev), _ptr(mask), _ptr(new_ghat), _ptr(agg),
           _ptr(new_theta), m, n, float(alpha), float(beta))
    return new_ghat, agg, new_theta


def int8_stats_batched(g: torch.Tensor, ghat: torch.Tensor,
                       err: torch.Tensor):
    """Per-worker eq.-(8) sqnorms and abs-max of one int8+EF leaf.

    ``pending = (g - ghat) + err`` is recomputed in registers and never
    written. Returns ``(sqnorms, amax)``: (M,) f32 and (M,) in the bank
    dtype (the max is exact, so its order does not matter).
    """
    name = "int8_stats_batched"
    if g.dim() < 1 or not (g.shape == ghat.shape == err.shape):
        raise ValueError(f"{name}: g, ghat and err must share one (M, ...) "
                         "shape")
    suffix = check_bank(name, g, ghat, err)
    m, n = g.shape[0], g[0].numel()
    if n == 0:
        return (torch.zeros((m,), dtype=torch.float32, device=g.device),
                torch.zeros((m,), dtype=ghat.dtype, device=g.device))
    if not on_card(name, g, ghat, err):
        return ref.int8_stats_batched(g, ghat, err)
    nchunks = grid_chunks(name, g.shape, n, REDUCE_CHUNK, m)
    sq_part = torch.empty((m, nchunks), dtype=torch.float32, device=g.device)
    am_part = torch.empty((m, nchunks), dtype=ghat.dtype, device=g.device)
    sq = torch.empty((m,), dtype=torch.float32, device=g.device)
    am = torch.empty((m,), dtype=ghat.dtype, device=g.device)
    count_launch(name)
    launch("fused_step", f"{name}_{suffix}", g.device, _ptr(g), _ptr(ghat),
           _ptr(err), _ptr(sq_part), _ptr(am_part), _ptr(sq), _ptr(am),
           m, n, nchunks)
    return sq, am


def fused_int8_step(g: torch.Tensor, ghat: torch.Tensor, err: torch.Tensor,
                    theta: torch.Tensor, theta_prev: torch.Tensor,
                    mask: torch.Tensor, scale: torch.Tensor, alpha, beta):
    """Everything after the censor decision for one int8+EF leaf.

    ``scale`` is the (M,) f32 per-worker scale from
    :func:`int8_stats_batched`'s abs-max (``core.quantize.int8_scale``).
    Returns ``(new_ghat, new_err, agg, new_theta)``.
    """
    name = "fused_int8_step"
    _check_step(name, g, ghat, theta, theta_prev, err)
    m, n = g.shape[0], theta.numel()
    check_worker_vector(name, "mask", mask, m)
    check_worker_vector(name, "scale", scale, m)
    if n == 0:
        return ghat.clone(), err.clone(), theta.clone(), theta.clone()
    if not on_card(name, g, ghat, err, theta, theta_prev, mask, scale):
        return ref.fused_int8_step(g, ghat, err, theta, theta_prev, mask,
                                   scale, alpha, beta)
    return int8_on_card(g, ghat, err, theta, theta_prev, mask, scale, alpha,
                        beta, _path(g, m, n))


def int8_on_card(g, ghat, err, theta, theta_prev, mask, scale, alpha, beta,
                 path: str):
    """B6 on checked CUDA operands by ``path``, as :func:`dense_on_card`."""
    name = "fused_int8_step"
    m, n = g.shape[0], theta.numel()
    new_ghat = torch.empty_like(ghat)
    new_err = torch.empty_like(err)
    agg = torch.empty_like(theta)
    new_theta = torch.empty_like(theta)
    fn = _launcher(name, path, g.dtype)
    count_launch(name)
    launch("fused_step", fn, g.device, _ptr(g), _ptr(ghat), _ptr(err),
           _ptr(theta), _ptr(theta_prev), _ptr(mask), _ptr(scale),
           _ptr(new_ghat), _ptr(new_err), _ptr(agg), _ptr(new_theta), m, n,
           float(alpha), float(beta))
    return new_ghat, new_err, agg, new_theta
