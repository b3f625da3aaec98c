"""B3: the eq.-(4) heavy-ball update of one parameter leaf, on the card.

Wraps ``csrc/hb_update.cu`` (port of ``repro/kernels/hb_update.py``). The
staged kernel step and ``ComposedOptimizer.apply_server`` run it on the
``cuda`` backend. ``alpha``/``beta`` reach the kernel as runtime
arguments, so no hyperparameter value is compiled into it. CPU tensors
run ``ref.hb_update``; CUDA tensors launch the kernel.
"""
from __future__ import annotations

import torch

from . import ref
from .build import launch
from .censor import _ptr
from .common import count_launch, fused_suffix, on_card


def hb_update(theta: torch.Tensor, nabla: torch.Tensor,
              theta_prev: torch.Tensor, alpha, beta) -> torch.Tensor:
    """``(theta - alpha*nabla) + beta*(theta - theta_prev)`` in one pass.

    In ``common.compute_dtype(theta.dtype)``, cast once to theta's dtype:
    the result equals ``ref.hb_update`` bit for bit, and, for f32 and f64
    leaves (their own compute dtype), ``opt.server.HeavyBall.apply``.
    theta and theta_prev share one dtype P, nabla (the worker sum) has the
    bank dtype H, a pair of ``common.FUSED_DTYPES``.
    """
    name = "hb_update"
    shapes = [tuple(x.shape) for x in (theta, nabla, theta_prev)]
    if len(set(shapes)) != 1:
        raise ValueError(f"{name}: theta, nabla and theta_prev must share "
                         f"one shape, got {shapes}")
    suffix = fused_suffix(name, (theta, theta_prev), nabla, what="theta")
    n = theta.numel()
    if n == 0:
        return theta
    if not on_card(name, theta, nabla, theta_prev):
        return ref.hb_update(theta, nabla, theta_prev, alpha, beta)
    out = torch.empty_like(theta)
    count_launch(name)
    launch("hb_update", f"{name}_{suffix}", theta.device, _ptr(theta),
           _ptr(nabla), _ptr(theta_prev), _ptr(out), n, float(alpha),
           float(beta))
    return out
