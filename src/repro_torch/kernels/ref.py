"""Plain PyTorch versions of the kernels (the correctness contract).

A line-for-line port of ``repro/kernels/ref.py`` for B1-B11, in the same
operation order and dtypes. One deliberate
difference: the worker sum is a left fold from ``ghat'_0`` (``core.util.tree_sum_leading``), not
``jnp.sum(axis=0)``, because the CUDA kernels fold in that order and must
equal these functions bit for bit on the card. The wrappers in
``censor.py``, ``fused_step.py``, ``hb_update.py``, ``topk_pack.py``,
``lowrank_ef.py`` and ``quantize_ef.py`` run these on CPU tensors.
"""
from __future__ import annotations

import torch

from ..core.util import scalar_in, sum_leading
from .common import compute_dtype


def censor_delta_sqnorm_batched(g: torch.Tensor, ghat: torch.Tensor
                                ) -> torch.Tensor:
    """(M,) per-worker ||g_m - ghat_m||^2; subtraction in the bank dtype,
    f32 accumulation (the reference step's exact recipe)."""
    m = g.shape[0]
    d = (g.to(ghat.dtype) - ghat).to(torch.float32)
    return torch.sum(torch.square(d).reshape(m, -1), dim=1)


def sqnorm_batched(x: torch.Tensor) -> torch.Tensor:
    """(M,) per-worker ||x_m||^2 with f32 accumulation."""
    m = x.shape[0]
    return torch.sum(torch.square(x.to(torch.float32)).reshape(m, -1), dim=1)


def _bcast(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (leaf.dim() - 1)).to(leaf.dtype)


def censor_bank_advance(g: torch.Tensor, ghat: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """ghat + mask * (g - ghat), the arithmetic-mask bank advance."""
    return ghat + _bcast(mask, ghat) * (g.to(ghat.dtype) - ghat)


def bank_advance(ghat: torch.Tensor, payload: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """ghat + mask * payload (pre-encoded payload variant)."""
    return ghat + _bcast(mask, ghat) * payload.to(ghat.dtype)


def absmax_batched(x: torch.Tensor) -> torch.Tensor:
    """(M,) per-worker max |x_m| in ``x.dtype``."""
    m = x.shape[0]
    return torch.amax(torch.abs(x).reshape(m, -1), dim=1)


def quantize_ef_batched(pending: torch.Tensor, err: torch.Tensor,
                        mask: torch.Tensor, scale: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(payload, new_err) of the int8 round trip with error feedback."""
    s = _bcast(scale.to(torch.float32), pending).to(torch.float32)
    q32 = torch.clamp(torch.round(pending.to(torch.float32) / s), -127, 127)
    payload = (q32 * s).to(pending.dtype)
    mk = _bcast(mask, pending)
    new_err = mk * (pending - payload) \
        + (1.0 - mk) * err.to(pending.dtype)
    return payload, new_err


def select_pack_ef_batched(pending: torch.Tensor, err: torch.Tensor,
                           keep: torch.Tensor, mask: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(payload, new_err) of the top-k select/pack + EF sweep.

    The payload is a ``where`` select (not a multiply: ``x * 0`` flips
    negative zeros)."""
    payload = torch.where(keep != 0, pending, torch.zeros_like(pending))
    mk = _bcast(mask, pending)
    new_err = mk * (pending - payload) \
        + (1.0 - mk) * err.to(pending.dtype)
    return payload, new_err


def residual_ef_batched(pending: torch.Tensor, payload: torch.Tensor,
                        err: torch.Tensor, mask: torch.Tensor
                        ) -> torch.Tensor:
    """Masked EF residual: ``mk*(pending - payload) + (1-mk)*err``."""
    mk = _bcast(mask, pending)
    return mk * (pending - payload.to(pending.dtype)) \
        + (1.0 - mk) * err.to(pending.dtype)


def hb_update(theta: torch.Tensor, nabla: torch.Tensor,
              theta_prev: torch.Tensor, alpha, beta) -> torch.Tensor:
    """Eq. (4): (theta - alpha*nabla) + beta*(theta - theta_prev), in
    ``common.compute_dtype``, cast back to the parameter dtype."""
    acc = compute_dtype(theta.dtype)
    a = scalar_in(alpha, acc, theta.device)
    b = scalar_in(beta, acc, theta.device)
    t = theta.to(acc)
    out = (t - a * nabla.to(acc)) + b * (t - theta_prev.to(acc))
    return out.to(theta.dtype)


# -------------------------------------------------- fused-step versions
def fused_dense_step(g: torch.Tensor, ghat: torch.Tensor,
                     theta: torch.Tensor, theta_prev: torch.Tensor,
                     mask: torch.Tensor, alpha, beta):
    """(new_ghat, agg, new_theta): bank advance + eq.-(5) worker sum +
    eq.-(4) update, per leaf."""
    new_ghat = censor_bank_advance(g, ghat, mask)
    agg = sum_leading(new_ghat)
    return new_ghat, agg, hb_update(theta, agg, theta_prev, alpha, beta)


def int8_stats_batched(g: torch.Tensor, ghat: torch.Tensor,
                       err: torch.Tensor):
    """(sqnorms, amax) of the int8 pending delta."""
    pending = (g.to(ghat.dtype) - ghat) + err.to(ghat.dtype)
    return sqnorm_batched(pending), absmax_batched(pending)


def fused_int8_step(g: torch.Tensor, ghat: torch.Tensor, err: torch.Tensor,
                    theta: torch.Tensor, theta_prev: torch.Tensor,
                    mask: torch.Tensor, scale: torch.Tensor, alpha, beta):
    """(new_ghat, new_err, agg, new_theta): int8 round trip + EF blend +
    bank advance + eq.-(5) worker sum + eq.-(4) update, per leaf."""
    pending = (g.to(ghat.dtype) - ghat) + err.to(ghat.dtype)
    payload, new_err = quantize_ef_batched(pending, err, mask, scale)
    new_ghat = bank_advance(ghat, payload, mask)
    agg = sum_leading(new_ghat)
    return (new_ghat, new_err, agg,
            hb_update(theta, agg, theta_prev, alpha, beta))
