"""Plain PyTorch versions of the kernels (the correctness contract).

A line-for-line port of ``repro/kernels/ref.py`` for B1-B12, in the same
operation order and dtypes, of the attention oracles B13
(``repro/kernels/decode_attention.py:decode_attention_ref``) and B14
(``repro/models/flash.py:reference_attention``), with the same -1e30 mask
value and f32 upcasts, and the port-only ``fold_workers``. One deliberate
difference: the worker sum is a left fold from ``ghat'_0`` (``core.util.tree_sum_leading``), not
``jnp.sum(axis=0)``, because the CUDA kernels fold in that order and must
equal these functions bit for bit on the card. The wrappers in
``censor.py``, ``fused_step.py``, ``hb_update.py``, ``topk_pack.py``,
``lowrank_ef.py``, ``quantize_ef.py``, ``flash_attention.py`` and
``decode_attention.py`` run these on CPU tensors.
"""
from __future__ import annotations

import torch

from ..core.util import scalar_in, sum_leading
from .common import compute_dtype

NEG = -1e30


def censor_delta_sqnorm(g: torch.Tensor, ghat: torch.Tensor) -> torch.Tensor:
    """|| g - ghat ||^2 in f32 (per-tensor partial of the eq.-(8) test);
    both are cast to f32 before the subtraction."""
    d = g.to(torch.float32) - ghat.to(torch.float32)
    return torch.sum(d * d)


def censor_select(g: torch.Tensor, ghat: torch.Tensor,
                  transmit) -> torch.Tensor:
    """ghat' = g where transmitted else ghat (worker-side bank advance)."""
    if isinstance(transmit, torch.Tensor):
        flag = transmit.to(device=ghat.device, dtype=torch.bool)
    else:   # a fill on the device, not a copy from the host (which waits)
        flag = torch.full((), bool(transmit), device=ghat.device)
    return torch.where(flag, g.to(ghat.dtype), ghat)


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


def fold_workers(x: torch.Tensor) -> torch.Tensor:
    """The worker sum of a bank: ``sum_leading``'s left fold from x_0."""
    return sum_leading(x)


# ------------------------------------------------------- attention oracles
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window=None, scale=None
                        ) -> torch.Tensor:
    """Naive attention; q (B, H, Lq, d), k/v (B, K, S, d), H = K*G, kv head
    h // G; masks on absolute positions (qpos = row, kpos = column)."""
    b, h, lq, d = q.shape
    kh, s_len = k.shape[1], k.shape[2]
    g = h // kh
    if scale is None:
        scale = d ** -0.5
    q5 = q.reshape(b, kh, g, lq, d)
    s = torch.einsum("bkgqd,bksd->bkgqs", q5.to(torch.float32),
                     k.to(torch.float32)) * scale
    qpos = torch.arange(lq, device=q.device)[:, None]
    kpos = torch.arange(s_len, device=q.device)[None, :]
    m = torch.ones((lq, s_len), dtype=torch.bool, device=q.device)
    if causal:
        m = m & (kpos <= qpos)
    if window is not None:
        m = m & (kpos > qpos - window)
    s = torch.where(m, s, NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.to(torch.float32))
    return o.reshape(b, h, lq, d).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_pos: torch.Tensor,
                         pos, scale=None) -> torch.Tensor:
    """Single-query attention over a ring cache; q (B, H, d), caches
    (B, K, C, d), slot c valid iff 0 <= cache_pos[c] <= pos."""
    b, h, d = q.shape
    kh = k_cache.shape[1]
    g = h // kh
    if scale is None:
        scale = d ** -0.5
    q4 = q.reshape(b, kh, g, d).to(torch.float32)
    s = torch.einsum("bkgd,bkcd->bkgc", q4,
                     k_cache.to(torch.float32)) * scale
    valid = (cache_pos >= 0) & (cache_pos <= pos)
    s = torch.where(valid[None, None, None, :], s, NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgc,bkcd->bkgd", p, v_cache.to(torch.float32))
    return o.reshape(b, h, d).to(q.dtype)
