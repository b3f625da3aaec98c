"""Plain PyTorch versions of the kernels (the correctness contract).

A line-for-line port of ``repro/kernels/ref.py`` for B1-B12, in the same
operation order and dtypes, of the attention oracles B13
(``repro/kernels/decode_attention.py:decode_attention_ref``) and B14
(``repro/models/flash.py:reference_attention``), with the same -1e30 mask
value and f32 upcasts, and the port-only ``fold_workers``. One deliberate
difference: the worker sum is a left fold from ``ghat'_0``
(``core.util.sum_leading``: in f32 for a bf16 bank, rounded once, which
gives ``jnp.sum(axis=0)``'s bits there), not ``jnp.sum(axis=0)``, because
the CUDA kernels fold in that order and must equal these functions bit for
bit on the card. The wrappers in
``censor.py``, ``fused_step.py``, ``hb_update.py``, ``topk_pack.py``,
``lowrank_ef.py``, ``quantize_ef.py``, ``flash_attention.py``,
``flash_backward.py`` and ``decode_attention.py`` run these on CPU
tensors. ``flash_attention_blocked`` and ``flash_attention_bwd`` follow
``repro/models/flash.py``'s blocked forward and custom-VJP backward line
for line: the backward is the plain version of the port-only
``flash_attention_bwd`` kernel, and both are what training's
``reference`` backend runs.
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
                        *, causal: bool = True, window=None, scale=None,
                        return_lse: bool = False):
    """Naive attention; q (B, H, Lq, d), k/v (B, K, S, d), H = K*G, kv head
    h // G; masks on absolute positions (qpos = row, kpos = column). With
    ``return_lse`` the pair (out, lse): lse the (B, H, Lq) f32 log-sum-exp
    ``m + log(max(l, 1e-37))`` of each row, as ``repro/models/flash.py``
    keeps it."""
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
    o = o.reshape(b, h, lq, d).to(q.dtype)
    if not return_lse:
        return o
    mx = s.amax(dim=-1)
    lse = mx + torch.log(torch.clamp(
        torch.exp(s - mx[..., None]).sum(dim=-1), min=1e-37))
    return o, lse.reshape(b, h, lq)


def divisor_block(n: int, target: int) -> int:
    """The largest block up to ``target`` that divides ``n`` (``flash.py``'s
    ``_divisor``)."""
    for cand in range(min(target, n), 0, -1):
        if n % cand == 0:
            return cand
    return 1


def _block_mask(qi: int, kj: int, bq: int, bk: int, q_offset: int, causal,
                window, device) -> torch.Tensor:
    """Bool (bq, bk) mask of query block qi against kv block kj
    (``flash.py``'s ``_block_mask``)."""
    qpos = q_offset + qi * bq + torch.arange(bq, device=device)[:, None]
    kpos = kj * bk + torch.arange(bk, device=device)[None, :]
    m = torch.ones((bq, bk), dtype=torch.bool, device=device)
    if causal:
        m = m & (kpos <= qpos)
    if window is not None:
        m = m & (kpos > qpos - window)
    return m


def flash_attention_blocked(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window=None, scale=None, q_block: int = 512,
                            kv_block: int = 512, q_offset: int = 0):
    """(o, lse) of ``flash.py``'s ``_fwd_blocks``: per query block of
    ``divisor_block(Lq, q_block)`` rows, the online softmax over kv blocks
    of ``divisor_block(S, kv_block)`` keys in f32; o in q's dtype, lse
    (B, H, Lq) f32. Query row i sits at position q_offset + i."""
    b, h, lq, d = q.shape
    kh, s_len = k.shape[1], k.shape[2]
    g = h // kh
    if scale is None:
        scale = d ** -0.5
    bq, bk = divisor_block(lq, q_block), divisor_block(s_len, kv_block)
    f32 = torch.float32
    q5 = q.reshape(b, kh, g, lq, d)
    k5, v5 = k[:, :, None], v[:, :, None]
    outs, lses = [], []
    for qi in range(lq // bq):
        qblk = q5[:, :, :, qi * bq:(qi + 1) * bq]
        acc = torch.zeros((b, kh, g, bq, d), dtype=f32, device=q.device)
        m_run = torch.full((b, kh, g, bq), NEG, dtype=f32, device=q.device)
        l_run = torch.zeros((b, kh, g, bq), dtype=f32, device=q.device)
        for kj in range(s_len // bk):
            kblk = k5[:, :, :, kj * bk:(kj + 1) * bk]
            vblk = v5[:, :, :, kj * bk:(kj + 1) * bk]
            s = torch.einsum("...qd,...kd->...qk", qblk.to(f32),
                             kblk.to(f32)) * scale
            mask = _block_mask(qi, kj, bq, bk, q_offset, causal, window,
                               q.device)
            s = torch.where(mask, s, NEG)
            m_new = torch.maximum(m_run, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m_run - m_new)
            l_run = l_run * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "...qk,...kd->...qd", p, vblk.to(f32))
            m_run = m_new
        l_safe = torch.clamp(l_run, min=1e-37)
        outs.append((acc / l_safe[..., None]).to(q.dtype))
        lses.append(m_run + torch.log(l_safe))
    o = torch.cat(outs, dim=3).reshape(b, h, lq, d)
    return o, torch.cat(lses, dim=3).reshape(b, h, lq)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window=None, scale=None,
                        q_block: int = 512, kv_block: int = 512,
                        q_offset: int = 0):
    """(dq, dk, dv) of ``flash.py``'s custom-VJP ``bwd``, line for line:
    D = rowsum(do * o); per query block a scan over the kv blocks for dq,
    per kv block a scan over the query blocks for dk and dv, summed over
    the G query heads of each kv head at the end. Blocks as
    :func:`flash_attention_blocked`'s. dq, dk and dv come back in q's, k's
    and v's dtypes."""
    b, h, lq, d = q.shape
    kh, s_len = k.shape[1], k.shape[2]
    g = h // kh
    if scale is None:
        scale = d ** -0.5
    bq, bk = divisor_block(lq, q_block), divisor_block(s_len, kv_block)
    nq, nk = lq // bq, s_len // bk
    f32 = torch.float32
    q5 = q.reshape(b, kh, g, lq, d)
    k5, v5 = k[:, :, None], v[:, :, None]
    do_f = do.reshape(b, kh, g, lq, d).to(f32)
    lse5 = lse.reshape(b, kh, g, lq)
    delta = torch.sum(do_f * o.reshape(b, kh, g, lq, d).to(f32), dim=-1)

    def rows(x, qi):
        return x[:, :, :, qi * bq:(qi + 1) * bq]

    def keys(x, kj):
        return x[:, :, :, kj * bk:(kj + 1) * bk]

    def probs(qi, kj):
        s = torch.einsum("...qd,...kd->...qk", rows(q5, qi).to(f32),
                         keys(k5, kj).to(f32)) * scale
        mask = _block_mask(qi, kj, bq, bk, q_offset, causal, window,
                           q.device)
        s = torch.where(mask, s, NEG)
        p = torch.exp(s - rows(lse5, qi)[..., None])
        dp = torch.einsum("...qd,...kd->...qk", rows(do_f, qi),
                          keys(v5, kj).to(f32))
        return p, p * (dp - rows(delta, qi)[..., None])

    dq_blocks = []
    for qi in range(nq):
        dq_acc = torch.zeros((b, kh, g, bq, d), dtype=f32, device=q.device)
        for kj in range(nk):
            _, ds = probs(qi, kj)
            dq_acc = dq_acc + scale * torch.einsum(
                "...qk,...kd->...qd", ds, keys(k5, kj).to(f32))
        dq_blocks.append(dq_acc)
    dq = torch.cat(dq_blocks, dim=3).reshape(b, h, lq, d).to(q.dtype)
    dk_blocks, dv_blocks = [], []
    for kj in range(nk):
        dk_acc = torch.zeros((b, kh, g, bk, d), dtype=f32, device=q.device)
        dv_acc = torch.zeros_like(dk_acc)
        for qi in range(nq):
            p, ds = probs(qi, kj)
            dv_acc = dv_acc + torch.einsum("...qk,...qd->...kd", p,
                                           rows(do_f, qi))
            dk_acc = dk_acc + scale * torch.einsum(
                "...qk,...qd->...kd", ds, rows(q5, qi).to(f32))
        dk_blocks.append(dk_acc.sum(dim=2))
        dv_blocks.append(dv_acc.sum(dim=2))
    dk = torch.cat(dk_blocks, dim=2).to(k.dtype)
    dv = torch.cat(dv_blocks, dim=2).to(v.dtype)
    return dq, dk, dv


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
