"""Blocked (flash) attention with a gradient (port of
``repro/models/flash.py``).

``flash_attention`` is the attention of a training step: a
``torch.autograd.Function``, the counterpart of the JAX package's custom
VJP. The forward returns o and keeps (q, k, v, o, lse), as JAX's ``fwd``
does; the backward computes dq, dk and dv from them and the gradient of o,
as JAX's ``bwd`` does. On the ``cuda`` backend with CUDA tensors the
forward is B14 with its log-sum-exp (``kernels.flash_attention``) and the
backward the port's ``flash_attention_bwd`` kernel
(``kernels.flash_backward``), each in its f32 or bf16 build by q's dtype:
in bf16, o and dq, dk, dv come back in bf16 (one rounding each) and lse
in f32, as JAX's ``fwd`` and ``bwd`` give them. On the ``reference`` backend, and on CPU
tensors, both are the plain versions that follow JAX's blocked
recurrences (``kernels.ref.flash_attention_blocked`` and
``flash_attention_bwd``), in blocks of ``q_block`` query rows and
``kv_block`` keys (the largest divisors of Lq and S up to them); the
kernels pick their own tiles. Tensors on any other device go to the
kernel wrappers, which launch on CUDA tensors or raise.
``reference_attention`` is the naive oracle of the tests.

Shapes: q (B, H, Lq, d), k and v (B, K, S, d), H = K * G; out (B, H, Lq, d).
``q_offset`` puts query row i at position q_offset + i; the kernels take
queries at positions 0 .. Lq - 1 only, so a nonzero offset runs the plain
versions' path alone and raises on the ``cuda`` backend off the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import flash_attention as forward_kernel
from ..kernels import flash_backward as backward_kernel
from ..kernels import ref

BACKENDS = ("cuda", "reference")


class _Flash(torch.autograd.Function):
    """Forward (o, keeping q, k, v, o and the log-sum-exp) and backward
    (dq, dk, dv) of one attention call."""

    @staticmethod
    def forward(ctx, q, k, v, settings):
        causal, window, scale, bq, bk, q_offset, kernels = settings
        if kernels:
            o, lse = forward_kernel.flash_attention(
                q, k, v, causal=causal, window=window, scale=scale,
                return_lse=True)
        else:
            o, lse = ref.flash_attention_blocked(
                q, k, v, causal=causal, window=window, scale=scale,
                q_block=bq, kv_block=bk, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.settings = settings
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, scale, bq, bk, q_offset, kernels = ctx.settings
        if kernels:
            dq, dk, dv = backward_kernel.flash_attention_bwd(
                q, k, v, o, lse, do, causal=causal, window=window,
                scale=scale)
        else:
            dq, dk, dv = ref.flash_attention_bwd(
                q, k, v, o, lse, do, causal=causal, window=window,
                scale=scale, q_block=bq, kv_block=bk, q_offset=q_offset)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, q_block: int = 512,
                    kv_block: int = 512, q_offset: int = 0,
                    backend: str = "cuda") -> torch.Tensor:
    """Blocked attention, q (B, H, Lq, d), k/v (B, K, S, d), H = K * G, masks
    on absolute positions (kpos <= qpos if causal, kpos > qpos - window),
    gradients to q, k and v through autograd."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    b, h, lq, d = q.shape
    if h % k.shape[1]:
        raise ValueError(f"flash_attention: {h} query heads do not group "
                         f"over {k.shape[1]} kv heads")
    if scale is None:
        scale = d ** -0.5
    kernels = backend == "cuda" and q.device.type != "cpu"
    if kernels and q_offset:
        raise NotImplementedError(
            "flash_attention: the kernels take queries at positions 0 .. "
            "Lq - 1; q_offset runs on the reference backend")
    settings = (bool(causal), window, float(scale),
                ref.divisor_block(lq, q_block),
                ref.divisor_block(k.shape[2], kv_block), int(q_offset),
                kernels)
    return _Flash.apply(q, k, v, settings)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """Naive O(L^2) oracle for tests: the scores in f32, the -1e30 mask on
    positions q_offset + i and j, a softmax, in q's dtype."""
    b, h, lq, d = q.shape
    kh, s_len = k.shape[1], k.shape[2]
    g = h // kh
    if scale is None:
        scale = d ** -0.5
    q5 = q.reshape(b, kh, g, lq, d)
    s = torch.einsum("bkgqd,bksd->bkgqs", q5.to(torch.float32),
                     k.to(torch.float32)) * scale
    qpos = q_offset + torch.arange(lq, device=q.device)[:, None]
    kpos = torch.arange(s_len, device=q.device)[None, :]
    m = torch.ones((lq, s_len), dtype=torch.bool, device=q.device)
    if causal:
        m = m & (kpos <= qpos)
    if window is not None:
        m = m & (kpos > qpos - window)
    s = torch.where(m, s, ref.NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.to(torch.float32))
    return o.reshape(b, h, lq, d).to(q.dtype)
