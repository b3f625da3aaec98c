"""The flash-attention backward pass of training, on the card (port-only).

Wraps ``csrc/flash_backward.cu``: the backward of ``repro/models/flash.py``'s
custom VJP, which the JAX package leaves to XLA (no Pallas kernel computes
it). ``models.flash.flash_attention`` runs it on the ``cuda`` backend, once
a layer a worker in a training step, after B14 wrote the forward's output
and log-sum-exp. CPU tensors run ``ref.flash_attention_bwd``; CUDA tensors
launch the kernel or raise. The kernel reads its operands by strides,
picks its own tiles and takes any Lq, S and head dim up to 256, float32.
Where :func:`flash_attention.async_copy_ok` holds for an operand it loads
that operand 16 bytes at a time; otherwise element by element.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from .build import launch
from .common import count_launch, on_card
from .flash_attention import _check, async_copy_ok


def _dims(q, k, v, o, do, dq, dk, dv, causal, window) -> ctypes.Array:
    """The launcher's dims: sizes, the eight operands' strides, the masks
    and the bit mask of the operands read 16 bytes at a time (kVecQ, kVecK,
    kVecV, kVecDO in csrc/flash_backward.cu)."""
    b, h, lq, d = q.shape
    kh, s_len = k.shape[1], k.shape[2]
    strides = [st for t in (q, k, v, o, do, dq, dk, dv) for st in t.stride()]
    vec = sum(1 << i for i, t in enumerate((q, k, v, do)) if async_copy_ok(t))
    return (ctypes.c_int64 * 42)(
        b, h, kh, lq, s_len, d, *strides, int(bool(causal)),
        int(window is not None), 0 if window is None else int(window), vec)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window=None, scale=None):
    """(dq, dk, dv) of ``do``, the gradient of the attention output ``o``,
    from the forward's ``lse`` (B14's ``return_lse``): FlashAttention-2's
    equations as ``repro/models/flash.py``'s custom VJP computes them (the
    same masks and -1e30). dq comes back in q's shape and strides, dk and
    dv in k's and v's (``torch.empty_like``). One launch of
    ``flash_attention_bwd`` a call on the card."""
    name = "flash_attention_bwd"
    b, h, kh, lq, s_len, d = _check(name, q, k, v)
    for what, t, shape in (("o", o, q.shape), ("do", do, q.shape),
                           ("lse", lse, (b, h, lq))):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {what} must have shape "
                             f"{tuple(shape)}, got {tuple(t.shape)}")
    if scale is None:
        scale = d ** -0.5
    if not on_card(name, q, k, v, o, lse, do, contiguous=False):
        return ref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                       window=window, scale=scale)
    if {t.dtype for t in (q, k, v, o, do, lse)} != {torch.float32}:
        raise NotImplementedError(
            f"{name}: float32 only (bf16 training is not ported yet: "
            "ROADMAP.md A13, bf16 configs)")
    if s_len == 0 or d > 256:
        raise ValueError(f"{name}: needs at least one key and a head dim "
                         f"up to 256, got S={s_len}, d={d}")
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    dims = _dims(q, k, v, o, do, dq, dk, dv, causal, window)
    count_launch(name)
    launch("flash_backward", "flash_attention_bwd_f32", q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
           do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
           dv.data_ptr(), ctypes.addressof(dims), float(scale))
    return dq, dk, dv
