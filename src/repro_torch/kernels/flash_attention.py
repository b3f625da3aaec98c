"""B14: the flash-attention forward pass of serving prefill and training,
on the card.

Wraps ``csrc/flash_attention.cu`` (port of
``repro/kernels/flash_attention.py:flash_attention_pallas``).
``models.layers.attention`` runs it on the ``cuda`` backend, once a layer
per prefill; ``models.flash.flash_attention`` once a layer a worker in a
training step, with ``return_lse`` (the log-sum-exp its backward,
``kernels.flash_backward``, reads). CPU tensors run
``ref.flash_attention_fwd``; CUDA tensors
launch the kernel or raise. The kernel reads q, k and v by strides, picks
its own tiles and takes any Lq, S and head dim up to 256. f32 runs the
SIMT design, bf16 the tensor-core (``wgmma``) design. Where
:func:`async_copy_ok` (f32) or :func:`tc_copy_ok` (bf16) holds it copies
its tiles 16 bytes at a time (f32: ``cp.async``; bf16: TMA); otherwise it
loads them element by element.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from .build import ATTENTION_DTYPES, launch
from .common import copy16_ok, count_launch, on_card


def _check(name: str, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor) -> tuple:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: want q (B, H, Lq, d) and k, v (B, K, S, "
                         f"d), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, lq, d = q.shape
    kh, s_len = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or kh == 0 or h % kh:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit k, v "
                         f"{tuple(k.shape)} (H must be a multiple of K)")
    if len({q.dtype, k.dtype, v.dtype}) != 1:
        raise TypeError(f"{name}: q, k and v must share one dtype")
    return b, h, kh, lq, s_len, d


def async_copy_ok(*ts: torch.Tensor) -> bool:
    """Whether the kernel may copy these operands into shared memory 16
    bytes at a time (``cp.async``): float32, a unit last stride, the head
    dim and every other stride a multiple of 4 elements, and each base
    address 16-byte aligned. The model's (B, H, L, d) views of contiguous
    (B, L, H, 64) tensors qualify; d = 33, a view one float off its
    storage's alignment, a non-unit last stride or bf16 take the kernel's
    element-by-element loads."""
    return all(t.dtype == torch.float32 for t in ts) and copy16_ok(ts, 4)


def tc_copy_ok(*ts: torch.Tensor) -> bool:
    """Whether the bf16 (tensor-core) kernel may copy these operands by
    TMA: bfloat16, a unit last stride, the head dim and every other stride
    a multiple of 8 elements (16 bytes), and each base address 16-byte
    aligned. The models' (B, H, L, d) views of contiguous (B, L, H, d)
    tensors at d = 64, 128 and 256 qualify; d = 33, a view off its
    storage's alignment or a non-unit last stride take the same kernel's
    element-by-element loads."""
    return all(t.dtype == torch.bfloat16 for t in ts) and copy16_ok(ts, 8)


def copy_flag(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """The launcher's copy flag: 1 where the kernel of q's dtype may copy
    16 bytes at a time."""
    ok = async_copy_ok if q.dtype == torch.float32 else tc_copy_ok
    return int(ok(q, k, v))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None, scale=None,
                    return_lse: bool = False):
    """Blocked attention: q (B, H, Lq, d), k/v (B, K, S, d) with H = K*G,
    kv head h // G, masks on absolute positions (kpos <= qpos if causal,
    kpos > qpos - window if a window is given). Returns (B, H, Lq, d) in
    q's dtype, computed in f32; with ``return_lse`` the pair (out, lse),
    lse the (B, H, Lq) f32 log-sum-exp ``m + log(max(l, 1e-37))`` of each
    row. Without it the launch passes a null lse pointer and runs the
    kernel serving's prefill always ran."""
    name = "flash_attention"
    b, h, kh, lq, s_len, d = _check(name, q, k, v)
    if scale is None:
        scale = d ** -0.5
    if not on_card(name, q, k, v, contiguous=False):
        return ref.flash_attention_fwd(q, k, v, causal=causal,
                                       window=window, scale=scale,
                                       return_lse=return_lse)
    if q.dtype not in ATTENTION_DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype} is not supported "
                        "(float32 and bfloat16 are)")
    if s_len == 0 or d > 256:
        raise ValueError(f"{name}: needs at least one key and a head dim "
                         f"up to 256, got S={s_len}, d={d}")
    out = torch.empty((b, h, lq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    dims = (ctypes.c_int64 * 22)(
        b, h, kh, lq, s_len, d, *q.stride(), *k.stride(), *v.stride(),
        int(bool(causal)), int(window is not None),
        0 if window is None else int(window), copy_flag(q, k, v))
    count_launch(name)
    launch("flash_attention", f"{name}_{ATTENTION_DTYPES[q.dtype]}",
           q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           out.data_ptr(), None if lse is None else lse.data_ptr(),
           ctypes.addressof(dims), float(scale))
    return (out, lse) if return_lse else out
