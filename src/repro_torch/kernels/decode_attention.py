"""B13: single-query (decode) attention over a ring KV cache, on the card.

Wraps ``csrc/decode_attention.cu`` (port of
``repro/kernels/decode_attention.py:decode_attention_pallas``).
``models.layers.decode_attention`` runs it on the ``cuda`` backend, once a
layer per decode step, on the model's (B, C, K, hd) cache seen as
(B, K, C, hd) through a transposed view: the kernel reads k and v by
strides, so no step copies the cache. CPU tensors run
``ref.decode_attention_ref``; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from .build import ATTENTION_DTYPES, DECODE_SLOTS, launch
from .common import count_launch, on_card


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_pos: torch.Tensor, pos, *,
                     scale=None) -> torch.Tensor:
    """q (B, H, d); k_cache, v_cache (B, K, C, d), any strides; cache_pos
    (C,) int32 absolute positions (-1 empty); pos the current position.
    Slot c is valid iff 0 <= cache_pos[c] <= pos. Returns (B, H, d) in q's
    dtype, computed in f32."""
    name = "decode_attention"
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"{name}: want q (B, H, d) and caches (B, K, C, "
                         f"d), got {tuple(q.shape)}, {tuple(k_cache.shape)},"
                         f" {tuple(v_cache.shape)}")
    b, h, d = q.shape
    kh, c = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != b or k_cache.shape[3] != d or kh == 0 or h % kh:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit the "
                         f"caches {tuple(k_cache.shape)}")
    if tuple(cache_pos.shape) != (c,) or cache_pos.dtype != torch.int32:
        raise ValueError(f"{name}: cache_pos must be ({c},) int32, got "
                         f"{tuple(cache_pos.shape)} {cache_pos.dtype}")
    if len({q.dtype, k_cache.dtype, v_cache.dtype}) != 1:
        raise TypeError(f"{name}: q and the caches must share one dtype")
    if scale is None:
        scale = d ** -0.5
    if not on_card(name, q, k_cache, v_cache, cache_pos, contiguous=False):
        return ref.decode_attention_ref(q, k_cache, v_cache, cache_pos, pos,
                                        scale=scale)
    if q.dtype not in ATTENTION_DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype} is not supported "
                        "(float32 and bfloat16 are)")
    if c == 0 or d > 256 or not cache_pos.is_contiguous():
        raise ValueError(f"{name}: needs at least one slot, a head dim up "
                         f"to 256 and a contiguous cache_pos")
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    nchunks = -(-c // DECODE_SLOTS)
    part_ml = torch.empty((b * h, nchunks, 2), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((b * h, nchunks, d), dtype=torch.float32,
                           device=q.device)
    dims = (ctypes.c_int64 * 18)(
        b, h, kh, c, d, *q.stride(), *k_cache.stride(), *v_cache.stride(),
        int(pos), nchunks)
    count_launch(name)
    launch("decode_attention", f"{name}_{ATTENTION_DTYPES[q.dtype]}",
           q.device, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
           cache_pos.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(),
           out.data_ptr(), ctypes.addressof(dims), float(scale))
    return out
