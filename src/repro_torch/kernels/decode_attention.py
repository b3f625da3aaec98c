"""B13: single-query (decode) attention over a ring KV cache, on the card.

Wraps ``csrc/decode_attention.cu`` (port of
``repro/kernels/decode_attention.py:decode_attention_pallas``).
``models.layers.decode_attention`` runs it on the ``cuda`` backend, once a
layer per decode step, on the model's (B, C, K, hd) cache seen as
(B, K, C, hd) through a transposed view: the kernel reads k and v by
strides, so no step copies the cache. CPU tensors run
``ref.decode_attention_ref``; CUDA tensors launch the kernel or raise.
f32 runs partials of ``DECODE_SLOTS`` slots; bf16 its own design, whose
partials the kernel's library sizes for the card (:func:`plan`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import ref
from .build import ATTENTION_DTYPES, DECODE_SLOTS, launch, launch_query
from .common import copy16_ok, count_launch, on_card


@functools.lru_cache(maxsize=256)
def plan(b: int, h: int, kh: int, c: int, d: int, index: int) -> int:
    """Cache slots of one partial of the bf16 kernel on CUDA device
    ``index``, from the kernel's own launch configuration
    (``decode_attention_bf16_chunk`` in csrc/decode_attention.cu): the
    fewest chunks that fill one wave of resident blocks (the SM count times
    the blocks an SM holds, by the occupancy calculator), spread over the
    (b, kv head, head group) triples, in whole sub-tiles of 32 slots.
    qwen3-4b's last serve_long step (B 8, K 8, G 4, C 2081, d 128) on an
    H100's 132 SMs: 6 blocks an SM, 192 slots, 11 partials. Asked once a
    shape: a decode step's 36-48 calls reuse the answer."""
    dims = (ctypes.c_int64 * 5)(b, h, kh, c, d)
    chunk = ctypes.c_int64(0)
    launch_query("decode_attention", "decode_attention_bf16_chunk", index,
                 ctypes.addressof(dims), ctypes.addressof(chunk))
    return chunk.value


def cache_copy_ok(*ts: torch.Tensor) -> bool:
    """Whether the bf16 kernel may copy these cache views 16 bytes at a
    time: a unit last stride, the head dim and every other stride a
    multiple of 8 elements, 16-byte aligned bases. The models' (B, K, C, d)
    views of contiguous (B, C, K, d) caches qualify."""
    return copy16_ok(ts, 8)


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
    if q.dtype == torch.float32:
        chunk, vec = DECODE_SLOTS, 0
    else:
        chunk = plan(b, h, kh, c, d, q.device.index or 0)
        vec = int(cache_copy_ok(k_cache, v_cache))
    nchunks = -(-c // chunk)
    part_ml = torch.empty((b * h, nchunks, 2), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((b * h, nchunks, d), dtype=torch.float32,
                           device=q.device)
    # the f32 launcher reads the first 18 entries
    dims = (ctypes.c_int64 * 20)(
        b, h, kh, c, d, *q.stride(), *k_cache.stride(), *v_cache.stride(),
        int(pos), nchunks, chunk, vec)
    count_launch(name)
    launch("decode_attention", f"{name}_{ATTENTION_DTYPES[q.dtype]}",
           q.device, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
           cache_pos.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(),
           out.data_ptr(), ctypes.addressof(dims), float(scale))
    return out
