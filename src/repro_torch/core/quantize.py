"""Int8 quantization of transmitted deltas with error feedback (port of
``repro.core.quantize``).

Symmetric int8 with an f32 scale ``where(amax > 0, amax / 127, 1)``: the
division runs in the delta's dtype and the quotient is cast to f32. The
codes round half to even (``torch.round``, like ``jnp.round``).
"""
from __future__ import annotations

import torch

from ..tree import tree_leaves, tree_map


def int8_scale(amax: torch.Tensor) -> torch.Tensor:
    """``where(amax > 0, amax / 127, 1)`` in amax's dtype, then f32.

    The divisor is a tensor, not a Python scalar: on CUDA PyTorch turns
    division by a host scalar into a multiply by its reciprocal, which
    can differ from the quotient by one ulp.
    """
    q = amax / torch.full_like(amax, 127.0)
    return torch.where(amax > 0, q, torch.ones_like(amax)).to(torch.float32)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q_int8, scale)."""
    scale = int8_scale(torch.amax(torch.abs(x)))
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def quantize_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """Q(x) as the value the receiver reconstructs (same dtype as x)."""
    q, s = quantize_int8(x)
    return dequantize_int8(q, s, x.dtype)


def _roundtrip_per_worker(x: torch.Tensor) -> torch.Tensor:
    """Int8 round trip of each worker slice of a leading-M leaf, with one
    scale per worker (the batched form of ``quantize_roundtrip``)."""
    m = x.shape[0]
    bshape = (m,) + (1,) * (x.dim() - 1)
    scale = int8_scale(torch.amax(torch.abs(x.reshape(m, -1)), dim=1))
    s = scale.reshape(bshape)
    q = torch.clamp(torch.round(x.to(torch.float32) / s), -127, 127)
    return dequantize_int8(q.to(torch.int8), s, x.dtype)


def tree_quantize_roundtrip_per_worker(tree):
    """Int8 round trip of a leading-M stacked tree, one scale per worker
    slice: each worker quantizes its own delta."""
    return tree_map(_roundtrip_per_worker, tree)


def payload_bytes_int8(tree) -> int:
    """Uplink bytes for one quantized transmission of this tree."""
    leaves = tree_leaves(tree)
    return sum(x.numel() for x in leaves) + 4 * len(leaves)


def payload_bytes_dense(tree) -> int:
    """Uplink bytes for one unquantized transmission."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))
