"""B1, B8, B9, B4: the censor kernels of one bank leaf, on the card.

Wraps ``csrc/censor.cu`` (port of ``repro/kernels/censor.py``'s
``censor_delta_sqnorm_batched``, ``sqnorm_batched``, ``bank_advance`` and
``censor_bank_advance``).
CPU tensors run ``ref``'s plain versions; CUDA tensors launch the kernels
(see ``common`` for the dispatch rule).
"""
from __future__ import annotations

import torch

from . import ref
from .build import REDUCE_CHUNK, launch
from .common import check_leaves, check_worker_vector, count_launch, on_card


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _sqnorm_launch(name: str, lib_fn: str, device, ptrs, m: int, n: int
                   ) -> torch.Tensor:
    """Run one two-pass reduction; returns its (M,) f32 result."""
    nchunks = -(-n // REDUCE_CHUNK)
    part = torch.empty((m, nchunks), dtype=torch.float32, device=device)
    out = torch.empty((m,), dtype=torch.float32, device=device)
    count_launch(name)
    launch("censor", lib_fn, device, *ptrs, _ptr(part), _ptr(out), m, n,
           nchunks)
    return out


def censor_delta_sqnorm_batched(g: torch.Tensor, ghat: torch.Tensor
                                ) -> torch.Tensor:
    """(M,) f32 ``sum_j (g[m, j] - ghat[m, j])^2`` of one (M, ...) leaf.

    The subtraction runs in the bank dtype and the sum in f32, in a fixed
    order: two launches give the same bits, and the M=1 call on one
    worker equals that worker's entry of the batched call.
    """
    name = "censor_delta_sqnorm_batched"
    suffix = check_leaves(name, g, ghat)
    m, n = g.shape[0], g[0].numel()
    if n == 0:
        return torch.zeros((m,), dtype=torch.float32, device=g.device)
    if not on_card(name, g, ghat):
        return ref.censor_delta_sqnorm_batched(g, ghat)
    return _sqnorm_launch(name, f"{name}_{suffix}", g.device,
                          (_ptr(g), _ptr(ghat)), m, n)


def sqnorm_batched(x: torch.Tensor) -> torch.Tensor:
    """(M,) f32 ``sum_j x[m, j]^2`` of one (M, ...) pending leaf.

    B1's chunks and tree on ``x`` in place of ``g - ghat``: on
    ``x = g - ghat`` it equals :func:`censor_delta_sqnorm_batched` bit for
    bit, and the M=1 call equals the batched slice.
    """
    name = "sqnorm_batched"
    suffix = check_leaves(name, x)
    m, n = x.shape[0], x[0].numel()
    if n == 0:
        return torch.zeros((m,), dtype=torch.float32, device=x.device)
    if not on_card(name, x):
        return ref.sqnorm_batched(x)
    return _sqnorm_launch(name, f"{name}_{suffix}", x.device, (_ptr(x),),
                          m, n)


def bank_advance(ghat: torch.Tensor, payload: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """``ghat + mask * payload`` of one (M, ...) leaf, in one pass."""
    name = "bank_advance"
    suffix = check_leaves(name, ghat, payload)
    m, n = ghat.shape[0], ghat[0].numel()
    check_worker_vector(name, "mask", mask, m)
    if n == 0:
        return ghat
    if not on_card(name, ghat, payload, mask):
        return ref.bank_advance(ghat, payload, mask)
    out = torch.empty_like(ghat)
    count_launch(name)
    launch("censor", f"{name}_{suffix}", ghat.device, _ptr(ghat),
           _ptr(payload), _ptr(mask), _ptr(out), m, n)
    return out


def censor_bank_advance(g: torch.Tensor, ghat: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """``ghat + mask * (g - ghat)`` of one (M, ...) leaf, in one pass.

    The arithmetic-mask form, not a select (``h + (g - h) != g`` in
    floating point): it equals B2's ``new_ghat`` for the same operands.
    """
    name = "censor_bank_advance"
    suffix = check_leaves(name, g, ghat)
    m, n = ghat.shape[0], ghat[0].numel()
    check_worker_vector(name, "mask", mask, m)
    if n == 0:
        return ghat
    if not on_card(name, g, ghat, mask):
        return ref.censor_bank_advance(g, ghat, mask)
    out = torch.empty_like(ghat)
    count_launch(name)
    launch("censor", f"{name}_{suffix}", ghat.device, _ptr(g), _ptr(ghat),
           _ptr(mask), _ptr(out), m, n)
    return out
