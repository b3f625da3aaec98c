"""B1, B8, B9, B4, B12a, B12b: the censor kernels, on the card.

Wraps ``csrc/censor.cu`` (port of ``repro/kernels/censor.py``'s
``censor_delta_sqnorm_batched``, ``sqnorm_batched``, ``bank_advance`` and
``censor_bank_advance`` of one (M, ...) bank leaf, and of the single-tensor
``censor_delta_sqnorm`` and ``censor_select``).
CPU tensors run ``ref``'s plain versions; CUDA tensors launch the kernels
(see ``common`` for the dispatch rule).
"""
from __future__ import annotations

import torch

from . import ref
from .build import REDUCE_CHUNK, ROW_TILE, SINGLE_DTYPES, launch
from .common import (BLOCK_THREADS, STAGED_DTYPES, check_bank, check_shapes,
                     check_worker_vector, count_launch, fused_suffix,
                     grid_chunks, on_card, sm_count, sqnorm_path)

#: the designs of B1, B8, B5 and B7a (``common.sqnorm_path`` picks one by
#: shape)
SQNORM_PATHS = ("two_pass", "warp")


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _sqnorm_launch(name: str, lib_fn: str, device, ptrs, shape, m: int,
                   n: int) -> torch.Tensor:
    """Run one two-pass reduction; returns its (M,) f32 result."""
    nchunks = grid_chunks(name, shape, n, REDUCE_CHUNK, m)
    part = torch.empty((m, nchunks), dtype=torch.float32, device=device)
    out = torch.empty((m,), dtype=torch.float32, device=device)
    count_launch(name)
    launch("censor", lib_fn, device, *ptrs, _ptr(part), _ptr(out), m, n,
           nchunks)
    return out


def censor_delta_sqnorm_batched(g: torch.Tensor, ghat: torch.Tensor
                                ) -> torch.Tensor:
    """(M,) f32 ``sum_j (g[m, j] - ghat[m, j])^2`` of one (M, ...) leaf.

    g is cast to the bank dtype and the subtraction runs there (a bf16
    bank rounds it to bf16), the sum in f32, in a fixed order: two
    launches give the same bits, and the M=1 call on one worker equals
    that worker's entry of the batched call. The (g, ghat) dtypes are a
    pair of ``common.FUSED_DTYPES``. Of its two designs,
    ``common.sqnorm_path`` picks one by shape; they give the same bits.
    """
    name = "censor_delta_sqnorm_batched"
    check_shapes(name, g, ghat)
    fused_suffix(name, (g,), ghat)
    m, n = g.shape[0], g[0].numel()
    if n == 0:
        return torch.zeros((m,), dtype=torch.float32, device=g.device)
    if not on_card(name, g, ghat):
        return ref.censor_delta_sqnorm_batched(g, ghat)
    return delta_sqnorm_on_card(g, ghat,
                                sqnorm_path(m, n, sm_count(g.device.index)))


def warp_design(name: str, path: str, n: int) -> bool:
    """Whether ``path`` names the warp design of B1, B8, B5 or B7a (``False``:
    the two-pass design). Raises, before any launch, on another name or on
    a row of more than ``REDUCE_CHUNK`` elements for the warp design."""
    if path == "two_pass":
        return False
    if path != "warp" or n > REDUCE_CHUNK:
        raise ValueError(f"{name}: path must be one of {SQNORM_PATHS} (warp "
                         f"for rows of at most {REDUCE_CHUNK} elements), "
                         f"got {path!r} at n={n}")
    return True


def _warp_launch(name: str, lib_fn: str, device, ptrs, m: int,
                 n: int) -> torch.Tensor:
    """Run one warp-design reduction; returns its (M,) f32 result."""
    out = torch.empty((m,), dtype=torch.float32, device=device)
    count_launch(name)
    launch("censor", lib_fn, device, *ptrs, _ptr(out), m, n)
    return out


def delta_sqnorm_on_card(g: torch.Tensor, ghat: torch.Tensor,
                         path: str) -> torch.Tensor:
    """B1 on checked CUDA operands by ``path`` (one of ``SQNORM_PATHS``;
    ``"warp"`` takes rows of at most ``REDUCE_CHUNK`` elements).
    :func:`censor_delta_sqnorm_batched` takes the path
    ``common.sqnorm_path`` picks; the card's checks call both on one
    input."""
    name = "censor_delta_sqnorm_batched"
    m, n = g.shape[0], g[0].numel()
    suffix = fused_suffix(name, (g,), ghat)
    ptrs = (_ptr(g), _ptr(ghat))
    if warp_design(name, path, n):
        return _warp_launch(name, f"{name}_warp_{suffix}", g.device, ptrs,
                            m, n)
    return _sqnorm_launch(name, f"{name}_{suffix}", g.device, ptrs, g.shape,
                          m, n)


def sqnorm_batched(x: torch.Tensor) -> torch.Tensor:
    """(M,) f32 ``sum_j x[m, j]^2`` of one (M, ...) pending leaf.

    B1's designs, chunks and trees on ``x`` in place of ``g - ghat``: on
    ``x = g - ghat`` it equals :func:`censor_delta_sqnorm_batched` bit for
    bit, and the M=1 call equals the batched slice. ``common.sqnorm_path``
    picks the design by shape, as for B1. x is f32, f64 or bf16
    (``common.STAGED_DTYPES``: a bf16 row is squared and summed in f32).
    """
    name = "sqnorm_batched"
    check_shapes(name, x)
    check_bank(name, x, dtypes=STAGED_DTYPES)
    m, n = x.shape[0], x[0].numel()
    if n == 0:
        return torch.zeros((m,), dtype=torch.float32, device=x.device)
    if not on_card(name, x):
        return ref.sqnorm_batched(x)
    return sqnorm_on_card(x, sqnorm_path(m, n, sm_count(x.device.index)))


def sqnorm_on_card(x: torch.Tensor, path: str) -> torch.Tensor:
    """B8 on a checked CUDA leaf by ``path``, as
    :func:`delta_sqnorm_on_card`."""
    name = "sqnorm_batched"
    m, n = x.shape[0], x[0].numel()
    suffix = STAGED_DTYPES[x.dtype]
    if warp_design(name, path, n):
        return _warp_launch(name, f"{name}_warp_{suffix}", x.device,
                            (_ptr(x),), m, n)
    return _sqnorm_launch(name, f"{name}_{suffix}", x.device, (_ptr(x),),
                          x.shape, m, n)


def bank_advance(ghat: torch.Tensor, payload: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """``ghat + mask * payload`` of one (M, ...) leaf, in one pass.

    On the card, one design for every shape: B10's tiling over workers and
    columns (a block covers up to 256 columns of several rows), so a tall
    bank of short rows runs on the whole card and a wide one as the row
    tiles did. (payload, ghat) is a dtype pair of ``common.FUSED_DTYPES``:
    a bf16 bank takes a bf16 or an f32 payload, cast to bf16 first, and
    rounds each operation to bf16.
    """
    name = "bank_advance"
    check_shapes(name, ghat, payload)
    suffix = fused_suffix(name, (payload,), ghat, what="payload")
    m, n = ghat.shape[0], ghat[0].numel()
    check_worker_vector(name, "mask", mask, m)
    if n == 0:
        return ghat
    if not on_card(name, ghat, payload, mask):
        return ref.bank_advance(ghat, payload, mask)
    grid_chunks(name, ghat.shape, n, BLOCK_THREADS)
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
    On the card, B9's one design for every shape (B10's tiling over
    workers and columns), with B4's element operation. (g, ghat) is a
    dtype pair of ``common.FUSED_DTYPES``, as B9's.
    """
    name = "censor_bank_advance"
    check_shapes(name, g, ghat)
    suffix = fused_suffix(name, (g,), ghat, what="g")
    m, n = ghat.shape[0], ghat[0].numel()
    check_worker_vector(name, "mask", mask, m)
    if n == 0:
        return ghat
    if not on_card(name, g, ghat, mask):
        return ref.censor_bank_advance(g, ghat, mask)
    grid_chunks(name, ghat.shape, n, BLOCK_THREADS)
    out = torch.empty_like(ghat)
    count_launch(name)
    launch("censor", f"{name}_{suffix}", ghat.device, _ptr(g), _ptr(ghat),
           _ptr(mask), _ptr(out), m, n)
    return out


# ------------------------------------------------ single-tensor entry points
def _single(name: str, g: torch.Tensor, ghat: torch.Tensor) -> str:
    """g and ghat share one shape, each in f32, f64 or bf16; returns the
    launcher suffix of the pair."""
    if g.shape != ghat.shape:
        raise ValueError(f"{name}: g and ghat must share one shape, got "
                         f"{tuple(g.shape)} and {tuple(ghat.shape)}")
    for t in (g, ghat):
        if t.dtype not in SINGLE_DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype} is not supported "
                            "(float32, float64 and bfloat16 are)")
    return f"{SINGLE_DTYPES[g.dtype]}_{SINGLE_DTYPES[ghat.dtype]}"


def censor_delta_sqnorm(g: torch.Tensor, ghat: torch.Tensor) -> torch.Tensor:
    """() f32 ``sum (float(g) - float(ghat))^2`` of one tensor pair (B12a).

    Both are cast to f32 *before* the subtraction (B1 subtracts in the
    bank dtype). B1's chunks and fixed-order tree at M=1: two launches give
    the same bits.
    """
    name = "censor_delta_sqnorm"
    suffix = _single(name, g, ghat)
    n = g.numel()
    if n == 0:
        return torch.zeros((), dtype=torch.float32, device=g.device)
    if not on_card(name, g, ghat):
        return ref.censor_delta_sqnorm(g, ghat)
    return _sqnorm_launch(name, f"{name}_{suffix}", g.device,
                          (_ptr(g), _ptr(ghat)), g.shape, 1, n).reshape(())


def _flag(name: str, transmit) -> int:
    """The transmit flag as 0/1: a Python bool or int, or a one-element
    bool or integer tensor (the JAX kernel reads it as an int32)."""
    t = torch.as_tensor(transmit)
    if t.numel() != 1 or t.is_floating_point() or t.is_complex():
        raise TypeError(f"{name}: transmit must be one bool or integer, got "
                        f"{t.dtype} of shape {tuple(t.shape)}")
    return int(t.item() != 0)


def censor_select(g: torch.Tensor, ghat: torch.Tensor,
                  transmit) -> torch.Tensor:
    """``ghat' = transmit ? g.to(ghat.dtype) : ghat`` of one tensor (B12b).

    A select, not a mask multiply: -0.0 and NaN on either side come through
    bit for bit. The kernel reads only the side it selects.
    """
    name = "censor_select"
    suffix = _single(name, g, ghat)
    flag = _flag(name, transmit)
    n = ghat.numel()
    if n == 0:
        return ghat
    if not on_card(name, g, ghat):
        return ref.censor_select(g, ghat, flag)
    grid_chunks(name, ghat.shape, n, ROW_TILE)
    out = torch.empty_like(ghat)
    count_launch(name)
    launch("censor", f"{name}_{suffix}", ghat.device, _ptr(g), _ptr(ghat),
           _ptr(out), n, flag)
    return out
