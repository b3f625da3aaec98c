"""B7a, B7b: the staged int8 + error-feedback kernels of one pending leaf,
on the card.

Wraps ``csrc/quantize_ef.cu`` (port of ``repro/kernels/quantize_ef.py``'s
``absmax_batched`` and ``quantize_ef_batched``). A staged int8 step runs
B7a for the per-worker abs-max, derives the scales with
``core.quantize.int8_scale``, then B7b for the payload and the next
error-feedback leaf. CPU tensors run ``ref``'s plain versions; CUDA
tensors launch the kernels (see ``common`` for the dispatch rule).

B7a, like B1, B8 and B5, has two designs (``common.sqnorm_path``): two
passes, or one launch for rows of one reduction chunk on many workers;
both give the same bits. B7b has one design for every shape, the tall
tiling of B9 and B4 (a block covers up to 256 columns of several rows).

A bf16 pending leaf runs too: B7a takes its max in f32 (exact) and
returns it in bf16; B7b takes err in bf16 or f32 (``common.EF_DTYPES``),
casts it to bf16, divides in f32 by the f32 scale it is given and rounds
the payload and each operation of the EF blend to bf16, as eager PyTorch
(and ``ref``) does.
"""
from __future__ import annotations

import torch

from . import ref
from .build import ABSMAX_SPAN, launch
from .censor import _ptr, warp_design
from .common import (BLOCK_THREADS, STAGED_DTYPES, check_bank, check_shapes,
                     check_worker_vector, count_launch, ef_suffix,
                     grid_chunks, on_card, sm_count, sqnorm_path)


def absmax_batched(x: torch.Tensor) -> torch.Tensor:
    """(M,) ``max_j |x[m, j]|`` of one (M, ...) leaf, in ``x.dtype``.

    A NaN in a worker's row gives NaN, as ``torch.amax`` does; on the
    same pending it equals B5's abs-max. Of its two designs,
    ``common.sqnorm_path`` picks one by shape, as for B1, B8 and B5; they
    give the same bits (which NaN a NaN row returns aside).
    """
    name = "absmax_batched"
    check_shapes(name, x)
    check_bank(name, x, dtypes=STAGED_DTYPES)
    m, n = x.shape[0], x[0].numel()
    if n == 0:
        return torch.zeros((m,), dtype=x.dtype, device=x.device)
    if not on_card(name, x):
        return ref.absmax_batched(x)
    return absmax_on_card(x, sqnorm_path(m, n, sm_count(x.device.index)))


def absmax_on_card(x: torch.Tensor, path: str) -> torch.Tensor:
    """B7a on a checked CUDA leaf by ``path`` (one of
    ``censor.SQNORM_PATHS``). ``"two_pass"``: one partial per
    ``ABSMAX_SPAN`` elements of a row, then one fold a worker.
    ``"warp"`` (rows of at most ``REDUCE_CHUNK`` elements): one launch, a
    row on a power-of-two segment of a warp's lanes.
    :func:`absmax_batched` takes the path ``common.sqnorm_path`` picks;
    the card's checks call both on one input."""
    name = "absmax_batched"
    m, n = x.shape[0], x[0].numel()
    suffix = STAGED_DTYPES[x.dtype]
    warp = warp_design(name, path, n)    # raises before any allocation
    out = torch.empty((m,), dtype=x.dtype, device=x.device)
    if warp:
        count_launch(name)
        launch("quantize_ef", f"{name}_warp_{suffix}", x.device, _ptr(x),
               _ptr(out), m, n)
        return out
    nspans = grid_chunks(name, x.shape, n, ABSMAX_SPAN, m)
    part = torch.empty((m, nspans), dtype=x.dtype, device=x.device)
    count_launch(name)
    launch("quantize_ef", f"{name}_{suffix}", x.device, _ptr(x), _ptr(part),
           _ptr(out), m, n, nspans)
    return out


def quantize_ef_batched(pending: torch.Tensor, err: torch.Tensor,
                        mask: torch.Tensor, scale: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 round trip and error-feedback update of one (M, ...) leaf,
    in one pass.

    ``scale`` is the (M,) f32 per-worker scale (``core.quantize.int8_scale``
    of :func:`absmax_batched`). Returns ``(payload, new_err)``: the
    dequantized ``clip(rint(f32(p)/s), -127, 127)*s`` in the pending dtype,
    and ``mask*(p - payload) + (1 - mask)*err``; its ``new_err`` equals
    B6's on the same operands. ``err`` is in the pending dtype, or in f32
    on a bf16 pending leaf (``common.EF_DTYPES``); both outputs are in the
    pending dtype. The kernel reads ``scale`` in f32 as the JAX kernel
    does, where ``ref`` (as JAX's ``ref.py``) rounds it to the pending
    dtype first: the two agree on ``int8_scale``'s scales of a bf16
    abs-max, which bf16 holds exactly.
    """
    name = "quantize_ef_batched"
    suffix = ef_suffix(name, pending, err)
    m, n = pending.shape[0], pending[0].numel()
    check_worker_vector(name, "mask", mask, m)
    check_worker_vector(name, "scale", scale, m)
    if n == 0:
        return pending, torch.zeros_like(pending)
    if not on_card(name, pending, err, mask, scale):
        return ref.quantize_ef_batched(pending, err, mask, scale)
    grid_chunks(name, pending.shape, n, BLOCK_THREADS)
    payload = torch.empty_like(pending)
    new_err = torch.empty_like(pending)
    count_launch(name)
    launch("quantize_ef", f"{name}_{suffix}", pending.device, _ptr(pending),
           _ptr(err), _ptr(mask), _ptr(scale), _ptr(payload), _ptr(new_err),
           m, n)
    return payload, new_err
