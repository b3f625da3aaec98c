"""B10: the top-k transport's select/pack + error-feedback sweep, on the
card.

Wraps ``csrc/topk_pack.cu`` (port of ``repro/kernels/topk_pack.py``).
Given the exact 0/1 keep masks (``opt.transport.tree_topk_keep``, plain
PyTorch), one pass per leaf emits the payload (kept entries verbatim,
``+0.0`` elsewhere: a select, so a kept ``-0.0`` survives) and the next EF
leaf. The pass is tiled over workers and columns alike (B2's tall pass 1),
so a bank of 10^5 narrow rows runs on the whole card. CPU tensors run
``ref.select_pack_ef_batched``; CUDA tensors launch the kernel. A bf16
pending leaf (keep in bf16 too) takes err in bf16 or f32
(``common.EF_DTYPES``), cast to bf16 before the blend, whose operations
each round to bf16.
"""
from __future__ import annotations

import torch

from . import ref
from .build import launch
from .censor import _ptr
from .common import (check_shapes, check_worker_vector, count_launch,
                     ef_suffix, on_card)


def select_pack_ef_batched(pending: torch.Tensor, err: torch.Tensor,
                           keep: torch.Tensor, mask: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(payload, new_err)`` of one (M, ...) leaf from one read of each
    input: ``payload = where(keep != 0, pending, 0)`` and
    ``new_err = mask*(pending - payload) + (1 - mask)*err``. ``keep`` is in
    the pending dtype, ``err`` in it or in f32 on a bf16 pending leaf."""
    name = "select_pack_ef_batched"
    suffix = ef_suffix(name, pending, err)
    check_shapes(name, pending, keep)
    if keep.dtype != pending.dtype:
        raise TypeError(f"{name}: keep must be in the pending dtype "
                        f"{pending.dtype}, got {keep.dtype}")
    m, n = pending.shape[0], pending[0].numel()
    check_worker_vector(name, "mask", mask, m)
    if n == 0:
        return pending, torch.zeros_like(pending)
    if not on_card(name, pending, err, keep, mask):
        return ref.select_pack_ef_batched(pending, err, keep, mask)
    payload = torch.empty_like(pending)
    new_err = torch.empty_like(pending)
    count_launch(name)
    launch("topk_pack", f"{name}_{suffix}", pending.device, _ptr(pending),
           _ptr(err), _ptr(keep), _ptr(mask), _ptr(payload), _ptr(new_err),
           m, n)
    return payload, new_err


def select_pack_ef_row(pending: torch.Tensor, err: torch.Tensor,
                       keep: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """One worker's select/pack + EF: the batched kernel at M=1 with the
    transmit mask 1, so it equals the batched step's worker slice."""
    one = torch.ones((1,), dtype=torch.float32, device=pending.device)
    payload, new_err = select_pack_ef_batched(pending[None], err[None],
                                              keep[None], one)
    return payload[0], new_err[0]
