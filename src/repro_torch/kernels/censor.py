"""B1: the per-worker eq.-(8) norms of one bank leaf, on the card.

Wraps ``csrc/censor.cu`` (port of ``repro/kernels/censor.py``'s
``censor_delta_sqnorm_batched``). CPU tensors run ``ref``'s plain version;
CUDA tensors launch the kernel (see ``common`` for the dispatch rule).
"""
from __future__ import annotations

import torch

from . import ref
from .build import REDUCE_CHUNK, launch
from .common import check_bank, count_launch, on_card


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def censor_delta_sqnorm_batched(g: torch.Tensor, ghat: torch.Tensor
                                ) -> torch.Tensor:
    """(M,) f32 ``sum_j (g[m, j] - ghat[m, j])^2`` of one (M, ...) leaf.

    The subtraction runs in the bank dtype and the sum in f32, in a fixed
    order: two launches give the same bits, and the M=1 call on one
    worker equals that worker's entry of the batched call.
    """
    name = "censor_delta_sqnorm_batched"
    if g.shape != ghat.shape or g.dim() < 1:
        raise ValueError(f"{name}: g {tuple(g.shape)} and ghat "
                         f"{tuple(ghat.shape)} must be one (M, ...) shape")
    suffix = check_bank(name, g, ghat)
    m, n = g.shape[0], g[0].numel()
    if n == 0:
        return torch.zeros((m,), dtype=torch.float32, device=g.device)
    if not on_card(name, g, ghat):
        return ref.censor_delta_sqnorm_batched(g, ghat)
    nchunks = -(-n // REDUCE_CHUNK)
    part = torch.empty((m, nchunks), dtype=torch.float32, device=g.device)
    out = torch.empty((m,), dtype=torch.float32, device=g.device)
    count_launch(name)
    launch("censor", f"{name}_{suffix}", g.device, _ptr(g), _ptr(ghat),
           _ptr(part), _ptr(out), m, n, nchunks)
    return out
