"""B11: the low-rank transport's error-feedback residual, on the card.

Wraps ``csrc/lowrank_ef.cu`` (port of ``repro/kernels/lowrank_ef.py``).
The PowerSGD factor products stay plain PyTorch (``opt.transport``); given
the reconstruction, one pass per leaf computes
``mask*(pending - payload) + (1 - mask)*err``. CPU tensors run
``ref.residual_ef_batched``; CUDA tensors launch the kernel. A bf16
pending leaf takes the payload and err each in bf16 or f32
(``common.EF_DTYPES``: the payload of f32 factors is f32), cast to bf16
first; the result is in the pending dtype, each operation rounded to bf16.
"""
from __future__ import annotations

import torch

from . import ref
from .build import launch
from .censor import _ptr
from .common import check_worker_vector, count_launch, ef_suffix, on_card


def residual_ef_batched(pending: torch.Tensor, payload: torch.Tensor,
                        err: torch.Tensor, mask: torch.Tensor
                        ) -> torch.Tensor:
    """The next EF leaf of one (M, ...) leaf, from one read of each input."""
    name = "residual_ef_batched"
    suffix = ef_suffix(name, pending, payload, err)
    m, n = pending.shape[0], pending[0].numel()
    check_worker_vector(name, "mask", mask, m)
    if n == 0:
        return torch.zeros_like(pending)
    if not on_card(name, pending, payload, err, mask):
        return ref.residual_ef_batched(pending, payload, err, mask)
    new_err = torch.empty_like(pending)
    count_launch(name)
    launch("lowrank_ef", f"{name}_{suffix}", pending.device, _ptr(pending),
           _ptr(payload), _ptr(err), _ptr(mask), _ptr(new_err), m, n)
    return new_err


def residual_ef_row(pending: torch.Tensor, payload: torch.Tensor,
                    err: torch.Tensor) -> torch.Tensor:
    """One worker's EF residual: the batched kernel at M=1 with the
    transmit mask 1, so it equals the batched step's worker slice."""
    one = torch.ones((1,), dtype=torch.float32, device=pending.device)
    return residual_ef_batched(pending[None], payload[None], err[None],
                               one)[0]
