"""Censor policies: who uploads this round (port of ``repro.opt.censor``).

  * :class:`NeverCensor` -- everyone transmits (GD/HB family).
  * :class:`Eq8Censor` -- the paper's eq. (8).

The adaptive and stochastic (CSGD) policies are not ported yet.
Decisions are evaluated in the norms' f32 precision for host-scalar and
tensor eps1 alike (``core.censoring._eps_cast``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.censoring import transmit_mask
from .api import static_pos


@dataclasses.dataclass(frozen=True)
class NeverCensor:
    """Every worker transmits every round (classical GD/HB)."""

    def init(self, num_workers: int):
        return ()

    def decide(self, state, delta_sq, step_sq):
        return torch.ones(delta_sq.shape, dtype=torch.float32,
                          device=delta_sq.device), state


@dataclasses.dataclass(frozen=True)
class Eq8Censor:
    """The paper's skip condition (eq. 8).

    ``eps1`` is a Python float or a 0-d tensor; a tensor takes the
    branch-free form, which decides exactly like the host-scalar branches.
    """

    eps1: Any

    def init(self, num_workers: int):
        return ()

    def decide(self, state, delta_sq, step_sq):
        ones = torch.ones(delta_sq.shape, dtype=torch.float32,
                          device=delta_sq.device)
        pos = static_pos(self.eps1)
        if pos is None:
            eps = torch.as_tensor(self.eps1, device=delta_sq.device)
            mask = torch.where(eps > 0,
                               transmit_mask(delta_sq, step_sq, self.eps1),
                               ones)
        elif pos:
            mask = transmit_mask(delta_sq, step_sq, self.eps1)
        else:
            mask = ones
        return mask, state
