"""Censor policies: who uploads this round (port of ``repro.opt.censor``).

  * :class:`NeverCensor` -- everyone transmits (GD/HB family).
  * :class:`Eq8Censor` -- the paper's eq. (8).
  * :class:`AdaptiveCensor` -- beyond the paper: a relative-novelty EMA
    test.

Each has the batched ``decide(state, delta_sq, step_sq)`` and
``decide_ids(state, delta_sq, step_sq, worker_ids)``, the form
``shard_step`` calls for a shard of workers with absolute ids; all three
read only the norms, so the ids do not change their decisions. The
stochastic (CSGD) policy and the per-client ``client_decide`` of the
event runtime are not ported yet. Decisions are evaluated in the norms'
f32 precision for host-scalar and tensor eps1 alike
(``core.censoring._eps_cast``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.censoring import transmit_mask
from ..device import resolve_device
from .api import static_pos


@dataclasses.dataclass(frozen=True)
class NeverCensor:
    """Every worker transmits every round (classical GD/HB)."""

    def init(self, num_workers: int, device=None):
        return ()

    def decide(self, state, delta_sq, step_sq):
        return torch.ones(delta_sq.shape, dtype=torch.float32,
                          device=delta_sq.device), state

    def decide_ids(self, state, delta_sq, step_sq, worker_ids):
        return self.decide(state, delta_sq, step_sq)


@dataclasses.dataclass(frozen=True)
class Eq8Censor:
    """The paper's skip condition (eq. 8).

    ``eps1`` is a Python float or a 0-d tensor; a tensor takes the
    branch-free form, which decides exactly like the host-scalar branches.
    """

    eps1: Any

    def init(self, num_workers: int, device=None):
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

    def decide_ids(self, state, delta_sq, step_sq, worker_ids):
        # eq. (8) reads only the norms; the shard's ids are irrelevant
        return self.decide(state, delta_sq, step_sq)


@dataclasses.dataclass(frozen=True)
class AdaptiveCensor:
    """Beyond the paper: transmit iff ``||delta_m||^2 > adaptive * EMA_m``.

    A scale-free relative-novelty test. The state is the (M,) f32 EMA of
    each worker's delta norm; a worker whose EMA is still 0 transmits and
    seeds it. The test is elementwise per worker, so a shard holding its
    own EMA slice decides as the whole population would.
    """

    adaptive: float
    decay: float = 0.9

    def init(self, num_workers: int, device=None):
        return torch.zeros((num_workers,), dtype=torch.float32,
                           device=resolve_device(device))

    def decide(self, ema, delta_sq, step_sq):
        warm = ema > 0
        mask = torch.where(warm,
                           (delta_sq > self.adaptive * ema).to(torch.float32),
                           1.0)
        new_ema = torch.where(warm,
                              self.decay * ema
                              + (1 - self.decay) * delta_sq, delta_sq)
        return mask, new_ema

    def decide_ids(self, ema, delta_sq, step_sq, worker_ids):
        return self.decide(ema, delta_sq, step_sq)
