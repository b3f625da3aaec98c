"""The federated-optimizer protocol (port of ``repro.opt.api``).

Algorithm 1 composes a censor policy (who uploads), a transport (what the
upload carries) and a server update (how theta advances); see
``optimizer.ComposedOptimizer``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch


class OptState(NamedTuple):
    """Optimizer state threaded through every iteration of Algorithm 1.

    Attributes:
      prev_params: theta^{k-1} (the eq.-(4) momentum anchor).
      ghat: (M, ...) stale-gradient bank.
      err: transport state: the (M, ...) error-feedback bank for int8,
        empty (0,) leaves for dense transport.
      comm: split-int32 uplink/downlink counters (``core.accounting``).
      censor: censor-policy state: ``()`` for the stateless policies, the
        (M,) EMA for the adaptive one.
    """
    prev_params: Any
    ghat: Any
    err: Any
    comm: Any
    censor: Any = ()


class StepStats(NamedTuple):
    """Per-iteration diagnostics returned by ``step``."""
    mask: torch.Tensor             # (M,) 1 = worker transmitted
    delta_sq: torch.Tensor         # (M,) ||delta_m||^2
    step_sq: torch.Tensor          # () ||theta^k - theta^{k-1}||^2
    agg_grad_sqnorm: torch.Tensor  # () ||grad_k||^2


class ShardStepStats(NamedTuple):
    """Per-round diagnostics from ``ComposedOptimizer.shard_step``.

    All shard-local ``(M_local,)`` rows. ``mask`` is the raw censor
    decision; ``attempted`` adds the participation gate (what went on the
    air: the byte basis); ``delivered`` adds the channel gate (what the
    bank folded).
    """
    mask: torch.Tensor        # (M_local,) censor pass
    attempted: torch.Tensor   # (M_local,) censor AND participate
    delivered: torch.Tensor   # (M_local,) attempted AND channel pass
    delta_sq: torch.Tensor    # (M_local,) ||delta_m||^2
    step_sq: torch.Tensor     # () ||theta^k - theta^{k-1}||^2


def static_pos(x) -> Optional[bool]:
    """``bool(x > 0)`` for a host scalar; ``None`` for a tensor.

    A tensor hyperparameter is the port's counterpart of a traced JAX
    scalar: stages never branch on its value, they compile the
    branch-free form instead.
    """
    if isinstance(x, torch.Tensor):
        return None
    return bool(x > 0)
