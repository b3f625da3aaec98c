"""The CHB skip-transmission condition, eq. (8) (port of
``repro.core.censoring``).

A worker m transmits at iteration k iff

    || grad_m(theta^k) - grad_m(theta_hat_m^{k-1}) ||^2
        >  eps1 * || theta^k - theta^{k-1} ||^2

with both sides global squared l2 norms over the whole parameter tree.
Also the feasibility checks of eqs. (10)-(14) (pure floats).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..tree import tree_leaves, tree_map
from .util import scalar_in, tree_sqnorm


def _eps_cast(eps1, step_sqnorm: torch.Tensor):
    """Pin eps1 to the norms' dtype (f32) *before* the eq.-(8) product.

    A Python float and an f64 tensor eps1 then decide identically: both
    round once to the norms' dtype, and the product runs in f32.
    """
    return scalar_in(eps1, step_sqnorm.dtype, step_sqnorm.device)


def skip_condition(delta_sqnorm: torch.Tensor, step_sqnorm: torch.Tensor,
                   eps1) -> torch.Tensor:
    """True where the worker is CENSORED (does not transmit). Eq. (8)."""
    return delta_sqnorm <= _eps_cast(eps1, step_sqnorm) * step_sqnorm


def transmit_mask(delta_sqnorm: torch.Tensor, step_sqnorm: torch.Tensor,
                  eps1) -> torch.Tensor:
    """(M,) f32: 1.0 where the worker transmits, 0.0 where censored."""
    return (delta_sqnorm > _eps_cast(eps1, step_sqnorm)
            * step_sqnorm).to(torch.float32)


def delta_sqnorms(delta_stacked) -> torch.Tensor:
    """(M,) per-worker global squared norms of a leading-M stacked tree.

    Per leaf an f32 sum of squares, accumulated leaf by leaf in tree order.
    """
    leaves = tree_leaves(delta_stacked)
    m = leaves[0].shape[0]
    acc = torch.zeros((m,), dtype=torch.float32, device=leaves[0].device)
    for x in leaves:
        acc = acc + torch.sum(
            torch.square(x.to(torch.float32)).reshape(m, -1), dim=1)
    return acc


def paper_eps1(alpha: float, num_workers: int, scale: float = 0.1) -> float:
    """The paper's practical choice eps1 = scale/(alpha^2 M^2) (Sec. IV)."""
    return scale / (alpha ** 2 * num_workers ** 2)


@dataclasses.dataclass(frozen=True)
class FeasibleParams:
    """A parameter triple inside the theoretical region (10)-(12)."""
    alpha: float
    beta: float
    eps1: float
    rate: float  # guaranteed contraction factor c(alpha, beta, eps1)


def theoretical_params(L: float, mu: float, num_workers: int,
                       delta: float = 0.5, rho3: float = 1.0
                       ) -> FeasibleParams:
    """Corner of the feasible region from Appendix C eq. (55).

    With rho3=1, alpha=(1-delta)/L, eta1=(1-alpha L)/(2 alpha):
      beta  = 0.5 * sqrt((1-alpha L)(1-alpha mu))
      eps1  = (1-alpha L)(1-alpha mu) / (4 alpha^2 M^2)
    giving c = alpha*mu = (1-delta)/(L/mu), the order of classical HB.
    """
    if not 0.0 < delta < 1.0:
        raise ValueError("delta must be in (0,1)")
    alpha = (1.0 - delta) / L
    al = alpha * L
    am = alpha * mu
    beta = 0.5 * math.sqrt((1.0 - al) * (1.0 - am))
    eps1 = (1.0 - al) * (1.0 - am) / (4.0 * alpha ** 2 * num_workers ** 2)
    return FeasibleParams(alpha=alpha, beta=beta, eps1=eps1, rate=am)


def check_feasible(alpha: float, beta: float, eps1: float, L: float,
                   num_workers: int, rho3: float = 1.0) -> bool:
    """Check the simplified condition (14)/(43) with eta1=(1-alpha L)/(2 alpha).

    alpha <= 1/L,  beta^2 (1+1/rho3) <= 1 - alpha L,
    eps1 <= ((1-alpha L) - beta^2 (1+1/rho3)) / (alpha^2 (1+rho3) M^2)
    (conservatively using |M_c^k| <= M).
    """
    if alpha > 1.0 / L:
        return False
    slack = (1.0 - alpha * L) - beta ** 2 * (1.0 + 1.0 / rho3)
    if slack < 0:
        return False
    bound = slack / (alpha ** 2 * (1.0 + rho3) * num_workers ** 2)
    return eps1 <= bound + 1e-12


def step_sqnorm(params, prev_params) -> torch.Tensor:
    """|| theta^k - theta^{k-1} ||^2 over the whole tree (f32)."""
    return tree_sqnorm(tree_map(torch.sub, params, prev_params))
