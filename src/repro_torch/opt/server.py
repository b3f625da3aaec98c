"""Server updates: how theta advances (port of ``repro.opt.server``).

  * :class:`HeavyBall` -- eq. (4):
    ``theta^{k+1} = (theta^k - alpha*grad_k) + beta*(theta^k - theta^{k-1})``.
  * :class:`GradientDescent` -- the beta = 0 case, delegating to the same
    expression so GD and HB(beta=0) are bit-identical.

Each scalar is cast to the parameter leaf's dtype before it multiplies.
The ``metrics()`` hook reports the step scalars in f32 (``repro_torch.obs``
namespaces them ``server/<kind>/<key>``), so a sweep's metric series
names each point's hyperparameters.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.util import scalar_in
from ..tree import tree_map


def scal(s, leaf: torch.Tensor):
    """A config scalar rounded to the leaf's dtype (``core.util.scalar_in``)."""
    return scalar_in(s, leaf.dtype, leaf.device)


def f32(s) -> torch.Tensor:
    """A hyperparameter as a 0-d f32 tensor (a metric value)."""
    return torch.as_tensor(s).to(torch.float32)


def hb_expr(t, g, tp, alpha, beta):
    """Eq. (4) in the order ``(t - alpha*g) + beta*(t - tp)``."""
    return (t - alpha * g) + beta * (t - tp)


@dataclasses.dataclass(frozen=True)
class HeavyBall:
    """The paper's eq.-(4) momentum update."""

    alpha: Any
    beta: Any = 0.0

    def apply(self, params, prev_params, agg):
        return tree_map(
            lambda t, g, tp: hb_expr(t, g.to(t.dtype), tp,
                                     scal(self.alpha, t),
                                     scal(self.beta, t)).to(t.dtype),
            params, agg, prev_params)

    def metrics(self) -> dict:
        return {"alpha": f32(self.alpha), "beta": f32(self.beta)}


@dataclasses.dataclass(frozen=True)
class GradientDescent:
    """Plain distributed GD (eq. 4 with beta = 0)."""

    alpha: Any

    def apply(self, params, prev_params, agg):
        return HeavyBall(self.alpha, 0.0).apply(params, prev_params, agg)

    def metrics(self) -> dict:
        return {"alpha": f32(self.alpha)}
