"""Configuration grids for batched CHB experiments (port of
``repro.sweep.grid``).

A :class:`ConfigGrid` is a cartesian product over the CHB family's
hyperparameters: step size alpha, momentum beta, censoring threshold eps1
(absolute, or relative through the paper's eps1 = scale/(alpha^2 M^2)
rule), task seed, quantization mode and worker count M.
``grid.points()`` enumerates it into :class:`GridPoint` tuples, which
``sweep.run_sweep`` runs.

Axes are of two kinds, as in the JAX package: alpha, beta and eps1 vary
inside one partition; quantize, num_workers, seed and a named ``algo``
change the program's structure and split the grid into partitions.

Point order is the row-major cartesian product in field order (alpha,
beta, eps, seed, quantize, num_workers), so results reshape back into the
grid's axes.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import NamedTuple, Optional, Sequence

from ..core.censoring import paper_eps1


class GridPoint(NamedTuple):
    """One concrete experiment configuration inside a sweep.

    Attributes:
      alpha: step size.
      beta: heavy-ball momentum (0 => GD/LAG family).
      eps1: absolute censoring threshold (0 => no censoring). For a named
        ``algo`` the builder may read it otherwise (``csgd`` takes it as
        ``tau0``). For named points, ``beta``/``eps1`` left at their 0.0
        defaults are unset: the algorithm's registered defaults apply
        (``GridPoint(algo="chb")`` runs the paper's chb).
      seed: task seed: selects the task the point runs on (built by the
        sweep's task factory); also passed to the seeded censors of named
        algorithms.
      quantize: ``None`` or a registered transport kind
        (``opt.transport_names()``) at its default hyperparameters.
      num_workers: M, or ``None`` to inherit the task's worker count.
      algo: ``None`` for the eq.-(8)/heavy-ball continuum (gd, hb, lag and
        chb are points of it), or a ``repro_torch.opt`` registry name,
        built through ``opt.make_for_point`` in a partition of its own.
    """
    alpha: float
    beta: float = 0.0
    eps1: float = 0.0
    seed: int = 0
    quantize: Optional[str] = None
    num_workers: Optional[int] = None
    algo: Optional[str] = None

    @property
    def algo_name(self) -> str:
        """gd/hb/lag/chb classification of this point (paper Sec. II), or
        the registry name of a named point."""
        if self.algo is not None:
            return self.algo
        if self.eps1 > 0 and self.beta > 0:
            return "chb"
        if self.eps1 > 0:
            return "lag"
        if self.beta > 0:
            return "hb"
        return "gd"


@dataclasses.dataclass(frozen=True)
class ConfigGrid:
    """Cartesian product over CHB hyperparameters.

    At most one of ``eps1`` (absolute thresholds) or ``eps1_scale``
    (relative: resolved per point as ``scale / (alpha^2 M^2)``, the
    paper's Sec.-IV rule) may be given; omitting both means no censoring.

    Args:
      alpha: step sizes (at least one).
      beta: momentum values.
      eps1: absolute censoring thresholds.
      eps1_scale: relative thresholds (exclusive with ``eps1``).
      seed: task seeds; more than one needs a ``task_factory`` at
        ``run_sweep`` time.
      quantize: transport kinds (``None`` or ``opt.transport_names()``).
      num_workers: worker counts; ``(None,)`` inherits the task's M.
    """
    alpha: Sequence[float]
    beta: Sequence[float] = (0.0,)
    eps1: Optional[Sequence[float]] = None
    eps1_scale: Optional[Sequence[float]] = None
    seed: Sequence[int] = (0,)
    quantize: Sequence[Optional[str]] = (None,)
    num_workers: Sequence[Optional[int]] = (None,)

    def __post_init__(self):
        if self.eps1 is not None and self.eps1_scale is not None:
            raise ValueError("give eps1 or eps1_scale, not both")
        if not self.alpha:
            raise ValueError("alpha axis must have at least one value")
        from ..opt.registry import TRANSPORT_KINDS, transport_names
        for q in self.quantize:
            if q is not None and q not in TRANSPORT_KINDS:
                raise ValueError(f"unknown quantize mode {q!r} (expected "
                                 f"None or one of {transport_names()})")

    def _eps_axis(self) -> Sequence[float]:
        if self.eps1 is not None:
            return self.eps1
        if self.eps1_scale is not None:
            return self.eps1_scale
        return (0.0,)

    @property
    def num_points(self) -> int:
        return (len(self.alpha) * len(self.beta) * len(self._eps_axis())
                * len(self.seed) * len(self.quantize)
                * len(self.num_workers))

    def points(self, default_num_workers: Optional[int] = None
               ) -> tuple[GridPoint, ...]:
        """Enumerate the grid (row-major in declared field order).

        Args:
          default_num_workers: M that resolves ``eps1_scale`` for points
            whose ``num_workers`` is ``None``.
        """
        relative = self.eps1_scale is not None
        out = []
        for a, b, e, s, q, m in itertools.product(
                self.alpha, self.beta, self._eps_axis(), self.seed,
                self.quantize, self.num_workers):
            m_eff = m if m is not None else default_num_workers
            if relative:
                if m_eff is None:
                    raise ValueError(
                        "eps1_scale needs num_workers (in the grid or via "
                        "default_num_workers) to resolve the threshold")
                e = paper_eps1(a, m_eff, e)
            out.append(GridPoint(alpha=float(a), beta=float(b),
                                 eps1=float(e), seed=int(s), quantize=q,
                                 num_workers=m))
        return tuple(out)
