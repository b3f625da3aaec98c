"""The sweep engine: a whole ``ConfigGrid`` of Algorithm-1 runs (port of
``repro.sweep.engine``).

The engine partitions the grid by its static axes (num_workers, quantize,
seed, a named ``algo`` and which of its optional axes a named point sets;
plus eps1 under ``per_tensor`` granularity, whose byte accounting needs a
host-scalar threshold), builds each partition's task once, and runs the
partition's points one after another on the task's device.

The JAX package compiles one program a partition and maps it over the
points' (alpha, beta, eps1) as traced scalars. PyTorch runs eagerly, so
there is nothing to compile: each point is built exactly as a user would
build it, from host floats (``opt.make_for_point`` for a named point,
``ComposedOptimizer.with_hparams`` on the template otherwise), and runs
``simulator.trajectory``. So **every point equals ``simulator.run`` of its
optimizer bit for bit** on the same device, and launches the same
kernels. (A tensor alpha, beta or eps1 would send the stages down their
branch-free forms, which are not ``simulator.run``'s code.)
``obs.compile_log`` ticks ``sweep/partition`` once a partition, so
``num_programs`` keeps its JAX meaning.

Seeds: several ``seed`` values need a ``task_factory(seed, num_workers)
-> FedTask``; each distinct seed is its own partition.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np
import torch

from .. import opt as opt_mod
from ..core import simulator
from ..core.simulator import FedTask, History, task_to
from ..device import resolve_device
from ..obs import compile_log
from ..opt import ComposedOptimizer, DenseTransport, Eq8Censor, HeavyBall, \
    NeverCensor
from ..tree import tree_leaves
from .grid import ConfigGrid, GridPoint

TaskFactory = Callable[[int, int], FedTask]


def _leading_dim(task: FedTask) -> int:
    return tree_leaves(task.worker_data)[0].shape[0]


def _base_optimizer(base_cfg, m: int) -> ComposedOptimizer:
    """The partition's template composition (num_workers not yet bound)."""
    if base_cfg is None:
        return ComposedOptimizer(
            censor=NeverCensor(), transport=DenseTransport(),
            server=HeavyBall(0.0, 0.0), num_workers=m)
    if not isinstance(base_cfg, ComposedOptimizer):
        raise TypeError(
            "base_cfg must be a ComposedOptimizer; other optimizers have "
            "no sweepable (alpha, beta, eps1) hooks: "
            f"{type(base_cfg).__name__}")
    return base_cfg


def _named_axes(p: GridPoint) -> tuple[bool, bool]:
    """Which optional axes a named-``algo`` point set.

    ``GridPoint``'s 0.0 defaults mean "unset" for named points: the axis
    is left out of the builder call so the algorithm's registered default
    applies (``GridPoint(algo="chb")`` runs the paper's chb). The flags are
    part of the partition key, as in the JAX package.
    """
    return (p.beta != 0.0, p.eps1 != 0.0)


def _point_optimizer(p: GridPoint, m: int, base_cfg) -> ComposedOptimizer:
    """The optimizer a grid point describes, from host floats.

    A named point builds through the registry (with the template's
    backend when there is a template); a continuum point rebinds the
    template's hyperparameters, reusing the template's transport when it
    is already the point's kind (so a ``TopKTransport(k=...)`` keeps its
    k).
    """
    if p.algo is not None:
        beta_set, eps_set = _named_axes(p)
        kw: dict[str, Any] = {"quantize": p.quantize, "seed": p.seed}
        if base_cfg is not None:
            kw["backend"] = _base_optimizer(base_cfg, m).backend
        if beta_set:
            kw["beta"] = p.beta
        if eps_set:
            kw["eps1"] = p.eps1
        return opt_mod.make_for_point(p.algo, p.alpha, m, **kw)
    base = _base_optimizer(base_cfg, m)
    if getattr(base.transport, "mode", None) == p.quantize:
        transport = base.transport
    else:
        transport = opt_mod.make_transport(p.quantize)
    o = dataclasses.replace(base, num_workers=m, transport=transport)
    return o.with_hparams(alpha=p.alpha, beta=p.beta, eps1=p.eps1)


def run_sweep(grid: Union[ConfigGrid, Sequence[GridPoint]],
              task: Optional[FedTask] = None, *,
              num_iters: int,
              task_factory: Optional[TaskFactory] = None,
              base_cfg=None,
              vectorize: bool = False,
              collect_metrics: bool = False,
              device=None) -> "SweepResult":
    """Run every grid point, partition by partition.

    Args:
      grid: a ``ConfigGrid`` or an explicit sequence of ``GridPoint``s.
      task: the shared ``FedTask`` when the grid has a single seed.
      num_iters: iterations K of every point.
      task_factory: ``(seed, num_workers) -> FedTask``; needed when the
        grid sweeps seeds, or worker counts beyond the shared task's.
      base_cfg: template ``ComposedOptimizer`` for the choices outside the
        grid's axes (granularity, backend, censor family, a transport
        instance); its alpha/beta/eps1/num_workers/quantize are set per
        point.
      vectorize: not ported: raises ``NotImplementedError`` (ROADMAP.md
        A8b). The JAX package's ``vmap`` mode batches the points' matmuls
        and is documented as inexact.
      collect_metrics: record each point's per-round MetricBag in its
        ``History.metrics`` (``simulator.trajectory``); no other field
        changes and no extra kernel launches.
      device: ``None`` runs on CUDA and raises without it; ``"cpu"`` is
        the explicit CPU opt-in. Every task is moved there.
    Returns:
      A ``SweepResult`` with one ``History`` per point, in grid order, on
      the device (at model width the final states dominate its memory).
    """
    if vectorize:
        raise NotImplementedError(
            "run_sweep(vectorize=True) is not ported (ROADMAP.md A8b); "
            "the default runs each point bit for bit as simulator.run")
    if task is None and task_factory is None:
        raise ValueError("need a task or a task_factory")
    dev = resolve_device(device)
    m_default = _leading_dim(task) if task is not None else None
    if base_cfg is not None and m_default is None:
        m_default = base_cfg.num_workers
    points = grid.points(m_default) if isinstance(grid, ConfigGrid) \
        else tuple(grid)
    if not points:
        raise ValueError("empty grid")

    granularity = "global" if base_cfg is None else \
        getattr(base_cfg, "granularity", "global")

    if base_cfg is not None:
        # a censor without an eps1 hook (adaptive, stochastic, custom)
        # keeps its own thresholds, so a varying eps axis would give N
        # identical runs labeled as distinct points
        base_censor = getattr(base_cfg, "censor", None)
        if base_censor is not None and \
                not isinstance(base_censor, (Eq8Censor, NeverCensor)):
            eps_axis = {p.eps1 for p in points if p.algo is None}
            if len(eps_axis) > 1:
                raise ValueError(
                    f"base_cfg censor {type(base_censor).__name__} has no "
                    "eps1 hook, so the grid's varying eps1 axis "
                    f"({sorted(eps_axis)[:4]}...) would be silently "
                    "ignored; sweep its own threshold via named "
                    "GridPoint(algo=...) points instead")

    groups: dict[tuple, list[int]] = {}
    for i, p in enumerate(points):
        m = p.num_workers if p.num_workers is not None else m_default
        if m is None:
            raise ValueError(
                f"point {i} has no num_workers and no task to infer it from")
        eps_static = p.eps1 if (granularity == "per_tensor"
                                and p.algo is None) else None
        axes = _named_axes(p) if p.algo is not None else None
        groups.setdefault((m, p.quantize, p.seed, p.algo, eps_static, axes),
                          []).append(i)

    if task_factory is None and any(k[2] != 0 for k in groups):
        # a shared task has no seed axis: a non-default seed label would
        # mislabel every result row
        raise ValueError(
            "non-default seeds need a task_factory(seed, num_workers)")

    histories: list[Optional[History]] = [None] * len(points)
    specs: list[Optional[dict]] = [None] * len(points)
    elapsed = 0.0
    for (m, _quant, seed, _algo, _eps, _axes), idxs in groups.items():
        group_task = task_factory(seed, m) if task_factory is not None \
            else task
        if group_task is None or _leading_dim(group_task) != m:
            raise ValueError(
                f"group needs a task with num_workers={m}; pass a "
                "task_factory to sweep worker counts")
        group_task = task_to(group_task, dev)
        opts = [_point_optimizer(points[i], m, base_cfg) for i in idxs]
        for i, o in zip(idxs, opts):
            try:
                specs[i] = opt_mod.to_spec(o)
            except ValueError:
                # a custom stage outside the spec vocabulary still sweeps
                specs[i] = None
        compile_log.record("sweep", "partition")
        t0 = time.perf_counter()
        for i, o in zip(idxs, opts):
            histories[i] = simulator.trajectory(
                o, group_task, num_iters, collect_metrics=collect_metrics)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        elapsed += time.perf_counter() - t0
        del group_task
    return SweepResult(points=points, num_iters=num_iters,
                       histories=tuple(histories), elapsed_s=elapsed,
                       num_programs=len(groups), specs=tuple(specs))


# ---------------------------------------------------------------- results
def _np(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """Each grid point's run and accounting, in grid order.

    Attributes:
      points: the grid points, index-aligned with ``histories``.
      num_iters: K, shared by all points.
      histories: one ``History`` per point, as ``simulator.run`` returns
        it (tensors on the sweep's device).
      elapsed_s: wall-clock seconds of the points' runs (task building
        excluded; the card synchronized at each partition's end).
      num_programs: how many static partitions ran.
      specs: each point's ``repro_torch.opt`` registry spec
        (``opt.from_spec(specs[i])`` rebuilds it), or ``None`` for a
        composition with a stage outside the spec vocabulary.
    """
    points: tuple[GridPoint, ...]
    num_iters: int
    histories: tuple[History, ...]
    elapsed_s: float
    num_programs: int
    specs: tuple[Optional[dict], ...] = ()

    def __len__(self) -> int:
        return len(self.points)

    def history(self, i: int) -> History:
        """Point ``i``'s full ``History`` (``simulator.run``'s layout)."""
        return self.histories[i]

    @property
    def objective(self) -> np.ndarray:
        """(B, K) objective trajectories."""
        return np.stack([_np(h.objective) for h in self.histories])

    @property
    def comm_cum(self) -> np.ndarray:
        """(B, K) cumulative uplink transmissions."""
        return np.stack([_np(h.comm_cum) for h in self.histories])

    @property
    def agg_grad_sqnorm(self) -> np.ndarray:
        """(B, K) ||grad_k||^2 trajectories."""
        return np.stack([_np(h.agg_grad_sqnorm) for h in self.histories])

    @property
    def uplink_bytes(self) -> np.ndarray:
        """(B,) exact cumulative uplink payload bytes per point."""
        return np.asarray([h.final_state.comm.uplink_bytes_exact()
                           for h in self.histories], np.int64)

    def metrics(self, i: int) -> dict:
        """Point ``i``'s ``{name: (K,) tensor}`` MetricBag series; empty
        unless the sweep ran with ``collect_metrics=True``."""
        bags = self.histories[i].metrics
        return dict(bags) if bags else {}

    def metrics_summary(self) -> list[dict]:
        """One ``{name: final float}`` row per point (JSON-ready; empty
        dicts when the sweep collected no metrics)."""
        from ..obs.metrics import summarize
        return [summarize(self.metrics(i)) if self.metrics(i) else {}
                for i in range(len(self.points))]

    def _fstar_for(self, fstar, i: int) -> float:
        if isinstance(fstar, dict):
            return float(fstar[self.points[i].seed])
        fstar = _np(fstar)
        if np.ndim(fstar) == 0:
            return float(fstar)
        return float(fstar[i])

    def frontier(self, fstar, tol: float) -> list[dict]:
        """Per-point communication/accuracy frontier rows.

        Args:
          fstar: optimal value: a scalar, a per-point sequence, or a
            ``{seed: fstar}`` dict for multi-seed sweeps.
          tol: target objective error (``f - f* < tol``).
        Returns:
          One dict per point: its coordinates, ``iters_to_tol`` and
          ``comms_to_tol`` (-1 = never reached), ``total_comms``,
          ``final_err`` and the exact ``uplink_bytes``.
        """
        rows = []
        ub = self.uplink_bytes
        for i, (p, h) in enumerate(zip(self.points, self.histories)):
            fs = self._fstar_for(fstar, i)
            rows.append({
                "index": i,
                "algo": p.algo_name,
                "alpha": p.alpha, "beta": p.beta, "eps1": p.eps1,
                "seed": p.seed, "quantize": p.quantize,
                "num_workers": int(h.mask.shape[1]),
                "iters_to_tol": simulator.iterations_to_accuracy(h, fs, tol),
                "comms_to_tol": simulator.comms_to_accuracy(h, fs, tol),
                "total_comms": int(h.comm_cum[-1]),
                "final_err": float(h.objective[-1]) - fs,
                "uplink_bytes": int(ub[i]),
            })
        return rows

    def to_json(self, path: Optional[str] = None,
                include_trajectories: bool = True,
                fstar=None, tol: Optional[float] = None) -> str:
        """Serialize the sweep (the JAX package's keys).

        Args:
          path: if given, also write the JSON there.
          include_trajectories: include the (B, K) objective and comm
            trajectories (masks are always left out).
          fstar, tol: if both given, a ``frontier`` section is included.
        """
        doc: dict[str, Any] = {
            "num_points": len(self.points),
            "num_iters": self.num_iters,
            "num_programs": self.num_programs,
            "elapsed_s": self.elapsed_s,
            "points": [p._asdict() for p in self.points],
            "specs": list(self.specs),
            "uplink_bytes": self.uplink_bytes.tolist(),
        }
        if include_trajectories:
            doc["objective"] = self.objective.tolist()
            doc["comm_cum"] = self.comm_cum.tolist()
        summary = self.metrics_summary()
        if any(summary):
            doc["metrics"] = summary
        if fstar is not None and tol is not None:
            doc["frontier"] = self.frontier(fstar, tol)
        text = json.dumps(doc, indent=1, sort_keys=True)
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    def to_csv(self, fstar, tol: float, path: Optional[str] = None) -> str:
        """Frontier rows as CSV (a header and one line per point)."""
        rows = self.frontier(fstar, tol)
        cols = ["index", "algo", "alpha", "beta", "eps1", "seed", "quantize",
                "num_workers", "iters_to_tol", "comms_to_tol", "total_comms",
                "final_err", "uplink_bytes"]
        lines = [",".join(cols)]
        for r in rows:
            lines.append(",".join(
                "" if r[c] is None else f"{r[c]:.6e}" if c == "final_err"
                else str(r[c]) for c in cols))
        text = "\n".join(lines) + "\n"
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text
