"""Edge-scenario sweeps: ``repro_torch.fed`` deployment knobs over
synchronous rounds (port of ``repro.sweep.fed_sweep``).

The event-driven runtime (``fed.runner``) follows each client's clock;
this module models the same deployment knobs in synchronous rounds, so a
(loss rate x participation x quorum x seed) grid runs as plain loops over
scenarios and rounds, with the JAX package's semantics and draws:

  * participation -- each client joins the round's cohort with
    probability ``participation`` (i.i.d.);
  * censoring -- cohort members apply the eq.-(8) test against the
    current step norm, as ``opt.step`` does;
  * loss -- each transmission drops with probability ``loss_prob``; a
    dropped uplink costs air bytes and energy but leaves the bank and the
    quorum count untouched (a censored beacon counts toward the quorum);
  * quorum -- theta advances only when ``#arrived >= ceil(quorum *
    #cohort)``; a failed round still folds the delivered deltas into the
    bank but keeps theta. The server update is computed every round and
    selected by the quorum test, as in the JAX package.

Draws: scenario ``seed`` starts from ``PRNGKey(seed)`` (the seed as a
uint32); each round splits the key in three and draws two ``(M,)``
uniforms, in f64 as the JAX package draws them under x64, compared with
the f64 ``participation`` and ``loss_prob`` (``random.py``: the JAX PRNG
bit for bit, drawn on the host and moved to the task's device). So the
participation, transmit, delivered and quorum records equal the JAX
package's.

Kernels: with a ``backend="cuda"`` optimizer each round runs B8 on the
per-worker ``g - ghat`` (the eq.-(8) norms), B9 for the delivered fold,
``fold_workers`` for the worker sum (``tree_sum_leading``'s left fold) and
B3 for the server update: the staged route's arithmetic, so the bits
equal the ``reference`` backend's. Correctness anchor: the ideal scenario
(loss 0, participation 1, quorum 1) equals ``simulator.run`` bit for bit.

``mesh=`` (a ``launch.mesh.ClientMesh`` of K shards) splits the scenarios
into K contiguous blocks, block i run on shard i's device; scenarios are
independent, so the result is the unsharded sweep's bit for bit.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import random as jrandom
from ..core.censoring import delta_sqnorms, step_sqnorm
from ..core.quantize import payload_bytes_dense
from ..core.simulator import FedTask, global_loss, task_to
from ..core.util import tree_sqnorm, tree_stack_zeros, tree_sum_leading
from ..device import resolve_device
from ..fed.energy import EnergyModel
from ..kernels import ops as kernel_ops
from ..opt import AdaptiveCensor
from ..opt.transport import _bcast
from ..tree import tree_leaves, tree_map


class FedScenarioPoint(NamedTuple):
    """One deployment scenario inside a fed sweep.

    Attributes:
      loss_prob: i.i.d. uplink drop probability.
      participation: per-client per-round cohort-join probability.
      quorum: fraction of the cohort that must arrive before theta
        advances.
      seed: PRNG seed of the scenario's participation and loss draws.
    """
    loss_prob: float = 0.0
    participation: float = 1.0
    quorum: float = 1.0
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class FedScenarioGrid:
    """Cartesian product over deployment knobs, enumerated row-major in
    field order."""
    loss_prob: Sequence[float] = (0.0,)
    participation: Sequence[float] = (1.0,)
    quorum: Sequence[float] = (1.0,)
    seed: Sequence[int] = (0,)

    def points(self) -> tuple[FedScenarioPoint, ...]:
        return tuple(
            FedScenarioPoint(float(l), float(p), float(q), int(s))
            for l, p, q, s in itertools.product(
                self.loss_prob, self.participation, self.quorum, self.seed))


def _draws(seed: int, m: int, num_rounds: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """A seed's (R, M) f64 participation and drop uniforms, on the host:
    per round ``key, k_part, k_drop = split(key, 3)`` from
    ``PRNGKey(uint32(seed))``, then one uniform draw per round key (drawn
    for all rounds at once: a batch of keys draws each key's bits)."""
    key = jrandom.PRNGKey(int(seed) & 0xFFFFFFFF, device="cpu")
    round_keys = []
    for _ in range(num_rounds):
        key, k_part, k_drop = jrandom.split(key, 3)
        round_keys.append(torch.stack((k_part, k_drop)))
    u = jrandom.uniform(torch.stack(round_keys), (m,), torch.float64)
    return u[:, 0], u[:, 1]


def run_fed_sweep(opt, task: FedTask, grid, num_rounds: int, *,
                  energy: Optional[EnergyModel] = None,
                  vectorize: bool = False, mesh=None,
                  device=None) -> "FedSweepResult":
    """Sweep deployment scenarios for one algorithm.

    Args:
      opt: the ``repro_torch.opt.ComposedOptimizer`` every scenario runs;
        a dense transport, ``granularity="global"`` and a non-adaptive
        censor (the adaptive EMA's cohort-wide update is ill-defined under
        partial participation).
      task: the distributed problem; its tensors are moved to ``device``.
      grid: a ``FedScenarioGrid`` or a sequence of ``FedScenarioPoint``.
      num_rounds: synchronous server rounds R per scenario.
      energy: radio/compute energy model (``fed.EnergyModel()`` default).
      vectorize: not ported; raises ``NotImplementedError`` (ROADMAP.md
        A8b).
      mesh: optional ``launch.mesh.ClientMesh``: scenario block i (of K
        contiguous blocks; the point count must divide by K) runs on
        ``mesh.devices[i]``, and ``device`` is then not used.
      device: ``None`` runs on CUDA and raises without it; ``"cpu"`` is
        the explicit CPU opt-in.
    Returns:
      A ``FedSweepResult`` (numpy, on the host).
    """
    if getattr(opt, "censor", None) is None or \
            getattr(opt, "server", None) is None:
        raise TypeError(
            "run_fed_sweep drives the censor/server stages directly, so "
            "it needs a ComposedOptimizer (or an optimizer exposing those "
            f"stage attributes), not {type(opt).__name__}")
    if opt.quantize is not None:
        raise NotImplementedError("fed sweep supports dense transport only")
    if opt.granularity != "global":
        raise NotImplementedError("fed sweep supports granularity='global'")
    if isinstance(opt.censor, AdaptiveCensor):
        raise NotImplementedError("fed sweep does not cover adaptive mode")
    if vectorize:
        raise NotImplementedError(
            "run_fed_sweep(vectorize=True) is not ported (ROADMAP.md A8b)")
    points = grid.points() if isinstance(grid, FedScenarioGrid) \
        else tuple(grid)
    m = tree_leaves(task.worker_data)[0].shape[0]
    if opt.num_workers != m:
        raise ValueError(f"cfg.num_workers={opt.num_workers} != task M={m}")
    energy = energy if energy is not None else EnergyModel()
    if mesh is None:
        shard_devices = [resolve_device(device)]
    else:
        # scenarios are independent, so sharding the grid is a partition:
        # no fold, each device runs its own contiguous block
        shard_devices = list(mesh.devices)
        if len(points) % len(shard_devices):
            raise ValueError(
                f"grid has {len(points)} points; a {len(shard_devices)}"
                "-shard mesh needs the point count divisible by the shard "
                "count; pad the grid or drop mesh=")
    block = len(points) // len(shard_devices)
    kernels = opt.backend == "cuda"

    draws = {s: _draws(s, m, num_rounds) for s in {p.seed for p in points}}
    recs = []
    for i, dev in enumerate(shard_devices):
        task_dev = task_to(task, dev)
        recs += [_scenario(opt, task_dev, p, draws[p.seed], kernels, dev)
                 for p in points[i * block:(i + 1) * block]]
    obj, gsq, transmit, delivered, participate, met = (
        np.stack([r[j] for r in recs]) for j in range(6))

    # uplink and downlink ship the same dense parameter payload here
    payload = payload_bytes_dense(task.init_params)
    attempted = transmit.astype(np.int64).sum(axis=2)        # (B, R)
    cohort = participate.astype(np.int64).sum(axis=2)
    energy_per_round = energy.round_energy(attempted, cohort, payload)
    return FedSweepResult(
        points=points, num_rounds=num_rounds,
        objective=obj, agg_grad_sqnorm=gsq,
        transmit_mask=transmit, delivered_mask=delivered,
        participate_mask=participate, quorum_met=met,
        comm_cum=np.cumsum(attempted, axis=1),
        delivered_cum=np.cumsum(delivered.astype(np.int64).sum(axis=2),
                                axis=1),
        bytes_cum=np.cumsum(attempted * payload, axis=1),
        energy_cum=np.cumsum(energy_per_round, axis=1),
    )


def _host(x: torch.Tensor) -> np.ndarray:
    """A record on the host; numpy has no bf16, so a bf16 task's objective
    widens to f32 (exactly)."""
    x = x.cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def _scenario(opt, task: FedTask, point: FedScenarioPoint, draws,
              kernels: bool, dev) -> tuple:
    """One scenario's synchronous rounds (one a row of its ``draws``);
    returns its host records ``(objective, agg_sqnorm, transmit,
    delivered, participate, met)``."""
    u_part, u_drop = draws
    num_rounds, m = u_part.shape
    # the comparisons run in f64 on the host, as JAX runs them under x64
    part_draw = (u_part < point.participation).to(torch.float32).to(dev)
    drop_draw = (u_drop < point.loss_prob).to(torch.float32).to(dev)
    quorum = torch.tensor(point.quorum, dtype=torch.float64, device=dev)
    params = task.init_params
    prev = params
    ghat = tree_stack_zeros(params, m)
    cstate = opt.censor.init(m, dev)
    recs = []
    for r in range(num_rounds):
        participate = part_draw[r]
        grads = task.grad_fn(params, task.worker_data)
        delta = tree_map(lambda g, h: g.to(h.dtype) - h, grads, ghat)
        del grads
        dsq = kernel_ops.tree_sqnorms(delta) if kernels \
            else delta_sqnorms(delta)
        ssq = step_sqnorm(params, prev)
        censor_pass, cstate = opt.censor.decide(cstate, dsq, ssq)
        # repro-lint: disable=mask-multiply-select -- both operands are
        # 0/1 masks, so this is a boolean AND, not a payload select
        transmit = participate * censor_pass
        # repro-lint: disable=mask-multiply-select -- 0/1 masks again
        dropped = drop_draw[r] * transmit
        delivered = transmit - dropped
        # deliveries always fold; the quorum gates only the theta update
        if kernels:
            new_ghat = kernel_ops.tree_bank_advance(ghat, delta, delivered)
        else:
            new_ghat = tree_map(
                lambda h, q: h + _bcast(delivered, h) * q.to(h.dtype),
                ghat, delta)
        del delta
        agg = kernel_ops.tree_fold_workers(new_ghat) if kernels \
            else tree_sum_leading(new_ghat)
        upd = opt.apply_server(params, prev, agg)
        arrived = participate - dropped      # beacons count, drops do not
        cohort = torch.sum(participate)
        met = (torch.sum(arrived).to(torch.float64)
               >= torch.ceil(quorum * cohort.to(torch.float64))) \
            & (cohort > 0)
        recs.append((global_loss(task, params), tree_sqnorm(agg), transmit,
                     delivered, participate, met))
        new_params = tree_map(lambda u, t: torch.where(met, u, t),
                              upd, params)
        prev = tree_map(lambda t, tp: torch.where(met, t, tp), params, prev)
        params, ghat = new_params, new_ghat
        del upd, agg
    obj, gsq, tx, dl, pa, mt = (_host(torch.stack(c)) for c in zip(*recs))
    return (obj, gsq, tx.astype(np.int8), dl.astype(np.int8),
            pa.astype(np.int8), mt)


@dataclasses.dataclass(frozen=True)
class FedSweepResult:
    """Per-scenario synchronous-round trajectories and edge accounting.

    Attributes:
      points: scenario coordinates, index-aligned with every array.
      num_rounds: R.
      objective: (B, R) f(theta^k) before each round's update.
      agg_grad_sqnorm: (B, R) ||sum_m ghat_m||^2 at each update.
      transmit_mask / delivered_mask / participate_mask: (B, R, M) int8
        (attempted uplink / survived the channel / joined the cohort).
      quorum_met: (B, R) whether the round's theta update was applied.
      comm_cum / delivered_cum: (B, R) cumulative attempted / delivered
        uplinks.
      bytes_cum: (B, R) cumulative attempted uplink payload bytes (drops
        still burn air bytes).
      energy_cum: (B, R) cumulative radio joules (tx per attempt, rx per
        cohort member).
    """
    points: tuple[FedScenarioPoint, ...]
    num_rounds: int
    objective: np.ndarray
    agg_grad_sqnorm: np.ndarray
    transmit_mask: np.ndarray
    delivered_mask: np.ndarray
    participate_mask: np.ndarray
    quorum_met: np.ndarray
    comm_cum: np.ndarray
    delivered_cum: np.ndarray
    bytes_cum: np.ndarray
    energy_cum: np.ndarray

    def __len__(self) -> int:
        return len(self.points)

    def frontier(self, fstar: float, tol: float) -> list[dict]:
        """Rounds, uplinks, bytes and joules to accuracy per scenario (-1
        where ``tol`` is never reached), mirroring
        ``fed.edge_metrics_to_accuracy``."""
        rows = []
        for i, p in enumerate(self.points):
            err = self.objective[i] - fstar
            hits = np.nonzero(err < tol)[0]
            if hits.size == 0:
                rec = {"rounds": -1, "uplinks": -1, "bytes": -1,
                       "energy_j": -1.0}
            else:
                k = int(hits[0])
                rec = {"rounds": k,
                       "uplinks": int(self.comm_cum[i, k]),
                       "bytes": int(self.bytes_cum[i, k]),
                       "energy_j": float(self.energy_cum[i, k])}
            rows.append({"index": i, **p._asdict(), **rec,
                         "final_err": float(err[-1])})
        return rows

    def to_json(self, path: Optional[str] = None,
                fstar: Optional[float] = None,
                tol: Optional[float] = None) -> str:
        """Serialize the scenario trajectories (and, given ``fstar`` and
        ``tol``, the frontier)."""
        doc: dict[str, Any] = {
            "num_points": len(self.points),
            "num_rounds": self.num_rounds,
            "points": [p._asdict() for p in self.points],
            "objective": self.objective.tolist(),
            "comm_cum": self.comm_cum.tolist(),
            "bytes_cum": self.bytes_cum.tolist(),
            "energy_cum": self.energy_cum.tolist(),
        }
        if fstar is not None and tol is not None:
            doc["frontier"] = self.frontier(fstar, tol)
        text = json.dumps(doc, indent=1, sort_keys=True)
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text
