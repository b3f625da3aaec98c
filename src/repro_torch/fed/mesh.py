"""Mesh-sharded synchronous federated runtime: 10^5-10^6 clients a run
(port of ``repro.fed.mesh``).

The event runtime (``fed.runner``) follows each client's clock, which is
exact but walks a host event heap. This module runs the same deployment
knobs as synchronous rounds with the client axis as a sharded leading
axis: every client bank (stale-gradient ``ghat``, EF residual, censor
state, comm counters) lives as per-shard blocks on a 1-D ``("clients",)``
mesh (``launch.mesh.make_client_mesh``), each shard runs its round over
its contiguous client block on its device, and the shards meet at the
server in one fold (``core.distributed.make_client_fold``) of the eq.-(5)
partial aggregates and the quorum and accounting scalars. Nothing
client-sized crosses a shard boundary: the fold moves one parameter-sized
tree and five scalars a shard a round.

The runtime is single-controller, as the JAX package's is: one host loop
runs each shard's round, then the fold and the server update on the
mesh's first device. Shards may share a device (``["cuda:0"] * 8``); the
round semantics do not depend on where a shard runs.

Round semantics are ``sweep.fed_sweep``'s (i.i.d. Bernoulli participation
and uplink loss, censoring by the composed policy, deliveries always
folding into the bank, quorum gating only the theta update), but the
draws are keyed per client by absolute id:
``fold_in(fold_in(fold_in(PRNGKey(seed), round), id), 0 | 1)`` gives the
participation and drop uniforms (f64, as the JAX package draws them under
x64), for a shard's ids in one batched draw. So the masks do not depend
on the shard count. A scenario with participation 1 and loss 0 draws
nothing.

Two exactness anchors (``tests/test_torch_mesh.py``):

  (a) sync anchor: the ideal scenario over ONE shard equals
      ``core.simulator.run`` bit for bit (objective, masks,
      ``agg_grad_sqnorm``, final params, uplink counts), on both backends;
  (b) K-invariance: over K shards every client draws the same
      participation, loss and censor decisions (masks bit-equal for K in
      {1, 2, 8}); floats agree to the ulps of the K-way fold.

A shard's gradients and losses are the task's batched ``grad_fn`` and
``loss_fn`` over its contiguous block, as ``simulator.run`` batches them
over all M; on ``backend="cuda"`` a shard runs ``shard_step``'s staged
kernels and the worker fold kernel (``fold_workers``), the server B3.
Profiler spans (``obs.profile.named_scope``): ``fed.mesh/draws``,
``fed.mesh/shard_step`` and ``fed.mesh/fold_server``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from .. import random as jrandom
from ..core.distributed import make_client_fold
from ..core.simulator import FedTask
from ..core.util import tree_sqnorm
from ..launch.mesh import make_client_mesh
from ..launch.sharding import (client_shard_sizes, per_device_views,
                               replicated, stack_shards)
from ..obs import compile_log
from ..obs.metrics import merge_shard_bags, step_metrics
from ..obs.profile import named_scope
from ..opt import AdaptiveCensor
from ..opt.api import StepStats
from ..tree import tree_leaves, tree_map
from .channel import ChannelConfig
from .clients import Population, VectorPopulation
from .energy import EnergyModel


@dataclasses.dataclass(frozen=True)
class MeshScenario:
    """One deployment scenario for the mesh runtime.

    Same knobs and semantics as ``sweep.fed_sweep.FedScenarioPoint``:
    ``participation`` is the per-client per-round i.i.d. cohort-join
    probability, ``loss_prob`` the i.i.d. uplink drop probability,
    ``quorum`` the arrived fraction gating the theta update, ``seed``
    keys every draw. Draws are folded per (seed, round, client id), so a
    scenario replays identically at any shard count.
    """
    participation: float = 1.0
    loss_prob: float = 0.0
    quorum: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if not 0.0 < self.participation <= 1.0:
            raise ValueError("participation must be in (0, 1]")
        if not 0.0 <= self.loss_prob < 1.0:
            raise ValueError("loss_prob must be in [0, 1)")
        if not 0.0 < self.quorum <= 1.0:
            raise ValueError("quorum must be in (0, 1]")

    @property
    def sync_draws(self) -> bool:
        """True when no participation or loss randomness exists: the rounds
        then draw nothing (quorum is trivially met but still evaluated)."""
        return self.participation >= 1.0 and self.loss_prob == 0.0


class MeshHistory(NamedTuple):
    """Per-round trajectory and cohort accounting of one ``run_mesh``.

    Counts are exact integer sums of {0, 1} indicators (int64 on the
    host); bytes are exact Python-int products of the per-uplink payload.
    """
    objective: np.ndarray        # (R,) f(theta^k) before round k's update
    agg_grad_sqnorm: np.ndarray  # (R,) ||sum_m ghat_m||^2 at the update
    quorum_met: np.ndarray       # (R,) bool: theta advanced this round
    participated: np.ndarray     # (R,) cohort size per round
    attempted: np.ndarray        # (R,) uplinks attempted (censor & cohort)
    delivered: np.ndarray        # (R,) uplinks that survived the channel
    comm_cum: np.ndarray         # (R,) cumulative attempted uplinks
    delivered_cum: np.ndarray    # (R,) cumulative delivered uplinks
    bytes_cum: np.ndarray        # (R,) cumulative attempted payload bytes
    energy_cum: np.ndarray       # (R,) cumulative joules (radio + compute)
    wall_clock: np.ndarray       # (R,) modeled seconds at end of round k
    final_params: Any            # theta^R on the server device
    mask: Optional[np.ndarray] = None     # (R, M) int8 attempted uplinks
    metrics: tuple = ()          # per-round merged MetricBags (host floats)


def _check(opt, task: FedTask, population) -> int:
    """The JAX package's rejections; returns M."""
    if getattr(opt, "censor", None) is None or \
            getattr(opt, "server", None) is None:
        raise TypeError(
            "run_mesh drives the censor/transport stages through "
            "shard_step, so it needs a ComposedOptimizer (or an optimizer "
            f"exposing the stage attributes), not {type(opt).__name__}")
    if opt.granularity != "global":
        raise NotImplementedError("run_mesh supports granularity='global'")
    if isinstance(opt.censor, AdaptiveCensor):
        raise NotImplementedError(
            "run_mesh rejects adaptive censoring (cohort-wide EMA is "
            "ill-defined under partial participation; see fed_sweep)")
    m = tree_leaves(task.worker_data)[0].shape[0]
    if opt.num_workers != m:
        raise ValueError(f"cfg.num_workers={opt.num_workers} != task M={m}")
    if population is not None and population.num_clients != m:
        raise ValueError(
            f"population has {population.num_clients} clients, task has {m}")
    return m


def run_mesh(cfg, task: FedTask, num_rounds: int, *,
             mesh=None,
             scenario: Optional[MeshScenario] = None,
             population: Optional[VectorPopulation] = None,
             channel: Optional[ChannelConfig] = None,
             energy: Optional[EnergyModel] = None,
             collect_mask: bool = True,
             collect_metrics: bool = False,
             donate: bool = False,
             bake_data: bool = True) -> MeshHistory:
    """Run one scenario with the client axis sharded over ``mesh``.

    Args:
      cfg: the ``ComposedOptimizer`` (any transport with a ``shard_step``
        path: dense, int8, top-k, low-rank, on both backends); adaptive
        censoring is rejected, as in ``sweep.fed_sweep`` (its cohort-wide
        EMA is ill-defined under partial participation).
      task: the distributed problem; ``worker_data``'s leading axis M
        must equal ``cfg.num_workers`` and divide into the shard count.
      num_rounds: synchronous server rounds R.
      mesh: a ``launch.mesh.ClientMesh`` (default: ``make_client_mesh(1)``,
        one shard on the first CUDA device, which raises without CUDA).
        Shard i owns the contiguous client block ``[i*M/K, (i+1)*M/K)``
        on ``mesh.devices[i]``; the server state lives on device 0.
      scenario: deployment knobs (default: the ideal sync scenario).
      population: optional columnar per-client compute model
        (``VectorPopulation``, or a ``Population``, converted with
        ``as_vector``) for the wall-clock and compute-energy models; its
        ``participation`` is ignored (``scenario.participation`` draws).
      channel: nominal air interface for the wall-clock model (rates and
        overhead only; ``scenario.loss_prob`` governs drops). Default:
        ideal.
      energy: radio/compute energy model (default ``EnergyModel()``).
      collect_mask: record the (R, M) attempted-uplink rows (turn off at
        10^6 clients to keep host memory flat).
      collect_metrics: one merged ``obs`` MetricBag a round (per-shard
        bags merged by ``obs.metrics.merge_shard_bags`` weighted by the
        shard size, ``agg_grad_sqnorm`` overwritten after the fold).
      donate: accepted for the JAX signature. XLA reuses donated buffers
        across rounds; PyTorch frees a round's tensors when the loop drops
        them, so both values run the same program and give the same bits.
      bake_data: accepted for the JAX signature. XLA folds a shard's data
        into its program as a constant; PyTorch runs eagerly with no
        program to fold it into, so both values run the same program and
        give the same bits.
    Returns:
      A ``MeshHistory``.
    """
    del donate, bake_data    # no PyTorch counterpart (see the docstring)
    opt = cfg
    if isinstance(population, Population):
        population = population.as_vector()
    m = _check(opt, task, population)
    scenario = scenario if scenario is not None else MeshScenario()
    channel = channel if channel is not None else ChannelConfig.ideal()
    energy = energy if energy is not None else EnergyModel()
    mesh = mesh if mesh is not None else make_client_mesh(1)
    m_local = client_shard_sizes(m, mesh)
    devices, k_shards, server = mesh.devices, mesh.size, mesh.server
    compile_log.record("fed.mesh", "run_mesh")

    # ----------------------------------------------------- per-shard data
    data_blocks = per_device_views(task.worker_data, mesh)
    ids_blocks = [torch.arange(i * m_local, (i + 1) * m_local,
                               dtype=torch.int64, device=d)
                  for i, d in enumerate(devices)]
    comp = np.zeros((m,), np.float32) if population is None else \
        np.asarray(population.compute_mean_s, np.float32)
    compw = np.zeros((m,), np.float32) if population is None else \
        np.asarray(population.compute_w, np.float32)
    comp_blocks = per_device_views(torch.from_numpy(comp), mesh)
    compw_blocks = per_device_views(torch.from_numpy(compw), mesh)
    cohort_full = [torch.tensor(m_local, device=d) for d in devices]
    base_keys = [] if scenario.sync_draws else \
        [jrandom.PRNGKey(scenario.seed, device=d) for d in devices]

    opt_local = dataclasses.replace(opt, num_workers=m_local)
    part_p, loss_p = scenario.participation, scenario.loss_prob
    sync_draws = scenario.sync_draws

    # ------------------------------------------------------- shard round
    def shard_round(i, state, params, round_idx):
        data, ids = data_blocks[i], ids_blocks[i]
        grads = task.grad_fn(params, data)
        if sync_draws:
            participate = channel_mask = None
        else:
            with named_scope("fed.mesh/draws"):
                ck = jrandom.fold_in(
                    jrandom.fold_in(base_keys[i], round_idx), ids)
                # keys (m_local, 2, 2): stream 0 participation, 1 the drop
                u = jrandom.uniform(
                    jrandom.fold_in(ck[:, None], torch.arange(2)), (),
                    torch.float64)
                participate = (u[:, 0] < part_p).to(torch.float32)
                channel_mask = (u[:, 1] >= loss_p).to(torch.float32)
        with named_scope("fed.mesh/shard_step"):
            new_state, partial_agg, st = opt_local.shard_step(
                state, params, grads, worker_ids=ids,
                participate=participate, channel_mask=channel_mask)
        del grads
        loss_part = torch.sum(task.loss_fn(params, data))
        comp_s = comp_blocks[i]
        if participate is None:
            n_part = cohort_full[i]
            comp_active = comp_s
        else:
            n_part = torch.sum(participate.to(torch.int32))
            comp_active = torch.where(participate != 0, comp_s, 0.0)
        n_att = torch.sum(st.attempted.to(torch.int32))
        n_del = torch.sum(st.delivered.to(torch.int32))
        wall_local = torch.max(comp_active)
        comp_j = torch.sum(comp_active * compw_blocks[i])
        partials = (partial_agg, loss_part, n_part, n_att, n_del, comp_j)
        row = tree_map(lambda v: v[None], partials)
        bag = None
        if collect_metrics:
            bag = step_metrics(opt_local, new_state, StepStats(
                mask=st.mask, delta_sq=st.delta_sq, step_sq=st.step_sq,
                agg_grad_sqnorm=tree_sqnorm(partial_agg)))
        return new_state, row, st.attempted, wall_local, bag

    # ------------------------------------------------ fold + server update
    fold = make_client_fold(mesh)
    quorum = torch.tensor(scenario.quorum, dtype=torch.float32,
                          device=server)

    def server_round(stacked, params, prev):
        partial_agg, loss_sum, n_part, n_att, n_del, comp_j = fold(stacked)
        # beacons count toward quorum, drops do not: arrived =
        # participated - (attempted - delivered), as in fed_sweep; the
        # threshold in f32, as the JAX package evaluates it
        arrived = n_part - (n_att - n_del)
        met = (arrived.to(torch.float32)
               >= torch.ceil(quorum * n_part.to(torch.float32))) \
            & (n_part > 0)
        upd = opt.apply_server(params, prev, partial_agg)
        new_params = tree_map(lambda u, t: torch.where(met, u, t),
                              upd, params)
        new_prev = tree_map(lambda t, tp: torch.where(met, t, tp),
                            params, prev)
        return (new_params, new_prev, met, loss_sum,
                tree_sqnorm(partial_agg), n_part, n_att, n_del, comp_j)

    # ------------------------------------------------------- init + loop
    params_rep = replicated(task.init_params, mesh)
    prev_rep = tree_map(torch.clone, params_rep)
    states = [opt_local.init(p) for p in
              per_device_views(params_rep, mesh, replicated=True)]

    payload = opt.transport.payload_bytes(task.init_params)
    uplink_air = 0.0
    if np.isfinite(channel.uplink_rate_bps):
        uplink_air = channel.overhead_s + 8.0 * payload / \
            channel.uplink_rate_bps
    downlink_air = channel.downlink_time(payload)

    objective, gsq_hist, met_hist = [], [], []
    n_part_h, n_att_h, n_del_h = [], [], []
    wall, energy_cum, t, joules = [], [], 0.0, 0.0
    mask_rows: list[np.ndarray] = []
    bags: list[dict] = []

    for k in range(num_rounds):
        views = per_device_views(params_rep, mesh, replicated=True)
        outs = [shard_round(i, states[i], views[i], k)
                for i in range(k_shards)]
        with named_scope("fed.mesh/fold_server"):
            stacked = stack_shards([o[1] for o in outs], mesh)
            (params_rep, prev_rep, met, loss_sum, gsq, n_part, n_att, n_del,
             comp_j) = server_round(stacked, params_rep, prev_rep)
        # shard states carry theta^{k-1} for the next eq.-(8) step norm;
        # quorum may have frozen it, so it comes from the server's new_prev
        prev_views = per_device_views(prev_rep, mesh, replicated=True)
        states = [o[0]._replace(prev_params=pv)
                  for o, pv in zip(outs, prev_views)]

        # one read from the device a round: the scalars (ints below 2^53
        # and f32 values are exact in f64), then the masks if collected
        host = torch.stack(
            [x.to(server, torch.float64) for x in
             (loss_sum, gsq, met, n_part, n_att, n_del, comp_j)]
            + [o[3].to(server, torch.float64) for o in outs]).tolist()
        loss_f, gsq_f, met_f, part_i, att_i, del_i, comp_f = host[:7]
        att_i, part_i = int(att_i), int(part_i)
        objective.append(loss_f)
        gsq_hist.append(gsq_f)
        met_hist.append(bool(met_f))
        n_part_h.append(part_i)
        n_att_h.append(att_i)
        n_del_h.append(int(del_i))
        t += max(host[7:]) + (uplink_air if att_i else 0.0) + downlink_air
        wall.append(t)
        joules += float(energy.round_energy(att_i, part_i, payload)) \
            + comp_f
        energy_cum.append(joules)
        if collect_mask:
            mask_rows.append(torch.cat(
                [o[2].to(server) for o in outs]).to(torch.int8).cpu()
                .numpy())
        if collect_metrics:
            shard_bags = [{kk: torch.as_tensor(v).cpu()
                           for kk, v in o[4].items()} for o in outs]
            merged = merge_shard_bags(shard_bags,
                                      weights=[m_local] * k_shards)
            merged = {kk: float(v) for kk, v in merged.items()}
            merged["agg_grad_sqnorm"] = gsq_f
            bags.append(merged)

    att = np.asarray(n_att_h, np.int64)
    return MeshHistory(
        objective=np.asarray(objective),
        agg_grad_sqnorm=np.asarray(gsq_hist),
        quorum_met=np.asarray(met_hist, bool),
        participated=np.asarray(n_part_h, np.int64),
        attempted=att,
        delivered=np.asarray(n_del_h, np.int64),
        comm_cum=np.cumsum(att),
        delivered_cum=np.cumsum(np.asarray(n_del_h, np.int64)),
        bytes_cum=np.cumsum(att * payload),
        energy_cum=np.asarray(energy_cum),
        wall_clock=np.asarray(wall),
        final_params=params_rep,
        mask=np.stack(mask_rows) if mask_rows else None,
        metrics=tuple(bags),
    )
