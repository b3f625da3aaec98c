"""Event-driven federated edge runtime for the CHB family (port of
``repro.fed.runner``).

Wraps the exact Algorithm-1 semantics of a composed ``repro_torch.opt``
optimizer in a deployment simulation: heterogeneous clients
(``clients.py``) compute local gradients with per-client latency and
availability, uplinks travel through a channel model (``channel.py``) that
charges air time and joules (``energy.py``) and may drop packets, and the
server advances by the composed server update whenever a quorum of the
round's cohort has reported. The censor and transport stages run through
their per-client entry points (``client_decide`` / ``*_row``), so any
composition whose censor decides per client (everything but the adaptive
EMA, CSGD included) runs here unchanged.

Correctness anchor: with zero latency, a lossless channel, full
participation and full quorum (``sync_config``), the event loop reduces
to ``core.simulator.run`` bit for bit: objective, uplinks, masks and
theta.

Semantics under asynchrony, all from the eq. (5) stale-bank view:
  * Client ``i`` is the only writer of bank row ``ghat_i``, and its local
    copy advances in lockstep with the server's (drops are NACKed), so a
    delta computed against the row folds safely however late it arrives.
  * A censored client sends a zero-byte beacon: it counts toward the
    quorum, and its bank row stays stale.
  * A dropped uplink costs full air time and transmit energy but leaves
    the server bank untouched, and the client does not advance its EF row.
  * Unavailable or unsampled clients keep stale bank rows.

The event loop is host Python (a heap of timed events) with the host
numpy draws of the JAX package in the same order; the math runs on the
task's device. On ``backend="cuda"`` each client evaluation takes its
eq.-(8) norm through B8 at M = 1 (``kernels.ops.tree_sqnorm_row``) and
each round's server update runs B3 (``opt.apply_server``); the row
transports are plain PyTorch, as in the JAX package.

Tensors are never updated in place where a snapshot could see it: a busy
client's ``(params, ssq, round)`` and a queued arrival's payload hold
tensors that no later stage writes. The fold adds into the bank in place,
since a client reads its bank row only at its ``finish`` event.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from ..core.censoring import step_sqnorm
from ..core.quantize import payload_bytes_dense
from ..core.simulator import FedTask, global_loss, task_to
from ..core.util import tree_sqnorm, tree_sum_leading, tree_worker_slice
from ..device import resolve_device
from ..kernels import ops as kernel_ops
from ..obs import compile_log
from ..tree import tree_leaves, tree_map
from .channel import ChannelConfig
from .clients import Population, uniform_population
from .energy import EdgeStats, EnergyModel


@dataclasses.dataclass(frozen=True)
class EdgeConfig:
    """Deployment scenario: who computes, over what air, at what cost.

    Attributes:
      population: M client profiles + the server's cohort-sampling policy.
      channel: uplink/downlink air-time and loss model.
      energy: radio/compute joule model for the per-client accounting.
      quorum: fraction of the round's cohort that must report before the
        server applies the update; must be in (0, 1].
      seed: host-side RNG seed for every latency/availability/channel draw.
      retry_tick_s: wall-clock step used to re-poll availability when all
        clients are idle but unavailable.
    """
    population: Population
    channel: ChannelConfig = dataclasses.field(
        default_factory=ChannelConfig)
    energy: EnergyModel = dataclasses.field(default_factory=EnergyModel)
    quorum: float = 1.0
    seed: int = 0
    retry_tick_s: float = 1.0

    def __post_init__(self):
        if not 0.0 < self.quorum <= 1.0:
            raise ValueError("quorum must be in (0, 1]")


def quorum_need(quorum: float, cohort_size: int) -> int:
    """Arrivals required before theta advances: ``max(1, ceil(q * |C|))``."""
    return max(1, math.ceil(quorum * cohort_size))


def sync_config(num_clients: int, seed: int = 0) -> EdgeConfig:
    """The degenerate scenario that reproduces ``core.simulator.run``:
    zero latency, a lossless infinite-rate channel, full participation and
    full quorum (``seed`` is irrelevant, nothing is drawn)."""
    return EdgeConfig(
        population=uniform_population(num_clients, compute_mean_s=0.0),
        channel=ChannelConfig.ideal(),
        energy=EnergyModel(),
        quorum=1.0,
        seed=seed,
    )


class EdgeHistory(NamedTuple):
    """Per-round trajectory + deployment accounting (numpy on the host,
    except the final params and bank, which stay on the device)."""
    objective: np.ndarray      # (R,) f(theta^k) before round k's update
    comm_cum: np.ndarray       # (R,) cumulative uplink transmissions
    mask: np.ndarray           # (R, M) int8, 1 = fresh delta folded in round k
    agg_grad_sqnorm: np.ndarray  # (R,) ||sum_m ghat_m||^2 at the update
    wall_clock: np.ndarray     # (R,) seconds at the end of round k
    energy_cum: np.ndarray     # (R,) cumulative joules across all clients
    bytes_cum: np.ndarray      # (R,) cumulative uplink payload bytes
    final_params: Any
    final_bank: Any            # (M, ...) server stale-gradient bank
    stats: EdgeStats
    # () unless run_edge(collect_metrics=True): per-round series
    # {name: (R,) array} -- censor/transmit rates, drop counts, exact
    # byte/energy counters and the staleness histogram (rounds late of
    # each folded delta, bucketed 0 / 1 / 2-3 / 4+)
    metrics: Any = ()


class _Event(NamedTuple):
    """Heap entry; ``seq`` makes same-time ordering FIFO-stable."""
    time: float
    seq: int
    kind: str                  # "finish" | "arrive"
    client: int
    round_: int
    data: Any                  # finish: None; arrive: (payload, delivered,
    #                            transmitted, new_err_row)


def _stages(opt, task: FedTask):
    """The per-client and server stages, mirroring the composed
    ``opt.step`` stage for stage (the JAX runner's ``_compile``). Each
    call ticks ``obs.compile_log``'s ``fed/client_eval`` or
    ``fed/server_update`` (the JAX package ticks once a trace)."""
    kernels = opt.backend == "cuda"

    def client_eval(params, i, ghat_row, err_row, ssq, rnd):
        compile_log.record("fed", "client_eval")     # one tick a call
        data_i = tree_map(lambda x: x[i:i + 1], task.worker_data)
        g = tree_map(lambda x: x[0], task.grad_fn(params, data_i))
        delta = tree_map(lambda x, h: x.to(h.dtype) - h, g, ghat_row)
        pending = opt.transport.prepare_row(delta, err_row)
        if kernels:        # B8 at M = 1: the batched step's row, bit for bit
            dsq = kernel_ops.tree_sqnorm_row(pending)
        else:
            dsq = tree_sqnorm(pending)
        transmit = opt.censor.client_decide(rnd, i, dsq, ssq)
        payload, aux = opt.transport.encode_row(pending, err_row)
        new_err = opt.transport.feedback_row(pending, payload, aux, err_row)
        return payload, new_err, transmit

    def fold(ghat, payload, i):
        for h, q in zip(tree_leaves(ghat), tree_leaves(payload)):
            h[i] += q.to(h.dtype)

    def server_update(params, prev_params, ghat):
        compile_log.record("fed", "server_update")   # one tick a round
        agg = tree_sum_leading(ghat)
        new_params = opt.apply_server(params, prev_params, agg)
        # ||theta^{k+1} - theta^k||^2: the next cohort's eq.-(8) test runs
        # with exactly the batched step norm
        return new_params, step_sqnorm(new_params, params), tree_sqnorm(agg)

    return client_eval, fold, server_update


def _check(opt, m: int) -> None:
    if any(getattr(opt, a, None) is None
           for a in ("censor", "transport", "server")):
        raise TypeError(
            "fed.run_edge drives the censor/transport/server stages "
            "directly (per-client entry points), so it needs a "
            f"ComposedOptimizer, not {type(opt).__name__}")
    if opt.granularity != "global":
        raise NotImplementedError(
            "fed.runner supports granularity='global' only")
    if not getattr(opt.censor, "supports_event_runtime", False):
        raise NotImplementedError(
            f"censor policy {type(opt.censor).__name__} has no per-client "
            "decision rule (adaptive censoring needs the whole cohort); "
            "it cannot run in the event-driven runtime")
    if opt.num_workers != m:
        raise ValueError(f"cfg.num_workers={opt.num_workers} != population "
                         f"num_clients={m}")


def run_edge(opt, task: FedTask, edge: EdgeConfig, num_rounds: int, *,
             collect_metrics: bool = False, runlog=None,
             device=None) -> EdgeHistory:
    """Run the deployment scenario for ``num_rounds`` server rounds.

    Args:
      opt: a ``repro_torch.opt`` ComposedOptimizer with global granularity,
        a censor with per-client decisions (``supports_event_runtime``)
        and ``num_workers`` equal to the population size.
      task: the distributed problem (leaves stacked with leading axis M);
        its tensors are moved to ``device``.
      edge: the deployment scenario (clients, channel, energy, quorum).
      num_rounds: number of server updates to perform.
      collect_metrics: record per-round series in ``EdgeHistory.metrics``
        (host accounting only: trajectories are identical with it on or
        off).
      runlog: optional ``repro_torch.obs.RunLog``; when given, one
        ``"round"`` event (the round's metrics, as ``collect_metrics``
        records them, and ``cohort_size``) is appended per server update
        as it completes.
      device: ``None`` runs on CUDA and raises without it; ``"cpu"`` is
        the explicit CPU opt-in.
    Returns:
      An ``EdgeHistory``.
    Raises:
      NotImplementedError: for per-tensor granularity and censor policies
        without a per-client rule (adaptive).
      ValueError: if ``opt.num_workers`` mismatches the population.
    """
    m = edge.population.num_clients
    _check(opt, m)
    task = task_to(task, resolve_device(device))

    rng = np.random.default_rng(edge.seed)
    client_eval, fold, server_update = _stages(opt, task)

    # opt.init builds the bank and EF state (dtypes included) as step does
    st0 = opt.init(task.init_params)
    ghat, err = st0.ghat, st0.err
    params = task.init_params
    prev_params = params           # theta^{-1} = theta^0, as in opt.init
    ssq = torch.zeros((), dtype=torch.float32,
                      device=tree_leaves(params)[0].device)

    quantized = opt.transport.stateful
    payload_nbytes = opt.transport.payload_bytes(task.init_params)
    down_nbytes = payload_bytes_dense(task.init_params)

    stats = EdgeStats(num_clients=m)
    prof = edge.population.profiles
    idle = [True] * m
    # params/ssq version each busy client is computing against
    assigned: dict[int, tuple[Any, Any, int]] = {}

    heap: list[_Event] = []
    seq = 0
    t = 0.0
    round_ = 0

    def push(time_, kind, client, rnd, data=None):
        nonlocal seq
        heapq.heappush(heap, _Event(time_, seq, kind, client, rnd, data))
        seq += 1

    def dispatch_cohort() -> list[int]:
        """Sample idle+available clients; pushes their finish events."""
        nonlocal t
        for _attempt in range(100_000):
            cands = [i for i in range(m) if idle[i]
                     and prof[i].is_available(t, rng)]
            cohort = edge.population.sample_cohort(cands, rng)
            if cohort:
                break
            if heap:        # let in-flight stragglers land and free clients
                handle(heapq.heappop(heap))
            else:           # everyone idle but unavailable: wait and re-poll
                t += edge.retry_tick_s
        else:
            raise RuntimeError("no dispatchable client after 100k attempts")
        for i in cohort:
            idle[i] = False
            assigned[i] = (params, ssq, round_)
            dl = edge.channel.downlink_time(down_nbytes)
            stats.record_downlink(i, edge.energy.rx_energy(down_nbytes))
            ct = prof[i].draw_compute_time(rng)
            stats.record_compute(
                i, ct, edge.energy.compute_energy(ct, prof[i].compute_w))
            push(t + dl + ct, "finish", i, round_)
        return cohort

    arrived_from: dict[int, int] = {}   # round -> arrivals from its cohort
    fold_row = np.zeros((m,), np.int8)
    # per-round counters (reset after each server update); staleness
    # buckets: folded deltas 0 / 1 / 2-3 / 4+ rounds late
    rc = {"transmit": 0, "censor": 0, "drop": 0,
          "staleness/h0": 0, "staleness/h1": 0, "staleness/h2_3": 0,
          "staleness/h4p": 0}

    def handle(ev: _Event) -> None:
        nonlocal t
        t = max(t, ev.time)
        i = ev.client
        if ev.kind == "finish":
            p_i, ssq_i, rnd = assigned[i]
            payload, new_err_row, transmit = client_eval(
                p_i, i, tree_worker_slice(ghat, i),
                tree_worker_slice(err, i) if quantized else (), ssq_i, rnd)
            if bool(transmit):
                rc["transmit"] += 1
                tx = edge.channel.uplink(payload_nbytes, rng)
                stats.record_uplink(i, payload_nbytes, tx.time_s,
                                    edge.energy.tx_energy(payload_nbytes),
                                    tx.delivered)
                push(ev.time + tx.time_s, "arrive", i, rnd,
                     (payload, tx.delivered, True, new_err_row))
            else:
                rc["censor"] += 1
                stats.record_censored(i)
                # zero-byte beacon: the server hears "no update" after the
                # protocol overhead; no payload energy is charged
                push(ev.time + edge.channel.overhead_s, "arrive", i, rnd,
                     (None, True, False, None))
        else:  # arrive
            payload, delivered, transmitted, new_err_row = ev.data
            if transmitted and not delivered:
                rc["drop"] += 1
            if transmitted and delivered:
                fold(ghat, payload, i)
                if quantized:
                    for e, n in zip(tree_leaves(err),
                                    tree_leaves(new_err_row)):
                        e[i] = n.to(e.dtype)
                fold_row[i] = 1
                staleness = round_ - ev.round_
                rc["staleness/h0" if staleness <= 0 else
                   "staleness/h1" if staleness == 1 else
                   "staleness/h2_3" if staleness <= 3 else
                   "staleness/h4p"] += 1
                if ev.round_ != round_:
                    stats.record_stale(i)
            idle[i] = True
            assigned.pop(i, None)
            if ev.round_ >= round_:   # stale arrivals can't satisfy a quorum
                arrived_from[ev.round_] = arrived_from.get(ev.round_, 0) + 1

    objective, comm_cum, masks, gsq_hist = [], [], [], []
    wall, energy_cum, bytes_cum = [], [], []
    bag_hist: list[dict] = []

    while round_ < num_rounds:
        cohort = dispatch_cohort()
        need = quorum_need(edge.quorum, len(cohort))
        while arrived_from.get(round_, 0) < need:
            handle(heapq.heappop(heap))
        # f(theta^k) before the update, as simulator.run records it
        objective.append(float(global_loss(task, params)))
        new_params, next_ssq, agg_sq = server_update(params, prev_params,
                                                     ghat)
        gsq_hist.append(float(agg_sq))
        prev_params, params, ssq = params, new_params, next_ssq
        masks.append(fold_row.copy())
        fold_row[:] = 0
        comm_cum.append(stats.total_uplinks)
        wall.append(t)
        energy_cum.append(stats.total_energy_j)
        bytes_cum.append(stats.total_uplink_bytes)
        if collect_metrics or runlog is not None:
            decided = rc["transmit"] + rc["censor"]
            bag = {
                "censor_rate": rc["censor"] / max(1, decided),
                "transmit_rate": rc["transmit"] / max(1, decided),
                "drops": float(rc["drop"]),
                "folds": float(masks[-1].sum()),
                "agg_grad_sqnorm": gsq_hist[-1],
                "bank_sqnorm": float(tree_sqnorm(ghat)),
                "comm/uplink_total": float(stats.total_uplinks),
                "comm/uplink_bytes": float(stats.total_uplink_bytes),
                "energy_j": float(stats.total_energy_j),
                "wall_clock_s": float(t),
                **{k: float(v) for k, v in rc.items()
                   if k.startswith("staleness/")},
            }
            if collect_metrics:
                bag_hist.append(bag)
            if runlog is not None:
                runlog.write_round(round_, bag, cohort_size=len(cohort))
        for k in rc:
            rc[k] = 0
        arrived_from.pop(round_, None)
        round_ += 1

    stats.rounds = num_rounds
    stats.wall_clock_s = t
    metrics: Any = ()
    if bag_hist:
        metrics = {k: np.asarray([b[k] for b in bag_hist])
                   for k in bag_hist[0]}
    return EdgeHistory(
        objective=np.asarray(objective),
        comm_cum=np.asarray(comm_cum, np.int64),
        mask=np.stack(masks),
        agg_grad_sqnorm=np.asarray(gsq_hist),
        wall_clock=np.asarray(wall),
        energy_cum=np.asarray(energy_cum),
        bytes_cum=np.asarray(bytes_cum, np.int64),
        final_params=params,
        final_bank=ghat,
        stats=stats,
        metrics=metrics,
    )


def edge_metrics_to_accuracy(hist: EdgeHistory, fstar: float,
                             tol: float) -> dict:
    """{rounds, uplinks, bytes, energy_j, wall_clock_s} when f - f* first
    drops below ``tol``; all -1 if the tolerance is never reached."""
    err = hist.objective - fstar
    hits = np.nonzero(err < tol)[0]
    if hits.size == 0:
        return {"rounds": -1, "uplinks": -1, "bytes": -1,
                "energy_j": -1.0, "wall_clock_s": -1.0}
    k = int(hits[0])
    return {
        "rounds": k,
        "uplinks": int(hist.comm_cum[k]),
        "bytes": int(hist.bytes_cum[k]),
        "energy_j": float(hist.energy_cum[k]),
        "wall_clock_s": float(hist.wall_clock[k]),
    }
