#!/usr/bin/env python3
"""Fed-mesh scaling on the card: a 10^5-client scenario frontier and a
clients-against-wall-clock ladder to 10^6 (the port's counterpart of
``benchmarks/fed_mesh.py``).

    python3 benchmarks_torch/fed_mesh.py [--out BENCH_fed_mesh_torch.json]
        [--device cpu]                      # a CPU rehearsal
    REPRO_BENCH_FAST=1 python3 benchmarks_torch/fed_mesh.py   # small shapes

Runs ``fed.run_mesh`` in this process over ``make_client_mesh(1)``: one
shard on the card, chb dense on the ``cuda`` backend (the JAX benchmark
runs 8 host devices in a subprocess; here one card holds every client).

  * frontier: ``make_edge_quadratics(100_000, d=16, seed=0)`` (f64), chb
    at alpha 0.5/M and eps1 4, ``uniform_vector_population(M, 0.05,
    straggler_frac=0.1, seed=1)``, the default channel and energy model,
    80 rounds of each of the scenarios ideal, lossy, partial and harsh
    (seed 3), each after a warm-up run of one round: bytes, joules,
    modeled wall clock, the gap to the closed-form f* (computed on the
    CPU), host seconds of the run (set-up included) and ms a round;
  * ladder: 10^5, 2.5 10^5, 5 10^5 and 10^6 clients, 5 rounds of the ideal
    scenario each with ``collect_mask=False``, after a warm-up run of one
    round: seconds a round and client-rounds a second.

The JAX benchmark's checks hold here too: the ideal scenario converges to
f*, censoring saves bytes against transmit-everything, every scenario
improves on its starting gap, every rung completes with finite
objectives. At the full shapes the ideal scenario's attempted uplinks and
bytes are also compared with the JAX artifact ``BENCH_fed_mesh.json``
(reported, not asserted: past the f64 noise floor eq. (8) follows each
platform's rounding; see ``against_jax`` for the other scenarios). The
artifact goes through ``repro_torch.obs.bench`` to
``--out`` (the card's name and power limit are in its ``env``). Runs on
CUDA and fails without a card unless ``--device cpu`` asks for the CPU,
whose times are the host's.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import fed, obs, opt  # noqa: E402
from repro_torch.data import edge_tasks  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.mesh import make_client_mesh  # noqa: E402

# REPRO_BENCH_FAST=1: the JAX benchmark's CI shapes, same code paths
FAST = os.environ.get("REPRO_BENCH_FAST", "") not in ("", "0")
FRONTIER_M = 800 if FAST else 100_000
FRONTIER_ROUNDS = 60 if FAST else 80
LADDER_M = (400, 800, 1600) if FAST else (100_000, 250_000, 500_000,
                                          1_000_000)
LADDER_ROUNDS = 3 if FAST else 5
D = 16
SCENARIOS = (("ideal", 1.0, 0.0, 1.0), ("lossy", 1.0, 0.2, 0.7),
             ("partial", 0.5, 0.0, 0.5), ("harsh", 0.5, 0.3, 0.5))
SCENARIO_SEED = 3
JAX_ARTIFACT = ROOT / "BENCH_fed_mesh.json"


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_mesh(o, task, rounds, mesh, device, **kw):
    _sync(device)
    t0 = time.perf_counter()
    hist = fed.run_mesh(o, task, rounds, mesh=mesh, collect_mask=False,
                        bake_data=False, **kw)
    _sync(device)
    return hist, time.perf_counter() - t0


def frontier(mesh, device) -> tuple[list, float, int]:
    m, r = FRONTIER_M, FRONTIER_ROUNDS
    task = edge_tasks.make_edge_quadratics(m, d=D, seed=0, device=device)
    # the closed-form optimum row by row on the CPU (on the card each row
    # would wait on a copy to the host)
    fstar = edge_tasks.edge_quadratics_fstar(
        edge_tasks.make_edge_quadratics(m, d=D, seed=0, device="cpu"))
    o = opt.make("chb", 0.5 / m, m, eps1=4.0, backend="cuda")
    pop = fed.uniform_vector_population(m, compute_mean_s=0.05,
                                        straggler_frac=0.1, seed=1)
    chan, en = fed.ChannelConfig(), fed.EnergyModel()
    payload = o.transport.payload_bytes(task.init_params)
    rows = []
    for name, part, loss, quo in SCENARIOS:
        sc = fed.MeshScenario(participation=part, loss_prob=loss,
                              quorum=quo, seed=SCENARIO_SEED)
        _timed_mesh(o, task, 1, mesh, device, scenario=sc)     # warm-up
        mh, host_s = _timed_mesh(o, task, r, mesh, device, scenario=sc,
                                 population=pop, channel=chan, energy=en)
        rows.append(dict(
            scenario=name, participation=part, loss_prob=loss, quorum=quo,
            rounds=r, uplink_bytes=int(mh.bytes_cum[-1]),
            attempted=int(mh.attempted.sum()),
            joules=float(mh.energy_cum[-1]),
            sim_wall_s=float(mh.wall_clock[-1]), host_s=host_s,
            ms_per_round=host_s * 1e3 / r,
            quorum_met_frac=float(mh.quorum_met.mean()),
            gap0=float(mh.objective[0] - fstar),
            gap=float(mh.objective[-1] - fstar)))
        print(json.dumps({"frontier": rows[-1]}), flush=True)
    return rows, fstar, payload


def ladder(mesh, device) -> list:
    rows = []
    for m in LADDER_M:
        task = edge_tasks.make_edge_quadratics(m, d=D, seed=0,
                                               device=device)
        o = opt.make("chb", 0.5 / m, m, eps1=4.0, backend="cuda")
        _timed_mesh(o, task, 1, mesh, device)      # warm-up: allocations
        mh, total = _timed_mesh(o, task, LADDER_ROUNDS, mesh, device,
                                scenario=fed.MeshScenario(seed=0))
        if not np.isfinite(mh.objective).all():
            raise RuntimeError(f"ladder M={m}: objective is not finite")
        rows.append(dict(clients=m, rounds=LADDER_ROUNDS, total_s=total,
                         s_per_round=total / LADDER_ROUNDS,
                         client_rounds_per_s=m * LADDER_ROUNDS / total))
        print(json.dumps({"ladder": rows[-1]}), flush=True)
        del task, mh
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def against_jax(rows: list) -> dict:
    """The ideal scenario's attempted uplinks, bytes and quorum record
    against the JAX artifact's (the same task, population and scenario at
    f64; it draws nothing). The other scenarios draw, and the artifact was
    written by jax 0.4.37, whose default threefry (not partitionable)
    gives other bits than the jax 0.9.0 PRNG the port reproduces: their
    counts stand beside the artifact's for reference only."""
    if FAST:
        return {"compared": False, "why": "fast shapes"}
    doc = json.loads(JAX_ARTIFACT.read_text())
    jax_rows = {r["scenario"]: r for r in
                doc["benchmarks"]["fed_mesh"]["frontier"]}
    out = {"compared": True, "jax_version": doc["env"].get("jax_version")}
    for r in rows:
        j = jax_rows[r["scenario"]]
        out[r["scenario"]] = {
            "attempted": r["attempted"], "jax_attempted": j["attempted"],
            "equal": (r["attempted"] == j["attempted"]
                      and r["uplink_bytes"] == j["uplink_bytes"]
                      and r["quorum_met_frac"] == j["quorum_met_frac"]),
            "draws": r["participation"] < 1.0 or r["loss_prob"] > 0.0}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "BENCH_fed_mesh_torch.json"))
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (a rehearsal)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    mesh = make_client_mesh(1, None if device.type == "cuda" else [device])
    t0 = time.perf_counter()
    front, fstar, payload = frontier(mesh, device)
    lad = ladder(mesh, device)

    # the JAX benchmark's gates: the ideal scenario converges to the
    # closed-form optimum; censoring beats transmit-everything on bytes;
    # every scenario improves on its starting gap; every rung completed
    ideal = front[0]
    assert ideal["scenario"] == "ideal"
    assert ideal["gap"] < 1e-3 * ideal["gap0"], \
        f"ideal scenario did not converge: {ideal}"
    naive = FRONTIER_M * FRONTIER_ROUNDS * payload
    assert ideal["uplink_bytes"] < naive, "censoring saved no bytes"
    assert all(row["gap"] < row["gap0"] for row in front)
    assert [row["clients"] for row in lad] == list(LADDER_M)

    us = lad[-1]["s_per_round"] * 1e6
    row = (f"fed_mesh,{us:.1f},clients_max={LADDER_M[-1]};devices=1;"
           f"ideal_relgap={ideal['gap'] / ideal['gap0']:.2e}")
    bench = dict(row=row, backend="cuda", device=str(device), fast=FAST,
                 devices=1, shards=1, payload_bytes=payload, fstar=fstar,
                 frontier=front, ladder=lad, against_jax=against_jax(front),
                 seconds=time.perf_counter() - t0, spec=None)
    doc = obs.bench.make_artifact("fed_mesh_torch", {"fed_mesh": bench},
                                  registry=list(opt.names()))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    obs.bench.write_artifact(doc, str(out))
    print(json.dumps({"artifact": str(out), "env": doc["env"],
                      "against_jax": bench["against_jax"],
                      "seconds": bench["seconds"]}), flush=True)
    print(row)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
