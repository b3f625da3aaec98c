#!/usr/bin/env python3
"""Fig. 11 of the CHB paper through the port's sweep engine: the eps1 grid
of ``benchmarks/fig11_epsilon.py`` (33 eps1 scales x 2 seeds, M = 9, 3000
iterations, f64, linear regression) on the card.

    python3 benchmarks_torch/fig11_epsilon.py
        [--out build/BENCH_torch_fig11_epsilon.json]
        [--device cpu --scales 3 --fstar-iters 20000]   # a CPU rehearsal

For each backend (``cuda``, then ``reference``) it runs ``sweep.run_sweep`` over the grid (fstar per seed
from the port's ``simulator.estimate_fstar``, tolerance 1e-7, as the JAX
benchmark), and prints one JSON line: the sweep's elapsed seconds,
point-iterations a second, the frontier, and how many points have the
``total_comms``, ``comms_to_tol`` and ``iters_to_tol`` of the JAX
package's ``BENCH_fig11_sweep.json`` (with the first point that differs).
Then it traces the grid's first 3 points for 200 iterations with
``torch.profiler`` and reports the device's idle share over them. It
checks the paper's trade-off on the scales 0.01, 0.1 and 1 (more eps1:
fewer communications, more iterations), as the JAX benchmark does, and
writes the artifact through ``repro_torch.obs.bench`` to ``--out`` (the
card's name and power limit are in its ``env``).

Runs on CUDA and fails without a card; ``--device cpu`` is the explicit
opt-in for a rehearsal on the CPU (with a smaller grid: ``--scales``,
``--iters``, ``--fstar-iters``), whose times are the host's and whose
device idle share is not measured.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

from repro_torch import obs, opt, sweep  # noqa: E402
from repro_torch.core import simulator  # noqa: E402
from repro_torch.data import paper_tasks  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402

SEEDS = (0, 1)
M = 9
TOL = 1e-7
JAX_ARTIFACT = ROOT / "BENCH_fig11_sweep.json"
FRONTIER_INTS = ("total_comms", "comms_to_tol", "iters_to_tol")
BACKENDS = ("cuda", "reference")
TRACED_POINTS = 3
TRACE_ITERS = 200


def _factory(device):
    def factory(seed: int, m: int):
        return paper_tasks.make_linear_regression(m=m, seed=seed,
                                                  device=device).task
    return factory


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def against_jax(rows: list, jax_rows: list) -> dict:
    """How many frontier rows have the JAX artifact's integers (all three,
    and each one), and the first that does not."""
    same = [all(r[k] == j[k] for k in FRONTIER_INTS)
            for r, j in zip(rows, jax_rows)]
    first = next((i for i, s in enumerate(same) if not s), None)
    out = {"points_equal": int(sum(same)), "points": len(same),
           **{f"{k}_equal": sum(r[k] == j[k] for r, j in zip(rows, jax_rows))
              for k in FRONTIER_INTS},
           "first_differing": None}
    if first is not None:
        r, j = rows[first], jax_rows[first]
        out["first_differing"] = {
            "index": first, "eps1": r["eps1"], "seed": r["seed"],
            **{f"{k}": r[k] for k in FRONTIER_INTS},
            **{f"jax_{k}": j[k] for k in FRONTIER_INTS}}
    return out


def _device_ms(evt) -> float:
    us = getattr(evt, "self_device_time_total", None)
    if us is None:
        us = getattr(evt, "self_cuda_time_total", 0.0)
    return us / 1e3


def device_idle(grid_points, factory, base, iters: int, device) -> dict:
    """The device's idle share over a traced sweep of a few points:
    1 - (device busy time) / (wall time between two CUDA events)."""
    if device.type != "cuda":
        return {"idle_share": "not measured (no card)"}
    sweep.run_sweep(grid_points, task_factory=factory, num_iters=2,
                    base_cfg=base, device=device)          # warm-up
    _sync(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with obs.trace(str(ROOT / "build" / "fig11_trace")) as prof:
        start.record()
        sweep.run_sweep(grid_points, task_factory=factory, num_iters=iters,
                        base_cfg=base, device=device)
        end.record()
        _sync(device)
    busy = sum(_device_ms(e) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)
    if busy <= 0:
        raise RuntimeError("the profiler recorded no device time")
    wall = start.elapsed_time(end)
    return {"points": len(grid_points), "iters": iters, "wall_ms": wall,
            "busy_ms": busy, "idle_share": 1.0 - busy / wall}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=3000)
    ap.add_argument("--scales", type=int, default=33)
    ap.add_argument("--fstar-iters", type=int, default=40000)
    ap.add_argument("--out", default=str(ROOT / "build"
                                         / "BENCH_torch_fig11_epsilon.json"))
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (a rehearsal)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    scales = tuple(float(s) for s in np.logspace(-2.0, 0.0, args.scales))
    factory = _factory(device)
    alpha = paper_tasks.make_linear_regression(device="cpu").alpha_paper
    fstar = {s: float(simulator.estimate_fstar(factory(s, M), alpha,
                                               args.fstar_iters,
                                               device=device))
             for s in SEEDS}
    grid = sweep.ConfigGrid(alpha=(alpha,), beta=(0.4,), eps1_scale=scales,
                            seed=SEEDS, num_workers=(M,))
    jax_doc = json.loads(JAX_ARTIFACT.read_text())
    jax_rows = jax_doc["benchmarks"]["fig11_epsilon"]["frontier"]
    compare_jax = args.scales == 33 and args.iters == 3000

    results, rows_by_backend = {}, {}
    for backend in BACKENDS:
        base = opt.make("chb", alpha, M, backend=backend)
        res = sweep.run_sweep(grid, task_factory=factory,
                              num_iters=args.iters, base_cfg=base,
                              device=device)
        rows = res.frontier(fstar, TOL)
        if not all(np.isfinite(r["final_err"]) for r in rows):
            raise RuntimeError(f"{backend}: a point's objective is not "
                               "finite")
        by_scale = {s: rows[i * len(SEEDS)] for i, s in enumerate(scales)}
        canon = [scales[0], scales[len(scales) // 2], scales[-1]]
        comms = [by_scale[s]["comms_to_tol"] for s in canon]
        iters = [by_scale[s]["iters_to_tol"] for s in canon]
        if not (comms == sorted(comms, reverse=True)
                and iters == sorted(iters)):
            raise RuntimeError(f"{backend}: the eps1 trade-off does not "
                               f"hold: comms {comms}, iters {iters}")
        traced = device_idle(res.points[:TRACED_POINTS], factory, base,
                             TRACE_ITERS, device)
        point_iters = len(res) * args.iters
        results[backend] = {
            "elapsed_s": res.elapsed_s,
            "point_iterations_per_s": point_iters / res.elapsed_s,
            "us_per_point_iteration": res.elapsed_s / point_iters * 1e6,
            "num_programs": res.num_programs,
            "canonical": {"scales": canon, "comms_to_tol": comms,
                          "iters_to_tol": iters},
            "traced": traced,
            "against_jax": (against_jax(rows, jax_rows) if compare_jax
                            else "not compared (the grid is not the "
                            "JAX artifact's)")}
        rows_by_backend[backend] = rows
        print(json.dumps({"backend": backend, **results[backend]}),
              flush=True)
        specs = list(res.specs)
        del res

    frontier_equal = all(
        all(x[k] == y[k] for k in FRONTIER_INTS + ("uplink_bytes",))
        for x, y in zip(*rows_by_backend.values()))
    first = BACKENDS[0]
    derived = ";".join(
        f"{b}:{results[b]['point_iterations_per_s']:.0f}it/s"
        for b in BACKENDS)
    payload = {
        "row": f"fig11_epsilon,{results[first]['us_per_point_iteration']:.1f}"
               f",{derived}",
        "seconds": time.perf_counter() - t0,
        "backend": list(BACKENDS),
        "device": str(device),
        "num_points": grid.num_points, "num_iters": args.iters,
        "tol": TOL, "fstar": {str(s): v for s, v in fstar.items()},
        "fstar_iters": args.fstar_iters,
        "results": results,
        "frontier": rows_by_backend,
        "backends_frontier_equal": frontier_equal,
        "specs": specs,
    }
    doc = obs.bench.make_artifact("torch_fig11_epsilon",
                                  {"fig11_epsilon": payload},
                                  registry=list(opt.names()))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    obs.bench.write_artifact(doc, str(out))
    print(json.dumps({"artifact": str(out), "env": doc["env"],
                      "backends_frontier_equal": frontier_equal,
                      "seconds": payload["seconds"]}), flush=True)
    print(payload["row"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
