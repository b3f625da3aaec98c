#!/usr/bin/env python3
"""Where the time of one Algorithm-1 iteration, or of serving, goes on the
card.

    python3 benchmarks_torch/step_profile.py [--d 163597056] [--m 4] [--iters 5]
        [--transport dense int8 topk lowrank dense_staged int8_staged
         per_tensor] [--backend cuda reference]
    python3 benchmarks_torch/step_profile.py --serve default long [--iters 5]
    python3 benchmarks_torch/step_profile.py --edge chb chb_int8 csgd \
        [--iters 5]

Builds the full-width task of ``chip_smoke.py``'s phase 5 (edge quadratics
at the parameter count of ``chb-paper-lm-124m``, M=4, f32, chb with
alpha=0.125, eps1=4; top-k keeps (2d)//5 entries, low-rank runs rank 2 and
per_tensor granularity runs on the model's 12 leaves, the ``_staged``
paths run dense and int8 under ``force_staged()``), warms each
configuration up with one
``simulator.run``, then traces ``--iters`` iterations of another with
``torch.profiler`` (CPU and CUDA activities). For each transport, on the
kernel and the reference backend (or those ``--backend`` names: at
``--m 100000`` the reference backend's worker sum is 10^5 eager adds an
iteration), it prints one JSON line: device time by
kernel name, the window's wall time (CUDA events), the device's busy time
(the sum of its kernels and copies) and its idle share (1 - busy / wall).
With ``--serve``, it profiles chb-paper-lm-124m at full width instead,
at ``chip_smoke.py``'s serving shapes (default: batch 4, prompt 64; long:
batch 8, prompt 2048), with the JAX package's PRNGKey(0) weights: after
a warm-up prefill and step, one traced prefill, then ``--iters`` traced
decode steps, each window on the cuda and the reference backend, one JSON
line each (idle share and top device ops: whether B13, the LM head or the
weight reads set a decode step's pace).
With ``--edge``, it profiles ``fed.run_edge`` at phase 5's width on the
paths of ``chip_smoke.py``'s phase edge: after a warm-up run of 2 rounds,
``--iters`` traced rounds under ``sync_config(m)`` and under the phase's
deployment scenario, each on the cuda and the reference backend, one
JSON line each.
Needs a CUDA card and fails without one; it fails too if the trace shows
no device time.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import opt  # noqa: E402
from repro_torch.core import simulator  # noqa: E402
from repro_torch.data import edge_tasks  # noqa: E402
from repro_torch.kernels import fused_step  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

from chip_smoke import (EDGE_PATHS, FULL_ALPHA, FULL_RANK, LM_ARCH,  # noqa: E402
                        SERVE_RUNS, edge_scenario, lm_tree_task)

TRANSPORTS = ("dense", "int8", "topk", "lowrank", "dense_staged",
              "int8_staged", "per_tensor")
# the paths that run on the model's leaves; the rest run on one leaf
TREE_PATHS = ("lowrank", "per_tensor")


def _device_ms(evt) -> float:
    us = getattr(evt, "self_device_time_total", None)
    if us is None:
        us = getattr(evt, "self_cuda_time_total", 0.0)
    return us / 1e3


def transport_kw(transport: str, d: int) -> dict:
    """The ``opt.make`` keywords of one path at width ``d``."""
    return {"dense": {}, "int8": {"quantize": "int8"},
            "topk": {"transport": "topk", "k": (2 * d) // 5},
            "lowrank": {"transport": "lowrank", "rank": FULL_RANK},
            "dense_staged": {}, "int8_staged": {"quantize": "int8"},
            "per_tensor": {"granularity": "per_tensor"},
            }[transport]


def profile_run(task, transport, backend, iters: int) -> dict:
    m = task.worker_data[0].shape[0]
    d = sum(x.numel() for x in tree_leaves(task.init_params))
    o = opt.make("chb", 0.5 / 4, m, eps1=4.0, backend=backend,
                 **transport_kw(transport, d))
    route = fused_step.force_staged() if transport.endswith("_staged") \
        else contextlib.nullcontext()
    with route:
        simulator.run(o, task, 2)                    # warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start.record()
            simulator.run(o, task, iters)
            end.record()
            torch.cuda.synchronize()
    return _summary(prof, start.elapsed_time(end), iters,
                    transport=transport, backend=backend)


def _summary(prof, wall: float, iters: int, **meta) -> dict:
    """Device time by kernel name, busy time and idle share of a window of
    ``wall`` ms (CUDA events) holding ``iters`` iterations."""
    # device-side events only (kernels, copies): the CPU-side operator
    # events carry their kernels' device time too and would count it twice
    rows = sorted(((evt.key, _device_ms(evt), evt.count)
                   for evt in prof.key_averages()
                   if evt.device_type == DeviceType.CUDA
                   and _device_ms(evt) > 0),
                  key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in rows)
    if busy <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return {**meta, "iters": iters, "wall_ms": wall, "busy_ms": busy,
            "idle_share": 1.0 - busy / wall,
            "per_iter_ms": wall / iters,
            "by_kernel": [{"name": k[:90], "ms": ms, "calls": n}
                          for k, ms, n in rows[:14]]}


def profile_serve(kind: str, iters: int) -> list:
    """One traced prefill and ``iters`` traced decode steps of
    chb-paper-lm-124m at ``chip_smoke.SERVE_RUNS["serve_" + kind]``, on
    each backend."""
    from repro_torch.configs import get
    from repro_torch.launch.serve import full_f32, prompts_of
    from repro_torch.models import model
    from repro_torch.random import PRNGKey
    full_f32()
    shape = SERVE_RUNS[f"serve_{kind}"]
    b, l = shape["batch"], shape["prompt"]
    cache_len = l + max(shape["gen"], iters + 2) + 1
    cfg = get(LM_ARCH)
    params = model.init_params(PRNGKey(0, device="cuda"), cfg)
    prompts = prompts_of(cfg, b, l, "cuda")
    out = []
    for backend in ("cuda", "reference"):
        logits, cache = model.prefill(params, cfg, prompts,
                                      cache_len=cache_len, backend=backend)
        tok = torch.argmax(logits, -1)[:, None]
        model.serve_step(params, cfg, cache, tok, l, backend=backend)
        for window in ("prefill", "decode"):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                start.record()
                if window == "prefill":
                    model.prefill(params, cfg, prompts, cache_len=cache_len,
                                  backend=backend)
                else:
                    for i in range(iters):
                        logits, cache = model.serve_step(
                            params, cfg, cache, tok, l + 1 + i,
                            backend=backend)
                        tok = torch.argmax(logits, -1)[:, None]
                end.record()
                torch.cuda.synchronize()
            out.append(_summary(prof, start.elapsed_time(end),
                                1 if window == "prefill" else iters,
                                serve=kind, window=window, backend=backend,
                                batch=b, prompt=l))
        del cache
        torch.cuda.empty_cache()
    return out


def profile_edge(task, path: str, iters: int) -> list:
    """``iters`` traced rounds of ``fed.run_edge`` on one EDGE_PATHS path,
    under ``sync_config`` and the deployment scenario, on each backend."""
    from repro_torch import fed
    algo, kw = EDGE_PATHS[path]
    m = task.worker_data[0].shape[0]
    out = []
    for scenario, edge in (("sync", fed.sync_config(m)),
                           ("deployment", edge_scenario())):
        for backend in ("cuda", "reference"):
            o = opt.make(algo, FULL_ALPHA, m, backend=backend, **kw)
            fed.run_edge(o, task, edge, 2)                 # warm-up
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                start.record()
                hist = fed.run_edge(o, task, edge, iters)
                end.record()
                torch.cuda.synchronize()
            d = hist.stats.as_dict()
            out.append(_summary(prof, start.elapsed_time(end), iters,
                                edge=path, scenario=scenario,
                                backend=backend,
                                client_evals=d["uplinks"] + d["censored"]))
            del hist
            torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d", type=int, default=163_597_056)
    ap.add_argument("--m", type=int, default=4)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--transport", nargs="+", choices=TRANSPORTS,
                    default=list(TRANSPORTS),
                    help="low-rank and per_tensor view the task as "
                    "chb-paper-lm-124m's leaves, so they need the default "
                    "--d")
    ap.add_argument("--backend", nargs="+", choices=("cuda", "reference"),
                    default=["cuda", "reference"])
    ap.add_argument("--serve", nargs="+", choices=("default", "long"),
                    help="profile serving chb-paper-lm-124m instead")
    ap.add_argument("--edge", nargs="+", choices=tuple(EDGE_PATHS),
                    help="profile fed.run_edge's rounds instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("step_profile: needs a CUDA card")
    if args.serve:
        print(json.dumps({"device": torch.cuda.get_device_name(0)}),
              flush=True)
        for kind in args.serve:
            for row in profile_serve(kind, args.iters):
                print(json.dumps(row), flush=True)
        return
    task = edge_tasks.make_edge_quadratics(m=args.m, d=args.d, seed=0,
                                           dtype=torch.float32)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "d": args.d, "m": args.m}), flush=True)
    if args.edge:
        for path in args.edge:
            for row in profile_edge(task, path, args.iters):
                print(json.dumps(row), flush=True)
        return
    for transport in args.transport:
        run_task = lm_tree_task(task) if transport in TREE_PATHS else task
        for backend in args.backend:
            print(json.dumps(profile_run(run_task, transport, backend,
                                         args.iters)), flush=True)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
