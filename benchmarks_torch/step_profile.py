#!/usr/bin/env python3
"""Where the time of one Algorithm-1 iteration, or of serving, goes on the
card.

    python3 benchmarks_torch/step_profile.py [--d 163597056] [--m 4] [--iters 5]
        [--transport dense int8 topk lowrank dense_staged int8_staged
         per_tensor] [--backend cuda reference]
    python3 benchmarks_torch/step_profile.py --serve default long [--iters 5]
        [--arch chb-paper-lm-124m|qwen3-4b|gemma3-12b|...]
    python3 benchmarks_torch/step_profile.py --edge chb chb_int8 csgd \
        [--iters 5]
    python3 benchmarks_torch/step_profile.py --mesh ideal lossy partial \
        harsh [--m 100000] [--d 16] [--iters 5]
    python3 benchmarks_torch/step_profile.py --train dense int8 \
        [--iters 3] [--backend cuda reference]
        [--arch chb-paper-lm-124m|qwen3-4b|gemma3-12b]

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
With ``--serve``, it profiles serving ``--arch`` (default
chb-paper-lm-124m; the dense bf16 configs too) at full width instead,
at ``chip_smoke.py``'s serving shapes (default: batch 4, prompt 64; long:
batch 8, prompt 2048), with the JAX package's PRNGKey(0) weights: after
a warm-up prefill and step and ``--iters`` untraced decode steps (their
wall a step, ``untraced_ms_per_iter``), one traced prefill, then
``--iters`` traced decode steps, each window on the cuda and the reference
backend, one JSON line each (idle share, device kernels an iteration, top
device ops and device time by group (SERVE_GROUPS): whether B13, B14, the
GEMMs or the host set the pace).
With ``--edge``, it profiles ``fed.run_edge`` at phase 5's width on the
paths of ``chip_smoke.py``'s phase edge: after a warm-up run of 2 rounds,
``--iters`` traced rounds under ``sync_config(m)`` and under the phase's
deployment scenario, each on the cuda and the reference backend, one
JSON line each.
With ``--mesh``, it profiles ``fed.run_mesh`` rounds on the edge
quadratics at ``--m`` clients and ``--d`` (f64, one shard on the card, chb
dense on the cuda backend, ``chip_smoke.py``'s MESH_SCENARIOS): after a
warm-up run of 2 rounds, ``--iters`` traced rounds, one JSON line a
scenario with the host time of the runtime's spans (``fed.mesh/draws``:
the PRNG's threefry hashes; ``fed.mesh/shard_step``;
``fed.mesh/fold_server``) and their share of the window.
With ``--train``, it profiles scan-strategy training steps of
chb-paper-lm-124m at full width, ``chip_smoke.py``'s phase train
(TRAIN_TC: M = 4, 16 x 256 tokens a step, dense or int8 uploads), or with
``--arch qwen3-4b`` or ``gemma3-12b`` those of phase train_bf16 (bf16 at
the published widths, the depth and batch of TRAIN_BF16: qwen3-4b's 16
layers dense, 10 int8; gemma3-12b's one superblock, 4 x 2048 tokens,
dense only): after a
warm-up step, ``--iters`` steps queued back to back between two CUDA
events, ``--iters`` steps as ``train()`` runs them (the batch made and
the metrics read to the host around each step; ``train_loop_ms``: events
around each step alone), then ``--iters`` traced steps, on each backend,
one JSON line each, with the
device time also summed by group (the GEMMs, B14, the flash backward,
the optimizer's kernels B1/B2 or B5/B6, the rest) and the idle share
against the untraced steps' wall (the profiler's own host time stretches
the traced window).
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
                        MESH_SCENARIOS, MESH_SEED, SERVE_RUNS, TRAIN_BF16,
                        TRAIN_TC, edge_scenario, lm_tree_task,
                        train_bf16_config)

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


def _summary(prof, wall: float, iters: int, spans=(), **meta) -> dict:
    """Device time by kernel name, busy time and idle share of a window of
    ``wall`` ms (CUDA events) holding ``iters`` iterations. ``spans`` names
    the profiler spans of the window, whose device-side rows cover their
    kernels' time and are left out of the busy time."""
    # device-side events only (kernels, copies): the CPU-side operator
    # events carry their kernels' device time too and would count it twice
    rows = sorted(((evt.key, _device_ms(evt), evt.count)
                   for evt in prof.key_averages()
                   if evt.device_type == DeviceType.CUDA
                   and evt.key not in spans and _device_ms(evt) > 0),
                  key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in rows)
    if busy <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return {**meta, "iters": iters, "wall_ms": wall, "busy_ms": busy,
            "idle_share": 1.0 - busy / wall,
            "per_iter_ms": wall / iters,
            "by_kernel": [{"name": k[:90], "ms": ms, "calls": n}
                          for k, ms, n in rows[:14]]}


# device-time groups of a training step, by kernel name (first match):
# B14's f32 (flash_fwd) and bf16 (flash_tc) designs; cuBLAS's GEMMs (f32,
# bf16: nvjet)
TRAIN_GROUPS = (("flash_backward", ("flash_bwd",)),
                ("flash_forward", ("flash_fwd", "flash_tc")),
                ("gemm", ("gemm", "xmma", "cutlass", "nvjet")),
                ("optimizer_kernels", ("delta_sqnorm", "finish_partials",
                                       "fused_dense_step", "fused_int8_step",
                                       "int8_stats", "fold_columns")))


# device-time groups of a serving window, by kernel name (first match):
# B14's f32 (flash_fwd) and bf16 (flash_tc) designs, B13's partials (f32,
# bf16) and its combine pass
SERVE_GROUPS = (("flash_forward", ("flash_fwd", "flash_tc")),
                ("decode_attention", ("decode_partials",
                                      "decode_bf16_partials",
                                      "decode_combine")),
                ("gemm", ("gemm", "xmma", "cutlass", "nvjet")))


def _groups(prof, groups=TRAIN_GROUPS) -> dict:
    """Device ms of a trace summed by ``groups`` (the rest: "other")."""
    out = {name: 0.0 for name, _ in groups}
    out["other"] = 0.0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        key = evt.key.lower()
        group = next((name for name, keys in groups
                      if any(k in key for k in keys)), "other")
        out[group] += _device_ms(evt)
    return out


def profile_train(uploads: str, backend: str, iters: int,
                  arch: str = LM_ARCH) -> dict:
    """``iters`` traced scan steps of chb-paper-lm-124m at full width, or of
    a TRAIN_BF16 config at its cut (``train``'s pieces:
    ``make_optimizer``, ``init_params``, ``init_scan_state``,
    ``make_scan_step``, ``batch_iterator``) after one warm-up step."""
    from repro_torch.configs import get
    from repro_torch.core import distributed
    from repro_torch.data import lm_data
    from repro_torch.launch.serve import full_f32
    from repro_torch.models import model
    from repro_torch.random import PRNGKey
    from repro_torch.train import trainer
    full_f32()
    quantize = None if uploads == "dense" else uploads
    if arch == LM_ARCH:
        cfg, tcfg = get(arch), TRAIN_TC
    else:
        spec = TRAIN_BF16[arch]
        run = spec["runs"]["chb_int8" if quantize else "chb"]
        cfg = train_bf16_config(arch, num_layers=run["num_layers"])
        tcfg = {**TRAIN_TC, **spec["tc"]}
    tc = trainer.TrainConfig(**tcfg, quantize=quantize)
    o = trainer.make_optimizer(tc)
    params = model.init_params(PRNGKey(tc.seed, device="cuda"), cfg)
    state = distributed.init_scan_state(o, params)
    step = distributed.make_scan_step(
        o, lambda p, b: model.train_loss(p, cfg, b, remat=tc.remat,
                                         backend=backend)[0],
        backend=backend)
    data = lm_data.batch_iterator(cfg, global_batch=tc.global_batch,
                                  seq_len=tc.seq_len,
                                  num_workers=tc.num_workers, seed=tc.seed,
                                  device="cuda")
    params, state, _ = step(params, state, next(data))       # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # the same number of steps without the profiler, whose own host time
    # stretches the traced window
    batches = [next(data) for _ in range(iters)]
    torch.cuda.synchronize()
    start.record()
    for batch in batches:
        params, state, _ = step(params, state, batch)
    end.record()
    torch.cuda.synchronize()
    unprofiled = start.elapsed_time(end)
    # the same number of steps as train() runs them: each step's batch made
    # after the last step, its metrics read to the host after it; events
    # around each step alone
    looped = []
    for _ in range(iters):
        batch = next(data)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        params, state, metrics = step(params, state, batch)
        b.record()
        looped.append((a, b))
        {k: float(v) for k, v in metrics.items()}
    torch.cuda.synchronize()
    looped_ms = [a.elapsed_time(b) for a, b in looped]
    batches = [next(data) for _ in range(iters)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for batch in batches:
            params, state, _ = step(params, state, batch)
        end.record()
        torch.cuda.synchronize()
    out = _summary(prof, start.elapsed_time(end), iters, train=uploads,
                   backend=backend, arch=arch, layers=cfg.num_layers,
                   tokens_per_step=tc.global_batch * tc.seq_len)
    out["by_group"] = _groups(prof)
    out["unprofiled_per_iter_ms"] = unprofiled / iters
    out["train_loop_ms"] = looped_ms
    out["idle_share_unprofiled"] = 1.0 - out["busy_ms"] / unprofiled
    return out


def profile_serve(kind: str, iters: int, arch: str = LM_ARCH) -> list:
    """One traced prefill and ``iters`` traced decode steps of ``arch`` at
    full width at ``chip_smoke.SERVE_RUNS["serve_" + kind]``, on each
    backend."""
    from repro_torch.configs import get
    from repro_torch.launch.serve import full_f32, prompts_of
    from repro_torch.models import model
    from repro_torch.random import PRNGKey
    full_f32()
    shape = SERVE_RUNS[f"serve_{kind}"]
    b, l = shape["batch"], shape["prompt"]
    cache_len = l + max(shape["gen"], iters + 2) + 1
    cfg = get(arch)
    params = model.init_params(PRNGKey(0, device="cuda"), cfg)
    prompts = prompts_of(cfg, b, l, "cuda")
    out = []
    for backend in ("cuda", "reference"):
        logits, cache = model.prefill(params, cfg, prompts,
                                      cache_len=cache_len, backend=backend)
        tok = torch.argmax(logits, -1)[:, None]
        model.serve_step(params, cfg, cache, tok, l, backend=backend)
        # the decode steps' wall without the profiler's own host time
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            logits, cache = model.serve_step(params, cfg, cache, tok,
                                             l + 1 + i, backend=backend)
            tok = torch.argmax(logits, -1)[:, None]
        end.record()
        torch.cuda.synchronize()
        untraced = start.elapsed_time(end) / iters
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
            n = 1 if window == "prefill" else iters
            row = _summary(prof, start.elapsed_time(end), n, arch=arch,
                           serve=kind, window=window, backend=backend,
                           batch=b, prompt=l)
            if window == "decode":
                row["untraced_ms_per_iter"] = untraced
            row["by_group"] = _groups(prof, SERVE_GROUPS)
            row["device_kernels_per_iter"] = sum(
                evt.count for evt in prof.key_averages()
                if evt.device_type == DeviceType.CUDA) / n
            out.append(row)
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


MESH_SPANS = ("fed.mesh/draws", "fed.mesh/shard_step", "fed.mesh/fold_server")


def profile_mesh(m: int, d: int, scenario: str, iters: int) -> dict:
    """``iters`` traced rounds of ``fed.run_mesh`` over one shard on the
    card, chb dense on the cuda backend."""
    from repro_torch import fed
    from repro_torch.launch.mesh import make_client_mesh
    task = edge_tasks.make_edge_quadratics(m=m, d=d, seed=0)
    part, loss, quo = MESH_SCENARIOS[scenario]
    sc = fed.MeshScenario(participation=part, loss_prob=loss, quorum=quo,
                          seed=MESH_SEED)
    o = opt.make("chb", 0.5 / m, m, eps1=4.0, backend="cuda")
    mesh = make_client_mesh(1)
    fed.run_mesh(o, task, 2, mesh=mesh, scenario=sc)          # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        fed.run_mesh(o, task, iters, mesh=mesh, scenario=sc,
                     collect_mask=False)
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end)
    spans = {evt.key: evt.cpu_time_total / 1e3
             for evt in prof.key_averages()
             if evt.key in MESH_SPANS and evt.device_type == DeviceType.CPU}
    return {**_summary(prof, wall, iters, spans=MESH_SPANS, mesh=scenario,
                       m=m, d=d, shards=1),
            "span_host_ms": spans,
            "span_share": {k: v / wall for k, v in spans.items()}}


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
                    help="profile serving --arch instead")
    ap.add_argument("--arch", default=LM_ARCH,
                    help="the config --serve serves at full width, or "
                    "--train trains (chb-paper-lm-124m, or a TRAIN_BF16 "
                    "config at its cut)")
    ap.add_argument("--edge", nargs="+", choices=tuple(EDGE_PATHS),
                    help="profile fed.run_edge's rounds instead")
    ap.add_argument("--mesh", nargs="+", choices=tuple(MESH_SCENARIOS),
                    help="profile fed.run_mesh's rounds instead (at --m "
                    "clients and --d)")
    ap.add_argument("--train", nargs="+", choices=("dense", "int8"),
                    help="profile training --arch's steps instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("step_profile: needs a CUDA card")
    if args.train:
        print(json.dumps({"device": torch.cuda.get_device_name(0)}),
              flush=True)
        for uploads in args.train:
            for backend in args.backend:
                print(json.dumps(profile_train(uploads, backend,
                                               args.iters, args.arch)),
                      flush=True)
                torch.cuda.empty_cache()
        return
    if args.mesh:
        print(json.dumps({"device": torch.cuda.get_device_name(0),
                          "d": args.d, "m": args.m}), flush=True)
        for scenario in args.mesh:
            print(json.dumps(profile_mesh(args.m, args.d, scenario,
                                          args.iters)), flush=True)
            torch.cuda.empty_cache()
        return
    if args.serve:
        print(json.dumps({"device": torch.cuda.get_device_name(0)}),
              flush=True)
        for kind in args.serve:
            for row in profile_serve(kind, args.iters, args.arch):
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
