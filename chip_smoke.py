#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Runs from the repository root (it puts ``src/`` on ``sys.path`` itself)
and imports only ``repro_torch``. Phases, each printing one JSON line:

  1. device   -- CUDA must be present; prints ``nvidia-smi``'s name and
                 power limit.
  2. build    -- compiles ``src/repro_torch/kernels/csrc`` with nvcc.
  3. kernels  -- each kernel against its plain PyTorch version on the
                 card: M in {1, 4, 9}, n in {1, 127, 128*257+3, 2^20+17},
                 f32 and f64, masks all 0 / all 1 / mixed, inputs salted
                 with -0.0, one all-zero int8 pending row, top-k keep
                 masks that keep -0.0 entries; the int8 kernels (B5, B6,
                 B7a, B7b) also on rows salted with NaN and +-inf; and four
                 cross-kernel identities (one JSON line). Then the same
                 at M = 70,000, n = 2049 (phase kernels_large_m: past grid
                 y's 65535 blocks, where the per-worker kernels walk the
                 workers; M=1 calls of sampled workers). Then (phase
                 bank_advance_paths) B9's 16-byte and element-wise paths
                 on aligned and misaligned leaves, salted with -0.0, NaN
                 and +-inf, M up to 70,000; (phase absmax_paths) B7a's
                 two paths the same way, against its plain version and
                 B5's abs-max; (phase fused_fold_paths) B2 and B6 on the
                 shape their wrappers dispatch (common.fold_path) and on
                 the other design, at M up to 100,000 and on each side of
                 the threshold, salted with -0.0, NaN and +-inf;
                 (phase attention_kernels) B14 over GQA 1/2/4/6,
                 causal, window and non-causal rectangular shapes on and
                 off its tiles, head dims 32-256, strided and misaligned
                 views, f32 and bf16; B13 over C in {1, 97, 2081}, empty slots, wrapped
                 rings and pos 0; both against an f64 plain version
                 (ATTN_FACTOR); B12a within SQNORM_RTOL and repeatable,
                 B12b bitwise with -0.0 and NaN salted.
  4. golden   -- ``simulator.run`` of chb on the paper's linreg task
                 (m=5, n_per=30, d=20, seed=0) for 60 iterations, dense,
                 int8, top-k (k=8) and low-rank (rank 2), f64 and f32,
                 kernel backend against reference backend, f64 uploads
                 against the JAX package's; at f64 also dense and int8
                 under ``force_staged()`` (against the fused route),
                 per_tensor granularity and the adaptive censor for 80,
                 and csgd, whose uploads, masks and objective are the JAX
                 package's (GOLDEN_CSGD).
  5. full     -- each path at the width of ``chb-paper-lm-124m``
                 (163,597,056 f32 parameters, M=4 workers), 20 iterations:
                 dense, int8 and top-k on one leaf, low-rank on the model's
                 12 leaves, the staged dense and int8 routes and the
                 single-shard ``shard_step`` + ``apply_server`` anchor on
                 one leaf, per_tensor on the 12 leaves; kernel backend
                 against reference backend, staged and sharded against the
                 fused steps, the launch counts read per path.
  many_workers -- benchmarks/fed_mesh.py's edge quadratics (d=16, f64)
                 at its frontier M = 100,000 (fused dense and int8) and at
                 M = 70,000 (the staged routes and top-k, whose worker sum
                 folds in Python), 3 iterations: cuda against reference
                 bit for bit, the launch counts read per path, each
                 path's median step ms.
  edge        -- ``fed.run_edge`` at phase 5's width (M = 4, one leaf of
                 163,597,056 f32), chb dense and int8 and csgd, 10 rounds
                 each: (a) under ``sync_config(4)`` it equals
                 ``simulator.run`` on the card bit for bit; (b) a
                 deployment (one 12x straggler, availability 0.8, 15%
                 loss, quorum 3/4) gives the same masks, counters, wall
                 clock, energy and theta on both backends; (c) B8's M = 1
                 row equals the batched slice; (d) B8 launches once per
                 client evaluation, B3 once per round, nothing else. Also
                 the JAX PRNG's draws on the card against the CPU's. Ms a
                 round and client evaluations a second.
  sweep       -- the sweep engine: (a) ``sweep.run_sweep`` of a 6-point
                 grid (eps1 in {0, 4, 8} x {dense, int8}, 2 partitions)
                 at phase 5's width, 10 iterations, each point equal to
                 ``simulator.run`` bit for bit (masks, comm_cum, bytes,
                 objective, theta), the launches the per-point runs' sum,
                 a ``collect_metrics`` rerun with the same bits and
                 launches; (b) the paper's Fig. 11 setting cut (linreg M =
                 9, f64, 4 eps1 scales x 2 seeds, 300 iterations) on both
                 backends, each point equal to its ``simulator.run``, the
                 masks equal between backends; (c) ``sweep.run_fed_sweep``
                 on (a)'s task, 4 scenarios, 10 rounds: the ideal one equal
                 to ``simulator.run``, all equal on both backends, B8, B9
                 and B3 once a round a scenario. Ms a point-iteration,
                 peak device memory.
  serve       -- ``launch.serve.generate`` of chb-paper-lm-124m at full
                 width (163,597,056 f32 parameters, the JAX package's
                 ``init_params(PRNGKey(0))`` weights), serve_default (batch 4, prompt 64, gen
                 32) and serve_long (batch 8, prompt 2048, gen 32): the
                 cuda backend teacher-forced with the reference backend's
                 tokens, logits within SERVE_LOGIT_TOL and argmax equal
                 where the gap is clear; prefill ms, decode ms a step,
                 tok/s; B14 12 launches a prefill, B13 12 a step.
  jax_pin     -- the reduced and GQA configs with numpy weights on the
                 cuda backend: the JAX package's greedy tokens exactly and
                 its prefill-logit checksums (SERVE_PIN).
  ops         -- the four single-tensor ``kernels.ops`` entry points
                 (B12a, B12b, B3 at n = 163,597,056 f32, B14) against their
                 plain versions.
  6. timing   -- each kernel, its plain version, its library call where
                 one exists and its bound at the main path's shape (B2 and
                 B6 also at the fed-mesh shape, on both designs, beside
                 the measured floor of an exact fold there:
                 benchmarks_torch/chain_floor.py); then the
                 ``{"kernels": [...]}`` line of all 16 kernels.

The last line is ``{"ok": true, "device": {...}}``. Every failed check
raises, so the script exits non-zero and prints no last line; without
CUDA it stops before any phase.
"""
from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch  # noqa: E402,F401  (fails at once outside a checkout)
from repro_torch.configs import get as get_config  # noqa: E402
from repro_torch.convert import named_leaves  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.random import PRNGKey  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

LM_ARCH = "chb-paper-lm-124m"
# the parameter leaves of chb-paper-lm-124m, read from the port's own
# init_params on the meta device (shapes only): the tree the low-rank and
# per_tensor paths run on, and the width of the full-width phase
LM_LEAVES = {name: tuple(x.shape) for name, x in named_leaves(init_params(
    PRNGKey(0, device="cpu"), get_config(LM_ARCH), device="meta")).items()}

# full-width configuration: the parameter count of configs/chb_paper_lm.py
# (chb-paper-lm-124m), M = TrainConfig.num_workers' default, and the
# step size / eps1 of benchmarks/fed_mesh.py's edge-quadratics runs
FULL_D = sum(math.prod(shape) for shape in LM_LEAVES.values())
FULL_M = 4
FULL_ITERS = 20
FULL_ALPHA = 0.5 / FULL_M
FULL_EPS1 = 4.0

# the fed-mesh scale: benchmarks/fed_mesh.py's edge quadratics (d=16,
# seed 0, chb at alpha 0.5/M, eps1 4.0) at its frontier M = 100,000 for the
# fused dense and int8 routes, whose worker sum runs in B2/B6; at 70,000
# (past grid y's 65535 blocks still) for the staged routes and top-k,
# whose worker sum, like the reference backend's, folds in Python, one
# eager add a worker. f64, 3 iterations, both backends.
MANY_M = 100_000
MANY_M_PYTHON_FOLD = 70_000
MANY_D = 16
MANY_ITERS = 3
MANY_PATHS = {  # path: (M, opt.make keywords)
    "dense": (MANY_M, {}),
    "int8": (MANY_M, {"quantize": "int8"}),
    "dense_staged": (MANY_M_PYTHON_FOLD, {}),
    "int8_staged": (MANY_M_PYTHON_FOLD, {"quantize": "int8"}),
    "topk": (MANY_M_PYTHON_FOLD, {"transport": "topk",
                                  "k": (2 * MANY_D) // 5}),
}
# the M of phase 3's second pass over every kernel
LARGE_M = 70_000

# chb on linreg (m=5, n_per=30, d=20, seed=0), 60 iterations. At f64 the
# JAX package's reference and pallas backends both give these uploads and
# final objectives (tests/test_torch_simulator.py holds the port to that
# run in-process); every eq.-(8) decision there clears its threshold by
# more than 2%, so the count is the same on any platform. Top-k runs at
# k=8 and low-rank at rank 2; the task's one leaf is a vector, which the
# low-rank transport ships dense, so its run is the dense run.
GOLDEN_F64 = {"dense": (240, float.fromhex("0x1.107a2630170dfp+6")),
              "int8": (240, float.fromhex("0x1.107a2630170dep+6")),
              "topk": (295, float.fromhex("0x1.107a279e9e656p+6")),
              "lowrank": (240, float.fromhex("0x1.107a2630170dfp+6"))}
# at f32 the run reaches the f32 noise floor near iteration 30, after which
# eq. (8) compares rounding noise and the totals depend on the platform's
# rounding: tests/test_backend.py pins XLA-CPU's, printed here beside ours
GOLDEN_F32 = {"dense": 262, "int8": 259, "topk": 295, "lowrank": 262}
GOLDEN_OBJECTIVE = float.fromhex("0x1.107a260000000p+6")
GOLDEN_KW = {"dense": {}, "int8": {"quantize": "int8"},
             "topk": {"transport": "topk", "k": 8},
             "lowrank": {"transport": "lowrank", "rank": 2}}
# the same task for 80 iterations at f64: the JAX package's uploads for chb
# with per_tensor granularity and for the adaptive censor (0.25, decay 0.9)
# with the hb server (tests/test_opt.py's pre-redesign pins)
GOLDEN_F64_80 = {"per_tensor": 339, "adaptive": 83}
GOLDEN_ADAPTIVE = 0.25
# csgd (tau0 0.05, decay 0.99, seed 0) on the same task, 60 iterations at
# f64: the JAX package's uploads, each iteration's mask as a bit row (bit w
# = worker w transmitted) and final objective. Every decision clears its
# threshold u * tau_k by more than CSGD_MIN_MARGIN of it (the uniforms are
# the JAX PRNG's, bit for bit). tests/test_torch_fed.py recomputes them
# with the JAX package:
#   PYTHONPATH=src python -m pytest -q tests/test_torch_fed.py -k pins
GOLDEN_CSGD_TAU0 = 0.05
GOLDEN_CSGD = (59, [31, 31, 28, 31, 28, 16, 13, 16, 14, 0, 1, 24, 0, 0, 6,
                    8, 0, 0, 0, 0, 2, 9, 0, 4, 0, 0, 16, 0, 4, 16, 0, 0, 0,
                    0, 16, 8, 0, 16, 0, 8, 0, 0, 20, 0, 24, 2, 0, 0, 24, 0,
                    16, 4, 0, 0, 16, 0, 0, 16, 16, 4],
               float.fromhex("0x1.107b06c911d37p+6"))
CSGD_MIN_MARGIN = 1e-3

# phase edge: fed.run_edge at the full width of phase 5 (M = 4 clients,
# one f32 leaf of 163,597,056), chb dense and int8 at phase 5's alpha and
# eps1, and csgd (tau0 5 per parameter: a mix of sends and skips on this
# task), EDGE_ROUNDS server rounds each. The deployment scenario is
# examples/edge_deployment.py's cut to 4 clients: one 12x straggler,
# availability 0.8, 15% loss at 1 Mbps, a quorum of 3 of 4, seed 0.
EDGE_ROUNDS = 10
# the ulps by which the port's normal draws may differ from JAX's on the
# CPU (tests/test_torch_random.py)
NORMAL_MAX_ULP = 3
EDGE_PATHS = {"chb": ("chb", {"eps1": 4.0}),
              "chb_int8": ("chb", {"eps1": 4.0, "quantize": "int8"}),
              "csgd": ("csgd", {"tau0": 5.0 * 163_597_056})}

# top-k keeps 40% of the entries: the repo's density rule (2*d)//5 of
# benchmarks/common.py's task-scaled top-k curve
FULL_TOPK_K = (2 * FULL_D) // 5
FULL_RANK = 2

# The JAX pin of serving. chb-paper-lm-124m's reduced() (2 layers, d 256,
# vocab 512) and its GQA variant (2 kv heads, layers "AS", window 16,
# qk_norm), with weights from convert.numpy_model_params(cfg, seed), prompts
# serve.prompts_of(cfg, 2, 24) and a cache of 41 slots: the JAX package's
# greedy tokens of 16 steps (prefill's argmax, then 15 serve_steps) and the
# sum and abs-sum of its prefill logits, computed with the JAX package on
# the CPU in f32 (models.model.prefill / serve_step). The seeds keep every
# compared top-2 gap above 1e-3 (0.024 and 0.021 here), so the tokens do
# not turn on rounding. tests/test_torch_models.py recomputes both with
# the JAX package and holds them to these constants:
#   PYTHONPATH=src python -m pytest -q tests/test_torch_models.py -k pins
SERVE_PIN_SEEDS = {"reduced": 0, "gqa": 1}
SERVE_PIN = {
    "reduced": (
        [[106, 491, 424, 231, 307, 334, 306, 466, 58, 179, 62, 201, 132, 18,
          317, 437],
         [233, 428, 89, 233, 269, 124, 124, 127, 53, 270, 124, 187, 233, 139,
          233, 411]],
        -12.472770690917969, 792.0371704101562),
    "gqa": (
        [[454, 287, 169, 75, 75, 287, 169, 311, 148, 347, 287, 287, 287, 287,
          471, 24],
         [417, 354, 417, 199, 252, 354, 252, 392, 147, 235, 261, 229, 392, 149,
          261, 422]],
        -7.226400375366211, 799.6193237304688),
}
# both checksums within this fraction of the abs-sum: the largest
# per-logit difference between the JAX package on the CPU and the port is
# about 6e-6 against a mean |logit| near 0.78 (tests/test_torch_models.py)
SERVE_PIN_RTOL = 1e-4
SERVE_PIN_SHAPE = {"batch": 2, "prompt": 24, "gen": 16, "cache": 41}

# H100 SXM device-memory rate (NVIDIA data sheet); the bound of every
# kernel here is its bytes over this rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# sqnorms accumulate in f32 for both bank dtypes (the delta is cast to f32
# before squaring, as in the JAX kernels), so one bound serves both: the
# kernel's chunked tree and torch.sum group the same f32 terms differently
SQNORM_RTOL = 1e-5

KERNEL_META = {
    "censor_delta_sqnorm_batched": ("src/repro_torch/kernels/csrc/censor.cu",
                                    "src/repro/kernels/censor.py:131"),
    "sqnorm_batched": ("src/repro_torch/kernels/csrc/censor.cu",
                       "src/repro/kernels/censor.py:168"),
    "bank_advance": ("src/repro_torch/kernels/csrc/censor.cu",
                     "src/repro/kernels/censor.py:248"),
    "hb_update": ("src/repro_torch/kernels/csrc/hb_update.cu",
                  "src/repro/kernels/hb_update.py:41"),
    "select_pack_ef_batched": ("src/repro_torch/kernels/csrc/topk_pack.cu",
                               "src/repro/kernels/topk_pack.py:47"),
    "residual_ef_batched": ("src/repro_torch/kernels/csrc/lowrank_ef.cu",
                            "src/repro/kernels/lowrank_ef.py:43"),
    "fused_dense_step": ("src/repro_torch/kernels/csrc/fused_step.cu",
                         "src/repro/kernels/fused_step.py:126"),
    "int8_stats_batched": ("src/repro_torch/kernels/csrc/fused_step.cu",
                           "src/repro/kernels/fused_step.py:198"),
    "fused_int8_step": ("src/repro_torch/kernels/csrc/fused_step.cu",
                        "src/repro/kernels/fused_step.py:270"),
    "censor_bank_advance": ("src/repro_torch/kernels/csrc/censor.cu",
                            "src/repro/kernels/censor.py:203"),
    "absmax_batched": ("src/repro_torch/kernels/csrc/quantize_ef.cu",
                       "src/repro/kernels/quantize_ef.py:40"),
    "quantize_ef_batched": ("src/repro_torch/kernels/csrc/quantize_ef.cu",
                            "src/repro/kernels/quantize_ef.py:79"),
    "censor_delta_sqnorm": ("src/repro_torch/kernels/csrc/censor.cu",
                            "src/repro/kernels/censor.py:60"),
    "censor_select": ("src/repro_torch/kernels/csrc/censor.cu",
                      "src/repro/kernels/censor.py:93"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:60"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:71"),
}

# B13/B14 against their plain versions: the kernel's max abs error against
# an f64 plain version on the card (the same function without the f32
# casts) is at most ATTN_FACTOR times the f32 plain version's own max abs
# error against it, plus ATTN_FLOOR. Both f32 versions round the one f64
# function; the kernel sums its products and its softmax in another order
# (online, tile by tile), which may cost a few times the plain version's
# rounding, never more.
ATTN_FACTOR = 4.0
ATTN_FLOOR = 1e-6

# serving at full width: chb-paper-lm-124m (12 layers, d 768, 12/12 heads,
# hd 64, vocab 32,768), weights from init_params(PRNGKey(0)), the JAX
# package's launch.serve weights.
# serve_default is launch/serve.py's defaults; serve_long a 2048-token
# prompt, whose decode steps read 12 x 102 MB of KV cache through B13 (more
# than the 0.65 GB of weights). The cache holds prompt + gen + 1 slots.
SERVE_RUNS = {"serve_default": {"batch": 4, "prompt": 64, "gen": 32},
              "serve_long": {"batch": 8, "prompt": 2048, "gen": 32}}
# the cuda and reference backends' logits (prefill and every
# teacher-forced step) agree within SERVE_LOGIT_TOL (absolute); their
# argmax must then agree wherever the reference's top-2 gap exceeds twice
# it (an order that no pair of errors within the tolerance can flip)
SERVE_LOGIT_TOL = 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bits(t: torch.Tensor) -> torch.Tensor:
    """The raw bits of a float tensor (tells -0.0 from +0.0)."""
    return t.contiguous().view({torch.float32: torch.int32,
                                torch.float64: torch.int64,
                                torch.bfloat16: torch.int16}[t.dtype])


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape \
        and torch.equal(bits(a), bits(b))


def same_or_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    """NaN exactly where b is NaN, the same bits everywhere else."""
    nan = torch.isnan(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and torch.equal(torch.isnan(a), nan) \
        and torch.equal(bits(a)[~nan], bits(b)[~nan])


def max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def sample_workers(m: int):
    """The workers whose M=1 calls are held against the batched row: all
    of a small M; past grid y's 65535 blocks, the first and last worker of
    each block's walk and one between."""
    if m <= 16:
        return range(m)
    return sorted({0, 1, m // 2, 65534, 65535, m - 1} & set(range(m)))


# ------------------------------------------------------------ phase 1
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "runs on a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device_count": torch.cuda.device_count()})
    return smi


# ------------------------------------------------------------ phase 2
def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build()
    seconds = time.perf_counter() - t0
    for name, log in logs.items():
        print(f"--- nvcc {name}.cu\n{log}", file=sys.stderr)
    for name in build.SOURCES:
        build.library(name)
    emit({"phase": "build", "seconds": seconds,
          "compiled": sorted(logs), "dir": str(build.BUILD_DIR)})


# ------------------------------------------------------------ phase 3
def _inputs(m, n, dtype, seed, device):
    """g, ghat, err (M, n) and theta, theta_prev (n,), salted with -0.0."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float64).to(dtype)

    g, h, e = randn(m, n), randn(m, n), randn(m, n) * 0.01
    t, p = randn(n), randn(n)
    neg0 = torch.tensor(-0.0, dtype=dtype, device=device)
    g[:, ::7] = neg0
    h[:, ::11] = neg0
    e[:, ::5] = neg0
    h[:, ::77] = 0.0            # g = -0.0, ghat = +0.0 on these columns
    t[::13] = neg0
    p[::13] = 0.0
    zero_row = m - 1 if m > 1 else (0 if n == 1 else None)
    if zero_row is not None:     # pending all zero: amax 0, scale 1
        g[zero_row] = h[zero_row]
        e[zero_row] = 0.0
    return g, h, e, t, p


def _masks(m, device):
    mixed = torch.tensor([float(i % 2 == 0) for i in range(m)],
                         device=device)
    return {"zeros": torch.zeros(m, device=device),
            "ones": torch.ones(m, device=device), "mixed": mixed}


def _keep(g: torch.Tensor, seed: int) -> torch.Tensor:
    """0/1 top-k keep masks in g's dtype. g holds -0.0 on every 7th
    column: columns 7, 21, ... keep theirs, 0, 14, ... drop it; a -0.0 in
    the mask itself reads as "drop"."""
    gen = torch.Generator(device=g.device).manual_seed(seed + 5)
    keep = (torch.rand(g.shape, generator=gen, device=g.device) < 0.4
            ).to(g.dtype)
    keep[:, ::7] = 1.0
    keep[:, ::14] = 0.0
    keep[:, 3::29] = -0.0
    return keep


def _check_staged(g, h, e, keep, pend, scale, mask, mtag, max_err) -> dict:
    """B4, B7b, B9, B10 and B11 against their plain versions under one
    mask: bitwise, on repeat launches and on M=1 calls of each worker.
    Returns each kernel's outputs."""
    from repro_torch.kernels import (censor, lowrank_ef, quantize_ef, ref,
                                     topk_pack)
    m = g.shape[0]
    calls = {  # kernel: (label, wrapper, plain, operands without the mask)
        "censor_bank_advance": ("B4", censor.censor_bank_advance,
                                ref.censor_bank_advance, (g, h)),
        "quantize_ef_batched": (
            "B7b", lambda p_, e_, s_, mk: quantize_ef.quantize_ef_batched(
                p_, e_, mk, s_),
            lambda p_, e_, s_, mk: ref.quantize_ef_batched(p_, e_, mk, s_),
            (pend, e, scale)),
        "bank_advance": ("B9", censor.bank_advance, ref.bank_advance,
                         (h, g)),
        "select_pack_ef_batched": ("B10", topk_pack.select_pack_ef_batched,
                                   ref.select_pack_ef_batched, (g, e, keep)),
        # an arbitrary-float payload: the residual of a reconstruction
        "residual_ef_batched": ("B11", lowrank_ef.residual_ef_batched,
                                ref.residual_ef_batched, (g, h, e)),
    }
    results = {}
    for name, (kname, fn, plain, ops) in calls.items():
        out = fn(*ops, mask)
        want = plain(*ops, mask)
        outs = out if isinstance(out, tuple) else (out,)
        wants = want if isinstance(want, tuple) else (want,)
        results[name] = outs
        max_err[name] = max([max_err[name]] + [
            max_diff(a, b) for a, b in zip(outs, wants)])
        check(all(same_bits(a, b) for a, b in zip(outs, wants)),
              f"{kname} {mtag}")
        again = fn(*ops, mask)
        again = again if isinstance(again, tuple) else (again,)
        check(all(same_bits(a, b) for a, b in zip(outs, again)),
              f"{kname} repeat {mtag}")
        for w in sample_workers(m):
            one = fn(*(x[w:w + 1] for x in ops), mask[w:w + 1])
            one = one if isinstance(one, tuple) else (one,)
            check(all(same_bits(a, b[w:w + 1]) for a, b in zip(one, outs)),
                  f"{kname} M=1 slice {w} {mtag}")
    return results


def _check_nonfinite(g, h, e, t, p, tag) -> None:
    """B5, B6, B7a and B7b on rows salted with NaN and +-inf: NaN where
    their plain versions give NaN (as torch.amax and torch.clamp do), the
    same bits elsewhere. A NaN row's scale is 1 and its NaN entry stays NaN
    in the payload, not a clipped -127*scale."""
    from repro_torch.core.quantize import int8_scale
    from repro_torch.kernels import fused_step, quantize_ef, ref
    m, n = g.shape
    g, h = g.clone(), h.clone()
    g[0, 1] = float("nan")
    if m > 1:
        g[1, 0] = float("inf")
        g[1, n - 1] = float("-inf")
    if m > 2:
        h[2, n // 2] = float("nan")
    mask = torch.tensor([float(i % 2 == 0) for i in range(m)],
                        device=g.device)
    sq, am = fused_step.int8_stats_batched(g, h, e)
    sq_p, am_p = ref.int8_stats_batched(g, h, e)
    check(same_or_nan(am, am_p), f"B5 absmax, NaN/inf rows {tag}")
    fin = torch.isfinite(sq_p)
    check(torch.equal(torch.isfinite(sq), fin)
          and (not fin.any() or _rel_err(sq[fin], sq_p[fin]) <= SQNORM_RTOL),
          f"B5 sqnorm, NaN/inf rows {tag}")
    scale = int8_scale(am)
    check(bool(torch.isnan(am[0])) and float(scale[0]) == 1.0,
          f"B5 NaN row: amax {float(am[0])}, scale {float(scale[0])} {tag}")
    out = fused_step.fused_int8_step(g, h, e, t, p, mask, scale, 0.1, 0.4)
    plain = ref.fused_int8_step(g, h, e, t, p, mask, scale, 0.1, 0.4)
    for a, b, what in zip(out, plain, ("ghat'", "err'", "agg", "theta'")):
        check(same_or_nan(a, b), f"B6 {what}, NaN/inf rows {tag}")
    pend = (g - h) + e
    am7 = quantize_ef.absmax_batched(pend)
    check(same_or_nan(am7, ref.absmax_batched(pend)) and same_or_nan(am7, am),
          f"B7a, NaN/inf rows {tag}")
    pay, err = quantize_ef.quantize_ef_batched(pend, e, mask, scale)
    pay_p, err_p = ref.quantize_ef_batched(pend, e, mask, scale)
    check(same_or_nan(pay, pay_p) and same_or_nan(err, err_p)
          and same_or_nan(err, out[1]), f"B7b, NaN/inf rows {tag}")
    check(bool(torch.isnan(pay[0, 1])), f"B7b NaN entry not kept {tag}")


def _check_rows(g, h, e, keep, tag, topk_pack, lowrank_ef) -> None:
    """The ``*_row`` wrappers equal the batched call's worker slice under
    the all-ones mask they pin."""
    m = g.shape[0]
    ones = torch.ones(m, device=g.device)
    pay, ne = topk_pack.select_pack_ef_batched(g, e, keep, ones)
    res = lowrank_ef.residual_ef_batched(g, h, e, ones)
    for w in sample_workers(m):
        rp, rn = topk_pack.select_pack_ef_row(g[w], e[w], keep[w])
        check(same_bits(rp, pay[w]) and same_bits(rn, ne[w]),
              f"B10 row {w} {tag}")
        check(same_bits(lowrank_ef.residual_ef_row(g[w], h[w], e[w]),
                        res[w]), f"B11 row {w} {tag}")


def _rel_err(k: torch.Tensor, p: torch.Tensor) -> float:
    scale = torch.clamp(p.abs(), min=torch.finfo(torch.float32).tiny)
    return float(torch.max((k - p).abs() / scale))


def phase_kernels(device, ms=(1, 4, 9),
                  ns=(1, 127, 128 * 257 + 3, 2 ** 20 + 17),
                  dtypes=(torch.float32, torch.float64),
                  phase="kernels") -> dict:
    """Every kernel against its plain version; returns max abs errors."""
    from repro_torch.core.quantize import int8_scale
    from repro_torch.kernels import (censor, fused_step, hb_update,
                                     lowrank_ef, quantize_ef, ref, topk_pack)
    from repro_torch.opt import GradientDescent, HeavyBall
    max_err = {name: 0.0 for name in KERNEL_META}
    cases = nonfinite = 0
    # the cross-kernel identities: each must hold bit for bit in every case
    ident = {"B4 == B2 ghat'": 0, "B7a == B5 amax": 0,
             "B7b err' == B6 err'": 0, "B8(pending) == B5 sqnorm": 0}
    alpha, beta = 0.0123, 0.4
    for dtype in dtypes:
        for m in ms:
            for n in ns:
                seed = 1000 * m + n % 997 + (dtype == torch.float64)
                g, h, e, t, p = _inputs(m, n, dtype, seed, device)
                tag = f"{dtype} M={m} n={n}"

                # B1
                k = censor.censor_delta_sqnorm_batched(g, h)
                pl = ref.censor_delta_sqnorm_batched(g, h)
                check(_rel_err(k, pl) <= SQNORM_RTOL, f"B1 sqnorm {tag}")
                max_err["censor_delta_sqnorm_batched"] = max(
                    max_err["censor_delta_sqnorm_batched"],
                    float((k - pl).abs().max()))
                check(same_bits(k, censor.censor_delta_sqnorm_batched(g, h)),
                      f"B1 repeat {tag}")
                for w in sample_workers(m):
                    check(same_bits(k[w:w + 1],
                                    censor.censor_delta_sqnorm_batched(
                                        g[w:w + 1], h[w:w + 1])),
                          f"B1 M=1 slice {w} {tag}")

                # B8: on x = g - ghat it is B1, bit for bit
                x = g - h
                k8 = censor.sqnorm_batched(x)
                pl = ref.sqnorm_batched(x)
                check(_rel_err(k8, pl) <= SQNORM_RTOL, f"B8 sqnorm {tag}")
                check(same_bits(k8, k), f"B8 on g - ghat != B1 {tag}")
                max_err["sqnorm_batched"] = max(max_err["sqnorm_batched"],
                                                float((k8 - pl).abs().max()))
                check(same_bits(k8, censor.sqnorm_batched(x)),
                      f"B8 repeat {tag}")
                for w in sample_workers(m):
                    check(same_bits(k8[w:w + 1],
                                    censor.sqnorm_batched(x[w:w + 1])),
                          f"B8 M=1 slice {w} {tag}")
                del x

                # B3, at beta > 0 and at the gd server's beta = 0
                nab = g[0]
                for a_, b_, server in ((alpha, beta, HeavyBall(alpha, beta)),
                                       (alpha, 0.0, GradientDescent(alpha))):
                    out = hb_update.hb_update(t, nab, p, a_, b_)
                    check(same_bits(out, ref.hb_update(t, nab, p, a_, b_)),
                          f"B3 beta={b_} {tag}")
                    check(same_bits(out, server.apply(t, p, nab)),
                          f"B3 beta={b_} != {type(server).__name__} {tag}")
                    check(same_bits(out, hb_update.hb_update(t, nab, p, a_,
                                                             b_)),
                          f"B3 repeat beta={b_} {tag}")

                # B5
                sq, am = fused_step.int8_stats_batched(g, h, e)
                sq_p, am_p = ref.int8_stats_batched(g, h, e)
                check(_rel_err(sq, sq_p) <= SQNORM_RTOL, f"B5 sqnorm {tag}")
                check(same_bits(am, am_p), f"B5 absmax {tag}")
                max_err["int8_stats_batched"] = max(
                    max_err["int8_stats_batched"],
                    float((sq - sq_p).abs().max()))
                sq2, am2 = fused_step.int8_stats_batched(g, h, e)
                check(same_bits(sq, sq2) and same_bits(am, am2),
                      f"B5 repeat {tag}")
                for w in sample_workers(m):
                    sq1, am1 = fused_step.int8_stats_batched(
                        g[w:w + 1], h[w:w + 1], e[w:w + 1])
                    check(same_bits(sq[w:w + 1], sq1)
                          and same_bits(am[w:w + 1], am1),
                          f"B5 M=1 slice {w} {tag}")
                scale = int8_scale(am)
                if m > 1 or n == 1:
                    check(float(scale[-1]) == 1.0, f"B5 zero row scale {tag}")
                keep = _keep(g, seed)

                # B7a, on the pending tree the staged int8 step materializes
                pend = (g - h) + e
                am7 = quantize_ef.absmax_batched(pend)
                check(same_bits(am7, ref.absmax_batched(pend)), f"B7a {tag}")
                max_err["absmax_batched"] = max(
                    max_err["absmax_batched"],
                    max_diff(am7, ref.absmax_batched(pend)))
                check(same_bits(am7, quantize_ef.absmax_batched(pend)),
                      f"B7a repeat {tag}")
                for w in sample_workers(m):
                    check(same_bits(am7[w:w + 1],
                                    quantize_ef.absmax_batched(
                                        pend[w:w + 1])),
                          f"B7a M=1 slice {w} {tag}")
                check(same_bits(am7, am), f"B7a != B5 amax {tag}")
                ident["B7a == B5 amax"] += 1
                # the staged int8 masks equal the fused ones only if B8 on
                # the materialized pending is B5's sqnorm, bit for bit
                check(same_bits(censor.sqnorm_batched(pend), sq),
                      f"B8 on pending != B5 sqnorm {tag}: max rel "
                      f"{_rel_err(censor.sqnorm_batched(pend), sq)}")
                ident["B8(pending) == B5 sqnorm"] += 1

                for mname, mask in _masks(m, device).items():
                    mtag = f"{tag} mask={mname}"
                    # B2
                    out = fused_step.fused_dense_step(g, h, t, p, mask,
                                                      alpha, beta)
                    plain = ref.fused_dense_step(g, h, t, p, mask,
                                                 alpha, beta)
                    for a, b, what in zip(out, plain,
                                          ("ghat'", "agg", "theta'")):
                        check(same_bits(a, b), f"B2 {what} {mtag}")
                    again = fused_step.fused_dense_step(g, h, t, p, mask,
                                                        alpha, beta)
                    check(all(same_bits(a, b) for a, b in zip(out, again)),
                          f"B2 repeat {mtag}")
                    dense_ghat = out[0]
                    for w in sample_workers(m):
                        one = fused_step.fused_dense_step(
                            g[w:w + 1], h[w:w + 1], t, p, mask[w:w + 1],
                            alpha, beta)
                        check(same_bits(one[0], out[0][w:w + 1]),
                              f"B2 M=1 slice {w} {mtag}")
                    # B6
                    out = fused_step.fused_int8_step(g, h, e, t, p, mask,
                                                     scale, alpha, beta)
                    plain = ref.fused_int8_step(g, h, e, t, p, mask, scale,
                                                alpha, beta)
                    for a, b, what in zip(out, plain, ("ghat'", "err'",
                                                       "agg", "theta'")):
                        check(same_bits(a, b), f"B6 {what} {mtag}")
                    again = fused_step.fused_int8_step(g, h, e, t, p, mask,
                                                       scale, alpha, beta)
                    check(all(same_bits(a, b) for a, b in zip(out, again)),
                          f"B6 repeat {mtag}")
                    for w in sample_workers(m):
                        one = fused_step.fused_int8_step(
                            g[w:w + 1], h[w:w + 1], e[w:w + 1], t, p,
                            mask[w:w + 1], scale[w:w + 1], alpha, beta)
                        check(same_bits(one[0], out[0][w:w + 1])
                              and same_bits(one[1], out[1][w:w + 1]),
                              f"B6 M=1 slice {w} {mtag}")
                    staged = _check_staged(g, h, e, keep, pend, scale, mask,
                                           mtag, max_err)
                    check(same_bits(staged["censor_bank_advance"][0],
                                    dense_ghat), f"B4 != B2 ghat' {mtag}")
                    ident["B4 == B2 ghat'"] += 1
                    check(same_bits(staged["quantize_ef_batched"][1],
                                    out[1]), f"B7b err' != B6 err' {mtag}")
                    ident["B7b err' == B6 err'"] += 1
                    del staged
                    cases += 1
                _check_rows(g, h, e, keep, tag, topk_pack, lowrank_ef)
                if n >= 3:
                    _check_nonfinite(g, h, e, t, p, tag)
                    nonfinite += 1
                del pend
    emit({"phase": phase, "ms": list(ms), "ns": list(ns),
          "cases": cases, "nonfinite_cases": nonfinite,
          "max_abs_err": max_err, "sqnorm_rtol": SQNORM_RTOL,
          "elementwise": "bitwise, including the sign of zero; NaN where "
          "the plain version gives NaN"})
    emit({"phase": f"identities ({phase})", "cases_held_bitwise": ident})
    return max_err


# (m, n, storage offset) of B9's path cases: aligned rows of 16-byte
# vectors and the element-wise path (a leaf view one element off its
# storage's alignment; phase 3's odd n already take it) at M = 1, 4, 9,
# and both at M = 70000, past grid y's 65535 blocks
BANK_PATH_CASES = [(m, n, off) for m in (1, 4, 9)
                   for n, off in ((4, 0), (128 * 257 + 4, 0), (2 ** 20, 0),
                                  (4096, 1), (2 ** 20 + 4, 1))] \
    + [(70000, 36, 0), (70000, 36, 1)]
# B7a's path cases: the 16-byte path (n a multiple of the elements in 16
# bytes, an aligned leaf), the element-wise path (odd n, or a view one
# element off alignment), one and several 32,768-element spans, M up to
# 70000 (tests/test_torch_cuda.py::test_absmax_vector_and_scalar_paths)
ABSMAX_PATH_CASES = [
    (1, 4096, 0), (4, 4096, 0), (9, 4096, 0), (4, 4099, 0), (9, 70001, 0),
    (4, 4096, 1), (9, 4100, 1), (4, 2 ** 17 + 4, 0), (1, 1, 0), (1, 3, 1),
    (70000, 36, 0), (70000, 33, 0), (70000, 36, 1)]


def _offset_leaf(m, n, off, dtype, device, gen) -> torch.Tensor:
    """An (M, n) leaf of normal draws starting ``off`` elements into its
    storage."""
    flat = torch.randn(off + m * n, generator=gen, device=device,
                       dtype=dtype)
    return flat[off:].view(m, n)


def phase_bank_advance_paths(device,
                             dtypes=(torch.float32, torch.float64)) -> None:
    """B9's two paths against its plain version, bit for bit, on the
    BANK_PATH_CASES, inputs salted with -0.0, NaN and +-inf, all three
    masks, a repeat launch and the M=1 calls of sample_workers."""
    from repro_torch.kernels import censor, ref
    cases = 0
    for dtype in dtypes:
        for m, n, off in BANK_PATH_CASES:
            gen = torch.Generator(device=device).manual_seed(
                m * 7 + n % 1009 + off)
            h = _offset_leaf(m, n, off, dtype, device, gen)
            q = _offset_leaf(m, n, off, dtype, device, gen)
            h[:, ::7] = -0.0
            q[:, ::5] = -0.0
            q[:, 3::11] = float("nan")
            h[:, 1::13] = float("inf")
            q[:, 2::17] = float("-inf")
            tag = f"B9 paths {dtype} M={m} n={n} offset={off}"
            for mname, mask in _masks(m, device).items():
                out = censor.bank_advance(h, q, mask)
                check(same_bits(out, ref.bank_advance(h, q, mask)),
                      f"{tag} mask={mname}")
                check(same_bits(out, censor.bank_advance(h, q, mask)),
                      f"{tag} mask={mname}: repeat")
                for w in sample_workers(m):
                    check(same_bits(censor.bank_advance(
                        h[w:w + 1], q[w:w + 1], mask[w:w + 1]),
                        out[w:w + 1]), f"{tag} mask={mname}: M=1 {w}")
                cases += 1
    emit({"phase": "bank_advance_paths", "cases": cases,
          "rule": "bitwise, -0.0, NaN and inf included"})


def phase_absmax_paths(device,
                       dtypes=(torch.float32, torch.float64)) -> None:
    """B7a's 16-byte and element-wise paths on the ABSMAX_PATH_CASES, rows
    salted with -0.0, NaN and +-inf and one row all -0.0: rows without a
    NaN bitwise equal to the plain version (+0 for the -0.0 row), NaN rows
    NaN, every row equal to B5's abs-max of the same pending, a repeat
    launch and the M=1 calls of sample_workers."""
    from repro_torch.kernels import fused_step, quantize_ef, ref
    cases = 0
    for dtype in dtypes:
        for m, n, off in ABSMAX_PATH_CASES:
            tag = f"B7a paths {dtype} M={m} n={n} offset={off}"
            gen = torch.Generator(device=device).manual_seed(m * 13 + n + off)
            g, h, e = (_offset_leaf(m, n, 0, dtype, device, gen)
                       for _ in range(3))
            g[:, ::5], h[:, ::5], e[:, ::5] = -0.0, 0.0, -0.0
            g[1::4, 0] = float("inf")
            g[1::4, n - 1] = float("-inf")
            g[2::4, n // 2] = float("nan")
            if m > 3:
                g[3], h[3], e[3] = -0.0, 0.0, -0.0
            pend = (g - h) + e
            x = _offset_leaf(m, n, off, dtype, device, gen)
            x.copy_(pend)
            am = quantize_ef.absmax_batched(x)
            check(same_or_nan(am, ref.absmax_batched(pend)), tag)
            check(torch.equal(torch.isnan(am), torch.isnan(pend).any(dim=1)),
                  f"{tag}: NaN rows")
            if m > 3:
                check(int(bits(am[3:4])[0]) == 0,
                      f"{tag}: the -0.0 row gives {float(am[3])}, not +0")
            check(same_or_nan(am, fused_step.int8_stats_batched(g, h, e)[1]),
                  f"{tag}: B7a != B5 amax")
            check(same_or_nan(am, quantize_ef.absmax_batched(x)),
                  f"{tag}: repeat")
            for w in sample_workers(m):
                check(same_or_nan(quantize_ef.absmax_batched(x[w:w + 1]),
                                  am[w:w + 1]), f"{tag}: M=1 {w}")
            cases += 1
            del g, h, e, pend, x
    emit({"phase": "absmax_paths", "cases": cases,
          "rule": "bitwise where no NaN, NaN rows NaN, equal to B5's "
          "abs-max; -0.0, NaN and inf salted"})


def fold_path_cases(sms: int) -> list:
    """(M, n) of B2/B6's design cases: the fed-mesh frontier, phase
    kernels_large_m's shape, one column past grid y's 65535 blocks, a short
    tall bank, and each side of ``common.fold_path``'s threshold (M at
    ONE_PASS_MAX_WORKERS and one above; n one short of a column for every
    thread the card holds, and at it)."""
    from repro_torch.kernels.common import (ONE_PASS_MAX_WORKERS,
                                            THREADS_PER_SM)
    mo, wide = ONE_PASS_MAX_WORKERS, sms * THREADS_PER_SM
    return [(MANY_M, MANY_D), (LARGE_M, 2049), (65536, 1), (300, 16),
            (mo, 16), (mo + 1, 16), (mo + 1, wide - 1), (mo + 1, wide)]


def _fold_inputs(m, n, dtype, device, seed):
    """B2/B6 operands salted with -0.0 (column 0 all -0.0; column 1 a
    ghat' of -0.0 in every row under the all-zeros mask) and, where n >= 3,
    NaN and +-inf in the last columns."""
    g, h, e, t, p = _inputs(m, n, dtype, seed, device)
    g[:, 0], h[:, 0], e[:, 0] = -0.0, -0.0, -0.0
    if n > 1:
        g[:, 1], h[:, 1] = -1.0, -0.0
    if n >= 3:
        g[m // 2, n - 1] = float("nan")
        h[m - 1, n - 2] = float("inf")
        g[0, n - 1] = float("-inf")
    return g, h, e, t, p


def phase_fused_fold_paths(device,
                           dtypes=(torch.float32, torch.float64)) -> None:
    """B2 and B6 on the fold_path_cases: the design their wrapper picks
    against the plain version (NaN where it gives NaN, the same bits
    elsewhere), the other design against the first, a repeat launch and
    the M=1 calls of sample_workers, all three masks."""
    from repro_torch.core.quantize import int8_scale
    from repro_torch.kernels import common, fused_step, ref
    sms = common.sm_count(device.index or 0)
    alpha, beta = 0.0123, 0.4
    cases, paths = 0, {}
    for dtype in dtypes:
        for m, n in fold_path_cases(sms):
            g, h, e, t, p = _fold_inputs(m, n, dtype, device, m + n)
            path = common.fold_path(m, n, sms)
            other = "one_pass" if path == "tall" else "tall"
            paths[f"M={m} n={n}"] = path
            scale = int8_scale(fused_step.int8_stats_batched(g, h, e)[1])
            for mname, mask in _masks(m, device).items():
                tag = f"{dtype} M={m} n={n} mask={mname} ({path})"
                out = fused_step.fused_dense_step(g, h, t, p, mask, alpha,
                                                  beta)
                plain = ref.fused_dense_step(g, h, t, p, mask, alpha, beta)
                alt = fused_step.dense_on_card(g, h, t, p, mask, alpha, beta,
                                               other)
                again = fused_step.fused_dense_step(g, h, t, p, mask, alpha,
                                                    beta)
                for a, b, c, d, what in zip(out, plain, alt, again,
                                            ("ghat'", "agg", "theta'")):
                    check(same_or_nan(a, b), f"B2 {what} {tag}")
                    check(same_or_nan(c, a), f"B2 {what} {other} {tag}")
                    check(same_bits(d, a), f"B2 {what} repeat {tag}")
                if mname == "zeros" and n > 1:
                    check(bool((bits(out[1][1:2]) == bits(
                        torch.tensor([-0.0], dtype=dtype, device=device))
                    ).all()), f"B2 -0.0 column's agg {tag}")
                for w in sample_workers(m):
                    one = fused_step.fused_dense_step(
                        g[w:w + 1], h[w:w + 1], t, p, mask[w:w + 1], alpha,
                        beta)
                    check(same_or_nan(one[0], out[0][w:w + 1]),
                          f"B2 M=1 slice {w} {tag}")
                out = fused_step.fused_int8_step(g, h, e, t, p, mask, scale,
                                                 alpha, beta)
                plain = ref.fused_int8_step(g, h, e, t, p, mask, scale, alpha,
                                            beta)
                alt = fused_step.int8_on_card(g, h, e, t, p, mask, scale,
                                              alpha, beta, other)
                again = fused_step.fused_int8_step(g, h, e, t, p, mask, scale,
                                                   alpha, beta)
                for a, b, c, d, what in zip(out, plain, alt, again,
                                            ("ghat'", "err'", "agg",
                                             "theta'")):
                    check(same_or_nan(a, b), f"B6 {what} {tag}")
                    check(same_or_nan(c, a), f"B6 {what} {other} {tag}")
                    check(same_bits(d, a), f"B6 {what} repeat {tag}")
                for w in sample_workers(m):
                    one = fused_step.fused_int8_step(
                        g[w:w + 1], h[w:w + 1], e[w:w + 1], t, p,
                        mask[w:w + 1], scale[w:w + 1], alpha, beta)
                    check(same_or_nan(one[0], out[0][w:w + 1])
                          and same_or_nan(one[1], out[1][w:w + 1]),
                          f"B6 M=1 slice {w} {tag}")
                del out, plain, alt, again
                cases += 1
            del g, h, e, t, p
            torch.cuda.empty_cache()
    emit({"phase": "fused_fold_paths", "cases": cases, "sms": sms,
          "path_by_shape": paths,
          "rule": "the picked design against the plain version and the "
          "other design: NaN where it gives NaN, the same bits elsewhere "
          "(-0.0 included); repeat and M=1 slices bitwise"})


# ----------------------------------------------------------- phase 3b
def _flash_f64(q, k, v, causal, window):
    """B14's function in f64 (the plain version without its f32 casts)."""
    b, h, lq, d = q.shape
    kh, s_len = k.shape[1], k.shape[2]
    q5 = q.double().reshape(b, kh, h // kh, lq, d)
    s = torch.einsum("bkgqd,bksd->bkgqs", q5, k.double()) * d ** -0.5
    qpos = torch.arange(lq, device=q.device)[:, None]
    kpos = torch.arange(s_len, device=q.device)[None, :]
    m = torch.ones((lq, s_len), dtype=torch.bool, device=q.device)
    if causal:
        m = m & (kpos <= qpos)
    if window is not None:
        m = m & (kpos > qpos - window)
    p = torch.softmax(torch.where(m, s, -1e30), dim=-1)
    return torch.einsum("bkgqs,bksd->bkgqd", p,
                        v.double()).reshape(b, h, lq, d)


def _decode_f64(q, k, v, cpos, pos):
    """B13's function in f64."""
    b, h, d = q.shape
    kh = k.shape[1]
    s = torch.einsum("bkgd,bkcd->bkgc", q.double().reshape(b, kh, h // kh, d),
                     k.double()) * d ** -0.5
    valid = (cpos >= 0) & (cpos <= pos)
    p = torch.softmax(torch.where(valid, s, -1e30), dim=-1)
    return torch.einsum("bkgc,bkcd->bkgd", p, v.double()).reshape(b, h, d)


def _attn_check(kernel, plain, exact, tag) -> tuple:
    """The B13/B14 rule; returns (kernel's error, plain version's error)."""
    err_k = float((kernel.double() - exact).abs().max())
    err_p = float((plain.double() - exact).abs().max())
    check(math.isfinite(err_k) and err_k <= ATTN_FACTOR * err_p + ATTN_FLOOR,
          f"{tag}: kernel error {err_k} against the f64 version, the f32 "
          f"plain version's {err_p}")
    return err_k, err_p


# (b, h, kh, lq, s, d, causal, window, dtype, offset): GQA 1/2/4/6, Lq and
# S off the 128-row query tile and the 64-key tile (Lq = S in {1, 127, 128,
# 129}), causal, windows (one whose band crosses the 128-row edge),
# non-causal rectangular, Lq > S with rows that have no valid key (they
# visit every tile and give the mean of v), head dims 32-256 (33: the
# element-wise loads; 80: zero-filled up to 128), bf16, operands one
# element off their storage's alignment (offset 1: the element-wise
# loads), and one batch row of serve_long's prefill
FLASH_CASES = [
    (2, 8, 8, 100, 100, 64, True, None, torch.float32, 0),
    (2, 8, 4, 130, 130, 64, True, 48, torch.float32, 0),
    (1, 8, 2, 77, 333, 64, False, None, torch.float32, 0),
    (1, 8, 2, 200, 150, 32, False, 40, torch.float32, 0),
    (1, 12, 2, 190, 190, 64, True, 7, torch.float32, 0),
    (2, 4, 4, 257, 257, 128, True, None, torch.float32, 0),
    (1, 4, 2, 65, 65, 256, True, 16, torch.float32, 0),
    (2, 8, 4, 130, 130, 64, True, 48, torch.bfloat16, 0),
    (1, 8, 2, 77, 333, 64, False, None, torch.bfloat16, 0),
    (1, 12, 12, 2048, 2048, 64, True, None, torch.float32, 0),
    (2, 4, 4, 1, 1, 64, True, None, torch.float32, 0),
    (1, 8, 8, 127, 127, 64, True, None, torch.float32, 0),
    (1, 8, 4, 128, 128, 64, True, None, torch.float32, 0),
    (2, 4, 2, 129, 129, 64, True, None, torch.float32, 0),
    (1, 12, 2, 300, 300, 64, True, 100, torch.float32, 0),
    (1, 4, 2, 129, 129, 33, True, None, torch.float32, 0),
    (1, 4, 2, 150, 150, 80, False, 70, torch.float32, 0),
    (2, 8, 4, 130, 130, 64, True, None, torch.float32, 1),
    (1, 4, 2, 300, 140, 64, True, 30, torch.float32, 0),
    (2, 4, 2, 129, 129, 64, True, None, torch.bfloat16, 0),
    (1, 4, 2, 129, 129, 33, True, 50, torch.bfloat16, 1),
]
# (b, h, kh, c, d, pos, dtype; pos None: every slot empty): C 1, 97 and
# 2081, pos 0, empty slots, wrapped rings, G 1/2/4/8/16 (two head groups),
# head dims 64-256, bf16, and serve_long's last decode step
DECODE_CASES = [
    (2, 8, 8, 1, 64, 0, torch.float32),
    (3, 8, 4, 97, 64, 0, torch.float32),
    (3, 8, 4, 97, 64, 40, torch.float32),
    (2, 8, 2, 97, 64, 300, torch.float32),
    (2, 4, 2, 97, 64, None, torch.float32),
    (8, 12, 12, 2081, 64, 2078, torch.float32),
    (2, 16, 2, 2081, 64, 5000, torch.float32),
    (1, 32, 2, 97, 64, 50, torch.float32),
    (2, 4, 2, 97, 128, 120, torch.float32),
    (2, 4, 2, 97, 256, 120, torch.float32),
    (3, 8, 4, 97, 64, 40, torch.bfloat16),
    (2, 8, 8, 2081, 64, 3000, torch.bfloat16),
]
SINGLE_PAIRS = [(torch.float32, torch.float32), (torch.float64, torch.float64),
                (torch.float64, torch.float32), (torch.float32, torch.bfloat16),
                (torch.bfloat16, torch.bfloat16)]


def phase_attention_kernels(device, max_err) -> None:
    """B12a, B12b, B13 and B14 against their plain versions on the card."""
    from repro_torch.kernels import (censor, decode_attention,
                                     flash_attention, ref)
    from repro_torch.models.kvcache import slot_positions
    gen = torch.Generator(device=device).manual_seed(31)
    worst = {}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    async_cases = 0
    for b, h, kh, lq, s_len, d, causal, window, dtype, off in FLASH_CASES:
        tag = f"B14 b={b} h={h} kh={kh} lq={lq} s={s_len} d={d} " \
              f"causal={causal} window={window} {dtype} offset={off}"

        def view(n, x):
            """A (B, H, L, d) view of a (B, L, H, d) tensor, as the model
            passes them, starting ``off`` elements into its storage."""
            flat = randn(off + b * n * x * d).to(dtype)
            return flat[off:].view(b, n, x, d).transpose(1, 2)

        q, k, v = view(lq, h), view(s_len, kh), view(s_len, kh)
        path = flash_attention.async_copy_ok(q, k, v)
        check(path == (dtype == torch.float32 and d % 4 == 0 and off == 0),
              f"{tag}: cp.async path {path}")
        async_cases += path
        out = flash_attention.flash_attention(q, k, v, causal=causal,
                                              window=window)
        plain = ref.flash_attention_fwd(q, k, v, causal=causal,
                                        window=window)
        check(out.dtype == dtype and out.shape == plain.shape, tag)
        worst[tag] = _attn_check(out, plain,
                                 _flash_f64(q, k, v, causal, window), tag)
        check(same_bits(out, flash_attention.flash_attention(
            q, k, v, causal=causal, window=window)), f"{tag}: repeat")
        if dtype == torch.float32:
            max_err["flash_attention"] = max(max_err["flash_attention"],
                                             max_diff(out, plain))
        del q, k, v, out, plain
    for b, h, kh, c, d, pos, dtype in DECODE_CASES:
        tag = f"B13 b={b} h={h} kh={kh} c={c} d={d} pos={pos} {dtype}"
        q = randn(b, h, d).to(dtype)
        # (B, K, C, d) views of the model's (B, C, K, d) cache
        k = randn(b, c, kh, d).to(dtype).transpose(1, 2)
        v = randn(b, c, kh, d).to(dtype).transpose(1, 2)
        if pos is None:
            cpos, pos = torch.full((c,), -1, dtype=torch.int32,
                                   device=device), 10
        else:
            cpos = slot_positions(pos + 1, c, device)
        out = decode_attention.decode_attention(q, k, v, cpos, pos)
        plain = ref.decode_attention_ref(q, k, v, cpos, pos)
        check(out.dtype == dtype and out.shape == plain.shape, tag)
        worst[tag] = _attn_check(out, plain,
                                 _decode_f64(q, k, v, cpos, pos), tag)
        check(same_bits(out, decode_attention.decode_attention(
            q, k, v, cpos, pos)), f"{tag}: repeat")
        if dtype == torch.float32:
            max_err["decode_attention"] = max(max_err["decode_attention"],
                                              max_diff(out, plain))
    single = 0
    for n in (1, 127, 2 ** 20 + 17):
        for dg, dh in SINGLE_PAIRS:
            tag = f"n={n} g {dg} ghat {dh}"
            g = randn(n).to(dg)
            h = (g.double() + 0.1 * randn(n).double()).to(dh)
            g[::7] = -0.0
            h[::11] = -0.0
            sq = censor.censor_delta_sqnorm(g, h)
            sq_p = ref.censor_delta_sqnorm(g, h)
            check(sq.shape == () and _rel_err(sq, sq_p) <= SQNORM_RTOL,
                  f"B12a {tag}: {float(sq)} against {float(sq_p)}")
            check(same_bits(sq, censor.censor_delta_sqnorm(g, h)),
                  f"B12a repeat {tag}")
            max_err["censor_delta_sqnorm"] = max(
                max_err["censor_delta_sqnorm"], max_diff(sq, sq_p))
            if n > 5:
                g[3] = float("nan")
                h[5] = float("nan")
            for t in (0, 1):
                out = censor.censor_select(g, h, t)
                check(same_bits(out, ref.censor_select(g, h, t)),
                      f"B12b transmit={t} {tag}")
                check(same_bits(out, h if t == 0 else g.to(dh)),
                      f"B12b transmit={t} {tag}: not a select")
            single += 1
    max_err["censor_select"] = 0.0
    emit({"phase": "attention_kernels", "flash_cases": len(FLASH_CASES),
          "flash_cases_cp_async": async_cases,
          "decode_cases": len(DECODE_CASES), "single_tensor_cases": single,
          "rule": f"attention: error vs f64 <= {ATTN_FACTOR} x plain f32's "
          f"+ {ATTN_FLOOR}; B12a rel {SQNORM_RTOL}; B12b bitwise with -0.0 "
          "and NaN",
          "worst_ratio": max(ek / (ep + ATTN_FLOOR)
                             for ek, ep in worst.values()),
          "errors": {k: {"kernel": ek, "plain_f32": ep}
                     for k, (ek, ep) in worst.items()}})


# ------------------------------------------------------------ phase 4
class StepRecorder:
    """Wraps an optimizer; records CUDA events and stats around ``step``."""

    def __init__(self, opt):
        self.opt = opt
        self.events = []
        self.stats = []

    def init(self, params):
        return self.opt.init(params)

    def step(self, state, params, grads):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.opt.step(state, params, grads)
        end.record()
        self.events.append((start, end))
        self.stats.append((out[2].delta_sq, out[2].step_sq))
        return out

    def median_ms(self) -> float:
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b)
                                 for a, b in self.events[1:])

    def min_margin(self, eps1: float) -> float:
        """Smallest |dsq - eps1*ssq| / (eps1*ssq) over steps with ssq > 0."""
        out = float("inf")
        for dsq, ssq in self.stats:
            if float(ssq) > 0:
                thr = eps1 * ssq.double()
                out = min(out, float(((dsq.double() - thr).abs()
                                      / thr).min()))
        return out


def _noise_floor(rec: "StepRecorder", thetas: list) -> int:
    """First iteration whose f32 step is below 256 ulps of theta (rms).

    Past it both sides of eq. (8) are rounding noise: the decision turns
    on how each platform rounds the gradient, not on the descent.
    """
    eps = torch.finfo(torch.float32).eps
    for k, (_, ssq) in enumerate(rec.stats):
        if 0 < float(ssq) < (256 * eps) ** 2 * thetas[k]:
            return k
    return len(rec.stats)


class ThetaRecorder:
    """Wraps a task's grad_fn to record ||theta^k||^2 at each iteration."""

    def __init__(self, task):
        self.norms = []
        self.task = task._replace(grad_fn=self.grad_fn)
        self._grad_fn = task.grad_fn

    def grad_fn(self, params, data):
        self.norms.append(float(torch.sum(params.double() ** 2)))
        return self._grad_fn(params, data)


def same_run(a, b) -> bool:
    """Two ``simulator.run`` histories: masks, counts, bytes, objective and
    final theta bit for bit."""
    return (torch.equal(a.mask, b.mask) and torch.equal(a.comm_cum, b.comm_cum)
            and torch.equal(a.final_state.comm.uplink_count,
                            b.final_state.comm.uplink_count)
            and a.final_state.comm.uplink_bytes_exact()
            == b.final_state.comm.uplink_bytes_exact()
            and same_bits(a.objective, b.objective)
            and all(same_bits(x, y) for x, y in zip(
                tree_leaves(a.final_params), tree_leaves(b.final_params))))


def phase_golden(device) -> None:
    from repro_torch import opt
    from repro_torch.core import simulator
    from repro_torch.data import paper_tasks
    from repro_torch.kernels import fused_step
    bundle = paper_tasks.make_linear_regression(m=5, n_per=30, d=20, seed=0,
                                                device=device)
    out, fused64 = {}, {}
    for kind, kw in GOLDEN_KW.items():
        hist, recs = {}, {}
        for prec, dtype in (("f64", torch.float64), ("f32", torch.float32)):
            for backend in ("cuda", "reference"):
                rec = StepRecorder(opt.make("chb", bundle.alpha_paper, 5,
                                            backend=backend, **kw))
                th = ThetaRecorder(simulator.task_to(bundle.task,
                                                     dtype=dtype))
                hist[prec, backend] = simulator.run(rec, th.task, 60,
                                                    device=device)
                recs[prec, backend] = (rec, th.norms)
        for prec in ("f64", "f32"):
            hk, hr = hist[prec, "cuda"], hist[prec, "reference"]
            check(torch.equal(hk.mask, hr.mask)
                  and torch.equal(hk.comm_cum, hr.comm_cum),
                  f"golden {kind} {prec}: masks differ between backends")
            check(same_bits(hk.objective, hr.objective)
                  and same_bits(hk.final_params, hr.final_params),
                  f"golden {kind} {prec}: trajectories differ between "
                  "backends")
            check(int(hk.comm_cum[-1]) == int(hk.mask.sum()),
                  f"golden {kind} {prec}: comm_cum != mask sum")
        h64, h32 = hist["f64", "cuda"], hist["f32", "cuda"]
        fused64[kind] = h64
        comm64, obj64 = int(h64.comm_cum[-1]), float(h64.objective[-1])
        want64, want_obj64 = GOLDEN_F64[kind]
        check(comm64 == want64 == int(h64.mask.sum()),
              f"golden {kind} f64: {comm64} uploads, the JAX package "
              f"gives {want64}")
        check(abs(obj64 - want_obj64) <= 1e-9 * want_obj64,
              f"golden {kind} f64: objective {obj64!r}")
        obj32 = float(h32.objective[-1])
        check(abs(obj32 - GOLDEN_OBJECTIVE) <= 1e-4 * GOLDEN_OBJECTIVE,
              f"golden {kind} f32: objective {obj32!r}")
        floor = _noise_floor(*recs["f32", "cuda"])
        if kind != "topk":
            # top-k's deferred mass keeps its steps above the 256-ulp floor
            # to the end, so the rule has no floor to hold it to; an f32
            # top-k choice between two near-equal entries may differ from
            # the f64 one, and its masks are only printed
            check(floor >= 20, f"golden {kind} f32: noise floor at {floor}")
            check(torch.equal(h32.mask[:floor], h64.mask[:floor]),
                  f"golden {kind}: f32 masks leave the f64 run's before "
                  f"the f32 noise floor ({floor})")
        out[kind] = {"f64_comm_cum": comm64, "f64_objective": obj64,
                     "f32_comm_cum": int(h32.comm_cum[-1]),
                     "f32_jax_pin": GOLDEN_F32[kind], "f32_objective": obj32,
                     "f32_noise_floor_iter": floor,
                     "f32_first_mask_diff_vs_f64": next(
                         (k for k in range(60)
                          if not torch.equal(h32.mask[k], h64.mask[k])),
                         None)}
    task64 = simulator.task_to(bundle.task, dtype=torch.float64)
    # the staged route: the fused route's bits, the JAX package's uploads
    for kind in ("dense", "int8"):
        with fused_step.force_staged():
            h = simulator.run(opt.make("chb", bundle.alpha_paper, 5,
                                       backend="cuda", **GOLDEN_KW[kind]),
                              task64, 60, device=device)
        check(same_run(h, fused64[kind]),
              f"golden {kind} f64: the staged route differs from the fused")
        check(int(h.comm_cum[-1]) == GOLDEN_F64[kind][0],
              f"golden {kind} staged: {int(h.comm_cum[-1])} uploads")
        out[f"{kind}_staged"] = {"f64_comm_cum": int(h.comm_cum[-1]),
                                 "equals_fused": True}
    # per_tensor granularity and the adaptive censor, 80 iterations
    builders = {
        "per_tensor": lambda b: opt.make("chb", bundle.alpha_paper, 5,
                                         granularity="per_tensor",
                                         backend=b),
        "adaptive": lambda b: opt.ComposedOptimizer(
            censor=opt.AdaptiveCensor(GOLDEN_ADAPTIVE),
            transport=opt.DenseTransport(),
            server=opt.HeavyBall(bundle.alpha_paper, 0.4), num_workers=5,
            backend=b),
    }
    for kind, build in builders.items():
        hk, hr = (simulator.run(build(b), task64, 80, device=device)
                  for b in ("cuda", "reference"))
        check(same_run(hk, hr), f"golden {kind} f64: backends differ")
        sent = int(hk.comm_cum[-1])
        check(sent == GOLDEN_F64_80[kind] == int(hk.mask.sum()),
              f"golden {kind} f64: {sent} uploads, the JAX package gives "
              f"{GOLDEN_F64_80[kind]}")
        out[kind] = {"f64_comm_cum": sent,
                     "uplink_bytes": hk.final_state.comm.uplink_bytes_exact(),
                     "f64_objective": float(hk.objective[-1])}
    out["csgd"] = golden_csgd(device, task64, bundle.alpha_paper)
    emit({"phase": "golden", **out})


def golden_csgd(device, task64, alpha) -> dict:
    """csgd on the golden task at f64 on both backends: the JAX package's
    uploads, masks and objective (GOLDEN_CSGD)."""
    from repro_torch import opt
    from repro_torch.core import simulator
    hk, hr = (simulator.run(opt.make("csgd", alpha, 5, tau0=GOLDEN_CSGD_TAU0,
                                     backend=b), task64, 60, device=device)
              for b in ("cuda", "reference"))
    check(same_run(hk, hr), "golden csgd f64: backends differ")
    sent, rows, obj = GOLDEN_CSGD
    got_rows = [int(sum(int(v) << w for w, v in enumerate(r)))
                for r in hk.mask.cpu().tolist()]
    check(int(hk.comm_cum[-1]) == sent and got_rows == rows,
          f"golden csgd f64: {int(hk.comm_cum[-1])} uploads, masks "
          f"{got_rows}; the JAX package gives {sent}, {rows}")
    check(abs(float(hk.objective[-1]) - obj) <= 1e-9 * obj,
          f"golden csgd f64: objective {float(hk.objective[-1])!r}")
    return {"f64_comm_cum": sent, "masks_equal_jax": True,
            "f64_objective": float(hk.objective[-1])}


def same_edge_anchor(edge, hist) -> bool:
    """``run_edge(sync_config)`` against ``simulator.run``: objective,
    comm_cum, masks, theta and the bank, bit for bit."""
    return (torch.equal(torch.from_numpy(edge.objective),
                        hist.objective.cpu().to(torch.float64))
            and torch.equal(torch.from_numpy(edge.comm_cum),
                            hist.comm_cum.cpu().to(torch.int64))
            and torch.equal(torch.from_numpy(edge.mask).to(torch.float32),
                            hist.mask.cpu())
            and all(same_bits(a, b) for a, b in zip(
                tree_leaves(edge.final_params), tree_leaves(hist.final_params)))
            and all(same_bits(a, b) for a, b in zip(
                tree_leaves(edge.final_bank),
                tree_leaves(hist.final_state.ghat))))


# ------------------------------------------------------------ phase 5
# the kernels each path launches per step, per leaf: one leaf for dense,
# int8 and top-k, the model's 12 for low-rank
PATH_KERNELS = {
    "dense": ("censor_delta_sqnorm_batched", "fused_dense_step"),
    "int8": ("int8_stats_batched", "fused_int8_step"),
    "topk": ("sqnorm_batched", "select_pack_ef_batched", "bank_advance",
             "hb_update"),
    "lowrank": ("sqnorm_batched", "residual_ef_batched", "bank_advance",
                "hb_update"),
    "dense_staged": ("censor_delta_sqnorm_batched", "censor_bank_advance",
                     "hb_update"),
    "int8_staged": ("sqnorm_batched", "absmax_batched", "quantize_ef_batched",
                    "bank_advance", "hb_update"),
    "per_tensor": ("sqnorm_batched", "bank_advance", "hb_update"),
    # B3 through apply_server, after the (one-shard) fold
    "shard_dense": ("censor_delta_sqnorm_batched", "censor_bank_advance",
                    "hb_update"),
    "shard_int8": ("sqnorm_batched", "absmax_batched", "quantize_ef_batched",
                   "bank_advance", "hb_update"),
}
# the path each staged or sharded path must equal bit for bit
SAME_AS = {"dense_staged": "dense", "int8_staged": "int8",
           "shard_dense": "dense", "shard_int8": "int8"}


class ShardAnchor:
    """The single-shard sync anchor as an optimizer ``simulator.run`` can
    drive: ``shard_step`` over every worker with no gates, then
    ``apply_server`` on the partial sum."""

    def __init__(self, opt):
        self.opt = opt

    def init(self, params):
        return self.opt.init(params)

    def step(self, state, params, grads):
        from repro_torch.core.util import tree_sqnorm
        from repro_torch.opt import StepStats
        new_state, partial, st = self.opt.shard_step(state, params, grads)
        new_params = self.opt.apply_server(params, state.prev_params,
                                           partial)
        return new_state, new_params, StepStats(
            mask=st.mask, delta_sq=st.delta_sq, step_sq=st.step_sq,
            agg_grad_sqnorm=tree_sqnorm(partial))


def _lm_grad(theta, data):
    a, c = data
    return {k: a.view((-1,) + (1,) * x.dim()) * (x - c[k])
            for k, x in theta.items()}


def _lm_loss(theta, data):
    a, c = data
    total = torch.zeros_like(a)
    for k, x in theta.items():
        r = x - c[k]
        total = total + 0.5 * a * torch.sum(r * r, dim=tuple(
            range(1, r.dim())))
    return total


def lm_tree_task(task):
    """The edge quadratics viewed as the 12 leaves of chb-paper-lm-124m.

    The gradient of ``0.5*a_m*||theta - c_m||^2`` is elementwise, so each
    leaf's gradient is the flat task's on that leaf's span of the centers:
    the same objective with the same f*. The centers are views of the flat
    task's, so the view costs no memory.
    """
    from repro_torch.core.simulator import FedTask
    a, c = task.worker_data
    m, off, centers, init = c.shape[0], 0, {}, {}
    for name, shape in LM_LEAVES.items():
        size = math.prod(shape)
        centers[name] = c[:, off:off + size].view((m,) + shape)
        init[name] = torch.zeros(shape, dtype=c.dtype, device=c.device)
        off += size
    check(off == c.shape[1], f"the model's leaves hold {off} parameters, "
          f"the task {c.shape[1]}")
    return FedTask(init_params=init, grad_fn=_lm_grad, loss_fn=_lm_loss,
                   worker_data=(a, centers), name="edge_quadratics_lm_tree")


def lowrank_payload_bytes(rank: int) -> int:
    """Bytes of one low-rank transmission of the model's leaves: two
    factors of rank min(rank, rows, cols) per matrix leaf (rows =
    shape[0]), a vector leaf dense."""
    total = 0
    for shape in LM_LEAVES.values():
        if len(shape) >= 2:
            r, c = shape[0], math.prod(shape[1:])
            total += min(rank, r, c) * (r + c) * 4
        else:
            total += math.prod(shape) * 4
    return total


def full_task(device):
    """Phase 5's task, ``make_edge_quadratics(m=FULL_M, d=FULL_D, seed=0)``
    in f32 on the card, built once for phases full, edge and sweep; and
    the seconds it took."""
    from repro_torch.data import edge_tasks
    t0 = time.perf_counter()
    task = edge_tasks.make_edge_quadratics(m=FULL_M, d=FULL_D, seed=0,
                                           dtype=torch.float32, device=device)
    return task, time.perf_counter() - t0


def phase_full(flat, setup_s: float, d=FULL_D, m=FULL_M,
               iters=FULL_ITERS) -> dict:
    """Each path at full width (on ``flat``, phase 5's task) on both
    backends; returns each path's launch counts."""
    from repro_torch import opt
    from repro_torch.core import simulator
    from repro_torch.data import edge_tasks
    from repro_torch.kernels import common, fused_step
    fstar = edge_tasks.edge_quadratics_fstar(flat)
    tree = lm_tree_task(flat)
    int8 = {"quantize": "int8"}
    paths = {  # path: (opt.make keywords, task, bytes of one transmission)
        "dense": ({}, flat, 4 * d),
        "int8": (int8, flat, d + 4),
        "topk": ({"transport": "topk", "k": FULL_TOPK_K}, flat,
                 FULL_TOPK_K * (4 + 4)),
        "lowrank": ({"transport": "lowrank", "rank": FULL_RANK}, tree,
                    lowrank_payload_bytes(FULL_RANK)),
        "dense_staged": ({}, flat, 4 * d),
        "int8_staged": (int8, flat, d + 4),
        # bytes count per transmitted leaf: at most 4d a worker-iteration
        "per_tensor": ({"granularity": "per_tensor"}, tree, None),
        "shard_dense": ({}, flat, 4 * d),
        "shard_int8": (int8, flat, d + 4),
    }

    def one_run(kind, kw, task, backend, keep_state=False):
        o = opt.make("chb", FULL_ALPHA, m, eps1=FULL_EPS1, backend=backend,
                     **kw)
        rec = StepRecorder(ShardAnchor(o) if kind.startswith("shard")
                           else o)
        staged = fused_step.force_staged() if kind.endswith("_staged") \
            else contextlib.nullcontext()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with staged:
            hist = simulator.run(rec, task, iters)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        comm = hist.final_state.comm
        res = {
            "mask": hist.mask.cpu(), "comm_cum": hist.comm_cum.cpu(),
            "uplink_count": comm.uplink_count.cpu(),
            "uplink_bytes": comm.uplink_bytes_exact(),
            "theta": tree_leaves(hist.final_params),
            "objective": float(hist.objective[-1]),
            "step_ms": rec.median_ms(), "wall_s": wall,
            # eq. (8) per leaf has no one global margin
            "min_margin": (None if kind == "per_tensor"
                           else rec.min_margin(FULL_EPS1)),
        }
        if keep_state:
            s = hist.final_state
            res["state"] = tree_leaves([s.prev_params, s.ghat, s.err,
                                        list(s.comm)])
        del hist, rec
        torch.cuda.empty_cache()
        return res

    summary, launches, fused = {}, {}, {}
    for kind, (kw, task, payload) in paths.items():
        # the fused steps stay for the staged and sharded paths to equal
        keep = kind in SAME_AS.values()
        common.reset_launches()
        k = one_run(kind, kw, task, "cuda",
                    keep_state=keep or kind.startswith("shard"))
        launches[kind] = dict(common.LAUNCHES)
        common.reset_launches()
        r = one_run(kind, kw, task, "reference")
        check(not any(common.LAUNCHES.values()),
              f"full {kind}: the reference backend launched a kernel")
        per_step = len(tree_leaves(task.init_params))
        want_launches = {name: (iters * per_step
                                if name in PATH_KERNELS[kind] else 0)
                         for name in common.KERNELS}
        check(launches[kind] == want_launches,
              f"full {kind}: launches {launches[kind]}, want "
              f"{want_launches}")
        check(torch.equal(k["mask"], r["mask"]), f"full {kind}: masks")
        check(torch.equal(k["comm_cum"], r["comm_cum"]),
              f"full {kind}: comm_cum")
        check(torch.equal(k["uplink_count"], r["uplink_count"]),
              f"full {kind}: uplink_count")
        sent = int(k["mask"].sum())
        if payload is None:
            want = r["uplink_bytes"]
            check(0 < want <= sent * 4 * d and want % 4 == 0,
                  f"full {kind}: uplink bytes {want} for {sent} uploads")
        else:
            want = sent * payload
        check(k["uplink_bytes"] == want == r["uplink_bytes"],
              f"full {kind}: uplink bytes {k['uplink_bytes']} != {want}")
        theta_rel = max(float((a - b).abs().max() / b.abs().max())
                        for a, b in zip(k["theta"], r["theta"]))
        check(all(same_bits(a, b) for a, b in zip(k["theta"], r["theta"])),
              f"full {kind}: final theta differs between backends (max rel "
              f"{theta_rel})")
        if kind in ("dense", "int8"):
            check(want > 2 ** 31,
                  f"full {kind}: {want} bytes do not pass 2^31")
        if kind in SAME_AS:
            f = fused[SAME_AS[kind]]
            check(torch.equal(k["mask"], f["mask"])
                  and torch.equal(k["comm_cum"], f["comm_cum"])
                  and torch.equal(k["uplink_count"], f["uplink_count"])
                  and k["uplink_bytes"] == f["uplink_bytes"],
                  f"full {kind}: masks, counts or bytes differ from "
                  f"{SAME_AS[kind]}'s")
            check(all(same_bits(a, b) for a, b in zip(k["theta"],
                                                      f["theta"])),
                  f"full {kind}: final theta differs from {SAME_AS[kind]}'s")
            if kind.startswith("shard"):
                check(len(k["state"]) == len(f["state"]) and all(
                    same_bits(a, b) if a.is_floating_point()
                    else torch.equal(a, b)
                    for a, b in zip(k["state"], f["state"])),
                      f"full {kind}: the state differs from "
                      f"{SAME_AS[kind]}'s step")
        check(all(math.isfinite(x) for x in (k["objective"],
                                             r["objective"])),
              f"full {kind}: objective is not finite")
        margins = [x["min_margin"] for x in (k, r)
                   if x["min_margin"] is not None]
        summary[kind] = {
            "uploads": sent, "uplink_bytes": k["uplink_bytes"],
            "payload_bytes": payload, "leaves": per_step,
            "theta_bitwise": True, "theta_max_rel_diff": theta_rel,
            "equals": SAME_AS.get(kind),
            "min_eq8_margin": min(margins) if margins else None,
            "objective": k["objective"],
            "fstar_rel_gap": (k["objective"] - fstar) / fstar,
            "step_ms_cuda": k["step_ms"], "step_ms_reference": r["step_ms"],
            "wall_s_cuda": k["wall_s"], "wall_s_reference": r["wall_s"],
            "launches": {n: c for n, c in launches[kind].items() if c},
        }
        if keep:
            fused[kind] = k
        del k, r
        torch.cuda.empty_cache()
    del paths, tree, fused
    torch.cuda.empty_cache()
    emit({"phase": "full", "d": d, "m": m, "iters": iters,
          "topk_k": FULL_TOPK_K, "lowrank_rank": FULL_RANK,
          "setup_s": setup_s, **summary})
    return launches


# ------------------------------------------------- phase many_workers
def phase_many_workers() -> dict:
    """The MANY_PATHS at the fed-mesh scale on both backends: masks,
    counts, uplink bytes, objective and final theta bit for bit, and each
    path's kernels launched once a step. Returns each path's launch counts
    (keys ``many_<path>``)."""
    from repro_torch import opt
    from repro_torch.core import simulator
    from repro_torch.data import edge_tasks
    from repro_torch.kernels import common, fused_step
    t0 = time.perf_counter()
    tasks = {m: edge_tasks.make_edge_quadratics(m=m, d=MANY_D, seed=0)
             for m in sorted({m for m, _ in MANY_PATHS.values()})}
    setup_s = time.perf_counter() - t0
    summary, launches = {}, {}
    for kind, (m, kw) in MANY_PATHS.items():
        runs = {}
        for backend in ("cuda", "reference"):
            rec = StepRecorder(opt.make("chb", 0.5 / m, m, eps1=FULL_EPS1,
                                        backend=backend, **kw))
            route = fused_step.force_staged() if kind.endswith("_staged") \
                else contextlib.nullcontext()
            torch.cuda.synchronize()
            common.reset_launches()
            t = time.perf_counter()
            with route:
                hist = simulator.run(rec, tasks[m], MANY_ITERS)
            torch.cuda.synchronize()
            runs[backend] = (hist, rec, time.perf_counter() - t,
                             dict(common.LAUNCHES))
        (hk, rk, sk, lk), (hr, rr, sr, lr) = runs["cuda"], runs["reference"]
        want = {name: MANY_ITERS if name in PATH_KERNELS[kind] else 0
                for name in common.KERNELS}
        check(lk == want, f"many_workers {kind}: launches {lk}, want {want}")
        check(not any(lr.values()),
              f"many_workers {kind}: the reference backend launched a kernel")
        check(tuple(hk.mask.shape) == (MANY_ITERS, m),
              f"many_workers {kind}: masks of shape {tuple(hk.mask.shape)}")
        check(same_run(hk, hr), f"many_workers {kind}: the cuda backend's "
              "masks, counts, bytes or theta differ from the reference's")
        check(bool(torch.isfinite(hk.objective).all()),
              f"many_workers {kind}: objective is not finite")
        launches[f"many_{kind}"] = lk
        summary[kind] = {
            "m": m, "uploads": int(hk.comm_cum[-1]),
            "uplink_bytes": hk.final_state.comm.uplink_bytes_exact(),
            "min_eq8_margin": rr.min_margin(FULL_EPS1),
            "step_ms_cuda": rk.median_ms(),
            "step_ms_reference": rr.median_ms(),
            "wall_s_cuda": sk, "wall_s_reference": sr,
            "launches": {n: c for n, c in lk.items() if c}}
        del runs, hk, hr
        torch.cuda.empty_cache()
    del tasks
    torch.cuda.empty_cache()
    emit({"phase": "many_workers", "d": MANY_D, "iters": MANY_ITERS,
          "dtype": "float64", "bitwise": "masks, comm_cum, uplink counts "
          "and bytes, objective, final theta", "setup_s": setup_s,
          **summary, "seconds": time.perf_counter() - t0})
    return launches


# --------------------------------------------------------- phase edge
class RoundClock:
    """Wraps a task's loss_fn, which ``run_edge`` and ``simulator.run``
    call once a round (the objective), to time the rounds on the host
    clock after a synchronize. The wrapper closes over the stamps, not
    the clock: a bound method in ``self.task`` would be a reference cycle
    holding the task's tensors on the card until the cyclic collector
    ran."""

    def __init__(self, task):
        stamps = self.stamps = []
        loss = task.loss_fn

        def loss_fn(params, data):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            return loss(params, data)
        self.task = task._replace(loss_fn=loss_fn)

    def median_ms(self) -> float:
        """The median round after the first (which builds and warms)."""
        gaps = [b - a for a, b in zip(self.stamps[1:], self.stamps[2:])]
        return statistics.median(gaps) * 1e3


def edge_scenario():
    """examples/edge_deployment.py's deployment cut to FULL_M clients."""
    from repro_torch import fed
    return fed.EdgeConfig(
        population=fed.straggler_population(
            FULL_M, compute_mean_s=1.0, straggler_frac=1 / FULL_M,
            straggler_slowdown=12.0, jitter="exp", availability="bernoulli",
            avail_p=0.8, seed=0),
        channel=fed.ChannelConfig.lossy(0.15, uplink_rate_bps=1e6),
        quorum=3 / FULL_M, seed=0)


def _edge_run(o, task, edge, device):
    """One timed ``run_edge`` with its launch counts."""
    from repro_torch import fed
    from repro_torch.kernels import common
    clock = RoundClock(task)
    torch.cuda.synchronize()
    common.reset_launches()
    t = time.perf_counter()
    hist = fed.run_edge(o, clock.task, edge, EDGE_ROUNDS, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    d = hist.stats.as_dict()
    evals = d["uplinks"] + d["censored"]
    return hist, {"ms_per_round": clock.median_ms(), "wall_s": wall,
                  "client_evals": evals, "evals_per_s": evals / wall,
                  "launches": dict(common.LAUNCHES)}


def _want_edge_launches(evals: int, leaves: int) -> dict:
    """B8 once per leaf per client evaluation, B3 once per leaf per round,
    nothing else (the row transports are plain PyTorch)."""
    from repro_torch.kernels import common
    return {name: {"sqnorm_batched": leaves * evals,
                   "hb_update": leaves * EDGE_ROUNDS}.get(name, 0)
            for name in common.KERNELS}


def _prng_on_card(device) -> dict:
    """The JAX PRNG's draws on the card against the same draws on the CPU:
    uniforms bit for bit; normals within 2 * NORMAL_MAX_ULP (the CPU port's
    bound against XLA; the card's f64 log may differ from the CPU's in the
    last bit as PyTorch's CPU one does from XLA's)."""
    from repro_torch import random as jrandom
    out = {}
    for dtype, itype in ((torch.float32, torch.int32),
                         (torch.float64, torch.int64)):
        name = str(dtype).removeprefix("torch.")
        for draw in ("uniform", "normal"):
            fn = getattr(jrandom, draw)
            k, c = (fn(jrandom.PRNGKey(3, device=dev), (1 << 20,), dtype)
                    for dev in (device, "cpu"))
            ulp = (k.cpu().view(itype).to(torch.int64)
                   - c.view(itype).to(torch.int64)).abs()
            limit = 0 if draw == "uniform" else 2 * NORMAL_MAX_ULP
            check(int(ulp.max()) <= limit, f"edge prng: {draw} {name} on "
                  f"the card is {int(ulp.max())} ulps from the CPU's")
            out[f"{draw}_{name}_differ"] = int((ulp > 0).sum())
            out[f"{draw}_{name}_max_ulp"] = int(ulp.max())
    return out


def phase_edge(device, task) -> dict:
    """``fed.run_edge`` at full width (EDGE_PATHS): (a) the sync anchor
    against ``simulator.run`` on cuda, bit for bit; (b) the deployment
    scenario on cuda against reference, bit for bit; (c) B8's M = 1 row
    against the batched slice; (d) the launch counts. Returns each cuda
    ``run_edge``'s launch counts (keys ``edge_*``)."""
    from repro_torch import fed, opt
    from repro_torch.core import simulator
    from repro_torch.kernels import censor
    t0 = time.perf_counter()
    # (c) first: its launches are comparisons, not the path's
    gen = torch.Generator(device=device).manual_seed(23)
    x = torch.randn((FULL_M, FULL_D), generator=gen, device=device)
    batched = censor.sqnorm_batched(x)
    for i in range(FULL_M):
        check(same_bits(censor.sqnorm_batched(x[i][None]), batched[i:i + 1]),
              f"edge: B8's row of worker {i} differs from the batched slice")
    del x, batched
    prng = _prng_on_card(device)
    leaves = len(tree_leaves(task.init_params))
    summary, launches = {"prng": prng}, {}
    for path, (algo, kw) in EDGE_PATHS.items():
        mk = {b: opt.make(algo, FULL_ALPHA, FULL_M, backend=b, **kw)
              for b in ("cuda", "reference")}
        # (a) the sync anchor on the card
        sim_clock = RoundClock(task)
        sim = simulator.run(mk["cuda"], sim_clock.task, EDGE_ROUNDS,
                            device=device)
        sync, sync_t = _edge_run(mk["cuda"], task, fed.sync_config(FULL_M),
                                 device)
        check(same_edge_anchor(sync, sim), f"edge {path}: run_edge("
              "sync_config) differs from simulator.run on the card")
        check(sync_t["launches"] == _want_edge_launches(
            sync_t["client_evals"], leaves),
            f"edge {path} sync: launches {sync_t['launches']}")
        del sim, sync
        torch.cuda.empty_cache()
        # (b) the deployment on both backends
        runs = {b: _edge_run(mk[b], task, edge_scenario(), device)
                for b in ("cuda", "reference")}
        (hk, tk), (hr, tr) = runs["cuda"], runs["reference"]
        for f in ("mask", "comm_cum", "bytes_cum", "energy_cum",
                  "wall_clock"):
            check(np.array_equal(getattr(hk, f), getattr(hr, f)),
                  f"edge {path}: {f} differs between backends")
        check(hk.stats.as_dict() == hr.stats.as_dict(),
              f"edge {path}: the deployment accounting differs")
        check(all(same_bits(a, b) for a, b in zip(
            tree_leaves(hk.final_params), tree_leaves(hr.final_params))),
            f"edge {path}: final theta differs between backends")
        check(bool(np.isfinite(hk.objective).all()),
              f"edge {path}: objective is not finite")
        check(tk["launches"] == _want_edge_launches(tk["client_evals"],
                                                    leaves),
              f"edge {path}: launches {tk['launches']}")
        check(not any(tr["launches"].values()),
              f"edge {path}: the reference backend launched a kernel")
        check(int(hk.comm_cum[-1]) > 0, f"edge {path}: no uploads")
        launches[f"edge_sync_{path}"] = sync_t.pop("launches")
        launches[f"edge_{path}"] = tk.pop("launches")
        tr.pop("launches")
        d = hk.stats.as_dict()
        summary[path] = {
            "sync": {"ms_per_round_cuda": sync_t["ms_per_round"],
                     "simulator_ms_per_iter_cuda": sim_clock.median_ms(),
                     "evals_per_s_cuda": sync_t["evals_per_s"],
                     "bitwise": True},
            "deployment": {"cuda": tk, "reference": tr,
                           "uploads": d["uplinks"], "dropped": d["dropped"],
                           "censored": d["censored"],
                           "stale_folds": d["stale_folds"],
                           "wall_clock_s": d["wall_clock_s"],
                           "bitwise": True}}
        del runs, hk, hr
        torch.cuda.empty_cache()
    emit({"phase": "edge", "d": FULL_D, "m": FULL_M, "rounds": EDGE_ROUNDS,
          "dtype": "float32", **summary,
          "seconds": time.perf_counter() - t0})
    return launches


# -------------------------------------------------------- phase sweep
SWEEP_ITERS = 10
SWEEP_FIG11_SCALES = tuple(float(x) for x in np.logspace(-2.0, 0.0, 4))
SWEEP_FIG11_SEEDS = (0, 1)
SWEEP_FIG11_ITERS = 300
SWEEP_FIG11_M = 9
SWEEP_FED_GRID = {"loss_prob": (0.0, 0.15), "participation": (1.0, 0.75),
                  "quorum": (1.0,), "seed": (0,)}


def _fingerprint(h) -> dict:
    """What a sweep point is held to: masks, comm_cum, uplink bytes and
    theta (on the card), objective and the agg sqnorm series."""
    return {"mask": h.mask.cpu(), "comm_cum": h.comm_cum.cpu(),
            "objective": h.objective.cpu(),
            "agg_grad_sqnorm": h.agg_grad_sqnorm.cpu(),
            "uplink_bytes": h.final_state.comm.uplink_bytes_exact(),
            "theta": tree_leaves(h.final_params)}


def _same_fingerprint(a: dict, b: dict) -> bool:
    return (all(torch.equal(a[k], b[k]) for k in
                ("mask", "comm_cum", "objective", "agg_grad_sqnorm"))
            and a["uplink_bytes"] == b["uplink_bytes"]
            and all(same_bits(x, y) for x, y in zip(a["theta"],
                                                    b["theta"])))


def _timed_sweep(grid, task, iters, base, device, **kw):
    """One ``run_sweep`` with its launch counts, wall seconds and peak
    device memory."""
    from repro_torch import sweep
    from repro_torch.kernels import common
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    common.reset_launches()
    t = time.perf_counter()
    res = sweep.run_sweep(grid, task, num_iters=iters, base_cfg=base,
                          device=device, **kw)
    torch.cuda.synchronize()
    return res, {"wall_s": time.perf_counter() - t,
                 "elapsed_s": res.elapsed_s,
                 "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                 "launches": dict(common.LAUNCHES)}


def _per_point_runs(points, specs, task_of, iters, device) -> tuple:
    """``simulator.run`` of each point's optimizer (rebuilt from its spec):
    the fingerprints and the summed launch counts."""
    from repro_torch import opt
    from repro_torch.core import simulator
    from repro_torch.kernels import common
    prints, total = [], {name: 0 for name in common.KERNELS}
    for p, spec in zip(points, specs):
        common.reset_launches()
        h = simulator.run(opt.from_spec(spec), task_of(p), iters,
                          device=device)
        for name, c in common.LAUNCHES.items():
            total[name] += c
        prints.append(_fingerprint(h))
        del h
    return prints, total


def phase_sweep(device, task) -> dict:
    """The sweep engine on the card. (a) full width: a 6-point grid (eps1
    x {dense, int8}, 2 partitions) on phase 5's task, each point equal to
    ``simulator.run`` bit for bit, the launches the sum of the per-point
    runs', and a ``collect_metrics`` rerun with the same bits and launches;
    (b) the paper's Fig. 11 setting cut to 4 eps1 scales x 2 seeds, 300
    iterations, f64, on both backends: every point equal to its
    ``simulator.run``, the two backends' masks equal; (c) ``run_fed_sweep``
    on (a)'s task, 4 scenarios: the ideal one equal to ``simulator.run``,
    every scenario equal on both backends, B8, B9 and B3 once a round a
    scenario. Returns the sweeps' launch counts (keys ``sweep_*``)."""
    from repro_torch import opt, sweep
    from repro_torch.core import simulator
    from repro_torch.data import paper_tasks
    from repro_torch.kernels import common
    t0 = time.perf_counter()
    launches, summary = {}, {}
    leaves = len(tree_leaves(task.init_params))

    # (a) full width
    grid = sweep.ConfigGrid(alpha=(FULL_ALPHA,),
                            eps1=(0.0, FULL_EPS1, 2 * FULL_EPS1),
                            quantize=(None, "int8"))
    base = opt.make("chb", FULL_ALPHA, FULL_M, eps1=FULL_EPS1,
                    backend="cuda")
    res, run_a = _timed_sweep(grid, task, SWEEP_ITERS, base, device)
    check(res.num_programs == 2 and len(res) == 6,
          f"sweep (a): {len(res)} points in {res.num_programs} partitions")
    got = [_fingerprint(h) for h in res.histories]
    points, specs = res.points, res.specs
    del res
    torch.cuda.empty_cache()
    prints, per_point = _per_point_runs(points, specs, lambda p: task,
                                        SWEEP_ITERS, device)
    for i, (g, r) in enumerate(zip(got, prints)):
        check(_same_fingerprint(g, r), f"sweep (a): point {i} "
              f"{points[i]} differs from simulator.run")
        check(bool(torch.isfinite(g["objective"]).all()),
              f"sweep (a): point {i} objective is not finite")
    del prints
    check(run_a["launches"] == per_point, f"sweep (a): launches "
          f"{run_a['launches']} != the per-point runs' {per_point}")
    dense = sum(p.quantize is None for p in points)
    want = {name: 0 for name in common.KERNELS}
    for name in PATH_KERNELS["dense"]:
        want[name] = dense * SWEEP_ITERS * leaves
    for name in PATH_KERNELS["int8"]:
        want[name] = (len(points) - dense) * SWEEP_ITERS * leaves
    check(run_a["launches"] == want,
          f"sweep (a): launches {run_a['launches']}, want {want}")
    res_m, run_m = _timed_sweep(grid, task, SWEEP_ITERS, base, device,
                                collect_metrics=True)
    for i, h in enumerate(res_m.histories):
        check(_same_fingerprint(_fingerprint(h), got[i]),
              f"sweep (a): point {i} with metrics differs")
        check(h.metrics["censor_rate"].shape == (SWEEP_ITERS,),
              f"sweep (a): point {i} has no metric series")
    check(run_m["launches"] == run_a["launches"],
          f"sweep (a): collect_metrics launched {run_m['launches']}")
    launches["sweep_full"] = run_a.pop("launches")
    run_m.pop("launches")
    summary["full"] = {
        "points": len(points), "partitions": 2, "iters": SWEEP_ITERS,
        "uploads": [int(g["comm_cum"][-1]) for g in got],
        "uplink_bytes": [g["uplink_bytes"] for g in got],
        "ms_per_point_iteration": run_a["elapsed_s"] * 1e3
        / (len(points) * SWEEP_ITERS),
        "ms_per_point_iteration_metrics": run_m["elapsed_s"] * 1e3
        / (len(points) * SWEEP_ITERS),
        "peak_gib": run_a["peak_gib"], "peak_gib_metrics": run_m["peak_gib"],
        "wall_s": run_a["wall_s"], "bitwise": True}
    del res_m, got
    torch.cuda.empty_cache()

    # (c) run_fed_sweep on (a)'s task
    fgrid = sweep.FedScenarioGrid(**SWEEP_FED_GRID)
    fed_runs = {}
    for b in ("cuda", "reference"):
        o = opt.make("chb", FULL_ALPHA, FULL_M, eps1=FULL_EPS1, backend=b)
        torch.cuda.synchronize()
        common.reset_launches()
        t = time.perf_counter()
        fr = sweep.run_fed_sweep(o, task, fgrid, SWEEP_ITERS, device=device)
        torch.cuda.synchronize()
        fed_runs[b] = (fr, time.perf_counter() - t, dict(common.LAUNCHES))
    (fk, wk, lk), (fref, wr, lr) = fed_runs["cuda"], fed_runs["reference"]
    for f in ("objective", "agg_grad_sqnorm", "transmit_mask",
              "delivered_mask", "participate_mask", "quorum_met",
              "comm_cum", "delivered_cum", "bytes_cum", "energy_cum"):
        check(np.array_equal(getattr(fk, f), getattr(fref, f)),
              f"sweep (c): {f} differs between backends")
    rounds = len(fk) * SWEEP_ITERS * leaves
    want = {name: rounds if name in ("sqnorm_batched", "bank_advance",
                                     "hb_update") else 0
            for name in common.KERNELS}
    check(lk == want, f"sweep (c): launches {lk}, want {want}")
    check(not any(lr.values()),
          "sweep (c): the reference backend launched a kernel")
    ideal = fk.points.index(sweep.FedScenarioPoint(0.0, 1.0, 1.0, 0))
    o = opt.make("chb", FULL_ALPHA, FULL_M, eps1=FULL_EPS1, backend="cuda")
    ref = simulator.run(o, task, SWEEP_ITERS, device=device)
    check(np.array_equal(fk.objective[ideal], ref.objective.cpu().numpy())
          and np.array_equal(fk.agg_grad_sqnorm[ideal],
                             ref.agg_grad_sqnorm.cpu().numpy())
          and np.array_equal(fk.comm_cum[ideal], ref.comm_cum.cpu().numpy())
          and np.array_equal(fk.transmit_mask[ideal],
                             ref.mask.cpu().numpy().astype(np.int8))
          and bool(fk.quorum_met[ideal].all()),
          "sweep (c): the ideal scenario differs from simulator.run")
    check((fk.delivered_cum[:, -1] <= fk.comm_cum[:, -1]).all()
          and fk.participate_mask.mean() < 1,
          "sweep (c): the scenarios drew no partial cohort")
    launches["sweep_fed"] = lk
    summary["fed"] = {
        "scenarios": len(fk), "rounds": SWEEP_ITERS,
        "uploads": fk.comm_cum[:, -1].tolist(),
        "delivered": fk.delivered_cum[:, -1].tolist(),
        "quorum_met": fk.quorum_met.sum(axis=1).tolist(),
        "ms_per_round_cuda": wk * 1e3 / (len(fk) * SWEEP_ITERS),
        "ms_per_round_reference": wr * 1e3 / (len(fref) * SWEEP_ITERS),
        "bitwise": True}
    del ref, fed_runs, fk, fref, fr
    torch.cuda.empty_cache()

    # (b) the paper's Fig. 11 setting, cut
    def factory(seed, m):
        return paper_tasks.make_linear_regression(m=m, seed=seed,
                                                  device=device).task
    alpha = paper_tasks.make_linear_regression(device="cpu").alpha_paper
    tasks = {s: factory(s, SWEEP_FIG11_M) for s in SWEEP_FIG11_SEEDS}
    fgrid = sweep.ConfigGrid(alpha=(alpha,), beta=(0.4,),
                             eps1_scale=SWEEP_FIG11_SCALES,
                             seed=SWEEP_FIG11_SEEDS,
                             num_workers=(SWEEP_FIG11_M,))
    fig11 = {}
    for b in ("cuda", "reference"):
        fbase = opt.make("chb", alpha, SWEEP_FIG11_M, backend=b)
        torch.cuda.synchronize()
        common.reset_launches()
        t = time.perf_counter()
        res = sweep.run_sweep(fgrid, task_factory=factory,
                              num_iters=SWEEP_FIG11_ITERS, base_cfg=fbase,
                              device=device)
        torch.cuda.synchronize()
        wall, lb = time.perf_counter() - t, dict(common.LAUNCHES)
        got = [_fingerprint(h) for h in res.histories]
        prints, per_point = _per_point_runs(
            res.points, res.specs, lambda p: tasks[p.seed],
            SWEEP_FIG11_ITERS, device)
        for i, (g, r) in enumerate(zip(got, prints)):
            check(_same_fingerprint(g, r), f"sweep (b) {b}: point {i} "
                  f"{res.points[i]} differs from simulator.run")
        check(lb == per_point, f"sweep (b) {b}: launches {lb} != the "
              f"per-point runs' {per_point}")
        fig11[b] = (res, got, wall, lb)
    (rk, gk, wk, lk), (rr, gr, wr, lr) = fig11["cuda"], fig11["reference"]
    for i, (a, b) in enumerate(zip(gk, gr)):
        check(torch.equal(a["mask"], b["mask"])
              and torch.equal(a["comm_cum"], b["comm_cum"])
              and a["uplink_bytes"] == b["uplink_bytes"],
              f"sweep (b): point {i} masks differ between backends")
    n_pts = len(rk)
    want = {name: (n_pts * SWEEP_FIG11_ITERS
                   if name in PATH_KERNELS["dense"] else 0)
            for name in common.KERNELS}
    check(lk == want, f"sweep (b): launches {lk}, want {want}")
    check(not any(lr.values()),
          "sweep (b): the reference backend launched a kernel")
    launches["sweep_fig11"] = lk
    theta_rel = max(float((a["theta"][0] - b["theta"][0]).abs().max()
                          / b["theta"][0].abs().max())
                    for a, b in zip(gk, gr))
    summary["fig11"] = {
        "points": n_pts, "partitions": rk.num_programs,
        "iters": SWEEP_FIG11_ITERS,
        "uploads": [int(g["comm_cum"][-1]) for g in gk],
        "point_iterations_per_s_cuda": n_pts * SWEEP_FIG11_ITERS
        / rk.elapsed_s,
        "point_iterations_per_s_reference": n_pts * SWEEP_FIG11_ITERS
        / rr.elapsed_s,
        "wall_s_cuda": wk, "wall_s_reference": wr,
        "theta_max_rel_diff_between_backends": theta_rel,
        "bitwise": True}
    del fig11, rk, rr, gk, gr, tasks
    torch.cuda.empty_cache()
    emit({"phase": "sweep", "d": FULL_D, "m": FULL_M, **summary,
          "seconds": time.perf_counter() - t0})
    return launches


# ------------------------------------------------------- phase serve
def _gap(logits: torch.Tensor) -> torch.Tensor:
    """Each row's top-2 gap."""
    top = torch.topk(logits, 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def phase_serve(device) -> dict:
    """chb-paper-lm-124m at full width through ``launch.serve.generate``:
    the reference backend, then the cuda backend teacher-forced with the
    reference's tokens; logits, argmax and launch counts. Returns each
    run's launch counts."""
    from repro_torch.kernels import common
    from repro_torch.launch import serve
    cfg = get_config(LM_ARCH)
    # the JAX package's launch.serve weights: init_params(PRNGKey(0), cfg)
    params = init_params(PRNGKey(0, device=device), cfg)
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(n_params == FULL_D == 163_597_056,
          f"serve: {n_params} parameters")
    check(cfg.num_layers == 12 and cfg.d_model == 768
          and cfg.num_heads == cfg.num_kv_heads == 12 and cfg.head_dim == 64
          and cfg.vocab_size == 32768, f"serve: {cfg}")
    out, launches = {}, {}
    for run, shape in SERVE_RUNS.items():
        b, l, gen = shape["batch"], shape["prompt"], shape["gen"]
        prompts = serve.prompts_of(cfg, b, l, device)
        ref_runs = [serve.generate(params, cfg, prompts, gen,
                                   backend="reference", device=device)
                    for _ in range(2)]          # the first warms up
        ref = ref_runs[-1]
        check(torch.equal(ref.tokens, ref_runs[0].tokens),
              f"{run}: the reference backend is not repeatable")
        check(not torch.backends.cuda.matmul.allow_tf32,
              f"{run}: TF32 matmuls are on")
        serve.generate(params, cfg, prompts, gen, feed=ref.tokens,
                       device=device)            # warm-up
        common.reset_launches()
        cud = serve.generate(params, cfg, prompts, gen, feed=ref.tokens,
                             device=device)
        torch.cuda.synchronize()
        launches[run] = dict(common.LAUNCHES)
        want = {name: 0 for name in common.KERNELS}
        want["flash_attention"] = cfg.num_layers
        want["decode_attention"] = cfg.num_layers * (gen - 1)
        check(launches[run] == want,
              f"{run}: launches {launches[run]}, want {want}")
        diff = max(max_diff(a, r) for a, r in zip(cud.logits, ref.logits))
        check(all(bool(torch.isfinite(x).all()) for x in cud.logits)
              and tuple(cud.logits[0].shape) == (b, cfg.vocab_size),
              f"{run}: logits not finite or of the wrong shape")
        check(diff <= SERVE_LOGIT_TOL,
              f"{run}: logits differ between backends by {diff}")
        gaps = torch.stack([_gap(r) for r in ref.logits], dim=1)
        clear = gaps > 2 * SERVE_LOGIT_TOL
        check(torch.equal(cud.tokens[clear], ref.tokens[clear]),
              f"{run}: argmax differs where the top-2 gap is clear")

        def rate(g):
            return b * gen / ((g.prefill_ms + sum(g.step_ms)) / 1e3)
        out[run] = {
            "batch": b, "prompt": l, "gen": gen, "cache": l + gen + 1,
            "max_logit_diff": diff,
            "argmax_compared": int(clear.sum()),
            "argmax_total": int(clear.numel()),
            "argmax_equal_all": bool(torch.equal(cud.tokens, ref.tokens)),
            "prefill_ms_cuda": cud.prefill_ms,
            "prefill_ms_reference": ref.prefill_ms,
            "decode_ms_per_step_cuda": statistics.median(cud.step_ms),
            "decode_ms_per_step_reference": statistics.median(ref.step_ms),
            "tok_per_s_cuda": rate(cud), "tok_per_s_reference": rate(ref),
            "launches": {k: c for k, c in launches[run].items() if c},
        }
        del ref_runs, ref, cud, prompts
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    emit({"phase": "serve", "arch": LM_ARCH, "params": FULL_D,
          "logit_tol": SERVE_LOGIT_TOL, "tf32": False, **out})
    return launches


def phase_pin(device) -> None:
    """The JAX pin: the reduced and GQA configs with numpy weights, on the
    cuda backend: greedy tokens exactly, the prefill-logit checksums within
    SERVE_PIN_RTOL of the abs-sum."""
    import dataclasses

    from repro_torch.convert import model_params, numpy_model_params
    from repro_torch.launch import serve
    base = get_config(LM_ARCH).reduced()
    cfgs = {"reduced": base,
            "gqa": dataclasses.replace(base, num_kv_heads=2,
                                       layer_pattern="AS", sliding_window=16,
                                       qk_norm=True).validate()}
    out = {}
    for name, cfg in cfgs.items():
        params = model_params(numpy_model_params(cfg, SERVE_PIN_SEEDS[name]),
                              cfg, device)
        sh = SERVE_PIN_SHAPE
        prompts = serve.prompts_of(cfg, sh["batch"], sh["prompt"], device)
        g = serve.generate(params, cfg, prompts, sh["gen"],
                           cache_len=sh["cache"], device=device)
        toks, total, abs_total = SERVE_PIN[name]
        first = g.logits[0].double()
        got = (float(first.sum()), float(first.abs().sum()))
        check(g.tokens.cpu().tolist() == toks,
              f"pin {name}: tokens {g.tokens.cpu().tolist()}, the JAX "
              f"package's {toks}")
        tol = SERVE_PIN_RTOL * abs_total
        check(abs(got[0] - total) <= tol and abs(got[1] - abs_total) <= tol,
              f"pin {name}: checksums {got}, the JAX package's "
              f"{(total, abs_total)}")
        out[name] = {"tokens_equal": True, "sum": got[0], "abs_sum": got[1],
                     "jax_sum": total, "jax_abs_sum": abs_total}
    emit({"phase": "jax_pin", **out})


def phase_ops(device, d=FULL_D) -> dict:
    """The four single-tensor ``ops`` entry points on the card against their
    plain versions: B12a, B12b and B3 at n = d in f32, B14 at one batch row
    of serve_long's prefill. Returns the launch counts of the run."""
    from repro_torch.kernels import common, ops
    gen = torch.Generator(device=device).manual_seed(13)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    g, h, t, p = randn(d), randn(d), randn(d), randn(d)
    g[::7] = -0.0
    h[::11] = -0.0
    q, k, v = (randn(1, 2048, 12, 64).transpose(1, 2) for _ in range(3))
    torch.cuda.synchronize()
    common.reset_launches()
    sq = ops.censor_delta_sqnorm(g, h)
    sq_p = ops.censor_delta_sqnorm(g, h, use_pallas=False)   # no launch
    g[3] = float("nan")
    h[5] = float("nan")
    sel = [ops.censor_select(g, h, flag) for flag in (0, 1)]
    hb = ops.hb_param_update(t, h, p, 0.1, 0.4)
    att = ops.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    launches = dict(common.LAUNCHES)
    want = {name: 0 for name in common.KERNELS}
    want.update(censor_delta_sqnorm=1, censor_select=2, hb_update=1,
                flash_attention=1)
    check(launches == want, f"ops: launches {launches}, want {want}")
    check(_rel_err(sq, sq_p) <= SQNORM_RTOL,
          f"ops B12a: {float(sq)} against {float(sq_p)}")
    for flag, out in zip((0, 1), sel):
        check(same_bits(out, ops.censor_select(g, h, flag,
                                               use_pallas=False)),
              f"ops B12b transmit={flag}")
    check(same_bits(hb, ops.hb_param_update(t, h, p, 0.1, 0.4,
                                            use_pallas=False)), "ops B3")
    err = _attn_check(att, ops.flash_attention_fwd(q, k, v,
                                                   use_pallas=False),
                      _flash_f64(q, k, v, True, None), "ops B14")
    emit({"phase": "ops", "n": d, "B12a_rel_err": _rel_err(sq, sq_p),
          "B12b": "bitwise", "B3": "bitwise", "B14_errors": err,
          "launches": {k_: c for k_, c in launches.items() if c}})
    return launches


# ------------------------------------------------------------ phase 6
# device cycles the card sleeps before a timed window, while the host
# queues the window's calls: about 10 ms at an H100's 1.98 GHz, longer than
# any window's host time, so the events time the card's work alone (B13's
# wrapper takes longer on the host than its kernel on the card)
SLEEP_CYCLES = 20_000_000


def _time_ms(fn, reps: int) -> float:
    """Mean ms of one call over ``reps`` calls queued back to back between
    two CUDA events, after one warm-up call; the card sleeps first while
    the host queues the calls, so no host time falls in the window."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def fed_mesh_timing(device, m=MANY_M, n=MANY_D) -> dict:
    """B2 and B6 at the fed-mesh shape (M = 100,000, n = 16, f64): the
    design the wrapper picks and the one-pass design, the shape's byte
    bound, and the floor of an exact fold there (one thread's M - 1
    dependent f64 adds, ``benchmarks_torch/chain_floor.py``)."""
    from benchmarks_torch.chain_floor import chain_floor_ms
    from repro_torch.core.quantize import int8_scale
    from repro_torch.kernels import common, fused_step, ref
    floor = chain_floor_ms(m)
    gen = torch.Generator(device=device).manual_seed(23)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float64)

    g, h, e = randn(m, n), randn(m, n), randn(m, n) * 0.01
    t, p = randn(n), randn(n)
    mask = torch.tensor([1.0, 0.0] * (m // 2) + [1.0] * (m % 2),
                        device=device)
    scale = int8_scale(ref.absmax_batched((g - h) + e))
    el = 8                                              # f64 bytes
    work = {   # name: (run by design, bytes moved)
        "fused_dense_step": (
            lambda path: fused_step.dense_on_card(g, h, t, p, mask, 0.1, 0.4,
                                                  path),
            (3 * m * n + 4 * n) * el + 4 * m),
        "fused_int8_step": (
            lambda path: fused_step.int8_on_card(g, h, e, t, p, mask, scale,
                                                 0.1, 0.4, path),
            (5 * m * n + 4 * n) * el + 8 * m),
    }
    path = common.fold_path(m, n, common.sm_count(device.index or 0))
    out = {}
    for name, (run, nbytes) in work.items():
        ms = _time_ms(lambda: run(path), 10)
        one_pass_ms = _time_ms(lambda: run("one_pass"), 3)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = {"shape": f"M={m} n={n} float64", "path": path,
                     "ms": ms, "one_pass_ms": one_pass_ms,
                     "bytes": nbytes, "bound_ms": bound_ms,
                     "chain_floor_ms": floor["f64"],
                     "ms_over_chain_floor": ms / floor["f64"]}
    del g, h, e, t, p
    torch.cuda.empty_cache()
    emit({"phase": "fed_mesh_timing", "chain_floor_ms": floor, **out})
    return out


def phase_timing(device, launches, max_err, d=FULL_D, m=FULL_M) -> list:
    """Each kernel at the full-width shape (B3 at n, the rest at M x n):
    its time, its plain version's, one PyTorch call's where one computes
    the same function, and its bound. ``launches`` maps each path to its
    kernels' counts from phase 5."""
    from repro_torch.core.quantize import int8_scale
    from repro_torch.kernels import (censor, fused_step, hb_update,
                                     lowrank_ef, quantize_ef, ref, topk_pack)
    gen = torch.Generator(device=device).manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    g, h, e = randn(m, d), randn(m, d), randn(m, d) * 0.01
    t, p = randn(d), randn(d)
    keep = (randn(m, d) > 0.2533).to(torch.float32)   # about 40% kept
    mask = torch.tensor([1.0, 0.0] * (m // 2) + [1.0] * (m % 2),
                        device=device)
    pend = (g - h) + e
    scale = int8_scale(ref.absmax_batched(pend))
    nab = g[0]
    el = 4                                             # f32 bytes
    work = {   # name: (kernel, plain, library call or None, bytes moved,
               #        f32 operations)
        "censor_delta_sqnorm_batched": (
            lambda: censor.censor_delta_sqnorm_batched(g, h),
            lambda: ref.censor_delta_sqnorm_batched(g, h), None,
            2 * m * d * el + 4 * m, 3 * m * d),
        "fused_dense_step": (
            lambda: fused_step.fused_dense_step(g, h, t, p, mask, 0.1, 0.4),
            lambda: ref.fused_dense_step(g, h, t, p, mask, 0.1, 0.4), None,
            ((2 * m + 2) + (m + 2)) * d * el + 4 * m, (4 * m + 5) * d),
        "int8_stats_batched": (
            lambda: fused_step.int8_stats_batched(g, h, e),
            lambda: ref.int8_stats_batched(g, h, e), None,
            3 * m * d * el + 8 * m, 6 * m * d),
        "fused_int8_step": (
            lambda: fused_step.fused_int8_step(g, h, e, t, p, mask, scale,
                                               0.1, 0.4),
            lambda: ref.fused_int8_step(g, h, e, t, p, mask, scale, 0.1,
                                        0.4), None,
            ((3 * m + 2) + (2 * m + 2)) * d * el + 8 * m, (16 * m + 5) * d),
        "sqnorm_batched": (
            lambda: censor.sqnorm_batched(g),
            lambda: ref.sqnorm_batched(g),
            lambda: torch.linalg.vecdot(g, g),
            m * d * el + 4 * m, 2 * m * d),
        "bank_advance": (
            lambda: censor.bank_advance(h, g, mask),
            lambda: ref.bank_advance(h, g, mask),
            lambda: torch.addcmul(h, mask[:, None], g),
            3 * m * d * el + 4 * m, 2 * m * d),
        "hb_update": (
            lambda: hb_update.hb_update(t, nab, p, 0.1, 0.4),
            lambda: ref.hb_update(t, nab, p, 0.1, 0.4), None,
            4 * d * el, 5 * d),
        "select_pack_ef_batched": (
            lambda: topk_pack.select_pack_ef_batched(g, e, keep, mask),
            lambda: ref.select_pack_ef_batched(g, e, keep, mask), None,
            5 * m * d * el + 4 * m, 5 * m * d),
        "residual_ef_batched": (
            lambda: lowrank_ef.residual_ef_batched(g, h, e, mask),
            lambda: ref.residual_ef_batched(g, h, e, mask), None,
            4 * m * d * el + 4 * m, 5 * m * d),
        "censor_bank_advance": (
            lambda: censor.censor_bank_advance(g, h, mask),
            lambda: ref.censor_bank_advance(g, h, mask),
            # rounds otherwise at weight 1 (h + 1*(g - h) is not g): a time
            lambda: torch.lerp(h, g, mask[:, None]),
            3 * m * d * el + 4 * m, 3 * m * d),
        "absmax_batched": (
            lambda: quantize_ef.absmax_batched(pend),
            lambda: ref.absmax_batched(pend),
            lambda: torch.linalg.vector_norm(pend, ord=math.inf, dim=1),
            m * d * el + el * m, 2 * m * d),
        "quantize_ef_batched": (
            lambda: quantize_ef.quantize_ef_batched(pend, e, mask, scale),
            lambda: ref.quantize_ef_batched(pend, e, mask, scale), None,
            4 * m * d * el + 8 * m, 9 * m * d),
    }
    fed = fed_mesh_timing(device)
    rows = []
    for name, (kfn, pfn, lfn, nbytes, ops) in work.items():
        ms = _time_ms(kfn, 10)
        plain_ms = _time_ms(pfn, 3)
        library_ms = None if lfn is None else _time_ms(lfn, 10)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_FLOPS * 1e3
        src, replaces = KERNEL_META[name]
        by_path = {path: c[name] for path, c in launches.items()
                   if c[name]}
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": sum(by_path.values()),
            "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, "launches_by_path": by_path,
            "bytes": nbytes,
            "shape": (f"n={d} float32" if name == "hb_update"
                      else f"M={m} n={d} float32"),
            **({"fed_mesh": fed[name]} if name in fed else {})})
        torch.cuda.empty_cache()
    del g, h, e, t, p, keep, pend, nab
    torch.cuda.empty_cache()
    return rows + model_timing_rows(device, launches, max_err, d)


def model_timing_rows(device, launches, max_err, d=FULL_D) -> list:
    """B12a and B12b at n = d in f32; B13 at serve_long's last decode step
    and B14 at its prefill (batch 8, 12 heads, head dim 64, the model's
    strided views). Bounds count what these inputs need: B12b reads only
    the side it selects, B14 the causal band's products."""
    import torch.nn.functional as F

    from repro_torch.kernels import (censor, decode_attention,
                                     flash_attention, ref)
    from repro_torch.models.kvcache import slot_positions
    gen = torch.Generator(device=device).manual_seed(17)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    g, h = randn(d), randn(d)
    flag = torch.tensor(True, device=device)
    run = SERVE_RUNS["serve_long"]
    b, l, hd, nh = run["batch"], run["prompt"], 64, 12
    c, pos = l + run["gen"] + 1, l + run["gen"] - 2
    q1 = randn(b, nh, hd)
    kc, vc = randn(b, c, nh, hd), randn(b, c, nh, hd)
    cpos = slot_positions(pos + 1, c, device)
    kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
    valid = (cpos >= 0) & (cpos <= pos)
    q, k, v = (randn(b, l, nh, hd).transpose(1, 2) for _ in range(3))
    pairs = l * (l + 1) // 2                      # causal (q, k) pairs
    work = {   # name: (kernel, plain, library, bytes, f32 operations, shape)
        "censor_delta_sqnorm": (
            lambda: censor.censor_delta_sqnorm(g, h),
            lambda: ref.censor_delta_sqnorm(g, h),
            lambda: torch.dist(g, h), 2 * d * 4 + 4, 3 * d,
            f"n={d} float32"),
        "censor_select": (
            lambda: censor.censor_select(g, h, 1),
            lambda: ref.censor_select(g, h, 1),
            lambda: torch.where(flag, g, h), 2 * d * 4, 0,
            f"n={d} float32, transmit=1"),
        "decode_attention": (
            lambda: decode_attention.decode_attention(q1, kt, vt, cpos, pos),
            lambda: ref.decode_attention_ref(q1, kt, vt, cpos, pos),
            lambda: F.scaled_dot_product_attention(
                q1[:, :, None], kt, vt, attn_mask=valid),
            2 * b * c * nh * hd * 4 + 2 * b * nh * hd * 4 + 4 * c,
            4 * b * nh * c * hd,
            f"B={b} H=K={nh} C={c} d={hd} float32, pos={pos}"),
        "flash_attention": (
            lambda: flash_attention.flash_attention(q, k, v, causal=True),
            lambda: ref.flash_attention_fwd(q, k, v, causal=True),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
            4 * b * nh * l * hd * 4, 4 * b * nh * pairs * hd,
            f"B={b} H=K={nh} L={l} d={hd} float32, causal"),
    }
    rows = []
    for name, (kfn, pfn, lfn, nbytes, ops_, shape) in work.items():
        ms = _time_ms(kfn, 10)
        plain_ms = _time_ms(pfn, 3)
        library_ms = _time_ms(lfn, 10)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops_ / F32_FLOPS * 1e3
        src, replaces = KERNEL_META[name]
        by_path = {path: cnt[name] for path, cnt in launches.items()
                   if cnt[name]}
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": sum(by_path.values()),
            "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, "launches_by_path": by_path,
            "bytes": nbytes, "operations": ops_, "shape": shape})
        torch.cuda.empty_cache()
    return rows


def main() -> None:
    t0 = time.perf_counter()
    phase_device()
    # the low-rank factors are plain matmuls: full f32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(FULL_D == 163_597_056, f"chb-paper-lm-124m has {FULL_D} "
          "parameters in the port's init_params")
    phase_build()
    dev = torch.device("cuda")
    max_err = phase_kernels(dev)
    # past grid y's 65535 blocks: the seven kernels walk the workers
    large = phase_kernels(dev, ms=(LARGE_M,), ns=(2049,),
                          phase="kernels_large_m")
    max_err = {k: max(v, large[k]) for k, v in max_err.items()}
    phase_bank_advance_paths(dev)
    phase_absmax_paths(dev)
    phase_fused_fold_paths(dev)
    phase_attention_kernels(dev, max_err)
    phase_golden(dev)
    flat, setup_s = full_task(dev)
    launches = phase_full(flat, setup_s)
    launches.update(phase_many_workers())
    launches.update(phase_edge(dev, flat))
    launches.update(phase_sweep(dev, flat))
    del flat
    torch.cuda.empty_cache()
    launches.update(phase_serve(dev))
    phase_pin(dev)
    launches["ops"] = phase_ops(dev)
    rows = phase_timing(dev, launches, max_err)
    check(len(rows) == len(KERNEL_META) == 16, f"{len(rows)} kernel rows")
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
