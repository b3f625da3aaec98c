#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Runs from the repository root (it puts ``src/`` on ``sys.path`` itself)
and imports only ``repro_torch``. Phases, each printing one JSON line:

  1. device   -- CUDA must be present; prints ``nvidia-smi``'s name and
                 power limit.
  2. build    -- compiles ``src/repro_torch/kernels/csrc`` with nvcc;
                 then (phase bwd_bf16_sass) counts the HGMMA (wgmma)
                 instructions ``cuobjdump --dump-sass`` finds in each of
                 the bf16 flash backward's dk/dv and dq kernels, and fails
                 if one has none.
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
                 B5's abs-max; (phase fused_fold_paths) B2, B6 and the
                 worker fold (fold_workers) on the shape their wrappers
                 dispatch (common.fold_path) and on the other design, at M
                 up to 100,000 and on each side of the threshold, salted
                 with -0.0, NaN and +-inf; (phase tall_paths) B10, B1,
                 B8, B5, B7a and B9 on tall banks (M from 65 to 100,000
                 and on each side of the worker threshold, n in {1, 16,
                 33, 2049}, f32 and f64, salted the same way): B10 and B9
                 against their plain versions bit for bit; the two designs
                 of B1, B8, B5 and B7a (common.sqnorm_path) against each
                 other and their M=1 calls, B1 against B8 on g - ghat, B5
                 against B8 and B7a on its pending delta, bit for bit (NaN
                 where NaN); B7a and B9 also on misaligned views;
                 (phase fused_bf16_banks) the 20 launchers of B1, B2, B5
                 and B6 on bf16 banks (bf16 params, f32 params, and B5/B6
                 with an f32 err), both designs of each, M in {1, 4, 9,
                 70,000}, odd n, views one element off, salted with -0.0,
                 NaN and +-inf, against their plain versions (B2, B6 and
                 B5's abs-max bit for bit, the sums within SQNORM_RTOL),
                 the designs against each other, repeats and M=1 slices
                 bitwise; (phase staged_bf16_banks) the 10 launchers of B3,
                 B4, B8, B9 and the worker fold on bf16 banks (bf16 and f32
                 operands), each design, the same shapes and rows of 16
                 and 2048 (B4's and B9's 16-byte tiles), against their
                 plain versions (B3, B4, B9 and the fold bit for bit, B8
                 within SQNORM_RTOL), the designs, repeats and M=1 slices
                 bitwise; (phase stateful_bf16_banks) the 10 launchers of
                 B7a, B7b, B10 and B11 on a bf16 pending leaf (err and
                 B11's payload in bf16 and f32), both designs of B7a, the
                 same shapes and the fed mesh's M = 10^5 rows of 16,
                 against their plain versions bit for bit, B7a against
                 B5's abs-max and B7b's err' against B6's, the designs,
                 repeats and M=1 slices bitwise;
                 (phase attention_kernels) B14 over GQA 1/2/4/6,
                 causal, window and non-causal rectangular shapes on and
                 off its tiles, head dims 32-256, strided and misaligned
                 views, f32 and bf16 (also one batch row of qwen3-4b's and
                 gemma3-12b's serve_long prefill in bf16: d 128, and d 256
                 causal and at window 1024; the bf16 tensor-core design
                 at L in {1, 63, 64, 65, 127, 129, 2047}, d 33-256, GQA
                 1-8, bands across its 64-key tiles, rows with no valid
                 key, misaligned views); B13 over C in {1, 31, 97, 257,
                 2081}, empty slots, wrapped rings and pos 0 (also both
                 models' last serve_long step in bf16, full caches and
                 gemma3's 1024-slot ring, and a strided bf16 cache); both
                 against an f64 plain version (ATTN_FACTOR; bf16 outputs
                 also row by row); B12a within SQNORM_RTOL and repeatable,
                 B12b bitwise with -0.0 and NaN salted. B14 with its
                 log-sum-exp on every B14 case: the output the same bits as
                 without it, the lse against its plain version and an f64
                 version; the flash backward (FLASH_BWD_CASES: GQA 1/2/4/6,
                 L on, one short of and one past its 64-row and 32-key
                 tiles, Lq != S, rows with no valid key, d in {33, 64,
                 80, 128, 256}, causal, windows (16 on 64-row tiles),
                 misaligned views, training's (4, 12, 256, 64) and L =
                 2048) against its plain version and an f64 version
                 (ATTN_FACTOR), its bits the same over three calls; its
                 bf16 build (FLASH_BWD_BF16_CASES: qwen3-4b's and
                 gemma3-12b's training shapes, causal and at window 1024,
                 then the edges of the tensor-core design's 64-row,
                 64-key and 32-row tiles and of the SIMT design's 64-row
                 and 32-key ones) from B14 bf16's output and lse,
                 each element within bf16_bwd_excess's bound of the f64
                 function of the same residuals and of its bf16 plain
                 version, its bits the same over three calls.
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
                 fused steps, the launch counts read per path. Also dense
                 and int8 with ``bank_dtype=torch.bfloat16`` (f32 params:
                 masks, counts, bytes and theta equal to the reference
                 backend's) and on the task in bf16, held step by step
                 against the reference backend from one state (Lockstep:
                 eq. (4) runs in f32 in the kernels, in bf16 there); and
                 the staged dense route, the sharded anchor and per_tensor
                 on both (B3, B4, B8, B9 and the fold on bf16 banks), the
                 staged and sharded runs equal to the fused bf16 ones bit
                 for bit; and the stateful transports on both (B7a, B7b,
                 B10, B11 on a bf16 pending leaf): staged and sharded int8
                 (equal to the fused int8 runs bit for bit) and top-k on
                 one leaf, low-rank on the 12 leaves, f32 params over a
                 bf16 bank (held against the reference backend whole, and
                 low-rank step by step: its reference keeps err' in f32)
                 and bf16 params (Lockstep).
  many_workers -- benchmarks/fed_mesh.py's edge quadratics (d=16, f64)
                 at its frontier M = 100,000 (fused dense and int8) and at
                 M = 70,000 (the staged routes and top-k, whose worker sum
                 runs in fold_workers; the reference backend's folds in
                 Python), 3 iterations: cuda against reference bit for
                 bit, the launch counts read per path, each path's median
                 step ms.
  mesh        -- ``fed.run_mesh`` on the same task at M = 100,000, chb
                 dense, benchmarks/fed_mesh.py's 4 frontier scenarios
                 (ideal, lossy, partial, harsh), MESH_ROUNDS rounds each
                 over K in {1, 2, 8} shards on the one card: masks, cohort,
                 attempted, delivered, quorum and bytes bit-equal across
                 K; the ideal scenario at K = 1 equal to ``simulator.run``
                 bit for bit; the harsh one equal on both backends over
                 MESH_REF_ROUNDS rounds; B1, B4 and fold_workers once a
                 shard a round, B3 once a round. Also the ideal scenario
                 on a bf16 bank of f32 params at K = 1: equal to
                 ``simulator.run`` and, over two rounds, to the reference
                 backend bit for bit. Ms a round.
  edge        -- ``fed.run_edge`` at phase 5's width (M = 4, one leaf of
                 163,597,056 f32), chb dense and int8 and csgd, 10 rounds
                 each: (a) under ``sync_config(4)`` it equals
                 ``simulator.run`` on the card bit for bit; (b) a
                 deployment (one 12x straggler, availability 0.8, 15%
                 loss, quorum 3/4) gives the same masks, counters, wall
                 clock, energy and theta on both backends; (c) B8's M = 1
                 row equals the batched slice; (d) B8 launches once per
                 client evaluation, B3 once per round, nothing else; the
                 deployment of chb on a bf16 bank of the f32 params equal
                 on both backends too. Also
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
  serve_bf16  -- the same two runs of qwen3-4b (4,022,468,096 parameters)
                 and gemma3-12b (8,934,264,576) at full width in bf16, one
                 after the other, with the JAX package's
                 init_params(PRNGKey(0)) weights (their draw timed): logits
                 within SERVE_BF16_LOGIT_ULPS, B14 once a layer a prefill
                 and B13 once a layer a step, TF32 and bf16
                 reduced-precision GEMM reductions off; peak memory.
  jax_pin     -- the reduced and GQA configs with numpy weights on the
                 cuda backend: the JAX package's greedy tokens exactly and
                 its prefill-logit checksums (SERVE_PIN); qwen3-4b and
                 gemma3-12b reduced in bf16 with GQA (SERVE_BF16_PIN):
                 teacher-forced with JAX's tokens, argmax equal where the
                 gap is clear, checksums within SERVE_BF16_PIN_RTOL.
  ops         -- the four single-tensor ``kernels.ops`` entry points
                 (B12a, B12b, B3 at n = 163,597,056 f32, B14) against their
                 plain versions.
  train       -- ``train.trainer.train`` of chb-paper-lm-124m at full
                 width (163,597,056 f32 parameters, init_params(PRNGKey(0)),
                 M = 4 workers, global batch 16 x 256 tokens, TRAIN_TC):
                 TRAIN_STEPS chb steps through B14 with its log-sum-exp,
                 the flash backward, B1 and B2, each step's launches the
                 scan step's, CUDA events around every step; int8 one step
                 through B5 and B6. Then from one state the first step on
                 both backends, and the second from the cuda backend's
                 state after the first: masks, transmitted and counters
                 equal (each eq.-(8) decision's margin reported), params
                 and ghat within TRAIN_RTOL of the leaf's largest value.
                 Ms a step, tokens a second, peak device memory.
  train_bf16  -- ``train.trainer.train`` of qwen3-4b and gemma3-12b in
                 bf16 at their published widths, depth cut to fit the
                 card (TRAIN_BF16: qwen3-4b at 16 of 36 layers, 3 chb
                 steps of 16 x 256 tokens, and at 10 layers one int8
                 step; gemma3-12b at one SSSSSA superblock, 2 chb steps
                 of 4 x 2048 tokens), params and bank in bf16: every step
                 through B14 bf16 with its lse and flash_attention_bwd_bf16
                 once a layer a worker and B1/B2 (B5/B6) bf16 once a
                 leaf, counted per C launcher; ms a step, tokens a
                 second, peak memory, losses, uploads, one JSON line a
                 run. Then (_bf16_lockstep) one state's first three
                 steps on both backends at 4 and 2 layers, the first two
                 sending every worker and the third (eps1_scale 64)
                 censoring every one: each decision's margin above
                 dsq_bound, masks and counters equal, ghat' and theta'
                 within their derived bounds.
  train_cli   -- ``python -m repro_torch.launch.train --steps 2`` as a
                 subprocess (full width on the card): exit 0 and one
                 finite loss line a logged step.
  6. timing   -- each kernel, its plain version, its library call where
                 one exists and its bound at the main path's shape (B2 and
                 B6 also at the fed-mesh shape, on both designs, beside
                 the measured floor of an exact fold there:
                 benchmarks_torch/chain_floor.py; fold_workers and B1's
                 two designs there and at 10^6, B1 also on each side of
                 its worker threshold; B4, B5, B7a, B7b, B8, B9 (B5, B8
                 and B7a on both designs), B10 and B11 at M = 70,000 and
                 100,000, n = 16);
                 B14 also with its log-sum-exp, the flash backward at
                 training's shape (one worker's 4 x 256 tokens) beside
                 SDPA's autograd backward; B1-B6, B8, B9 and the fold
                 also on bf16 banks of bf16 and of f32 params, B7a, B7b,
                 B10 and B11 on a bf16 pending leaf; then the
                 ``{"kernels":
                 [...]}`` line of all 18 kernels (16 ported, and
                 fold_workers and flash_attention_bwd, which only the port
                 has), the 28 rows of the sub-f32 launchers
                 (``<kernel>_bf16``, ``<kernel>_f32_bf16`` of B1-B6, B8,
                 B9 and the fold; B7b's and B10's ``_bf16`` and
                 ``_bf16_f32`` (f32 err), B11's four, B7a's; the warp
                 designs of B8 and B7a and the fold's tall design at
                 the fed mesh's shape) and B14's and
                 B13's bf16 builds at serve_bf16's serve_long shapes beside
                 bf16 SDPA, bound at the bf16 tensor-core rate; the
                 bf16 flash backward at phase train_bf16's three
                 attention shapes beside bf16 SDPA's backward (bound: the
                 band's five products at the bf16 tensor-core rate), and
                 B14 bf16 with and without its lse there.

The last line is ``{"ok": true, "device": {...}}``. Every failed check
raises, so the script exits non-zero and prints no last line; without
CUDA it stops before any phase.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
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
# whose worker sum runs in fold_workers, and on the reference backend
# folds in Python, one eager add a worker. f64, 3 iterations, both
# backends.
MANY_M = 100_000
MANY_M_STAGED = 70_000
MANY_D = 16
MANY_ITERS = 3
MANY_PATHS = {  # path: (M, opt.make keywords)
    "dense": (MANY_M, {}),
    "int8": (MANY_M, {"quantize": "int8"}),
    "dense_staged": (MANY_M_STAGED, {}),
    "int8_staged": (MANY_M_STAGED, {"quantize": "int8"}),
    "topk": (MANY_M_STAGED, {"transport": "topk", "k": (2 * MANY_D) // 5}),
}
# phase mesh: fed.run_mesh at MANY_M clients on MANY_D, chb dense at
# alpha 0.5/M, eps1 4.0, benchmarks/fed_mesh.py's frontier scenarios
# (participation, loss, quorum; seed 3), over each of MESH_SHARDS shard
# counts on the one card; the reference backend's Python fold (10^5
# eager adds a round) only for MESH_REF_ROUNDS rounds of one scenario
MESH_SCENARIOS = {"ideal": (1.0, 0.0, 1.0), "lossy": (1.0, 0.2, 0.7),
                  "partial": (0.5, 0.0, 0.5), "harsh": (0.5, 0.3, 0.5)}
MESH_SEED = 3
MESH_SHARDS = (1, 2, 8)
MESH_ROUNDS = 10
MESH_REF_ROUNDS = 3
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

# The bf16 pin of serving: qwen3-4b and gemma3-12b reduced (d 256, vocab
# 512) in bf16 with GQA kept (bf16_pin_config), weights from
# convert.numpy_model_params(cfg, seed) (bf16 values), SERVE_PIN_SHAPE: the
# JAX package's greedy tokens of 16 steps and the sum and abs-sum of its
# logits over all 16 steps (f32 of its bf16 products), computed with the
# JAX package on the CPU (models.model.prefill / serve_step, jitted as its
# launch.serve runs them). The port runs teacher-forced with these tokens;
# its argmax must be the JAX package's wherever its own top-2 gap exceeds
# twice SERVE_BF16_LOGIT_ULPS ulps of its largest |logit|, and both sums
# lie within SERVE_BF16_PIN_RTOL of the abs-sum. tests/test_torch_serve_
# bf16.py recomputes the pins with JAX and holds the port on the CPU to
# the same comparisons:
#   PYTHONPATH=src python -m pytest -q tests/test_torch_serve_bf16.py -k pins
SERVE_BF16_PIN_SEEDS = {"qwen3-4b": 0, "gemma3-12b": 0}
SERVE_BF16_PIN = {
    "qwen3-4b": (
        [[392, 242, 268, 354, 436, 35, 35, 35, 168, 115, 20, 46, 242, 48, 509,
          48],
         [128, 76, 413, 128, 76, 413, 128, 212, 180, 338, 487, 487, 487, 487,
          487, 487]],
        7.34910917468369, 13112.766818156466),
    "gemma3-12b": (
        [[139, 139, 139, 249, 249, 249, 249, 249, 139, 29, 249, 249, 249, 249,
          249, 371],
         [68, 68, 68, 68, 68, 456, 456, 456, 456, 456, 456, 456, 456, 456,
          284, 284]],
        -359.4987201411277, 13173.777987236157),
}
# a per-logit difference that is random in sign moves a sum of 16 x 2 x
# 512 logits by about 128 times its typical size (about 1e-4 of the
# abs-sum for a typical size of 0.01); 1e-3 also holds a one-sided drift
# of 8e-4 a logit
SERVE_BF16_PIN_RTOL = 1e-3


def bf16_pin_config(get_fn, arch: str):
    """``arch`` reduced in bf16 with GQA kept: 4 heads over 2 kv heads of
    the model's head dim (128, or gemma3's 256), window 16 (gemma3's "S"
    rings wrap in a pin run), superblocks of 2 layers (gemma3: 4 layers,
    "SASA"). ``get_fn`` is either package's ``configs.get``."""
    import dataclasses
    full = get_fn(arch)
    return dataclasses.replace(
        full.reduced(num_layers=4 if "S" in full.layer_pattern else 2),
        dtype="bfloat16", num_kv_heads=2, head_dim=full.head_dim,
        sliding_window=16, scan_period=2).validate()

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
    # port-only: the JAX package sums the bank with XLA, no Pallas kernel
    "fold_workers": ("src/repro_torch/kernels/csrc/fused_step.cu",
                     "none (port-only; the JAX package's worker sum is "
                     "XLA's jnp.sum, src/repro/core/util.py:52)"),
    # port-only: the JAX package's attention backward is the pure-JAX
    # custom VJP of models/flash.py, which XLA compiles
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_backward.cu",
                            "none (port-only; the JAX package's backward "
                            "is the pure-JAX custom VJP "
                            "src/repro/models/flash.py:96)"),
}
PORT_ONLY = ("fold_workers", "flash_attention_bwd")

# B13/B14 against their plain versions: the kernel's max abs error against
# an f64 plain version on the card (the same function without the f32
# casts) is at most ATTN_FACTOR times the f32 plain version's own max abs
# error against it, plus ATTN_FLOOR. Both f32 versions round the one f64
# function; the kernel sums its products and its softmax in another order
# (online, tile by tile), which may cost a few times the plain version's
# rounding, never more.
ATTN_FACTOR = 4.0
ATTN_FLOOR = 1e-6
# A bf16 output is held to the same rule row by row too: each row's (each
# query's) max abs error against f64 at most ATTN_FACTOR times the plain
# version's on that row, plus ATTN_FLOOR. bf16 rounds to 2^-9 of each
# value, and rows differ in size (a causal row over n keys of random data
# holds values of about sqrt(e / n)), so the whole tensor's max is the
# rounding of the largest early rows and would pass a fault confined to
# the late, small rows (a dropped key tile, a wrong stage of a ring).

# phase train: chb-paper-lm-124m at full width, TrainConfig's defaults (M =
# 4 workers, global batch 16 of 256 tokens, alpha 3e-2, beta 0.4, remat
# "none") but for eps1_scale, set so that the steps censor some workers
TRAIN_TC = {"algorithm": "chb", "num_workers": 4, "global_batch": 16,
            "seq_len": 256, "alpha": 3e-2, "beta": 0.4, "eps1_scale": 8.0}
TRAIN_STEPS = 3
# cuda against reference from one state: the backends sum the attention's
# products (B14 and the backward against their blocked plain versions) and
# the eq.-(8) norms (B1 against torch.sum) in other orders, about 1e-6
# relative a step; each leaf of params and ghat within TRAIN_RTOL of its
# largest magnitude
TRAIN_RTOL = 1e-4

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

# serving the dense bf16 configs at full width (phase serve_bf16): every
# layer of qwen3-4b and gemma3-12b at their published widths, with the JAX
# package's launch.serve weights, init_params(PRNGKey(0)) in bf16; the
# parameter counts are the JAX package's param_count. The runs are
# SERVE_RUNS' (gemma3's serve_long wraps its 1024-slot "S" rings).
SERVE_BF16_ARCHS = {"qwen3-4b": 4_022_468_096, "gemma3-12b": 8_934_264_576}
# The bf16 logits of the cuda and reference backends (prefill and every
# teacher-forced step) agree within SERVE_BF16_LOGIT_ULPS bf16 ulps of the
# run's largest |logit| (bf16_ulp). The backends share every GEMM (cuBLAS,
# f32 accumulation, one rounding); they part where B14 or B13 sums in
# another order than the plain version and an attention output rounds to
# the other bf16 neighbour, a flip that the later layers carry to the
# logits. tests/test_torch_serve_bf16.py measures that carry on the CPU at
# these depths (36 and 48 layers, d 256), attention summed in f64 against
# the plain f32 version: at most 3 ulps (the test's bound); this leaves
# about 2.7x that for the wider layers here. Argmax must agree wherever
# the reference's top-2 gap exceeds twice the tolerance.
SERVE_BF16_LOGIT_ULPS = 8


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


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
    emit({"phase": "bwd_bf16_sass", "hgmma": bwd_bf16_hgmma()})


# the bf16 flash backward's tensor-core kernels, by head-dim capacity
BWD_BF16_KERNELS = tuple(f"{k}<{d}>" for k in ("flash_bwd_dkv_kernel",
                                               "flash_bwd_dq_tc_kernel")
                         for d in (64, 128, 256))


def count_hgmma(sass: str) -> dict:
    """HGMMA instructions by bf16 backward kernel (``name<DMAX>``) in the
    text of ``cuobjdump --dump-sass``; other functions are not counted."""
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            found = re.search(r"(flash_bwd_(?:dkv|dq_tc)_kernel)ILi(\d+)E",
                              line)
            fn = f"{found.group(1)}<{found.group(2)}>" if found else None
            if fn:
                counts[fn] = 0
        elif fn and "HGMMA" in line:
            counts[fn] += 1
    return counts


def bwd_bf16_hgmma() -> dict:
    """The HGMMA (wgmma) instructions ``cuobjdump --dump-sass`` finds in
    each of the bf16 flash backward's dk/dv and dq kernels of the built
    ``flash_backward`` library; fails unless every one has some."""
    from repro_torch.kernels import build
    tool = Path(build.nvcc()).parent / "cuobjdump"
    counts = count_hgmma(subprocess.run(
        [str(tool), "--dump-sass", str(build.library_path("flash_backward"))],
        capture_output=True, text=True, check=True).stdout)
    check(sorted(counts) == sorted(BWD_BF16_KERNELS)
          and all(counts.values()),
          f"flash_backward's bf16 kernels without HGMMA: {counts}")
    return counts


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
                # the worker fold: sum_leading's bits (-0.0 columns too)
                for x in (g, h):
                    fw = fused_step.fold_workers(x)
                    plain = ref.fold_workers(x)
                    check(same_bits(fw, plain), f"fold_workers {tag}")
                    max_err["fold_workers"] = max(max_err["fold_workers"],
                                                  max_diff(fw, plain))
                    check(same_bits(fw, fused_step.fold_workers(x)),
                          f"fold_workers repeat {tag}")
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


def phase_staged_advance_paths(device,
                               dtypes=(torch.float32, torch.float64)) -> None:
    """B4's and B7b's 16-byte and element-wise paths on the
    BANK_PATH_CASES (both operands at the case's offset, and on the
    offset-1 cases also the second operand alone off alignment), inputs
    salted with -0.0, NaN and +-inf, all three masks: bit for bit against
    their plain versions (NaN where NaN), a repeat launch and the M=1
    calls of sample_workers. B7b takes the scales of the plain abs-max
    (1 for a NaN row, inf for an inf row)."""
    from repro_torch.core.quantize import int8_scale
    from repro_torch.kernels import censor, quantize_ef, ref
    cases = 0
    for dtype in dtypes:
        for m, n, off in BANK_PATH_CASES:
            gen = torch.Generator(device=device).manual_seed(
                m * 11 + n % 1013 + off)
            g, h, e = (_offset_leaf(m, n, 0, dtype, device, gen)
                       for _ in range(3))
            e.mul_(0.01)
            g[:, ::7] = -0.0
            h[:, ::5] = -0.0
            g[:, 3::11] = float("nan")
            h[:, 1::13] = float("inf")
            g[:, 2::17] = float("-inf")
            pend = (g - h) + e
            scale = int8_scale(ref.absmax_batched(pend))
            for offs in sorted({(off, off), (0, off)}):
                tag = f"paths {dtype} M={m} n={n} offsets={offs}"
                gg, hh = (_offset_copy(x, o) for x, o in zip((g, h), offs))
                pp, ee = (_offset_copy(x, o) for x, o in zip((pend, e), offs))
                for mname, mask in _masks(m, device).items():
                    mtag = f"{tag} mask={mname}"
                    out = censor.censor_bank_advance(gg, hh, mask)
                    check(same_or_nan(out, ref.censor_bank_advance(g, h, mask)),
                          f"B4 {mtag}")
                    check(same_bits(censor.censor_bank_advance(gg, hh, mask), out),
                          f"B4 {mtag}: repeat")
                    pay, err = quantize_ef.quantize_ef_batched(pp, ee, mask, scale)
                    pay_p, err_p = ref.quantize_ef_batched(pend, e, mask, scale)
                    check(same_or_nan(pay, pay_p) and same_or_nan(err, err_p),
                          f"B7b {mtag}")
                    again = quantize_ef.quantize_ef_batched(pp, ee, mask, scale)
                    check(same_bits(again[0], pay) and same_bits(again[1], err),
                          f"B7b {mtag}: repeat")
                    for w in sample_workers(m):
                        r = slice(w, w + 1)
                        check(same_or_nan(censor.censor_bank_advance(
                            gg[r], hh[r], mask[r]), out[r]), f"B4 {mtag}: M=1 {w}")
                        one = quantize_ef.quantize_ef_batched(pp[r], ee[r], mask[r],
                                                              scale[r])
                        check(same_or_nan(one[0], pay[r])
                              and same_or_nan(one[1], err[r]),
                              f"B7b {mtag}: M=1 {w}")
                    cases += 1
                del gg, hh, pp, ee
            del g, h, e, pend
    emit({"phase": "staged_advance_paths", "cases": cases,
          "kernels": ["censor_bank_advance", "quantize_ef_batched"],
          "rule": "bitwise, NaN where the plain version gives NaN; -0.0, "
          "NaN and inf salted; repeat and M=1 rows bitwise"})


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
    """B2, B6 and fold_workers on the fold_path_cases: the design their
    wrapper picks against the plain version (NaN where it gives NaN, the
    same bits elsewhere), the other design against the first, a repeat
    launch and (B2, B6) the M=1 calls of sample_workers, all three masks;
    fold_workers on B2's advanced bank, equal to B2's agg."""
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
                # the worker fold of the advanced bank: B2's agg
                fw = fused_step.fold_workers(out[0])
                check(same_or_nan(fw, ref.fold_workers(out[0])),
                      f"fold_workers {tag}")
                check(same_or_nan(fused_step.fold_on_card(out[0], other),
                                  fw), f"fold_workers {other} {tag}")
                check(same_bits(fused_step.fold_workers(out[0]), fw),
                      f"fold_workers repeat {tag}")
                check(same_or_nan(fw, out[1]), f"fold_workers != B2 agg {tag}")
                del fw
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
          "path_by_shape": paths, "kernels": ["fused_dense_step",
                                              "fused_int8_step",
                                              "fold_workers"],
          "rule": "the picked design against the plain version and the "
          "other design: NaN where it gives NaN, the same bits elsewhere "
          "(-0.0 included); repeat and M=1 slices bitwise; fold_workers "
          "of B2's ghat' equal to B2's agg"})


def tall_path_cases(sms: int) -> list:
    """(M, n) of the tall-bank cases of B10, B1, B8 and B5: M at 65 and
    66, a short tall bank, each side of ``common.sqnorm_path``'s worker
    threshold, phase kernels_large_m's M (past grid y's 65535 blocks) and
    the fed-mesh frontier, each with n in {1, 16, 33, 2049} (2049: a row
    of two reduction chunks, where B1, B8 and B5 run their two-pass design
    only)."""
    from repro_torch.kernels.common import warp_rows_min_workers
    t = warp_rows_min_workers(sms)
    return [(m, n) for m in sorted({65, 66, 300, t, t + 1, LARGE_M, MANY_M})
            for n in (1, 16, 33, 2049)]


def _within_or_nan(got, plain) -> bool:
    """NaN exactly where the plain version gives NaN, within SQNORM_RTOL
    elsewhere."""
    nan = torch.isnan(plain)
    return torch.equal(torch.isnan(got), nan) and torch.allclose(
        got[~nan], plain[~nan], rtol=SQNORM_RTOL, atol=0)


def _tall_sums(g, h, e, designs, m, tag) -> None:
    """B1, B8 and B5 on one tall case: each by the design its wrapper
    picks against its plain version (the sums within SQNORM_RTOL, B5's
    abs-max exact; NaN where NaN) and a repeat launch bitwise; each
    design in ``designs`` against the picked one and its M=1 calls of
    sample_workers, B1 against B8 on g - ghat and B5 against B8 and B7a
    on pending = (g - ghat) + e, NaN where NaN and bitwise elsewhere."""
    from repro_torch.kernels import censor, fused_step, quantize_ef, ref
    x, pend = g - h, (g - h) + e
    b1 = censor.censor_delta_sqnorm_batched(g, h)
    b8 = censor.sqnorm_batched(x)
    sq, am = fused_step.int8_stats_batched(g, h, e)
    sq_p, am_p = ref.int8_stats_batched(g, h, e)
    check(_within_or_nan(b1, ref.censor_delta_sqnorm_batched(g, h)),
          f"B1 {tag} against the plain version")
    check(_within_or_nan(b8, ref.sqnorm_batched(x)),
          f"B8 {tag} against the plain version")
    check(_within_or_nan(sq, sq_p) and same_or_nan(am, am_p),
          f"B5 {tag} against the plain version")
    sq2, am2 = fused_step.int8_stats_batched(g, h, e)
    check(same_bits(censor.censor_delta_sqnorm_batched(g, h), b1)
          and same_bits(censor.sqnorm_batched(x), b8)
          and same_bits(sq2, sq) and same_bits(am2, am), f"repeat {tag}")
    b8p = censor.sqnorm_batched(pend)
    b7a = quantize_ef.absmax_batched(pend)
    for design in designs:
        d1 = censor.delta_sqnorm_on_card(g, h, design)
        d8 = censor.sqnorm_on_card(x, design)
        s, a = fused_step.int8_stats_on_card(g, h, e, design)
        check(same_or_nan(d1, b1) and same_or_nan(d1, b8),
              f"B1 {design} {tag}")
        check(same_or_nan(d8, b8) and same_or_nan(d8, b1),
              f"B8 {design} {tag}")
        check(same_or_nan(s, sq) and same_or_nan(a, am), f"B5 {design} {tag}")
        check(same_or_nan(s, b8p) and same_or_nan(a, b7a),
              f"B5 {design} against B8 and B7a on pending {tag}")
        for w in sample_workers(m):
            r = slice(w, w + 1)
            one = (censor.delta_sqnorm_on_card(g[r], h[r], design),
                   censor.sqnorm_on_card(x[r], design),
                   *fused_step.int8_stats_on_card(g[r], h[r], e[r], design))
            for got, want, what in zip(one, (b1, b8, sq, am),
                                       ("B1", "B8", "B5 sq", "B5 am")):
                check(same_or_nan(got, want[r]),
                      f"{what} {design} M=1 slice {w} {tag}")


def _offset_copy(x: torch.Tensor, off: int) -> torch.Tensor:
    """A copy of ``x`` in a view starting ``off`` elements into its
    storage (off 1: every row off 16-byte alignment)."""
    flat = torch.empty(off + x.numel(), dtype=x.dtype, device=x.device)
    out = flat[off:].view(x.shape)
    out.copy_(x)
    return out


def _tall_b7a_b9(g, h, e, designs, m, tag) -> None:
    """B7a and B9 on one tall case, each on an aligned leaf and on a view
    one element off alignment (the 16-byte and the element-wise loads):
    B7a by the design its wrapper picks against its plain version and
    B5's abs-max of the same pending, each design in ``designs`` against
    the picked one and its M=1 calls of sample_workers; B9 under all three
    masks against its plain version and its M=1 calls of sample_workers;
    both a repeat launch bitwise, the rest NaN where NaN and bitwise
    elsewhere (-0.0 included)."""
    from repro_torch.kernels import censor, fused_step, quantize_ef, ref
    pend = (g - h) + e
    am5 = fused_step.int8_stats_batched(g, h, e)[1]
    plain = ref.absmax_batched(pend)
    for off in (0, 1):
        otag = f"{tag} offset={off}"
        x = _offset_copy(pend, off)
        am = quantize_ef.absmax_batched(x)
        check(same_or_nan(am, plain), f"B7a {otag} against the plain version")
        check(same_or_nan(am, am5), f"B7a {otag} against B5's abs-max")
        check(same_bits(quantize_ef.absmax_batched(x), am), f"B7a repeat {otag}")
        for design in designs:
            check(same_or_nan(quantize_ef.absmax_on_card(x, design), am),
                  f"B7a {design} {otag}")
            for w in sample_workers(m):
                check(same_or_nan(quantize_ef.absmax_on_card(x[w:w + 1], design),
                                  am[w:w + 1]), f"B7a {design} M=1 slice {w} {otag}")
        del x
        hh, qq = _offset_copy(h, off), _offset_copy(g, off)
        for mname, mask in _masks(m, h.device).items():
            mtag = f"{otag} mask={mname}"
            out = censor.bank_advance(hh, qq, mask)
            check(same_or_nan(out, ref.bank_advance(h, g, mask)),
                  f"B9 {mtag} against the plain version")
            check(same_bits(censor.bank_advance(hh, qq, mask), out), f"B9 repeat {mtag}")
            for w in sample_workers(m):
                r = slice(w, w + 1)
                check(same_or_nan(censor.bank_advance(hh[r], qq[r], mask[r]), out[r]),
                      f"B9 M=1 slice {w} {mtag}")
            del out
        del hh, qq


def _tall_b4_b7b(g, h, e, m, tag) -> None:
    """B4 and B7b on one tall case, under all three masks, with both
    operands aligned, both a view one element off alignment, and the
    second alone off it (the 16-byte and the element-wise paths): each
    against its plain version, B4 against B2's ghat' and B7b's err'
    against B6's (the scales of the plain abs-max), a repeat launch
    bitwise, and the M=1 calls of sample_workers; NaN where NaN and
    bitwise elsewhere (-0.0 included)."""
    from repro_torch.core.quantize import int8_scale
    from repro_torch.kernels import censor, fused_step, quantize_ef, ref
    pend = (g - h) + e
    scale = int8_scale(ref.absmax_batched(pend))
    t = torch.zeros(g.shape[1], dtype=g.dtype, device=g.device)
    for mname, mask in _masks(m, g.device).items():
        b2 = fused_step.fused_dense_step(g, h, t, t, mask, 0.1, 0.4)[0]
        b6 = fused_step.fused_int8_step(g, h, e, t, t, mask, scale, 0.1,
                                        0.4)[1]
        b4_p = ref.censor_bank_advance(g, h, mask)
        pay_p, err_p = ref.quantize_ef_batched(pend, e, mask, scale)
        for offs in ((0, 0), (1, 1), (0, 1)):
            otag = f"{tag} offsets={offs} mask={mname}"
            gg, hh = (_offset_copy(x, o) for x, o in zip((g, h), offs))
            out = censor.censor_bank_advance(gg, hh, mask)
            check(same_or_nan(out, b4_p), f"B4 {otag} against the plain version")
            check(same_or_nan(out, b2), f"B4 {otag} against B2's ghat'")
            check(same_bits(censor.censor_bank_advance(gg, hh, mask), out),
                  f"B4 repeat {otag}")
            for w in sample_workers(m):
                r = slice(w, w + 1)
                check(same_or_nan(censor.censor_bank_advance(gg[r], hh[r], mask[r]),
                                  out[r]), f"B4 M=1 slice {w} {otag}")
            del gg, hh, out
            pp, ee = (_offset_copy(x, o) for x, o in zip((pend, e), offs))
            pay, err = quantize_ef.quantize_ef_batched(pp, ee, mask, scale)
            check(same_or_nan(pay, pay_p) and same_or_nan(err, err_p),
                  f"B7b {otag} against the plain version")
            check(same_or_nan(err, b6), f"B7b {otag}: err' against B6's")
            again = quantize_ef.quantize_ef_batched(pp, ee, mask, scale)
            check(same_bits(again[0], pay) and same_bits(again[1], err),
                  f"B7b repeat {otag}")
            for w in sample_workers(m):
                r = slice(w, w + 1)
                one = quantize_ef.quantize_ef_batched(pp[r], ee[r], mask[r], scale[r])
                check(same_or_nan(one[0], pay[r]) and same_or_nan(one[1], err[r]),
                      f"B7b M=1 slice {w} {otag}")
            del pp, ee, pay, err, again
        del b2, b6, b4_p, pay_p, err_p


def phase_tall_paths(device, dtypes=(torch.float32, torch.float64)) -> None:
    """B10, B1, B8, B5, B7a and B9 on the tall_path_cases, inputs salted
    with -0.0 (column 0 all -0.0; a kept and a dropped -0.0 in every 7th
    column), NaN and +-inf. B10 under all three masks: bitwise (NaN where
    NaN) against the plain version, a repeat launch bitwise, and the M=1
    row calls of sample_workers against the batched call under the
    all-ones mask. B1, B8 and B5 on both designs where both run (n <=
    2048), as _tall_sums says; B7a on both designs there and B9 on its
    one, on aligned and misaligned views, as _tall_b7a_b9 says; B4 and B7b
    on their one design, as _tall_b4_b7b says."""
    from repro_torch.kernels import censor, common, ref, topk_pack
    from repro_torch.kernels.build import REDUCE_CHUNK
    sms = common.sm_count(device.index or 0)
    cases, sum_cases, paths = 0, 0, {}
    for dtype in dtypes:
        for m, n in tall_path_cases(sms):
            g, h, e, _, _ = _fold_inputs(m, n, dtype, device, 3 * m + n)
            keep = _keep(g, m + n)
            paths[f"M={m} n={n}"] = common.sqnorm_path(m, n, sms)
            tag = f"{dtype} M={m} n={n} ({paths[f'M={m} n={n}']})"
            designs = censor.SQNORM_PATHS if n <= REDUCE_CHUNK else ("two_pass",)
            _tall_sums(g, h, e, designs, m, tag)
            _tall_b7a_b9(g, h, e, designs, m, tag)
            _tall_b4_b7b(g, h, e, m, tag)
            sum_cases += 1
            torch.cuda.empty_cache()
            for mname, mask in _masks(m, device).items():
                mtag = f"{tag} mask={mname}"
                got = topk_pack.select_pack_ef_batched(g, e, keep, mask)
                plain = ref.select_pack_ef_batched(g, e, keep, mask)
                again = topk_pack.select_pack_ef_batched(g, e, keep, mask)
                for a, b, c, what in zip(got, plain, again,
                                         ("payload", "err'")):
                    check(same_or_nan(a, b), f"B10 {what} {mtag}")
                    check(same_bits(c, a), f"B10 {what} repeat {mtag}")
                if mname == "ones":
                    for w in sample_workers(m):
                        row = topk_pack.select_pack_ef_row(g[w], e[w],
                                                           keep[w])
                        check(same_or_nan(row[0], got[0][w])
                              and same_or_nan(row[1], got[1][w]),
                              f"B10 M=1 row {w} {mtag}")
                del got, plain, again
                cases += 1
            del g, h, e, keep
            torch.cuda.empty_cache()
    emit({"phase": "tall_paths", "cases": cases, "sum_cases": sum_cases,
          "sms": sms,
          "sqnorm_path_by_shape": paths,
          "kernels": ["select_pack_ef_batched", "censor_delta_sqnorm_batched",
                      "sqnorm_batched", "int8_stats_batched",
                      "absmax_batched", "bank_advance",
                      "censor_bank_advance", "quantize_ef_batched"],
          "rule": "B10, B9, B4 and B7b against the plain version NaN where it "
          "gives NaN, the same bits elsewhere (-0.0 included), repeat and "
          "M=1 rows bitwise; the two designs of B1, B8, B5 and B7a against "
          "each other and their M=1 calls, B1 against B8 on g - ghat, B5 "
          "against B8 and B7a on pending, NaN where NaN and bitwise "
          "elsewhere; each against its plain version within SQNORM_RTOL "
          "(B5's and B7a's abs-max exact), NaN where NaN; B7a, B9, B4 and "
          "B7b also on views one element off alignment; B4 equal to B2's "
          "ghat', B7b's err' to B6's"})


# ------------------------------------------------- phase fused_bf16_banks
#: (params P, bank H, err E) of the sub-f32 launchers of B1, B2, B5 and B6
#: (B1 and B2 take no err): all bf16, f32 on a bf16 bank, and that with
#: the f32 err transport.init makes
BF16_COMBOS = [(torch.bfloat16, torch.bfloat16, torch.bfloat16),
               (torch.float32, torch.bfloat16, torch.bfloat16),
               (torch.float32, torch.bfloat16, torch.float32)]
#: (M, n, off): M in {1, 4, 9, 70,000}, odd n (a row of 2049 is two
#: reduction chunks: no warp design there), views one element off
BF16_CASES = [(m, n, off) for m in (1, 4, 9) for n in (1, 33, 2049)
              for off in (0, 1)] + [(4, 128 * 257 + 3, 0), (LARGE_M, 33, 0),
                                    (LARGE_M, 33, 1), (LARGE_M, 2049, 0)]


def _bf16_inputs(m, n, combo, off, device, seed):
    """B2/B6's salted operands (``_fold_inputs``: -0.0 columns, NaN and
    +-inf) with g, theta, theta_prev in P, ghat in H and err in E, each
    ``off`` elements into its storage; rows past the first salted with NaN
    and -inf in g, +inf in ghat."""
    p_dt, h_dt, e_dt = combo
    g, h, e, t, p = _fold_inputs(m, n, torch.float32, device, seed)
    if m > 2 and n > 3:
        g[1, 2], g[2, 3], h[1, 3] = float("nan"), float("-inf"), float("inf")
    return (_offset_copy(g.to(p_dt), off), _offset_copy(h.to(h_dt), off),
            _offset_copy(e.to(e_dt), off), _offset_copy(t.to(p_dt), off),
            _offset_copy(p.to(p_dt), off))


def phase_fused_bf16_banks(device) -> None:
    """The sub-f32 launchers of B1, B2, B5 and B6 (BF16_COMBOS) on
    BF16_CASES, both designs of each, against their plain versions on the
    card: B2's and B6's outputs and B5's abs-max NaN where the plain
    version gives NaN and the same bits elsewhere (-0.0 included), the
    sums of B1 and B5 within SQNORM_RTOL; the designs against each other,
    a repeat launch and the M=1 calls of sample_workers bitwise, every
    mask."""
    from repro_torch.core.quantize import int8_scale
    from repro_torch.kernels import censor, common, fused_step, ref
    sms = common.sm_count(device.index or 0)
    alpha, beta = 0.0123, 0.4
    cases, err, names = 0, {}, set()
    for combo in BF16_COMBOS:
        pair = common.FUSED_DTYPES[combo[:2]]     # B1's and B2's suffix
        suffix = pair + ("" if combo[2] == combo[1] else "_f32")
        for m, n, off in BF16_CASES:
            g, h, e, t, p = _bf16_inputs(m, n, combo, off, device, m + n)
            tag = f"{suffix} M={m} n={n} off={off}"
            sq_designs = ("two_pass", "warp") if n <= 2048 else ("two_pass",)
            # B1 and B5: both designs, the plain version, M=1 slices
            b1_p = ref.censor_delta_sqnorm_batched(g, h)
            sq_p, am_p = ref.int8_stats_batched(g, h, e)
            first = None
            for design in sq_designs:
                b1 = censor.delta_sqnorm_on_card(g, h, design)
                sq, am = fused_step.int8_stats_on_card(g, h, e, design)
                check(_within_or_nan(b1, b1_p), f"B1 {design} {tag}")
                check(_within_or_nan(sq, sq_p) and same_or_nan(am, am_p),
                      f"B5 {design} {tag}")
                check(am.dtype == h.dtype, f"B5 amax dtype {tag}")
                if first is None:
                    first = (b1, sq, am)
                check(all(same_or_nan(a, b) for a, b in
                          zip((b1, sq, am), first)),
                      f"B1/B5 {design} against two_pass {tag}")
                again = (censor.delta_sqnorm_on_card(g, h, design),
                         *fused_step.int8_stats_on_card(g, h, e, design))
                check(all(same_bits(a, b) for a, b in zip(again,
                                                          (b1, sq, am))),
                      f"B1/B5 {design} repeat {tag}")
                for w in sample_workers(m):
                    r = slice(w, w + 1)
                    one = (censor.delta_sqnorm_on_card(g[r], h[r], design),
                           *fused_step.int8_stats_on_card(g[r], h[r], e[r],
                                                          design))
                    check(all(same_or_nan(a, b[r]) for a, b in
                              zip(one, (b1, sq, am))),
                          f"B1/B5 {design} M=1 slice {w} {tag}")
                for name, got, plain, suf in (
                        ("censor_delta_sqnorm_batched", b1, b1_p, pair),
                        ("int8_stats_batched", sq, sq_p, suffix)):
                    key = f"{name}{'_warp' if design == 'warp' else ''}_{suf}"
                    names.add(key)
                    fin = torch.isfinite(plain)
                    if fin.any():
                        err[key] = max(err.get(key, 0.0),
                                       _rel_err(got[fin], plain[fin]))
            scale = int8_scale(first[2])
            del first, b1, sq, am, again, b1_p, sq_p, am_p
            masks = _masks(m, device)
            if m == LARGE_M:   # the plain fold is 70,000 eager adds a call
                masks = {"mixed": masks["mixed"]}
            for mname, mask in masks.items():
                mtag = f"{tag} mask={mname}"
                outs = {}
                for path in fused_step.FOLD_PATHS:
                    if combo[2] == combo[1]:
                        outs["B2", path] = fused_step.dense_on_card(
                            g, h, t, p, mask, alpha, beta, path)
                        names.add(fused_step._launcher(
                            "fused_dense_step", path, suffix=pair))
                    outs["B6", path] = fused_step.int8_on_card(
                        g, h, e, t, p, mask, scale, alpha, beta, path)
                    names.add(fused_step._launcher("fused_int8_step", path,
                                                   suffix=suffix))
                plain = {"B2": ref.fused_dense_step(g, h, t, p, mask, alpha,
                                                    beta),
                         "B6": ref.fused_int8_step(g, h, e, t, p, mask,
                                                   scale, alpha, beta)}
                for (kern, path), out in outs.items():
                    dts = [x.dtype for x in out]
                    want = ([h.dtype, h.dtype, t.dtype] if kern == "B2"
                            else [h.dtype, h.dtype, h.dtype, t.dtype])
                    check(dts == want, f"{kern} {path} dtypes {dts} {mtag}")
                    check(all(same_or_nan(a, b) for a, b in
                              zip(out, plain[kern])),
                          f"{kern} {path} against the plain version {mtag}")
                    if kern == "B2" and mname == "zeros" and n > 1:
                        check(bool((bits(out[1][1:2]) == bits(torch.tensor(
                            [-0.0], dtype=h.dtype, device=device))).all()),
                              f"B2 {path} -0.0 column's agg {mtag}")
                for kern in ("B2", "B6"):
                    if (kern, "one_pass") not in outs:
                        continue
                    again = (fused_step.dense_on_card(g, h, t, p, mask, alpha,
                                                      beta, "one_pass")
                             if kern == "B2" else fused_step.int8_on_card(
                                 g, h, e, t, p, mask, scale, alpha, beta,
                                 "one_pass"))
                    check(all(same_bits(a, b) for a, b in
                              zip(again, outs[kern, "one_pass"])),
                          f"{kern} repeat {mtag}")
                    check(all(same_or_nan(a, b) for a, b in
                              zip(outs[kern, "tall"],
                                  outs[kern, "one_pass"])),
                          f"{kern} tall against one_pass {mtag}")
                for w in sample_workers(m):
                    r = slice(w, w + 1)
                    for path in fused_step.FOLD_PATHS:
                        one = fused_step.int8_on_card(
                            g[r], h[r], e[r], t, p, mask[r], scale[r], alpha,
                            beta, path)
                        full = outs["B6", path]
                        check(same_or_nan(one[0], full[0][r])
                              and same_or_nan(one[1], full[1][r]),
                              f"B6 {path} M=1 slice {w} {mtag}")
                        if ("B2", path) in outs:
                            one = fused_step.dense_on_card(
                                g[r], h[r], t, p, mask[r], alpha, beta, path)
                            check(same_or_nan(one[0], outs["B2", path][0][r]),
                                  f"B2 {path} M=1 slice {w} {mtag}")
                del outs, plain
                cases += 1
            del g, h, e, t, p
            torch.cuda.empty_cache()
    check(len(names) == 20, f"{len(names)} sub-f32 launchers checked")
    emit({"phase": "fused_bf16_banks", "cases": cases, "sms": sms,
          "combos": [[str(d) for d in c] for c in BF16_COMBOS],
          "launchers": sorted(names),
          "max_rel_err_sqnorm": err,
          "rule": "B2, B6 (both designs) and B5's abs-max against the "
          "plain version NaN where it gives NaN, the same bits elsewhere "
          "(-0.0 included); B1's and B5's sums within SQNORM_RTOL; the "
          "designs against each other, repeats and M=1 slices bitwise"})


# ------------------------------------------------ phase staged_bf16_banks
#: (operand P, bank H) of the sub-f32 launchers of B3, B4 and B9 (B8 and
#: the fold take the bf16 pending leaf or bank of either)
STAGED_BF16_PAIRS = [(torch.bfloat16, torch.bfloat16),
                     (torch.float32, torch.bfloat16)]
#: BF16_CASES and rows of a multiple of 8 elements (B4's and B9's 16-byte
#: tiles where aligned, elements one element off)
STAGED_BF16_CASES = BF16_CASES + [(m, n, off) for m in (4, 9)
                                  for n in (16, 2048) for off in (0, 1)] \
    + [(LARGE_M, 16, 0), (LARGE_M, 16, 1)]


def phase_staged_bf16_banks(device) -> None:
    """The sub-f32 launchers of B3, B4, B8, B9 and the worker fold on
    STAGED_BF16_CASES, each design, against their plain versions on the
    card: B3, B4, B9 and the fold NaN where the plain version gives NaN and
    the same bits elsewhere (-0.0 included), B8 within SQNORM_RTOL; the
    designs against each other, repeats and the M=1 calls of
    sample_workers bitwise; B3 on the fold's sum."""
    from repro_torch.kernels import censor, common, fused_step, hb_update, ref
    t0 = time.perf_counter()
    alpha, beta = 0.0123, 0.4
    cases, err, names = 0, {}, set()
    for m, n, off in STAGED_BF16_CASES:
        tag = f"M={m} n={n} off={off}"
        # B8 and the fold: one bf16 leaf of the case
        g, h, _, t, p = _bf16_inputs(m, n, (torch.bfloat16,) * 3, off,
                                     device, m + n + 1)
        x = _offset_copy(g - h, off)
        sq_p = ref.sqnorm_batched(x)
        sq_designs = censor.SQNORM_PATHS if n <= 2048 else ("two_pass",)
        first = None
        for design in sq_designs:
            sq = censor.sqnorm_on_card(x, design)
            check(sq.dtype == torch.float32 and _within_or_nan(sq, sq_p),
                  f"B8 bf16 {design} against the plain version {tag}")
            first = sq if first is None else first
            check(same_or_nan(sq, first), f"B8 bf16 {design} against "
                  f"two_pass {tag}")
            check(same_bits(censor.sqnorm_on_card(x, design), sq),
                  f"B8 bf16 {design} repeat {tag}")
            for w in sample_workers(m):
                check(same_or_nan(censor.sqnorm_on_card(x[w:w + 1], design),
                                  sq[w:w + 1]),
                      f"B8 bf16 {design} M=1 slice {w} {tag}")
            key = f"sqnorm_batched{'_warp' if design == 'warp' else ''}_bf16"
            names.add(key)
            fin = torch.isfinite(sq_p)
            if fin.any():
                err[key] = max(err.get(key, 0.0),
                               _rel_err(sq[fin], sq_p[fin]))
        fold_p = ref.fold_workers(h)
        folds = {}
        for design in fused_step.FOLD_PATHS:
            folds[design] = fused_step.fold_on_card(h, design)
            check(folds[design].dtype == torch.bfloat16
                  and same_or_nan(folds[design], fold_p),
                  f"fold bf16 {design} against the plain version {tag}")
            check(same_bits(fused_step.fold_on_card(h, design),
                            folds[design]), f"fold bf16 {design} repeat {tag}")
            names.add(fused_step._launcher("fold_workers", design,
                                           torch.bfloat16))
        del x, sq_p, first, sq, fold_p
        # B4, B9 and B3 on each (operand, bank) pair
        for p_dt, h_dt in STAGED_BF16_PAIRS:
            suffix = common.FUSED_DTYPES[(p_dt, h_dt)]
            g, h, _, t, p = _bf16_inputs(m, n, (p_dt, h_dt, h_dt), off,
                                         device, m + n)
            agg = folds["tall"]
            b3 = hb_update.hb_update(t, agg, p, alpha, beta)
            check(b3.dtype == p_dt and same_or_nan(
                b3, ref.hb_update(t, agg, p, alpha, beta)),
                  f"B3 {suffix} against the plain version {tag}")
            check(same_bits(hb_update.hb_update(t, agg, p, alpha, beta), b3),
                  f"B3 {suffix} repeat {tag}")
            names.add(f"hb_update_{suffix}")
            masks = _masks(m, device)
            for mname, mask in masks.items():
                mtag = f"{suffix} {tag} mask={mname}"
                for label, fn, plain, ops in (
                        ("B4", censor.censor_bank_advance,
                         ref.censor_bank_advance, (g, h)),
                        ("B9", censor.bank_advance, ref.bank_advance,
                         (h, g))):
                    out = fn(*ops, mask)
                    check(out.dtype == h_dt and same_or_nan(
                        out, plain(*ops, mask)),
                          f"{label} against the plain version {mtag}")
                    check(same_bits(fn(*ops, mask), out),
                          f"{label} repeat {mtag}")
                    for w in sample_workers(m):
                        r = slice(w, w + 1)
                        check(same_or_nan(fn(*(o[r] for o in ops), mask[r]),
                                          out[r]),
                              f"{label} M=1 slice {w} {mtag}")
                    del out
                cases += 1
            names.update({f"censor_bank_advance_{suffix}",
                          f"bank_advance_{suffix}"})
            del g, h, t, p, b3
        del folds
        torch.cuda.empty_cache()
    check(len(names) == 10, f"{len(names)} staged sub-f32 launchers checked")
    emit({"phase": "staged_bf16_banks", "cases": cases,
          "shapes": len(STAGED_BF16_CASES),
          "pairs": [[str(d) for d in c] for c in STAGED_BF16_PAIRS],
          "launchers": sorted(names), "max_rel_err_sqnorm": err,
          "rule": "B3, B4, B9 and the fold (both designs) against the plain "
          "version NaN where it gives NaN, the same bits elsewhere (-0.0 "
          "included); B8 within SQNORM_RTOL; the designs against each "
          "other, repeats and M=1 slices bitwise",
          "seconds": time.perf_counter() - t0})


# --------------------------------------------- phase stateful_bf16_banks
#: STAGED_BF16_CASES and the fed mesh's frontier (M = 10^5 rows of 16),
#: where run_mesh runs int8 on a bf16 bank
STATEFUL_BF16_CASES = STAGED_BF16_CASES + [(MANY_M, MANY_D, 0),
                                           (MANY_M, MANY_D, 1)]
#: err dtypes of B7b, B10 and B11 on a bf16 pending leaf, and B11's
#: payload dtypes
STATEFUL_ERRS = (torch.bfloat16, torch.float32)


def phase_stateful_bf16_banks(device) -> None:
    """The bf16 launchers of B7a, B7b, B10 and B11 on STATEFUL_BF16_CASES
    against their plain versions on the card: NaN where the plain version
    gives NaN and the same bits elsewhere (-0.0 included); B7a's two
    designs against each other and B5's abs-max, B7b's err' against B6's
    on B6's pending; repeats and the M=1 calls of sample_workers bitwise
    (fed/runner.py's row entries run the batched kernels at M = 1), every
    mask."""
    from repro_torch.core.quantize import int8_scale
    from repro_torch.kernels import (common, fused_step, lowrank_ef,
                                     quantize_ef, ref, topk_pack)
    t0 = time.perf_counter()
    bf16 = torch.bfloat16
    cases, names = 0, set()
    for m, n, off in STATEFUL_BF16_CASES:
        tag = f"M={m} n={n} off={off}"
        # g in f32 (B6's params), ghat, err in f32, theta: B6's operands;
        # the bf16 pending leaf is B6's (g - ghat) + err
        g, h, e32, t, tp = _bf16_inputs(
            m, n, (torch.float32, bf16, torch.float32), off, device, m + n + 2)
        pend = _offset_copy((g.to(bf16) - h) + e32.to(bf16), off)
        # B7a: each design, against the plain version, B5's abs-max and
        # the other design
        am_p = ref.absmax_batched(pend)
        designs = ("two_pass", "warp") if n <= 2048 else ("two_pass",)
        first = None
        for design in designs:
            am = quantize_ef.absmax_on_card(pend, design)
            check(am.dtype == bf16 and same_or_nan(am, am_p),
                  f"B7a bf16 {design} against the plain version {tag}")
            first = am if first is None else first
            check(same_or_nan(am, first), f"B7a bf16 {design} against "
                  f"two_pass {tag}")
            check(same_bits(quantize_ef.absmax_on_card(pend, design), am),
                  f"B7a bf16 {design} repeat {tag}")
            for w in sample_workers(m):
                check(same_or_nan(quantize_ef.absmax_on_card(
                    pend[w:w + 1], design), am[w:w + 1]),
                      f"B7a bf16 {design} M=1 slice {w} {tag}")
            names.add(f"absmax_batched{'_warp' if design == 'warp' else ''}"
                      "_bf16")
        if m < LARGE_M:
            sq_am = fused_step.int8_stats_batched(g, h, e32)[1]
            check(same_or_nan(first, sq_am), f"B7a bf16 against B5's "
                  f"abs-max {tag}")
        scale = int8_scale(am_p)
        keep = _offset_copy(_keep(pend, m + n), off)
        q32 = _offset_copy(pend.float() + 0.01 * torch.randn(
            pend.shape, generator=torch.Generator(device=device).manual_seed(
                m + n), device=device), off)
        del first, am_p, am
        for e_dt in STATEFUL_ERRS:
            e = _offset_copy(e32.to(e_dt), off)
            ef = "" if e_dt == bf16 else "_f32"
            qs = {q_dt: _offset_copy(q32.to(q_dt), off)
                  for q_dt in STATEFUL_ERRS}
            for mname, mask in _masks(m, device).items():
                mtag = f"err {e_dt} {tag} mask={mname}"
                # label: (the kernel on rows r, its plain version, launcher)
                calls = {
                    "B7b": (lambda r: quantize_ef.quantize_ef_batched(
                        pend[r], e[r], mask[r], scale[r]),
                        ref.quantize_ef_batched(pend, e, mask, scale),
                        f"quantize_ef_batched_bf16{ef}"),
                    "B10": (lambda r: topk_pack.select_pack_ef_batched(
                        pend[r], e[r], keep[r], mask[r]),
                        ref.select_pack_ef_batched(pend, e, keep, mask),
                        f"select_pack_ef_batched_bf16{ef}")}
                for q_dt, q in qs.items():
                    suffix = common.EF_DTYPES["residual_ef_batched"][
                        (bf16, q_dt, e_dt)]
                    calls[f"B11 payload {q_dt}"] = (
                        lambda r, q=q: (lowrank_ef.residual_ef_batched(
                            pend[r], q[r], e[r], mask[r]),),
                        (ref.residual_ef_batched(pend, q, e, mask),),
                        f"residual_ef_batched_{suffix}")
                every = slice(None)
                for label, (fn, want, launcher) in calls.items():
                    out = fn(every)
                    check(all(a.dtype == bf16 and same_or_nan(a, b)
                              for a, b in zip(out, want)),
                          f"{label} against the plain version {mtag}")
                    check(all(same_bits(a, b) for a, b in zip(fn(every),
                                                              out)),
                          f"{label} repeat {mtag}")
                    for w in sample_workers(m):
                        r = slice(w, w + 1)
                        check(all(same_or_nan(a, b[r])
                                  for a, b in zip(fn(r), out)),
                              f"{label} M=1 slice {w} {mtag}")
                    names.add(launcher)
                    del out
                del calls
                if m < LARGE_M:
                    # B6 on g, ghat and err (bf16 err: bf16 params)
                    gg = g if e_dt == torch.float32 else g.to(bf16)
                    tt = t if e_dt == torch.float32 else t.to(bf16)
                    b6 = fused_step.fused_int8_step(gg, h, e, tt, tt, mask,
                                                    scale, 0.1, 0.4)[1]
                    check(same_or_nan(quantize_ef.quantize_ef_batched(
                        pend, e, mask, scale)[1], b6),
                          f"B7b err' against B6's {mtag}")
                cases += 1
            del e, qs
        del g, h, e32, t, tp, pend, keep, q32, scale
        torch.cuda.empty_cache()
    check(len(names) == 10, f"{len(names)} stateful bf16 launchers checked")
    emit({"phase": "stateful_bf16_banks", "cases": cases,
          "shapes": len(STATEFUL_BF16_CASES),
          "launchers": sorted(names),
          "rule": "B7a (both designs), B7b, B10 and B11 against the plain "
          "version NaN where it gives NaN, the same bits elsewhere (-0.0 "
          "included); B7a against B5's abs-max, B7b's err' against B6's; "
          "the designs against each other, repeats and M=1 slices bitwise",
          "seconds": time.perf_counter() - t0})


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


def _lse_f64(q, k, causal, window):
    """B14's log-sum-exp in f64: logsumexp of each row's masked, scaled
    scores (-1e30 where masked)."""
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
    return torch.logsumexp(torch.where(m, s, -1e30), dim=-1).reshape(b, h, lq)


def flash_bwd_f64(q, k, v, do, causal, window, o=None):
    """The flash backward's function (``repro/models/flash.py``'s custom
    VJP) in f64: (dq, dk, dv). The probabilities are exp(s - lse), so a row
    with no valid key has p = 1 on every key, as in flash.py. ``o``, where
    given, is the forward output the backward reads in D = sum dO o (the
    custom VJP's residual: in bf16, B14's rounded output); else the exact
    one."""
    b, h, lq, d = q.shape
    kh, s_len = k.shape[1], k.shape[2]
    g, scale = h // kh, d ** -0.5
    q5 = q.double().reshape(b, kh, g, lq, d)
    do5 = do.double().reshape(b, kh, g, lq, d)
    k64, v64 = k.double(), v.double()
    s = torch.einsum("bkgqd,bksd->bkgqs", q5, k64) * scale
    qpos = torch.arange(lq, device=q.device)[:, None]
    kpos = torch.arange(s_len, device=q.device)[None, :]
    m = torch.ones((lq, s_len), dtype=torch.bool, device=q.device)
    if causal:
        m = m & (kpos <= qpos)
    if window is not None:
        m = m & (kpos > qpos - window)
    s = torch.where(m, s, -1e30)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bkgqd,bksd->bkgqs", do5, v64)
    if o is None:
        o = torch.einsum("bkgqs,bksd->bkgqd", torch.softmax(s, dim=-1), v64)
    else:
        o = o.double().reshape(b, kh, g, lq, d)
    ds = p * (dp - torch.sum(do5 * o, dim=-1)[..., None])
    dq = scale * torch.einsum("bkgqs,bksd->bkgqd", ds, k64)
    dk = scale * torch.einsum("bkgqs,bkgqd->bksd", ds, q5)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, do5)
    return dq.reshape(b, h, lq, d), dk, dv


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
    """The B13/B14 rule, on bf16 outputs row by row too; returns (kernel's
    error, plain version's error) over the whole tensor."""
    err_k = float((kernel.double() - exact).abs().max())
    err_p = float((plain.double() - exact).abs().max())
    check(math.isfinite(err_k) and err_k <= ATTN_FACTOR * err_p + ATTN_FLOOR,
          f"{tag}: kernel error {err_k} against the f64 version, the f32 "
          f"plain version's {err_p}")
    if kernel.dtype == torch.bfloat16:
        row_k = (kernel.double() - exact).abs().amax(-1).flatten()
        row_p = (plain.double() - exact).abs().amax(-1).flatten()
        excess = row_k - (ATTN_FACTOR * row_p + ATTN_FLOOR)
        i = int(torch.nan_to_num(excess, nan=math.inf).argmax())
        check(bool((excess <= 0).all()),
              f"{tag}: row {i} (of {row_k.numel()}): kernel error "
              f"{float(row_k[i])} against the f64 version, the plain "
              f"version's {float(row_p[i])} on that row (whole tensor: "
              f"{err_k} and {err_p})")
    return err_k, err_p


# (b, h, kh, lq, s, d, causal, window, dtype, offset): GQA 1/2/4/6, Lq and
# S off the 128-row query tile and the 64-key tile (Lq = S in {1, 127, 128,
# 129}), causal, windows (one whose band crosses the 128-row edge),
# non-causal rectangular, Lq > S with rows that have no valid key (they
# visit every tile and give the mean of v), head dims 32-256 (33: the
# element-wise loads; 80: zero-filled up to 128), bf16, operands one
# element off their storage's alignment (offset 1: the element-wise
# loads), and one batch row of serve_long's prefill: chb-paper-lm-124m's in
# f32, qwen3-4b's (GQA 32/8, d 128) and gemma3-12b's (16/8, d 256, causal
# and its "S" layers' window 1024) in bf16. Then the bf16 tensor-core
# design's edges (128-row blocks, 64-key tiles): L one short of, on and one
# past a tile (1, 63, 64, 65, 127, 129, 2047), d 72 (zero-filled to 128,
# 16-byte copies) and 256, G 8, a band of 65 keys across tile edges, rows
# with no valid key, a view off alignment at d 128
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
    (1, 32, 8, 2048, 2048, 128, True, None, torch.bfloat16, 0),
    (1, 16, 8, 2048, 2048, 256, True, None, torch.bfloat16, 0),
    (1, 16, 8, 2048, 2048, 256, True, 1024, torch.bfloat16, 0),
    *[(1, 8, 2, n, n, 128, True, None, torch.bfloat16, 0)
      for n in (1, 63, 64, 65, 127, 2047)],
    (2, 4, 2, 129, 129, 72, True, None, torch.bfloat16, 0),
    (1, 8, 1, 257, 257, 256, True, 65, torch.bfloat16, 0),
    (1, 4, 2, 150, 80, 64, True, 16, torch.bfloat16, 0),
    (2, 8, 4, 130, 130, 128, True, None, torch.bfloat16, 1),
]
# (b, h, kh, c, d, pos, dtype; pos None: every slot empty): C 1, 97 and
# 2081, pos 0, empty slots, wrapped rings, G 1/2/4/8/16 (two head groups),
# head dims 64-256, bf16, and serve_long's last decode step: chb-paper-lm-
# 124m's in f32, qwen3-4b's and gemma3-12b's in bf16 (gemma3's "S" ring of
# 1024 slots wrapped twice); then the bf16 design at C 1, 31 (one partial
# sub-tile) and 257 (a wrapped ring), two head groups, and on a strided
# cache (STRIDED_DECODE: the element loads)
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
    (8, 32, 8, 2081, 128, 2078, torch.bfloat16),
    (8, 16, 8, 2081, 256, 2078, torch.bfloat16),
    (8, 16, 8, 1024, 256, 2078, torch.bfloat16),
    (2, 8, 8, 1, 128, 0, torch.bfloat16),
    (3, 8, 4, 31, 128, 40, torch.bfloat16),
    (2, 8, 2, 257, 128, 300, torch.bfloat16),
    (1, 32, 2, 97, 64, 50, torch.bfloat16),
    (2, 8, 2, 257, 256, 120, torch.bfloat16),
]
STRIDED_DECODE = (2, 8, 2, 257, 256, 120, torch.bfloat16)
# the flash backward, f32 (b, h, kh, lq, s, d, causal, window, offset):
# GQA 1, 2 and 4; L on and off its 64-row tiles (64, 65, 127, 129, 200,
# 256), Lq < S, and Lq > S with rows that have no valid key (every tile
# visited); d 33 (element loads), 64, 80 (zero-filled to 128), 128 and 256;
# causal with and without a window, non-causal; operands one element off
# their storage's alignment (offset 1); training's (4, 12, 256, 64) and an
# L = 2048 case. Then the key-tile design's edges: L one short of and one
# past each tile (64 query rows and 32 keys at d <= 64, 32 x 32 above), G
# = 6, a window of 16 on 64-row tiles, rows with no valid key in a tile
# that also holds valid rows, d = 33 off alignment with a window
FLASH_BWD_CASES = [
    (2, 4, 4, 64, 64, 64, True, None, 0),
    (2, 4, 2, 65, 65, 64, True, None, 0),
    (1, 8, 2, 129, 129, 80, True, None, 0),
    (2, 4, 2, 200, 200, 33, True, None, 1),
    (1, 8, 2, 256, 256, 64, True, 48, 0),
    (1, 4, 4, 127, 127, 80, True, 30, 1),
    (1, 8, 4, 256, 256, 64, False, None, 0),
    (1, 4, 2, 100, 160, 80, False, 20, 0),
    (1, 4, 2, 300, 140, 64, True, 30, 0),
    (1, 4, 2, 100, 100, 128, True, None, 0),
    (1, 4, 4, 65, 65, 256, True, 16, 0),
    (4, 12, 12, 256, 256, 64, True, None, 0),
    (1, 12, 12, 2048, 2048, 64, True, None, 0),
    (1, 4, 2, 63, 63, 64, True, None, 0),
    (1, 4, 2, 129, 95, 64, True, None, 0),
    (1, 4, 4, 97, 97, 64, True, None, 0),
    (1, 4, 2, 31, 33, 64, False, None, 0),
    (1, 4, 2, 31, 31, 80, True, None, 0),
    (1, 4, 2, 33, 33, 128, True, None, 0),
    (1, 2, 2, 33, 31, 256, True, None, 0),
    (1, 12, 2, 100, 100, 64, True, None, 0),
    (1, 4, 2, 200, 200, 64, True, 16, 0),
    (1, 4, 2, 200, 200, 64, False, 16, 0),
    (1, 4, 2, 150, 100, 64, True, 20, 0),
    (1, 4, 2, 97, 97, 33, True, 16, 1),
]
# the flash backward in bf16 (flash_attention_bwd_bf16), the same tuples:
# first training's two shapes, one worker's chunk of each phase train_bf16
# run (qwen3-4b: 4 x 256 tokens, 32 query heads over 8 kv heads of 128,
# causal; gemma3-12b: 1 x 2048 tokens, 16 over 8 of 256, causal, and its
# "S" layers' window 1024); then the key-tile design's edges as the f32
# cases have them: L one short of and one past its 64-row and 32-key tiles,
# G 1, 4 and 6, a window of 16 on 64-row tiles, rows with no valid key in a
# tile that also holds valid ones, Lq != S, non-causal, d 72 (16-byte loads
# of 8, zero-filled to 128) and 256, d 33 and d 128 one element off their
# storage's alignment (the element loads); then the tensor-core design's
# edges: L one short of and one past its 64-row and 64-key tiles at d 64,
# 128 and 256 and its 32-row stages at d 256, causal and windowed, and Lq > S
# under a window (rows 94 on have no valid key)
FLASH_BWD_BF16_CASES = [
    (4, 32, 8, 256, 256, 128, True, None, 0),
    (1, 16, 8, 2048, 2048, 256, True, None, 0),
    (1, 16, 8, 2048, 2048, 256, True, 1024, 0),
    (1, 4, 2, 63, 63, 64, True, None, 0),
    (1, 4, 2, 65, 65, 64, True, None, 0),
    (1, 4, 2, 129, 95, 64, True, None, 0),
    (2, 6, 6, 100, 100, 64, True, None, 0),
    (1, 8, 2, 100, 100, 64, True, None, 0),
    (1, 12, 2, 100, 100, 64, True, None, 0),
    (1, 4, 2, 200, 200, 64, True, 16, 0),
    (1, 4, 2, 150, 100, 64, True, 20, 0),
    (1, 4, 2, 31, 33, 64, False, None, 0),
    (1, 4, 2, 33, 33, 128, True, None, 0),
    (1, 4, 2, 100, 160, 72, False, 20, 0),
    (1, 2, 2, 33, 31, 256, True, None, 0),
    (1, 4, 2, 97, 97, 33, True, 16, 1),
    (2, 4, 2, 130, 130, 128, True, None, 1),
    (1, 4, 2, 63, 63, 128, True, None, 0),
    (1, 4, 2, 65, 65, 128, True, 40, 0),
    (1, 4, 2, 127, 129, 64, True, 48, 0),
    (1, 4, 2, 129, 127, 64, False, 70, 0),
    (1, 2, 2, 31, 31, 256, True, None, 0),
    (1, 4, 2, 33, 33, 256, True, 20, 0),
    (1, 4, 2, 63, 65, 256, True, None, 0),
    (1, 4, 2, 65, 63, 256, True, 40, 0),
    (1, 4, 2, 160, 65, 128, True, 30, 0),
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

    async_cases = tc_cases = lse_cases = 0
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
        tc_path = flash_attention.tc_copy_ok(q, k, v)
        check(tc_path == (dtype == torch.bfloat16 and d % 8 == 0
                          and off == 0), f"{tag}: bf16 16-byte path {tc_path}")
        async_cases += path
        tc_cases += tc_path
        out = flash_attention.flash_attention(q, k, v, causal=causal,
                                              window=window)
        plain = ref.flash_attention_fwd(q, k, v, causal=causal,
                                        window=window)
        check(out.dtype == dtype and out.shape == plain.shape, tag)
        worst[tag] = _attn_check(out, plain,
                                 _flash_f64(q, k, v, causal, window), tag)
        check(same_bits(out, flash_attention.flash_attention(
            q, k, v, causal=causal, window=window)), f"{tag}: repeat")
        # with its log-sum-exp (training's forward): the same output bits
        out_l, lse = flash_attention.flash_attention(
            q, k, v, causal=causal, window=window, return_lse=True)
        check(same_bits(out_l, out), f"{tag}: the output with the "
              "log-sum-exp is not the output without it")
        _, lse_p = ref.flash_attention_fwd(q, k, v, causal=causal,
                                           window=window, return_lse=True)
        check(lse.dtype == torch.float32 and lse.shape == lse_p.shape,
              f"{tag} lse")
        worst[f"{tag} lse"] = _attn_check(
            lse, lse_p, _lse_f64(q, k, causal, window), f"{tag} lse")
        lse_cases += 1
        if dtype == torch.float32:
            max_err["flash_attention"] = max(max_err["flash_attention"],
                                             max_diff(out, plain))
        del q, k, v, out, plain, out_l, lse, lse_p
    for case, strided in ([(c, False) for c in DECODE_CASES]
                          + [(STRIDED_DECODE, True)]):
        b, h, kh, c, d, pos, dtype = case
        tag = f"B13 b={b} h={h} kh={kh} c={c} d={d} pos={pos} {dtype}" \
              + (" strided" if strided else "")
        q = randn(b, h, d).to(dtype)
        # (B, K, C, d) views of the model's (B, C, K, d) cache; the strided
        # case every other element of a (B, C, K, 2d) one
        k, v = ((randn(b, c, kh, 2 * d).to(dtype)[..., ::2]
                 if strided else randn(b, c, kh, d).to(dtype)).transpose(1, 2)
                for _ in range(2))
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
    max_err["flash_attention_bwd"] = 0.0
    for case in FLASH_BWD_CASES:
        worst.update(_check_flash_bwd(case, randn, max_err))
    bwd_bf16 = {}
    for case in FLASH_BWD_BF16_CASES:
        bwd_bf16.update(_check_flash_bwd_bf16(case, randn))
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
          "flash_cases_bf16_16_byte": tc_cases, "flash_lse_cases": lse_cases,
          "flash_bwd_cases": len(FLASH_BWD_CASES),
          "flash_bwd_bf16_cases": len(FLASH_BWD_BF16_CASES),
          "flash_bwd_bf16_rule": "each element within half a bf16 ulp of "
          f"the f64 value plus {ATTN_FACTOR} x the f32 plain version's max "
          "error, and within one bf16 ulp of the bf16 plain version plus "
          f"{ATTN_FACTOR + 1} x it (+ {ATTN_FLOOR})",
          "flash_bwd_bf16_worst": max(bwd_bf16.values()),
          "flash_bwd_bf16_errors": bwd_bf16,
          "decode_cases": len(DECODE_CASES) + 1, "single_tensor_cases": single,
          "rule": f"attention: error vs f64 <= {ATTN_FACTOR} x plain f32's "
          f"+ {ATTN_FLOOR}, over the tensor and (bf16) each row; B12a rel "
          f"{SQNORM_RTOL}; B12b bitwise with -0.0 and NaN",
          "worst_ratio": max(ek / (ep + ATTN_FLOOR)
                             for ek, ep in worst.values()),
          "errors": {k: {"kernel": ek, "plain_f32": ep}
                     for k, (ek, ep) in worst.items()}})


def _check_flash_bwd(case, randn, max_err) -> dict:
    """The flash backward on one case against its plain version and the
    f64 function (the B13/B14 rule), from B14's output and log-sum-exp;
    repeatable bit for bit, one launch a call. Returns the rule's errors by
    tag."""
    from repro_torch.kernels import common, flash_attention, flash_backward
    from repro_torch.kernels import ref
    b, h, kh, lq, s_len, d, causal, window, off = case
    tag = f"flash bwd b={b} h={h} kh={kh} lq={lq} s={s_len} d={d} " \
          f"causal={causal} window={window} offset={off}"

    def view(n, x):
        flat = randn(off + b * n * x * d)
        return flat[off:].view(b, n, x, d).transpose(1, 2)

    q, k, v, do = view(lq, h), view(s_len, kh), view(s_len, kh), view(lq, h)
    kw = {"causal": causal, "window": window}
    o, lse = flash_attention.flash_attention(q, k, v, return_lse=True, **kw)
    before = common.LAUNCHES["flash_attention_bwd"]
    got = flash_backward.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    check(common.LAUNCHES["flash_attention_bwd"] == before + 1,
          f"{tag}: launches")
    plain = ref.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    exact = flash_bwd_f64(q, k, v, do, causal, window)
    out = {}
    for name, g, p_, x, like in zip(("dq", "dk", "dv"), got, plain, exact,
                                    (q, k, v)):
        check(g.dtype == torch.float32 and g.shape == like.shape,
              f"{tag}: {name} layout")
        out[f"{tag} {name}"] = _attn_check(g, p_, x, f"{tag} {name}")
        max_err["flash_attention_bwd"] = max(max_err["flash_attention_bwd"],
                                             max_diff(g, p_))
    for _ in range(2):
        again = flash_backward.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        check(all(same_bits(a, b_) for a, b_ in zip(got, again)),
              f"{tag}: the backward is not repeatable")
    return out


def bf16_ulps(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at each |x| (bf16_ulp elementwise; at
    2^-126 and below, there), in f64."""
    x = x.double().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(x)) - 7)


def bf16_bwd_excess(got, plain, plain32, exact) -> float:
    """The bf16 backward's rule on one output (dq, dk or dv): with err32 the
    f32 plain version's max error against the f64 value (the plain version
    on the bf16 inputs widened to f32, before its one rounding), each
    element of the kernel's output within half a bf16 ulp of the f64
    value plus ATTN_FACTOR x err32 + ATTN_FLOOR (its f32 sum, in another
    order, may cost a few times the plain version's rounding; then one
    rounding to bf16), and within one bf16 ulp of the bf16 plain version
    plus (ATTN_FACTOR + 1) x err32 + ATTN_FLOOR (both f32 sums within
    their bounds of the f64 value, each rounded once). Returns the largest
    ratio of an element's distance to its bound (at most 1 passes)."""
    err32 = float((plain32.double() - exact).abs().max())
    g = got.double()
    to_exact = (g - exact).abs() / (
        0.5 * bf16_ulps(torch.maximum(g.abs(), exact.abs()))
        + ATTN_FACTOR * err32 + ATTN_FLOOR)
    p = plain.double()
    to_plain = (g - p).abs() / (
        bf16_ulps(torch.maximum(g.abs(), p.abs()))
        + (ATTN_FACTOR + 1) * err32 + ATTN_FLOOR)
    worst = max(float(to_exact.max()), float(to_plain.max()))
    return worst if math.isfinite(worst) else math.inf


def _check_flash_bwd_bf16(case, randn) -> dict:
    """``flash_attention_bwd_bf16`` on one case from B14 bf16's output and
    log-sum-exp, against its plain version and the f64 function of the same
    residuals (bf16_bwd_excess), its outputs bf16 in the operands' strides,
    its bits the same over three calls, one launch of the bf16 launcher a
    call, its 16-byte loads where ``tc_copy_ok`` holds. Returns the rule's
    worst ratio by tag."""
    from repro_torch.kernels import common, flash_attention, flash_backward
    from repro_torch.kernels import ref
    b, h, kh, lq, s_len, d, causal, window, off = case
    bf = torch.bfloat16
    tag = f"flash bwd bf16 b={b} h={h} kh={kh} lq={lq} s={s_len} d={d} " \
          f"causal={causal} window={window} offset={off}"

    def view(n, x):
        flat = randn(off + b * n * x * d).to(bf)
        return flat[off:].view(b, n, x, d).transpose(1, 2)

    q, k, v, do = view(lq, h), view(s_len, kh), view(s_len, kh), view(lq, h)
    vec = flash_attention.tc_copy_ok(q, k, v, do)
    check(vec == (d % 8 == 0 and off == 0), f"{tag}: 16-byte loads {vec}")
    kw = {"causal": causal, "window": window}
    o, lse = flash_attention.flash_attention(q, k, v, return_lse=True, **kw)
    check(o.dtype == bf and lse.dtype == torch.float32, f"{tag}: B14")
    before = dict(common.LAUNCHERS)
    got = flash_backward.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    check({n: c - before.get(n, 0) for n, c in common.LAUNCHERS.items()
           if c != before.get(n, 0)} == {"flash_attention_bwd_bf16": 1},
          f"{tag}: launches")
    plain = ref.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    plain32 = ref.flash_attention_bwd(q.float(), k.float(), v.float(),
                                      o.float(), lse, do.float(), **kw)
    exact = flash_bwd_f64(q, k, v, do, causal, window, o=o)
    out = {}
    for name, g, p_, p32, x, like in zip(("dq", "dk", "dv"), got, plain,
                                         plain32, exact, (q, k, v)):
        check(g.dtype == bf and g.shape == like.shape
              and g.stride() == like.stride(), f"{tag}: {name} layout")
        out[f"{tag} {name}"] = bf16_bwd_excess(g, p_, p32, x)
        check(out[f"{tag} {name}"] <= 1.0, f"{tag} {name}: "
              f"{out[f'{tag} {name}']} of the bf16 rule's bound")
    del plain, plain32, exact
    for _ in range(2):
        again = flash_backward.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        check(all(same_bits(a, b_) for a, b_ in zip(got, again)),
              f"{tag}: the backward is not repeatable")
    return out


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
             "fold_workers", "hb_update"),
    "lowrank": ("sqnorm_batched", "residual_ef_batched", "bank_advance",
                "fold_workers", "hb_update"),
    "dense_staged": ("censor_delta_sqnorm_batched", "censor_bank_advance",
                     "fold_workers", "hb_update"),
    "int8_staged": ("sqnorm_batched", "absmax_batched", "quantize_ef_batched",
                    "bank_advance", "fold_workers", "hb_update"),
    "per_tensor": ("sqnorm_batched", "bank_advance", "fold_workers",
                   "hb_update"),
    # B3 through apply_server, after the (one-shard) fold
    "shard_dense": ("censor_delta_sqnorm_batched", "censor_bank_advance",
                    "fold_workers", "hb_update"),
    "shard_int8": ("sqnorm_batched", "absmax_batched", "quantize_ef_batched",
                   "bank_advance", "fold_workers", "hb_update"),
    # sub-f32 banks: f32 params on a bf16 bank ("_bf16bank") and bf16
    # params; int8 on the fused route only
    "dense_bf16bank": ("censor_delta_sqnorm_batched", "fused_dense_step"),
    "int8_bf16bank": ("int8_stats_batched", "fused_int8_step"),
    "dense_bf16": ("censor_delta_sqnorm_batched", "fused_dense_step"),
    "int8_bf16": ("int8_stats_batched", "fused_int8_step"),
}
for _bf16 in ("_bf16bank", "_bf16"):
    for _path in ("dense_staged", "shard_dense", "per_tensor", "int8_staged",
                  "shard_int8", "topk", "lowrank"):
        PATH_KERNELS[_path + _bf16] = PATH_KERNELS[_path]
# the path each staged or sharded path must equal bit for bit
SAME_AS = {"dense_staged": "dense", "int8_staged": "int8",
           "shard_dense": "dense", "shard_int8": "int8",
           **{f"{path}{b}": f"{fused}{b}" for b in ("_bf16bank", "_bf16")
              for path, fused in (("dense_staged", "dense"),
                                  ("shard_dense", "dense"),
                                  ("int8_staged", "int8"),
                                  ("shard_int8", "int8"))}}


class ShardAnchor:
    """The single-shard sync anchor as an optimizer ``simulator.run`` can
    drive: ``shard_step`` over every worker with no gates, then
    ``apply_server`` on the partial sum."""

    def __init__(self, opt):
        self.opt = opt
        self.alpha, self.beta = opt.alpha, opt.beta

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


def lowrank_payload_bytes(rank: int, itemsize: int = 4) -> int:
    """Bytes of one low-rank transmission of the model's leaves of
    ``itemsize``-byte params: two factors of rank min(rank, rows, cols) per
    matrix leaf (rows = shape[0]), a vector leaf dense."""
    total = 0
    for shape in LM_LEAVES.values():
        if len(shape) >= 2:
            r, c = shape[0], math.prod(shape[1:])
            total += min(rank, r, c) * (r + c) * itemsize
        else:
            total += math.prod(shape) * itemsize
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
        # f32 params on a bf16 bank: the uploads are the f32 payload's
        # (per_tensor's the bf16 pending leaves', at most 2d)
        "dense_bf16bank": ({"bank_dtype": torch.bfloat16}, flat, 4 * d),
        "int8_bf16bank": ({**int8, "bank_dtype": torch.bfloat16}, flat,
                          d + 4),
        # the stateful transports off the fused route (B7a, B7b, B10 on a
        # bf16 pending leaf): the uplinks are the f32 params' payload
        "int8_staged_bf16bank": ({**int8, "bank_dtype": torch.bfloat16},
                                 flat, d + 4),
        "shard_int8_bf16bank": ({**int8, "bank_dtype": torch.bfloat16},
                                flat, d + 4),
        "topk_bf16bank": ({"transport": "topk", "k": FULL_TOPK_K,
                           "bank_dtype": torch.bfloat16}, flat,
                          FULL_TOPK_K * (4 + 4)),
        "dense_staged_bf16bank": ({"bank_dtype": torch.bfloat16}, flat,
                                  4 * d),
        "shard_dense_bf16bank": ({"bank_dtype": torch.bfloat16}, flat,
                                 4 * d),
        "per_tensor_bf16bank": ({"granularity": "per_tensor",
                                 "bank_dtype": torch.bfloat16}, tree, None),
    }

    def one_run(kind, kw, task, backend, keep_state=False):
        o = opt.make("chb", FULL_ALPHA, m, eps1=FULL_EPS1, backend=backend,
                     **kw)
        rec = StepRecorder(ShardAnchor(o) if kind.startswith("shard")
                           else o)
        staged = fused_step.force_staged() if "_staged" in kind \
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
            "min_margin": (None if kind.startswith("per_tensor")
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
        LAUNCHERS_BY_PATH[kind] = dict(common.LAUNCHERS)
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
            el = 2 if kind.endswith("_bf16bank") else 4   # pending's bytes
            check(0 < want <= sent * el * d and want % el == 0,
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
    del paths, fused
    torch.cuda.empty_cache()
    bf16_summary, bf16_launches = _full_bf16_paths(tree, d, m, iters)
    del tree
    summary.update(bf16_summary)
    launches.update(bf16_launches)
    emit({"phase": "full", "d": d, "m": m, "iters": iters,
          "topk_k": FULL_TOPK_K, "lowrank_rank": FULL_RANK,
          "setup_s": setup_s, **summary})
    return launches


#: phase full's paths held step by step against the reference backend
#: (Lockstep), by (opt.make keywords, params dtype, on the model's 12
#: leaves). The all-bf16 paths run make_edge_quadratics in bf16 (per_tensor
#: and low-rank on its view as the model's 12 leaves): eq. (4) runs in f32
#: in B2, B6 and B3 (compute_dtype, as the JAX kernels run it) and in bf16
#: on the reference backend (as the JAX reference step does), so the two
#: are held from one state. Each cuda theta' lies within BF16_EQ4_UNITS
#: bf16 unit roundoffs (2^-8) of the sum of the magnitudes of eq. (4)'s
#: terms of the reference's: the reference rounds alpha, beta and each of
#: its five operations to bf16, the kernel once. The staged and sharded
#: paths equal the fused runs bit for bit (SAME_AS). lowrank_bf16bank
#: (f32 params over a bf16 bank, the 12 leaves): its factor products run in
#: f32, so the reference keeps err' in f32 and B11 writes it in bf16, as the
#: JAX package's two backends do (ONE_BF16_ROUNDING); theta' is the same
#: f32 arithmetic on one bank, bit for bit
BF16 = torch.bfloat16
_INT8, _TOPK = {"quantize": "int8"}, {"transport": "topk", "k": FULL_TOPK_K}
_LOWRANK = {"transport": "lowrank", "rank": FULL_RANK}
BF16_FULL_PATHS = {
    "dense_bf16": ({}, BF16, False), "int8_bf16": (_INT8, BF16, False),
    "dense_staged_bf16": ({}, BF16, False),
    "shard_dense_bf16": ({}, BF16, False),
    "per_tensor_bf16": ({"granularity": "per_tensor"}, BF16, True),
    "int8_staged_bf16": (_INT8, BF16, False),
    "shard_int8_bf16": (_INT8, BF16, False),
    "topk_bf16": (_TOPK, BF16, False), "lowrank_bf16": (_LOWRANK, BF16, True),
    "lowrank_bf16bank": ({**_LOWRANK, "bank_dtype": BF16}, torch.float32,
                         True)}
BF16_EQ4_UNITS = 8
#: |err'_cuda - err'_reference| where the reference keeps low-rank's err'
#: in f32 and B11 rounds it to bf16: bf16(p - bf16(q)) against p - q, at
#: most u|q| + u|p - q| + u^2|q| with u = 2^-8 and |q| <= |p| + |p - q|
ONE_BF16_ROUNDING = 2.0 ** -7


class Lockstep:
    """Both backends from one state at every step; the run goes on from
    the cuda step. Masks, the comm counters, ghat', err' and the worker
    sum bit for bit (err' of another dtype within ONE_BF16_ROUNDING of
    |pending| + 2|err'|); theta' bit for bit for f32 params, within
    BF16_EQ4_UNITS of eq. (4)'s terms for bf16 ones."""

    def __init__(self, cuda_opt, ref_opt, tag):
        self.cuda, self.ref, self.tag = StepRecorder(cuda_opt), \
            StepRecorder(ref_opt), tag
        self.alpha, self.beta = cuda_opt.alpha, cuda_opt.beta
        self.theta_units = 0.0
        self.err_rel = 0.0

    def init(self, params):
        return self.cuda.init(params)

    def _err_close(self, state, grads, ec, er) -> bool:
        """err' of the two backends, leaf by leaf: bit for bit in one dtype,
        else within ONE_BF16_ROUNDING of |pending| + 2|err'_reference|."""
        def ef(err):       # the EF bank (low-rank's beside its factors)
            return err["err"] if isinstance(err, dict) and "q" in err \
                else err
        if ef(ec) is not ec and not all(same_bits(a, b) for a, b in zip(
                tree_leaves(ec["q"]), tree_leaves(er["q"]))):
            return False
        for g, h, e0, a, b in zip(*(tree_leaves(x) for x in (
                grads, state.ghat, ef(state.err), ef(ec), ef(er)))):
            if a.dtype == b.dtype:
                if not same_bits(a, b):
                    return False
                continue
            pend = ((g.to(h.dtype) - h) + e0.to(h.dtype)).float()
            bound = ONE_BF16_ROUNDING * (pend.abs() + 2 * b.float().abs())
            gap = (a.float() - b.float()).abs()
            if not bool((gap <= bound).all()):
                return False
            scale = float(pend.abs().max()) or 1.0
            self.err_rel = max(self.err_rel, float(gap.max()) / scale)
            del pend, bound, gap
        return True

    def step(self, state, params, grads):
        from repro_torch.core.util import sum_leading
        out_c = self.cuda.step(state, params, grads)
        out_r = self.ref.step(state, params, grads)
        (sc, tc, stc), (sr, tr, str_) = out_c, out_r
        k, tag = len(self.cuda.events), self.tag
        check(torch.equal(stc.mask, str_.mask), f"{tag} step {k}: masks")
        check(all(torch.equal(a, b) for a, b in zip(sc.comm, sr.comm)),
              f"{tag} step {k}: comm counters")
        check(all(same_bits(a, b) for a, b in zip(
            tree_leaves(sc.ghat), tree_leaves(sr.ghat))),
              f"{tag} step {k}: ghat'")
        check(self._err_close(state, grads, sc.err, sr.err),
              f"{tag} step {k}: err'")
        for t, tp, h, a, b in zip(*(tree_leaves(x) for x in (
                params, state.prev_params, sc.ghat, tc, tr))):
            check(a.dtype == b.dtype == t.dtype, f"{tag} step {k}: theta' "
                  f"dtypes {a.dtype}, {b.dtype}")
            if t.dtype == torch.float32:
                check(same_bits(a, b), f"{tag} step {k}: theta'")
                continue
            agg = sum_leading(h).float()
            t, tp = t.float(), tp.float()
            terms = t.abs() + abs(self.alpha) * agg.abs() \
                + abs(self.beta) * (t - tp).abs()
            gap = (a.float() - b.float()).abs()
            units = float((gap / (terms * 2.0 ** -8).clamp_min(
                torch.finfo(torch.float32).tiny)).max())
            check(units <= BF16_EQ4_UNITS, f"{tag} step {k}: theta' {units} "
                  "bf16 units from the reference's")
            self.theta_units = max(self.theta_units, units)
            del agg, t, tp, terms, gap
        return out_c


def _payload_bytes(kind: str, d: int, itemsize: int):
    """One upload's bytes on a Lockstep path (None: per_tensor, whose
    bytes count per transmitted leaf)."""
    if kind.startswith("per_tensor"):
        return None
    if "int8" in kind:
        return d + 4
    if kind.startswith("topk"):
        return FULL_TOPK_K * (4 + itemsize)
    if kind.startswith("lowrank"):
        return lowrank_payload_bytes(FULL_RANK, itemsize)
    return itemsize * d


def _full_bf16_paths(tree32, d, m, iters, device="cuda") -> tuple:
    """BF16_FULL_PATHS at full width: chb through the cuda backend, in
    lockstep with the reference backend (Lockstep), on make_edge_quadratics
    in bf16 or (f32 params) on ``tree32``, phase full's task as the model's
    12 leaves; launches as PATH_KERNELS says, bytes as the port's and the
    JAX package's payload_bytes count them (_payload_bytes; per_tensor at
    most 2d an upload); the staged and sharded runs equal to the fused
    ones' bit for bit (masks, counters, theta, ghat, err). Returns (summary,
    launches) by path."""
    from repro_torch import opt
    from repro_torch.core import simulator
    from repro_torch.data import edge_tasks
    from repro_torch.kernels import common, fused_step
    t0 = time.perf_counter()
    task = edge_tasks.make_edge_quadratics(m=m, d=d, seed=0,
                                           dtype=torch.bfloat16, device=device)
    tree = lm_tree_task(task)
    setup_s = time.perf_counter() - t0
    summary, launches, kept = {}, {}, {}
    for kind, (kw, p_dt, leaves12) in BF16_FULL_PATHS.items():
        ops = [opt.make("chb", FULL_ALPHA, m, eps1=FULL_EPS1, backend=b,
                        **kw) for b in ("cuda", "reference")]
        if kind.startswith("shard"):
            ops = [ShardAnchor(o) for o in ops]
        lock = Lockstep(*ops, f"full {kind}")
        if p_dt == torch.float32:
            on = tree32
        else:
            on = tree if leaves12 else task
        leaves = len(tree_leaves(on.init_params))
        staged = fused_step.force_staged() if "_staged" in kind \
            else contextlib.nullcontext()
        common.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with staged:
            hist = simulator.run(lock, on, iters, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches[kind] = dict(common.LAUNCHES)
        LAUNCHERS_BY_PATH[kind] = dict(common.LAUNCHERS)
        want = {name: iters * leaves if name in PATH_KERNELS[kind] else 0
                for name in common.KERNELS}
        check(launches[kind] == want,
              f"full {kind}: launches {launches[kind]}, want {want}")
        comm = hist.final_state.comm
        sent = int(hist.mask.sum())
        got_bytes = comm.uplink_bytes_exact()
        el = torch.empty((), dtype=p_dt).element_size()
        payload = _payload_bytes(kind, d, el)
        if payload is None:
            check(0 < got_bytes <= sent * 2 * d and got_bytes % 2 == 0,
                  f"full {kind}: uplink bytes {got_bytes} for {sent} uploads")
        else:
            check(got_bytes == sent * payload,
                  f"full {kind}: uplink bytes {got_bytes}, want {sent} x "
                  f"{payload}")
        objective = float(hist.objective[-1])
        check(math.isfinite(objective) and all(
            x.dtype == p_dt for x in tree_leaves(hist.final_params)),
              f"full {kind}: objective {objective}")
        s = hist.final_state
        res = {"mask": hist.mask.cpu(), "comm_cum": hist.comm_cum.cpu(),
               "theta": tree_leaves(hist.final_params),
               "state": tree_leaves([s.ghat, s.err, list(s.comm)])}
        if kind in SAME_AS:
            f = kept[SAME_AS[kind]]
            check(torch.equal(res["mask"], f["mask"])
                  and torch.equal(res["comm_cum"], f["comm_cum"])
                  and len(res["state"]) == len(f["state"])
                  and all(same_bits(a, b) if a.is_floating_point()
                          else torch.equal(a, b) for a, b in zip(
                              res["theta"] + res["state"],
                              f["theta"] + f["state"])),
                  f"full {kind}: differs from {SAME_AS[kind]}'s run")
        if kind in SAME_AS.values():
            kept[kind] = res
        margins = [x.min_margin(FULL_EPS1) for x in (lock.cuda, lock.ref)]
        summary[kind] = {
            "uploads": sent, "uplink_bytes": got_bytes,
            "payload_bytes": payload, "leaves": leaves, "lockstep": True,
            "params": str(p_dt), "equals": SAME_AS.get(kind),
            "theta_max_bf16_units": lock.theta_units,
            "theta_bound_units": BF16_EQ4_UNITS,
            "err_max_gap_rel_pending": lock.err_rel,
            "min_eq8_margin": (None if kind.startswith("per_tensor")
                               else min(margins)), "objective": objective,
            "step_ms_cuda": lock.cuda.median_ms(),
            "step_ms_reference": lock.ref.median_ms(), "wall_s_both": wall,
            "setup_s": setup_s,
            "launches": {n: c for n, c in launches[kind].items() if c}}
        del hist, lock, ops, res, s
        torch.cuda.empty_cache()
    del task, tree, kept
    torch.cuda.empty_cache()
    return summary, launches


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


# ------------------------------------------------------------ phase mesh
MESH_EXACT = ("mask", "participated", "attempted", "delivered",
              "quorum_met", "comm_cum", "delivered_cum", "bytes_cum")
# a dense chb shard's kernels, once a shard a round (B3 once a round)
MESH_SHARD_KERNELS = ("censor_delta_sqnorm_batched", "censor_bank_advance",
                      "fold_workers")


def _mesh_run(o, task, scenario, shards, rounds, device):
    """One timed ``fed.run_mesh`` over ``shards`` shards on ``device``;
    returns the history, its launch counts and its ms a round."""
    from repro_torch import fed
    from repro_torch.kernels import common
    from repro_torch.launch.mesh import make_client_mesh
    mesh = make_client_mesh(shards, [device] * shards)
    torch.cuda.synchronize()
    common.reset_launches()
    t = time.perf_counter()
    hist = fed.run_mesh(o, task, rounds, mesh=mesh, scenario=scenario)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3 / rounds
    return hist, dict(common.LAUNCHES), ms


def phase_mesh(device) -> dict:
    """``fed.run_mesh`` at the fed mesh's 10^5 clients on the one card:
    every MESH_SCENARIOS scenario over each of MESH_SHARDS shard counts,
    the integer records bit-equal across K and the floats within the K-way
    fold's ulps; the ideal scenario at K = 1 equal to ``simulator.run`` bit
    for bit; the harsh scenario equal on both backends; the kernels
    launched once a shard a round (B3 once a round). Returns the launch
    counts of the K = 1 runs (keys ``mesh_<scenario>``)."""
    from repro_torch import fed, opt
    from repro_torch.core import simulator
    from repro_torch.data import edge_tasks
    from repro_torch.kernels import common
    t0 = time.perf_counter()
    m = MANY_M
    task = edge_tasks.make_edge_quadratics(m=m, d=MANY_D, seed=0,
                                           device=device)

    def make(backend):
        return opt.make("chb", 0.5 / m, m, eps1=FULL_EPS1, backend=backend)

    summary, launches = {}, {}
    for name, (part, loss, quo) in MESH_SCENARIOS.items():
        sc = fed.MeshScenario(participation=part, loss_prob=loss,
                              quorum=quo, seed=MESH_SEED)
        runs = {k: _mesh_run(make("cuda"), task, sc, k, MESH_ROUNDS,
                             device) for k in MESH_SHARDS}
        base = runs[1][0]
        for k, (h, lk, _) in runs.items():
            want = {n: (k * MESH_ROUNDS if n in MESH_SHARD_KERNELS else
                        MESH_ROUNDS if n == "hb_update" else 0)
                    for n in common.KERNELS}
            check(lk == want, f"mesh {name} K={k}: launches {lk}, want "
                  f"{want}")
            for f in MESH_EXACT:
                check(np.array_equal(getattr(h, f), getattr(base, f)),
                      f"mesh {name} K={k}: {f} differs from K=1's")
            rel = float(np.max(np.abs(h.objective - base.objective)
                               / np.abs(base.objective)))
            check(rel < 1e-12 and bool(np.isfinite(h.objective).all()),
                  f"mesh {name} K={k}: objective {rel} from K=1's")
        check(tuple(base.mask.shape) == (MESH_ROUNDS, m),
              f"mesh {name}: masks of shape {base.mask.shape}")
        if part < 1.0 or loss > 0.0:
            check(0 < base.participated.min() and
                  base.participated.max() <= m and
                  (base.delivered <= base.attempted).all(),
                  f"mesh {name}: cohort records out of range")
        launches[f"mesh_{name}"] = runs[1][1]
        summary[name] = {
            "uploads": int(base.comm_cum[-1]),
            "delivered": int(base.delivered_cum[-1]),
            "uplink_bytes": int(base.bytes_cum[-1]),
            "quorum_met": int(base.quorum_met.sum()),
            "objective_first": float(base.objective[0]),
            "objective_last": float(base.objective[-1]),
            "ms_per_round": {f"K={k}": r[2] for k, r in runs.items()},
            "launches_k1": {n: c for n, c in runs[1][1].items() if c}}
        del runs, base
    # (a) the sync anchor on the card
    ideal = fed.MeshScenario()
    h, _, _ = _mesh_run(make("cuda"), task, ideal, 1, MESH_ROUNDS, device)
    ref = simulator.run(make("cuda"), task, MESH_ROUNDS, device=device)
    check(np.array_equal(h.objective, ref.objective.cpu().numpy())
          and np.array_equal(h.agg_grad_sqnorm,
                             ref.agg_grad_sqnorm.cpu().numpy())
          and np.array_equal(h.comm_cum, ref.comm_cum.cpu().numpy())
          and np.array_equal(h.mask, ref.mask.cpu().numpy().astype(np.int8))
          and same_bits(h.final_params, ref.final_params),
          "mesh: the ideal scenario at K=1 differs from simulator.run")
    del h, ref
    # both backends, MESH_REF_ROUNDS rounds of the harsh scenario at K = 2
    part, loss, quo = MESH_SCENARIOS["harsh"]
    sc = fed.MeshScenario(participation=part, loss_prob=loss, quorum=quo,
                          seed=MESH_SEED)
    by_backend = {b: _mesh_run(make(b), task, sc, 2, MESH_REF_ROUNDS, device)
                  for b in ("cuda", "reference")}
    (hk, _, msk), (hr, lr, msr) = by_backend["cuda"], by_backend["reference"]
    check(not any(lr.values()),
          "mesh: the reference backend launched a kernel")
    check(all(np.array_equal(getattr(hk, f), getattr(hr, f))
              for f in MESH_EXACT + ("objective", "agg_grad_sqnorm",
                                     "energy_cum", "wall_clock"))
          and same_bits(hk.final_params, hr.final_params),
          "mesh: the harsh scenario differs between backends")
    del by_backend, hk, hr, task
    torch.cuda.empty_cache()
    bf16bank, launches["mesh_bf16bank"] = _mesh_bf16bank(device)
    line = ", ".join(f"{n} {r['ms_per_round']['K=1']:.3f}"
                     for n, r in summary.items())
    print(f"mesh: ms a round at M={m}, one shard on the card: {line}",
          flush=True)
    emit({"phase": "mesh", "m": m, "d": MANY_D, "dtype": "float64",
          "rounds": MESH_ROUNDS, "shards": list(MESH_SHARDS),
          "scenarios": summary,
          "backends_equal": {"scenario": "harsh", "shards": 2,
                             "rounds": MESH_REF_ROUNDS,
                             "ms_per_round_cuda": msk,
                             "ms_per_round_reference": msr},
          "bitwise": "across K: masks, cohort, attempted, delivered, "
          "quorum, comm and bytes; K=1 ideal == simulator.run; cuda == "
          "reference", "bf16bank": bf16bank,
          "seconds": time.perf_counter() - t0})
    return launches


#: rounds of phase mesh's bf16-bank case on the reference backend (its
#: worker sum is 10^5 eager adds a round); the first transmits everywhere
#: (theta^0 = theta^-1), the second decides 10^5 eq.-(8) tests
MESH_BF16_REF_ROUNDS = 2


def _mesh_bf16bank(device) -> tuple:
    """The ideal scenario at 10^5 clients on a bf16 bank of f32 params, one
    shard: MESH_ROUNDS rounds equal to ``simulator.run`` on the card bit
    for bit, and MESH_BF16_REF_ROUNDS rounds equal on both backends (B1 on
    the bf16 bank, B4, the fold of the bf16 bank and B3 against the
    reference step); B1, B4 and the fold once a round, B3 once a round.
    Returns (summary, the cuda run's launches)."""
    from repro_torch import fed, opt
    from repro_torch.core import simulator
    from repro_torch.data import edge_tasks
    from repro_torch.kernels import common
    m = MANY_M
    task = edge_tasks.make_edge_quadratics(m=m, d=MANY_D, seed=0,
                                           dtype=torch.float32, device=device)

    def make(backend):
        return opt.make("chb", 0.5 / m, m, eps1=FULL_EPS1, backend=backend,
                        bank_dtype=torch.bfloat16)

    ideal = fed.MeshScenario()
    h, lk, ms = _mesh_run(make("cuda"), task, ideal, 1, MESH_ROUNDS, device)
    LAUNCHERS_BY_PATH["mesh_bf16bank"] = dict(common.LAUNCHERS)
    want = {n: (MESH_ROUNDS if n in MESH_SHARD_KERNELS + ("hb_update",)
                else 0) for n in common.KERNELS}
    check(lk == want, f"mesh bf16bank: launches {lk}, want {want}")
    sim = simulator.run(make("cuda"), task, MESH_ROUNDS, device=device)
    check(np.array_equal(h.objective, sim.objective.cpu().numpy())
          and np.array_equal(h.comm_cum, sim.comm_cum.cpu().numpy())
          and np.array_equal(h.mask, sim.mask.cpu().numpy().astype(np.int8))
          and same_bits(h.final_params, sim.final_params),
          "mesh bf16bank: the ideal scenario differs from simulator.run")
    check(0 < int(h.comm_cum[-1]) < MESH_ROUNDS * m,
          f"mesh bf16bank: {int(h.comm_cum[-1])} uploads")
    del sim
    runs = {b: _mesh_run(make(b), task, ideal, 1, MESH_BF16_REF_ROUNDS,
                         device) for b in ("cuda", "reference")}
    (hk, _, msk), (hr, lr, msr) = runs["cuda"], runs["reference"]
    check(not any(lr.values()),
          "mesh bf16bank: the reference backend launched a kernel")
    check(all(np.array_equal(getattr(hk, f), getattr(hr, f))
              for f in MESH_EXACT + ("objective", "agg_grad_sqnorm"))
          and same_bits(hk.final_params, hr.final_params),
          "mesh bf16bank: the backends differ")
    out = {"rounds": MESH_ROUNDS, "uploads": int(h.comm_cum[-1]),
           "ref_uploads_by_round": np.diff(hk.comm_cum, prepend=0).tolist(),
           "ms_per_round_cuda": ms, "ref_rounds": MESH_BF16_REF_ROUNDS,
           "ms_per_round_cuda_short": msk, "ms_per_round_reference": msr,
           "bitwise": "simulator.run; cuda == reference"}
    del h, runs, hk, hr, task
    torch.cuda.empty_cache()
    return out, lk


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
    summary["chb_bf16bank"], launches["edge_bf16bank"] = _edge_bf16bank(
        task, device, leaves)
    emit({"phase": "edge", "d": FULL_D, "m": FULL_M, "rounds": EDGE_ROUNDS,
          "dtype": "float32", **summary,
          "seconds": time.perf_counter() - t0})
    return launches


def _edge_bf16bank(task, device, leaves) -> tuple:
    """chb's deployment on a bf16 bank of the f32 params, on both backends:
    masks, counters, wall clock, energy, theta and the bank bit for bit
    (B8 sums the bf16 pending row, B3 runs eq. (4) in f32 on the bf16
    worker sum, as HeavyBall.apply does); B8 once per client evaluation, B3
    once per round. Returns (summary, the cuda run's launches)."""
    from repro_torch import opt
    from repro_torch.kernels import common
    algo, kw = EDGE_PATHS["chb"]
    runs = {}
    for b in ("cuda", "reference"):
        runs[b] = _edge_run(opt.make(algo, FULL_ALPHA, FULL_M, backend=b,
                                     bank_dtype=torch.bfloat16, **kw),
                            task, edge_scenario(), device)
        if b == "cuda":
            LAUNCHERS_BY_PATH["edge_bf16bank"] = dict(common.LAUNCHERS)
    (hk, tk), (hr, tr) = runs["cuda"], runs["reference"]
    for f in ("mask", "comm_cum", "bytes_cum", "energy_cum", "wall_clock"):
        check(np.array_equal(getattr(hk, f), getattr(hr, f)),
              f"edge chb_bf16bank: {f} differs between backends")
    check(hk.stats.as_dict() == hr.stats.as_dict(),
          "edge chb_bf16bank: the deployment accounting differs")
    check(all(same_bits(a, b) for a, b in zip(
        tree_leaves([hk.final_params, hk.final_bank]),
        tree_leaves([hr.final_params, hr.final_bank])))
          and tree_leaves(hk.final_bank)[0].dtype == torch.bfloat16,
          "edge chb_bf16bank: theta or the bank differs between backends")
    check(tk["launches"] == _want_edge_launches(tk["client_evals"], leaves),
          f"edge chb_bf16bank: launches {tk['launches']}")
    check(not any(tr["launches"].values()),
          "edge chb_bf16bank: the reference backend launched a kernel")
    check(int(hk.comm_cum[-1]) > 0 and bool(np.isfinite(hk.objective).all()),
          "edge chb_bf16bank: no uploads or a non-finite objective")
    launches = tk.pop("launches")
    tr.pop("launches")
    d = hk.stats.as_dict()
    del runs, hk, hr
    torch.cuda.empty_cache()
    return {"deployment": {"cuda": tk, "reference": tr,
                           "uploads": d["uplinks"], "censored": d["censored"],
                           "bank_dtype": "bfloat16", "bitwise": True}}, \
        launches


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
                                     "fold_workers", "hb_update") else 0
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


def _serve_run(params, cfg, shape, device, tol_of) -> tuple:
    """One run of ``launch.serve.generate``: the reference backend twice
    (the first warms up), then the cuda backend twice teacher-forced with
    the reference's tokens (the first warms up); logits within
    ``tol_of(reference logits)``, argmax equal where the reference's top-2
    gap exceeds twice that, the launch counts of one prefill and gen - 1
    steps, TF32 and bf16 reduced-precision reductions off. Returns (what
    the phase emits of the run, the launch counts)."""
    from repro_torch.kernels import common
    from repro_torch.launch import serve
    b, l, gen = shape["batch"], shape["prompt"], shape["gen"]
    prompts = serve.prompts_of(cfg, b, l, device)

    def timed(**kw):
        torch.cuda.reset_peak_memory_stats()
        g = serve.generate(params, cfg, prompts, gen, device=device, **kw)
        torch.cuda.synchronize()
        return g, torch.cuda.max_memory_allocated() / 2 ** 30
    ref_runs = [timed(backend="reference") for _ in range(2)]
    ref, ref_gib = ref_runs[-1]
    check(torch.equal(ref.tokens, ref_runs[0][0].tokens),
          f"{cfg.name}: the reference backend is not repeatable")
    check(not torch.backends.cuda.matmul.allow_tf32,
          f"{cfg.name}: TF32 matmuls are on")
    check(not torch.backends.cuda.matmul
          .allow_bf16_reduced_precision_reduction,
          f"{cfg.name}: bf16 GEMMs may reduce in bf16")
    timed(feed=ref.tokens)                                  # warm-up
    common.reset_launches()
    cud, cud_gib = timed(feed=ref.tokens)
    launches = dict(common.LAUNCHES)
    want = {name: 0 for name in common.KERNELS}
    want["flash_attention"] = cfg.num_layers
    want["decode_attention"] = cfg.num_layers * (gen - 1)
    check(launches == want, f"{cfg.name}: launches {launches}, want {want}")
    check(all(bool(torch.isfinite(x).all()) for x in cud.logits)
          and tuple(cud.logits[0].shape) == (b, cfg.vocab_size)
          and all(x.dtype == torch.float32 for x in cud.logits),
          f"{cfg.name}: logits not finite f32 of the wrong shape")
    diff = max(max_diff(a, r) for a, r in zip(cud.logits, ref.logits))
    tol = tol_of(ref.logits)
    check(diff <= tol, f"{cfg.name}: logits differ between backends by "
          f"{diff}, more than {tol}")
    gaps = torch.stack([_gap(r) for r in ref.logits], dim=1)
    clear = gaps > 2 * tol
    check(torch.equal(cud.tokens[clear], ref.tokens[clear]),
          f"{cfg.name}: argmax differs where the top-2 gap is clear")

    def rate(g):
        return b * gen / ((g.prefill_ms + sum(g.step_ms)) / 1e3)
    out = {
        "batch": b, "prompt": l, "gen": gen, "cache": l + gen + 1,
        "max_logit_diff": diff, "logit_tol": tol,
        "max_abs_logit": max(float(r.abs().max()) for r in ref.logits),
        "argmax_compared": int(clear.sum()),
        "argmax_total": int(clear.numel()),
        "argmax_equal_all": bool(torch.equal(cud.tokens, ref.tokens)),
        "prefill_ms_cuda": cud.prefill_ms,
        "prefill_ms_reference": ref.prefill_ms,
        "decode_ms_per_step_cuda": statistics.median(cud.step_ms),
        "decode_ms_per_step_reference": statistics.median(ref.step_ms),
        "tok_per_s_cuda": rate(cud), "tok_per_s_reference": rate(ref),
        "peak_gib_cuda": cud_gib, "peak_gib_reference": ref_gib,
        "launches": {k: c for k, c in launches.items() if c},
    }
    return out, launches


def phase_serve(device) -> dict:
    """chb-paper-lm-124m at full width through ``launch.serve.generate``
    (``_serve_run``). Returns each run's launch counts."""
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
        out[run], launches[run] = _serve_run(
            params, cfg, shape, device, lambda _: SERVE_LOGIT_TOL)
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    emit({"phase": "serve", "arch": LM_ARCH, "params": FULL_D,
          "logit_tol": SERVE_LOGIT_TOL, "tf32": False, **out})
    return launches


def phase_serve_bf16(device) -> dict:
    """qwen3-4b and gemma3-12b at full width in bf16 through
    ``launch.serve.generate`` (``_serve_run``, SERVE_BF16_LOGIT_ULPS), one
    model on the card at a time. Returns each run's launch counts."""
    t0 = time.perf_counter()
    out, launches = {}, {}
    start_gib = torch.cuda.memory_allocated() / 2 ** 30
    for arch, n_want in SERVE_BF16_ARCHS.items():
        cfg = get_config(arch)
        check(cfg.dtype == "bfloat16" and cfg.num_layers in (36, 48),
              f"serve_bf16: {cfg}")
        t = time.perf_counter()
        params = init_params(PRNGKey(0, device=device), cfg)
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t
        leaves = tree_leaves(params)
        n_params = sum(x.numel() for x in leaves)
        check(n_params == n_want and all(x.dtype == torch.bfloat16
                                         for x in leaves),
              f"serve_bf16 {arch}: {n_params} parameters, want {n_want} "
              "in bf16")
        res = {"params": n_params, "layers": cfg.num_layers,
               "d_model": cfg.d_model, "heads": cfg.num_heads,
               "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
               "layer_pattern": cfg.layer_pattern,
               "weights_gib": sum(x.numel() * x.element_size()
                                  for x in leaves) / 2 ** 30,
               "weights_draw_s": draw_s}
        del leaves
        for run, shape in SERVE_RUNS.items():
            res[run], launches[f"{arch}_{run}"] = _serve_run(
                params, cfg, shape, device,
                lambda logits: SERVE_BF16_LOGIT_ULPS * bf16_ulp(
                    max(float(x.abs().max()) for x in logits)))
            torch.cuda.empty_cache()
        out[arch] = res
        del params
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "serve_bf16", "logit_ulps": SERVE_BF16_LOGIT_ULPS,
          "allocated_gib_at_start": start_gib,
          "tf32": False, "bf16_reduced_precision_reduction": False, **out,
          "seconds": time.perf_counter() - t0})
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
    for arch, seed in SERVE_BF16_PIN_SEEDS.items():
        cfg = bf16_pin_config(get_config, arch)
        params = model_params(numpy_model_params(cfg, seed), cfg, device)
        out[f"{arch}_bf16"] = bf16_pin_check(
            params, cfg, SERVE_BF16_PIN[arch], device)
    emit({"phase": "jax_pin", "bf16_logit_ulps": SERVE_BF16_LOGIT_ULPS,
          "bf16_rtol": SERVE_BF16_PIN_RTOL, **out})


def bf16_pin_check(params, cfg, pin, device) -> dict:
    """One bf16 pin (SERVE_BF16_PIN): ``generate`` teacher-forced with the
    JAX package's tokens; its argmax where its top-2 gap is clear, and the
    two checksums of every step's logits. Returns what was compared."""
    from repro_torch.launch import serve
    toks, total, abs_total = pin
    sh = SERVE_PIN_SHAPE
    prompts = serve.prompts_of(cfg, sh["batch"], sh["prompt"], device)
    feed = torch.tensor(toks, dtype=torch.int64, device=device)
    g = serve.generate(params, cfg, prompts, sh["gen"], cache_len=sh["cache"],
                       feed=feed, device=device)
    logits = torch.stack(g.logits, dim=1).double()          # (B, gen, V)
    tol = SERVE_BF16_LOGIT_ULPS * bf16_ulp(float(logits.abs().max()))
    clear = _gap(logits) > 2 * tol
    check(bool(clear.any()) and torch.equal(g.tokens[clear], feed[clear]),
          f"pin {cfg.name}: argmax {g.tokens.cpu().tolist()} where the gap "
          f"is clear ({clear.cpu().tolist()}), the JAX package's {toks}")
    got = (float(logits.sum()), float(logits.abs().sum()))
    rtol = SERVE_BF16_PIN_RTOL * abs_total
    check(abs(got[0] - total) <= rtol and abs(got[1] - abs_total) <= rtol,
          f"pin {cfg.name}: checksums {got}, the JAX package's "
          f"{(total, abs_total)}")
    return {"argmax_compared": int(clear.sum()),
            "argmax_total": int(clear.numel()),
            "argmax_equal_all": bool(torch.equal(g.tokens, feed)),
            "logit_tol": tol, "sum": got[0], "abs_sum": got[1],
            "jax_sum": total, "jax_abs_sum": abs_total}


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


# ------------------------------------------------------- phase train
def train_launches(cfg, m: int, leaves: int, int8: bool) -> dict:
    """One scan step's launches on the cuda backend (remat "none"), from
    the code of ``ComposedOptimizer._step_kernels`` that the step runs: B1
    and B2 (dense) or B5 and B6 (int8) once a leaf; B14 with its
    log-sum-exp and the flash backward once a layer a worker."""
    from repro_torch.kernels import common
    want = {name: 0 for name in common.KERNELS}
    if int8:
        want.update(int8_stats_batched=leaves, fused_int8_step=leaves)
    else:
        want.update(censor_delta_sqnorm_batched=leaves,
                    fused_dense_step=leaves)
    want.update(flash_attention=m * cfg.num_layers,
                flash_attention_bwd=m * cfg.num_layers)
    return want


class _StepWatch:
    """Wraps the scan step that ``train`` builds: CUDA events and the
    launch counts around every step. It reads nothing from the card
    inside a step, so the events time the step alone."""

    def __init__(self, distributed):
        self.dist = distributed
        self.events, self.launches, self.launchers = [], [], []

    def __enter__(self):
        from repro_torch.kernels import common
        make = self.dist.make_scan_step

        def make_watched(*a, **kw):
            step = make(*a, **kw)

            def watched(*args):
                before = dict(common.LAUNCHES)
                before_l = dict(common.LAUNCHERS)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = step(*args)
                end.record()
                self.events.append((start, end))
                self.launches.append({k: common.LAUNCHES[k] - before[k]
                                      for k in before})
                self.launchers.append(
                    {k: c - before_l.get(k, 0)
                     for k, c in common.LAUNCHERS.items()
                     if c != before_l.get(k, 0)})
                return out
            return watched

        self.saved = make
        self.dist.make_scan_step = make_watched
        return self

    def __exit__(self, *exc):
        self.dist.make_scan_step = self.saved
        return False

    def ms(self) -> list:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


class _DecisionWatch:
    """Records each eq.-(8) decision's dsq / (eps1 ssq), worker by worker.
    It reads the norms to the host inside the step, so it wraps only the
    untimed steps."""

    def __init__(self):
        self.ratios = []

    def __enter__(self):
        from repro_torch.opt import censor
        self.mod, self.saved = censor, censor.transmit_mask

        def decide_watched(dsq, ssq, eps1):
            thr = eps1 * float(ssq)
            if thr > 0:
                self.ratios.append([float(x) / thr for x in dsq])
            return self.saved(dsq, ssq, eps1)

        censor.transmit_mask = decide_watched
        return self

    def __exit__(self, *exc):
        self.mod.transmit_mask = self.saved
        return False

    def min_margin(self) -> float:
        return min((abs(r - 1.0) for rs in self.ratios for r in rs),
                   default=float("inf"))


def _leaf_rel_diff(a_tree, b_tree) -> float:
    """max over leaves of max|a - b| / max|b|."""
    worst = 0.0
    for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)):
        scale = float(b.abs().max())
        diff = float((a.double() - b.double()).abs().max())
        worst = max(worst, diff / scale if scale > 0 else diff)
    return worst


def _same_step(tag, out_c, out_r) -> dict:
    """One scan step on both backends from one state: masks, transmitted
    and counters equal; params and ghat within TRAIN_RTOL."""
    (p_c, s_c, m_c), (p_r, s_r, m_r) = out_c, out_r
    check(torch.equal(s_c.comm.uplink_count, s_r.comm.uplink_count)
          and s_c.comm.uplink_bytes_exact() == s_r.comm.uplink_bytes_exact()
          and float(m_c["transmitted"]) == float(m_r["transmitted"]),
          f"{tag}: masks or counters differ: "
          f"{s_c.comm.uplink_count.tolist()} {s_r.comm.uplink_count.tolist()}")
    rel = {"params": _leaf_rel_diff(p_c, p_r),
           "ghat": _leaf_rel_diff(s_c.ghat, s_r.ghat)}
    if s_c.err != ():
        rel["err"] = _leaf_rel_diff(s_c.err, s_r.err)
    for what in ("params", "ghat"):
        check(rel[what] <= TRAIN_RTOL,
              f"{tag}: {what} differ by {rel[what]} of the leaf's largest")
    for key in ("loss", "step_sqnorm", "agg_grad_sqnorm"):
        a, b = float(m_c[key]), float(m_r[key])
        check(math.isfinite(a) and abs(a - b) <= TRAIN_RTOL * abs(b),
              f"{tag}: {key} {a} against {b}")
    return {"uplinks": s_c.comm.uplink_count.tolist(),
            "transmitted": float(m_c["transmitted"]),
            "loss_cuda": float(m_c["loss"]),
            "loss_reference": float(m_r["loss"]),
            "rel_diff": rel}


def phase_train(device) -> dict:
    """``train.trainer.train`` of chb-paper-lm-124m at full width on the
    cuda backend (TRAIN_STEPS chb steps; int8 one step), then one state's
    first and second steps on both backends. Returns the main runs'
    launch counts."""
    import dataclasses

    from repro_torch.core import distributed
    from repro_torch.data import lm_data
    from repro_torch.kernels import common
    from repro_torch.models import model
    from repro_torch.train import trainer
    cfg = get_config(LM_ARCH)
    tc = trainer.TrainConfig(**TRAIN_TC, steps=TRAIN_STEPS, log_every=1)
    leaves = len(LM_LEAVES)
    tokens = tc.global_batch * tc.seq_len
    out, launches = {}, {}
    for run, change in (("chb", {}), ("chb_int8", {"quantize": "int8",
                                                   "steps": 1})):
        rtc = dataclasses.replace(tc, **change)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        common.reset_launches()
        t0 = time.perf_counter()
        with _StepWatch(distributed) as watch:
            params, state, hist = trainer.train(cfg, rtc, verbose=False,
                                                device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        total = dict(common.LAUNCHES)
        ms = watch.ms()
        n = sum(x.numel() for x in tree_leaves(params))
        check(n == FULL_D, f"train {run}: {n} parameters")
        want = train_launches(cfg, tc.num_workers, leaves,
                              rtc.quantize == "int8")
        check(len(watch.launches) == rtc.steps, f"train {run}: steps")
        for t, got in enumerate(watch.launches):
            check(got == want, f"train {run} step {t}: launches "
                  f"{ {k: c for k, c in got.items() if c} }, want "
                  f"{ {k: c for k, c in want.items() if c} }")
        check(total == {k: rtc.steps * c for k, c in want.items()},
              f"train {run}: launches {total}")
        check(len(hist) == rtc.steps and all(
            math.isfinite(h[k]) for h in hist
            for k in ("loss", "step_sqnorm", "agg_grad_sqnorm")),
            f"train {run}: history {hist}")
        check(int(state.step) == rtc.steps
              and int(state.comm.total_uplinks) == hist[-1]["comms"],
              f"train {run}: counters")
        launches[f"train_{run}"] = total
        med = statistics.median(ms[1:]) if len(ms) > 1 else ms[0]
        out[run] = {"steps": rtc.steps, "ms_steps": ms,
                    "ms_per_step": med, "tokens_per_s": tokens / med * 1e3,
                    "wall_s": wall,
                    "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                    "loss": [h["loss"] for h in hist],
                    "transmitted": [h["transmitted"] for h in hist],
                    "comms": hist[-1]["comms"],
                    "launches_per_step": {k: c for k, c in want.items()
                                          if c}}
        del params, state
    # cuda against reference from one state: the first step from the
    # initial state, the second from the cuda backend's state after it
    o = trainer.make_optimizer(tc)
    params0 = model.init_params(PRNGKey(tc.seed, device=device), cfg)
    state0 = distributed.init_scan_state(o, params0)
    data = lm_data.batch_iterator(cfg, global_batch=tc.global_batch,
                                  seq_len=tc.seq_len,
                                  num_workers=tc.num_workers, seed=tc.seed,
                                  device=device)
    steps = {backend: distributed.make_scan_step(
        o, lambda p, b, be=backend: model.train_loss(
            p, cfg, b, remat=tc.remat, backend=be)[0], backend=backend)
        for backend in ("cuda", "reference")}
    compare = {}
    state_in = (params0, state0)
    for t in range(2):
        batch = next(data)
        with _DecisionWatch() as watch:
            out_c = steps["cuda"](*state_in, batch)
            out_r = steps["reference"](*state_in, batch)
        compare[f"step{t}"] = {**_same_step(f"train step {t}", out_c, out_r),
                               "ratios_dsq_over_threshold": watch.ratios,
                               "min_margin": watch.min_margin()}
        state_in = out_c[:2]
        del out_r
    del params0, state0, state_in, out_c
    torch.cuda.empty_cache()
    for run, r in out.items():
        print(f"train {run}: {r['ms_per_step']:.2f} ms a step "
              f"({r['ms_steps']}), {r['tokens_per_s']:.0f} tokens/s, peak "
              f"{r['peak_gib']:.2f} GiB", flush=True)
    emit({"phase": "train", "arch": LM_ARCH, "params": FULL_D,
          "tokens_per_step": tokens, "config": TRAIN_TC,
          "rtol": TRAIN_RTOL, "tf32": torch.backends.cuda.matmul.allow_tf32,
          **out, "cuda_vs_reference": compare})
    return launches


class _DsqWatch:
    """Records each eq.-(8) decision's (dsq, threshold eps1 * ssq) and,
    wrapping ``core.distributed._worker_grads``, the norm of the
    difference between two backends' eq.-(8) deltas of each worker,
    ||bf16(g_a - ghat) - bf16(g_b - ghat)||: the first call of a lockstep
    step keeps its gradient banks, the second measures against them and
    drops them. Reads to the host inside the step: untimed steps only."""

    def __init__(self, distributed):
        self.dist = distributed
        self.decisions, self.delta_diff, self.kept = [], None, None

    def __enter__(self):
        from repro_torch.opt import censor
        self.censor, self.saved_mask = censor, censor.transmit_mask
        self.saved_grads = self.dist._worker_grads

        def decide_watched(dsq, ssq, eps1):
            self.decisions.append(([float(x) for x in dsq],
                                   eps1 * float(ssq)))
            return self.saved_mask(dsq, ssq, eps1)

        def grads_watched(loss_fn, leaves, treedef, batch, banks):
            loss_sum, grads = self.saved_grads(loss_fn, leaves, treedef,
                                               batch, banks)
            if self.kept is None:
                self.kept = grads
                return loss_sum, grads
            sq = [0.0] * banks[0].shape[0]
            for ga, gb, h in zip(self.kept, grads, banks):
                fa, fb, fh = (x.reshape(x.shape[0], -1) for x in (ga, gb, h))
                for s in _chunks(fh.shape[1]):
                    for m in range(len(sq)):
                        # bf16 - bf16 in PyTorch: f32, one rounding (B1's
                        # delta)
                        diff = (fa[m, s] - fh[m, s]).float() \
                            - (fb[m, s] - fh[m, s]).float()
                        sq[m] += float(torch.sum(diff * diff,
                                                 dtype=torch.float64))
            self.delta_diff, self.kept = [math.sqrt(x) for x in sq], None
            return loss_sum, grads

        censor.transmit_mask = decide_watched
        self.dist._worker_grads = grads_watched
        return self

    def __exit__(self, *exc):
        self.censor.transmit_mask = self.saved_mask
        self.dist._worker_grads = self.saved_grads
        self.kept = None
        return False


def _chunks(n: int, size: int = 1 << 24):
    """Slices of [0, n) of ``size`` elements: a leaf's f32 temporaries a
    chunk at a time (a bf16 leaf of 10^9 elements would need 4 GB each)."""
    return [slice(i, min(i + size, n)) for i in range(0, n, size)]


def dsq_bound(dsq: float, e: float) -> float:
    """The most that two computations of one worker's eq.-(8) norm can
    differ by when one is ||d_b||^2 = dsq and their deltas differ by e =
    ||d_a - d_b||: | ||d_a||^2 - ||d_b||^2 | <= e (2 ||d_b|| + e), plus
    each f32 sum's own SQNORM_RTOL."""
    return e * (2 * math.sqrt(dsq) + e) + 2 * SQNORM_RTOL * dsq


# phase train_bf16: the dense bf16 configs trained at their published
# widths (d, heads, head dim, d_ff, vocab; tied embeddings) through B14
# bf16 with its log-sum-exp, flash_attention_bwd_bf16 and the bf16 CHB
# step (B1/B2 bf16; int8: B5/B6 bf16), init_params(PRNGKey(0)) in bf16,
# the bank in the params' dtype (core.distributed.init_scan_state, as the
# JAX package's makes it), TRAIN_TC but for the batch. Depth is cut to fit
# the card's 80 GB: a step holds params, prev_params, the (M, ...) bank
# and gradient bank and, while the fused step runs out of place, the new
# bank, the f32 worker sum and the new params: 17 copies of the weights in
# bf16 (dense, M = 4), 25 with int8's err and new err. qwen3-4b: 16 of 36
# layers for chb (2,003,851,776 parameters; 62.75 GiB at peak on an H100
# 80GB HBM3), 10 for the int8 step (1,398,266,880; at 8 layers its peak
# was 56.45 GiB, 23.6 copies, so 16 layers would need about 94 GB),
# TRAIN_TC's 16 x 256 tokens; gemma3-12b: one "SSSSSA" superblock, 6 of 48 layers
# (1,997,590,272), 4 x 2048 tokens, so that its "S" layers' 1024-key
# window masks. The parameter counts are the JAX package's param_count of
# the cut configs (tests/test_torch_train_bf16.py).
TRAIN_BF16 = {
    "qwen3-4b": {"tc": {}, "runs": {
        "chb": {"num_layers": 16, "params": 2_003_851_776, "steps": 3},
        "chb_int8": {"num_layers": 10, "params": 1_398_266_880, "steps": 1,
                     "quantize": "int8"}}},
    "gemma3-12b": {"tc": {"global_batch": 4, "seq_len": 2048}, "runs": {
        "chb": {"num_layers": 6, "params": 1_997_590_272, "steps": 2}}},
}
# cuda against reference from one state (the first step, then the second
# from the cuda backend's state), both on the card: the same widths cut
# shallower, since two steps' outputs, the input state and both backends'
# gradient banks (_DsqWatch) are alive at once (about 22 copies of the
# weights): qwen3-4b at 4 layers, gemma3-12b at one "S" and one "A" layer.
# At these widths the workers' dsq / (eps1 ssq) lie within a few percent
# of each other, and the backends' deltas differ by about as much (at
# TRAIN_TC's eps1_scale 8, qwen3-4b's second step left the four workers
# margins |dsq - eps1 ssq| of 1.6 to 4.1 against dsq_bounds of 3.9 to 4.1
# on an H100): no eps1 splits them with room to spare, so each lockstep
# step runs at its own eps1_scale (TRAIN_BF16_LOCKSTEP_EPS1_SCALES), where
# every decision clears its bound: step 0 sends every worker (ssq is 0),
# step 1 at a quarter of TRAIN_TC's scale sends every worker (dsq near 4
# eps1 ssq), step 2 at 8 times it censors every worker (dsq near eps1
# ssq / 8), so both branches of the bf16 step (a sent worker's ghat' is its
# gradient; a censored one's keeps its ghat and its counter) are held
# against reference; the main runs censor at eps1_scale 8
TRAIN_BF16_LOCKSTEP_EPS1_SCALES = (2.0, 2.0, 64.0)
TRAIN_BF16_LOCKSTEP = {
    "qwen3-4b": {"num_layers": 4},
    "gemma3-12b": {"num_layers": 2, "layer_pattern": "SA", "scan_period": 2},
}
# the bank's bound between the backends, in bf16 ulps of each leaf's
# largest |ghat'|: BASE + one a layer. ghat' is each transmitting worker's
# bf16 gradient; the backends part only in the attention (B14 and the
# backward against their blocked plain versions), whose outputs may round
# to the other bf16 neighbour, and the cotangent carries such flips
# through every layer of the backward. tests/test_torch_train_bf16.py
# measures the same carry between the port and the JAX package (every op,
# not only the attention) at 2 and 4 layers: at most 4.5 ulps, within its
# bound of 4 + one a layer, which this takes over
TRAIN_BF16_GHAT_ULPS_BASE = 4
# the backends' losses (f32 means of per-token terms from bf16 logits)
# within this share of the loss: one bf16 ulp relative
TRAIN_BF16_LOSS_RTOL = 2.0 ** -8


def train_bf16_config(arch: str, **cut):
    """``arch``'s config with its depth cut (``cut``: num_layers, and where
    the pattern changes layer_pattern and scan_period), widths as
    published."""
    import dataclasses
    return dataclasses.replace(get_config(arch), **cut).validate()


def _bf16_lockstep(arch, cfg, tc, device,
                   scales=TRAIN_BF16_LOCKSTEP_EPS1_SCALES) -> dict:
    """One state's first step on both backends, then each later step from
    the cuda backend's state, step t at eps1_scale ``scales[t]``: each worker's eq.-(8) margin
    |dsq - eps1 ssq| above dsq_bound of its delta difference (asserted),
    then masks, transmitted and counters equal, and over the steps at
    least one sent and one censored decision compared; each leaf of ghat' within
    (TRAIN_BF16_GHAT_ULPS_BASE + layers) bf16 ulps of its largest |ghat'|,
    and each element of theta' within BF16_EQ4_UNITS bf16 unit roundoffs
    of the magnitudes of eq. (4)'s terms (B2 runs eq. (4) in f32 and rounds
    once, the reference backend rounds each of its operations to bf16:
    Lockstep's rule) plus alpha M times the bank's bound (the worker sums
    differ by at most M times it); losses within TRAIN_BF16_LOSS_RTOL."""
    from repro_torch.core import distributed
    from repro_torch.data import lm_data
    from repro_torch.models import model
    from repro_torch.train import trainer
    import dataclasses
    opts = {e: trainer.make_optimizer(dataclasses.replace(tc, eps1_scale=e))
            for e in scales}
    o = opts[scales[0]]
    params0 = model.init_params(PRNGKey(tc.seed, device=device), cfg)
    state0 = distributed.init_scan_state(o, params0)
    data = lm_data.batch_iterator(cfg, global_batch=tc.global_batch,
                                  seq_len=tc.seq_len,
                                  num_workers=tc.num_workers, seed=tc.seed,
                                  device=device)
    steps = {(e, backend): distributed.make_scan_step(
        o_e, lambda p, b, be=backend: model.train_loss(
            p, cfg, b, remat=tc.remat, backend=be)[0], backend=backend)
        for e, o_e in opts.items() for backend in ("cuda", "reference")}
    ulps = TRAIN_BF16_GHAT_ULPS_BASE + cfg.num_layers
    out, state_in = {}, (params0, state0)
    sent = censored = 0
    del params0, state0
    for t, e in enumerate(scales):
        theta_in, prev_in = state_in[0], state_in[1].prev_params
        batch = next(data)
        with _DsqWatch(distributed) as watch:
            out_c = steps[e, "cuda"](*state_in, batch)
            out_r = steps[e, "reference"](*state_in, batch)
        (p_c, s_c, m_c), (p_r, s_r, m_r) = out_c, out_r
        (dsq_c, thr), (dsq_r, thr_r) = watch.decisions
        check(thr == thr_r and watch.delta_diff is not None,
              f"train_bf16 {arch} step {t}: thresholds {thr} {thr_r}")
        bounds = [dsq_bound(x, e) for x, e in zip(dsq_r, watch.delta_diff)]
        margins = [abs(x - thr) for x in dsq_r]
        check(all(mg > bd for mg, bd in zip(margins, bounds)),
              f"train_bf16 {arch} step {t}: a decision too close to call: "
              f"margins {margins}, bounds {bounds}, dsq {dsq_r}, threshold "
              f"{thr}")
        check(torch.equal(s_c.comm.uplink_count, s_r.comm.uplink_count)
              and s_c.comm.uplink_bytes_exact()
              == s_r.comm.uplink_bytes_exact()
              and float(m_c["transmitted"]) == float(m_r["transmitted"]),
              f"train_bf16 {arch} step {t}: masks or counters differ: "
              f"{s_c.comm.uplink_count.tolist()} "
              f"{s_r.comm.uplink_count.tolist()}")
        worst = {"ghat": 0.0, "params": 0.0}
        for a, b_, pa, pb, t_, tp in zip(*(tree_leaves(x) for x in (
                s_c.ghat, s_r.ghat, p_c, p_r, theta_in, prev_in))):
            m_w = b_.shape[0]
            fa, fb = a.reshape(m_w, -1), b_.reshape(m_w, -1)
            ft, ftp, fpa, fpb = (x.reshape(-1) for x in (t_, tp, pa, pb))
            parts = _chunks(ft.numel())
            top = max(float(fb[:, s].abs().max()) for s in parts)
            g_bound = ulps * bf16_ulp(top) if top > 0 else 0.0
            g_diff = max(float((fa[:, s].float() - fb[:, s].float()).abs()
                               .max()) for s in parts)
            p_share = 0.0
            for s in parts:
                t32, tp32 = ft[s].float(), ftp[s].float()
                p_bound = BF16_EQ4_UNITS * 2.0 ** -8 * (
                    t32.abs() + o.alpha * fb[:, s].float().sum(dim=0).abs()
                    + o.beta * (t32 - tp32).abs()) \
                    + o.alpha * o.num_workers * g_bound
                p_share = max(p_share, float(
                    ((fpa[s].float() - fpb[s].float()).abs()
                     / p_bound.clamp_min(ATTN_FLOOR)).max()))
            check(g_diff <= g_bound and p_share <= 1.0,
                  f"train_bf16 {arch} step {t}: a leaf's ghat' differs by "
                  f"{g_diff} (bound {g_bound}), theta' by {p_share} of its "
                  "bound")
            worst["ghat"] = max(worst["ghat"], g_diff / g_bound
                                if g_bound else 0.0)
            worst["params"] = max(worst["params"], p_share)
        lc, lr = float(m_c["loss"]), float(m_r["loss"])
        check(math.isfinite(lc) and abs(lc - lr) <= TRAIN_BF16_LOSS_RTOL
              * abs(lr), f"train_bf16 {arch} step {t}: loss {lc} against "
              f"{lr}")
        n_sent = int(float(m_r["transmitted"]))
        sent, censored = sent + n_sent, censored + len(dsq_r) - n_sent
        out[f"step{t}"] = {
            "eps1_scale": e,
            "uplinks": s_c.comm.uplink_count.tolist(),
            "transmitted": float(m_c["transmitted"]),
            "loss_cuda": lc, "loss_reference": lr,
            "dsq_over_threshold": [x / thr if thr else None for x in dsq_r],
            "margins": margins, "bounds": bounds,
            "delta_diff": watch.delta_diff,
            "worst_share_of_bound": worst}
        state_in = out_c[:2]
        del out_r, p_r, s_r, p_c, s_c, out_c, theta_in, prev_in
        gc.collect()
    check(sent > 0 and censored > 0,
          f"train_bf16 {arch}: the lockstep compared {sent} sent and "
          f"{censored} censored decisions, want both")
    del state_in, steps
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": cfg.num_layers, "layer_pattern": cfg.layer_pattern,
            "params": sum(math.prod(x.shape) for x in tree_leaves(
                init_params(PRNGKey(0, device="cpu"), cfg, device="meta"))),
            "ghat_ulps": ulps, **out}


def phase_train_bf16(device, card: str) -> dict:
    """``train.trainer.train`` of qwen3-4b and gemma3-12b in bf16 at their
    published widths, depth cut (TRAIN_BF16), on the cuda backend: each
    step's launches the scan step's (train_launches) and every launcher a
    bf16 build (B14 bf16 with its log-sum-exp and flash_attention_bwd_bf16
    once a layer a worker, B1/B2 or B5/B6 bf16 once a leaf), finite
    losses, CUDA events around every step, peak device memory; then
    _bf16_lockstep at TRAIN_BF16_LOCKSTEP. Returns each run's launch counts
    by kernel (its launchers go to LAUNCHERS_BY_PATH)."""
    import dataclasses

    from repro_torch.core import distributed
    from repro_torch.kernels import common
    from repro_torch.train import trainer
    t0 = time.perf_counter()
    out, launches = {}, {}
    for arch, spec in TRAIN_BF16.items():
        base = trainer.TrainConfig(**{**TRAIN_TC, **spec["tc"]},
                                   log_every=1)
        res = {"published_layers": get_config(arch).num_layers,
               "config": {**TRAIN_TC, **spec["tc"]}}
        for run, r in spec["runs"].items():
            cfg = train_bf16_config(arch, num_layers=r["num_layers"])
            rtc = dataclasses.replace(base, steps=r["steps"],
                                      quantize=r.get("quantize"))
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            common.reset_launches()
            t = time.perf_counter()
            with _StepWatch(distributed) as watch:
                params, state, hist = trainer.train(cfg, rtc, verbose=False,
                                                    device=device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            leaves = tree_leaves(params)
            n = sum(x.numel() for x in leaves)
            check(n == r["params"] and all(x.dtype == torch.bfloat16
                                           for x in leaves)
                  and all(x.dtype == torch.bfloat16
                          for x in tree_leaves(state.ghat)),
                  f"train_bf16 {arch} {run}: {n} parameters, want "
                  f"{r['params']}, params and bank in bf16")
            want = train_launches(cfg, rtc.num_workers, len(leaves),
                                  rtc.quantize == "int8")
            check(len(watch.launches) == rtc.steps,
                  f"train_bf16 {arch} {run}: steps")
            for s_i, (got, got_l) in enumerate(zip(watch.launches,
                                                   watch.launchers)):
                per_kernel: dict[str, int] = {}
                for launcher, c in got_l.items():
                    k = kernel_of(launcher)
                    per_kernel[k] = per_kernel.get(k, 0) + c
                check(got == want and all(
                    x.endswith("_bf16") for x in got_l)
                    and per_kernel == {k: c for k, c in want.items() if c}
                    and got_l.get("flash_attention_bf16")
                    == got_l.get("flash_attention_bwd_bf16")
                    == rtc.num_workers * cfg.num_layers,
                    f"train_bf16 {arch} {run} step {s_i}: launches "
                    f"{ {k: c for k, c in got.items() if c} }, launchers "
                    f"{got_l}, want {want}")
            check(len(hist) == rtc.steps and all(
                math.isfinite(h[k]) for h in hist
                for k in ("loss", "step_sqnorm", "agg_grad_sqnorm")),
                f"train_bf16 {arch} {run}: history {hist}")
            check(int(state.step) == rtc.steps
                  and int(state.comm.total_uplinks) == hist[-1]["comms"],
                  f"train_bf16 {arch} {run}: counters")
            path = f"train_bf16_{arch}_{run}"
            launches[path] = {k: rtc.steps * c for k, c in want.items()}
            LAUNCHERS_BY_PATH[path] = {}
            for got_l in watch.launchers:
                for k, c in got_l.items():
                    LAUNCHERS_BY_PATH[path][k] = \
                        LAUNCHERS_BY_PATH[path].get(k, 0) + c
            ms = watch.ms()
            med = statistics.median(ms[1:]) if len(ms) > 1 else ms[0]
            tokens = rtc.global_batch * rtc.seq_len
            res[run] = {
                "layers": cfg.num_layers, "params": n, "steps": rtc.steps,
                "ms_steps": ms, "ms_per_step": med,
                "ms_per_step_is": "median after the first" if len(ms) > 1
                else "the one step (the first)",
                "tokens_per_step": tokens,
                "tokens_per_s": tokens / med * 1e3, "wall_s": wall,
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                "loss": [h["loss"] for h in hist],
                "transmitted": [h["transmitted"] for h in hist],
                "comms": hist[-1]["comms"],
                "launches_per_step": {k: c for k, c in want.items() if c},
                "launchers_per_step": watch.launchers[-1]}
            print(f"train_bf16 {arch} {run} ({cfg.num_layers} layers): "
                  f"{med:.2f} ms a step ({ms}), "
                  f"{res[run]['tokens_per_s']:.0f} tokens/s, peak "
                  f"{res[run]['peak_gib']:.2f} GiB, loss "
                  f"{res[run]['loss']}", flush=True)
            emit({"phase": "train_bf16_run", "arch": arch, "run": run,
                  "config": res["config"], **res[run], "card": card})
            del params, state, leaves
        gc.collect()
        torch.cuda.empty_cache()
        res["cuda_vs_reference"] = _bf16_lockstep(
            arch, train_bf16_config(arch, **TRAIN_BF16_LOCKSTEP[arch]),
            base, device)
        emit({"phase": "train_bf16_lockstep", "arch": arch,
              "eps1_scales": TRAIN_BF16_LOCKSTEP_EPS1_SCALES,
              **res["cuda_vs_reference"], "card": card})
        out[arch] = res
    emit({"phase": "train_bf16", "tf32": False,
          "bf16_reduced_precision_reduction":
          torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
          "card": card, **out,
          "seconds": time.perf_counter() - t0})
    return launches


def phase_train_cli() -> None:
    """``python -m repro_torch.launch.train --steps 2`` in a subprocess: the
    CLI at full width on the card, exit 0, a finite loss a logged step."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--steps", "2"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("step")]
    losses = [float(re.search(r"loss=(\S+)", ln).group(1)) for ln in lines]
    check(proc.returncode == 0 and len(losses) == 2
          and all(math.isfinite(x) for x in losses),
          f"train_cli: rc {proc.returncode}, stdout {proc.stdout[-2000:]}, "
          f"stderr {proc.stderr[-2000:]}")
    emit({"phase": "train_cli", "argv": ["--steps", "2"], "lines": lines,
          "seconds": time.perf_counter() - t0})


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


def _grids_a_call(fn):
    """The device kernels one call of ``fn`` runs, by name, as
    ``torch.profiler`` records them after one warm-up call; None where the
    profiler records no device kernel (no CUPTI)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [evt.name for evt in prof.events()
             if evt.device_type == DeviceType.CUDA]
    if not names:
        return None
    return {"grids": len(names),
            "names": sorted({re.sub(r"\(anonymous namespace\)::", "",
                                    n).split("(")[0] for n in names})}


# the fed mesh's shapes of phase 6: M of B10 and B11 (n = MANY_D, f64),
# and of fold_workers and B1, up to the ladder's 10^6 clients
TALL_MS = (MANY_M_STAGED, MANY_M)
FOLD_MS = (MANY_M, 1_000_000)
# the per-worker kernels fed_mesh_timing also times at M in TALL_MS
TALL_WORKER_KERNELS = ("censor_bank_advance", "int8_stats_batched",
                       "absmax_batched", "quantize_ef_batched",
                       "sqnorm_batched", "bank_advance")


def fed_mesh_timing(device, m=MANY_M, n=MANY_D) -> dict:
    """The fed mesh's shapes (n = 16, f64): B2 and B6 at M = 100,000, the
    design the wrapper picks and the one-pass design, with the shape's
    byte bound and the floor of an exact fold there (one thread's M - 1
    dependent f64 adds, ``benchmarks_torch/chain_floor.py``);
    fold_workers at M in FOLD_MS on both designs, its plain version
    (``sum_leading``, M - 1 eager adds) and ``torch.sum``, against the
    same floor; B1 on both designs at M in FOLD_MS and each side of
    ``common.sqnorm_path``'s worker threshold, with its plain version and
    byte bound; B10 (tiled like B2's tall pass 1) and B11 (a thread a
    column walking the M workers) at M in TALL_MS, and the
    TALL_WORKER_KERNELS there (tall_worker_timing). Returns
    ``{kernel: {...}}``."""
    from benchmarks_torch.chain_floor import chain_floor_ms
    from repro_torch.core.quantize import int8_scale
    from repro_torch.kernels import (censor, common, fused_step, lowrank_ef,
                                     ref, topk_pack)
    from repro_torch.kernels.build import REDUCE_CHUNK
    floors = {mm: chain_floor_ms(mm) for mm in sorted({m, *FOLD_MS})}
    floor = floors[m]
    gen = torch.Generator(device=device).manual_seed(23)
    sms = common.sm_count(device.index or 0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float64)

    def alternating(mm):
        return torch.tensor([1.0, 0.0] * (mm // 2) + [1.0] * (mm % 2),
                            device=device)

    g, h, e = randn(m, n), randn(m, n), randn(m, n) * 0.01
    t, p = randn(n), randn(n)
    mask = alternating(m)
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
    path = common.fold_path(m, n, sms)
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

    out["fold_workers"] = {}
    for mm in FOLD_MS:
        x = randn(mm, n)
        fpath = common.fold_path(mm, n, sms)
        check(same_bits(fused_step.fold_workers(x), ref.fold_workers(x)),
              f"fold_workers M={mm} n={n}")
        ms = _time_ms(lambda: fused_step.fold_on_card(x, fpath), 10)
        nbytes = (mm + 1) * n * el
        chain = floors[mm]["f64"]
        out["fold_workers"][f"M={mm}"] = {
            "shape": f"M={mm} n={n} float64", "path": fpath, "ms": ms,
            "one_pass_ms": _time_ms(
                lambda: fused_step.fold_on_card(x, "one_pass"), 3),
            # M - 1 eager adds: about 10 s a call at 10^6, timed at 10^5
            "plain_ms": (_time_ms(lambda: ref.fold_workers(x), 1)
                         if mm <= MANY_M else None),
            "library_ms": _time_ms(lambda: torch.sum(x, dim=0), 10),
            "bytes": nbytes, "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "chain_floor_ms": chain, "bound_ms": max(
                nbytes / HBM_BYTES_PER_S * 1e3, chain),
            "ms_over_bound": ms / max(nbytes / HBM_BYTES_PER_S * 1e3,
                                      chain)}
        del x
    # B1 on both designs: the fed mesh's M, and each side of sqnorm_path's
    # worker threshold on rows of 16 and of one full reduction chunk
    out["censor_delta_sqnorm_batched"] = {}
    t = common.warp_rows_min_workers(sms)
    for mm, nn in [*((mm, n) for mm in FOLD_MS), (t, n), (t + 1, n),
                   (t, REDUCE_CHUNK), (t + 1, REDUCE_CHUNK)]:
        x, y = randn(mm, nn), randn(mm, nn)
        nbytes = 2 * mm * nn * el + 4 * mm
        out["censor_delta_sqnorm_batched"][f"M={mm} n={nn}"] = {
            "shape": f"M={mm} n={nn} float64",
            "path": common.sqnorm_path(mm, nn, sms),
            "ms": {d: _time_ms(lambda: censor.delta_sqnorm_on_card(x, y, d),
                               10) for d in censor.SQNORM_PATHS},
            "plain_ms": _time_ms(
                lambda: ref.censor_delta_sqnorm_batched(x, y), 3),
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        del x, y
    # B10 (tiled over workers and columns) and B11 (a thread a column
    # walks all M rows) at the tall shapes
    for name in ("select_pack_ef_batched", "residual_ef_batched"):
        out[name] = {}
    for mm in TALL_MS:
        pend, q, err = randn(mm, n), randn(mm, n), randn(mm, n) * 0.01
        keep = (randn(mm, n) > 0.2533).to(torch.float64)
        msk = alternating(mm)
        for name, run, plain, nbytes in (
                ("select_pack_ef_batched",
                 lambda: topk_pack.select_pack_ef_batched(pend, err, keep,
                                                          msk),
                 lambda: ref.select_pack_ef_batched(pend, err, keep, msk),
                 5 * mm * n * el + 4 * mm),
                ("residual_ef_batched",
                 lambda: lowrank_ef.residual_ef_batched(pend, q, err, msk),
                 lambda: ref.residual_ef_batched(pend, q, err, msk),
                 4 * mm * n * el + 4 * mm)):
            out[name][f"M={mm}"] = {
                "shape": f"M={mm} n={n} float64",
                "ms": _time_ms(run, 10), "plain_ms": _time_ms(plain, 3),
                "bytes": nbytes,
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        del pend, q, err, keep, msk
    torch.cuda.empty_cache()
    out.update(tall_worker_timing(device, randn, alternating, n))
    emit({"phase": "fed_mesh_timing",
          "chain_floor_ms": {f"M={mm}": f for mm, f in floors.items()},
          **out})
    return out


def tall_worker_timing(device, randn, alternating, n=MANY_D) -> dict:
    """B4, B5, B7a, B7b, B8 and B9 at M in TALL_MS, n = 16, f64: each one's
    time (B5, B8 and B7a on both designs, the one ``common.sqnorm_path``
    picks named; B9, B4 and B7b on their one design, B10's tall tiling),
    its plain
    version's, its library call's where one computes the same function
    (phase_timing's), and its byte bound. Returns
    ``{kernel: {"M=...": {...}}}``."""
    from repro_torch.core.quantize import int8_scale
    from repro_torch.kernels import censor, common, fused_step, quantize_ef, ref
    sms = common.sm_count(device.index or 0)
    el = 8                                              # f64 bytes
    out = {name: {} for name in TALL_WORKER_KERNELS}
    for mm in TALL_MS:
        g, h, e = randn(mm, n), randn(mm, n), randn(mm, n) * 0.01
        pend = (g - h) + e
        mask = alternating(mm)
        mw = mask.to(torch.float64)[:, None]     # the library calls' weight
        scale = int8_scale(ref.absmax_batched(pend))
        work = {   # name: (kernel by design, plain, library or None, bytes)
            "int8_stats_batched": (
                {d: (lambda d=d: fused_step.int8_stats_on_card(g, h, e, d))
                 for d in censor.SQNORM_PATHS},
                lambda: ref.int8_stats_batched(g, h, e), None,
                3 * mm * n * el + (4 + el) * mm),
            "sqnorm_batched": (
                {d: (lambda d=d: censor.sqnorm_on_card(pend, d))
                 for d in censor.SQNORM_PATHS},
                lambda: ref.sqnorm_batched(pend),
                lambda: torch.linalg.vecdot(pend, pend),
                mm * n * el + 4 * mm),
            "censor_bank_advance": (
                {"tall": lambda: censor.censor_bank_advance(g, h, mask)},
                lambda: ref.censor_bank_advance(g, h, mask),
                lambda: torch.lerp(h, g, mw), 3 * mm * n * el + 4 * mm),
            "bank_advance": (
                {"tall": lambda: censor.bank_advance(h, pend, mask)},
                lambda: ref.bank_advance(h, pend, mask),
                lambda: torch.addcmul(h, mw, pend), 3 * mm * n * el + 4 * mm),
            "absmax_batched": (
                {d: (lambda d=d: quantize_ef.absmax_on_card(pend, d))
                 for d in censor.SQNORM_PATHS},
                lambda: ref.absmax_batched(pend),
                lambda: torch.linalg.vector_norm(pend, ord=math.inf, dim=1),
                mm * n * el + el * mm),
            "quantize_ef_batched": (
                {"tall": lambda: quantize_ef.quantize_ef_batched(
                    pend, e, mask, scale)},
                lambda: ref.quantize_ef_batched(pend, e, mask, scale), None,
                4 * mm * n * el + 8 * mm),
        }
        for name, (designs, plain, lib, nbytes) in work.items():
            picked = (common.sqnorm_path(mm, n, sms) if len(designs) > 1
                      else next(iter(designs)))
            out[name][f"M={mm}"] = {
                "shape": f"M={mm} n={n} float64", "path": picked,
                "ms": {d: _time_ms(fn, 10) for d, fn in designs.items()},
                "plain_ms": _time_ms(plain, 3),
                "library_ms": None if lib is None else _time_ms(lib, 10),
                "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        del g, h, e, pend, mask, mw, scale
        torch.cuda.empty_cache()
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
        # torch.sum groups the workers otherwise (not its bits): a time
        "fold_workers": (
            lambda: fused_step.fold_workers(g),
            lambda: ref.fold_workers(g),
            lambda: torch.sum(g, dim=0),
            (m + 1) * d * el, (m - 1) * d),
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
                   if c[name] and path not in SUB_F32_PATHS}
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
            **({"port_only": True} if name in PORT_ONLY else {}),
            **({"fed_mesh": fed[name]} if name in fed else {})})
        torch.cuda.empty_cache()
    del g, h, e, t, p, keep, pend, nab
    torch.cuda.empty_cache()
    sub = bf16_timing_rows(device, d, m)
    sub_f32_launches(sub, launches)
    return rows + sub + model_timing_rows(device, launches, max_err, d)


#: the paths on sub-f32 banks (phases full, edge and mesh), of bf16 params
#: and of f32 params on a bf16 bank: their launches go to the sub-f32 rows
#: of the kernels line, by launcher (LAUNCHERS_BY_PATH), and not to the
#: f32 rows
SUB_F32_PATHS = (
    "dense_bf16bank", "int8_bf16bank", "dense_staged_bf16bank",
    "shard_dense_bf16bank", "per_tensor_bf16bank", "int8_staged_bf16bank",
    "shard_int8_bf16bank", "topk_bf16bank", "lowrank_bf16bank",
    "edge_bf16bank", "mesh_bf16bank", "dense_bf16", "int8_bf16",
    "dense_staged_bf16", "shard_dense_bf16", "per_tensor_bf16",
    "int8_staged_bf16", "shard_int8_bf16", "topk_bf16", "lowrank_bf16")
#: each sub-f32 path's launches per C launcher (``common.LAUNCHERS``),
#: read just after the path's cuda run
LAUNCHERS_BY_PATH: dict[str, dict[str, int]] = {}


def kernel_of(launcher: str) -> str:
    """The kernel (``common.KERNELS``) a C launcher builds."""
    from repro_torch.kernels import common
    return max((k for k in common.KERNELS if launcher.startswith(k + "_")),
               key=len)


def row_of(launcher: str, rows) -> str:
    """The sub-f32 row that counts ``launcher``'s launches: its own, else
    (a design or err build timed by no row of its own) its kernel's row of
    the default design (``_warp``, ``_tall`` dropped) with err in the bank
    dtype (B5's and B6's ``_f32_bf16_f32``, err f32 in the first step on
    f32 params, counts under ``_f32_bf16``). Raises if neither is a row."""
    if launcher in rows:
        return launcher
    base = launcher.replace("_warp_", "_").replace("_tall_", "_")
    if base.endswith("_f32_bf16_f32"):
        base = base[:-len("_f32")]
    check(base in rows, f"kernels line: launcher {launcher} has no row")
    return base


def sub_f32_launches(rows: list, launches: dict) -> None:
    """Fill each sub-f32 row's launches from the launcher counts of the
    sub-f32 paths' runs: ``launches_by_launcher`` the counts of the
    launchers it stands for (row_of), ``launches_by_path`` their sum per
    path, ``launches`` the total. Fails unless every sub-f32 path was read
    per launcher and its launcher counts add up to its kernel counts."""
    names = {r["name"] for r in rows}
    for r in rows:
        r["launches_by_path"], r["launches_by_launcher"] = {}, {}
    by_name = {r["name"]: r for r in rows}
    for path in SUB_F32_PATHS:
        check(path in launches and path in LAUNCHERS_BY_PATH,
              f"kernels line: no launch counts of path {path}")
        per_kernel: dict[str, int] = {}
        for launcher, c in LAUNCHERS_BY_PATH[path].items():
            if not c:
                continue
            k = kernel_of(launcher)
            per_kernel[k] = per_kernel.get(k, 0) + c
            r = by_name[row_of(launcher, names)]
            r["launches_by_path"][path] = r["launches_by_path"].get(path,
                                                                    0) + c
            r["launches_by_launcher"][launcher] = \
                r["launches_by_launcher"].get(launcher, 0) + c
        want = {k: c for k, c in launches[path].items() if c}
        check(per_kernel == want, f"kernels line: {path}'s launcher counts "
              f"{per_kernel} are not its kernel counts {want}")
    for r in rows:
        r["launches"] = sum(r["launches_by_path"].values())


def _bf16_row(name, row, kfn, pfn, lfn, nbytes, ops, shape,
              **extra) -> dict:
    """One sub-f32 row of the kernels line: the largest absolute difference
    from the plain version on its finite entries in this run, the kernel's,
    the plain version's and the library call's ms and the bound; its
    launches come from sub_f32_launches."""
    got, want = kfn(), pfn()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(max_diff(a[torch.isfinite(b)], b[torch.isfinite(b)])
              for a, b in zip(got, want))
    del got, want
    ms = _time_ms(kfn, 10)
    plain_ms = _time_ms(pfn, 3)
    library_ms = None if lfn is None else _time_ms(lfn, 10)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOPS * 1e3
    src, replaces = KERNEL_META[name]
    torch.cuda.empty_cache()
    return {"name": row, "route": "cuda", "source": src,
            "replaces": replaces, "launches": None,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, "bytes": nbytes, "shape": shape,
            **extra}


def bf16_timing_rows(device, d=FULL_D, m=FULL_M) -> list:
    """B1-B6, B8, B9 and the worker fold at the full-width shape on a bf16
    bank, of bf16 params (``_bf16``) and of f32 params (``_f32_bf16``, err
    in bf16 as after the first step; B4's g, B9's payload and B3's theta
    f32), B8 and the fold on a bf16 leaf; B8's warp design and the fold's
    tall one at the fed mesh's shape: time, plain version, library call
    in bf16 where one computes the same function, bound from the bytes each
    reads and writes once (launches: sub_f32_launches), and the
    largest absolute difference from the plain version in this run (B1's,
    B5's and B8's sums in another order; the rest bit for bit)."""
    from repro_torch.core.quantize import int8_scale
    from repro_torch.kernels import (censor, fused_step, hb_update,
                                     quantize_ef, ref)
    gen = torch.Generator(device=device).manual_seed(7)
    mask = torch.tensor([1.0, 0.0] * (m // 2) + [1.0] * (m % 2),
                        device=device)
    h_dt = torch.bfloat16

    def randn(*shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)

    rows = []
    for suffix, p_dt in (("bf16", torch.bfloat16),
                         ("f32_bf16", torch.float32)):
        g, h = randn(m, d, dtype=p_dt), randn(m, d, dtype=h_dt)
        e = randn(m, d, dtype=h_dt, scale=0.01)
        t, p = randn(d, dtype=p_dt), randn(d, dtype=p_dt)
        scale = int8_scale(ref.int8_stats_batched(g, h, e)[1])
        agg = h[0]
        mk = mask[:, None].to(h_dt)
        same = p_dt == h_dt        # a library call takes one dtype
        sp, sh = g.element_size(), h.element_size()
        shape = f"M={m} n={d} params {p_dt} bank bfloat16"
        work = {  # name: (kernel, plain, library, bytes moved, operations)
            "censor_delta_sqnorm_batched": (
                lambda: censor.censor_delta_sqnorm_batched(g, h),
                lambda: ref.censor_delta_sqnorm_batched(g, h), None,
                m * d * (sp + sh) + 4 * m, 3 * m * d),
            "fused_dense_step": (
                lambda: fused_step.fused_dense_step(g, h, t, p, mask, 0.1,
                                                    0.4),
                lambda: ref.fused_dense_step(g, h, t, p, mask, 0.1, 0.4),
                None, m * d * (sp + 2 * sh) + d * (3 * sp + sh) + 4 * m,
                (4 * m + 5) * d),
            "int8_stats_batched": (
                lambda: fused_step.int8_stats_batched(g, h, e),
                lambda: ref.int8_stats_batched(g, h, e), None,
                m * d * (sp + 2 * sh) + (4 + sh) * m, 6 * m * d),
            "fused_int8_step": (
                lambda: fused_step.fused_int8_step(g, h, e, t, p, mask, scale,
                                                   0.1, 0.4),
                lambda: ref.fused_int8_step(g, h, e, t, p, mask, scale, 0.1,
                                            0.4), None,
                m * d * (sp + 4 * sh) + d * (3 * sp + sh) + 8 * m,
                (16 * m + 5) * d),
            "hb_update": (
                lambda: hb_update.hb_update(t, agg, p, 0.1, 0.4),
                lambda: ref.hb_update(t, agg, p, 0.1, 0.4), None,
                d * (3 * sp + sh), 5 * d),
            "censor_bank_advance": (
                lambda: censor.censor_bank_advance(g, h, mask),
                lambda: ref.censor_bank_advance(g, h, mask),
                # rounds otherwise (one rounding, h + 1*(g - h) is not g)
                (lambda: torch.lerp(h, g, mk)) if same else None,
                m * d * (sp + 2 * sh) + 4 * m, 3 * m * d),
            "bank_advance": (
                lambda: censor.bank_advance(h, g, mask),
                lambda: ref.bank_advance(h, g, mask),
                (lambda: torch.addcmul(h, mk, g)) if same else None,
                m * d * (sp + 2 * sh) + 4 * m, 2 * m * d),
        }
        if same:     # B8 and the fold take the bf16 leaf of either pair
            work["sqnorm_batched"] = (
                lambda: censor.sqnorm_batched(h),
                lambda: ref.sqnorm_batched(h),
                lambda: torch.linalg.vecdot(h, h), m * d * sh + 4 * m,
                2 * m * d)
            # torch.sum groups the workers otherwise (not its bits): a time
            work["fold_workers"] = (
                lambda: fused_step.fold_workers(h),
                lambda: ref.fold_workers(h),
                lambda: torch.sum(h, dim=0), (m + 1) * d * sh, (m - 1) * d)
        for name, (kfn, pfn, lfn, nbytes, ops) in work.items():
            rows.append(_bf16_row(name, f"{name}_{suffix}", kfn, pfn, lfn,
                                  nbytes, ops, shape))
        del g, h, e, t, p, scale, agg, mk, work
        torch.cuda.empty_cache()
    rows += stateful_bf16_rows(randn, mask, d, m)
    # the other designs of B8, B7a and the fold, at the fed mesh's shape
    mm, nn = MANY_M, MANY_D
    x = randn(mm, nn, dtype=h_dt)
    shape = f"M={mm} n={nn} bfloat16"
    rows.append(_bf16_row(
        "absmax_batched", "absmax_batched_warp_bf16",
        lambda: quantize_ef.absmax_on_card(x, "warp"),
        lambda: ref.absmax_batched(x),
        lambda: torch.linalg.vector_norm(x, ord=math.inf, dim=1),
        mm * nn * 2 + 2 * mm, 2 * mm * nn, shape, design="warp"))
    rows.append(_bf16_row(
        "sqnorm_batched", "sqnorm_batched_warp_bf16",
        lambda: censor.sqnorm_on_card(x, "warp"),
        lambda: ref.sqnorm_batched(x), lambda: torch.linalg.vecdot(x, x),
        mm * nn * 2 + 4 * mm, 2 * mm * nn, shape,
        design="warp"))
    rows.append(_bf16_row(
        "fold_workers", "fold_workers_tall_bf16",
        lambda: fused_step.fold_on_card(x, "tall"),
        lambda: ref.fold_workers(x), lambda: torch.sum(x, dim=0),
        (mm + 1) * nn * 2, (mm - 1) * nn, shape, design="tall",
        # the fold is a chain of M - 1 dependent adds a column
        floor="chain of M - 1 dependent f32 adds (chain_floor.py)"))
    del x
    torch.cuda.empty_cache()
    return rows


def stateful_bf16_rows(randn, mask, d=FULL_D, m=FULL_M) -> list:
    """B7a, B7b, B10 and B11 at the full-width shape on a bf16 pending
    leaf, err (and B11's payload) in bf16 and in f32: the rows of
    bf16_timing_rows. B7a's library call is torch.linalg.vector_norm(inf)
    in bf16; the other three have none."""
    from repro_torch.core.quantize import int8_scale
    from repro_torch.kernels import (common, lowrank_ef, quantize_ef, ref,
                                     topk_pack)
    bf16 = torch.bfloat16
    pend = randn(m, d, dtype=bf16)
    keep = (randn(m, d, dtype=torch.float32) > 0.2533).to(bf16)
    scale = int8_scale(ref.absmax_batched(pend))
    shape = f"M={m} n={d} pending bfloat16"
    rows = [_bf16_row(
        "absmax_batched", "absmax_batched_bf16",
        lambda: quantize_ef.absmax_batched(pend),
        lambda: ref.absmax_batched(pend),
        lambda: torch.linalg.vector_norm(pend, ord=math.inf, dim=1),
        m * d * 2 + 2 * m, 2 * m * d, shape)]
    for e_dt in STATEFUL_ERRS:
        e = randn(m, d, dtype=e_dt, scale=0.01)
        se, suf = e.element_size(), "" if e_dt == bf16 else "_f32"
        etag = f"{shape} err {e_dt}"
        rows.append(_bf16_row(
            "quantize_ef_batched", f"quantize_ef_batched_bf16{suf}",
            lambda: quantize_ef.quantize_ef_batched(pend, e, mask, scale),
            lambda: ref.quantize_ef_batched(pend, e, mask, scale), None,
            m * d * (6 + se) + 8 * m, 9 * m * d, etag))
        rows.append(_bf16_row(
            "select_pack_ef_batched", f"select_pack_ef_batched_bf16{suf}",
            lambda: topk_pack.select_pack_ef_batched(pend, e, keep, mask),
            lambda: ref.select_pack_ef_batched(pend, e, keep, mask), None,
            m * d * (8 + se) + 4 * m, 5 * m * d, etag))
        for q_dt in STATEFUL_ERRS:
            q = randn(m, d, dtype=q_dt)
            sq = q.element_size()
            suffix = common.EF_DTYPES["residual_ef_batched"][(bf16, q_dt,
                                                              e_dt)]
            rows.append(_bf16_row(
                "residual_ef_batched", f"residual_ef_batched_{suffix}",
                lambda: lowrank_ef.residual_ef_batched(pend, q, e, mask),
                lambda: ref.residual_ef_batched(pend, q, e, mask), None,
                m * d * (4 + sq + se) + 4 * m, 5 * m * d,
                f"{etag} payload {q_dt}"))
            del q
        del e
    del pend, keep, scale
    torch.cuda.empty_cache()
    return rows


def model_timing_rows(device, launches, max_err, d=FULL_D) -> list:
    """B12a and B12b at n = d in f32; B13 at serve_long's last decode step
    and B14 at its prefill (batch 8, 12 heads, head dim 64, the model's
    strided views), also with its log-sum-exp there and at training's
    shape (with its bound and SDPA's forward there); the flash backward at
    training's shape (one worker's 4 x 256 tokens, 12 heads of 64, causal)
    beside its plain version and SDPA's autograd backward. Bounds count
    what these inputs need: B12b reads only the side it selects, B14 the
    causal band's products, the backward the band's five products (s
    again, dp, dq, dk, dv)."""
    import torch.nn.functional as F

    from repro_torch.kernels import (censor, decode_attention,
                                     flash_attention, flash_backward, ref)
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
    # training's shape: a worker's chunk of the global batch
    tb, tl = TRAIN_TC["global_batch"] // TRAIN_TC["num_workers"], \
        TRAIN_TC["seq_len"]
    tq, tk, tv, tdo = (randn(tb, tl, nh, hd).transpose(1, 2)
                       for _ in range(4))
    to, tlse = flash_attention.flash_attention(tq, tk, tv, return_lse=True)
    sq_, sk_, sv_ = (x.detach().clone().requires_grad_()
                     for x in (tq, tk, tv))
    sdpa = F.scaled_dot_product_attention(sq_, sk_, sv_, is_causal=True)
    tpairs = tl * (tl + 1) // 2
    operand = tb * nh * tl * hd * 4               # bytes of q (or k, v, o)
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
        # reads q, k, v, o, dO and lse, writes dq, dk and dv
        "flash_attention_bwd": (
            lambda: flash_backward.flash_attention_bwd(tq, tk, tv, to, tlse,
                                                       tdo),
            lambda: ref.flash_attention_bwd(tq, tk, tv, to, tlse, tdo),
            lambda: torch.autograd.grad(sdpa, (sq_, sk_, sv_), tdo,
                                        retain_graph=True),
            8 * operand + tb * nh * tl * 4, 10 * tb * nh * tpairs * hd,
            f"B={tb} H=K={nh} L={tl} d={hd} float32, causal (one worker's "
            "chunk of training's batch)"),
    }
    # B14 with its log-sum-exp (training's forward) beside its time
    with_lse = {
        "serve_long_prefill": _time_ms(lambda: flash_attention.flash_attention(
            q, k, v, causal=True, return_lse=True), 10),
        "train_shape": _time_ms(lambda: flash_attention.flash_attention(
            tq, tk, tv, causal=True, return_lse=True), 10),
        "train_shape_without": _time_ms(
            lambda: flash_attention.flash_attention(tq, tk, tv, causal=True),
            10)}
    # B14 at training's shape (192 of its launches in phase train): its
    # bound there (four products of the causal band) and SDPA's forward
    t_bytes, t_ops = 4 * operand, 4 * tb * nh * tpairs * hd
    b14_train = {
        "ms": with_lse["train_shape_without"],
        "ms_with_lse": with_lse["train_shape"],
        "bound_ms": max(t_bytes / HBM_BYTES_PER_S, t_ops / F32_FLOPS) * 1e3,
        "bound_by": "bytes" if t_bytes / HBM_BYTES_PER_S
        >= t_ops / F32_FLOPS else "operations",
        "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
            tq, tk, tv, is_causal=True), 10),
        "bytes": t_bytes, "operations": t_ops,
        "shape": f"B={tb} H=K={nh} L={tl} d={hd} float32, causal"}
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
            "bytes": nbytes, "operations": ops_, "shape": shape,
            **({"port_only": True} if name in PORT_ONLY else {}),
            **({"ms_with_lse": with_lse, "train_shape": b14_train}
               if name == "flash_attention" else {}),
            # the CUDA grids one call runs behind its one count, as the
            # profiler sees them in this run
            **({"grids_a_call": _grids_a_call(kfn)}
               if name == "flash_attention_bwd" else {})})
        torch.cuda.empty_cache()
    return rows


# the H100 SXM's dense bf16 tensor-core rate (NVIDIA data sheet): the
# bound of the bf16 attention rows is their products at this rate, the
# least time the card could take for them (B14 runs them on the tensor
# cores, with P V as two products; B13 as f32 FMAs on the CUDA cores)
BF16_FLOPS = 989e12


def _valid_pairs(l: int, window) -> int:
    """The (query, key) pairs of a causal L x L mask, banded by ``window``
    (kpos > qpos - window)."""
    w = l if window is None else min(window, l)
    return w * (w + 1) // 2 + (l - w) * w


def attention_bf16_rows(device, launches) -> list:
    """B14 and B13 in bf16 at the dense bf16 configs' serve_long shapes,
    the first of each list in the row and the others under ``at``: B14 at
    the full prefill (batch 8, L 2048: qwen3-4b causal at head dim 128;
    gemma3-12b at 256, causal and window 1024), B13 at the last decode
    step (slot 2078 of 2081; gemma3's "S" ring of 1024 slots wrapped). Each
    with its largest difference from the plain version, the plain
    version's time, bf16 SDPA's on the same (B, H, L, d) views (k and v
    expanded to H heads before the clock), and the bound: bytes read and
    written once at HBM_BYTES_PER_S, or the products of the valid pairs at
    BF16_FLOPS, the larger. ``launches`` are phase serve_bf16's counts."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention, flash_attention, ref
    from repro_torch.models.kvcache import slot_positions
    gen = torch.Generator(device=device).manual_seed(19)
    run = SERVE_RUNS["serve_long"]
    b, l = run["batch"], run["prompt"]
    c_full, pos = l + run["gen"] + 1, l + run["gen"] - 2
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(bf)

    def timed(kfn, pfn, lfn, nbytes, ops_, shape):
        got, want = kfn(), pfn()
        err = max_diff(got, want)
        del got, want
        ms, plain_ms, library_ms = (_time_ms(kfn, 10), _time_ms(pfn, 3),
                                    _time_ms(lfn, 10))
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops_ / BF16_FLOPS * 1e3
        torch.cuda.empty_cache()
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": library_ms, "bytes": nbytes,
                "operations": ops_, "shape": shape}

    def flash_case(arch, h, kh, d, window):
        q = randn(b, l, h, d).transpose(1, 2)
        k, v = (randn(b, l, kh, d).transpose(1, 2) for _ in range(2))
        ke, ve = (x.repeat_interleave(h // kh, dim=1) for x in (k, v))
        mask = None
        if window is not None:
            i = torch.arange(l, device=device)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None]
                                                 - window)
        return timed(
            lambda: flash_attention.flash_attention(q, k, v, causal=True,
                                                    window=window),
            lambda: ref.flash_attention_fwd(q, k, v, causal=True,
                                            window=window),
            lambda: F.scaled_dot_product_attention(
                q, ke, ve, attn_mask=mask, is_causal=mask is None),
            2 * (2 * b * h * l * d + 2 * b * kh * l * d),
            4 * b * h * _valid_pairs(l, window) * d,
            f"{arch}: B={b} H={h} K={kh} L={l} d={d} bfloat16, causal"
            + ("" if window is None else f", window {window}"))

    def decode_case(arch, h, kh, d, c):
        q = randn(b, h, d)
        kc, vc = (randn(b, c, kh, d) for _ in range(2))
        kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
        ke, ve = (x.repeat_interleave(h // kh, dim=1) for x in (kt, vt))
        cpos = slot_positions(pos + 1, c, device)
        valid = (cpos >= 0) & (cpos <= pos)
        n_valid = int(valid.sum())
        return timed(
            lambda: decode_attention.decode_attention(q, kt, vt, cpos, pos),
            lambda: ref.decode_attention_ref(q, kt, vt, cpos, pos),
            lambda: F.scaled_dot_product_attention(
                q[:, :, None], ke, ve, attn_mask=valid[None, None, None]),
            2 * (2 * b * c * kh * d + 2 * b * h * d) + 4 * c,
            4 * b * h * n_valid * d,
            f"{arch}: B={b} H={h} K={kh} C={c} d={d} bfloat16, pos={pos}")

    cases = {
        "flash_attention": [
            lambda: flash_case("qwen3-4b", 32, 8, 128, None),
            lambda: flash_case("gemma3-12b 'A'", 16, 8, 256, None),
            lambda: flash_case("gemma3-12b 'S'", 16, 8, 256, 1024)],
        "decode_attention": [
            lambda: decode_case("qwen3-4b", 32, 8, 128, c_full),
            lambda: decode_case("gemma3-12b 'A'", 16, 8, 256, c_full),
            lambda: decode_case("gemma3-12b 'S' ring", 16, 8, 256, 1024)],
    }
    rows = []
    for name, fns in cases.items():
        first, *rest = (fn() for fn in fns)
        src, replaces = KERNEL_META[name]
        by_path = {path: cnt[name] for path, cnt in launches.items()
                   if cnt[name]}
        rows.append({"name": f"{name}_bf16", "route": "cuda",
                     "source": src, "replaces": replaces,
                     "launches": sum(by_path.values()), **first,
                     "launches_by_path": by_path, "at": rest})
    return rows


def train_bf16_timing(device) -> tuple:
    """At phase train_bf16's attention shapes (one worker's chunk:
    qwen3-4b's 4 x 256 tokens, H 32, K 8, d 128, causal; gemma3-12b's 1 x
    2048, H 16, K 8, d 256, causal and window 1024): the row of
    ``flash_attention_bwd_bf16`` (qwen3-4b's shape in the row, gemma3's
    under ``at``) with its largest difference from its plain version, its
    plain version's time, bf16 SDPA's autograd backward on the same views
    (k and v expanded to H heads before the clock, as leaves: it returns
    per-head dk and dv, which the kernel sums over each group) and its
    bound: the band's five products (s again, dp, dq, dk, dv) at
    BF16_FLOPS, what the card could do for this work on its tensor cores,
    or the bytes read and written once, the larger, with the share of it
    the kernel reaches, the scratch its plan allocates and the device
    kernels a call runs (``_grids_a_call``); and B14 bf16 with and
    without its log-sum-exp at the same shapes beside bf16 SDPA's forward,
    with its bound (four products of the band at BF16_FLOPS). Launches
    come from phase train_bf16 (add_path_launches)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, flash_backward, ref
    gen = torch.Generator(device=device).manual_seed(23)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(bf)

    bwd, fwd = [], []
    for arch, b, h, kh, l, d, window in (
            ("qwen3-4b", 4, 32, 8, 256, 128, None),
            ("gemma3-12b 'A'", 1, 16, 8, 2048, 256, None),
            ("gemma3-12b 'S'", 1, 16, 8, 2048, 256, 1024)):
        q, do = (randn(b, l, h, d).transpose(1, 2) for _ in range(2))
        k, v = (randn(b, l, kh, d).transpose(1, 2) for _ in range(2))
        o, lse = flash_attention.flash_attention(q, k, v, window=window,
                                                 return_lse=True)
        sq = q.detach().clone().requires_grad_()
        ske, sve = (x.repeat_interleave(h // kh, dim=1).detach()
                    .requires_grad_() for x in (k, v))
        mask = None
        if window is not None:
            i = torch.arange(l, device=device)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None]
                                                 - window)
        sdpa = F.scaled_dot_product_attention(sq, ske, sve, attn_mask=mask,
                                              is_causal=mask is None)
        pairs = _valid_pairs(l, window)
        shape = (f"{arch}: B={b} H={h} K={kh} L={l} d={d} bfloat16, causal"
                 + ("" if window is None else f", window {window}"))
        kw = {"window": window}

        def kfn():
            return flash_backward.flash_attention_bwd(q, k, v, o, lse, do,
                                                      **kw)

        def pfn():
            return ref.flash_attention_bwd(q, k, v, o, lse, do, **kw)

        got, want = kfn(), pfn()
        err = max(max_diff(a, b_) for a, b_ in zip(got, want))
        del got, want
        layout = flash_backward.plan(b, h, kh, l, l, d, True, window, bf)
        # reads q, k, v, o, dO and lse, writes dq, dk and dv
        nbytes = 2 * (3 * b * h * l * d + 2 * b * kh * l * d) + 4 * b * h * l \
            + 2 * (b * h * l * d + 2 * b * kh * l * d)
        ops_ = 10 * b * h * pairs * d
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, \
            ops_ / BF16_FLOPS * 1e3
        ms = _time_ms(kfn, 10)
        bwd.append({
            "max_abs_err": err, "ms": ms, "plain_ms": _time_ms(pfn, 3),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "pct_of_bound": 100 * max(bytes_ms, ops_ms) / ms,
            "library_ms": _time_ms(lambda: torch.autograd.grad(
                sdpa, (sq, ske, sve), do, retain_graph=True), 10),
            "bytes": nbytes, "operations": ops_, "shape": shape,
            "scratch_bytes": layout.scratch_bytes,
            "grids_a_call": _grids_a_call(kfn)})
        f_bytes = 2 * (2 * b * h * l * d + 2 * b * kh * l * d) + 4 * b * h * l
        f_ops = 4 * b * h * pairs * d
        fwd.append({
            "shape": shape,
            "ms_with_lse": _time_ms(lambda: flash_attention.flash_attention(
                q, k, v, window=window, return_lse=True), 10),
            "ms": _time_ms(lambda: flash_attention.flash_attention(
                q, k, v, window=window), 10),
            "bound_ms": max(f_bytes / HBM_BYTES_PER_S,
                            f_ops / BF16_FLOPS) * 1e3,
            "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
                q, ske.detach(), sve.detach(), attn_mask=mask,
                is_causal=mask is None), 10)})
        del q, k, v, o, lse, do, sq, ske, sve, sdpa
        torch.cuda.empty_cache()
    src, replaces = KERNEL_META["flash_attention_bwd"]
    row = {"name": "flash_attention_bwd_bf16", "route": "cuda",
           "source": src, "replaces": replaces, "launches": 0,
           **bwd[0], "port_only": True, "at": bwd[1:],
           "launches_by_path": {}, "launches_by_launcher": {}}
    return row, fwd


def add_path_launches(rows: list, launches: dict) -> None:
    """Add the launches of more sub-f32 paths (``launches``: each path's
    counts by kernel; LAUNCHERS_BY_PATH: by launcher) to the rows of their
    launchers (row_of), as sub_f32_launches does; fails unless each path's
    launcher counts add up to its kernel counts."""
    names = {r["name"] for r in rows}
    by_name = {r["name"]: r for r in rows}
    for path, counts in launches.items():
        check(path in LAUNCHERS_BY_PATH,
              f"kernels line: no launcher counts of path {path}")
        per_kernel: dict[str, int] = {}
        for launcher, c in LAUNCHERS_BY_PATH[path].items():
            k = kernel_of(launcher)
            per_kernel[k] = per_kernel.get(k, 0) + c
            r = by_name[row_of(launcher, names)]
            for key, sub in (("launches_by_path", path),
                             ("launches_by_launcher", launcher)):
                r.setdefault(key, {})
                r[key][sub] = r[key].get(sub, 0) + c
            r["launches"] += c
        check(per_kernel == {k: c for k, c in counts.items() if c},
              f"kernels line: {path}'s launcher counts {per_kernel} are "
              f"not its kernel counts {counts}")


def main() -> None:
    t0 = time.perf_counter()
    card = phase_device()
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
    phase_staged_advance_paths(dev)
    phase_absmax_paths(dev)
    phase_fused_fold_paths(dev)
    phase_tall_paths(dev)
    phase_fused_bf16_banks(dev)
    phase_staged_bf16_banks(dev)
    phase_stateful_bf16_banks(dev)
    phase_attention_kernels(dev, max_err)
    phase_golden(dev)
    flat, setup_s = full_task(dev)
    launches = phase_full(flat, setup_s)
    launches.update(phase_many_workers())
    launches.update(phase_mesh(dev))
    launches.update(phase_edge(dev, flat))
    launches.update(phase_sweep(dev, flat))
    del flat
    launches.update(phase_serve(dev))
    serve_bf16 = phase_serve_bf16(dev)
    phase_pin(dev)
    launches["ops"] = phase_ops(dev)
    launches.update(phase_train(dev))
    train_bf16 = phase_train_bf16(dev, card)
    phase_train_cli()
    rows = phase_timing(dev, launches, max_err)
    rows += attention_bf16_rows(dev, serve_bf16)
    bwd_bf16, b14_train = train_bf16_timing(dev)
    rows.append(bwd_bf16)
    next(r for r in rows if r["name"] == "flash_attention_bf16")[
        "train_shapes"] = b14_train
    add_path_launches(rows, train_bf16)
    check(len(KERNEL_META) == 18 and len(rows) == 18 + 8 + 10 + 10 + 3,
          f"{len(rows)} kernel rows")
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
