#!/usr/bin/env python3
"""B14, B13, B9, B4, B7a, B7b, B2, B6, B10 and the flash backward of two
source trees, side by side on one card, and the bits of their sums B1, B5
and B8.

    python3 benchmarks_torch/kernel_ab.py --other <dir> [<dir> ...]
        [--only B14 B14bf16 B13 B9 B4 B7a B7b sums fused B10 bwd]
        [--ablate] [--reps 10]

Each ``<dir>`` holds another checkout of this repository (for example the
parent commit, unpacked with ``git archive`` into a directory that
``.gitignore`` lists). The script compiles ``flash_attention.cu`` (B14),
``censor.cu`` (B9; B1 and B8), ``quantize_ef.cu`` (B7a) and
``fused_step.cu`` (B5) of every tree with the port's nvcc flags into
``build/kernel_ab/``, prints each compiler log (``-Xptxas -v``), checks
each tree's B9 and B7a bits (B7a NaN where its plain version gives NaN)
and B14 against the f64 rule of ``chip_smoke.py`` on a few shapes (and
whether its bits are this tree's), B9 and
B7a also on tall banks up to M = 100,000 (it stops if this tree's fail
and reports the others'), then times all at the main path's shapes in
turns (the others, this, this, the others in reverse) beside their
library calls (timed first and last): B14 at serve_long's prefill (B 8, H = K 12, L 2048, d 64,
causal, the model's strided views) against
``scaled_dot_product_attention``; ``B14bf16`` B14 in bf16 at the dense
bf16 configs' serve_long prefill (B 8, L 2048: qwen3-4b's H 32, K 8, d 128
causal; gemma3-12b's 16/8 at d 256, causal and at window 1024) against
bf16 SDPA (k and v expanded to H heads, the window as a mask), after the
f64 rule on a few bf16 shapes; ``B13`` B13 in f32 at chb-paper-lm-124m's
last serve_long step (B 8, H = K 12, C 2081, d 64: each tree's bits must
be this tree's) and in bf16 at qwen3-4b's and gemma3-12b's (C 2081, and
gemma3's 1024-slot ring), after the f64 rule, against SDPA; a tree's
bf16 B14 gets the 16-byte copy flag where its launcher takes it (one probe
call tells) and its B13 the chunks its library plans where it exports
``decode_attention_bf16_chunk``; B9 at M = 4, n = 163,597,056 f32 and
at the fed mesh's M = 70,000 and 100,000, n = 16 (f64) against
``addcmul``, B7a at the same shapes against ``linalg.vector_norm(inf)``.
``B4`` and ``B7b`` check each tree's B4 (``censor_bank_advance``) and B7b
(``quantize_ef_batched``, with the scales of the plain abs-max) against
their plain versions bit for bit (NaN where NaN; -0.0, NaN and +-inf
salted) on aligned leaves and views one element off alignment, at M <= 9
and on tall banks, and stop if this tree's differ; then time both at B9's
shapes, B4 beside ``lerp`` (B7b has no library call).
Each tree runs the B7a launcher it has: this tree the design its wrapper
picks (``kernels/common.py:sqnorm_path``), a tree without the warp
design its two passes. ``sums`` checks that B1, B5 and B8 of this
tree give every other tree's bits at M = 4, n = 163,597,056 (f32) and at
M = 9, n = 70,001 (f32 and f64), and stops if they do not; then times the
three at M = 4, n = 163,597,056 (B8 beside ``linalg.vecdot``). ``fused``
checks that B2 and B6 of every tree give this tree's bits, and this
tree's the plain version's, at M = 4, n = 163,597,056 (f32), at the
fed-mesh shape M = 100,000, n = 16 (f64) and at M = 70,000, n = 2049
(f64, where the tall design's fold is fed by cp.async), and stops if they
do not; then times both at these shapes beside the floor of an exact
fold at the fed-mesh shape (one thread's M - 1 dependent adds,
``benchmarks_torch/chain_floor.py``). This tree runs the design its
wrapper picks (``kernels/common.py:fold_path``); another tree runs its
tall launchers where it has them and this tree picks the tall design,
else its one design. ``B10`` checks that B10 of every tree gives the
plain version's bits at M = 4, n = 163,597,056 (f32), at the fed mesh's
M = 70,000 and 100,000, n = 16 (f64) and on a few short banks, and stops
if it does not; then times it at the first three. ``bwd`` checks each
tree's flash backward (``flash_backward.cu``, from this tree's B14 output
and log-sum-exp) against the f64 rule of ``chip_smoke.py`` (dq, dk and
dv) and for the same bits over three calls on a few shapes (training's,
L = 2048, tile edges, GQA, a window, rows with no valid key, d = 80 and
256), and stops if this tree's fail; then times it at training's shape (B
4, H = K 12, L 256, d 64, causal) and at (1, 12, 12, 2048, 2048, 64)
beside SDPA's autograd backward, with each tree's device time a call by
grid (``torch.profiler``). A tree whose launcher takes a scratch pointer
gets a scratch of this tree's ``flash_backward.plan``; a tree without one
(before the key-tile design) runs as it is. One JSON line each,
and the card's name and power limit. Needs a CUDA card and nvcc.

A tree's B7a partial count is ceil(n / span), with the span its own
``kernels/build.py`` names (``ABSMAX_SPAN``; a tree without it uses one
partial per ``REDUCE_CHUNK``), read from the file's constants without
importing it.

``--ablate`` adds two B14 variants built from this tree's source, which
say where its time goes and are wrong by design (their checks report
``false``): ``no_mask`` treats every key tile as inside the band (no
per-score test), ``no_softmax`` also drops the online softmax (no max, no
exps, no shuffles; p = the scaled scores), leaving the two products, the
tile copies and the barriers. Under ``fused`` it adds ``fold_no_copy``,
this tree's B2/B6 whose narrow-bank fold copies nothing into its stages
(the chain of adds and the stage handovers alone, on whatever the shared
memory holds). For B7a, for B1, B8 and B5 under ``sums``, and for B2 and
B6 under ``fused``, it profiles each tree's call (``torch.profiler``) and
prints the device time of each of its kernels (pass 1, pass 2) a call
beside the call's time between CUDA events.
"""
from __future__ import annotations

import argparse
import ast
import ctypes
import functools
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from benchmarks_torch.chain_floor import chain_floor_ms  # noqa: E402
from chip_smoke import (ATTN_FACTOR, ATTN_FLOOR, FULL_D, LARGE_M,  # noqa: E402
                        MANY_D, MANY_M, MANY_M_STAGED, _decode_f64, _flash_f64, _time_ms,
                        flash_bwd_f64, same_bits, same_or_nan)
from repro_torch.core.quantize import int8_scale  # noqa: E402
from repro_torch.kernels import (build, common, decode_attention,  # noqa: E402
                                 flash_attention, flash_backward, ref)

OUT = ROOT / "build" / "kernel_ab"
# the sources each choice of --only compiles
SOURCES = {"B14": ("flash_attention",), "B14bf16": ("flash_attention",),
           "B13": ("decode_attention",), "B9": ("censor",),
           "B4": ("censor",), "B7a": ("quantize_ef",),
           "B7b": ("quantize_ef",), "sums": ("censor", "fused_step"),
           "fused": ("fused_step",), "B10": ("topk_pack",),
           "bwd": ("flash_backward",)}


def compile_tree(tag: str, csrc: Path, names) -> dict:
    """The sources ``names`` of one tree, one nvcc each, started
    together."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = OUT / f"{tag}_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
             str(csrc / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{tag} {name}.cu failed:\n{log}")
        (OUT / f"{tag}_{name}.log").write_text(log)
        print(f"--- nvcc {tag} {name}.cu\n{log}", file=sys.stderr)
        cdll = ctypes.CDLL(str(lib))
        for fn, argtypes in build.SIGNATURES[name].items():
            f = getattr(cdll, fn, None)      # an older tree may lack one
            if f is not None:
                f.argtypes = _tree_argtypes(csrc / f"{name}.cu", fn,
                                            argtypes)
                f.restype = ctypes.c_int
        libs[name] = cdll
    return libs


def _tree_argtypes(source: Path, fn: str, argtypes: tuple) -> tuple:
    """This tree's argtypes for ``fn``, or, where another tree's source
    defines B14's launchers without the lse pointer (trees before it
    existed) or the flash backward's without the scratch pointer (trees
    before the key-tile design), those launchers' shorter list."""
    found = re.search(rf"\bint {fn}\(([^)]*)\)", source.read_text())
    if not found or len(found.group(1).split(",")) != len(argtypes) - 1:
        return argtypes
    if fn == "flash_attention_bwd_f32":
        return argtypes[:10] + argtypes[11:]      # no scratch pointer
    if fn.startswith("flash_attention_"):
        return argtypes[:5] + argtypes[6:]        # no lse pointer
    return argtypes


def _takes_lse(lib) -> bool:
    return len(lib.flash_attention_f32.argtypes) == 9


# (variant, source, [(text of this tree's source, its replacement)])
ABLATIONS = (
    ("no_mask", "flash_attention", [("    const bool inside = k0 + kBK <= a.s",
                  "    const bool inside = true || k0 + kBK <= a.s")]),
    ("no_softmax", "flash_attention", [
        ("    const bool inside = k0 + kBK <= a.s",
         "    const bool inside = true || k0 + kBK <= a.s"),
        ("""    const float mn = maxval(m[i], mx);
    alpha[i] = expf(m[i] - mn);
    float rs = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[i][j] = expf(s[i][j] - mn);
      rs += s[i][j];
    }
#pragma unroll
    for (int off = kTX / 2; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
    l[i] = l[i] * alpha[i] + rs;
    m[i] = mn;""", """    alpha[i] = 1.0f;
    l[i] = 1.0f;"""),
        ("""#pragma unroll
    for (int off = kTX / 2; off > 0; off >>= 1)
      mx = maxval(mx, __shfl_xor_sync(0xffffffffu, mx, off));
""", "")]),
    ("fold_no_copy", "fused_step", [
        ("  mbar_expect(bar, bytes);\n  if (bytes) bulk_copy(buf, src, bytes, bar);",
         "  mbar_expect(bar, 0);")]),
)
# the source each choice of --only ablates
ABLATED = {"B14": "flash_attention", "fused": "fused_step"}


def ablated_trees(source: str) -> list[Path]:
    """This tree's ``source`` with each of its ablations applied, one
    directory each."""
    dirs = []
    text = (build.CSRC / f"{source}.cu").read_text()
    for name, src_name, edits in ABLATIONS:
        if src_name != source:
            continue
        src = text
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"kernel_ab: ablation {name} no longer "
                                 f"applies to {source}.cu")
            src = src.replace(old, new)
        csrc = OUT / "ablate" / name / "src/repro_torch/kernels/csrc"
        csrc.mkdir(parents=True, exist_ok=True)
        (csrc / f"{source}.cu").write_text(src)
        (csrc / "reduce.cuh").write_text(
            (build.CSRC / "reduce.cuh").read_text())
        dirs.append(OUT / "ablate" / name)
    return dirs


def run(lib, fn: str, device, *args) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib, fn)(device.index, *args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc}")


@functools.cache
def _bf16_copies(lib) -> bool:
    """Whether this tree's bf16 B14 takes the 16-byte copy flag: a
    launcher without the tensor-core design refuses it (a CUDA error
    before any launch), so one call on an aligned (1, 1, 8, 8) tensor
    tells."""
    x = torch.zeros((1, 1, 8, 8), dtype=torch.bfloat16, device="cuda")
    dims = (ctypes.c_int64 * 22)(1, 1, 1, 8, 8, 8, *x.stride(), *x.stride(),
                                 *x.stride(), 1, 0, 0, 1)
    lse = (None,) if _takes_lse(lib) else ()
    rc = lib.flash_attention_bf16(0, x.data_ptr(), x.data_ptr(),
                                  x.data_ptr(), torch.empty_like(x).data_ptr(),
                                  *lse, ctypes.addressof(dims), 1.0,
                                  torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    return rc == 0


def flash(libs, q, k, v, causal=True, window=None):
    b, h, lq, d = q.shape
    kh, s_len = k.shape[1], k.shape[2]
    out = torch.empty((b, h, lq, d), dtype=q.dtype, device=q.device)
    lib = libs["flash_attention"]
    # a tree whose launcher reads 21 entries ignores the 22nd (the copy
    # flag); a tree without the bf16 tensor-core design refuses it for bf16
    copy = flash_attention.copy_flag(q, k, v) \
        if q.dtype == torch.float32 or _bf16_copies(lib) else 0
    dims = (ctypes.c_int64 * 22)(
        b, h, kh, lq, s_len, d, *q.stride(), *k.stride(), *v.stride(),
        int(causal), int(window is not None),
        0 if window is None else int(window), copy)
    suffix = "f32" if q.dtype == torch.float32 else "bf16"
    # serving's call: a null lse pointer where the launcher takes one
    lse = (None,) if _takes_lse(lib) else ()
    run(lib, f"flash_attention_{suffix}", q.device, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), out.data_ptr(), *lse,
        ctypes.addressof(dims), float(d ** -0.5))
    return out


def decode(libs, q, k, v, cpos, pos):
    """One tree's B13: in bf16 the chunks its library plans, where it
    exports the plan (``decode_attention_bf16_chunk``), else its
    launcher's 32-slot partials."""
    b, h, d = q.shape
    kh, c = k.shape[1], k.shape[2]
    lib = libs["decode_attention"]
    if q.dtype == torch.bfloat16 and hasattr(lib,
                                             "decode_attention_bf16_chunk"):
        sizes = (ctypes.c_int64 * 5)(b, h, kh, c, d)
        got = ctypes.c_int64(0)
        if lib.decode_attention_bf16_chunk(q.device.index or 0,
                                           ctypes.addressof(sizes),
                                           ctypes.addressof(got)) != 0:
            raise RuntimeError("decode_attention_bf16_chunk failed")
        chunk, vec = got.value, int(decode_attention.cache_copy_ok(k, v))
    else:
        chunk, vec = 32, 0
    nchunks = -(-c // chunk)
    dev = q.device
    out = torch.empty((b, h, d), dtype=q.dtype, device=dev)
    part_ml = torch.empty((b * h, nchunks, 2), dtype=torch.float32,
                          device=dev)
    part_acc = torch.empty((b * h, nchunks, d), dtype=torch.float32,
                           device=dev)
    # a launcher that reads 18 entries ignores the last two
    dims = (ctypes.c_int64 * 20)(
        b, h, kh, c, d, *q.stride(), *k.stride(), *v.stride(), pos, nchunks,
        chunk, vec)
    suffix = "f32" if q.dtype == torch.float32 else "bf16"
    run(lib, f"decode_attention_{suffix}", dev,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cpos.data_ptr(),
        part_ml.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
        ctypes.addressof(dims), float(d ** -0.5))
    return out


def _suffix(x: torch.Tensor) -> str:
    return "f32" if x.dtype == torch.float32 else "f64"


def bank(libs, h, q, mask):
    out = torch.empty_like(h)
    run(libs["censor"], f"bank_advance_{_suffix(h)}", h.device, h.data_ptr(),
        q.data_ptr(), mask.data_ptr(), out.data_ptr(), h.shape[0],
        h[0].numel())
    return out


CHECK_FLASH = [  # (b, h, kh, lq, s, d, causal, window)
    (2, 8, 8, 129, 129, 64, True, None),
    (1, 12, 2, 300, 300, 64, True, 100),
    (1, 8, 2, 200, 150, 32, False, 40),
    (1, 4, 2, 77, 333, 80, False, None),
    (1, 4, 4, 65, 65, 256, True, 16),
]


def check_flash(trees, randn, dtype=torch.float32) -> None:
    """Each tree's B14 against the f64 rule (and whether its bits are this
    tree's) on CHECK_FLASH; in bf16 also the same bits twice."""
    for b, h, kh, lq, s_len, d, causal, window in CHECK_FLASH:
        q = randn(b, lq, h, d).to(dtype).transpose(1, 2)
        k, v = (randn(b, s_len, kh, d).to(dtype).transpose(1, 2)
                for _ in range(2))
        exact = _flash_f64(q, k, v, causal, window)
        err_p = float((ref.flash_attention_fwd(
            q, k, v, causal=causal, window=window).double() - exact
                       ).abs().max())
        outs = {tag: flash(libs, q, k, v, causal, window)
                for tag, libs in trees.items()}
        errs = {tag: float((o.double() - exact).abs().max())
                for tag, o in outs.items()}
        ok = {tag: e <= ATTN_FACTOR * err_p + ATTN_FLOOR
              for tag, e in errs.items()}
        same = {tag: same_bits(o, outs["this"]) for tag, o in outs.items()}
        if dtype != torch.float32:
            ok["this"] = ok["this"] and same_bits(
                outs["this"], flash(trees["this"], q, k, v, causal, window))
        print(json.dumps({"check": f"B14 {str(dtype)[6:]}",
                          "shape": [b, h, kh, lq, s_len, d],
                          "causal": causal, "window": window,
                          "plain_err": err_p, "errs": errs, "ok": ok,
                          "bits_as_this": same}),
              flush=True)
        if not ok["this"]:
            raise SystemExit("kernel_ab: B14 outside the f64 rule")


CHECK_DECODE = [  # (b, h, kh, c, d, pos)
    (8, 12, 12, 2081, 64, 2078),
    (3, 8, 4, 97, 128, 40),
    (2, 8, 2, 257, 256, 300),
    (8, 32, 8, 2081, 128, 2078),
]


def check_decode(trees, randn, dtype) -> None:
    """Each tree's B13 against the f64 rule on CHECK_DECODE, and whether
    its bits are this tree's (f32: they must be); this tree's the same
    bits twice."""
    from repro_torch.models.kvcache import slot_positions
    for b, h, kh, c, d, pos in CHECK_DECODE:
        q = randn(b, h, d).to(dtype)
        k, v = (randn(b, c, kh, d).to(dtype).transpose(1, 2)
                for _ in range(2))
        cpos = slot_positions(pos + 1, c, q.device)
        exact = _decode_f64(q, k, v, cpos, pos)
        err_p = float((ref.decode_attention_ref(q, k, v, cpos, pos).double()
                       - exact).abs().max())
        outs = {tag: decode(libs, q, k, v, cpos, pos)
                for tag, libs in trees.items()}
        errs = {tag: float((o.double() - exact).abs().max())
                for tag, o in outs.items()}
        ok = {tag: e <= ATTN_FACTOR * err_p + ATTN_FLOOR
              for tag, e in errs.items()}
        same = {tag: same_bits(o, outs["this"]) for tag, o in outs.items()}
        repeat = same_bits(outs["this"], decode(trees["this"], q, k, v, cpos,
                                                pos))
        print(json.dumps({"check": f"B13 {str(dtype)[6:]}",
                          "shape": [b, h, kh, c, d, pos], "plain_err": err_p,
                          "errs": errs, "ok": ok, "bits_as_this": same,
                          "repeat_bits": repeat}), flush=True)
        if not (ok["this"] and repeat) or (
                dtype == torch.float32 and not all(same.values())):
            raise SystemExit("kernel_ab: B13 outside the f64 rule, not "
                             "repeatable, or f32 bits moved")


def bwd(libs, q, k, v, o, lse, do, causal=True, window=None):
    """One tree's flash backward: (dq, dk, dv)."""
    b, h, lq, d = q.shape
    kh, s_len = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    lib = libs["flash_backward"]
    scratch, nbytes = (), 0
    if len(lib.flash_attention_bwd_f32.argtypes) == 14:
        nbytes = flash_backward.plan(b, h, kh, lq, s_len, d, causal,
                                     window).scratch_bytes
        buf = torch.empty(nbytes, dtype=torch.uint8, device=q.device)
        scratch = (buf.data_ptr(),)
    # a tree whose launcher reads 42 entries ignores the 43rd (the bytes)
    dims = flash_backward._dims(q, k, v, o, do, dq, dk, dv, causal, window,
                                nbytes)
    run(lib, "flash_attention_bwd_f32", q.device, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *scratch,
        ctypes.addressof(dims), float(d ** -0.5))
    return dq, dk, dv


CHECK_BWD = [  # (b, h, kh, lq, s, d, causal, window)
    (4, 12, 12, 256, 256, 64, True, None),
    (1, 12, 12, 2048, 2048, 64, True, None),
    (1, 4, 2, 129, 95, 64, True, None),
    (1, 8, 2, 100, 100, 64, True, None),
    (1, 4, 2, 200, 200, 64, True, 16),
    (1, 4, 2, 150, 100, 64, True, 20),
    (1, 4, 2, 77, 160, 80, False, 20),
    (1, 4, 4, 65, 65, 256, True, 16),
]


def bwd_inputs(randn, b, h, kh, lq, s_len, d, causal, window):
    """q, k, v, o, lse, dO: the model's strided views, o and lse from this
    tree's B14."""
    q, do = (randn(b, lq, h, d).transpose(1, 2) for _ in range(2))
    k, v = (randn(b, s_len, kh, d).transpose(1, 2) for _ in range(2))
    o, lse = flash_attention.flash_attention(q, k, v, causal=causal,
                                             window=window, return_lse=True)
    return q, k, v, o, lse, do


def check_bwd(trees, randn) -> None:
    for case in CHECK_BWD:
        *shape, causal, window = case
        q, k, v, o, lse, do = bwd_inputs(randn, *case)
        kw = {"causal": causal, "window": window}
        exact = flash_bwd_f64(q, k, v, do, causal, window)
        plain = ref.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        err_p = [float((p.double() - x).abs().max())
                 for p, x in zip(plain, exact)]
        outs = {tag: [bwd(libs, q, k, v, o, lse, do, **kw) for _ in range(3)]
                for tag, libs in trees.items()}
        errs = {tag: [float((g.double() - x).abs().max())
                      for g, x in zip(runs[0], exact)]
                for tag, runs in outs.items()}
        ok = {tag: all(e <= ATTN_FACTOR * p + ATTN_FLOOR
                       for e, p in zip(es, err_p)) for tag, es in errs.items()}
        repeat = {tag: all(same_bits(a, b_) for again in runs[1:]
                           for a, b_ in zip(runs[0], again))
                  for tag, runs in outs.items()}
        same = {tag: all(same_bits(a, b_) for a, b_ in
                         zip(runs[0], outs["this"][0]))
                for tag, runs in outs.items()}
        print(json.dumps({"check": "bwd", "shape": shape, "causal": causal,
                          "window": window, "plain_err_dq_dk_dv": err_p,
                          "errs": errs, "ok": ok, "repeat_bits": repeat,
                          "bits_as_this": same}), flush=True)
        if not (ok["this"] and repeat["this"]):
            raise SystemExit("kernel_ab: the flash backward outside the f64 "
                             "rule or not repeatable")
        del outs, exact, plain
        torch.cuda.empty_cache()


# B9's and B7a's tall shapes (the staged int8 and top-k steps of phase
# many_workers run at MANY_M_STAGED), timed beside full width
TALL_AB = ((MANY_M_STAGED, MANY_D), (MANY_M, MANY_D))


def check_bank(trees, dev) -> None:
    """Each tree's B9 against ``ref.bank_advance`` bit for bit (-0.0 and
    NaN salted) on aligned leaves and views one element off alignment, at
    M = 4 and on tall banks, f32 and f64."""
    gen = torch.Generator(device=dev).manual_seed(13)
    for m, n, dtype in ((4, 127, torch.float32), (4, 4096, torch.float32),
                        (4, 2 ** 20 + 17, torch.float32),
                        (4, 2 ** 20, torch.float32), (4, 4096, torch.float64),
                        (1057, 16, torch.float64), (70000, 33, torch.float32),
                        *((m, n, torch.float64) for m, n in TALL_AB)):
        for off in (0, 1):            # off 1: a view one element off alignment
            hh, qq = (torch.randn(off + m * n, generator=gen, device=dev,
                                  dtype=dtype)[off:].view(m, n)
                      for _ in range(2))
            hh[:, ::7] = -0.0
            qq[:, 3::11] = float("nan")
            mask = torch.tensor([float(i % 3 != 1) for i in range(m)],
                                device=dev)
            want = ref.bank_advance(hh, qq, mask)
            ok = {tag: same_bits(bank(libs, hh, qq, mask), want)
                  for tag, libs in trees.items()}
            print(json.dumps({"check": "B9", "m": m, "n": n, "off": off,
                              "dtype": str(dtype), "ok": ok}), flush=True)
            if not ok["this"]:
                raise SystemExit(f"kernel_ab: B9 differs at M={m} n={n} "
                                 f"off={off} {dtype}")


def censor_adv(libs, g, h, mask):
    """B4 of one tree: ``h + mask * (g - h)``."""
    out = torch.empty_like(h)
    run(libs["censor"], f"censor_bank_advance_{_suffix(h)}", h.device,
        g.data_ptr(), h.data_ptr(), mask.data_ptr(), out.data_ptr(),
        h.shape[0], h[0].numel())
    return out


def quant(libs, p, e, mask, scale):
    """B7b of one tree: ``(payload, new_err)``."""
    payload, new_e = torch.empty_like(p), torch.empty_like(p)
    run(libs["quantize_ef"], f"quantize_ef_batched_{_suffix(p)}", p.device,
        p.data_ptr(), e.data_ptr(), mask.data_ptr(), scale.data_ptr(),
        payload.data_ptr(), new_e.data_ptr(), p.shape[0], p[0].numel())
    return payload, new_e


def staged_inputs(m, n, dtype, dev, off=0, gen=None):
    """g, ghat, err (M, n) views ``off`` elements into their storage,
    salted with -0.0, NaN and +-inf, pending = (g - ghat) + err, the
    scales of its plain abs-max and a mask with every third worker not
    transmitting."""
    g, h, e = (torch.randn(off + m * n, generator=gen, device=dev,
                           dtype=dtype)[off:].view(m, n) for _ in range(3))
    e.mul_(0.01)
    g[:, ::7] = -0.0
    h[:, ::11] = -0.0
    if n > 3:
        g[0, 2] = float("nan")
        h[-1, n - 1] = float("inf")
        g[m // 2, 1] = float("-inf")
    pend = torch.empty(off + m * n, device=dev, dtype=dtype)[off:].view(m, n)
    pend.copy_((g - h) + e)
    mask = torch.tensor([float(i % 3 != 1) for i in range(m)], device=dev)
    return g, h, e, pend, int8_scale(ref.absmax_batched(pend)), mask


def check_staged(kernel, trees, dev) -> None:
    """Each tree's B4 or B7b against its plain version, bit for bit (NaN
    where NaN), on aligned leaves and views one element off alignment, at
    M <= 9 and on tall banks, f32 and f64."""
    gen = torch.Generator(device=dev).manual_seed(17)
    for m, n, dtype in ((4, 127, torch.float32), (4, 4096, torch.float32),
                        (4, 2 ** 20 + 17, torch.float32),
                        (9, 2 ** 20, torch.float32), (4, 4096, torch.float64),
                        (1057, 16, torch.float64), (70000, 33, torch.float32),
                        (70000, 2049, torch.float64),
                        *((m, n, torch.float64) for m, n in TALL_AB)):
        for off in (0, 1):
            g, h, e, pend, scale, mask = staged_inputs(m, n, dtype, dev, off,
                                                       gen)
            if kernel == "B4":
                want = (ref.censor_bank_advance(g, h, mask),)
                ok = {tag: same_or_nan(censor_adv(libs, g, h, mask), want[0])
                      for tag, libs in trees.items()}
            else:
                want = ref.quantize_ef_batched(pend, e, mask, scale)
                ok = {tag: all(same_or_nan(a, b) for a, b in zip(
                    quant(libs, pend, e, mask, scale), want))
                      for tag, libs in trees.items()}
            print(json.dumps({"check": kernel, "m": m, "n": n, "off": off,
                              "dtype": str(dtype), "ok": ok}), flush=True)
            if not ok["this"]:
                raise SystemExit(f"kernel_ab: {kernel} differs at M={m} "
                                 f"n={n} off={off} {dtype}")
            del g, h, e, pend, scale, mask, want
            torch.cuda.empty_cache()


def absmax_span(tree: Path) -> int:
    """Elements of a worker row behind one B7a partial in ``tree``: its
    ``kernels/build.py``'s ABSMAX_SPAN, else REDUCE_CHUNK. Read from the
    file's top-level integer constants (the module's package imports would
    pull in the other tree)."""
    consts = {}
    src = (tree / "src/repro_torch/kernels/build.py").read_text()
    for node in ast.parse(src).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            try:
                consts[node.targets[0].id] = eval(     # noqa: S307
                    compile(ast.Expression(node.value), "build.py", "eval"),
                    {"__builtins__": {}}, dict(consts))
            except Exception:   # not a constant expression of constants
                continue
    return consts.get("ABSMAX_SPAN", consts["REDUCE_CHUNK"])


def absmax(libs, span, x):
    """B7a of one tree: the design this tree's wrapper picks
    (``common.sqnorm_path``) where the tree has its launcher, else its
    two-pass design."""
    m, n = x.shape
    lib = libs["quantize_ef"]
    out = torch.empty((m,), dtype=x.dtype, device=x.device)
    warp = f"absmax_batched_warp_{_suffix(x)}"
    if hasattr(lib, warp) and common.sqnorm_path(
            m, n, common.sm_count(x.device.index or 0)) == "warp":
        run(lib, warp, x.device, x.data_ptr(), out.data_ptr(), m, n)
        return out
    part = torch.empty((m, -(-n // span)), dtype=x.dtype, device=x.device)
    run(lib, f"absmax_batched_{_suffix(x)}", x.device, x.data_ptr(),
        part.data_ptr(), out.data_ptr(), m, n, part.shape[1])
    return out


def check_absmax(trees, spans, dev) -> None:
    """Each tree's B7a against ``ref.absmax_batched`` on its 16-byte and
    element-wise paths (odd n, a view one element off alignment), rows
    salted with -0.0, NaN and +-inf, at M <= 9 and on tall banks."""
    gen = torch.Generator(device=dev).manual_seed(11)
    for m, n, off in ((1, 1, 0), (4, 4096, 0), (9, 70001, 0), (4, 4100, 1),
                      (3, 2 ** 20 + 4, 0), (1057, 16, 0), (70000, 33, 0),
                      (70000, 36, 1), (70000, 2048, 1),
                      *((m, n, 0) for m, n in TALL_AB)):
        for dtype in (torch.float32, torch.float64):
            x = torch.randn(off + m * n, generator=gen, device=dev,
                            dtype=dtype)[off:].view(m, n)
            x[:, ::7] = -0.0
            if n > 3:
                x[0, 2] = float("nan")
                x[-1, n - 1] = float("-inf")
            want = ref.absmax_batched(x)
            ok = {tag: same_or_nan(absmax(libs, spans[tag], x), want)
                  for tag, libs in trees.items()}
            print(json.dumps({"check": "B7a", "m": m, "n": n, "off": off,
                              "dtype": str(dtype), "ok": ok}), flush=True)
            if not ok["this"]:
                raise SystemExit(f"kernel_ab: B7a differs at M={m} n={n} "
                                 f"off={off} {dtype}")


def sums(libs, g, h, e, only=None):
    """B1, B8 (on g - h) and B5 of one tree: their four (M,) results, or
    only the kernel named ``only`` ("B1", "B8" on g, "B5 sqnorm")."""
    m, n = g.shape
    nch = -(-n // build.REDUCE_CHUNK)
    suffix = "f32" if g.dtype == torch.float32 else "f64"
    dev = g.device

    def empty(dtype, *shape):
        return torch.empty(shape, dtype=dtype, device=dev)

    part, b1, b8 = empty(torch.float32, m, nch), empty(torch.float32, m), \
        empty(torch.float32, m)
    if only in (None, "B1"):
        run(libs["censor"], f"censor_delta_sqnorm_batched_{suffix}", dev,
            g.data_ptr(), h.data_ptr(), part.data_ptr(), b1.data_ptr(), m, n,
            nch)
    if only in (None, "B8"):
        x = g if only else g - h
        run(libs["censor"], f"sqnorm_batched_{suffix}", dev, x.data_ptr(),
            part.data_ptr(), b8.data_ptr(), m, n, nch)
        del x
    if only not in (None, "B5 sqnorm"):
        return None
    am_part, sq, am = empty(g.dtype, m, nch), empty(torch.float32, m), \
        empty(g.dtype, m)
    run(libs["fused_step"], f"int8_stats_batched_{suffix}", dev,
        g.data_ptr(), h.data_ptr(), e.data_ptr(), part.data_ptr(),
        am_part.data_ptr(), sq.data_ptr(), am.data_ptr(), m, n, nch)
    return {"B1": b1, "B8": b8, "B5 sqnorm": sq, "B5 absmax": am}


def check_sums(trees, dev) -> None:
    """B1, B5 and B8 of this tree give every other tree's bits."""
    gen = torch.Generator(device=dev).manual_seed(19)
    for m, n, dtype in ((4, FULL_D, torch.float32), (9, 70001, torch.float32),
                        (9, 70001, torch.float64)):
        g, h, e = (torch.randn((m, n), generator=gen, device=dev,
                               dtype=dtype) for _ in range(3))
        g[:, ::7] = -0.0
        got = {tag: sums(libs, g, h, e * 0.01) for tag, libs in trees.items()}
        mine = got.pop("this")
        same = {tag: {k: same_bits(v, mine[k]) for k, v in r.items()}
                for tag, r in got.items()}
        print(json.dumps({"check": "sums", "m": m, "n": n,
                          "dtype": str(dtype), "same_bits_as_this": same}),
              flush=True)
        if not all(all(r.values()) for r in same.values()):
            raise SystemExit(f"kernel_ab: B1/B5/B8 bits differ between the "
                             f"trees at M={m} n={n} {dtype}")
        del g, h, e, got
        torch.cuda.empty_cache()


FUSED_SHAPES = ((4, FULL_D, torch.float32), (MANY_M, MANY_D, torch.float64),
                (LARGE_M, 2049, torch.float64))


def fused(libs, kind, tall, g, h, e, t, p, mask, scale):
    """B2 (``kind`` "B2") or B6 ("B6") of one tree: its outputs. ``tall``
    runs the tree's tall launcher where it has one."""
    lib = libs["fused_step"]
    m, n = g.shape
    suffix = "f32" if g.dtype == torch.float32 else "f64"
    name = "fused_dense_step" if kind == "B2" else "fused_int8_step"
    fn = f"{name}_tall_{suffix}"
    if not (tall and hasattr(lib, fn)):
        fn = f"{name}_{suffix}"
    new_h, agg, new_t = (torch.empty_like(x) for x in (h, t, t))
    if kind == "B2":
        run(lib, fn, g.device, g.data_ptr(), h.data_ptr(), t.data_ptr(),
            p.data_ptr(), mask.data_ptr(), new_h.data_ptr(), agg.data_ptr(),
            new_t.data_ptr(), m, n, 0.1, 0.4)
        return new_h, agg, new_t
    new_e = torch.empty_like(e)
    run(lib, fn, g.device, g.data_ptr(), h.data_ptr(), e.data_ptr(),
        t.data_ptr(), p.data_ptr(), mask.data_ptr(), scale.data_ptr(),
        new_h.data_ptr(), new_e.data_ptr(), agg.data_ptr(), new_t.data_ptr(),
        m, n, 0.1, 0.4)
    return new_h, new_e, agg, new_t


def fused_inputs(m, n, dtype, dev):
    gen = torch.Generator(device=dev).manual_seed(m + n)
    g, h, e = (torch.randn((m, n), generator=gen, device=dev, dtype=dtype)
               for _ in range(3))
    e *= 0.01
    g[:, ::7] = -0.0
    t, p = (torch.randn(n, generator=gen, device=dev, dtype=dtype)
            for _ in range(2))
    mask = torch.tensor([float(i % 3 != 1) for i in range(m)], device=dev)
    scale = int8_scale(ref.absmax_batched((g - h) + e))
    return g, h, e, t, p, mask, scale


def check_fused(trees, dev) -> None:
    """B2 and B6 of every tree give this tree's bits, and this tree's
    the plain version's, at the FUSED_SHAPES."""
    sms = common.sm_count(dev.index or 0)
    for m, n, dtype in FUSED_SHAPES:
        args = fused_inputs(m, n, dtype, dev)
        g, h, e, t, p, mask, scale = args
        tall = common.fold_path(m, n, sms) == "tall"
        for kind in ("B2", "B6"):
            plain = (ref.fused_dense_step(g, h, t, p, mask, 0.1, 0.4)
                     if kind == "B2" else
                     ref.fused_int8_step(g, h, e, t, p, mask, scale, 0.1,
                                         0.4))
            got = {tag: fused(libs, kind, tall, *args)
                   for tag, libs in trees.items()}
            same = {tag: all(same_bits(a, b) for a, b in zip(r, got["this"]))
                    for tag, r in got.items() if tag != "this"}
            ok = all(same_bits(a, b) for a, b in zip(got["this"], plain))
            print(json.dumps({"check": kind, "m": m, "n": n,
                              "dtype": str(dtype), "tall": tall,
                              "this_equals_plain": ok,
                              "same_bits_as_this": same}), flush=True)
            if not (ok and all(same.values())):
                raise SystemExit(f"kernel_ab: {kind} bits differ at M={m} "
                                 f"n={n} {dtype}")
            del plain, got
        del args, g, h, e, t, p, mask, scale
        torch.cuda.empty_cache()


# B10's shapes: full width, and the fed mesh's tall banks (the top-k step
# of phase many_workers runs at MANY_M_STAGED)
PACK_SHAPES = ((4, FULL_D, torch.float32),
               (MANY_M_STAGED, MANY_D, torch.float64),
               (MANY_M, MANY_D, torch.float64))


def pack(libs, p, e, keep, mask):
    """B10 of one tree: ``(payload, new_err)``."""
    m, n = p.shape
    payload, new_e = torch.empty_like(p), torch.empty_like(p)
    suffix = "f32" if p.dtype == torch.float32 else "f64"
    run(libs["topk_pack"], f"select_pack_ef_batched_{suffix}", p.device,
        p.data_ptr(), e.data_ptr(), keep.data_ptr(), mask.data_ptr(),
        payload.data_ptr(), new_e.data_ptr(), m, n)
    return payload, new_e


def pack_inputs(m, n, dtype, dev):
    """pending salted with -0.0 every 7th column, about 40% kept (a kept
    and a dropped -0.0, and -0.0 in the mask itself), every third worker
    not transmitting."""
    gen = torch.Generator(device=dev).manual_seed(m + n + 1)
    p, e = (torch.randn((m, n), generator=gen, device=dev, dtype=dtype)
            for _ in range(2))
    p[:, ::7] = -0.0
    keep = (torch.rand((m, n), generator=gen, device=dev) < 0.4).to(dtype)
    keep[:, ::7] = 1.0
    keep[:, ::14] = 0.0
    keep[:, 3::29] = -0.0
    mask = torch.tensor([float(i % 3 != 1) for i in range(m)], device=dev)
    return p, e * 0.01, keep, mask


def check_pack(trees, dev) -> None:
    """B10 of every tree gives the plain version's bits at the PACK_SHAPES
    and a few short ones."""
    for m, n, dtype in ((1, 1, torch.float64), (65, 33, torch.float32),
                        (66, 2049, torch.float64), *PACK_SHAPES):
        args = pack_inputs(m, n, dtype, dev)
        want = ref.select_pack_ef_batched(*args)
        ok = {tag: all(same_bits(a, b) for a, b in zip(pack(libs, *args),
                                                        want))
              for tag, libs in trees.items()}
        print(json.dumps({"check": "B10", "m": m, "n": n,
                          "dtype": str(dtype), "ok": ok}), flush=True)
        if not all(ok.values()):
            raise SystemExit(f"kernel_ab: B10 differs at M={m} n={n} "
                             f"{dtype}")
        del args, want
        torch.cuda.empty_cache()


def _device_us(evt) -> float:
    us = getattr(evt, "self_device_time_total", None)
    return getattr(evt, "self_cuda_time_total", 0.0) if us is None else us


def split(fn, reps: int) -> dict:
    """Device time a call of each kernel ``fn`` launches, in us
    (``torch.profiler`` over ``reps`` calls after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {evt.key[:80]: _device_us(evt) / reps
           for evt in prof.key_averages()
           if evt.device_type == DeviceType.CUDA and _device_us(evt) > 0}
    if not out:
        raise RuntimeError("the profiler recorded no device time")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path, nargs="+")
    ap.add_argument("--only", nargs="+", choices=tuple(SOURCES),
                    default=list(SOURCES))
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    names = sorted({n for k in args.only for n in SOURCES[k]})
    ablated = {d: source for k, source in ABLATED.items()
               if args.ablate and k in args.only
               for d in ablated_trees(source)}
    trees = {d.name: compile_tree(d.name, d / "src/repro_torch/kernels/csrc",
                                  [ablated[d]] if d in ablated else names)
             for d in [*args.other, *ablated]}
    trees["this"] = compile_tree("this", build.CSRC, names)
    spans = {d.name: absmax_span(d) for d in args.other}
    spans["this"] = absmax_span(ROOT)
    gen = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def having(source):
        return {t: libs for t, libs in trees.items() if source in libs}

    work, splits = {}, {}
    if "sums" in args.only:
        check_sums(having("fused_step"), dev)
        g, h, e = randn(4, FULL_D), randn(4, FULL_D), randn(4, FULL_D)
        for key in ("B1", "B8", "B5 sqnorm"):
            fns = {tag: (lambda libs=libs, key=key: sums(libs, g, h, e, key))
                   for tag, libs in having("fused_step").items()}
            work[key.split()[0]] = (
                fns, (lambda: torch.linalg.vecdot(g, g)) if key == "B8"
                else None)
            if args.ablate:
                splits[key.split()[0]] = {tag: split(fn, args.reps)
                                          for tag, fn in fns.items()}
    if "B14" in args.only:
        check_flash(having("flash_attention"), randn)
        b, h, l, d = 8, 12, 2048, 64
        q, k, v = (randn(b, l, h, d).transpose(1, 2) for _ in range(3))
        work["B14"] = (
            {tag: (lambda libs=libs, q=q, k=k, v=v: flash(libs, q, k, v))
             for tag, libs in having("flash_attention").items()},
            lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, is_causal=True))
    if "B14bf16" in args.only:
        check_flash(having("flash_attention"), randn, torch.bfloat16)
        b, l = 8, 2048
        for h, kh, d, window in ((32, 8, 128, None), (16, 8, 256, None),
                                 (16, 8, 256, 1024)):
            q = randn(b, l, h, d).to(torch.bfloat16).transpose(1, 2)
            k, v = (randn(b, l, kh, d).to(torch.bfloat16).transpose(1, 2)
                    for _ in range(2))
            ke, ve = (x.repeat_interleave(h // kh, dim=1) for x in (k, v))
            mask = None
            if window is not None:
                i = torch.arange(l, device=dev)
                mask = (i[None, :] <= i[:, None]) \
                    & (i[None, :] > i[:, None] - window)
            work[f"B14 bf16 B={b} H={h} K={kh} L={l} d={d} causal"
                 f"{'' if window is None else f' window {window}'}"] = (
                {tag: (lambda libs=libs, q=q, k=k, v=v, w=window:
                       flash(libs, q, k, v, window=w))
                 for tag, libs in having("flash_attention").items()},
                lambda q=q, ke=ke, ve=ve, mask=mask:
                F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask,
                                               is_causal=mask is None))
    if "B13" in args.only:
        from repro_torch.models.kvcache import slot_positions
        for dtype in (torch.float32, torch.bfloat16):
            check_decode(having("decode_attention"), randn, dtype)
        b, c_full, pos = 8, 2081, 2078
        for h, kh, d, c, dtype in ((12, 12, 64, c_full, torch.float32),
                                   (32, 8, 128, c_full, torch.bfloat16),
                                   (16, 8, 256, c_full, torch.bfloat16),
                                   (16, 8, 256, 1024, torch.bfloat16)):
            q = randn(b, h, d).to(dtype)
            k, v = (randn(b, c, kh, d).to(dtype).transpose(1, 2)
                    for _ in range(2))
            ke, ve = (x.repeat_interleave(h // kh, dim=1) for x in (k, v))
            cpos = slot_positions(pos + 1, c, dev)
            valid = (cpos >= 0) & (cpos <= pos)
            work[f"B13 {str(dtype)[6:]} B={b} H={h} K={kh} C={c} d={d} "
                 f"pos={pos}"] = (
                {tag: (lambda libs=libs, q=q, k=k, v=v, cpos=cpos:
                       decode(libs, q, k, v, cpos, pos))
                 for tag, libs in having("decode_attention").items()},
                lambda q=q, ke=ke, ve=ve, valid=valid:
                F.scaled_dot_product_attention(
                    q[:, :, None], ke, ve, attn_mask=valid[None, None, None]))
    if "bwd" in args.only:
        check_bwd(having("flash_backward"), randn)
        for case in ((4, 12, 12, 256, 256, 64, True, None),
                     (1, 12, 12, 2048, 2048, 64, True, None)):
            ins = bwd_inputs(randn, *case)
            sq, sk, sv = (x.detach().clone().requires_grad_()
                          for x in ins[:3])
            sdpa = F.scaled_dot_product_attention(sq, sk, sv, is_causal=True)
            key = "bwd B={} H={} K={} L={} S={} d={} causal".format(*case[:6])
            fns = {tag: (lambda libs=libs, ins=ins: bwd(libs, *ins))
                   for tag, libs in having("flash_backward").items()}
            work[key] = (fns, lambda sdpa=sdpa, sq=sq, sk=sk, sv=sv,
                         do=ins[5]: torch.autograd.grad(
                             sdpa, (sq, sk, sv), do, retain_graph=True))
            splits[key] = {tag: split(fn, args.reps)
                           for tag, fn in fns.items()}
    if "B9" in args.only:
        check_bank(having("censor"), dev)
        for m, n, dtype in ((4, FULL_D, torch.float32),
                            *((m, n, torch.float64) for m, n in TALL_AB)):
            hh, qq = (randn(m, n).to(dtype) for _ in range(2))
            mask = torch.tensor([float(i % 2 == 0) for i in range(m)],
                                device=dev)
            mw = mask.to(dtype)[:, None]
            work[f"B9 M={m} n={n} {str(dtype)[6:]}"] = (
                {tag: (lambda libs=libs, hh=hh, qq=qq, mask=mask:
                       bank(libs, hh, qq, mask))
                 for tag, libs in having("censor").items()},
                lambda hh=hh, qq=qq, mw=mw: torch.addcmul(hh, mw, qq))
    if "B4" in args.only:
        check_staged("B4", having("censor"), dev)
    if "B7b" in args.only:
        check_staged("B7b", having("quantize_ef"), dev)
    staged = {"B4", "B7b"} & set(args.only)
    for m, n, dtype in ((4, FULL_D, torch.float32),
                        *((m, n, torch.float64) for m, n in TALL_AB)
                        ) if staged else ():
        g, h, e, pend, scale, mask = staged_inputs(m, n, dtype, dev, 0, gen)
        shape = f"M={m} n={n} {str(dtype)[6:]}"
        if "B4" in args.only:
            mw = mask.to(dtype)[:, None]
            work[f"B4 {shape}"] = (
                {tag: (lambda libs=libs, g=g, h=h, mask=mask:
                       censor_adv(libs, g, h, mask))
                 for tag, libs in having("censor").items()},
                lambda g=g, h=h, mw=mw: torch.lerp(h, g, mw))
        if "B7b" in args.only:
            work[f"B7b {shape}"] = (
                {tag: (lambda libs=libs, pend=pend, e=e, mask=mask,
                       scale=scale: quant(libs, pend, e, mask, scale))
                 for tag, libs in having("quantize_ef").items()}, None)
    if "B7a" in args.only:
        check_absmax(having("quantize_ef"), spans, dev)
        for m, n, dtype in ((4, FULL_D, torch.float32),
                            *((m, n, torch.float64) for m, n in TALL_AB)):
            pend = randn(m, n).to(dtype)
            key = f"B7a M={m} n={n} {str(dtype)[6:]}"
            fns = {tag: (lambda libs=libs, tag=tag, pend=pend:
                         absmax(libs, spans[tag], pend))
                   for tag, libs in having("quantize_ef").items()}
            work[key] = (fns, lambda pend=pend: torch.linalg.vector_norm(
                pend, ord=math.inf, dim=1))
            if args.ablate:
                splits[key] = {tag: split(fn, args.reps)
                               for tag, fn in fns.items()}
    if "fused" in args.only:
        check_fused({t: libs for t, libs in having("fused_step").items()
                     if t not in {d.name for d in ablated}}, dev)
        sms = common.sm_count(dev.index or 0)
        for m, n, dtype in FUSED_SHAPES:
            fargs = fused_inputs(m, n, dtype, dev)
            tall = common.fold_path(m, n, sms) == "tall"
            for kind in ("B2", "B6"):
                key = f"{kind} M={m} n={n} {str(dtype)[6:]}"
                fns = {tag: (lambda libs=libs, kind=kind, tall=tall,
                             fargs=fargs: fused(libs, kind, tall, *fargs))
                       for tag, libs in having("fused_step").items()}
                work[key] = (fns, None)
                if args.ablate:
                    splits[key] = {tag: split(fn, args.reps)
                                   for tag, fn in fns.items()}
        floor = chain_floor_ms(MANY_M, args.reps)
        print(json.dumps({"chain_floor": {"m": MANY_M, "ms": floor,
                                          "ns_per_add": {
                                              k: v * 1e6 / (MANY_M - 1)
                                              for k, v in floor.items()}},
                          "card": smi}), flush=True)
    if "B10" in args.only:
        check_pack(having("topk_pack"), dev)
        for m, n, dtype in PACK_SHAPES:
            pargs = pack_inputs(m, n, dtype, dev)
            work[f"B10 M={m} n={n} {str(dtype)[6:]}"] = (
                {tag: (lambda libs=libs, pargs=pargs: pack(libs, *pargs))
                 for tag, libs in having("topk_pack").items()}, None)
    for name, (fns, lib_fn) in work.items():
        tags = [t for t in fns if t != "this"]
        order = tags + ["this", "this"] + tags[::-1]
        times = {tag: [] for tag in fns}
        if lib_fn is not None:            # the library call first and last
            fns = {**fns, "library": lib_fn}
            times["library"] = []
            order = ["library", *order, "library"]
        for tag in order:
            times[tag].append(_time_ms(fns[tag], args.reps))
        line = {"kernel": name, "ms": times, "card": smi}
        if name in splits:
            line["device_us_per_call_by_kernel"] = splits[name]
        if name.startswith(f"B7a M=4 n={FULL_D} "):
            line["partials_per_worker"] = {
                tag: -(-FULL_D // span) for tag, span in spans.items()}
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()

if __name__ == "__main__":
    main()
