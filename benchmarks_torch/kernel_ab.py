#!/usr/bin/env python3
"""B14, B9, B7a, B2 and B6 of two source trees, side by side on one card,
and the bits of their sums B1, B5 and B8.

    python3 benchmarks_torch/kernel_ab.py --other <dir> [<dir> ...]
        [--only B14 B9 B7a sums fused] [--ablate] [--reps 10]

Each ``<dir>`` holds another checkout of this repository (for example the
parent commit, unpacked with ``git archive`` into a directory that
``.gitignore`` lists). The script compiles ``flash_attention.cu`` (B14),
``censor.cu`` (B9; B1 and B8), ``quantize_ef.cu`` (B7a) and
``fused_step.cu`` (B5) of every tree with the port's nvcc flags into
``build/kernel_ab/``, prints each compiler log (``-Xptxas -v``), checks
each tree's B9 and B7a bits (B7a NaN where its plain version gives NaN)
and B14 against the f64 rule of ``chip_smoke.py`` on a few shapes (it
stops if this tree's fail and reports the others'), then times all at the
main path's shapes in turns (the others, this, this, the others in
reverse) beside their library calls: B14 at serve_long's prefill (B 8,
H = K 12, L 2048, d 64, causal, the model's strided views) against
``scaled_dot_product_attention``, B9 at M = 4, n = 163,597,056 f32
against ``addcmul``, B7a at the same shape against
``linalg.vector_norm(inf)``. ``sums`` checks that B1, B5 and B8 of this
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
else its one design. One JSON line each, and the card's name and power
limit. Needs a CUDA card and nvcc.

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
import json
import math
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
                        MANY_D, MANY_M, _flash_f64, _time_ms, same_bits, same_or_nan)
from repro_torch.core.quantize import int8_scale  # noqa: E402
from repro_torch.kernels import build, common, flash_attention, ref  # noqa: E402

OUT = ROOT / "build" / "kernel_ab"
# the sources each choice of --only compiles
SOURCES = {"B14": ("flash_attention",), "B9": ("censor",),
           "B7a": ("quantize_ef",), "sums": ("censor", "fused_step"),
           "fused": ("fused_step",)}


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
                f.argtypes = argtypes
                f.restype = ctypes.c_int
        libs[name] = cdll
    return libs


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


def flash(libs, q, k, v, causal=True, window=None):
    b, h, lq, d = q.shape
    kh, s_len = k.shape[1], k.shape[2]
    out = torch.empty((b, h, lq, d), dtype=q.dtype, device=q.device)
    # a tree whose launcher reads 21 entries ignores the 22nd (the copy flag)
    dims = (ctypes.c_int64 * 22)(
        b, h, kh, lq, s_len, d, *q.stride(), *k.stride(), *v.stride(),
        int(causal), int(window is not None),
        0 if window is None else int(window),
        int(flash_attention.async_copy_ok(q, k, v)))
    suffix = "f32" if q.dtype == torch.float32 else "bf16"
    run(libs["flash_attention"], f"flash_attention_{suffix}", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ctypes.addressof(dims), float(d ** -0.5))
    return out


def bank(libs, h, q, mask):
    out = torch.empty_like(h)
    run(libs["censor"], "bank_advance_f32", h.device, h.data_ptr(),
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


def check_flash(trees, randn) -> None:
    for b, h, kh, lq, s_len, d, causal, window in CHECK_FLASH:
        q = randn(b, lq, h, d).transpose(1, 2)
        k, v = (randn(b, s_len, kh, d).transpose(1, 2) for _ in range(2))
        exact = _flash_f64(q, k, v, causal, window)
        err_p = float((ref.flash_attention_fwd(
            q, k, v, causal=causal, window=window).double() - exact
                       ).abs().max())
        errs = {tag: float((flash(libs, q, k, v, causal, window).double()
                            - exact).abs().max())
                for tag, libs in trees.items()}
        ok = {tag: e <= ATTN_FACTOR * err_p + ATTN_FLOOR
              for tag, e in errs.items()}
        print(json.dumps({"check": "B14", "shape": [b, h, kh, lq, s_len, d],
                          "causal": causal, "window": window,
                          "plain_err": err_p, "errs": errs, "ok": ok}),
              flush=True)
        if not ok["this"]:
            raise SystemExit("kernel_ab: B14 outside the f64 rule")


def check_bank(trees, randn, dev) -> None:
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0], device=dev)
    for n in (127, 4096, 2 ** 20 + 17, 2 ** 20):
        for off in (0, 1):            # off 1: a view one float off alignment
            hh = randn(4 * n + off)[off:].view(4, n)
            qq = randn(4 * n + off)[off:].view(4, n)
            want = ref.bank_advance(hh, qq, mask).view(torch.int32)
            ok = {tag: torch.equal(bank(libs, hh, qq, mask).view(torch.int32),
                                   want) for tag, libs in trees.items()}
            print(json.dumps({"check": "B9", "n": n, "off": off, "ok": ok}),
                  flush=True)
            if not ok["this"]:
                raise SystemExit(f"kernel_ab: B9 differs at n={n} off={off}")


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
    m, n = x.shape
    part = torch.empty((m, -(-n // span)), dtype=x.dtype, device=x.device)
    out = torch.empty((m,), dtype=x.dtype, device=x.device)
    suffix = "f32" if x.dtype == torch.float32 else "f64"
    run(libs["quantize_ef"], f"absmax_batched_{suffix}", x.device,
        x.data_ptr(), part.data_ptr(), out.data_ptr(), m, n, part.shape[1])
    return out


def check_absmax(trees, spans, dev) -> None:
    """Each tree's B7a against ``ref.absmax_batched`` on its 16-byte and
    element-wise paths (odd n, a view one element off alignment), rows
    salted with -0.0, NaN and +-inf."""
    gen = torch.Generator(device=dev).manual_seed(11)
    for m, n, off in ((1, 1, 0), (4, 4096, 0), (9, 70001, 0), (4, 4100, 1),
                      (3, 2 ** 20 + 4, 0)):
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
            {tag: (lambda libs=libs: flash(libs, q, k, v))
             for tag, libs in having("flash_attention").items()},
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    if "B9" in args.only:
        check_bank(having("censor"), randn, dev)
        hh, qq = randn(4, FULL_D), randn(4, FULL_D)
        mask = torch.tensor([1.0, 0.0, 1.0, 0.0], device=dev)
        work["B9"] = (
            {tag: (lambda libs=libs: bank(libs, hh, qq, mask))
             for tag, libs in having("censor").items()},
            lambda: torch.addcmul(hh, mask[:, None], qq))
    if "B7a" in args.only:
        check_absmax(having("quantize_ef"), spans, dev)
        pend = randn(4, FULL_D)
        fns = {tag: (lambda libs=libs, tag=tag: absmax(libs, spans[tag],
                                                        pend))
               for tag, libs in having("quantize_ef").items()}
        work["B7a"] = (fns, lambda: torch.linalg.vector_norm(
            pend, ord=math.inf, dim=1))
        if args.ablate:
            splits["B7a"] = {tag: split(fn, args.reps)
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
    for name, (fns, lib_fn) in work.items():
        tags = [t for t in fns if t != "this"]
        order = tags + ["this", "this"] + tags[::-1]
        times = {tag: [] for tag in fns}
        for tag in order:
            times[tag].append(_time_ms(fns[tag], args.reps))
        if lib_fn is not None:
            times["library"] = [_time_ms(lib_fn, args.reps)]
        line = {"kernel": name, "ms": times, "card": smi}
        if name in splits:
            line["device_us_per_call_by_kernel"] = splits[name]
        if name == "B7a":
            line["partials_per_worker"] = {
                tag: -(-FULL_D // span) for tag, span in spans.items()}
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()

if __name__ == "__main__":
    main()
