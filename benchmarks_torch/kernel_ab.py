#!/usr/bin/env python3
"""B14 and B9 of two source trees, side by side on one card.

    python3 benchmarks_torch/kernel_ab.py --other <dir> [<dir> ...]
        [--only B14 B9] [--ablate] [--reps 10]

Each ``<dir>`` holds another checkout of this repository (for example the
parent commit, unpacked with ``git archive`` into a directory that
``.gitignore`` lists). The script compiles ``flash_attention.cu`` (B14)
and ``censor.cu`` (B9) of every tree with the port's nvcc flags into
``build/kernel_ab/``, prints each compiler log (``-Xptxas -v``), checks
each tree's B9 bits and B14 against the f64 rule of ``chip_smoke.py`` on
a few shapes (it stops if this tree's fail and reports the others'),
then times all at the main path's shapes in turns (the others, this,
this, the others in reverse) beside their library calls:
B14 at serve_long's prefill (B 8, H = K 12, L 2048, d 64, causal, the
model's strided views) against ``scaled_dot_product_attention``, B9 at
M = 4, n = 163,597,056 f32 against ``addcmul``. One JSON line each, and
the card's name and power limit. Needs a CUDA card and nvcc.

``--ablate`` adds two B14 variants built from this tree's source, which
say where its time goes and are wrong by design (their checks report
``false``): ``no_mask`` treats every key tile as inside the band (no
per-score test), ``no_softmax`` also drops the online softmax (no max, no
exps, no shuffles; p = the scaled scores), leaving the two products, the
tile copies and the barriers.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from chip_smoke import (ATTN_FACTOR, ATTN_FLOOR, FULL_D, _flash_f64,  # noqa: E402
                        _time_ms)
from repro_torch.kernels import build, flash_attention, ref  # noqa: E402

OUT = ROOT / "build" / "kernel_ab"
SOURCES = ("flash_attention", "censor")


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
            f = getattr(cdll, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        libs[name] = cdll
    return libs


# (variant, [(text of this tree's flash_attention.cu, its replacement)])
ABLATIONS = (
    ("no_mask", [("    const bool inside = k0 + kBK <= a.s",
                  "    const bool inside = true || k0 + kBK <= a.s")]),
    ("no_softmax", [
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
)


def ablated_trees() -> list[Path]:
    """This tree's B14 with each ablation applied, one directory each."""
    dirs = []
    text = (build.CSRC / "flash_attention.cu").read_text()
    for name, edits in ABLATIONS:
        src = text
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"kernel_ab: ablation {name} no longer "
                                 "applies to flash_attention.cu")
            src = src.replace(old, new)
        csrc = OUT / "ablate" / name / "src/repro_torch/kernels/csrc"
        csrc.mkdir(parents=True, exist_ok=True)
        (csrc / "flash_attention.cu").write_text(src)
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path, nargs="+")
    ap.add_argument("--only", nargs="+", choices=("B14", "B9"),
                    default=["B14", "B9"])
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
    names = [n for k, n in (("B14", "flash_attention"), ("B9", "censor"))
             if k in args.only]
    others = list(args.other)
    if args.ablate and "B14" in args.only:
        others += ablated_trees()
    trees = {d.name: compile_tree(d.name, d / "src/repro_torch/kernels/csrc",
                                  names if d in args.other
                                  else ["flash_attention"])
             for d in others}
    trees["this"] = compile_tree("this", build.CSRC, names)
    gen = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    work = {}
    if "B14" in args.only:
        check_flash(trees, randn)
        b, h, l, d = 8, 12, 2048, 64
        q, k, v = (randn(b, l, h, d).transpose(1, 2) for _ in range(3))
        work["B14"] = (
            {tag: (lambda libs=libs: flash(libs, q, k, v))
             for tag, libs in trees.items()},
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    if "B9" in args.only:
        trees = {t: libs for t, libs in trees.items() if "censor" in libs}
        check_bank(trees, randn, dev)
        hh, qq = randn(4, FULL_D), randn(4, FULL_D)
        mask = torch.tensor([1.0, 0.0, 1.0, 0.0], device=dev)
        work["B9"] = (
            {tag: (lambda libs=libs: bank(libs, hh, qq, mask))
             for tag, libs in trees.items()},
            lambda: torch.addcmul(hh, mask[:, None], qq))
    for name, (fns, lib_fn) in work.items():
        tags = [t for t in fns if t != "this"]
        order = tags + ["this", "this"] + tags[::-1]
        times = {tag: [] for tag in fns}
        for tag in order:
            times[tag].append(_time_ms(fns[tag], args.reps))
        times["library"] = [_time_ms(lib_fn, args.reps)]
        print(json.dumps({"kernel": name, "ms": times, "card": smi}),
              flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
