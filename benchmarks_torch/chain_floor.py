#!/usr/bin/env python3
"""The floor of an exact worker fold on the card: one thread's M - 1
dependent adds, timed.

    python3 benchmarks_torch/chain_floor.py [--m 100000] [--reps 10]

Compiles ``benchmarks_torch/csrc/chain_add.cu`` (benchmark-only) with the
port's nvcc flags into ``build/chain_floor/`` and times one thread's chain
of M - 1 dependent ``__fadd_rn`` / ``__dadd_rn`` from registers between
CUDA events (one warm-up, then ``--reps`` launches queued while the card
sleeps). B2 and B6 fold the workers of each column left to right, so on a
tall bank (M >> n) no design of theirs can take less than this. Prints one
JSON line: ms a chain and ns an add for f32 and f64, and the card's name
and power limit. ``kernel_ab.py --only fused`` and ``chip_smoke.py``'s
timing phase call :func:`chain_floor_ms`. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402

SOURCE = Path(__file__).resolve().parent / "csrc" / "chain_add.cu"
OUT = ROOT / "build" / "chain_floor"
# a card this many cycles asleep while the host queues the launches
SLEEP_CYCLES = 20_000_000


@functools.cache
def compile_chain() -> ctypes.CDLL:
    """The chain library, built with the port's flags and reduce.cuh (once
    a process)."""
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / "chain_add.so"
    proc = subprocess.run(
        [build.nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o", str(lib),
         str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"chain_add.cu failed:\n{proc.stdout}"
                           f"{proc.stderr}")
    cdll = ctypes.CDLL(str(lib))
    for suffix in ("f32", "f64"):
        fn = getattr(cdll, f"chain_add_{suffix}")
        fn.argtypes = (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_void_p)
        fn.restype = ctypes.c_int
    return cdll


def chain_floor_ms(m: int = 100_000, reps: int = 10) -> dict:
    """ms of one thread's M - 1 dependent adds, by dtype (``"f32"``,
    ``"f64"``)."""
    lib = compile_chain()
    dev = torch.device("cuda")
    out = {}
    for suffix, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        x = torch.linspace(-1.0, 1.0, 8, dtype=dtype, device=dev)
        res = torch.empty(1, dtype=dtype, device=dev)
        fn = getattr(lib, f"chain_add_{suffix}")

        def call():
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(dev.index or 0, x.data_ptr(), res.data_ptr(), m, stream)
            if rc != 0:
                raise RuntimeError(f"chain_add_{suffix}: CUDA error {rc}")

        call()
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            call()
        b.record()
        torch.cuda.synchronize()
        out[suffix] = a.elapsed_time(b) / reps
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=100_000)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chain_floor: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    ms = chain_floor_ms(args.m, args.reps)
    print(json.dumps({"chain_floor": {"m": args.m, "ms": ms,
                      "ns_per_add": {k: v * 1e6 / (args.m - 1)
                                     for k, v in ms.items()}},
                      "card": smi}), flush=True)


if __name__ == "__main__":
    main()
