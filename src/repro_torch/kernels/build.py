"""Compile ``csrc/*.cu`` with ``nvcc`` and load the libraries with ctypes.

Each source becomes one shared library with a plain C interface for
``sm_90a`` (Hopper), built on first use into ``build/repro_torch_kernels/``
at the repository root. A library's file name carries a digest of its
sources and flags, so an edited kernel is rebuilt and a stale one is
never loaded. :func:`build` starts one ``nvcc`` per missing library, all
at once. Nothing is compiled or loaded at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..obs import compile_log

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("censor", "fused_step", "hb_update", "topk_pack", "lowrank_ef",
           "quantize_ef", "flash_attention", "decode_attention")

NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

#: elements of one worker row that one reduction block sums (kChunk in
#: csrc/reduce.cuh); the launchers reject a partial buffer of another size
REDUCE_CHUNK = 2048
#: elements of one worker row behind one B7a partial (kAbsmaxSpan in
#: csrc/quantize_ef.cu: 16 chunks); its launcher rejects another count
ABSMAX_SPAN = 16 * REDUCE_CHUNK
#: elements of one worker row that one block of a row-tiled pass (B4, B7b,
#: B9, B12b) covers (kRowTile in csrc/reduce.cuh)
ROW_TILE = 1024
#: blocks one launch holds on grid x (kMaxGridX in csrc/reduce.cuh); the
#: per-worker kernels put the worker on grid y and walk any M with a
#: stride, and pass 2 of a reduction runs one block per worker on grid x
GRID_X_MAX = 2 ** 31 - 1
#: cache slots of one partial of the decode-attention kernel (kDecodeSlots
#: in csrc/decode_attention.cu); its launcher rejects partial buffers of
#: another length
DECODE_SLOTS = 32

# every launcher takes (device index, operands..., stream) and returns a
# cudaError_t; pointers and the stream must be c_void_p, or ctypes would
# pass them as 32-bit ints
_DEV, _P, _I64, _F64 = ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, \
    ctypes.c_double
_REDUCE_ARGS = (_DEV,) + (_P,) * 4 + (_I64, _I64, _I64, _P)
_DENSE_ARGS = (_DEV,) + (_P,) * 8 + (_I64, _I64, _F64, _F64, _P)
_STATS_ARGS = (_DEV,) + (_P,) * 7 + (_I64, _I64, _I64, _P)
_INT8_ARGS = (_DEV,) + (_P,) * 11 + (_I64, _I64, _F64, _F64, _P)
_SQNORM_ARGS = (_DEV,) + (_P,) * 3 + (_I64, _I64, _I64, _P)
_BANK_ARGS = (_DEV,) + (_P,) * 4 + (_I64, _I64, _P)
_HB_ARGS = (_DEV,) + (_P,) * 4 + (_I64, _F64, _F64, _P)
_PACK_ARGS = (_DEV,) + (_P,) * 6 + (_I64, _I64, _P)
_RESIDUAL_ARGS = (_DEV,) + (_P,) * 5 + (_I64, _I64, _P)
_SELECT_ARGS = (_DEV,) + (_P,) * 3 + (_I64, ctypes.c_int, _P)
# the attention launchers take their sizes and strides as a host int64
# array (a pointer) and the softmax scale as a double
_FLASH_ARGS = (_DEV,) + (_P,) * 5 + (_F64, _P)
_DECODE_ARGS = (_DEV,) + (_P,) * 8 + (_F64, _P)
#: the dtypes of the single-tensor entry points B12a/B12b and of the
#: attention kernels, by launcher suffix
SINGLE_DTYPES = {torch.float32: "f32", torch.float64: "f64",
                 torch.bfloat16: "bf16"}
ATTENTION_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _both(name: str, argtypes: tuple) -> dict:
    """The f32 and f64 launchers of one kernel."""
    return {f"{name}_{s}": argtypes for s in ("f32", "f64")}


def _pairs(name: str, argtypes: tuple) -> dict:
    """The launchers of one single-tensor kernel, one per (g, ghat) dtype
    pair."""
    return {f"{name}_{a}_{b}": argtypes for a in SINGLE_DTYPES.values()
            for b in SINGLE_DTYPES.values()}


SIGNATURES = {
    "censor": {**_both("censor_delta_sqnorm_batched", _REDUCE_ARGS),
               **_both("sqnorm_batched", _SQNORM_ARGS),
               **_both("bank_advance", _BANK_ARGS),
               **_both("censor_bank_advance", _BANK_ARGS),
               **_pairs("censor_delta_sqnorm", _REDUCE_ARGS),
               **_pairs("censor_select", _SELECT_ARGS)},
    "fused_step": {**_both("fused_dense_step", _DENSE_ARGS),
                   **_both("fused_dense_step_tall", _DENSE_ARGS),
                   **_both("int8_stats_batched", _STATS_ARGS),
                   **_both("fused_int8_step", _INT8_ARGS),
                   **_both("fused_int8_step_tall", _INT8_ARGS)},
    "hb_update": _both("hb_update", _HB_ARGS),
    "topk_pack": _both("select_pack_ef_batched", _PACK_ARGS),
    "lowrank_ef": _both("residual_ef_batched", _RESIDUAL_ARGS),
    "quantize_ef": {**_both("absmax_batched", _SQNORM_ARGS),
                    **_both("quantize_ef_batched", _PACK_ARGS)},
    "flash_attention": {f"flash_attention_{s}": _FLASH_ARGS
                        for s in ATTENTION_DTYPES.values()},
    "decode_attention": {f"decode_attention_{s}": _DECODE_ARGS
                         for s in ATTENTION_DTYPES.values()},
}

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit (set CUDA_HOME)")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every library in ``names`` that is not built yet.

    One ``nvcc`` per source, all started together. Returns each compiled
    library's compiler log (``-Xptxas=-v`` register and spill counts);
    raises ``RuntimeError`` with the log of any source that failed.
    """
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    jobs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = {}, []
    for name, out, tmp, proc in jobs:
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}.cu: nvcc exited {proc.returncode}\n"
                          f"{logs[name]}")
        else:
            os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
            compile_log.record("build", name)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = (ctypes.c_int,)
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def launch(lib_name: str, fn_name: str, device: torch.device, *args
           ) -> None:
    """Call one C launcher on ``device`` and PyTorch's current stream there;
    raise if it reports a CUDA error (a refused launch never runs, and a
    later synchronize would not report it)."""
    lib = library(lib_name)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib, fn_name)(device.index, *args, stream)
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{fn_name}: CUDA error {rc}: {msg}")
