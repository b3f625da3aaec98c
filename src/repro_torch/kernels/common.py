"""Shared plumbing for the kernel wrappers.

Dispatch rule (every wrapper): a tensor on the CPU runs the kernel's plain
version from ``ref.py``; a tensor on a CUDA device launches the
hand-written kernel or raises. Nothing falls back from one to the other.

``LAUNCHES`` counts, per kernel, the launches its wrapper made in this
process: each wrapper adds one where it calls into the compiled library
and nowhere else, so a run can show that it went through the kernels. It
is the live ``"kernels"`` namespace of ``obs.compile_log``.
"""
from __future__ import annotations

import functools

import torch

from ..obs import compile_log
from .build import GRID_X_MAX

KERNELS = ("censor_delta_sqnorm_batched", "fused_dense_step",
           "int8_stats_batched", "fused_int8_step", "sqnorm_batched",
           "bank_advance", "hb_update", "select_pack_ef_batched",
           "residual_ef_batched", "censor_bank_advance", "absmax_batched",
           "quantize_ef_batched", "censor_delta_sqnorm", "censor_select",
           "flash_attention", "decode_attention")

LAUNCHES: dict[str, int] = compile_log.namespace("kernels", KERNELS)

#: bank dtypes the kernels are built for (sub-f32 banks are not ported)
KERNEL_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


def reset_launches() -> None:
    """Zero every launch count."""
    compile_log.reset("kernels")


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 for sub-f32 params, the params' own precision otherwise."""
    return torch.promote_types(dtype, torch.float32)


def on_card(name: str, *tensors: torch.Tensor,
            contiguous: bool = True) -> bool:
    """Which side of the dispatch rule the operands fall on.

    True: all operands are tensors on one CUDA device, contiguous unless
    the kernel reads by strides (``contiguous=False``). False: all lie on
    the CPU. Anything else raises.
    """
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: operands must all lie on the CPU or all "
                         f"on one CUDA device, got "
                         f"{sorted(str(t.device) for t in tensors)}")
    if contiguous and not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: CUDA operands must be contiguous")
    return True


def check_bank(name: str, *tensors: torch.Tensor) -> str:
    """All operands share one kernel dtype; returns its suffix."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise TypeError(f"{name}: operands must share one dtype, got "
                        f"{sorted(str(d) for d in dtypes)}")
    dtype = dtypes.pop()
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: bank dtype {dtype} is not supported "
                        "(the kernels take float32 and float64)")
    return KERNEL_DTYPES[dtype]


def check_leaves(name: str, *xs: torch.Tensor) -> str:
    """Operands share one (M, ...) shape and one kernel dtype; returns its
    suffix."""
    if xs[0].dim() < 1 or any(x.shape != xs[0].shape for x in xs):
        raise ValueError(f"{name}: operands must share one (M, ...) shape, "
                         f"got {[tuple(x.shape) for x in xs]}")
    return check_bank(name, *xs)


def check_worker_vector(name: str, what: str, v: torch.Tensor,
                        m: int) -> None:
    """A per-worker (M,) float32 operand such as the mask or the scales."""
    if v.dtype != torch.float32 or tuple(v.shape) != (m,):
        raise ValueError(f"{name}: {what} must be ({m},) float32, got "
                         f"{tuple(v.shape)} {v.dtype}")


def grid_chunks(name: str, shape, n: int, span: int, m: int = 1) -> int:
    """Blocks of ``span`` elements in a worker row of ``n``: grid x of a
    reduction's pass 1 (whose pass 2 runs one block per worker, ``m``, on
    grid x too) or of a row-tiled pass. Raises, naming the limit and the
    shape, where one launch cannot hold them (the launcher would refuse
    with a bare ``invalid argument``)."""
    chunks = -(-n // span)
    if max(chunks, m) > GRID_X_MAX:
        raise ValueError(
            f"{name}: shape {tuple(shape)} needs {max(chunks, m)} blocks on "
            f"grid x ({chunks} of {span} elements a worker row, {m} "
            f"workers); a launch holds at most 2^31 - 1 = {GRID_X_MAX}")
    return chunks


#: workers up to which B2 and B6 keep their one-pass design on any bank:
#: a thread's walk of M rows costs about what the tall design's second
#: launch does
ONE_PASS_MAX_WORKERS = 64
#: threads one SM holds (Hopper): the one-pass design fills the card once
#: it has a column for each
THREADS_PER_SM = 2048


def fold_path(m: int, n: int, sms: int) -> str:
    """Which design B2 and B6 run on an (M, n) bank, on a card of ``sms``
    SMs. ``"one_pass"``: a thread a column walks the M workers (the
    columns fill the card, or M is small). ``"tall"``: the per-element
    work on the whole card, then the worker fold per column tile from
    shared memory (few columns, each a long chain). Both give the same
    bits."""
    if m <= ONE_PASS_MAX_WORKERS or n >= sms * THREADS_PER_SM:
        return "one_pass"
    return "tall"


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count
