"""Shared plumbing for the kernel wrappers.

Dispatch rule (every wrapper): a tensor on the CPU runs the kernel's plain
version from ``ref.py``; a tensor on a CUDA device launches the
hand-written kernel or raises. Nothing falls back from one to the other.

``LAUNCHES`` counts, per kernel, the launches its wrapper made in this
process: each wrapper adds one where it calls into the compiled library
and nowhere else, so a run can show that it went through the kernels. It
is the live ``"kernels"`` namespace of ``obs.compile_log``. ``LAUNCHERS``
counts the same launches per C launcher (a kernel's design and dtype
build, e.g. ``quantize_ef_batched_bf16_f32``): ``build.launch`` adds one
each time it calls one.
"""
from __future__ import annotations

import functools

import torch

from ..obs import compile_log
from .build import EF_DTYPES, GRID_X_MAX, REDUCE_CHUNK

KERNELS = ("censor_delta_sqnorm_batched", "fused_dense_step",
           "int8_stats_batched", "fused_int8_step", "sqnorm_batched",
           "bank_advance", "hb_update", "select_pack_ef_batched",
           "residual_ef_batched", "censor_bank_advance", "absmax_batched",
           "quantize_ef_batched", "censor_delta_sqnorm", "censor_select",
           "flash_attention", "decode_attention", "fold_workers",
           "flash_attention_bwd")

LAUNCHES: dict[str, int] = compile_log.namespace("kernels", KERNELS)
LAUNCHERS: dict[str, int] = compile_log.namespace("launchers")

#: the f32 and f64 banks every kernel takes, by launcher suffix. B1-B6
#: and B9 also take the pairs of ``FUSED_DTYPES``, B8, B7a and the worker
#: fold ``STAGED_DTYPES``, B7b, B10 and B11 ``EF_DTYPES``
KERNEL_DTYPES = {torch.float32: "f32", torch.float64: "f64"}

#: (params dtype P, bank dtype H) of the fused CHB step's kernels (B1, B2,
#: B5, B6), by launcher suffix: P is the gradients' and theta's dtype, H
#: ghat's, as ``opt.make(..., bank_dtype=H)`` gives it. A bf16 bank
#: computes each element operation in f32 and rounds it to bf16; its worker
#: sum and eq. (4) run in f32 (``compute_dtype``). The staged kernels take
#: the same pairs: B3 (theta in P, the worker sum in H), B4 (g in P) and B9
#: (the payload in P), an f32 operand cast to bf16 first (B4, B9) or the
#: bf16 sum to f32 (B3)
FUSED_DTYPES = {(torch.float32, torch.float32): "f32",
                (torch.float64, torch.float64): "f64",
                (torch.bfloat16, torch.bfloat16): "bf16",
                (torch.float32, torch.bfloat16): "f32_bf16"}

#: input dtypes of B8 (a pending tree) and the worker fold (a bank), by
#: launcher suffix: B8 squares and sums a bf16 row in f32, the fold sums a
#: bf16 bank in f32 and rounds once (``core.util.sum_leading``)
STAGED_DTYPES = {torch.float32: "f32", torch.float64: "f64",
                 torch.bfloat16: "bf16"}

def reset_launches() -> None:
    """Zero every launch count, per kernel and per launcher."""
    compile_log.reset("kernels")
    compile_log.reset("launchers")


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


def check_bank(name: str, *tensors: torch.Tensor,
               dtypes: dict = KERNEL_DTYPES) -> str:
    """All operands share one kernel dtype of ``dtypes`` (``KERNEL_DTYPES``,
    or ``STAGED_DTYPES`` for B8, B7a and the fold); returns its suffix."""
    got = {t.dtype for t in tensors}
    if len(got) != 1:
        raise TypeError(f"{name}: operands must share one dtype, got "
                        f"{sorted(str(d) for d in got)}")
    dtype = got.pop()
    if dtype not in dtypes:
        also = ", and bfloat16" if torch.bfloat16 in dtypes else ""
        raise TypeError(f"{name}: bank dtype {dtype} is not supported "
                        f"(the kernels take float32 and float64{also}; "
                        "other dtypes are ROADMAP queue B)")
    return dtypes[dtype]


def fused_suffix(name: str, params, bank: torch.Tensor,
                 err: torch.Tensor | None = None,
                 what: str = "params") -> str:
    """The launcher suffix of B1-B6 or B9: ``params`` (the gradients,
    theta and theta_prev; B9's payload) share one dtype P, ``bank`` has
    dtype H (B3: the worker sum), and (P, H) is a pair of
    ``FUSED_DTYPES``. ``err``, the EF residual, is in H or in P
    (``transport.init`` makes it in P; the steps leave it in H): an f32 err
    on a bf16 bank adds ``_f32``. ``what`` names ``params`` in the error.
    Raises ``TypeError`` on anything else, before any launch."""
    dtypes = {t.dtype for t in params}
    pair = (dtypes.pop() if len(dtypes) == 1 else None, bank.dtype)
    errs = (pair[1], pair[0]) if err is None else (err.dtype,)
    if dtypes or pair not in FUSED_DTYPES or not set(errs) & set(pair):
        got = sorted(str(d) for d in {t.dtype for t in params})
        extra = "" if err is None else f", err {err.dtype}"
        raise TypeError(
            f"{name}: {what} {got} on bank dtype {bank.dtype}{extra} is not "
            "supported: the kernels take one dtype (float32, float64 or "
            f"bfloat16), or float32 {what} on a torch.bfloat16 bank, with "
            "err in the bank's or the params' dtype; float16 and other "
            "pairs are ROADMAP queue B")
    suffix = FUSED_DTYPES[pair]
    if err is not None and err.dtype != bank.dtype:
        suffix += "_" + KERNEL_DTYPES[err.dtype]
    return suffix


def ef_suffix(name: str, *xs: torch.Tensor) -> str:
    """The launcher suffix of B7b, B10 or B11 (``name``) on operands of one
    (M, ...) shape whose dtypes, in the kernel's order, are a key of
    ``EF_DTYPES[name]``; raises ``TypeError`` on any other, before any
    launch."""
    check_shapes(name, *xs)
    table = EF_DTYPES[name]
    key = tuple(x.dtype for x in xs)
    if key not in table:
        raise TypeError(
            f"{name}: bank dtype {xs[0].dtype} with operands "
            f"{[str(d) for d in key]} is not supported (the kernels take "
            "float32 and float64 operands of one dtype, or a bfloat16 "
            "pending leaf with the other operands in bfloat16 or float32; "
            "other dtypes are ROADMAP queue B)")
    return table[key]


def check_shapes(name: str, *xs: torch.Tensor) -> None:
    """Operands share one (M, ...) shape."""
    if xs[0].dim() < 1 or any(x.shape != xs[0].shape for x in xs):
        raise ValueError(f"{name}: operands must share one (M, ...) shape, "
                         f"got {[tuple(x.shape) for x in xs]}")


def check_worker_vector(name: str, what: str, v: torch.Tensor,
                        m: int) -> None:
    """A per-worker (M,) float32 operand such as the mask or the scales."""
    if v.dtype != torch.float32 or tuple(v.shape) != (m,):
        raise ValueError(f"{name}: {what} must be ({m},) float32, got "
                         f"{tuple(v.shape)} {v.dtype}")


def grid_chunks(name: str, shape, n: int, span: int, m: int = 1) -> int:
    """Blocks of ``span`` elements in a worker row of ``n``: grid x of a
    reduction's pass 1 (whose pass 2 runs one block per worker, ``m``, on
    grid x too), of a row-tiled pass, or (``BLOCK_THREADS``) the most of
    a tall pass (B4, B7b, B9, at most a column a thread). Raises, naming
    the limit and the shape, where one launch cannot hold them (the
    launcher would refuse with a bare ``invalid argument``)."""
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
    """Which design B2, B6 and ``fold_workers`` run on an (M, n) bank, on
    a card of ``sms`` SMs. ``"one_pass"``: a thread a column walks the M
    workers (the columns fill the card, or M is small). ``"tall"``: the
    per-element work on the whole card, then the worker fold per column
    tile from shared memory (few columns, each a long chain). Both give
    the same bits."""
    if m <= ONE_PASS_MAX_WORKERS or n >= sms * THREADS_PER_SM:
        return "one_pass"
    return "tall"


#: threads of a block of every kernel here (kThreads in csrc/reduce.cuh)
BLOCK_THREADS = 256


def warp_rows_min_workers(sms: int) -> int:
    """Workers from which the two-pass design of B1, B8, B5 and B7a fills a
    card of ``sms`` SMs with its block a worker (rows of one reduction
    chunk): 1056 on an H100. Below them its eight warps a worker hide more
    load latency than the warp design's one."""
    return sms * THREADS_PER_SM // BLOCK_THREADS


def sqnorm_path(m: int, n: int, sms: int) -> str:
    """Which design B1 (``censor_delta_sqnorm_batched``), B8
    (``sqnorm_batched``), B5 (``int8_stats_batched``) and B7a
    (``absmax_batched``) run on an (M, n) bank, on a card of ``sms`` SMs.
    ``"warp"``: one launch for rows of one reduction chunk (n <= 2048) on
    more than ``warp_rows_min_workers(sms)`` workers, a warp a worker (B7a:
    a power-of-two segment of a warp's lanes a worker). ``"two_pass"``: a
    block a (chunk, worker), then a block a worker folds the partials (B5:
    two such launches, the sums and the abs-maxes; B7a: a block a span of
    16 chunks). Both give the same bits."""
    if n <= REDUCE_CHUNK and m > warp_rows_min_workers(sms):
        return "warp"
    return "two_pass"


def copy16_ok(ts, elems: int) -> bool:
    """Whether a kernel may copy each of these operands 16 bytes (``elems``
    elements) at a time: a unit last stride, the last dim and every other
    stride multiples of ``elems``, and a 16-byte aligned base address."""
    return all(t.stride(-1) == 1 and t.shape[-1] % elems == 0
               and all(st % elems == 0 for st in t.stride()[:-1])
               and t.data_ptr() % 16 == 0 for t in ts)


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count
