"""The flash-attention backward pass of training, on the card (port-only).

Wraps ``csrc/flash_backward.cu``: the backward of ``repro/models/flash.py``'s
custom VJP, which the JAX package leaves to XLA (no Pallas kernel computes
it). ``models.flash.flash_attention`` runs it on the ``cuda`` backend, once
a layer a worker in a training step, after B14 wrote the forward's output
and log-sum-exp. CPU tensors run ``ref.flash_attention_bwd``; CUDA tensors
launch the kernel or raise. The kernel reads its operands by strides and
takes any Lq, S and head dim up to 256, in float32
(``flash_attention_bwd_f32``) or bfloat16 (``flash_attention_bwd_bf16``:
dq, dk and dv rounded once at the store; lse f32 in both). Where
:func:`flash_attention.async_copy_ok` (f32) or
:func:`flash_attention.tc_copy_ok` (bf16) holds for an operand it copies
that operand 16 bytes at a time (bf16: by TMA, where it holds for q, k, v
and dO); otherwise element by element.

Both builds run three grids a call: D = rowsum(dO o) first. The f32 build
(a SIMT design) then works by key tile: a block owns a tile of keys of one
kv head and walks the query tiles of its band, computing each (query tile,
key tile) pair's s, p, dp and ds once (five products). dk and dv add up in
registers; each pair's dq partial goes to a scratch slot of its own, and
a last grid sums each query tile's slots in key-tile order. The bf16 build
(a tensor-core design, ``wgmma``) runs flash.py's own two passes: dk and dv
by key tile (a block walks the query tiles of its band, as above), then dq
by query tile (a block walks the key tiles of its band in order), with no
dq scratch: its scratch is D alone. No float atomics in either, so two
calls give the same bits. :func:`plan` is each layout in Python: the tiles
by head dim, the grids, the bands of (query tile, key tile) pairs and (f32)
the slots, and the scratch's bytes, which the launcher recomputes and
checks.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import ref
from .build import ATTENTION_DTYPES, launch
from .common import count_launch, on_card
from .flash_attention import _check, async_copy_ok, tc_copy_ok

#: (query rows, keys) of one tile pair by head-dim capacity: the f32
#: design's (BwdTiles in csrc/flash_backward.cu)
TILES = {64: (64, 32), 128: (32, 32), 256: (32, 32)}
#: the bf16 design's tiles by head-dim capacity (TcBwdTiles): the dk/dv
#: pass's query rows a stage and keys a block, then the dq pass's query rows
#: a block and keys a stage
TILES_BF16 = {64: (64, 64, 128, 64), 128: (64, 64, 128, 64),
              256: (32, 64, 128, 32)}


def head_dim_cap(d: int) -> int:
    """The kernel's instantiation for head dim ``d`` (64, 128 or 256)."""
    return 64 if d <= 64 else 128 if d <= 128 else 256


def row_has_key(qpos: int, s_len: int, causal: bool, window) -> bool:
    """Whether query row ``qpos`` has a valid key in [0, S)."""
    lo, hi = 0, s_len - 1
    if causal:
        hi = min(hi, qpos)
    if window is not None:
        lo = max(lo, qpos - window + 1)
    return lo <= hi


def key_tiles(qt: int, lq: int, s_len: int, bq: int, bk: int, causal: bool,
              window) -> tuple[int, int]:
    """The key tiles [lo, hi) that query tile ``qt`` meets: its rows'
    causal/window band, or every key tile if its last row has no valid key
    (p = 1 on every key there). The rows with a key form a prefix of
    [0, Lq), so the tile's last row decides."""
    q0, qlast = qt * bq, min(qt * bq + bq, lq) - 1
    nk = -(-s_len // bk)
    if not row_has_key(qlast, s_len, causal, window):
        return 0, nk
    klo, khi = 0, s_len - 1
    if causal:
        khi = min(khi, qlast)
    if window is not None:
        klo = max(klo, q0 - window + 1)
    return klo // bk, khi // bk + 1


@dataclass(frozen=True)
class Plan:
    """One call's layout. ``band[qt]`` is the key tiles [lo, hi) that query
    tile qt meets, ``base[qt]`` the slots of the query tiles before it in
    one head's band, ``pairs`` one head's slots; a slot holds ``slot``
    floats (bq x dmax). The scratch is the partials (b h pairs slots), then
    D (b h lq floats)."""
    b: int
    h: int
    kh: int
    lq: int
    dmax: int
    bq: int
    bk: int
    nq: int
    nk: int
    band: tuple
    base: tuple
    pairs: int

    @property
    def g(self) -> int:
        return self.h // self.kh

    @property
    def blocks(self) -> int:
        """Blocks of the main grid: one per (b, kv head, key tile)."""
        return self.b * self.kh * self.nk

    @property
    def slot(self) -> int:
        return self.bq * self.dmax

    @property
    def part_floats(self) -> int:
        return self.b * self.h * self.pairs * self.slot

    @property
    def scratch_bytes(self) -> int:
        return 4 * (self.part_floats + self.b * self.h * self.lq)

    def block(self, index: int) -> tuple[int, int, int]:
        """(batch row, kv head, key tile) of main-grid block ``index``: the
        key tiles in order, the lowest (the heaviest under causal) first."""
        nbk = self.b * self.kh
        bk, kt = index % nbk, index // nbk
        return bk // self.kh, bk % self.kh, kt

    def visits(self, kt: int) -> list[tuple[int, int]]:
        """The (head of the group, query tile) pairs a block of key tile
        ``kt`` walks, in its order: the G heads in order, each head's query
        tiles from the last down."""
        return [(gi, qt) for gi in range(self.g)
                for qt in range(self.nq - 1, -1, -1)
                if self.band[qt][0] <= kt < self.band[qt][1]]

    def slot_offset(self, bi: int, hq: int, qt: int, kt: int) -> int:
        """First float of the dq partial of (batch row, query head, query
        tile, key tile)."""
        lo = self.band[qt][0]
        return ((bi * self.h + hq) * self.pairs + self.base[qt] + kt - lo
                ) * self.slot

    def heaviest_block_fma(self, d: int) -> int:
        """FMAs of the block with the most pairs: five bq x bk x d products
        a pair."""
        return max(len(self.visits(kt)) for kt in range(self.nk)) * 5 * \
            self.bq * self.bk * d


@dataclass(frozen=True)
class Walk:
    """One pass of the bf16 design over one head's band: ``band[qt]`` is
    the key tiles [lo, hi) (``nk`` tiles of ``bk`` keys) that query tile qt
    (``nq`` tiles of ``bq`` rows) meets."""
    g: int
    bq: int
    bk: int
    nq: int
    nk: int
    band: tuple

    def visits(self, kt: int) -> list[tuple[int, int]]:
        """The (head of the group, query tile) pairs a dk/dv block of key
        tile ``kt`` walks, in its order (csrc's next_visit): the G heads in
        order, each head's query tiles from the last down."""
        return [(gi, qt) for gi in range(self.g)
                for qt in range(self.nq - 1, -1, -1)
                if self.band[qt][0] <= kt < self.band[qt][1]]

    def key_walk(self, qt: int) -> list[int]:
        """The key tiles a dq block of query tile ``qt`` walks, in order."""
        return list(range(*self.band[qt]))


@dataclass(frozen=True)
class TcPlan:
    """The bf16 design's layout of one call: the dk/dv pass ``kv`` (a block
    per (batch row, kv head, key tile) walks ``kv.visits``) and the dq pass
    ``dq`` (a block per (batch row, head, query tile) walks
    ``dq.key_walk``). The scratch is D alone (b h lq floats)."""
    b: int
    h: int
    kh: int
    lq: int
    dmax: int
    causal: bool
    kv: Walk
    dq: Walk

    @property
    def g(self) -> int:
        return self.h // self.kh

    @property
    def scratch_bytes(self) -> int:
        return 4 * self.b * self.h * self.lq

    @property
    def kv_blocks(self) -> int:
        return self.b * self.kh * self.kv.nk

    @property
    def dq_blocks(self) -> int:
        return self.b * self.h * self.dq.nq

    def kv_block(self, index: int) -> tuple[int, int, int]:
        """(batch row, kv head, key tile) of dk/dv block ``index``: the key
        tiles in order, the lowest (the heaviest under causal) first."""
        nbk = self.b * self.kh
        bk, kt = index % nbk, index // nbk
        return bk // self.kh, bk % self.kh, kt

    def dq_block(self, index: int) -> tuple[int, int, int]:
        """(batch row, head, query tile) of dq block ``index``: under causal
        the last query tile (the heaviest) first."""
        nbh = self.b * self.h
        bh, rank = index % nbh, index // nbh
        qt = self.dq.nq - 1 - rank if self.causal else rank
        return bh // self.h, bh % self.h, qt


def _walk(g, lq, s_len, bq, bk, causal, window) -> Walk:
    nq, nk = -(-lq // bq), -(-s_len // bk)
    return Walk(g, bq, bk, nq, nk, tuple(
        key_tiles(qt, lq, s_len, bq, bk, causal, window) for qt in range(nq)))


@functools.lru_cache(maxsize=256)
def plan(b: int, h: int, kh: int, lq: int, s_len: int, d: int, causal: bool,
         window, dtype: torch.dtype = torch.float32):
    """The layout the kernel uses for one call: a :class:`Plan` for float32
    (csrc/flash_backward.cu's plan_bytes and key_tiles), a :class:`TcPlan`
    for bfloat16 (launch_bwd_tc, next_visit and band_tiles)."""
    dmax = head_dim_cap(d)
    if dtype == torch.bfloat16:
        kv_bq, kv_bk, dq_bq, dq_bk = TILES_BF16[dmax]
        return TcPlan(b, h, kh, lq, dmax, bool(causal),
                      _walk(h // kh, lq, s_len, kv_bq, kv_bk, causal, window),
                      _walk(h // kh, lq, s_len, dq_bq, dq_bk, causal, window))
    if dtype != torch.float32:
        raise TypeError(f"flash_backward.plan: no design for {dtype}")
    bq, bk = TILES[dmax]
    nq, nk = -(-lq // bq), -(-s_len // bk)
    band = tuple(key_tiles(qt, lq, s_len, bq, bk, causal, window)
                 for qt in range(nq))
    base, pairs = [], 0
    for lo, hi in band:
        base.append(pairs)
        pairs += hi - lo
    return Plan(b, h, kh, lq, dmax, bq, bk, nq, nk, band, tuple(base), pairs)


def _dims(q, k, v, o, do, dq, dk, dv, causal, window,
          scratch_bytes) -> ctypes.Array:
    """The launcher's dims: sizes, the eight operands' strides, the masks,
    the bit mask of the operands read 16 bytes at a time (kVecQ, kVecK,
    kVecV, kVecDO, kVecO in csrc/flash_backward.cu) and the scratch's
    bytes."""
    b, h, lq, d = q.shape
    kh, s_len = k.shape[1], k.shape[2]
    strides = [st for t in (q, k, v, o, do, dq, dk, dv) for st in t.stride()]
    ok = async_copy_ok if q.dtype == torch.float32 else tc_copy_ok
    vec = sum(1 << i for i, t in enumerate((q, k, v, do, o)) if ok(t))
    return (ctypes.c_int64 * 43)(
        b, h, kh, lq, s_len, d, *strides, int(bool(causal)),
        int(window is not None), 0 if window is None else int(window), vec,
        scratch_bytes)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window=None, scale=None):
    """(dq, dk, dv) of ``do``, the gradient of the attention output ``o``,
    from the forward's ``lse`` (B14's ``return_lse``): FlashAttention-2's
    equations as ``repro/models/flash.py``'s custom VJP computes them (the
    same masks and -1e30). dq comes back in q's shape and strides, dk and
    dv in k's and v's (``torch.empty_like``). q, k, v, o and do share one
    dtype, float32 or bfloat16 (lse is float32); on the card any other
    raises ``TypeError`` naming ROADMAP queue B, before any launch. On the
    card the wrapper allocates one scratch buffer (``torch.empty``,
    :func:`plan`'s bytes: f32 the dq partials, then D; bf16 D alone) and
    counts one launch of ``flash_attention_bwd`` a call (``build.launch``
    counts its launcher, ``flash_attention_bwd_f32`` or ``_bf16``, in
    ``common.LAUNCHERS``); the C entry point runs three grids on the
    current stream (D; the key-tile walk; f32 the sum of dq's partials,
    bf16 the query-tile walk), the last two by programmatic dependent
    launch."""
    name = "flash_attention_bwd"
    b, h, kh, lq, s_len, d = _check(name, q, k, v)
    for what, t, shape in (("o", o, q.shape), ("do", do, q.shape),
                           ("lse", lse, (b, h, lq))):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {what} must have shape "
                             f"{tuple(shape)}, got {tuple(t.shape)}")
    if scale is None:
        scale = d ** -0.5
    if not on_card(name, q, k, v, o, lse, do, contiguous=False):
        return ref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                       window=window, scale=scale)
    dtypes = {t.dtype for t in (q, k, v, o, do)}
    if len(dtypes) != 1 or q.dtype not in ATTENTION_DTYPES \
            or lse.dtype != torch.float32:
        raise TypeError(
            f"{name}: q, k, v, o and do in {sorted(map(str, dtypes))} with "
            f"lse in {lse.dtype} are not supported (the kernel takes one "
            "dtype, float32 or bfloat16, and an f32 lse; other dtypes are "
            "ROADMAP queue B)")
    if s_len == 0 or d > 256:
        raise ValueError(f"{name}: needs at least one key and a head dim "
                         f"up to 256, got S={s_len}, d={d}")
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    window = None if window is None else int(window)
    layout = plan(b, h, kh, lq, s_len, d, bool(causal), window, q.dtype)
    scratch = torch.empty(layout.scratch_bytes, dtype=torch.uint8,
                          device=q.device)
    dims = _dims(q, k, v, o, do, dq, dk, dv, causal, window,
                 layout.scratch_bytes)
    count_launch(name)
    launch("flash_backward", f"{name}_{ATTENTION_DTYPES[q.dtype]}", q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
           do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
           dv.data_ptr(), scratch.data_ptr(), ctypes.addressof(dims),
           float(scale))
    return dq, dk, dv
