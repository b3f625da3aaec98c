"""The flash backward kernel's plans (``kernels/flash_backward.py:plan``),
held against a brute-force enumeration of the attention mask on the CPU.

The f32 build (``csrc/flash_backward.cu``'s SIMT design) walks, for each
key tile, the query tiles that meet it and writes each (query tile, key
tile) pair's dq partial to a slot of its own; its last grid sums each
query tile's slots in key-tile order. The bf16 build (the tensor-core
design, ``plan(..., dtype=torch.bfloat16)``) runs two passes with no dq
scratch: dk and dv by key tile (a block walks the query tiles that meet
it, as the f32 build does, on its own tiles), then dq by query tile (a
block walks the key tiles of its band in order); its scratch is D alone.
Everything the kernel computes on the host or from integers is mirrored
by ``plan``: the tiles by head dim, the grids and their order, the bands
of pairs, the f32 slots and the scratch's bytes. Checked here for both
builds (the bf16 cases' ids start with ``bf16-``) over the shapes of
``chip_smoke.py``'s ``FLASH_BWD_CASES`` and over windows narrower than a
tile:
  * every pair with an unmasked (q, k), or with a query row that has no
    valid key (p = 1 on every key there), is visited, once a head, and
    each query tile has as many slots as key tiles meet it;
  * the slots are disjoint and fill the partials exactly, and the scratch
    holds the band's pairs (not L^2) plus D;
  * the rows with a valid key form a prefix (the kernel tests a tile's
    last row only);
  * a float64 emulation of the kernel's dataflow from the plan (per-pair
    products, slots, the key-tile-order sum; bf16: the two passes' walks)
    equals the backward's f64 function to 1e-12: a pair missed or a slot
    misplaced would show there.
The kernel itself runs only on a card (tests/test_torch_flash_bwd_cuda.py).
"""
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the repository root's script)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_backward as fb  # noqa: E402

# (b, h, kh, lq, s, d, causal, window): windows narrower than a tile (64
# query rows, 32 keys at d <= 64; 32 x 32 above), on and off the tiles'
# edges, causal and not, with rows that have no valid key (Lq > S)
NARROW = [
    (1, 2, 1, 130, 130, 64, True, 16),
    (1, 2, 2, 200, 200, 64, True, 1),
    (1, 2, 1, 97, 97, 64, False, 16),
    (1, 2, 1, 150, 100, 64, True, 20),
    (1, 2, 2, 96, 96, 80, True, 5),
    (1, 2, 1, 70, 40, 256, False, 31),
    (1, 4, 2, 129, 129, 64, True, 33),
    (1, 2, 1, 100, 160, 64, False, 20),
]
CASES = [c[:8] for c in chip_smoke.FLASH_BWD_CASES] + NARROW
IDS = [f"b{c[0]}h{c[1]}k{c[2]}q{c[3]}s{c[4]}d{c[5]}"
       f"{'c' if c[6] else 'n'}w{c[7]}" for c in CASES]
# each case under both builds: the f32 plan keeps the case's id, the bf16
# plan's id starts with "bf16-"
DTYPES = (torch.float32, torch.bfloat16)
BOTH = [(c, dt) for dt in DTYPES for c in CASES]
BOTH_IDS = IDS + [f"bf16-{i}" for i in IDS]


def _mask(lq, s_len, causal, window) -> np.ndarray:
    """(lq, s) boolean: key k valid for query row q."""
    qpos, kpos = np.arange(lq)[:, None], np.arange(s_len)[None, :]
    m = np.ones((lq, s_len), dtype=bool)
    if causal:
        m &= kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m


def _needed(p: fb.Plan, lq, s_len, causal, window) -> set:
    """The (query tile, key tile) pairs whose p is not all 0: an unmasked
    (q, k), or a row with no valid key (p = 1 on every key)."""
    m = _mask(lq, s_len, causal, window)
    m[~m.any(axis=1)] = True
    q, k = np.nonzero(m)
    return set(zip((q // p.bq).tolist(), (k // p.bk).tolist()))


def _visited(p) -> list:
    """(query tile, key tile) of every visit of one head's blocks (a plan
    or walk that goes by key tile)."""
    return [(qt, kt) for kt in range(p.nk) for gi, qt in p.visits(kt)
            if gi == 0]


def _band(p) -> set:
    return {(qt, kt) for qt, (lo, hi) in enumerate(p.band)
            for kt in range(lo, hi)}


def test_tiles_mirror_the_kernel():
    """``TILES`` is ``BwdTiles`` of the source, and the launcher's C
    arity is ``build.SIGNATURES``' (the scratch pointer included)."""
    src = (build.CSRC / "flash_backward.cu").read_text()
    found = {int(dmax): (int(bq), int(bk)) for dmax, bq, bk in re.findall(
        r"struct BwdTiles<(\d+)> \{\s*static constexpr int BQ = (\d+), "
        r"BK = (\d+)", src)}
    assert found == fb.TILES
    params = re.search(r"\bint flash_attention_bwd_f32\(([^)]*)\)", src)
    assert len(params.group(1).split(",")) == len(
        build.SIGNATURES["flash_backward"]["flash_attention_bwd_f32"]) == 14


def test_bf16_tiles_mirror_the_kernel():
    """``TILES_BF16`` is ``TcBwdTiles`` of the source (the dk/dv pass's
    query rows a stage and keys a block, the dq pass's query rows a block
    and keys a stage), and the bf16 launcher's C arity is
    ``build.SIGNATURES``'."""
    src = (build.CSRC / "flash_backward.cu").read_text()
    found = {int(dmax): tuple(map(int, t)) for dmax, *t in re.findall(
        r"struct TcBwdTiles<(\d+)> \{\s*static constexpr int KV_BQ = (\d+), "
        r"KV_BK = (\d+), DQ_BQ = (\d+), DQ_BK = (\d+);", src)}
    assert found == fb.TILES_BF16
    params = re.search(r"\bint flash_attention_bwd_bf16\(([^)]*)\)", src)
    assert len(params.group(1).split(",")) == len(
        build.SIGNATURES["flash_backward"]["flash_attention_bwd_bf16"]) == 14


def test_plan_refuses_a_dtype_without_a_design():
    with pytest.raises(TypeError, match="no design"):
        fb.plan(1, 2, 1, 64, 64, 64, True, None, torch.float16)


@pytest.mark.parametrize("d, cap", [(1, 64), (33, 64), (64, 64), (65, 128),
                                    (80, 128), (128, 128), (129, 256),
                                    (256, 256)])
def test_head_dim_picks_the_instantiation(d, cap):
    assert fb.head_dim_cap(d) == cap


def _check_key_tile_walk(p, lq, s_len, causal, window):
    """A walk by key tile (the f32 plan, the bf16 dk/dv pass): every pair
    the mask needs visited, once a head, and no other."""
    visited = _visited(p)
    assert len(visited) == len(set(visited))
    band = _band(p)
    assert set(visited) == band
    assert _needed(p, lq, s_len, causal, window) == band
    # each head of a group walks the same pairs; the walk goes by head,
    # each head's query tiles from the last down
    for kt in range(p.nk):
        walk = p.visits(kt)
        assert [qt for gi, qt in walk] == [qt for _ in range(p.g)
                                          for gi, qt in walk if gi == 0]
        assert walk == sorted(walk, key=lambda v: (v[0], -v[1]))
    for qt, (lo, hi) in enumerate(p.band):
        assert 0 <= lo < hi <= p.nk
        assert sum(qt_ == qt for qt_, _ in visited) == hi - lo
    return visited


@pytest.mark.parametrize("case, dtype", BOTH, ids=BOTH_IDS)
def test_band_visits_every_needed_pair_once(case, dtype):
    b, h, kh, lq, s_len, d, causal, window = case
    p = fb.plan(b, h, kh, lq, s_len, d, causal, window, dtype)
    if dtype == torch.bfloat16:
        kv_bq, kv_bk, dq_bq, dq_bk = fb.TILES_BF16[fb.head_dim_cap(d)]
        for w, bq, bk in ((p.kv, kv_bq, kv_bk), (p.dq, dq_bq, dq_bk)):
            assert (w.bq, w.bk, w.g) == (bq, bk, h // kh)
            assert (w.nq, w.nk) == (-(-lq // bq), -(-s_len // bk))
        _check_key_tile_walk(p.kv, lq, s_len, causal, window)
        # the dq pass: each query tile's key tiles in order, each pair the
        # mask needs once
        walked = [(qt, kt) for qt in range(p.dq.nq)
                  for kt in p.dq.key_walk(qt)]
        assert len(walked) == len(set(walked))
        assert set(walked) == _band(p.dq) == _needed(p.dq, lq, s_len,
                                                      causal, window)
        assert all(p.dq.key_walk(qt) == sorted(p.dq.key_walk(qt))
                   for qt in range(p.dq.nq))
        return
    assert (p.bq, p.bk) == fb.TILES[fb.head_dim_cap(d)]
    assert (p.nq, p.nk) == (-(-lq // p.bq), -(-s_len // p.bk))
    visited = _check_key_tile_walk(p, lq, s_len, causal, window)
    assert len(visited) == p.pairs


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_slots_are_disjoint_and_hold_the_band(case):
    b, h, kh, lq, s_len, d, causal, window = case
    p = fb.plan(b, h, kh, lq, s_len, d, causal, window)
    offs = sorted(p.slot_offset(bi, khi * p.g + gi, qt, kt)
                  for bi in range(b) for khi in range(kh)
                  for kt in range(p.nk) for gi, qt in p.visits(kt))
    assert offs == list(range(0, p.part_floats, p.slot))
    assert p.slot == p.bq * p.dmax
    assert p.base == tuple(np.cumsum([0] + [hi - lo for lo, hi in p.band]
                                     )[:-1].tolist())
    assert p.part_floats == b * h * p.pairs * p.slot
    assert p.scratch_bytes == 4 * (b * h * p.pairs * p.bq * p.dmax
                                   + b * h * lq)
    assert p.scratch_bytes % 4 == 0 and (p.part_floats * 4) % 16 == 0


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bf16_scratch_is_d_alone(case):
    """The bf16 build keeps no dq partials: its scratch is D, 4 b h Lq
    bytes, whatever the band."""
    b, h, kh, lq, s_len, d, causal, window = case
    p = fb.plan(b, h, kh, lq, s_len, d, causal, window, torch.bfloat16)
    assert isinstance(p, fb.TcPlan)
    assert p.scratch_bytes == 4 * b * h * lq
    assert p.scratch_bytes < fb.plan(b, h, kh, lq, s_len, d, causal,
                                     window).scratch_bytes


@pytest.mark.parametrize("case, dtype", BOTH, ids=BOTH_IDS)
def test_grid_covers_each_key_tile_once_lowest_first(case, dtype):
    b, h, kh, lq, s_len, d, causal, window = case
    p = fb.plan(b, h, kh, lq, s_len, d, causal, window, dtype)
    if dtype == torch.bfloat16:
        # dk/dv: each (batch row, kv head, key tile) once, lowest key tile
        # first; dq: each (batch row, head, query tile) once, under causal
        # the last query tile first
        blocks = [p.kv_block(i) for i in range(p.kv_blocks)]
        assert sorted(blocks) == [(bi, khi, kt) for bi in range(b)
                                  for khi in range(kh)
                                  for kt in range(p.kv.nk)]
        assert [kt for _, _, kt in blocks] == sorted(kt for _, _, kt in
                                                     blocks)
        rows = [p.dq_block(i) for i in range(p.dq_blocks)]
        assert sorted(rows) == [(bi, hq, qt) for bi in range(b)
                                for hq in range(h) for qt in range(p.dq.nq)]
        order = [qt for _, _, qt in rows]
        assert order == sorted(order, reverse=causal)
        assert p.kv_blocks < 2 ** 31 and p.dq_blocks < 2 ** 31
        if causal and window is None and lq == s_len:   # heaviest first
            work = [len(p.kv.visits(kt)) for kt in range(p.kv.nk)]
            assert work == sorted(work, reverse=True)
            work = [len(p.dq.key_walk(qt)) for qt in order]
            assert work == sorted(work, reverse=True)
        return
    blocks = [p.block(i) for i in range(p.blocks)]
    assert sorted(blocks) == [(bi, khi, kt) for bi in range(b)
                              for khi in range(kh) for kt in range(p.nk)]
    assert [kt for _, _, kt in blocks] == sorted(kt for _, _, kt in blocks)
    assert p.blocks < 2 ** 31
    if causal and window is None and lq == s_len:   # heaviest first
        work = [len(p.visits(kt)) for kt in range(p.nk)]
        assert work == sorted(work, reverse=True)


@pytest.mark.parametrize("lq, s_len", [(1, 1), (40, 7), (7, 40), (130, 97)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 1, 3, 16, 50])
def test_rows_with_a_key_form_a_prefix(lq, s_len, causal, window):
    has = _mask(lq, s_len, causal, window).any(axis=1)
    n = int(has.sum())
    assert has[:n].all() and not has[n:].any()
    assert [fb.row_has_key(r, s_len, causal, window) for r in range(lq)] \
        == has.tolist()


def test_training_shape():
    """One worker's 4 x 256 tokens, 12 heads of 64, causal: 20 pairs of
    64 rows x 32 keys a head (15.7 MB of partials), 384 blocks doing 960
    pairs, the heaviest (key tiles 0 and 1) 4 pairs, 2.6M FMA: 20.7 us at
    half an H100 SM's FMA rate, as two blocks share an SM, so over the
    kernel's 15.1 us bound (see the note in csrc/flash_backward.cu)."""
    p = fb.plan(4, 12, 12, 256, 256, 64, True, None)
    assert (p.bq, p.bk, p.nq, p.nk, p.pairs) == (64, 32, 4, 8, 20)
    assert p.blocks == 384
    assert [len(p.visits(kt)) for kt in range(p.nk)] == [4, 4, 3, 3, 2, 2, 1, 1]
    assert p.b * p.kh * sum(len(p.visits(kt)) for kt in range(p.nk)) == 960
    assert p.heaviest_block_fma(64) == 4 * 5 * 64 * 32 * 64 == 2_621_440
    assert p.part_floats * 4 == 48 * 20 * 64 * 64 * 4 == 15_728_640
    assert p.scratch_bytes == 15_728_640 + 4 * 48 * 256
    long = fb.plan(1, 12, 12, 2048, 2048, 64, True, None)
    assert (long.pairs, long.blocks) == (1056, 768)
    assert long.scratch_bytes < 2 ** 31


def test_training_shapes_bf16():
    """Phase train_bf16's shapes in the bf16 plan. qwen3-4b (4 x 256
    tokens, 32 heads over 8 kv heads of 128, causal): dk/dv 128 blocks of
    64 keys, the heaviest walking 4 heads x 4 query tiles of 64; dq 256
    blocks of 128 rows and at most 4 key tiles; the scratch D alone, 0.13
    MB where the f32 plan's slots take 75.6 MB. gemma3-12b (1 x 2048, 16
    over 8 of 256, causal and window 1024): 256 dk/dv blocks of 32-row
    stages, the heaviest 2 heads x 64 query tiles (2 x 34 under the
    window); 256 dq blocks of 32-key stages."""
    p = fb.plan(4, 32, 8, 256, 256, 128, True, None, torch.bfloat16)
    assert (p.kv_blocks, p.dq_blocks, p.scratch_bytes) == (128, 256, 131_072)
    assert [len(p.kv.visits(kt)) for kt in range(p.kv.nk)] == [16, 12, 8, 4]
    assert max(len(p.dq.key_walk(qt)) for qt in range(p.dq.nq)) == 4
    assert fb.plan(4, 32, 8, 256, 256, 128, True, None).scratch_bytes \
        == 75_628_544
    for window, f32_bytes in ((None, 1_090_650_112), (1024, 830_603_264)):
        g = fb.plan(1, 16, 8, 2048, 2048, 256, True, window, torch.bfloat16)
        assert (g.kv.bq, g.dq.bk) == (32, 32)
        assert (g.kv_blocks, g.dq_blocks, g.scratch_bytes) == (256, 256,
                                                              131_072)
        assert max(len(g.kv.visits(kt)) for kt in range(g.kv.nk)) == \
            (128 if window is None else 68)
        assert fb.plan(1, 16, 8, 2048, 2048, 256, True,
                       window).scratch_bytes == f32_bytes


def emulate(q, k, v, o, lse, do, causal, window):
    """The kernel's dataflow in float64 from the plan: per block its walk,
    per pair s, p, dp, ds once and the five products, dk and dv summed in
    the walk's order, each dq partial into its slot; then each query tile's
    slots summed in key-tile order (the dq grid)."""
    b, h, lq, d = q.shape
    kh, s_len = k.shape[1], k.shape[2]
    p = fb.plan(b, h, kh, lq, s_len, d, causal, window)
    scale = d ** -0.5
    f64 = torch.float64
    part = torch.full((p.part_floats,), float("nan"), dtype=f64)
    dq = torch.full(q.shape, float("nan"), dtype=f64)
    dk = torch.zeros(k.shape, dtype=f64)
    dv = torch.zeros(v.shape, dtype=f64)
    delta = (do.double() * o.double()).sum(-1)

    def tile(x, row0, rows, n):
        """Rows row0 .. row0 + rows of x's last two dims, zero past n and
        past d up to dmax."""
        out = torch.zeros((rows, p.dmax), dtype=f64)
        got = x[row0:min(row0 + rows, n)].double()
        out[:got.shape[0], :d] = got
        return out

    qpos = torch.arange(p.bq)
    kpos = torch.arange(p.bk)
    for block in range(p.blocks):
        bi, khi, kt = p.block(block)
        k0 = kt * p.bk
        kt_, vt = tile(k[bi, khi], k0, p.bk, s_len), tile(v[bi, khi], k0,
                                                          p.bk, s_len)
        for gi, qt in p.visits(kt):
            hq, q0 = khi * p.g + gi, qt * p.bq
            qt_ = tile(q[bi, hq], q0, p.bq, lq)
            dot = tile(do[bi, hq], q0, p.bq, lq)
            lse_t = torch.zeros(p.bq, dtype=f64)
            del_t = torch.zeros(p.bq, dtype=f64)
            n = min(p.bq, lq - q0)
            lse_t[:n], del_t[:n] = lse[bi, hq, q0:q0 + n], delta[bi, hq,
                                                                  q0:q0 + n]
            rows, keys = (q0 + qpos)[:, None], (k0 + kpos)[None, :]
            msk = torch.zeros((p.bq, p.bk), dtype=torch.bool)
            if causal:
                msk |= keys > rows
            if window is not None:
                msk |= keys <= rows - window
            s = torch.where(msk, -1e30, qt_ @ kt_.T * scale)
            pr = torch.exp(s - lse_t[:, None])
            pr[(rows >= lq) | (keys >= s_len)] = 0.0
            ds = pr * (dot @ vt.T - del_t[:, None])
            dv[bi, khi, k0:k0 + p.bk] += (pr.T @ dot)[:s_len - k0, :d]
            dk[bi, khi, k0:k0 + p.bk] += (ds.T @ qt_)[:s_len - k0, :d]
            off = p.slot_offset(bi, hq, qt, kt)
            part[off:off + p.slot] = (ds @ kt_).reshape(-1)
    for bi in range(b):
        for hq in range(h):
            for qt, (lo, hi) in enumerate(p.band):
                base = p.slot_offset(bi, hq, qt, lo)
                acc = part[base:base + p.slot]
                for j in range(1, hi - lo):
                    acc = acc + part[base + j * p.slot:
                                     base + (j + 1) * p.slot]
                q0 = qt * p.bq
                n = min(p.bq, lq - q0)
                dq[bi, hq, q0:q0 + n] = scale * acc.reshape(
                    p.bq, p.dmax)[:n, :d]
    return dq, dk * scale, dv


def emulate_tc(q, k, v, o, lse, do, causal, window):
    """The bf16 build's dataflow in float64 from its plan: per dk/dv block
    its walk (head, query tile), each visit's p, ds and the dk and dv
    products in the walk's order; per dq block the key tiles of its band
    in order, each one's p, ds and dq product."""
    b, h, lq, d = q.shape
    kh, s_len = k.shape[1], k.shape[2]
    p = fb.plan(b, h, kh, lq, s_len, d, causal, window, torch.bfloat16)
    scale, f64 = d ** -0.5, torch.float64
    delta = (do.double() * o.double()).sum(-1)

    def pd(bi, hq, q0, bq, k0, bk):
        """p and ds of one tile pair (rows q0.., keys k0..), 0 past Lq and
        S; and the pair's q, dO, k rows (zero-filled)."""
        qpos = (q0 + torch.arange(bq))[:, None]
        kpos = (k0 + torch.arange(bk))[None, :]
        khi = hq // p.g

        def rows(x, r0, n, lim):
            out = torch.zeros((n, d), dtype=f64)
            got = x[r0:min(r0 + n, lim)].double()
            out[:got.shape[0]] = got
            return out

        qt_, dot = rows(q[bi, hq], q0, bq, lq), rows(do[bi, hq], q0, bq, lq)
        kt_, vt = rows(k[bi, khi], k0, bk, s_len), rows(v[bi, khi], k0, bk,
                                                         s_len)
        lse_t, del_t = torch.zeros(bq, dtype=f64), torch.zeros(bq, dtype=f64)
        n = max(0, min(bq, lq - q0))
        lse_t[:n], del_t[:n] = lse[bi, hq, q0:q0 + n], delta[bi, hq, q0:q0 + n]
        msk = torch.zeros((bq, bk), dtype=torch.bool)
        if causal:
            msk |= kpos > qpos
        if window is not None:
            msk |= kpos <= qpos - window
        s = torch.where(msk, -1e30, qt_ @ kt_.T * scale)
        pr = torch.exp(s - lse_t[:, None])
        pr[(qpos >= lq).expand(bq, bk) | (kpos >= s_len).expand(bq, bk)] = 0.0
        return pr, pr * (dot @ vt.T - del_t[:, None]), qt_, dot, kt_

    dk = torch.full(k.shape, float("nan"), dtype=f64)
    dv = torch.full(v.shape, float("nan"), dtype=f64)
    for block in range(p.kv_blocks):
        bi, khi, kt = p.kv_block(block)
        k0, bk, bq = kt * p.kv.bk, p.kv.bk, p.kv.bq
        acc_k, acc_v = torch.zeros((bk, d), dtype=f64), torch.zeros((bk, d),
                                                                     dtype=f64)
        for gi, qt in p.kv.visits(kt):
            pr, ds, qt_, dot, _ = pd(bi, khi * p.g + gi, qt * bq, bq, k0, bk)
            acc_v += pr.T @ dot
            acc_k += ds.T @ qt_
        n = min(bk, s_len - k0)
        dk[bi, khi, k0:k0 + n], dv[bi, khi, k0:k0 + n] = scale * acc_k[:n], \
            acc_v[:n]
    dq = torch.full(q.shape, float("nan"), dtype=f64)
    for block in range(p.dq_blocks):
        bi, hq, qt = p.dq_block(block)
        q0, bq, bk = qt * p.dq.bq, p.dq.bq, p.dq.bk
        acc = torch.zeros((bq, d), dtype=f64)
        for kt in p.dq.key_walk(qt):
            _, ds, _, _, kt_ = pd(bi, hq, q0, bq, kt * bk, bk)
            acc += ds @ kt_
        n = min(bq, lq - q0)
        dq[bi, hq, q0:q0 + n] = scale * acc[:n]
    return dq, dk, dv


EMULATED = [c for c in CASES if c[0] * c[1] * c[3] * c[4] <= 4 * 300 * 300]
EMULATED_BOTH = [(c, dt) for dt in DTYPES for c in EMULATED]
EMULATED_IDS = [IDS[CASES.index(c)] for c in EMULATED]


@pytest.mark.parametrize(
    "case, dtype", EMULATED_BOTH,
    ids=EMULATED_IDS + [f"bf16-{i}" for i in EMULATED_IDS])
def test_emulated_dataflow_equals_the_f64_backward(case, dtype):
    b, h, kh, lq, s_len, d, causal, window = case
    rng = np.random.default_rng(lq * 7 + s_len + d)
    q, do = (torch.from_numpy(rng.standard_normal((b, h, lq, d)))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, kh, s_len, d)))
            for _ in range(2))
    g = h // kh
    s = torch.einsum("bkgqd,bksd->bkgqs", q.reshape(b, kh, g, lq, d),
                     k) * d ** -0.5
    m = torch.from_numpy(_mask(lq, s_len, causal, window))
    s = torch.where(m, s, -1e30)
    lse = torch.logsumexp(s, dim=-1).reshape(b, h, lq)
    o = torch.einsum("bkgqs,bksd->bkgqd", torch.softmax(s, dim=-1),
                     v).reshape(b, h, lq, d)
    got = (emulate if dtype == torch.float32 else emulate_tc)(
        q, k, v, o, lse, do, causal, window)
    want = chip_smoke.flash_bwd_f64(q, k, v, do, causal, window)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert not torch.isnan(x).any(), name
        torch.testing.assert_close(x, y, rtol=1e-12, atol=1e-12, msg=name)
