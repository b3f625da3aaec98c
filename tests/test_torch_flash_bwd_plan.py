"""The flash backward kernel's plan (``kernels/flash_backward.py:plan``),
held against a brute-force enumeration of the attention mask on the CPU.

The kernel (``csrc/flash_backward.cu``) walks, for each key tile, the query
tiles that meet it and writes each (query tile, key tile) pair's dq
partial to a slot of its own; its last grid sums each query tile's slots
in key-tile order.
Everything it computes on the host or from integers is mirrored by
``plan``: the tiles by head dim, the grid and its order, the band of pairs,
the slots and the scratch's bytes. Checked here over the shapes of
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
    products, slots, the key-tile-order sum) equals the
    backward's f64 function to 1e-12: a pair missed or a slot misplaced
    would show there.
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


def _visited(p: fb.Plan) -> list:
    """(query tile, key tile) of every visit of one head's blocks."""
    return [(qt, kt) for kt in range(p.nk) for gi, qt in p.visits(kt)
            if gi == 0]


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


@pytest.mark.parametrize("d, cap", [(1, 64), (33, 64), (64, 64), (65, 128),
                                    (80, 128), (128, 128), (129, 256),
                                    (256, 256)])
def test_head_dim_picks_the_instantiation(d, cap):
    assert fb.head_dim_cap(d) == cap


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_band_visits_every_needed_pair_once(case):
    b, h, kh, lq, s_len, d, causal, window = case
    p = fb.plan(b, h, kh, lq, s_len, d, causal, window)
    assert (p.bq, p.bk) == fb.TILES[fb.head_dim_cap(d)]
    assert (p.nq, p.nk) == (-(-lq // p.bq), -(-s_len // p.bk))
    visited = _visited(p)
    assert len(visited) == len(set(visited)) == p.pairs
    band = {(qt, kt) for qt, (lo, hi) in enumerate(p.band)
            for kt in range(lo, hi)}
    assert set(visited) == band
    assert _needed(p, lq, s_len, causal, window) <= band
    # each head of a group walks the same pairs; a query tile has one slot
    # per key tile that meets it, and meets at least one
    for kt in range(p.nk):
        walk = p.visits(kt)
        assert [qt for gi, qt in walk] == [qt for _ in range(p.g)
                                          for gi, qt in walk if gi == 0]
        assert walk == sorted(walk, key=lambda v: (v[0], -v[1]))
    for qt, (lo, hi) in enumerate(p.band):
        assert 0 <= lo < hi <= p.nk
        assert sum(qt_ == qt for qt_, _ in visited) == hi - lo


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
def test_grid_covers_each_key_tile_once_lowest_first(case):
    b, h, kh, lq, s_len, d, causal, window = case
    p = fb.plan(b, h, kh, lq, s_len, d, causal, window)
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


EMULATED = [c for c in CASES if c[0] * c[1] * c[3] * c[4] <= 4 * 300 * 300]


@pytest.mark.parametrize("case", EMULATED,
                         ids=[IDS[CASES.index(c)] for c in EMULATED])
def test_emulated_dataflow_equals_the_f64_backward(case):
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
    got = emulate(q, k, v, o, lse, do, causal, window)
    want = chip_smoke.flash_bwd_f64(q, k, v, do, causal, window)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert not torch.isnan(x).any(), name
        torch.testing.assert_close(x, y, rtol=1e-12, atol=1e-12, msg=name)
