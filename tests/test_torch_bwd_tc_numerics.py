"""The arithmetic of the bf16 flash backward's tensor-core kernels, emulated
in plain torch on the CPU and held against the JAX package.

``csrc/flash_backward.cu``'s bf16 build runs flash.py's two passes on the
bf16 tensor cores with f32 accumulation: the dk/dv pass by key tile (S^T =
K Q^T and dP^T = V dO^T of bf16 operands, exact products and f32 sums, the
scale after the product; p^T = exp(s * scale - lse) and ds^T = p^T (dp^T -
D) in f32; dV += P^T dO and dK += dS^T Q with p and ds split in three,
x_hi = bf16(x), x_mid = bf16(x - x_hi), x_lo = bf16(x - x_hi - x_mid),
into one f32 accumulator, summed over the G heads and each head's query
tiles in the kernel's walk), then the dq pass by query tile (S, dP, p, ds
again; dQ += (dS_hi + dS_mid + dS_lo) K over the key tiles of the band in
order), dq, dk and dv scaled and rounded to bf16 once at the store. ``tc_flash_bwd`` below repeats that arithmetic tile by
tile on the kernel's own tiles (read from the source, so that the
emulation cannot drift from the kernel) and walks (``flash_backward.plan``
with dtype bfloat16); only the order of the f32 sums inside a product,
and an exp's last bits (torch.exp's against CUDA's expf), may differ from
the card's. The card itself is held to the same rules by
tests/test_torch_train_bf16_cuda.py and ``chip_smoke.py``.

Tolerances and why:
  * the split: x_hi + x_mid + x_lo within 2^-24 |x| of x (three roundings
    of 8 significant bits), for every normal p and ds of a case, the bound
    the kernel's note states. Split in two (x_hi + x_lo, within 2^-16 |x|)
    the emulation broke the next rule on four of these cases, by up to
    5%, and the card on three;
  * against the f64 function of the same residuals
    (``chip_smoke.flash_bwd_f64``) and the port's plain version in bf16 and
    f32: ``chip_smoke.bf16_bwd_excess`` at most 1, the rule the card holds
    the kernel to, at the small cases of
    ``chip_smoke.FLASH_BWD_BF16_CASES`` (every case but the training shapes);
  * against ``jax.vjp`` of ``repro.models.flash``'s custom VJP on the same
    bf16 inputs (numpy, seeded), from JAX's own o and log-sum-exp: each of
    dq, dk and dv within one bf16 ulp of the larger value plus 1e-5 (1 +
    |JAX's|), the rule tests/test_torch_train_bf16.py holds the plain bf16
    VJP to (both round one f32 sum once; the sums' order and the split
    move the f32 value by far less than the 1e-5).
"""
import re
import sys
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the repository root's script)
from repro.models import flash as j_flash  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import flash_backward as fb  # noqa: E402

F32, BF16 = torch.float32, torch.bfloat16
FLASH_TOL = 1e-5


def _source_tiles() -> dict:
    """TcBwdTiles of csrc/flash_backward.cu by head-dim capacity: (the
    dk/dv pass's query rows a stage, keys a block, the dq pass's query rows
    a block, keys a stage)."""
    src = (build.CSRC / "flash_backward.cu").read_text()
    found = re.findall(
        r"struct TcBwdTiles<(\d+)> \{\s*static constexpr int KV_BQ = (\d+), "
        r"KV_BK = (\d+), DQ_BQ = (\d+), DQ_BK = (\d+);", src)
    return {int(dmax): tuple(map(int, t)) for dmax, *t in found}


TILES = _source_tiles()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the port's CPU work here: in a parallel test
    run a pool of threads in every worker process contends for the same
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _split(x, record):
    """x_hi = bf16(x), x_mid = bf16(x - x_hi), x_lo = bf16(x - x_hi -
    x_mid), as f32 (the kernel's split3_pair); appends (x, x_hi, x_mid,
    x_lo) to ``record`` where given."""
    hi = x.to(BF16).to(F32)
    mid = (x - hi).to(BF16).to(F32)
    lo = (x - hi - mid).to(BF16).to(F32)
    if record is not None:
        record.append((x, hi, mid, lo))
    return hi, mid, lo


def _probs(s, lse, qpos, kpos, lq, s_len, causal, window, scale):
    """p = exp(mask(s * scale) - lse) in f32 (-1e30 where masked), 0 past
    Lq and past S (the kernel's prob); qpos and kpos broadcast against s."""
    valid = torch.ones(torch.broadcast_shapes(qpos.shape, kpos.shape),
                       dtype=torch.bool)
    if causal:
        valid = valid & (kpos <= qpos)
    if window is not None:
        valid = valid & (kpos > qpos - window)
    x = torch.where(valid, s * scale, torch.tensor(-1e30, dtype=F32))
    p = torch.exp(x - lse)
    return torch.where((qpos < lq) & (kpos < s_len), p, torch.zeros((), dtype=F32))


def _pad(x, n):
    """x (B, heads, L, d) zero-padded to n rows (the kernel's zero-fill)."""
    return torch.nn.functional.pad(x, (0, 0, 0, n - x.shape[2]))


def tc_flash_bwd(q, k, v, o, lse, do, *, causal=True, window=None,
                 scale=None, record=None):
    """The bf16 build's arithmetic in plain torch: q, do, o (B, H, Lq, d)
    and k, v (B, K, S, d) in bf16, lse (B, H, Lq) f32; (dq, dk, dv) in
    bf16."""
    b, h, lq, d = q.shape
    kh, s_len = k.shape[1], k.shape[2]
    g = h // kh
    if scale is None:
        scale = d ** -0.5
    p = fb.plan(b, h, kh, lq, s_len, d, causal, window, BF16)
    assert (p.kv.bq, p.kv.bk, p.dq.bq, p.dq.bk) == TILES[p.dmax]
    qf, kf, vf, dof = (x.to(F32) for x in (q, k, v, do))   # exact
    delta = (dof * o.to(F32)).sum(-1)                      # the prep grid
    lse = lse.to(F32)

    # dk/dv: a block per key tile, its walk's (head, query tile) in order
    bq, bk = p.kv.bq, p.kv.bk
    rows_pad, keys_pad = p.kv.nq * bq, p.kv.nk * bk
    qp, dop = _pad(qf, rows_pad), _pad(dof, rows_pad)
    lsep = torch.nn.functional.pad(lse, (0, rows_pad - lq))
    delp = torch.nn.functional.pad(delta, (0, rows_pad - lq))
    kp, vp = _pad(kf, keys_pad), _pad(vf, keys_pad)
    dk = torch.zeros((b, kh, keys_pad, d), dtype=F32)
    dv = torch.zeros_like(dk)
    for kt in range(p.kv.nk):
        keys = slice(kt * bk, (kt + 1) * bk)
        kpos = torch.arange(kt * bk, (kt + 1) * bk)[:, None]
        for gi, qt in p.kv.visits(kt):
            rows = slice(qt * bq, (qt + 1) * bq)
            qpos = torch.arange(qt * bq, (qt + 1) * bq)[None, :]
            qt_, dot = qp[:, gi::g, rows], dop[:, gi::g, rows]     # heads khi g + gi
            s_t = kp[:, :, keys] @ qt_.transpose(-1, -2)          # (B, K, bk, bq)
            p_t = _probs(s_t, lsep[:, gi::g, None, rows], qpos, kpos, lq,
                         s_len, causal, window, scale)
            dp_t = vp[:, :, keys] @ dot.transpose(-1, -2)
            ds_t = p_t * (dp_t - delp[:, gi::g, None, rows])
            for piece in _split(p_t, record):               # warpgroup 0
                dv[:, :, keys] = dv[:, :, keys] + piece @ dot
            for piece in _split(ds_t, record):              # warpgroup 1
                dk[:, :, keys] = dk[:, :, keys] + piece @ qt_
    dk = (scale * dk[:, :, :s_len]).to(BF16)
    dv = dv[:, :, :s_len].to(BF16)

    # dq: a block per query tile, the key tiles of its band in order
    bq, bk = p.dq.bq, p.dq.bk
    rows_pad, keys_pad = p.dq.nq * bq, p.dq.nk * bk
    qp, dop = _pad(qf, rows_pad), _pad(dof, rows_pad)
    lsep = torch.nn.functional.pad(lse, (0, rows_pad - lq))
    delp = torch.nn.functional.pad(delta, (0, rows_pad - lq))
    kp = _pad(kf, keys_pad).repeat_interleave(g, dim=1)
    vp = _pad(vf, keys_pad).repeat_interleave(g, dim=1)
    dq = torch.zeros((b, h, rows_pad, d), dtype=F32)
    for qt in range(p.dq.nq):
        rows = slice(qt * bq, (qt + 1) * bq)
        qpos = torch.arange(qt * bq, (qt + 1) * bq)[:, None]
        for kt in p.dq.key_walk(qt):
            keys = slice(kt * bk, (kt + 1) * bk)
            kpos = torch.arange(kt * bk, (kt + 1) * bk)[None, :]
            s = qp[:, :, rows] @ kp[:, :, keys].transpose(-1, -2)
            pr = _probs(s, lsep[:, :, rows, None], qpos, kpos, lq, s_len,
                        causal, window, scale)
            dp = dop[:, :, rows] @ vp[:, :, keys].transpose(-1, -2)
            ds = pr * (dp - delp[:, :, rows, None])
            for piece in _split(ds, record):
                dq[:, :, rows] = dq[:, :, rows] + piece @ kp[:, :, keys]
    dq = (scale * dq[:, :, :lq]).to(BF16)
    return dq, dk, dv


def test_tiles_are_the_plans():
    """The source's TcBwdTiles are ``flash_backward.TILES_BF16``."""
    assert TILES == fb.TILES_BF16


# the small cases of chip_smoke's bf16 backward cases: all but the training
# shapes, which come first
SMALL = chip_smoke.FLASH_BWD_BF16_CASES[3:]
SMALL_IDS = [f"b{c[0]}h{c[1]}k{c[2]}q{c[3]}s{c[4]}d{c[5]}"
             f"{'c' if c[6] else 'n'}w{c[7]}" for c in SMALL]


def _inputs(case, seed):
    """Seeded bf16 q, k, v, dO (numpy's normal as bf16 values) and the plain
    bf16 forward's o and log-sum-exp."""
    b, h, kh, lq, s_len, d, causal, window, _ = case
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.tensor(convert.bf16_values(rng.standard_normal(s))
                                ).to(BF16)
                   for s in ((b, h, lq, d), (b, kh, s_len, d), (b, kh, s_len, d),
                             (b, h, lq, d)))
    o, lse = ref.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     return_lse=True)
    return q, k, v, o, lse, do


def test_small_cases_cover_the_new_tile_edges():
    """The bf16 cases sit one short of and one past each tile of the
    design (64 query rows and keys; 32-row stages at d = 256), at d 64,
    128 and 256, causal and windowed, with Lq > S among them."""
    for size in (64, 32):
        for d in ((64, 128, 256) if size == 64 else (256,)):
            for edge in (size - 1, size + 1):
                assert any(c[5] == d and edge in (c[3], c[4])
                           for c in SMALL), (size, d, edge)
    assert any(c[7] is not None for c in SMALL if c[5] == 256)
    assert any(c[3] > c[4] for c in SMALL)


@pytest.mark.parametrize("case", SMALL, ids=SMALL_IDS)
def test_tc_arithmetic_within_the_card_rule(case):
    b, h, kh, lq, s_len, d, causal, window, _ = case
    q, k, v, o, lse, do = _inputs(case, seed=lq + s_len + d)
    kw = {"causal": causal, "window": window}
    record = []
    got = tc_flash_bwd(q, k, v, o, lse, do, record=record, **kw)
    plain = ref.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    plain32 = ref.flash_attention_bwd(q.float(), k.float(), v.float(),
                                      o.float(), lse, do.float(), **kw)
    exact = chip_smoke.flash_bwd_f64(q, k, v, do, causal, window, o=o)
    for name, g_, p_, p32, x, like in zip(("dq", "dk", "dv"), got, plain,
                                          plain32, exact, (q, k, v)):
        assert g_.dtype == BF16 and g_.shape == like.shape, name
        assert chip_smoke.bf16_bwd_excess(g_, p_, p32, x) <= 1.0, name
    assert record


@pytest.mark.parametrize("case", SMALL[:6], ids=SMALL_IDS[:6])
def test_the_split_keeps_p_and_ds_within_their_bound(case):
    """For every p and ds the emulation splits: each residual is exact in
    f32 and x_hi + x_mid + x_lo is within 2^-24 |x| of a normal x (an f32
    subnormal keeps bf16's subnormal spacing instead); x = 0 splits into
    zeros; and x_lo carries bits somewhere, which a split in two loses."""
    q, k, v, o, lse, do = _inputs(case, seed=7 + case[3])
    record = []
    tc_flash_bwd(q, k, v, o, lse, do, causal=case[6], window=case[7],
                 record=record)
    reached = False
    for x, hi, mid, lo in record:
        r = x - hi
        assert torch.equal(r + hi, x) and torch.equal(r - mid + mid, r)
        err = (hi.double() + mid.double() + lo.double() - x.double()).abs()
        normal = x.abs() >= 2.0 ** -126
        assert bool((err[normal] <= 2.0 ** -24 * x.double().abs()[normal]).all())
        assert bool((hi[x == 0] == 0).all() and (lo[x == 0] == 0).all())
        reached |= bool((lo != 0).any())
    assert reached


def _ulp(x) -> np.ndarray:
    """bf16's spacing at |x| (elementwise; at 2^-126 and below, there)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def _within_one_ulp(got, want) -> float:
    """The largest ratio of |got - want| to one bf16 ulp of the larger
    value plus FLASH_TOL (1 + |want|), elementwise."""
    a = got.double().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32)).astype(np.float64)
    bound = _ulp(np.maximum(np.abs(a), np.abs(w))) + FLASH_TOL * (1 + abs(w))
    return float((np.abs(a - w) / bound).max())


# (b, h, kh, l, d, causal, window, block): L off the kernel's 64-row and
# 64-key tiles, GQA 1, 2 and 4, d 64, 128 and 256 (32-row stages),
# causal, windowed and non-causal
JAX_CASES = [(1, 4, 2, 80, 64, True, None, 16),
             (1, 8, 2, 96, 128, True, 40, 32),
             (1, 4, 2, 48, 256, True, 20, 16),
             (2, 2, 2, 72, 64, False, None, 24)]


@pytest.mark.parametrize("case", JAX_CASES,
                         ids=["-".join(map(str, c)) for c in JAX_CASES])
def test_tc_arithmetic_matches_jax_vjp(case):
    """dq, dk and dv of the emulation from JAX's residuals (o and the
    log-sum-exp its forward saves) against ``jax.vjp`` of the custom VJP,
    on the same bf16 inputs."""
    b, h, kh, l, d, causal, window, block = case
    rng = np.random.default_rng(sum(case[:5]))
    ins = [convert.bf16_values(rng.standard_normal(s))
           for s in ((b, h, l, d), (b, kh, l, d), (b, kh, l, d), (b, h, l, d))]
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jnp.bfloat16) for x in ins)
    fn = j_flash._make_flash(causal, window, d ** -0.5, block, block, 0)

    @jax.jit
    def run(q_, k_, v_, do_):
        o, vjp = jax.vjp(lambda a, b_, c: j_flash.flash_attention(
            a, b_, c, causal=causal, window=window, q_block=block,
            kv_block=block), q_, k_, v_)
        _, res = fn.fwd(q_.reshape(b, kh, h // kh, l, d), k_, v_)
        return o, res[4].reshape(b, h, l), vjp(do_)

    jo, jlse, jgrads = run(jq, jk, jv, jdo)
    q, k, v, do = (torch.tensor(x).to(BF16) for x in ins)
    o = torch.tensor(np.asarray(jo.astype(jnp.float32))).to(BF16)
    lse = torch.tensor(np.asarray(jlse, dtype=np.float32))
    got = tc_flash_bwd(q, k, v, o, lse, do, causal=causal, window=window)
    for name, x, w in zip(("dq", "dk", "dv"), got, jgrads):
        assert w.dtype == jnp.bfloat16
        assert _within_one_ulp(x, w) <= 1.0, name


def test_hgmma_count_reads_the_bf16_kernels_of_a_sass_dump():
    """``chip_smoke.count_hgmma`` (phase bwd_bf16_sass on the card) counts
    the HGMMA lines of each dk/dv and dq kernel by its DMAX, and nothing of
    the other functions."""
    sass = "\n".join([
        "\tFunction : _ZN50_GLOBAL__N__x_17flash_backward_cu_y20"
        "flash_bwd_dkv_kernelILi128EEEvNS_7BwdPtrsI13__nv_bfloat16EE",
        "        /*0100*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ ;",
        "        /*0110*/  HGMMA.64x128x16.F32.BF16 R88, R20, gdesc[UR8] ;",
        "\tFunction : _ZN50_GLOBAL__N__x_17flash_backward_cu_y22"
        "flash_bwd_dq_tc_kernelILi256EEEvNS_7BwdPtrsI13__nv_bfloat16EE",
        "        /*0200*/  HGMMA.64x32x16.F32.BF16 R24, gdesc[UR4], RZ ;",
        "\tFunction : _ZN50_GLOBAL__N__x_17flash_backward_cu_y16"
        "flash_bwd_kernelILi64EfEEvNS_7BwdPtrsIT0_EENS_7BwdArgsE",
        "        /*0300*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ ;",
        "        /*0310*/  FFMA R1, R2, R3, R4 ;"])
    assert chip_smoke.count_hgmma(sass) == {"flash_bwd_dkv_kernel<128>": 2,
                                            "flash_bwd_dq_tc_kernel<256>": 1}
    assert set(chip_smoke.BWD_BF16_KERNELS) == {
        f"{k}<{d}>" for k in ("flash_bwd_dkv_kernel", "flash_bwd_dq_tc_kernel")
        for d in fb.TILES_BF16}
