"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these need an NVIDIA card with ``nvcc`` and skip without
one (the CPU tests hold the plain versions against the JAX package). On a
card they run with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` runs the same comparisons over more shapes.
"""
import pytest
import torch

from repro_torch import opt
from repro_torch.core import simulator
from repro_torch.core.quantize import int8_scale
from repro_torch.data import edge_tasks
from repro_torch.core.util import tree_sqnorm
from repro_torch.kernels import (censor, common, decode_attention,
                                 flash_attention, fused_step, hb_update,
                                 lowrank_ef, ops, quantize_ef, ref, topk_pack)

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _same(a, b):
    return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _same_or_nan(a, b):
    """Bitwise equal where b is a number; NaN exactly where b is NaN."""
    nan = torch.isnan(b)
    return a.dtype == b.dtype and torch.equal(torch.isnan(a), nan) \
        and torch.equal(_bits(a)[~nan], _bits(b)[~nan])


def _inputs(m, n, dtype, device):
    gen = torch.Generator(device=device).manual_seed(m * 7919 + n)
    g, h, e = (torch.randn((m, n), generator=gen, device=device,
                           dtype=dtype) for _ in range(3))
    t, p = (torch.randn(n, generator=gen, device=device, dtype=dtype)
            for _ in range(2))
    g[:, ::7] = -0.0
    mask = torch.tensor([float(i % 2 == 0) for i in range(m)], device=device)
    return g, h, e * 0.01, t, p, mask


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("m,n", [(1, 1), (4, 4099), (9, 70001), (65535, 33),
                                 (65536, 2049), (70000, 2049)])
def test_kernels_match_plain_versions(card, m, n, dtype):
    g, h, e, t, p, mask = _inputs(m, n, dtype, card)
    common.reset_launches()
    k = censor.censor_delta_sqnorm_batched(g, h)
    torch.testing.assert_close(k, ref.censor_delta_sqnorm_batched(g, h),
                               rtol=1e-5, atol=0)
    sq, am = fused_step.int8_stats_batched(g, h, e)
    sq_p, am_p = ref.int8_stats_batched(g, h, e)
    torch.testing.assert_close(sq, sq_p, rtol=1e-5, atol=0)
    assert _same(am, am_p)
    out = fused_step.fused_dense_step(g, h, t, p, mask, 0.1, 0.4)
    for a, b in zip(out, ref.fused_dense_step(g, h, t, p, mask, 0.1, 0.4)):
        assert _same(a, b)
    scale = int8_scale(am)
    out = fused_step.fused_int8_step(g, h, e, t, p, mask, scale, 0.1, 0.4)
    for a, b in zip(out, ref.fused_int8_step(g, h, e, t, p, mask, scale,
                                             0.1, 0.4)):
        assert _same(a, b)
    assert _same(k, censor.censor_delta_sqnorm_batched(g, h))
    x = g - h
    k8 = censor.sqnorm_batched(x)
    torch.testing.assert_close(k8, ref.sqnorm_batched(x), rtol=1e-5, atol=0)
    assert _same(k8, k)
    assert _same(censor.bank_advance(h, g, mask),
                 ref.bank_advance(h, g, mask))
    assert _same(hb_update.hb_update(t, g[0], p, 0.1, 0.4),
                 ref.hb_update(t, g[0], p, 0.1, 0.4))
    keep = (g > 0.3).to(dtype)
    keep[:, ::7] = 1.0                  # keeps g's -0.0 entries
    for a, b in zip(topk_pack.select_pack_ef_batched(g, e, keep, mask),
                    ref.select_pack_ef_batched(g, e, keep, mask)):
        assert _same(a, b)
    assert _same(lowrank_ef.residual_ef_batched(g, h, e, mask),
                 ref.residual_ef_batched(g, h, e, mask))
    b4 = censor.censor_bank_advance(g, h, mask)
    assert _same(b4, ref.censor_bank_advance(g, h, mask))
    assert _same(b4, ref.fused_dense_step(g, h, t, p, mask, 0.1, 0.4)[0])
    pend = (g - h) + e
    am7 = quantize_ef.absmax_batched(pend)
    assert _same(am7, ref.absmax_batched(pend)) and _same(am7, am)
    out7 = quantize_ef.quantize_ef_batched(pend, e, mask, scale)
    for a, b in zip(out7, ref.quantize_ef_batched(pend, e, mask, scale)):
        assert _same(a, b)
    assert _same(out7[1], out[1])        # B6's err'
    torch.cuda.synchronize()
    assert common.LAUNCHES == {"censor_delta_sqnorm_batched": 2,
                               "fused_dense_step": 1,
                               "int8_stats_batched": 1,
                               "fused_int8_step": 1,
                               "sqnorm_batched": 1, "bank_advance": 1,
                               "hb_update": 1, "select_pack_ef_batched": 1,
                               "residual_ef_batched": 1,
                               "censor_bank_advance": 1,
                               "absmax_batched": 1,
                               "quantize_ef_batched": 1,
                               "censor_delta_sqnorm": 0, "censor_select": 0,
                               "flash_attention": 0, "decode_attention": 0,
                               "fold_workers": 0, "flash_attention_bwd": 0}


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("m", [1, 4, 9])
@pytest.mark.parametrize("n,offset", [(4096, 0), (70001, 0), (4096, 1),
                                      (4100, 1)])
def test_bank_advance_vector_and_scalar_paths(card, dtype, m, n, offset):
    """B9 bit for bit against ``ref.bank_advance``, -0.0, NaN and inf
    salted: on rows of 16-byte vectors (n a multiple of 4, aligned leaves)
    and on its scalar path (odd n misaligns every row after the first; a
    leaf view one element off its storage's alignment); each worker's M=1
    slice equals its row of the batched call."""
    gen = torch.Generator(device=card).manual_seed(m * 31 + n + offset)

    def leaf():
        flat = torch.randn(offset + m * n, generator=gen, device=card,
                           dtype=dtype)
        return flat[offset:].view(m, n)

    h, q = leaf(), leaf()
    h[:, ::7] = -0.0
    q[:, ::5] = -0.0
    q[:, 3::11] = float("nan")
    h[:, 4::13] = float("inf")
    q[:, 6::17] = float("-inf")
    mask = torch.tensor([float(i % 3 != 1) for i in range(m)], device=card)
    common.reset_launches()
    out = censor.bank_advance(h, q, mask)
    assert common.LAUNCHES["bank_advance"] == 1
    assert _same(out, ref.bank_advance(h, q, mask))
    assert _same(out, censor.bank_advance(h, q, mask))
    for w in range(m):
        assert _same(censor.bank_advance(h[w:w + 1], q[w:w + 1],
                                         mask[w:w + 1]), out[w:w + 1])


def _sample_workers(m):
    """Every worker of a small M; past grid y's 65535 blocks, the first
    and last worker of each block's walk and one between."""
    if m <= 16:
        return range(m)
    return sorted({0, 1, m // 2, 65534, 65535, m - 1} & set(range(m)))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("n,offset", [(36, 0), (33, 1)])
def test_bank_advance_walks_any_m(card, dtype, n, offset):
    """B9 past grid y's 65535 blocks (M = 70000) on its 16-byte path (n a
    multiple of 4, aligned) and its element-wise path (a view one element
    off alignment): bit for bit against ``ref.bank_advance``, and a
    worker's M=1 call equals its row of the batched call."""
    m = 70000
    gen = torch.Generator(device=card).manual_seed(n + offset)
    flat = torch.randn(2 * (offset + m * n), generator=gen, device=card,
                       dtype=dtype)
    h = flat[offset:offset + m * n].view(m, n)
    q = flat[2 * offset + m * n:].view(m, n)
    h[:, ::7] = -0.0
    q[:, 3::11] = float("nan")
    mask = torch.tensor([float(i % 3 != 1) for i in range(m)], device=card)
    out = censor.bank_advance(h, q, mask)
    assert _same(out, ref.bank_advance(h, q, mask))
    for w in _sample_workers(m):
        assert _same(censor.bank_advance(h[w:w + 1], q[w:w + 1],
                                         mask[w:w + 1]), out[w:w + 1])


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("m,n,offset", [
    (1, 4096, 0), (4, 4096, 0), (9, 4096, 0), (4, 4099, 0), (9, 70001, 0),
    (4, 4096, 1), (9, 4100, 1), (4, 2 ** 17 + 4, 0), (1, 1, 0), (1, 3, 1),
    (70000, 36, 0), (70000, 33, 0), (70000, 36, 1)])
def test_absmax_vector_and_scalar_paths(card, dtype, m, n, offset):
    """B7a on its 16-byte path (n a multiple of the elements in 16 bytes,
    an aligned leaf) and its element-wise path (odd n, or a view one
    element off its storage's alignment), at M up to 70000 (past grid y's
    65535 blocks), rows salted with -0.0, NaN and +-inf, one row all -0.0:
    rows without a NaN bitwise equal to ``ref.absmax_batched`` (+0 for
    the -0.0 row), NaN rows NaN, every row equal to B5's abs-max of the
    same pending, and a worker's M=1 call equal to its batched entry."""
    g, h, e, _, _, _ = _inputs(m, n, dtype, card)
    g[:, ::5] = -0.0
    h[:, ::5] = 0.0
    e[:, ::5] = -0.0
    g[1::4, 0] = float("inf")
    g[1::4, n - 1] = float("-inf")
    g[2::4, n // 2] = float("nan")
    if m > 3:
        g[3], h[3], e[3] = -0.0, 0.0, -0.0
    pend = (g - h) + e
    flat = torch.empty(offset + m * n, dtype=dtype, device=card)
    x = flat[offset:].view(m, n)
    x.copy_(pend)
    common.reset_launches()
    am = quantize_ef.absmax_batched(x)
    assert common.LAUNCHES["absmax_batched"] == 1
    want = ref.absmax_batched(pend)
    assert _same_or_nan(am, want)
    assert torch.equal(torch.isnan(am), torch.isnan(pend).any(dim=1))
    if m > 3:
        assert _bits(am[3]).item() == 0            # +0, not -0
    assert _same_or_nan(am, fused_step.int8_stats_batched(g, h, e)[1])
    for w in _sample_workers(m):
        assert _same_or_nan(quantize_ef.absmax_batched(x[w:w + 1]),
                            am[w:w + 1])


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_nan_and_inf_rows_propagate_as_in_the_plain_versions(card, dtype):
    """B5, B6, B7a and B7b keep a NaN where torch.amax and torch.clamp do:
    a NaN row gets scale 1 and a NaN payload entry, not -127*scale."""
    g, h, e, t, p, _ = _inputs(4, 70001, dtype, card)
    g[0, 3] = float("nan")
    g[1, 2] = float("inf")
    g[1, -1] = float("-inf")
    h[2, 9] = float("nan")
    mask = torch.tensor([1.0, 0.0, 0.0, 1.0], device=card)
    sq, am = fused_step.int8_stats_batched(g, h, e)
    sq_p, am_p = ref.int8_stats_batched(g, h, e)
    assert torch.equal(torch.isnan(sq), torch.isnan(sq_p))
    assert _same_or_nan(am, am_p)
    assert torch.isnan(am[0]) and torch.isinf(am[1]) and torch.isnan(am[2])
    scale = int8_scale(am)
    assert float(scale[0]) == 1.0
    out = fused_step.fused_int8_step(g, h, e, t, p, mask, scale, 0.1, 0.4)
    for a, b in zip(out, ref.fused_int8_step(g, h, e, t, p, mask, scale,
                                             0.1, 0.4)):
        assert _same_or_nan(a, b)
    pend = (g - h) + e
    am7 = quantize_ef.absmax_batched(pend)
    assert _same_or_nan(am7, ref.absmax_batched(pend))
    assert _same_or_nan(am7, am)
    pay, err = quantize_ef.quantize_ef_batched(pend, e, mask, scale)
    pay_p, err_p = ref.quantize_ef_batched(pend, e, mask, scale)
    assert _same_or_nan(pay, pay_p) and _same_or_nan(err, err_p)
    assert _same_or_nan(err, out[1])
    assert torch.isnan(pay[0, 3]) and torch.isnan(pay[1]).all()


@pytest.mark.parametrize("kw,names", [
    ({}, ("censor_delta_sqnorm_batched", "fused_dense_step")),
    ({"quantize": "int8"}, ("int8_stats_batched", "fused_int8_step")),
    ({"transport": "topk", "k": 4_000}, ("sqnorm_batched",
                                         "select_pack_ef_batched",
                                         "bank_advance", "fold_workers",
                                         "hb_update")),
], ids=["dense", "int8", "topk"])
def test_main_path_launches_each_kernel_once_per_step(card, kw, names):
    task = edge_tasks.make_edge_quadratics(m=4, d=10_000, seed=0,
                                           dtype=torch.float32)
    common.reset_launches()
    runs = [simulator.run(opt.make("chb", 0.125, 4, eps1=4.0, backend=b,
                                   **kw), task, 3)
            for b in ("cuda", "reference")]
    assert torch.equal(runs[0].mask, runs[1].mask)
    assert torch.equal(runs[0].final_params, runs[1].final_params)
    assert {k: v for k, v in common.LAUNCHES.items() if v} == \
        {name: 3 for name in names}


def test_lowrank_path_launches_per_leaf(card):
    """Low-rank on a two-matrix tree: five kernels per leaf per step."""
    flat = edge_tasks.make_edge_quadratics(m=4, d=60 * 70 + 30 * 8, seed=0,
                                           dtype=torch.float32)
    a, c = flat.worker_data
    task = simulator.FedTask(
        init_params={"u": torch.zeros((60, 70), device=card),
                     "v": torch.zeros((30, 8), device=card)},
        grad_fn=lambda th, d: {k: d[0].view(-1, 1, 1) * (x - d[1][k])
                               for k, x in th.items()},
        loss_fn=lambda th, d: sum(0.5 * d[0] * ((x - d[1][k]) ** 2).sum(
            dim=(1, 2)) for k, x in th.items()),
        worker_data=(a, {"u": c[:, :4200].view(4, 60, 70),
                         "v": c[:, 4200:].view(4, 30, 8)}))
    common.reset_launches()
    runs = [simulator.run(opt.make("chb", 0.05, 4, eps1=4.0, backend=b,
                                   transport="lowrank", rank=2), task, 3)
            for b in ("cuda", "reference")]
    assert torch.equal(runs[0].mask, runs[1].mask)
    for k in ("u", "v"):
        assert _same(runs[0].final_params[k], runs[1].final_params[k])
    assert {k: v for k, v in common.LAUNCHES.items() if v} == \
        {name: 6 for name in ("sqnorm_batched", "residual_ef_batched",
                              "bank_advance", "fold_workers", "hb_update")}


@pytest.mark.parametrize("k", [1, 700, 3799, 4099, 5000])
def test_topk_keep_on_the_card_equals_the_cpu(card, k):
    """The exact keep masks rank ties by index on the card as on the CPU
    (where the CPU tests hold them to ``lax.top_k``)."""
    gen = torch.Generator().manual_seed(k)
    x = torch.randint(-3, 4, (4, 4099), generator=gen).to(torch.float32)
    x[:, ::5] = torch.where(x[:, ::5] == 0, -0.0, x[:, ::5])
    got = opt.tree_topk_keep(x.to(card), k).cpu()
    assert _same(got, opt.tree_topk_keep(x, k))
    assert (got.sum(dim=1) == min(k, 4099)).all()


@pytest.mark.parametrize("kw,names", [
    ({}, ("censor_delta_sqnorm_batched", "censor_bank_advance",
          "fold_workers", "hb_update")),
    ({"quantize": "int8"}, ("sqnorm_batched", "absmax_batched",
                            "quantize_ef_batched", "bank_advance",
                            "fold_workers", "hb_update")),
], ids=["dense", "int8"])
def test_staged_route_equals_the_fused_route(card, kw, names):
    task = edge_tasks.make_edge_quadratics(m=4, d=10_000, seed=0,
                                           dtype=torch.float32)
    o = opt.make("chb", 0.125, 4, eps1=4.0, backend="cuda", **kw)
    fused = simulator.run(o, task, 3)
    common.reset_launches()
    with fused_step.force_staged():
        staged = simulator.run(o, task, 3)
    assert {k: v for k, v in common.LAUNCHES.items() if v} == \
        {name: 3 for name in names}
    assert torch.equal(staged.mask, fused.mask)
    assert _same(staged.final_params, fused.final_params)
    for a, b in zip(staged.final_state.ghat, fused.final_state.ghat):
        assert _same(a, b)


@pytest.mark.parametrize("kw", [{}, {"quantize": "int8"}],
                         ids=["dense", "int8"])
def test_shard_step_plus_apply_server_is_step(card, kw):
    task = edge_tasks.make_edge_quadratics(m=4, d=10_000, seed=0,
                                           dtype=torch.float32)
    o = opt.make("chb", 0.125, 4, eps1=4.0, backend="cuda", **kw)
    params = task.init_params.to(card)
    a, c = (x.to(card) for x in task.worker_data)
    s1 = s2 = o.init(params)
    p1 = p2 = params
    for _ in range(3):
        s1, p1, st1 = o.step(s1, p1, task.grad_fn(p1, (a, c)))
        new, partial, st2 = o.shard_step(s2, p2, task.grad_fn(p2, (a, c)))
        p2 = o.apply_server(p2, s2.prev_params, partial)
        s2 = new
        assert torch.equal(st1.mask, st2.mask)
        assert _same(tree_sqnorm(partial), st1.agg_grad_sqnorm)
    assert _same(p1, p2) and _same(s1.ghat, s2.ghat)
    for f in s1.comm._fields:
        assert torch.equal(getattr(s1.comm, f), getattr(s2.comm, f))


def test_per_tensor_launches_per_leaf(card):
    """per_tensor on a two-leaf tree: B8, B9, the worker fold and B3
    once a leaf a step."""
    flat = edge_tasks.make_edge_quadratics(m=4, d=60 * 70 + 30 * 8, seed=0,
                                           dtype=torch.float32)
    a, c = flat.worker_data
    task = simulator.FedTask(
        init_params={"u": torch.zeros((60, 70), device=card),
                     "v": torch.zeros((30, 8), device=card)},
        grad_fn=lambda th, d: {k: d[0].view(-1, 1, 1) * (x - d[1][k])
                               for k, x in th.items()},
        loss_fn=lambda th, d: sum(0.5 * d[0] * ((x - d[1][k]) ** 2).sum(
            dim=(1, 2)) for k, x in th.items()),
        worker_data=(a, {"u": c[:, :4200].view(4, 60, 70),
                         "v": c[:, 4200:].view(4, 30, 8)}))
    common.reset_launches()
    runs = [simulator.run(opt.make("chb", 0.05, 4, eps1=4.0, backend=b,
                                   granularity="per_tensor"), task, 3)
            for b in ("cuda", "reference")]
    assert torch.equal(runs[0].mask, runs[1].mask)
    assert runs[0].final_state.comm.uplink_bytes_exact() == \
        runs[1].final_state.comm.uplink_bytes_exact()
    for k in ("u", "v"):
        assert _same(runs[0].final_params[k], runs[1].final_params[k])
    assert {k: v for k, v in common.LAUNCHES.items() if v} == \
        {name: 6 for name in ("sqnorm_batched", "bank_advance",
                              "fold_workers", "hb_update")}


# ------------------------------------------------- B12a, B12b, B13, B14
def _f64_attention(q, k, v, valid):
    """softmax(q k^T / sqrt(d), masked to -1e30) v in f64; q (B, K, G, Lq,
    d), k/v (B, K, S, d), valid broadcast to (Lq, S)."""
    s = torch.einsum("bkgqd,bksd->bkgqs", q.double(), k.double()) \
        * q.shape[-1] ** -0.5
    p = torch.softmax(torch.where(valid, s, -1e30), dim=-1)
    return torch.einsum("bkgqs,bksd->bkgqd", p, v.double())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("h,kh,lq,s,d,causal,window,offset", [
    (8, 8, 100, 100, 64, True, None, 0), (8, 4, 130, 130, 64, True, 48, 0),
    (8, 2, 77, 333, 64, False, None, 0), (8, 2, 200, 150, 64, False, 40, 0),
    # Lq = S at the edges of the kernel's 128-row query tiles
    (4, 4, 1, 1, 64, True, None, 0), (4, 4, 127, 127, 64, True, None, 0),
    (4, 4, 128, 128, 64, True, None, 0), (4, 2, 129, 129, 64, True, None, 0),
    # GQA 12/2 under a window whose band crosses the 128-row edge
    (12, 2, 300, 300, 64, True, 100, 0),
    # d = 33 (element-wise loads) and d = 80 (zero-filled up to 128)
    (4, 2, 129, 129, 33, True, None, 0), (4, 2, 150, 150, 80, False, 70, 0),
    # q, k and v one element off their storage's alignment
    (8, 4, 130, 130, 64, True, None, 1),
    # Lq > S: rows 169 .. 299 have no key and give the mean of v
    (4, 2, 300, 140, 64, True, 30, 0)])
def test_flash_attention_matches_plain_version(card, dtype, h, kh, lq, s, d,
                                               causal, window, offset):
    """Error against f64 at most 4x the f32 plain version's, plus 1e-6."""
    gen = torch.Generator(device=card).manual_seed(lq + s + d + offset)

    def view(n, x):        # a (2, x, n, d) view of a (2, n, x, d) tensor
        flat = torch.randn(offset + 2 * n * x * d, generator=gen,
                           device=card).to(dtype)
        return flat[offset:].view(2, n, x, d).transpose(1, 2)

    q, k, v = view(lq, h), view(s, kh), view(s, kh)
    assert flash_attention.async_copy_ok(q, k, v) == (
        dtype == torch.float32 and d % 4 == 0 and offset == 0)
    common.reset_launches()
    out = flash_attention.flash_attention(q, k, v, causal=causal,
                                          window=window)
    assert common.LAUNCHES["flash_attention"] == 1
    plain = ref.flash_attention_fwd(q, k, v, causal=causal, window=window)
    qp = torch.arange(lq, device=card)[:, None]
    kp = torch.arange(s, device=card)[None, :]
    valid = torch.ones((lq, s), dtype=torch.bool, device=card)
    if causal:
        valid &= kp <= qp
    if window is not None:
        valid &= kp > qp - window
    exact = _f64_attention(q.reshape(2, kh, h // kh, lq, d), k, v,
                           valid).reshape(2, h, lq, d)
    err_k = float((out.double() - exact).abs().max())
    err_p = float((plain.double() - exact).abs().max())
    assert out.dtype == dtype and err_k <= 4 * err_p + 1e-6
    assert torch.equal(out, flash_attention.flash_attention(
        q, k, v, causal=causal, window=window))


@pytest.mark.parametrize("kh,c,pos", [(8, 1, 0), (4, 97, 0), (4, 97, 40),
                                      (2, 97, 300), (2, 2081, 5000)])
def test_decode_attention_matches_plain_version(card, kh, c, pos):
    from repro_torch.models.kvcache import slot_positions
    gen = torch.Generator(device=card).manual_seed(c + pos)
    q = torch.randn((3, 8, 64), generator=gen, device=card)
    k, v = (torch.randn((3, c, kh, 64), generator=gen, device=card)
            .transpose(1, 2) for _ in range(2))
    cpos = slot_positions(pos + 1, c, card)
    common.reset_launches()
    out = decode_attention.decode_attention(q, k, v, cpos, pos)
    assert common.LAUNCHES["decode_attention"] == 1
    plain = ref.decode_attention_ref(q, k, v, cpos, pos)
    valid = ((cpos >= 0) & (cpos <= pos))[None, :]
    exact = _f64_attention(q.reshape(3, kh, 8 // kh, 1, 64), k, v,
                           valid).reshape(3, 8, 64)
    err_k = float((out.double() - exact).abs().max())
    err_p = float((plain.double() - exact).abs().max())
    assert err_k <= 4 * err_p + 1e-6


@pytest.mark.parametrize("dg,dh", [(torch.float32, torch.float32),
                                   (torch.float64, torch.float64),
                                   (torch.float64, torch.float32),
                                   (torch.float32, torch.bfloat16)],
                         ids=["f32", "f64", "f64-f32", "f32-bf16"])
def test_single_tensor_kernels_match_plain_versions(card, dg, dh):
    gen = torch.Generator(device=card).manual_seed(5)
    g = torch.randn(70001, generator=gen, device=card, dtype=torch.float64)
    h = (g + 0.1 * torch.randn(70001, generator=gen, device=card,
                               dtype=torch.float64)).to(dh)
    g = g.to(dg)
    g[::7] = -0.0
    common.reset_launches()
    sq = ops.censor_delta_sqnorm(g, h)
    torch.testing.assert_close(sq, ref.censor_delta_sqnorm(g, h), rtol=1e-5,
                               atol=0)
    assert _same_or_nan(sq, ops.censor_delta_sqnorm(g, h))
    g[3] = float("nan")
    for t in (0, 1):
        out = ops.censor_select(g, h, t)
        want = ref.censor_select(g, h, t)
        assert out.dtype == dh and torch.equal(
            out.view(torch.int16 if dh == torch.bfloat16 else
                     torch.int32 if dh == torch.float32 else torch.int64),
            want.view(torch.int16 if dh == torch.bfloat16 else
                      torch.int32 if dh == torch.float32 else torch.int64))
    assert common.LAUNCHES["censor_delta_sqnorm"] == 2
    assert common.LAUNCHES["censor_select"] == 2


def test_serving_launches_b14_per_layer_and_b13_per_step(card):
    """The reduced model on the card: one B14 a layer per prefill, one B13
    a layer per decode step; logits within 2e-4 of the reference backend's
    (the CPU tolerance against the JAX package)."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.launch import serve
    from repro_torch.models import model
    from repro_torch.random import PRNGKey
    cfg = dataclasses.replace(get("chb-paper-lm-124m").reduced(),
                              num_kv_heads=2, layer_pattern="AS",
                              sliding_window=16, qk_norm=True).validate()
    params = model.init_params(PRNGKey(0, device=card), cfg)
    prompts = serve.prompts_of(cfg, 2, 24, card)
    ref_run = serve.generate(params, cfg, prompts, 6, backend="reference",
                             device=card)
    common.reset_launches()
    run = serve.generate(params, cfg, prompts, 6, feed=ref_run.tokens,
                         device=card)
    assert {k: v for k, v in common.LAUNCHES.items() if v} == \
        {"flash_attention": 2, "decode_attention": 10}
    for a, b in zip(run.logits, ref_run.logits):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
    assert not torch.backends.cuda.matmul.allow_tf32


# ------------------------------------------------- the edge runtime (fed)
@pytest.mark.parametrize("m,n", [(4, 1), (4, 4099), (9, 2 ** 20 + 17)])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_sqnorm_row_equals_the_batched_slice(card, m, n, dtype):
    gen = torch.Generator(device=card).manual_seed(m + n)
    x = torch.randn((m, n), generator=gen, dtype=dtype, device=card)
    y = x[:, : n // 2 + 1].contiguous()
    batched = ops.tree_sqnorms({"a": x, "b": y})
    for i in range(m):
        # a worker's row, fresh as the event runtime's pending tree is
        row = ops.tree_sqnorm_row({"a": x[i].clone(), "b": y[i].clone()})
        assert _same(row, batched[i])


@pytest.mark.parametrize("algo,kw", [("chb", {}),
                                     ("csgd", {"tau0": 5.0 * 4099}),
                                     ("chb", {"quantize": "int8"})],
                         ids=["chb", "csgd", "chb-int8"])
def test_run_edge_sync_anchor_on_the_card(card, algo, kw):
    from repro_torch import fed
    # the quadratics' gradient is elementwise: one worker's equals its row
    task = edge_tasks.make_edge_quadratics(m=5, d=4099, seed=0, device=card)
    o = opt.make(algo, 0.1, 5, backend="cuda", **kw)
    ref_run = simulator.run(o, task, 60, device=card)
    common.reset_launches()
    hist = fed.run_edge(o, task, fed.sync_config(5), 60, device=card)
    evals = hist.stats.as_dict()["uplinks"] + hist.stats.as_dict()["censored"]
    assert {k: v for k, v in common.LAUNCHES.items() if v} == \
        {"sqnorm_batched": evals, "hb_update": 60}
    assert (hist.mask == ref_run.mask.cpu().numpy()).all()
    assert (hist.comm_cum == ref_run.comm_cum.cpu().numpy()).all()
    assert _same(hist.final_params, ref_run.final_params)


def test_prng_draws_on_the_card_equal_the_cpu(card):
    from repro_torch import random as jrandom
    for dtype in DTYPES:
        u = [jrandom.uniform(jrandom.PRNGKey(5, device=d), (4099,), dtype)
             for d in (card, "cpu")]
        assert _same(u[0].cpu(), u[1])
    keys = jrandom.fold_in(jrandom.PRNGKey(1, device=card),
                           torch.arange(9, device=card))
    assert torch.equal(keys.cpu(), jrandom.fold_in(
        jrandom.PRNGKey(1, device="cpu"), torch.arange(9)))


def _launched():
    return {k: v for k, v in common.LAUNCHES.items() if v}


def test_sweep_points_equal_run_on_the_card(card):
    """Every point of a dense/int8 grid equals ``simulator.run`` of its
    optimizer bit for bit on the card; each partition launches exactly its
    points' step kernels, and metrics add no launch."""
    from repro_torch import sweep
    task = edge_tasks.make_edge_quadratics(m=4, d=70001, seed=0,
                                           dtype=torch.float32, device=card)
    base = opt.make("chb", 0.125, 4, eps1=4.0, backend="cuda")
    grid = sweep.ConfigGrid(alpha=(0.125,), beta=(0.0, 0.4),
                            eps1=(0.0, 4.0), quantize=(None, "int8"))
    for metrics in (False, True):
        common.reset_launches()
        res = sweep.run_sweep(grid, task, num_iters=8, base_cfg=base,
                              device=card, collect_metrics=metrics)
        assert res.num_programs == 2
        assert _launched() == {"censor_delta_sqnorm_batched": 4 * 8,
                               "fused_dense_step": 4 * 8,
                               "int8_stats_batched": 4 * 8,
                               "fused_int8_step": 4 * 8}
    for spec, h in zip(res.specs, res.histories):
        ref_run = simulator.run(opt.from_spec(spec), task, 8, device=card)
        for f in ("objective", "comm_cum", "mask", "agg_grad_sqnorm"):
            assert torch.equal(getattr(h, f), getattr(ref_run, f)), f
        assert _same(h.final_params, ref_run.final_params)
        assert _same(h.final_state.ghat, ref_run.final_state.ghat)


def test_fed_sweep_on_the_card(card):
    """The ideal scenario equals ``simulator.run``; every scenario is the
    same on both backends; B8, B9, the worker fold and B3 launch once a
    round a scenario."""
    from repro_torch import sweep
    task = edge_tasks.make_edge_quadratics(m=5, d=4099, seed=0, device=card)
    grid = sweep.FedScenarioGrid(loss_prob=(0.0, 0.3),
                                 participation=(1.0, 0.6), quorum=(1.0, 0.5))
    res, launched = {}, {}
    for b in ("cuda", "reference"):
        common.reset_launches()
        res[b] = sweep.run_fed_sweep(opt.make("chb", 0.1, 5, backend=b),
                                     task, grid, 30, device=card)
        launched[b] = _launched()
    assert launched["cuda"] == {"sqnorm_batched": 8 * 30,
                                "bank_advance": 8 * 30,
                                "fold_workers": 8 * 30, "hb_update": 8 * 30}
    assert launched["reference"] == {}
    for f in ("objective", "agg_grad_sqnorm", "transmit_mask",
              "delivered_mask", "participate_mask", "quorum_met"):
        assert (getattr(res["cuda"], f) == getattr(res["reference"], f)).all()
    ref_run = simulator.run(opt.make("chb", 0.1, 5, backend="cuda"), task,
                            30, device=card)
    assert (res["cuda"].objective[0] == ref_run.objective.cpu().numpy()).all()
    assert (res["cuda"].transmit_mask[0]
            == ref_run.mask.cpu().numpy()).all()
    assert not res["cuda"].quorum_met.all()


# (M, n) of B2/B6's two designs (kernels/common.py:fold_path): the fed-mesh
# frontier, chip_smoke's kernels_large_m, one column past grid y's limit, a
# short tall bank, and each side of the threshold (M at ONE_PASS_MAX_WORKERS
# and one above; n one short of a column for each thread the card holds,
# and at it: "wide-1" and "wide", resolved on the card)
FOLD_SHAPES = [(100000, 16), (70000, 2049), (65536, 1), (300, 16),
               (common.ONE_PASS_MAX_WORKERS, 16),
               (common.ONE_PASS_MAX_WORKERS + 1, 16),
               (common.ONE_PASS_MAX_WORKERS + 1, "wide-1"),
               (common.ONE_PASS_MAX_WORKERS + 1, "wide")]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("m,n", FOLD_SHAPES)
def test_fused_steps_on_both_designs(card, m, n, dtype):
    """B2 and B6 by the design their wrapper picks, bit for bit against
    the plain versions (NaN where they give NaN), the other design against
    the first, a repeat launch and the M=1 calls of _sample_workers; all
    three masks; inputs salted with -0.0 (one column all -0.0, one whose
    ghat' is -0.0 in every row under the all-zeros mask), NaN and +-inf."""
    if isinstance(n, str):
        wide = common.sm_count(card.index or 0) * common.THREADS_PER_SM
        n = wide - 1 if n == "wide-1" else wide
    g, h, e, t, p, _ = _inputs(m, n, dtype, card)
    g[:, 0], h[:, 0], e[:, 0] = -0.0, -0.0, -0.0
    if n > 1:
        g[:, 1], h[:, 1] = -1.0, -0.0
    if n >= 3:
        g[m // 2, n - 1] = float("nan")
        h[m - 1, n - 2] = float("inf")
        g[0, n - 1] = float("-inf")
    path = common.fold_path(m, n, common.sm_count(card.index or 0))
    other = "one_pass" if path == "tall" else "tall"
    scale = int8_scale(fused_step.int8_stats_batched(g, h, e)[1])
    masks = {"ones": torch.ones(m, device=card),
             "zeros": torch.zeros(m, device=card),
             "alternating": torch.tensor([float(i % 2 == 0)
                                          for i in range(m)], device=card)}
    for name, mask in masks.items():
        common.reset_launches()
        out = fused_step.fused_dense_step(g, h, t, p, mask, 0.1, 0.4)
        assert common.LAUNCHES["fused_dense_step"] == 1
        for a, b in zip(out, ref.fused_dense_step(g, h, t, p, mask, 0.1,
                                                  0.4)):
            assert _same_or_nan(a, b), (name, path)
        for a, b in zip(fused_step.dense_on_card(g, h, t, p, mask, 0.1, 0.4,
                                                 other), out):
            assert _same_or_nan(a, b), (name, other)
        for a, b in zip(fused_step.fused_dense_step(g, h, t, p, mask, 0.1,
                                                    0.4), out):
            assert _same_or_nan(a, b), (name, "repeat")
        if name == "zeros" and n > 1:
            assert _bits(out[1][1]).item() == _bits(
                torch.tensor(-0.0, dtype=dtype)).item()
        for w in _sample_workers(m):
            one = fused_step.fused_dense_step(g[w:w + 1], h[w:w + 1], t, p,
                                              mask[w:w + 1], 0.1, 0.4)
            assert _same_or_nan(one[0], out[0][w:w + 1]), (name, w)
        out = fused_step.fused_int8_step(g, h, e, t, p, mask, scale, 0.1,
                                         0.4)
        for a, b in zip(out, ref.fused_int8_step(g, h, e, t, p, mask, scale,
                                                 0.1, 0.4)):
            assert _same_or_nan(a, b), (name, path)
        for a, b in zip(fused_step.int8_on_card(g, h, e, t, p, mask, scale,
                                                0.1, 0.4, other), out):
            assert _same_or_nan(a, b), (name, other)
        for a, b in zip(fused_step.fused_int8_step(g, h, e, t, p, mask, scale,
                                                   0.1, 0.4), out):
            assert _same_or_nan(a, b), (name, "repeat")
        for w in _sample_workers(m):
            one = fused_step.fused_int8_step(
                g[w:w + 1], h[w:w + 1], e[w:w + 1], t, p, mask[w:w + 1],
                scale[w:w + 1], 0.1, 0.4)
            assert _same_or_nan(one[0], out[0][w:w + 1]) \
                and _same_or_nan(one[1], out[1][w:w + 1]), (name, w)


# (M, n) of fold_workers: both designs on each side of common.fold_path's
# threshold (M at ONE_PASS_MAX_WORKERS and one above; n one short of a
# column for each thread the card holds, and at it), and the fed mesh's
# tall banks up to 10^5 rows
FOLD_WORKER_SHAPES = [(1, 7), (4, 4099), (common.ONE_PASS_MAX_WORKERS, 16),
                      (common.ONE_PASS_MAX_WORKERS + 1, 16), (300, 33),
                      (65536, 1), (100000, 16), (70000, 2049),
                      (common.ONE_PASS_MAX_WORKERS + 1, "wide-1"),
                      (common.ONE_PASS_MAX_WORKERS + 1, "wide")]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("m,n", FOLD_WORKER_SHAPES)
def test_fold_workers_on_both_designs(card, m, n, dtype):
    """The worker fold by the design its wrapper picks, bit for bit
    against ``sum_leading`` (NaN where it gives NaN), the other design
    against the first, one launch a call; a column of -0.0 stays -0.0."""
    if isinstance(n, str):
        wide = common.sm_count(card.index or 0) * common.THREADS_PER_SM
        n = wide - 1 if n == "wide-1" else wide
    gen = torch.Generator(device=card).manual_seed(m * 31 + n)
    x = torch.randn((m, n), generator=gen, device=card, dtype=dtype)
    x[:, 0] = -0.0
    if n >= 3:
        x[m // 2, n - 1] = float("nan")
        x[m - 1, n - 2] = float("inf")
    path = common.fold_path(m, n, common.sm_count(card.index or 0))
    other = "one_pass" if path == "tall" else "tall"
    common.reset_launches()
    got = fused_step.fold_workers(x)
    assert _launched() == {"fold_workers": 1}
    assert _same_or_nan(got, ref.fold_workers(x)), path
    assert _same_or_nan(fused_step.fold_on_card(x, other), got), other
    assert _bits(got[0]).item() == _bits(
        torch.tensor(-0.0, dtype=dtype)).item()


@pytest.mark.parametrize("shards", [1, 2, 8])
def test_run_mesh_on_the_card(card, shards):
    """``fed.run_mesh`` over shards on the one card equals the reference
    backend (masks, counts, objective, theta); B1, B4 and the worker fold
    launch once a shard a round, B3 once a round; at one shard the ideal
    scenario is ``simulator.run``."""
    import numpy as np

    from repro_torch import fed
    from repro_torch.launch.mesh import make_client_mesh
    m, rounds = 4000, 6
    task = edge_tasks.make_edge_quadratics(m=m, d=16, seed=0, device=card)
    mesh = make_client_mesh(shards, [card] * shards)
    sc = fed.MeshScenario(participation=0.5, loss_prob=0.3, quorum=0.5,
                          seed=3)
    runs, launched = {}, {}
    for b in ("cuda", "reference"):
        common.reset_launches()
        runs[b] = fed.run_mesh(opt.make("chb", 0.5 / m, m, eps1=4.0,
                                        backend=b), task, rounds,
                               mesh=mesh, scenario=sc)
        launched[b] = _launched()
    assert launched["cuda"] == {"censor_delta_sqnorm_batched": shards * 6,
                                "censor_bank_advance": shards * 6,
                                "fold_workers": shards * 6, "hb_update": 6}
    assert launched["reference"] == {}
    for f in ("mask", "participated", "attempted", "delivered",
              "quorum_met", "objective", "agg_grad_sqnorm"):
        assert np.array_equal(getattr(runs["cuda"], f),
                              getattr(runs["reference"], f)), f
    assert _same(runs["cuda"].final_params, runs["reference"].final_params)
    if shards == 1:
        o = opt.make("chb", 0.5 / m, m, eps1=4.0, backend="cuda")
        mh = fed.run_mesh(o, task, rounds, mesh=mesh)
        h = simulator.run(o, task, rounds, device=card)
        assert np.array_equal(mh.objective, h.objective.cpu().numpy())
        assert np.array_equal(mh.mask, h.mask.cpu().numpy().astype(np.int8))
        assert _same(mh.final_params, h.final_params)


# (M, n) of B10 and B1 on tall banks: M at 65 and 66, a short tall bank,
# each side of common.sqnorm_path's worker threshold ("t" and "t+1",
# resolved on the card), past grid y's 65535 blocks and the fed-mesh
# frontier; n in {1, 16, 33} and rows of one and of two reduction chunks
# (2048, 2049: B1's warp design takes the first only)
TALL_SHAPES = [(65, 16), (66, 33), (300, 1), ("t", 16), ("t+1", 16),
               ("t+1", 2048), (65536, 2048), (70000, 16), (100000, 16),
               (100000, 2049)]


def _tall_m(m, device):
    if isinstance(m, str):
        t = common.warp_rows_min_workers(common.sm_count(device.index or 0))
        m = t if m == "t" else t + 1
    return m


def _tall_salted(m, n, dtype, device):
    """g/pending, ghat, err and 0/1 keep masks: column 0 all -0.0, a kept
    and a dropped -0.0 in every 7th column, -0.0 in the keep mask itself,
    and where n >= 3 NaN and +-inf in the last columns."""
    g, h, e, _, _, _ = _inputs(m, n, dtype, device)
    g[:, 0], h[:, 0], e[:, 0] = -0.0, -0.0, -0.0
    if n >= 3:
        g[m // 2, n - 1] = float("nan")
        h[m - 1, n - 2] = float("inf")
        g[0, n - 1] = float("-inf")
    gen = torch.Generator(device=device).manual_seed(m + n)
    keep = (torch.rand((m, n), generator=gen, device=device) < 0.4
            ).to(dtype)
    keep[:, ::7] = 1.0
    keep[:, ::14] = 0.0
    keep[:, 3::29] = -0.0
    return g, h, e, keep


def _tall_masks(m, device):
    return {"ones": torch.ones(m, device=device),
            "zeros": torch.zeros(m, device=device),
            "alternating": torch.tensor([float(i % 2 == 0)
                                         for i in range(m)], device=device)}


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("m,n", TALL_SHAPES)
def test_select_pack_on_tall_banks(card, m, n, dtype):
    """B10 bit for bit against its plain version (NaN where it gives NaN)
    under all three masks, one launch a call, a repeat launch bitwise, and
    the M=1 row calls of _sample_workers against the batched call."""
    m = _tall_m(m, card)
    g, _, e, keep = _tall_salted(m, n, dtype, card)
    for name, mask in _tall_masks(m, card).items():
        common.reset_launches()
        out = topk_pack.select_pack_ef_batched(g, e, keep, mask)
        assert _launched() == {"select_pack_ef_batched": 1}
        for a, b in zip(out, ref.select_pack_ef_batched(g, e, keep, mask)):
            assert _same_or_nan(a, b), name
        for a, b in zip(topk_pack.select_pack_ef_batched(g, e, keep, mask),
                        out):
            assert _same(a, b), (name, "repeat")
        if name == "ones":
            for w in _sample_workers(m):
                row = topk_pack.select_pack_ef_row(g[w], e[w], keep[w])
                assert _same_or_nan(row[0], out[0][w]) \
                    and _same_or_nan(row[1], out[1][w]), w


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("m,n", TALL_SHAPES)
def test_delta_sqnorm_on_both_designs(card, m, n, dtype):
    """B1 by the design its wrapper picks against its plain version
    (rel 1e-5, NaN where NaN), one launch a call; each design that takes
    the shape bit for bit (NaN where NaN) against the first, against B8
    on g - ghat and against its M=1 calls of _sample_workers."""
    m = _tall_m(m, card)
    g, h, _, _ = _tall_salted(m, n, dtype, card)
    common.reset_launches()
    out = censor.censor_delta_sqnorm_batched(g, h)
    assert _launched() == {"censor_delta_sqnorm_batched": 1}
    plain = ref.censor_delta_sqnorm_batched(g, h)
    nan = torch.isnan(plain)
    assert torch.equal(torch.isnan(out), nan)
    torch.testing.assert_close(out[~nan], plain[~nan], rtol=1e-5, atol=0)
    b8 = censor.sqnorm_batched(g - h)
    designs = censor.SQNORM_PATHS if n <= 2048 else ("two_pass",)
    for design in designs:
        got = censor.delta_sqnorm_on_card(g, h, design)
        assert _same_or_nan(got, out) and _same_or_nan(got, b8), design
        for w in _sample_workers(m):
            one = censor.delta_sqnorm_on_card(g[w:w + 1], h[w:w + 1], design)
            assert _same_or_nan(one, out[w:w + 1]), (design, w)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("m,n", TALL_SHAPES)
def test_sqnorm_on_both_designs(card, m, n, dtype):
    """B8 by the design its wrapper picks against its plain version (rel
    1e-5, NaN where NaN), one launch a call, a repeat launch bitwise; each
    design that takes the shape bit for bit (NaN where NaN) against the
    first, against B1 on (g, ghat) and against its M=1 calls of
    _sample_workers, on x = g - ghat."""
    m = _tall_m(m, card)
    g, h, _, _ = _tall_salted(m, n, dtype, card)
    x = g - h
    common.reset_launches()
    out = censor.sqnorm_batched(x)
    assert _launched() == {"sqnorm_batched": 1}
    plain = ref.sqnorm_batched(x)
    nan = torch.isnan(plain)
    assert torch.equal(torch.isnan(out), nan)
    torch.testing.assert_close(out[~nan], plain[~nan], rtol=1e-5, atol=0)
    assert _same(censor.sqnorm_batched(x), out)
    b1 = censor.censor_delta_sqnorm_batched(g, h)
    designs = censor.SQNORM_PATHS if n <= 2048 else ("two_pass",)
    for design in designs:
        got = censor.sqnorm_on_card(x, design)
        assert _same_or_nan(got, out) and _same_or_nan(got, b1), design
        for w in _sample_workers(m):
            one = censor.sqnorm_on_card(x[w:w + 1], design)
            assert _same_or_nan(one, out[w:w + 1]), (design, w)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("m,n", TALL_SHAPES)
def test_int8_stats_on_both_designs(card, m, n, dtype):
    """B5 by the design its wrapper picks against its plain version (the
    sums rel 1e-5, the abs-max exact; NaN where NaN), one launch a call, a
    repeat launch bitwise; each design that takes the shape bit for bit
    (NaN where NaN) against the first, its sums against B8 and its abs-max
    against B7a on pending = (g - ghat) + e, and against its M=1 calls of
    _sample_workers."""
    m = _tall_m(m, card)
    g, h, e, _ = _tall_salted(m, n, dtype, card)
    common.reset_launches()
    sq, am = fused_step.int8_stats_batched(g, h, e)
    assert _launched() == {"int8_stats_batched": 1}
    sq_p, am_p = ref.int8_stats_batched(g, h, e)
    nan = torch.isnan(sq_p)
    assert torch.equal(torch.isnan(sq), nan)
    torch.testing.assert_close(sq[~nan], sq_p[~nan], rtol=1e-5, atol=0)
    assert _same_or_nan(am, am_p)
    sq2, am2 = fused_step.int8_stats_batched(g, h, e)
    assert _same(sq2, sq) and _same(am2, am)
    pend = (g - h) + e
    b8, b7a = censor.sqnorm_batched(pend), quantize_ef.absmax_batched(pend)
    designs = censor.SQNORM_PATHS if n <= 2048 else ("two_pass",)
    for design in designs:
        s, a = fused_step.int8_stats_on_card(g, h, e, design)
        assert _same_or_nan(s, sq) and _same_or_nan(a, am), design
        assert _same_or_nan(s, b8) and _same_or_nan(a, b7a), design
        for w in _sample_workers(m):
            s1, a1 = fused_step.int8_stats_on_card(
                g[w:w + 1], h[w:w + 1], e[w:w + 1], design)
            assert _same_or_nan(s1, sq[w:w + 1]) \
                and _same_or_nan(a1, am[w:w + 1]), (design, w)


# (M, n) of B7a and B9 on tall banks: past common.sqnorm_path's worker
# threshold ("t+1", resolved on the card), past grid y's 65535 blocks and
# the fed-mesh frontier; n in {1, 16, 33, 36, 2048} (33: element loads
# past the first row; 2048: a row of one full reduction chunk). Each on an
# aligned leaf and on a view one element off alignment.
TALL_B7A_B9 = [(m, n) for m in ("t+1", 70000, 100000)
               for n in (1, 16, 33, 36, 2048)]


def _offset_view(x, offset):
    """A copy of ``x`` in a view ``offset`` elements into its storage."""
    flat = torch.empty(offset + x.numel(), dtype=x.dtype, device=x.device)
    out = flat[offset:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("m,n", TALL_B7A_B9)
def test_absmax_on_both_designs(card, m, n, offset, dtype):
    """B7a by the design its wrapper picks against its plain version (NaN
    where NaN, +0 for a row of -0.0), one launch a call, a repeat launch
    bitwise, equal to B5's abs-max of the same pending; each design bit
    for bit (NaN where NaN) against the first and against its M=1 calls of
    _sample_workers."""
    m = _tall_m(m, card)
    g, h, e, _ = _tall_salted(m, n, dtype, card)
    g[1], h[1], e[1] = -0.0, 0.0, -0.0          # pending all -0.0
    pend = (g - h) + e
    x = _offset_view(pend, offset)
    common.reset_launches()
    am = quantize_ef.absmax_batched(x)
    assert _launched() == {"absmax_batched": 1}
    assert _same_or_nan(am, ref.absmax_batched(pend))
    assert _bits(am[1]).item() == 0
    assert _same(quantize_ef.absmax_batched(x), am)
    assert _same_or_nan(am, fused_step.int8_stats_batched(g, h, e)[1])
    for design in censor.SQNORM_PATHS:
        assert _same_or_nan(quantize_ef.absmax_on_card(x, design), am), design
        for w in _sample_workers(m):
            one = quantize_ef.absmax_on_card(x[w:w + 1], design)
            assert _same_or_nan(one, am[w:w + 1]), (design, w)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("m,n", TALL_B7A_B9)
def test_bank_advance_on_tall_banks(card, m, n, offset, dtype):
    """B9 (one design, B10's tiling) under all three masks bit for bit
    against its plain version (NaN where NaN, -0.0 included), one launch a
    call, a repeat launch bitwise, and the M=1 calls of _sample_workers
    against the batched call."""
    m = _tall_m(m, card)
    g, h, _, _ = _tall_salted(m, n, dtype, card)
    hh, qq = _offset_view(h, offset), _offset_view(g, offset)
    for name, mask in _tall_masks(m, card).items():
        common.reset_launches()
        out = censor.bank_advance(hh, qq, mask)
        assert _launched() == {"bank_advance": 1}
        assert _same_or_nan(out, ref.bank_advance(h, g, mask)), name
        assert _same(censor.bank_advance(hh, qq, mask), out), name
        for w in _sample_workers(m):
            r = slice(w, w + 1)
            assert _same_or_nan(censor.bank_advance(hh[r], qq[r], mask[r]),
                                out[r]), (name, w)


# (M, n) of B4 and B7b on the tall tiling of B9: M one past a 64-row
# block tile, one past common.sqnorm_path's worker threshold on an H100
# (1057), past grid y's 65535 blocks and the fed-mesh frontier; n in {1,
# 16, 33, 2049} (33 and 2049: element loads, every row after the first off
# 16-byte alignment)
TALL_B4_B7B = [(m, n) for m in (65, 1057, 70000, 100000)
               for n in (1, 16, 33, 2049)]
# storage offsets of (first operand, second operand): both aligned, both a
# view one element off alignment, the second alone off it
B4_B7B_OFFSETS = [(0, 0), (1, 1), (0, 1)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("offsets", B4_B7B_OFFSETS,
                         ids=["aligned", "both_off", "ghat_off"])
@pytest.mark.parametrize("m,n", TALL_B4_B7B)
def test_censor_bank_advance_on_tall_banks(card, m, n, offsets, dtype):
    """B4 (one design, B9's tall tiling) on (g, ghat) under all three
    masks: bit for bit (NaN where NaN, -0.0 included) against its plain
    version and B2's ghat', one launch a call, a repeat launch bitwise,
    and the M=1 calls of _sample_workers against the batched call."""
    g, h, _, _ = _tall_salted(m, n, dtype, card)
    t = torch.zeros(n, dtype=dtype, device=card)
    gg, hh = (_offset_view(x, off) for x, off in zip((g, h), offsets))
    for name, mask in _tall_masks(m, card).items():
        common.reset_launches()
        out = censor.censor_bank_advance(gg, hh, mask)
        assert _launched() == {"censor_bank_advance": 1}
        assert _same_or_nan(out, ref.censor_bank_advance(g, h, mask)), name
        ghat2 = fused_step.fused_dense_step(g, h, t, t, mask, 0.1, 0.4)[0]
        assert _same_or_nan(out, ghat2), (name, "B2's ghat'")
        assert _same(censor.censor_bank_advance(gg, hh, mask), out), name
        for w in _sample_workers(m):
            r = slice(w, w + 1)
            one = censor.censor_bank_advance(gg[r], hh[r], mask[r])
            assert _same_or_nan(one, out[r]), (name, w)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("offsets", B4_B7B_OFFSETS,
                         ids=["aligned", "both_off", "err_off"])
@pytest.mark.parametrize("m,n", TALL_B4_B7B)
def test_quantize_ef_on_tall_banks(card, m, n, offsets, dtype):
    """B7b (one design, the tall tiling of B9 and B4) on (pending, err)
    under all three masks, the scales of the plain abs-max (a NaN row's
    1, an inf row's inf): payload and err' bit for bit (NaN where NaN)
    against its plain version, err' against B6's, one launch a call, a
    repeat launch bitwise, and the M=1 calls of _sample_workers against
    the batched call."""
    g, h, e, _ = _tall_salted(m, n, dtype, card)
    pend = (g - h) + e
    scale = int8_scale(ref.absmax_batched(pend))
    t = torch.zeros(n, dtype=dtype, device=card)
    pp, ee = (_offset_view(x, off) for x, off in zip((pend, e), offsets))
    for name, mask in _tall_masks(m, card).items():
        common.reset_launches()
        out = quantize_ef.quantize_ef_batched(pp, ee, mask, scale)
        assert _launched() == {"quantize_ef_batched": 1}
        for a, b in zip(out, ref.quantize_ef_batched(pend, e, mask, scale)):
            assert _same_or_nan(a, b), name
        err6 = fused_step.fused_int8_step(g, h, e, t, t, mask, scale, 0.1,
                                          0.4)[1]
        assert _same_or_nan(out[1], err6), (name, "B6's err'")
        again = quantize_ef.quantize_ef_batched(pp, ee, mask, scale)
        assert all(_same(a, b) for a, b in zip(again, out)), name
        for w in _sample_workers(m):
            r = slice(w, w + 1)
            one = quantize_ef.quantize_ef_batched(pp[r], ee[r], mask[r],
                                                  scale[r])
            assert all(_same_or_nan(a, b[r]) for a, b in zip(one, out)), \
                (name, w)
    if n >= 3:
        assert float(scale[m // 2]) == 1.0 and bool(torch.isnan(
            out[0][m // 2, n - 1]))
