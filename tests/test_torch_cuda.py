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
from repro_torch.kernels import (censor, common, fused_step, hb_update,
                                 lowrank_ef, ref, topk_pack)

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
@pytest.mark.parametrize("m,n", [(1, 1), (4, 4099), (9, 70001)])
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
    torch.cuda.synchronize()
    assert common.LAUNCHES == {"censor_delta_sqnorm_batched": 2,
                               "fused_dense_step": 1,
                               "int8_stats_batched": 1,
                               "fused_int8_step": 1,
                               "sqnorm_batched": 1, "bank_advance": 1,
                               "hb_update": 1, "select_pack_ef_batched": 1,
                               "residual_ef_batched": 1}


@pytest.mark.parametrize("kw,names", [
    ({}, ("censor_delta_sqnorm_batched", "fused_dense_step")),
    ({"quantize": "int8"}, ("int8_stats_batched", "fused_int8_step")),
    ({"transport": "topk", "k": 4_000}, ("sqnorm_batched",
                                         "select_pack_ef_batched",
                                         "bank_advance", "hb_update")),
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
    """Low-rank on a two-matrix tree: four kernels per leaf per step."""
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
                              "bank_advance", "hb_update")}


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
