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
from repro_torch.kernels import censor, common, fused_step, ref

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
    torch.cuda.synchronize()
    assert common.LAUNCHES == {"censor_delta_sqnorm_batched": 2,
                               "fused_dense_step": 1,
                               "int8_stats_batched": 1,
                               "fused_int8_step": 1}


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["dense", "int8"])
def test_main_path_launches_each_kernel_once_per_step(card, quantize):
    task = edge_tasks.make_edge_quadratics(m=4, d=10_000, seed=0,
                                           dtype=torch.float32)
    common.reset_launches()
    runs = [simulator.run(opt.make("chb", 0.125, 4, eps1=4.0,
                                   quantize=quantize, backend=b), task, 3)
            for b in ("cuda", "reference")]
    assert torch.equal(runs[0].mask, runs[1].mask)
    names = (("int8_stats_batched", "fused_int8_step") if quantize
             else ("censor_delta_sqnorm_batched", "fused_dense_step"))
    assert {k: v for k, v in common.LAUNCHES.items() if v} == \
        {name: 3 for name in names}
