"""bf16 and f32-on-bf16 banks of B1, B2, B5 and B6 against their plain
versions, on the card.

Marked ``cuda``: these need an NVIDIA card with ``nvcc`` and skip without
one (``tests/test_torch_bf16_banks.py`` holds the plain versions against
the JAX package on the CPU). On a card they run with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_bf16_banks_cuda.py

Each design of each kernel, both dtype pairs (and B5/B6 with an f32 err),
against the plain version on the card: B2's and B6's outputs and B5's
abs-max bit for bit (NaN where NaN), the sums of B1 and B5 within rel
1e-5; the designs against each other and the M=1 call against the batched
slice bit for bit. ``chip_smoke.py`` phase fused_bf16_banks runs the same
over more shapes.
"""
import pytest
import torch

from repro_torch import opt
from repro_torch.core import simulator
from repro_torch.core.quantize import int8_scale
from repro_torch.data import edge_tasks
from repro_torch.kernels import censor, common, fused_step, ref

pytestmark = pytest.mark.cuda

BF16, F32 = torch.bfloat16, torch.float32
COMBOS = {"bf16": (BF16, BF16, BF16), "f32_bf16": (F32, BF16, BF16),
          "f32_bf16_f32": (F32, BF16, F32)}
SHAPES = [(1, 33), (4, 2049), (9, 128 * 257 + 3), (2000, 16)]
SQNORM_RTOL = 1e-5
ALPHA, BETA = 0.0123, 0.4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bits(t):
    return t.view({BF16: torch.int16, F32: torch.int32}[t.dtype])


def _same_or_nan(a, b):
    nan = torch.isnan(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and torch.equal(torch.isnan(a), nan) \
        and torch.equal(_bits(a)[~nan], _bits(b)[~nan])


def _inputs(m, n, combo, device, off=0):
    """Operands ``off`` elements into their storage, salted with -0.0 and,
    where n > 3, NaN and +-inf."""
    gen = torch.Generator(device=device).manual_seed(m * 7919 + n)

    def leaf(shape, dtype, scale=1.0):
        flat = torch.randn(off + torch.Size(shape).numel(), generator=gen,
                           device=device) * scale
        return flat.to(dtype)[off:].view(shape)

    p_dt, h_dt, e_dt = combo
    g, h, e = leaf((m, n), p_dt), leaf((m, n), h_dt), leaf((m, n), e_dt, 0.01)
    t, p = leaf((n,), p_dt), leaf((n,), p_dt)
    g[:, ::7] = -0.0
    h[:, ::11] = -0.0
    if n > 3:
        g[m // 2, n - 1] = float("nan")
        h[m - 1, n - 2] = float("inf")
        g[0, n - 3] = float("-inf")
    mask = torch.tensor([float(i % 2 == 0) for i in range(m)], device=device)
    return g, h, e, t, p, mask


@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("m,n", SHAPES)
@pytest.mark.parametrize("combo", list(COMBOS), ids=list(COMBOS))
def test_sums_on_both_designs(card, combo, m, n, off):
    g, h, e, t, p, mask = _inputs(m, n, COMBOS[combo], card, off)
    b1_p = ref.censor_delta_sqnorm_batched(g, h)
    sq_p, am_p = ref.int8_stats_batched(g, h, e)
    designs = ("two_pass", "warp") if n <= 2048 else ("two_pass",)
    first = None
    for design in designs:
        b1 = censor.delta_sqnorm_on_card(g, h, design)
        sq, am = fused_step.int8_stats_on_card(g, h, e, design)
        fin = ~torch.isnan(b1_p)
        assert torch.equal(torch.isnan(b1), ~fin)
        torch.testing.assert_close(b1[fin], b1_p[fin], rtol=SQNORM_RTOL,
                                   atol=0)
        fin = ~torch.isnan(sq_p)
        torch.testing.assert_close(sq[fin], sq_p[fin], rtol=SQNORM_RTOL,
                                   atol=0)
        assert _same_or_nan(am, am_p) and am.dtype == BF16
        first = first or (b1, sq, am)
        assert all(_same_or_nan(a, b) for a, b in zip((b1, sq, am), first))
        for w in (0, m - 1):
            r = slice(w, w + 1)
            assert _same_or_nan(censor.delta_sqnorm_on_card(
                g[r], h[r], design), b1[r])
            one = fused_step.int8_stats_on_card(g[r], h[r], e[r], design)
            assert _same_or_nan(one[0], sq[r]) and _same_or_nan(one[1], am[r])


@pytest.mark.parametrize("m,n", SHAPES)
@pytest.mark.parametrize("combo", list(COMBOS), ids=list(COMBOS))
def test_fused_steps_on_both_designs(card, combo, m, n):
    g, h, e, t, p, mask = _inputs(m, n, COMBOS[combo], card)
    scale = int8_scale(fused_step.int8_stats_batched(g, h, e)[1])
    plain = ref.fused_int8_step(g, h, e, t, p, mask, scale, ALPHA, BETA)
    plain_d = ref.fused_dense_step(g, h, t, p, mask, ALPHA, BETA)
    for path in fused_step.FOLD_PATHS:
        out = fused_step.int8_on_card(g, h, e, t, p, mask, scale, ALPHA,
                                      BETA, path)
        assert all(_same_or_nan(a, b) for a, b in zip(out, plain)), path
        if e.dtype == h.dtype:
            out = fused_step.dense_on_card(g, h, t, p, mask, ALPHA, BETA,
                                           path)
            assert all(_same_or_nan(a, b) for a, b in zip(out, plain_d))
        one = fused_step.int8_on_card(g[:1], h[:1], e[:1], t, p, mask[:1],
                                      scale[:1], ALPHA, BETA, path)
        assert _same_or_nan(one[0], plain[0][:1]) \
            and _same_or_nan(one[1], plain[1][:1])


@pytest.mark.parametrize("kw", [{}, {"quantize": "int8"}],
                         ids=["dense", "int8"])
def test_bf16_bank_run_launches_the_fused_kernels(card, kw):
    """f32 params on a bf16 bank through ``simulator.run`` on the card:
    B1 and B2 (B5 and B6) once a step, nothing else; the same masks,
    counters and theta bits as the reference backend."""
    task = edge_tasks.make_edge_quadratics(m=4, d=4099, seed=0,
                                           dtype=F32)
    runs = []
    for backend in ("cuda", "reference"):
        common.reset_launches()
        o = opt.make("chb", 0.5 / 4, 4, eps1=4.0, bank_dtype=BF16,
                     backend=backend, **kw)
        runs.append((simulator.run(o, task, 10), dict(common.LAUNCHES)))
    (hk, lk), (hr, lr) = runs
    names = ("int8_stats_batched", "fused_int8_step") if kw else \
        ("censor_delta_sqnorm_batched", "fused_dense_step")
    assert lk == {k: 10 if k in names else 0 for k in common.KERNELS}
    assert not any(lr.values())
    assert torch.equal(hk.mask, hr.mask)
    assert torch.equal(hk.comm_cum, hr.comm_cum)
    assert torch.equal(_bits(hk.final_params), _bits(hr.final_params))
    assert hk.final_state.ghat.dtype == BF16
