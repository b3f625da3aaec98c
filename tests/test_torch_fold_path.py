"""B2 and B6's two designs (``kernels/csrc/fused_step.cu``), on the CPU.

The wrappers pick a design by the bank's shape (``common.fold_path``): one
pass, a thread a column walking the workers, where the columns fill the
card or M is small; the tall design (the per-element work on the whole
card, then a fold per column tile from shared memory) elsewhere. The
kernels run only on the card (``tests/test_torch_cuda.py`` holds both
designs against the plain versions there); here:

  * the dispatch picks the one-pass design at the full-width shape (M = 4,
    n = 163,597,056) and Fig. 11's (M = 9, n = 50), the tall one at the
    fed-mesh frontier (M = 100,000, n = 16) and at M = 70,000, n = 2049,
    and moves its n threshold with the card's SM count;
  * the tall fold starts from -0.0 where the plain version starts from
    ghat'_0: the two folds are held equal bit for bit (NaN where NaN),
    -0.0 columns included;
  * the plain versions at tall shapes against the JAX package's oracles
    (``repro/kernels/ref.py``) and Pallas kernels (interpret mode), with
    ``test_torch_kernels.py``'s tolerances: ghat' exact (int8) or within
    an FMA's rounding (dense), agg and theta' within the bound of a worker
    sum taken in another order.
"""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels import fused_step as j_fused  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro_torch.core.quantize import int8_scale  # noqa: E402
from repro_torch.core.util import sum_leading  # noqa: E402
from repro_torch.kernels import common, fused_step  # noqa: E402

H100_SMS = 132
WIDE = H100_SMS * common.THREADS_PER_SM       # columns that fill an H100
ALPHA, BETA = 0.05, 0.4


@pytest.mark.parametrize("m,n,path", [
    (4, 163_597_056, "one_pass"),       # full width, chb-paper-lm-124m
    (9, 50, "one_pass"),                # Fig. 11's linreg
    (100_000, 16, "tall"),              # the fed-mesh frontier
    (70_000, 2049, "tall"),             # chip_smoke's kernels_large_m
    (1, 1, "one_pass"),                 # an M=1 row call
    (common.ONE_PASS_MAX_WORKERS, 16, "one_pass"),
    (common.ONE_PASS_MAX_WORKERS + 1, 16, "tall"),
    (common.ONE_PASS_MAX_WORKERS + 1, WIDE - 1, "tall"),
    (common.ONE_PASS_MAX_WORKERS + 1, WIDE, "one_pass"),
    (1_000_000, 16, "tall"),            # fed_mesh.py's ladder top
])
def test_fold_path_by_shape(m, n, path):
    assert common.fold_path(m, n, H100_SMS) == path


def test_fold_path_threshold_follows_the_sm_count():
    m = common.ONE_PASS_MAX_WORKERS + 1
    half = (H100_SMS // 2) * common.THREADS_PER_SM
    assert common.fold_path(m, half, H100_SMS) == "tall"
    assert common.fold_path(m, half, H100_SMS // 2) == "one_pass"
    assert common.fold_path(m, half - 1, H100_SMS // 2) == "tall"


def test_unknown_design_is_refused_before_a_launch():
    common.reset_launches()
    with pytest.raises(ValueError, match="path must be one of"):
        fused_step._launcher("fused_dense_step", "two_pass", torch.float64)
    assert fused_step._launcher("fused_int8_step", "tall",
                                torch.float32) == "fused_int8_step_tall_f32"
    assert fused_step._launcher("fused_dense_step", "one_pass",
                                torch.float64) == "fused_dense_step_f64"
    assert common.LAUNCHES["fused_dense_step"] == 0


def _fold_from_negative_zero(x: torch.Tensor) -> torch.Tensor:
    """The tall design's fold: -0.0, then every worker row in order."""
    acc = torch.full_like(x[0], -0.0)
    for w in range(x.shape[0]):
        acc = acc + x[w]
    return acc


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_fold_from_negative_zero_is_the_fold_from_the_first_row(dtype):
    rng = np.random.default_rng(19)
    m, n = 37, 64
    x = rng.standard_normal((m, n)).astype(dtype)
    x[:, 0] = -0.0                           # stays -0.0
    x[:, 1] = 0.0                            # stays +0.0
    x[::2, 2], x[1::2, 2] = -0.0, 0.0        # mixed zeros: +0.0
    x[0, 3] = -0.0                           # a -0.0 first row, then values
    x[:, 4] = rng.choice([1e30, -1e30], m).astype(dtype)   # cancellation
    x[5, 5] = np.nan
    x[6, 6], x[9, 6] = np.inf, -np.inf       # inf - inf: NaN
    x[7, 7] = np.inf
    x[:, 8] = np.finfo(dtype).tiny / 3       # subnormals
    x[:, 9] = -x[:, 9]
    t = torch.from_numpy(x)
    want = sum_leading(t)
    got = _fold_from_negative_zero(t)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan) and bool(nan[5]) \
        and bool(nan[6])
    bits = torch.int32 if dtype == np.float32 else torch.int64
    assert torch.equal(got[~nan].view(bits), want[~nan].view(bits))
    assert got.view(bits)[0] == torch.tensor(-0.0, dtype=t.dtype).view(bits)
    assert got.view(bits)[1] == 0


def _tall_inputs(m, n, dtype):
    rng = np.random.default_rng(m + n)
    g, h = (rng.standard_normal((m, n)).astype(dtype) for _ in range(2))
    e = (0.01 * rng.standard_normal((m, n))).astype(dtype)
    t, p = (rng.standard_normal(n).astype(dtype) for _ in range(2))
    g[:, ::7] = -0.0
    h[:, ::11] = -0.0
    g[:, 0], h[:, 0], e[:, 0] = -0.0, -0.0, -0.0
    mask = (np.arange(m) % 3 != 1).astype(np.float32)
    return g, h, e, t, p, mask


def _agg_bounds(ng, t, p, dtype):
    """(agg bound, theta' bound) for a worker sum taken in another order
    (``test_torch_kernels.py``'s)."""
    eps = np.finfo(dtype).eps
    agg_b = ng.shape[0] * eps * np.abs(ng).sum(axis=0)
    agg = ng.sum(axis=0)
    return agg_b, ALPHA * agg_b + 4 * eps * (np.abs(t) + np.abs(ALPHA * agg)
                                             + np.abs(BETA * (t - p)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("m,n", [(65, 16), (300, 16), (130, 33)])
def test_tall_plain_versions_against_jax(m, n, dtype):
    g, h, e, t, p, mask = _tall_inputs(m, n, dtype)
    tg, th, te, tt, tp, tm = (torch.from_numpy(x) for x in (g, h, e, t, p,
                                                           mask))
    ng, agg, out = fused_step.fused_dense_step(tg, th, tt, tp, tm, ALPHA,
                                               BETA)
    agg_b, theta_b = _agg_bounds(ng.numpy(), t, p, dtype)
    j = [jnp.asarray(x) for x in (g, h, t, p, mask)]
    rtol = 1e-6 if dtype == np.float32 else 1e-14
    for want in (j_fused.fused_dense_step(*j, ALPHA, BETA, interpret=True),
                 j_ref.fused_dense_step(*j, ALPHA, BETA)):
        np.testing.assert_allclose(ng.numpy(), np.asarray(want[0]),
                                   rtol=rtol, atol=0)
        assert np.all(np.abs(agg.numpy() - np.asarray(want[1])) <= agg_b)
        assert np.all(np.abs(out.numpy() - np.asarray(want[2])) <= theta_b)
    _, am = fused_step.int8_stats_batched(tg, th, te)
    scale = int8_scale(am)
    ng, ne, agg, out = fused_step.fused_int8_step(tg, th, te, tt, tp, tm,
                                                  scale, ALPHA, BETA)
    agg_b, theta_b = _agg_bounds(ng.numpy(), t, p, dtype)
    want = j_ref.fused_int8_step(
        *[jnp.asarray(x) for x in (g, h, e, t, p, mask)],
        jnp.asarray(scale.numpy()), ALPHA, BETA)
    np.testing.assert_array_equal(ng.numpy().view(np.uint8),
                                  np.asarray(want[0]).view(np.uint8))
    np.testing.assert_array_equal(ne.numpy().view(np.uint8),
                                  np.asarray(want[1]).view(np.uint8))
    assert np.all(np.abs(agg.numpy() - np.asarray(want[2])) <= agg_b)
    assert np.all(np.abs(out.numpy() - np.asarray(want[3])) <= theta_b)
