"""The port's kernel wrappers (their plain versions, on CPU tensors) held
against the JAX package's Pallas kernels (interpret mode) and its
``kernels/ref.py`` oracles.

Tolerances and why:
  * masks, abs-max and the int8 outputs err' and ghat': exact (the same
    elementwise expressions, each correctly rounded), except err' against
    the Pallas kernel in f32: XLA compiles the interpreted kernel and
    contracts ``pending - q*scale`` into an FMA there, so that err' is held
    to 4 eps |pending| (the eager ``ref.py`` oracle stays exact);
  * B2's ghat': rel 1e-6 (f32) / 1e-14 (f64), since XLA may contract
    ``ghat + mask*(g - ghat)`` into an FMA;
  * agg and theta': an absolute bound of M*eps*sum_m|ghat'_m| (times alpha
    for theta') plus a few ulps of theta's terms, because XLA's axis-0
    reduce may group the worker sum differently from the port's left fold;
    with cancellation a relative bound would mean nothing;
  * sqnorms: rel 1e-5 for both bank dtypes, since the delta is cast to f32
    before squaring and both sides accumulate in f32, in other orders.
The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``.
"""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import censor as j_censor
from repro.kernels import fused_step as j_fused
from repro.kernels import ref as j_ref
from repro_torch.core.quantize import int8_scale
from repro_torch.kernels import censor, common, fused_step

LEAVES = [(20,), (3, 50), (300, 129)]
WORKERS = [1, 5]
DTYPES = [np.float32, np.float64]
ALPHA, BETA = 0.05, 0.4


def _inputs(m, shape, dtype, seed=0):
    rng = np.random.default_rng(seed + 17 * m + len(shape))
    g, h = (rng.standard_normal((m,) + shape).astype(dtype)
            for _ in range(2))
    e = (0.01 * rng.standard_normal((m,) + shape)).astype(dtype)
    t, p = (rng.standard_normal(shape).astype(dtype) for _ in range(2))
    g.reshape(m, -1)[:, ::7] = -0.0
    h.reshape(m, -1)[:, ::11] = -0.0
    e.reshape(m, -1)[:, ::5] = -0.0
    if m > 1:                        # one worker with an all-zero pending
        g[-1] = h[-1]
        e[-1] = 0.0
    mask = np.array([1.0, 0.0, 1.0, 1.0, 0.0][:m], np.float32)
    return g, h, e, t, p, mask


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _exact(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def _fold_bounds(ng, t, p, dtype):
    """(agg bound, theta' bound) for a worker sum taken in another order."""
    eps = np.finfo(dtype).eps
    m = ng.shape[0]
    agg_b = m * eps * np.abs(ng).sum(axis=0)
    agg = ng.sum(axis=0)
    theta_b = ALPHA * agg_b + 4 * eps * (np.abs(t) + np.abs(ALPHA * agg)
                                         + np.abs(BETA * (t - p)))
    return agg_b, theta_b


def _within(got, want, bound):
    assert np.all(np.abs(got.numpy() - np.asarray(want)) <= bound)


@pytest.fixture(autouse=True)
def _zero_launches():
    common.reset_launches()
    yield
    assert common.LAUNCHES == {k: 0 for k in common.KERNELS}, \
        "a CPU tensor reached a kernel launch"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", LEAVES)
@pytest.mark.parametrize("m", WORKERS)
def test_b1_delta_sqnorm(m, shape, dtype):
    g, h, *_ = _inputs(m, shape, dtype)
    got = censor.censor_delta_sqnorm_batched(*_t(g, h))
    assert got.dtype == torch.float32 and got.shape == (m,)
    for want in (j_censor.censor_delta_sqnorm_batched(*_j(g, h),
                                                      interpret=True),
                 j_ref.censor_delta_sqnorm_batched(*_j(g, h))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", LEAVES)
@pytest.mark.parametrize("m", WORKERS)
def test_b5_int8_stats(m, shape, dtype):
    g, h, e, *_ = _inputs(m, shape, dtype)
    sq, am = fused_step.int8_stats_batched(*_t(g, h, e))
    for want_sq, want_am in (
            j_fused.int8_stats_batched(*_j(g, h, e), interpret=True),
            j_ref.int8_stats_batched(*_j(g, h, e))):
        np.testing.assert_allclose(sq.numpy(), np.asarray(want_sq),
                                   rtol=1e-5)
        _exact(am, want_am)
    if m > 1:
        assert float(am[-1]) == 0.0 and float(int8_scale(am)[-1]) == 1.0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", LEAVES)
@pytest.mark.parametrize("m", WORKERS)
def test_b2_fused_dense_step(m, shape, dtype):
    g, h, _, t, p, mask = _inputs(m, shape, dtype)
    ng, agg, out = fused_step.fused_dense_step(*_t(g, h, t, p, mask),
                                               ALPHA, BETA)
    rtol = 1e-6 if dtype == np.float32 else 1e-14
    agg_b, theta_b = _fold_bounds(ng.numpy(), t, p, dtype)
    for want in (j_fused.fused_dense_step(*_j(g, h, t, p, mask), ALPHA, BETA,
                                          interpret=True),
                 j_ref.fused_dense_step(*_j(g, h, t, p, mask), ALPHA, BETA)):
        np.testing.assert_allclose(ng.numpy(), np.asarray(want[0]),
                                   rtol=rtol, atol=0)
        _within(agg, want[1], agg_b)
        _within(out, want[2], theta_b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", LEAVES)
@pytest.mark.parametrize("m", WORKERS)
def test_b6_fused_int8_step(m, shape, dtype):
    g, h, e, t, p, mask = _inputs(m, shape, dtype)
    _, am = fused_step.int8_stats_batched(*_t(g, h, e))
    scale = int8_scale(am)
    ng, ne, agg, out = fused_step.fused_int8_step(
        *_t(g, h, e, t, p, mask), scale, ALPHA, BETA)
    j_scale = jnp.asarray(scale.numpy())
    agg_b, theta_b = _fold_bounds(ng.numpy(), t, p, dtype)
    pending = (g - h) + e
    fma_b = 4 * np.finfo(dtype).eps * np.abs(pending)
    for want, contracted in (
            (j_fused.fused_int8_step(*_j(g, h, e, t, p, mask), j_scale,
                                     ALPHA, BETA, interpret=True), True),
            (j_ref.fused_int8_step(*_j(g, h, e, t, p, mask), j_scale,
                                   ALPHA, BETA), False)):
        _exact(ng, want[0])
        if contracted and dtype == np.float32:
            _within(ne, want[1], fma_b)
        else:
            _exact(ne, want[1])
        _within(agg, want[2], agg_b)
        _within(out, want[3], theta_b)


def test_wrappers_reject_what_the_kernels_do_not_take():
    g, h, e, t, p, mask = _t(*_inputs(2, (8,), np.float32))
    with pytest.raises(TypeError, match="bank dtype"):
        censor.censor_delta_sqnorm_batched(g.bfloat16(), h.bfloat16())
    with pytest.raises(TypeError, match="one dtype"):
        fused_step.int8_stats_batched(g, h.double(), e)
    with pytest.raises(ValueError, match="mask"):
        fused_step.fused_dense_step(g, h, t, p, mask[:1], ALPHA, BETA)
    with pytest.raises(ValueError, match="scale"):
        fused_step.fused_int8_step(g, h, e, t, p, mask,
                                   torch.ones(2, dtype=torch.float64),
                                   ALPHA, BETA)
    with pytest.raises(ValueError, match="shape"):
        fused_step.fused_dense_step(g, h, t[:4], p, mask, ALPHA, BETA)
    # a device that is neither the CPU nor CUDA is refused, not run plainly
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        censor.censor_delta_sqnorm_batched(g.to("meta"), h.to("meta"))
    with pytest.raises(NotImplementedError, match="staged"):
        fused_step.force_staged()
