"""The port's kernel wrappers (their plain versions, on CPU tensors) held
against the JAX package's Pallas kernels (interpret mode) and its
``kernels/ref.py`` oracles: B1, B2, B5, B6 of the fused route, and B3,
B8, B9, B10, B11 of the staged route and ``apply_server``.

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
  * sqnorms (B1, B5, B8): rel 1e-5 for both bank dtypes, since the delta
    is cast to f32 before squaring and both sides accumulate in f32, in
    other orders;
  * B9, B10 and B11: exact against both, -0.0 included. Every product
    there has a 0/1 mask or keep factor, so it is exact and an FMA cannot
    change the sum;
  * B3: exact against ``ref.py``; against the interpreted kernel within
    2 eps (|theta| + |alpha*nabla| + |beta*(theta - theta_prev)|), since
    XLA may contract either product-and-sum into an FMA.
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
from repro.kernels import hb_update as j_hb
from repro.kernels import lowrank_ef as j_lowrank
from repro.kernels import ref as j_ref
from repro.kernels import topk_pack as j_topk
from repro_torch.core.quantize import int8_scale
from repro_torch.kernels import (build, censor, common, fused_step,
                                 hb_update, lowrank_ef, quantize_ef,
                                 topk_pack)
from repro_torch.opt import GradientDescent, HeavyBall

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


def _keep(m, shape, dtype):
    """0/1 keep masks that keep some of pending's -0.0 entries (every 7th
    flat index holds one) and drop others; a -0.0 mask entry drops."""
    rng = np.random.default_rng(7 * m + len(shape))
    keep = (rng.random((m,) + shape) < 0.4).astype(dtype)
    flat = keep.reshape(m, -1)
    flat[:, ::7] = 1.0
    flat[:, ::14] = 0.0
    flat[:, 3::29] = -0.0
    return keep


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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", LEAVES)
@pytest.mark.parametrize("m", WORKERS)
def test_b8_sqnorm(m, shape, dtype):
    g, h, *_ = _inputs(m, shape, dtype)
    x = g - h
    got = censor.sqnorm_batched(*_t(x))
    assert got.dtype == torch.float32 and got.shape == (m,)
    for want in (j_censor.sqnorm_batched(*_j(x), interpret=True),
                 j_ref.sqnorm_batched(*_j(x))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    # the plain versions of B8 on g - ghat and of B1 on (g, ghat) agree
    np.testing.assert_allclose(
        got.numpy(), censor.censor_delta_sqnorm_batched(*_t(g, h)).numpy(),
        rtol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", LEAVES)
@pytest.mark.parametrize("m", WORKERS)
def test_b9_bank_advance(m, shape, dtype):
    g, h, _, _, _, mask = _inputs(m, shape, dtype)
    got = censor.bank_advance(*_t(h, g, mask))
    for want in (j_censor.bank_advance(*_j(h, g, mask), interpret=True),
                 j_ref.bank_advance(*_j(h, g, mask))):
        _exact(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", LEAVES)
@pytest.mark.parametrize("m", WORKERS)
def test_b10_select_pack_ef(m, shape, dtype):
    g, _, e, _, _, mask = _inputs(m, shape, dtype)
    keep = _keep(m, shape, dtype)
    payload, new_err = topk_pack.select_pack_ef_batched(*_t(g, e, keep,
                                                            mask))
    for want in (j_topk.select_pack_ef_batched(*_j(g, e, keep, mask),
                                               interpret=True),
                 j_ref.select_pack_ef_batched(*_j(g, e, keep, mask))):
        _exact(payload, want[0])
        _exact(new_err, want[1])
    kept = keep != 0
    assert np.signbit(payload.numpy()[kept & (g == 0)]).any(), \
        "no kept -0.0 entry was tested"
    ones = np.ones((m,), np.float32)
    full = topk_pack.select_pack_ef_batched(*_t(g, e, keep, ones))
    w = m - 1
    row = topk_pack.select_pack_ef_row(*_t(g[w], e[w], keep[w]))
    j_row = j_topk.select_pack_ef_row(*_j(g[w], e[w], keep[w]),
                                      interpret=True)
    for got, batched, want in zip(row, full, j_row):
        _exact(got, batched[w].numpy())
        _exact(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", LEAVES)
@pytest.mark.parametrize("m", WORKERS)
def test_b11_residual_ef(m, shape, dtype):
    g, h, e, _, _, mask = _inputs(m, shape, dtype)
    got = lowrank_ef.residual_ef_batched(*_t(g, h, e, mask))
    for want in (j_lowrank.residual_ef_batched(*_j(g, h, e, mask),
                                               interpret=True),
                 j_ref.residual_ef_batched(*_j(g, h, e, mask))):
        _exact(got, want)
    w = m - 1
    row = lowrank_ef.residual_ef_row(*_t(g[w], h[w], e[w]))
    ones = np.ones((m,), np.float32)
    _exact(row, lowrank_ef.residual_ef_batched(*_t(g, h, e, ones))[w]
           .numpy())
    _exact(row, j_lowrank.residual_ef_row(*_j(g[w], h[w], e[w]),
                                          interpret=True))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", LEAVES)
def test_b3_hb_update(shape, dtype):
    g, _, _, t, p, _ = _inputs(1, shape, dtype)
    nab = g[0]
    eps = np.finfo(dtype).eps
    bound = 2 * eps * (np.abs(t) + np.abs(ALPHA * nab)
                       + np.abs(BETA * (t - p)))
    for beta, server in ((BETA, HeavyBall(ALPHA, BETA)),
                         (0.0, GradientDescent(ALPHA))):
        got = hb_update.hb_update(*_t(t, nab, p), ALPHA, beta)
        _exact(got, j_ref.hb_update(*_j(t, nab, p), ALPHA, beta))
        _exact(got, server.apply(*_t(t, p, nab)).numpy())
        _within(got, j_hb.hb_update(*_j(t, nab, p), ALPHA, beta,
                                    interpret=True), bound)


@pytest.mark.parametrize("shape", [(0,), (3, 0)], ids=["0", "3x0"])
def test_size_zero_leaves_return_what_jax_returns(shape):
    m, dt = 2, np.float32
    x = np.zeros((m,) + shape, dt)
    mask = np.ones((m,), np.float32)
    x_t, mask_t = _t(x, mask)
    _exact(censor.sqnorm_batched(x_t),
           j_censor.sqnorm_batched(*_j(x), interpret=True))
    assert censor.bank_advance(x_t, x_t, mask_t) is x_t
    payload, new_err = topk_pack.select_pack_ef_batched(x_t, x_t, x_t,
                                                        mask_t)
    assert payload is x_t and new_err.shape == x.shape
    for got, want in zip((payload, new_err), j_topk.select_pack_ef_batched(
            *_j(x, x, x, mask), interpret=True)):
        _exact(got, want)
    _exact(lowrank_ef.residual_ef_batched(x_t, x_t, x_t, mask_t),
           j_lowrank.residual_ef_batched(*_j(x, x, x, mask), interpret=True))
    theta = x_t[0]
    assert hb_update.hb_update(theta, theta, theta, ALPHA, BETA) is theta


def test_wrappers_reject_what_the_kernels_do_not_take():
    g, h, e, t, p, mask = _t(*_inputs(2, (8,), np.float32))
    with pytest.raises(TypeError, match="bank dtype"):
        censor.censor_delta_sqnorm_batched(g.half(), h.half())
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
    with pytest.raises(ValueError, match="shape"):
        topk_pack.select_pack_ef_batched(g, e, h[:1], mask)
    with pytest.raises(ValueError, match="mask"):
        censor.bank_advance(h, g, mask.double())
    with pytest.raises(TypeError, match="one dtype"):
        lowrank_ef.residual_ef_batched(g, h.double(), e, mask)
    with pytest.raises(TypeError, match="bank dtype"):
        hb_update.hb_update(t.half(), t.half(), t.half(), ALPHA, BETA)
    # a device that is neither the CPU nor CUDA is refused, not run plainly
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        censor.censor_delta_sqnorm_batched(g.to("meta"), h.to("meta"))
    # the staged kernels B4, B7a and B7b check their operands the same way
    with pytest.raises(ValueError, match="mask"):
        censor.censor_bank_advance(g, h, mask[:1])
    with pytest.raises(TypeError, match="bank dtype"):
        quantize_ef.absmax_batched(g.half())
    with pytest.raises(ValueError, match="scale"):
        quantize_ef.quantize_ef_batched(g, e, mask,
                                        torch.ones(2, dtype=torch.float64))
    with pytest.raises(TypeError, match="one dtype"):
        quantize_ef.quantize_ef_batched(g, e.double(), mask,
                                        torch.ones(2))


@pytest.mark.parametrize("shape,span,m,blocks", [
    ((4, 163_597_056), build.REDUCE_CHUNK, 4, 79_882),
    ((4, 163_597_056), build.ABSMAX_SPAN, 4, 4_993),
    ((100_000, 16), build.REDUCE_CHUNK, 100_000, 1),
    ((10 ** 6, 16), build.ROW_TILE, 1, 1)])
def test_grid_chunks_of_the_main_shapes(shape, span, m, blocks):
    """Grid x of the seven per-worker kernels at chb-paper-lm-124m's width
    and at the fed-mesh's client counts (the worker walks grid y)."""
    assert common.grid_chunks("k", shape, shape[1], span, m) == blocks


@pytest.mark.parametrize("shape,span,m", [
    ((2, 2 ** 31 * build.REDUCE_CHUNK), build.REDUCE_CHUNK, 2),
    ((2 ** 31, 16), build.REDUCE_CHUNK, 2 ** 31),
    ((3, 2 ** 31 * build.ROW_TILE + 1), build.ROW_TILE, 1)])
def test_grid_chunks_name_the_limit_and_the_shape(shape, span, m):
    """What one launch cannot hold raises in the wrapper, naming the
    limit and the shape, before the launcher's bare ``invalid
    argument``: more than 2^31 - 1 blocks of a row, or more workers than
    pass 2's one block each."""
    with pytest.raises(ValueError, match=r"2\^31 - 1") as err:
        common.grid_chunks("sqnorm_batched", shape, shape[1], span, m)
    assert f"{tuple(shape)}" in str(err.value)
    assert "sqnorm_batched" in str(err.value)
