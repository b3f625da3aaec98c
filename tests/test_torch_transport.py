"""The port's top-k and low-rank transports held against the JAX package's.

Tolerances and why:
  * top-k keep masks: exact. The keep set is an integer outcome; the
    inputs are integers in [-3, 3] with +-0.0 mixed in, so most entries
    tie and the lowest-index rule of ``lax.top_k`` decides;
  * ``payload_bytes``: exact (Python ints);
  * ``_orthonormalize`` and the low-rank encode/feedback: within 1e-12 of
    max |x| at f64 and 1e-5 of it at f32. Both packages run the same
    Gram-Schmidt loop and the same three products, but torch's and XLA's
    dot products sum in other orders;
  * the top-k residual after a transmit: ``payload + new_err == pending``
    exactly (``np.testing.assert_array_equal``, under which -0.0 equals
    +0.0, as the JAX conformance suite holds it): each payload entry is
    pending or 0, so the residual is 0 or pending;
  * the ``cuda`` route (``encode_feedback_cuda``, plain versions on CPU
    tensors) against ``encode`` + ``feedback``: bit for bit.
"""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.opt import transport as j_transport
from repro_torch.kernels import common
from repro_torch.opt import transport

M = 3
TREE = {"w1": (6, 10), "b1": (10,), "w2": (2, 3, 4)}


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint64 if x.dtype == np.float64 else np.uint32)


def _tied(shape, seed):
    """Integers in [-3, 3], a third of the zeros negative."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, size=shape).astype(np.float64)
    x[(x == 0) & (rng.random(shape) < 0.33)] = -0.0
    return x


def _tree(seed, dtype, m=M):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((m,) + s).astype(dtype)
            for k, s in TREE.items()}


def _to_torch(tree):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in tree.items()}


def _to_jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("shape", [(24,), (4, 9), (2, 3, 5)],
                         ids=["24", "4x9", "2x3x5"])
def test_topk_keep_equals_lax_top_k_on_ties(shape):
    size = int(np.prod(shape))
    for seed in range(3):
        x = _tied((M,) + shape, seed)
        assert (x == 0).sum() and np.signbit(x[x == 0]).any()
        for k in (1, 5, size, size + 3):
            got = transport.tree_topk_keep(torch.from_numpy(x), k).numpy()
            want = np.asarray(j_transport.tree_topk_keep(jnp.asarray(x), k))
            np.testing.assert_array_equal(_bits(got), _bits(want))
            assert got.dtype == np.float64
            assert (got.reshape(M, -1).sum(axis=1) == min(k, size)).all()


def test_topk_keep_of_a_tree_and_in_f32():
    x = {k: _tied((M,) + s, 5).astype(np.float32) for k, s in TREE.items()}
    got = transport.tree_topk_keep(_to_torch(x), 7)
    want = j_transport.tree_topk_keep(_to_jax(x), 7)
    for key in TREE:
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)],
                         ids=["f64", "f32"])
def test_orthonormalize_matches_jax(dtype, tol):
    rng = np.random.default_rng(3)
    p = rng.standard_normal((9, 3)).astype(dtype)
    p[:, 1] = 0.0                       # a zero column passes through
    got = transport._orthonormalize(torch.from_numpy(p)).numpy()
    want = np.asarray(j_transport._orthonormalize(jnp.asarray(p)))
    assert np.all(got[:, 1] == 0) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_allclose(got[:, [0, 2]].T @ got[:, [0, 2]],
                               np.eye(2), atol=10 * tol)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)],
                         ids=["f64", "f32"])
def test_lowrank_encode_feedback_match_jax(dtype, tol):
    j_t = j_transport.LowRankTransport(rank=2)
    t = transport.LowRankTransport(rank=2)
    params = {k: np.zeros(s, dtype) for k, s in TREE.items()}
    j_err = j_t.init(_to_jax(params), M)
    err = t.init(_to_torch(params), M)
    for key in TREE:
        np.testing.assert_array_equal(err["q"][key].numpy(),
                                      np.asarray(j_err["q"][key]))
    mask = np.array([1.0, 0.0, 1.0], np.float32)

    @jax.jit
    def j_step(delta, err):
        pend = j_t.prepare(delta, err)
        pay, aux = j_t.encode(pend, err)
        return pay, j_t.feedback(jnp.asarray(mask), pend, pay, aux, err)

    for step in range(3):               # the warm start carries over
        delta = _tree(10 + step, dtype)
        j_pay, j_err = j_step(_to_jax(delta), j_err)
        pend = t.prepare(_to_torch(delta), err)
        pay, aux = t.encode(pend, err)
        err = t.feedback(torch.from_numpy(mask), pend, pay, aux, err)
        for key in TREE:
            for got, want in ((pay[key], j_pay[key]),
                              (err["err"][key], j_err["err"][key]),
                              (err["q"][key], j_err["q"][key])):
                want = np.asarray(want)
                assert got.shape == want.shape
                scale = max(np.abs(want).max(initial=0.0), 1.0)
                np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                           atol=tol * scale)
    # a vector leaf ships dense and keeps no factor
    assert err["q"]["b1"].shape == (M, 0)


def test_payload_bytes_match_jax():
    for dtype in (np.float32, np.float64):
        params = {k: np.zeros(s, dtype) for k, s in TREE.items()}
        for kind, j_cls, cls, kws in (
                ("topk", j_transport.TopKTransport, transport.TopKTransport,
                 ({"k": 1}, {"k": 7}, {"k": 60}, {})),
                ("lowrank", j_transport.LowRankTransport,
                 transport.LowRankTransport,
                 ({"rank": 1}, {"rank": 2}, {"rank": 50}))):
            for kw in kws:
                assert cls(**kw).payload_bytes(_to_torch(params)) == \
                    j_cls(**kw).payload_bytes(_to_jax(params)), (kind, kw)
    assert transport.TopKTransport.exact_residual
    assert transport.DenseTransport.exact_residual
    assert transport.Int8Transport.exact_residual
    assert not transport.LowRankTransport.exact_residual


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_topk_residual_is_exact_and_cuda_route_is_bitwise(dtype):
    common.reset_launches()
    t = transport.TopKTransport(k=5)
    params = _to_torch({k: np.zeros(s, dtype) for k, s in TREE.items()})
    err = t.init(params, M)
    mask = torch.tensor([1.0, 0.0, 1.0])
    for step in range(3):
        delta = _to_torch(_tree(20 + step, dtype))
        pend = t.prepare(delta, err)
        pay, _ = t.encode(pend, err)
        new_err = t.feedback(mask, pend, pay, (), err)
        k_pay, k_err = t.encode_feedback_cuda(pend, err, mask)
        for key in TREE:
            p, q, e = pend[key].numpy(), pay[key].numpy(), new_err[key].numpy()
            tx = mask.numpy() != 0
            np.testing.assert_array_equal(q[tx] + e[tx], p[tx])
            np.testing.assert_array_equal(e[~tx], err[key].numpy()[~tx])
            np.testing.assert_array_equal(_bits(k_pay[key]), _bits(q))
            np.testing.assert_array_equal(_bits(k_err[key]), _bits(e))
        err = new_err
    assert t.ef_bank(err) is err
    assert common.LAUNCHES == {k: 0 for k in common.KERNELS}


def test_lowrank_cuda_route_is_bitwise():
    t = transport.LowRankTransport(rank=2)
    params = _to_torch({k: np.zeros(s, np.float64) for k, s in TREE.items()})
    err = t.init(params, M)
    mask = torch.tensor([0.0, 1.0, 1.0])
    pend = t.prepare(_to_torch(_tree(30, np.float64)), err)
    pay, aux = t.encode(pend, err)
    want = t.feedback(mask, pend, pay, aux, err)
    k_pay, got = t.encode_feedback_cuda(pend, err, mask)
    for key in TREE:
        for a, b in ((k_pay[key], pay[key]), (got["err"][key],
                                              want["err"][key]),
                     (got["q"][key], want["q"][key])):
            np.testing.assert_array_equal(_bits(a), _bits(b))
    assert t.ef_bank(got) is got["err"]
