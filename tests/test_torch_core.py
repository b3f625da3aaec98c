"""Core primitives of the PyTorch port held against the JAX package.

Both packages get the same numpy inputs. Every JAX input is built with an
explicit dtype, so the results do not depend on the process-wide x64 flag
(other test modules turn it on at import; this one does too, for f64).
"""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import accounting as j_accounting
from repro.core import censoring as j_censoring
from repro.core import quantize as j_quantize
from repro.core import util as j_util
from repro_torch import tree
from repro_torch.core import accounting, censoring, quantize, util

M = 5
SHAPES = {"w1": (6, 10), "b1": (10,), "w2": (10, 3)}
DTYPES = [np.float32, np.float64]


def _np_tree(seed, dtype, lead=()):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(lead + s).astype(dtype)
            for k, s in SHAPES.items()}


def _jax(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _torch(t):
    return tree.tree_map(torch.from_numpy, t)


def test_tree_order_matches_jax():
    nested = {"b": {"z": np.zeros(1), "a": np.zeros(2)}, "a": np.zeros(3),
              "c": (np.zeros(4), [np.zeros(5)])}
    want = [x.shape for x in jax.tree_util.tree_leaves(nested)]
    leaves, treedef = tree.tree_flatten(nested)
    assert [x.shape for x in leaves] == want
    back = tree.tree_unflatten(treedef, leaves)
    assert [x.shape for x in tree.tree_leaves(back)] == want
    assert isinstance(back["c"], tuple) and isinstance(back["c"][1], list)


@pytest.mark.parametrize("dtype", DTYPES)
def test_tree_sum_leading_is_a_left_fold(dtype):
    x = _np_tree(0, dtype, (M,))
    got = util.tree_sum_leading(_torch(x))
    want_j = j_util.tree_sum_leading(_jax(x))
    eps = np.finfo(dtype).eps
    for k, v in x.items():
        fold = v[0].copy()
        for m in range(1, M):
            fold = fold + v[m]
        # bitwise the explicit index-order fold
        np.testing.assert_array_equal(got[k].numpy(), fold)
        # XLA's axis-0 reduce may group the sum differently
        bound = M * eps * np.abs(v).sum(axis=0)
        assert np.all(np.abs(got[k].numpy() - np.asarray(want_j[k]))
                      <= bound)


def test_tree_utils_match_jax():
    a, b = _np_tree(8, np.float32), _np_tree(9, np.float32)
    stacked = _np_tree(10, np.float32, (M,))
    pairs = [
        (util.tree_add(_torch(a), _torch(b)), j_util.tree_add(_jax(a), _jax(b))),
        (util.tree_sub(_torch(a), _torch(b)), j_util.tree_sub(_jax(a), _jax(b))),
        (util.tree_scale(_torch(a), 0.5), j_util.tree_scale(_jax(a), 0.5)),
        (util.tree_zeros_like(_torch(a)), j_util.tree_zeros_like(_jax(a))),
        (util.tree_stack_zeros(_torch(a), 3), j_util.tree_stack_zeros(_jax(a), 3)),
        (util.tree_worker_slice(_torch(stacked), 2),
         j_util.tree_worker_slice(_jax(stacked), 2)),
        (util.tree_cast(_torch(a), torch.float64),
         j_util.tree_cast(_jax(a), jnp.float64)),
    ]
    for got, want in pairs:
        for k in SHAPES:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
            assert got[k].numpy().dtype == np.asarray(want[k]).dtype
    assert util.tree_bytes(_torch(a)) == j_util.tree_bytes(_jax(a))


@pytest.mark.parametrize("dtype", DTYPES)
def test_norms_match_jax(dtype):
    delta = _np_tree(1, dtype, (M,))
    a, b = _np_tree(2, dtype), _np_tree(3, dtype)
    # f32 accumulation on both sides for both dtypes (the delta is cast
    # to f32 before squaring); only the summation order differs
    np.testing.assert_allclose(
        censoring.delta_sqnorms(_torch(delta)).numpy(),
        np.asarray(j_censoring.delta_sqnorms(_jax(delta))), rtol=1e-5)
    np.testing.assert_allclose(
        float(censoring.step_sqnorm(_torch(a), _torch(b))),
        float(j_censoring.step_sqnorm(_jax(a), _jax(b))), rtol=1e-5)
    np.testing.assert_allclose(float(util.tree_sqnorm(_torch(a))),
                               float(j_util.tree_sqnorm(_jax(a))),
                               rtol=1e-5)
    assert censoring.delta_sqnorms(_torch(delta)).dtype == torch.float32


def test_transmit_mask_matches_jax_and_casts_eps1_first():
    rng = np.random.default_rng(4)
    dsq = rng.uniform(0, 2, size=64).astype(np.float32)
    ssq = np.float32(1.0)
    # a tie that only the f32 cast decides: 0.1 rounds up in f32, so
    # dsq == f32(0.1) is censored in f32 but transmits against f64 0.1
    dsq[0] = np.float32(0.1)
    eps1 = 0.1
    t_dsq, t_ssq = torch.from_numpy(dsq), torch.tensor(ssq)
    j_mask = np.asarray(j_censoring.transmit_mask(
        jnp.asarray(dsq), jnp.asarray(ssq), eps1))
    by_float = censoring.transmit_mask(t_dsq, t_ssq, eps1).numpy()
    by_f64 = censoring.transmit_mask(
        t_dsq, t_ssq, torch.tensor(eps1, dtype=torch.float64)).numpy()
    by_traced = np.asarray(j_censoring.transmit_mask(
        jnp.asarray(dsq), jnp.asarray(ssq), jnp.asarray(eps1, jnp.float64)))
    np.testing.assert_array_equal(by_float, j_mask)
    np.testing.assert_array_equal(by_f64, by_float)
    np.testing.assert_array_equal(by_traced, by_float)
    assert by_float[0] == 0.0 and float(dsq[0]) > eps1
    skip = censoring.skip_condition(t_dsq, t_ssq, eps1).numpy()
    np.testing.assert_array_equal(skip, by_float == 0.0)
    assert censoring.paper_eps1(0.05, 9) == j_censoring.paper_eps1(0.05, 9)


def test_comm_stats_exact_past_2_24_and_2_31():
    payload = 654_388_224           # one dense f32 upload at d=163,597,056
    rng = np.random.default_rng(5)
    masks = (rng.uniform(size=(12, 4)) < 0.6).astype(np.float32)
    c = accounting.CommStats.init(4, device="cpu")
    j = j_accounting.CommStats.init(4)
    for row in masks:
        c = c.update(torch.from_numpy(row), payload)
        j = j.update(jnp.asarray(row), payload)
        assert c.uplink_bytes_exact() == j.uplink_bytes_exact()
    sent = int(masks.sum())
    assert c.uplink_bytes_exact() == sent * payload > 2 ** 31
    assert int(c.total_uplinks) == sent
    np.testing.assert_array_equal(c.uplink_count.numpy(),
                                  masks.sum(axis=0).astype(np.int32))
    assert int(c.iterations) == int(c.downlink_count) == 12
    assert c.uplink_mib.dtype == torch.int32
    assert float(c.uplink_bytes) == float(sent * payload)
    # one byte at a time past 2^24: a float32 counter would stall here
    c = accounting.CommStats.init(1, device="cpu")._replace(
        uplink_mib=torch.tensor(16, dtype=torch.int32))
    for _ in range(3):
        c = c.update(torch.ones(1), 1)
    assert c.uplink_bytes_exact() == 2 ** 24 + 3
    c = c.add_bytes_split(torch.tensor(2 ** 11, dtype=torch.int32),
                          torch.tensor(2 ** 20 + 5, dtype=torch.int32))
    assert c.uplink_bytes_exact() == 2 ** 24 + 3 + 2 ** 31 + 2 ** 20 + 5


@pytest.mark.parametrize("dtype", DTYPES)
def test_int8_roundtrip_matches_jax(dtype):
    # amax = 127 gives scale 1, so the .5 entries are exact ties that round
    # half to even; a zero tensor has amax 0 and scale 1
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.0, -0.0],
                    dtype=dtype)
    zeros = np.zeros(8, dtype=dtype)
    rand = np.random.default_rng(6).standard_normal(8).astype(dtype)
    for x in (ties, zeros, rand):
        q, s = quantize.quantize_int8(torch.from_numpy(x))
        jq, js = j_quantize.quantize_int8(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js) and s.dtype == torch.float32
        np.testing.assert_array_equal(
            quantize.quantize_roundtrip(torch.from_numpy(x)).numpy(),
            np.asarray(j_quantize.quantize_roundtrip(jnp.asarray(x))))
    q, s = quantize.quantize_int8(torch.from_numpy(ties))
    assert q.tolist() == [127, 0, 2, 2, 0, -2, 3, 0] and float(s) == 1.0
    assert float(quantize.quantize_int8(torch.from_numpy(zeros))[1]) == 1.0
    stacked = np.stack([ties, zeros, rand])
    got = quantize.tree_quantize_roundtrip_per_worker(
        {"x": torch.from_numpy(stacked)})["x"].numpy()
    want = np.asarray(j_quantize.tree_quantize_roundtrip_per_worker(
        {"x": jnp.asarray(stacked)})["x"])
    np.testing.assert_array_equal(got, want)


def test_payload_bytes_match_jax():
    p = _np_tree(7, np.float32)
    assert quantize.payload_bytes_int8(_torch(p)) == \
        j_quantize.payload_bytes_int8(_jax(p))
    assert quantize.payload_bytes_dense(_torch(p)) == \
        j_quantize.payload_bytes_dense(_jax(p))
    assert util.tree_count_params(_torch(p)) == \
        j_util.tree_count_params(_jax(p))
