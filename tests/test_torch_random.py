"""The port's JAX PRNG (``repro_torch.random``) and the CSGD censor that
draws from it, held against ``jax.random`` and the JAX package's
``StochasticCensor`` in one process.

Tolerances and why:
  * threefry2x32, ``PRNGKey``, ``fold_in``, ``split``, ``random_bits`` and
    ``uniform`` (f32, f64) are integer and bit arithmetic: exact;
  * ``normal`` runs XLA's ``erf_inv`` and ``log1p`` polynomials in XLA's
    order with its fused multiply-adds, but two of XLA's CPU primitives
    are not PyTorch's: its f32 ``sqrt`` is not correctly rounded (it
    reaches only draws with |u| > 0.9966) and its f64 ``log`` is libm's
    where PyTorch's can differ in the last bit. So a draw may differ by at
    most ``NORMAL_MAX_ULP`` ulps, and at most ``NORMAL_MAX_FRAC`` of the
    draws differ at all (measured: 39 and 98 of 2,000,000 draws, f32 and
    f64, at most 2 and 3 ulps);
  * the censor's masks, ``tau_k`` and its uniforms: exact, against the
    JAX censor under ``jax.jit`` as the JAX package runs it (XLA's jitted
    f32 ``pow`` is PyTorch's CPU ``pow`` until ``decay^k`` turns
    subnormal, which XLA flushes to zero; op-by-op JAX rounds
    ``f32 ** i32`` otherwise).
"""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import opt as j_opt
from repro_torch import convert, opt
from repro_torch import random as jrandom

NORMAL_MAX_ULP = 3
NORMAL_MAX_FRAC = 1e-4
SEEDS = [0, 1, 7, 2 ** 31 - 1, 2 ** 32 + 5]
DTYPES = [(jnp.float32, torch.float32, np.int32),
          (jnp.float64, torch.float64, np.int64)]


def _key(seed):
    return jax.random.PRNGKey(seed)


def _pkey(seed):
    return jrandom.PRNGKey(seed, device="cpu")


def _bits(x, int_dtype):
    return np.asarray(x).view(int_dtype).astype(np.int64)


# Random123's known-answer vectors for threefry2x32 with 20 rounds
KAT = [((0x0, 0x0), (0x0, 0x0), (0x6b200159, 0x99ba4efe)),
       ((0xffffffff, 0xffffffff), (0xffffffff, 0xffffffff),
        (0x1cb996fc, 0xbb002be7)),
       ((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3),
        (0xc4923a9c, 0x483df7a0))]


@pytest.mark.parametrize("key,count,expect", KAT)
def test_threefry_known_answers(key, count, expect):
    t = lambda v: torch.tensor(v, dtype=torch.int64)
    y = jrandom.threefry2x32(t(key[0]), t(key[1]), t(count[0]), t(count[1]))
    assert (int(y[0]), int(y[1])) == expect


def test_threefry_matches_jax_raw_bits():
    from jax._src import prng as j_prng
    rng = np.random.default_rng(0)
    k = rng.integers(0, 2 ** 32, size=2, dtype=np.uint32)
    c = rng.integers(0, 2 ** 32, size=(2, 257), dtype=np.uint32)
    y = j_prng.threefry_2x32(jnp.asarray(k), jnp.asarray(c.reshape(-1)))
    # jax hashes the flat counts as two halves
    t = lambda v: torch.tensor(v.astype(np.int64))
    y1, y2 = jrandom.threefry2x32(t(k[0]), t(k[1]), t(c[0]), t(c[1]))
    np.testing.assert_array_equal(np.asarray(y).astype(np.int64),
                                  np.concatenate([y1.numpy(), y2.numpy()]))


@pytest.mark.parametrize("x64", [True, False])
@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed, x64):
    with jax.enable_x64(x64):
        want = np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)
    got = jrandom.PRNGKey(seed, x64=x64, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        convert.prng_key(np.asarray(jax.random.PRNGKey(seed)), "cpu").numpy(),
        _pkey(seed).numpy())


def test_fold_in_chains_and_batches():
    k, tk = _key(3), _pkey(3)
    for data in (0, 17, 2 ** 31 - 1, 2 ** 32 - 1):
        k, tk = jax.random.fold_in(k, data), jrandom.fold_in(tk, data)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(k))
    ids = np.array([4, 0, 9, 2, 7])
    want = np.stack([np.asarray(jax.random.fold_in(k, int(i))) for i in ids])
    np.testing.assert_array_equal(
        jrandom.fold_in(tk, torch.tensor(ids)).numpy(), want)


@pytest.mark.parametrize("num", [2, 15])
def test_split(num):
    for seed in (0, 11):
        want = np.asarray(jax.random.split(_key(seed), num)).astype(np.int64)
        np.testing.assert_array_equal(
            jrandom.split(_pkey(seed), num).numpy(), want)
    # a batch of keys splits key by key
    keys = jrandom.split(_pkey(5), 3)
    got = jrandom.split(keys, num)
    for i in range(3):
        np.testing.assert_array_equal(got[i].numpy(),
                                      jrandom.split(keys[i], num).numpy())


@pytest.mark.parametrize("width", [32, 64])
def test_random_bits(width):
    dt = {32: jnp.uint32, 64: jnp.uint64}[width]
    want = np.asarray(jax.random.bits(_key(5), (6, 7), dt))
    want = want.astype(np.int64) if width == 32 else want.view(np.int64)
    np.testing.assert_array_equal(
        jrandom.random_bits(_pkey(5), width, (6, 7)).numpy(), want)


@pytest.mark.parametrize("jdt,tdt,idt", DTYPES)
@pytest.mark.parametrize("shape", [(), (22, 30)])
def test_uniform_bitwise(jdt, tdt, idt, shape):
    for seed in (0, 3):
        want = jax.random.uniform(_key(seed), shape, jdt)
        got = jrandom.uniform(_pkey(seed), shape, tdt)
        np.testing.assert_array_equal(_bits(got.numpy(), idt),
                                      _bits(want, idt))
    want = jax.random.uniform(_key(1), (1000,), jdt, -2.5, 0.75)
    got = jrandom.uniform(_pkey(1), (1000,), tdt, -2.5, 0.75)
    np.testing.assert_array_equal(_bits(got.numpy(), idt), _bits(want, idt))


@pytest.mark.parametrize("jdt,tdt,idt", DTYPES)
def test_normal_within_ulp_bound(jdt, tdt, idt, monkeypatch):
    # a small CHUNK runs the chunked path too
    monkeypatch.setattr(jrandom, "CHUNK", 1 << 15)
    n = 200_000
    want = _bits(jax.random.normal(_key(3), (n,), jdt), idt)
    got = _bits(jrandom.normal(_pkey(3), (n,), tdt).numpy(), idt)
    ulp = np.abs(got - want)
    assert ulp.max() <= NORMAL_MAX_ULP
    assert np.count_nonzero(ulp) <= NORMAL_MAX_FRAC * n
    # the shapes the NN task draws: every value equal
    for shape in ((), (8, 6), (22, 30)):
        want = _bits(jax.random.normal(_key(7), shape, jdt), idt)
        got = _bits(jrandom.normal(_pkey(7), shape, tdt).numpy(),
                    idt)
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------- CSGD
def _csgd_pair(tau0=0.5, decay=0.97, seed=3):
    return (j_opt.StochasticCensor(tau0=tau0, decay=decay, seed=seed),
            opt.StochasticCensor(tau0=tau0, decay=decay, seed=seed))


@pytest.mark.parametrize("decay", [0.99, 0.97, 0.9])
def test_tau_bits(decay):
    jc, pc = _csgd_pair(decay=decay)
    ks = jnp.arange(400, dtype=jnp.int32)
    want = np.asarray(jax.jit(jax.vmap(jc._tau))(ks))
    got = np.stack([pc._tau(k).numpy() for k in range(400)])
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("m", [5, 9])
def test_stochastic_censor_decisions(m):
    jc, pc = _csgd_pair()
    decide = jax.jit(jc.decide)
    decide_ids = jax.jit(jc.decide_ids)
    client_decide = jax.jit(jc.client_decide)
    uniform = jax.jit(jc._uniform)
    rng = np.random.default_rng(m)
    k_j, k_p = jc.init(m), pc.init(m, device="cpu")
    ids = rng.permutation(4 * m)[:m]
    for k in range(60):
        dsq = rng.uniform(0.0, 0.8, m).astype(np.float32)
        mask_j, k_j = decide(k_j, jnp.asarray(dsq), jnp.zeros(()))
        mask_p, k_p = pc.decide(k_p, torch.tensor(dsq), torch.zeros(()))
        np.testing.assert_array_equal(mask_p.numpy(), np.asarray(mask_j))
        assert int(k_p) == int(k_j) == k + 1
        ids_j, _ = decide_ids(jnp.asarray(k, jnp.int32), jnp.asarray(dsq),
                              jnp.zeros(()), jnp.asarray(ids))
        ids_p, _ = pc.decide_ids(torch.tensor(k, dtype=torch.int32),
                                 torch.tensor(dsq), torch.zeros(()),
                                 torch.tensor(ids))
        np.testing.assert_array_equal(ids_p.numpy(), np.asarray(ids_j))
        u_p = pc._uniform(k, torch.tensor(ids), "cpu")
        for w in range(m):
            u_j = np.asarray(uniform(jnp.asarray(k, jnp.int32),
                                     jnp.asarray(int(ids[w]), jnp.int32)))
            assert u_p[w].numpy().view(np.int64) == u_j.view(np.int64)
            want = bool(client_decide(jnp.asarray(k, jnp.int32),
                                      jnp.asarray(w, jnp.int32),
                                      jnp.asarray(dsq[w]), jnp.zeros(())))
            got = pc.client_decide(k, w, torch.tensor(dsq[w]),
                                   torch.zeros(()))
            assert bool(got) == want == bool(mask_p[w])


def test_client_decide_of_the_other_censors():
    dsq, ssq = torch.tensor(2.0), torch.tensor(0.5)
    assert bool(opt.NeverCensor().client_decide(3, 1, dsq, ssq))
    assert bool(opt.Eq8Censor(3.9).client_decide(3, 1, dsq, ssq))
    assert not bool(opt.Eq8Censor(4.1).client_decide(3, 1, dsq, ssq))
    assert bool(opt.Eq8Censor(0.0).client_decide(3, 1, torch.tensor(0.0),
                                                 ssq))
    with pytest.raises(NotImplementedError):
        opt.AdaptiveCensor(0.5).client_decide(3, 1, dsq, ssq)
    assert not opt.AdaptiveCensor.supports_event_runtime
    assert opt.StochasticCensor.supports_event_runtime


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_csgd_spec_round_trip(backend):
    jo = j_opt.make("csgd", 0.05, 9, tau0=0.3, decay=0.95, seed=4,
                    backend=backend)
    po = opt.from_spec(j_opt.to_spec(jo))
    assert isinstance(po.censor, opt.StochasticCensor)
    assert po == opt.make("csgd", 0.05, 9, tau0=0.3, decay=0.95, seed=4,
                          backend=opt.BACKEND_ALIASES[backend])
    assert opt.from_spec(opt.to_spec(po)) == po
    spec = opt.to_spec(po)
    spec["backend"] = backend
    assert j_opt.from_spec(spec) == jo
    # eps1 is tau0's alias, as in the JAX registry
    assert opt.make("csgd", 0.05, 9, eps1=0.3).censor.tau0 == 0.3
