"""``ComposedOptimizer.step`` of the PyTorch port held against the JAX
package's reference step, plus the registry's spec mapping.

Both packages start from one state (carried across by
``repro_torch.convert``) and take five steps on the same numpy-drawn
gradients over a three-leaf dict tree, for every transport (top-k at k=4,
low-rank at rank 2). Tolerances and why:
  * masks and every ``CommStats`` counter: exact. The data are drawn so
    that no eq.-(8) decision lies within 1e-3 of its threshold (checked),
    far beyond what a summation-order difference can move;
  * delta sqnorms: rel 1e-5 (f32 accumulation, other order);
  * the bank and the transport state: exact, except for low-rank. The JAX
    step runs eagerly, so each of its elementwise ops rounds on its own,
    as each torch op does (a jitted step may contract a mul+add pair into
    an FMA), and the top-k keep sets are exact selections. Low-rank's
    payload and factors are matrix products, which torch and XLA sum in
    other orders: its bank, EF bank and factors are held to 1e-5 (f32) /
    1e-12 (f64) of the leaf's max |x|;
  * theta: rel 1e-5 (f32) / 1e-12 (f64) of max |theta|, since XLA's
    axis-0 worker sum groups differently from the port's left fold and
    the difference feeds back through five steps of momentum.
"""
import jax

jax.config.update("jax_enable_x64", True)

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import opt as j_opt
from repro.opt import registry as j_registry
from repro_torch import convert, opt, tree
from repro_torch.kernels import common, fused_step
from repro_torch.opt import registry

M = 5
SHAPES = {"w1": (6, 10), "b1": (10,), "w2": (10, 3)}
ALPHA = 0.05
EPS1 = 60.0
STEPS = 5
CASES = [("gd", {}), ("hb", {}), ("lag", {}), ("chb", {}),
         ("chb", {"quantize": "int8"}),
         ("chb", {"transport": "topk", "k": 4}),
         ("chb", {"transport": "lowrank", "rank": 2})]


def _params(dtype):
    rng = np.random.default_rng(0)
    return {k: rng.standard_normal(s).astype(dtype)
            for k, s in SHAPES.items()}


def _grads(step, dtype):
    """Per-worker gradients; worker m's scale 0.5^m spreads the eq.-(8)
    left-hand sides over orders of magnitude, so some workers censor."""
    rng = np.random.default_rng(100 + step)
    scale = 0.5 ** np.arange(M)
    return {k: (rng.standard_normal((M,) + s)
                * scale.reshape((M,) + (1,) * len(s))).astype(dtype)
            for k, s in SHAPES.items()}


def _kw(name, extra):
    kw = dict(extra)
    if name in ("lag", "chb"):
        kw["eps1"] = EPS1
    return kw


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX reference trajectory of every case, computed once."""
    out = {}
    for dtype in (np.float32, np.float64):
        for name, extra in CASES:
            o = j_opt.make(name, ALPHA, M, **_kw(name, extra))
            # eager: each jnp op rounds on its own, as each torch op does
            # (a jitted step may contract mul+add pairs into FMAs); the
            # low-rank step is held to a tolerance anyway, and compiles
            # once instead of dispatching its per-worker loop op by op
            step = (jax.jit(o.step) if extra.get("transport") == "lowrank"
                    else o.step)
            params = jax.tree_util.tree_map(jnp.asarray, _params(dtype))
            state = o.init(params)
            start = jax.tree_util.tree_map(np.asarray, state)
            recs = []
            for k in range(STEPS):
                grads = jax.tree_util.tree_map(jnp.asarray, _grads(k, dtype))
                state, params, stats = step(state, params, grads)
                recs.append(jax.tree_util.tree_map(
                    np.asarray, (state, params, stats)))
            out[name, tuple(extra.items()), dtype] = (start, recs)
    return out


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name,extra", CASES,
                         ids=["gd", "hb", "lag", "chb", "chb-int8",
                              "chb-topk", "chb-lowrank"])
def test_step_matches_jax(jax_steps, name, extra, dtype, backend):
    start, recs = jax_steps[name, tuple(extra.items()), dtype]
    o = opt.make(name, ALPHA, M, backend=backend, **_kw(name, extra))
    state = convert.opt_state(start, "cpu")
    params = convert.params(_params(dtype), "cpu")
    f32 = dtype == np.float32
    common.reset_launches()
    for k in range(STEPS):
        grads = convert.params(_grads(k, dtype), "cpu")
        state, params, stats = o.step(state, params, grads)
        j_state, j_params, j_stats = recs[k]
        np.testing.assert_array_equal(stats.mask.numpy(), j_stats.mask)
        if float(j_stats.step_sq) > 0 and name in ("lag", "chb"):
            thr = EPS1 * float(j_stats.step_sq)
            margin = np.abs(j_stats.delta_sq.astype(np.float64) - thr) / thr
            assert margin.min() > 1e-3, "test data put a decision on a tie"
        np.testing.assert_allclose(stats.delta_sq.numpy(), j_stats.delta_sq,
                                   rtol=1e-5)
        for f in ("uplink_count", "uplink_mib", "uplink_rem",
                  "downlink_count", "iterations"):
            np.testing.assert_array_equal(
                getattr(state.comm, f).numpy(), getattr(j_state.comm, f))
        exact = extra.get("transport") != "lowrank"
        for got, want in zip(
                tree.tree_leaves((state.ghat, state.err)),
                jax.tree_util.tree_leaves((j_state.ghat, j_state.err))):
            assert got.shape == want.shape
            if exact:
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                np.testing.assert_allclose(
                    got.numpy(), want, rtol=0,
                    atol=(1e-5 if f32 else 1e-12)
                    * np.abs(want).max(initial=1.0))
        for key in SHAPES:
            scale = np.abs(j_params[key]).max()
            np.testing.assert_allclose(params[key].numpy(), j_params[key],
                                       rtol=0,
                                       atol=(1e-5 if f32 else 1e-12) * scale)
    assert 0 < int(state.comm.uplink_count.sum()) <= STEPS * M
    assert common.LAUNCHES == {k: 0 for k in common.KERNELS}


def test_jax_spec_loads_with_pallas_as_cuda():
    for kw in ({}, {"quantize": "int8"}, {"transport": "topk", "k": 8},
               {"transport": "lowrank", "rank": 2}):
        j = j_opt.make("chb", 0.1, M, backend="pallas", **kw)
        spec = json.loads(json.dumps(j_opt.to_spec(j)))
        o = opt.from_spec(spec)
        assert o.backend == "cuda"
        assert o == opt.make("chb", 0.1, M, backend="cuda", **kw)
        assert opt.from_spec(opt.to_spec(o)) == o
        assert opt.to_spec(o) == dict(spec, backend="cuda")
        ref = dict(spec, backend="reference")
        assert opt.from_spec(ref).backend == "reference"
    for name in ("gd", "hb", "lag"):
        j = j_opt.make(name, 0.1, M)
        assert opt.from_spec(j_opt.to_spec(j)) == opt.make(name, 0.1, M)
    o = opt.make("chb", 0.1, M, bank_dtype=torch.float64)
    assert opt.from_spec(opt.to_spec(o)).bank_dtype is torch.float64
    # csgd loads since the JAX PRNG is ported; a kind outside the
    # vocabulary still raises
    assert opt.from_spec(j_opt.to_spec(j_opt.make("csgd", 0.1, M))) == \
        opt.make("csgd", 0.1, M)
    spec = j_opt.to_spec(j_opt.make("chb", 0.1, M))
    with pytest.raises(ValueError, match="unknown or unported"):
        opt.from_spec(dict(spec, censor={"kind": "oracle"}))
    with pytest.raises(ValueError, match="unknown backend"):
        opt.from_spec(dict(j_opt.to_spec(j_opt.make("gd", 0.1, M)),
                           backend="tpu"))


@pytest.mark.parametrize("quantize,transport,k,rank", [
    ("topk", None, 4, None),
    (None, "lowrank", None, 3),
    ("int8", "topk", None, None),           # conflicting kinds
    (None, "instance", 4, None),            # an instance binds its own k
    ("int8", "instance", None, None),
    (None, "instance", None, 2),
    ("dense", None, 4, None),               # dense has no k
    (None, "int8", None, 2),                # int8 has no rank
    ("fp4", None, None, None),              # unknown kind
], ids=["topk-k", "lowrank-rank", "conflict", "inst-k", "inst-quantize",
        "inst-rank", "dense-k", "int8-rank", "unknown"])
def test_resolve_transport_matches_jax(quantize, transport, k, rank):
    def resolve(reg, topk):
        t = topk(k=5) if transport == "instance" else transport
        try:
            return reg._resolve_transport(quantize, t, k, rank)
        except (TypeError, ValueError) as exc:
            return type(exc)

    got = resolve(registry, opt.TopKTransport)
    want = resolve(j_registry, j_opt.TopKTransport)
    if isinstance(want, type):
        assert got is want
    else:
        assert (registry._kind_of(got, opt.TRANSPORT_KINDS, "t"),
                dict(vars(got))) == \
            (j_registry._kind_of(want, j_opt.TRANSPORT_KINDS, "t"),
             dict(vars(want)))


@pytest.mark.parametrize("name", ["hb", "gd"])
def test_apply_server_on_cuda_is_server_apply(name):
    common.reset_launches()
    o = opt.make(name, ALPHA, M, backend="cuda")
    for dtype in (np.float32, np.float64):
        params = convert.params(_params(dtype), "cpu")
        prev = tree.tree_map(lambda x: x * 0.5, params)
        agg = convert.params(_grads(0, dtype), "cpu")
        agg = tree.tree_map(lambda g: g[0], agg)
        got = o.apply_server(params, prev, agg)
        want = o.server.apply(params, prev, agg)
        for key in SHAPES:
            assert got[key].dtype == want[key].dtype
            assert torch.equal(got[key].view(torch.uint8),
                               want[key].view(torch.uint8))
    assert common.LAUNCHES == {k: 0 for k in common.KERNELS}


def test_unported_routes_raise():
    # a censor kind the registry does not hold
    spec = j_opt.to_spec(j_opt.make("chb", 0.1, M))
    with pytest.raises(ValueError, match="censor kind 'oracle'"):
        opt.from_spec(dict(spec, censor={"kind": "oracle"}))
    params = tree.tree_map(torch.from_numpy, _params(np.float32))
    grads = convert.params(_grads(0, np.float32), "cpu")
    for backend in ("reference", "cuda"):
        o = opt.make("chb", 0.1, M, eps1=EPS1, granularity="per_tensor",
                     backend=backend)
        with pytest.raises(NotImplementedError, match="global granularity"):
            o.shard_step(o.init(params), params, grads)
        o = opt.make("chb", 0.1, M, eps1=EPS1, granularity="per_tensor",
                     quantize="int8", backend=backend)
        with pytest.raises(NotImplementedError, match="stateful transport"):
            o.step(o.init(params), params, grads)
    # the kernels take f32 and f64 banks only
    o = opt.make("chb", 0.1, M, eps1=EPS1, backend="cuda")
    half = tree.tree_map(lambda x: x.to(torch.bfloat16), params)
    with pytest.raises(TypeError, match="bfloat16"):
        o.step(o.init(half), half,
               tree.tree_map(lambda x: x.to(torch.bfloat16), grads))
    with pytest.raises(ValueError, match="unknown granularity"):
        opt.make("chb", 0.1, M, granularity="per_leaf")
    # the routes that used to raise here now run
    with fused_step.force_staged():
        assert not fused_step.fusion_enabled()
    o = opt.make("chb", 0.1, M, backend="cuda")
    o.shard_step(o.init(params), params, grads)
    with pytest.raises(ValueError, match="unknown backend"):
        opt.make("chb", 0.1, M, backend="pallas")
    with pytest.raises(TypeError, match="server"):
        opt.ComposedOptimizer(censor=opt.NeverCensor(),
                              transport=opt.DenseTransport(),
                              server=object(), num_workers=M,
                              backend="cuda")

    class Stateless(opt.DenseTransport):
        pass

    with pytest.raises(TypeError, match="custom transport Stateless"):
        opt.ComposedOptimizer(censor=opt.NeverCensor(),
                              transport=Stateless(),
                              server=opt.HeavyBall(0.1), num_workers=M,
                              backend="cuda")
    assert opt.ComposedOptimizer(censor=opt.NeverCensor(),
                                 transport=Stateless(),
                                 server=opt.HeavyBall(0.1), num_workers=M)
    assert o.name == "chb" and opt.make("gd", 0.1, M).name == "gd"
