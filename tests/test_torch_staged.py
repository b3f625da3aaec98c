"""The staged dense/int8 route, ``shard_step``, ``per_tensor`` granularity
and the adaptive censor of the PyTorch port, held against the JAX package.

Both packages run in one process on the same numpy-seeded inputs; the
port's ``cuda`` backend runs on CPU tensors here, so its kernel wrappers
run their plain versions (no launch is counted). Tolerances and why:
  * B4 (``censor_bank_advance``), B7a (``absmax_batched``) and B7b's
    payload (``quantize_ef_batched``): exact against the JAX package's
    interpreted Pallas kernels and its ``ref.py``, -0.0, NaN and +-inf
    entries included (a NaN compares equal to a NaN). B4's products have a
    0/1 mask factor, so an FMA cannot change them; the payload is a
    quotient, a rounding and one product;
  * B7b's err': exact against ``ref.py``; against the interpreted kernel
    in f32 within 4 eps |pending|, since XLA contracts
    ``pending - q*scale`` into an FMA there (as for B6);
  * the staged route (``force_staged()``) on f64 linreg, 60 iterations,
    against the JAX reference run: masks, ``comm_cum`` and the uplink
    counters exact (every decision clears its threshold by more than 2%),
    objective and theta within rel 1e-9 (torch and XLA reduce in other
    orders); against the port's fused route: every field bit for bit, at
    f32 and f64;
  * ``shard_step`` against the JAX ``shard_step`` (reference backend, run
    eagerly so no mul+add is contracted): masks, gates and ``CommStats``
    exact, bank and EF bank exact (elementwise, each op correctly
    rounded), the f32 delta and step sqnorms within rel 1e-5 for both bank
    dtypes (f32 sums in other orders), the adaptive EMA within rel 1e-6
    (it folds those sqnorms), the
    partial sum within M eps sum_m |ghat'_m| (XLA's axis-0 sum groups the
    workers in another order than the port's left fold); every eq.-(8)
    and adaptive decision is checked to clear its threshold by 1e-3;
  * the sync anchor: ``shard_step`` + ``apply_server`` equals ``step`` bit
    for bit on both port backends, 60 iterations;
  * ``per_tensor`` and the adaptive censor on f64 linreg, 80 iterations:
    uploads (339 and 83), masks and counters exact, objective within rel
    1e-9; on a three-leaf quadratic task the split-int32 byte counters are
    exact.
"""
import jax

jax.config.update("jax_enable_x64", True)

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import opt as j_opt
from repro.core import simulator as j_simulator
from repro.core.simulator import FedTask as JFedTask
from repro.data import paper_tasks as j_paper
from repro.kernels import censor as j_censor
from repro.kernels import quantize_ef as j_qef
from repro.kernels import ref as j_ref
from repro_torch import convert, opt, tree
from repro_torch.core import simulator
from repro_torch.core.quantize import int8_scale
from repro_torch.core.util import tree_sqnorm
from repro_torch.data import paper_tasks
from repro_torch.kernels import censor, common, fused_step, quantize_ef, ref

LEAVES = [(20,), (3, 50), (300, 129)]
WORKERS = [1, 5]
DTYPES = [np.float32, np.float64]
M = 5
# the JAX package's f64 uploads (tests/test_opt.py's pre-redesign pins)
PER_TENSOR_UPLOADS = 339
ADAPTIVE_UPLOADS = 83
ADAPTIVE = 0.25
STAGED_UPLOADS = 240


@pytest.fixture(autouse=True)
def _zero_launches():
    common.reset_launches()
    yield
    assert common.LAUNCHES == {k: 0 for k in common.KERNELS}, \
        "a CPU tensor reached a kernel launch"


# ------------------------------------------------------------ B4, B7a, B7b
def _inputs(m, shape, dtype, salt):
    rng = np.random.default_rng(31 * m + len(shape))
    g, h = (rng.standard_normal((m,) + shape).astype(dtype)
            for _ in range(2))
    e = (0.01 * rng.standard_normal((m,) + shape)).astype(dtype)
    g.reshape(m, -1)[:, ::7] = -0.0
    h.reshape(m, -1)[:, ::11] = -0.0
    e.reshape(m, -1)[:, ::5] = -0.0
    if m > 1:                        # one worker with an all-zero pending
        g[-1] = h[-1]
        e[-1] = 0.0
    if salt and m > 1:               # a NaN row and a +-inf row
        g.reshape(m, -1)[0, 3] = np.nan
        g.reshape(m, -1)[1, 2] = np.inf
        g.reshape(m, -1)[1, -1] = -np.inf
    mask = np.array([1.0, 0.0, 1.0, 1.0, 0.0][:m], np.float32)
    return g, h, e, mask


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _exact(got, want):
    """Bitwise equal, except that any NaN equals any NaN."""
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint8),
                                  want[~nan].view(np.uint8))


@pytest.mark.parametrize("salt", [False, True], ids=["finite", "nan-inf"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", LEAVES)
@pytest.mark.parametrize("m", WORKERS)
def test_b4_censor_bank_advance(m, shape, dtype, salt):
    g, h, _, mask = _inputs(m, shape, dtype, salt)
    got = censor.censor_bank_advance(*_t(g, h, mask))
    for want in (j_censor.censor_bank_advance(*_j(g, h, mask),
                                              interpret=True),
                 j_ref.censor_bank_advance(*_j(g, h, mask))):
        _exact(got, want)
    # B2's bank advance is the same expression
    t = torch.zeros(shape, dtype=got.dtype)
    new_ghat, _, _ = ref.fused_dense_step(*_t(g, h), t, t,
                                          torch.from_numpy(mask), 0.1, 0.4)
    _exact(got, new_ghat.numpy())


@pytest.mark.parametrize("salt", [False, True], ids=["finite", "nan-inf"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", LEAVES)
@pytest.mark.parametrize("m", WORKERS)
def test_b7_absmax_and_quantize_ef(m, shape, dtype, salt):
    g, h, e, mask = _inputs(m, shape, dtype, salt)
    p = (g - h) + e
    amax = quantize_ef.absmax_batched(*_t(p))
    for want in (j_qef.absmax_batched(*_j(p), interpret=True),
                 j_ref.absmax_batched(*_j(p))):
        _exact(amax, want)
    # B5's abs-max of the same pending, recomputed from (g, ghat, err)
    _exact(amax, ref.int8_stats_batched(*_t(g, h, e))[1].numpy())
    if m > 1:
        assert float(amax[-1]) == 0.0 and float(int8_scale(amax)[-1]) == 1.0
    if salt and m > 1:
        assert np.isnan(float(amax[0])) and float(amax[1]) == np.inf
    scale = int8_scale(amax)
    payload, new_err = quantize_ef.quantize_ef_batched(
        *_t(p, e, mask), scale)
    jp, je = j_qef.quantize_ef_batched(*_j(p, e, mask, scale.numpy()),
                                       interpret=True)
    rp, re_ = j_ref.quantize_ef_batched(*_j(p, e, mask, scale.numpy()))
    _exact(payload, jp)
    _exact(payload, rp)
    _exact(new_err, re_)
    if dtype == np.float64:
        _exact(new_err, je)
    else:
        je = np.asarray(je)
        nan = np.isnan(je)
        np.testing.assert_array_equal(np.isnan(new_err.numpy()), nan)
        bound = 4 * np.finfo(np.float32).eps * np.abs(p)
        assert np.all(np.abs(new_err.numpy()[~nan] - je[~nan])
                      <= bound[~nan])
    # B6's err' on the same operands
    t = torch.zeros(shape, dtype=payload.dtype)
    _, err6, _, _ = ref.fused_int8_step(*_t(g, h, e), t, t,
                                        torch.from_numpy(mask), scale,
                                        0.1, 0.4)
    _exact(new_err, err6.numpy())
    if salt and m > 1:
        # a NaN in pending gives scale 1 and a NaN payload entry there, not
        # a clipped -127*scale; an inf row's scale is inf and its payload NaN
        assert float(scale[0]) == 1.0
        assert np.isnan(float(payload[0].reshape(-1)[3]))
        assert torch.isnan(payload[1]).all()


# -------------------------------------------------------- the staged route
@pytest.fixture(scope="module")
def linreg():
    j = j_paper.make_linear_regression(m=M, n_per=30, d=20, seed=0)
    p = paper_tasks.make_linear_regression(m=M, n_per=30, d=20, seed=0,
                                           device="cpu")
    return j, p


def _jax_run(j, o, iters):
    return jax.tree_util.tree_map(np.asarray,
                                  j_simulator.run(o, j.task, iters))


def _tensors(x):
    """Every tensor of a tree whose nodes may be named tuples."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _tensors(x[k])]
    return [t for v in x for t in _tensors(v)]


def _same_history(a, b):
    for f in ("objective", "comm_cum", "mask", "agg_grad_sqnorm"):
        x, y = getattr(a, f), getattr(b, f)
        assert torch.equal(x, y), f
    xs = _tensors((a.final_params, a.final_state))
    ys = _tensors((b.final_params, b.final_state))
    assert len(xs) == len(ys) > 5
    for x, y in zip(xs, ys):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _matches_jax(ph, jh, uploads):
    np.testing.assert_array_equal(ph.mask.numpy(), jh.mask)
    np.testing.assert_array_equal(ph.comm_cum.numpy(), jh.comm_cum)
    pc, jc = ph.final_state.comm, jh.final_state.comm
    for f in ("uplink_count", "uplink_mib", "uplink_rem", "downlink_count",
              "iterations"):
        np.testing.assert_array_equal(getattr(pc, f).numpy(),
                                      getattr(jc, f))
    np.testing.assert_allclose(ph.objective.numpy(), jh.objective,
                               rtol=1e-9)
    for x, y in zip(tree.tree_leaves(ph.final_params),
                    jax.tree_util.tree_leaves(jh.final_params)):
        np.testing.assert_allclose(x.numpy(), y, rtol=1e-9, atol=1e-12)
    assert int(ph.comm_cum[-1]) == int(ph.mask.sum()) == uploads


@pytest.mark.parametrize("kw", [{}, {"quantize": "int8"}],
                         ids=["dense", "int8"])
def test_staged_route_matches_jax_and_the_fused_route(linreg, kw):
    j, p = linreg
    jh = _jax_run(j, j_opt.make("chb", j.alpha_paper, M, **kw), 60)
    for dtype in (torch.float64, torch.float32):
        task = simulator.task_to(p.task, dtype=dtype)
        o = opt.make("chb", p.alpha_paper, M, backend="cuda", **kw)
        assert fused_step.fusion_enabled()
        with fused_step.force_staged():
            assert not fused_step.fusion_enabled()
            staged = simulator.run(o, task, 60, device="cpu")
        assert fused_step.fusion_enabled()
        fused = simulator.run(o, task, 60, device="cpu")
        _same_history(staged, fused)
        if dtype == torch.float64:
            _matches_jax(staged, jh, STAGED_UPLOADS)


def test_force_staged_restores_the_flag_on_error():
    with pytest.raises(RuntimeError):
        with fused_step.force_staged():
            raise RuntimeError
    assert fused_step.fusion_enabled()


# -------------------------------------------------------------- shard_step
SHAPES = {"w1": (6, 10), "b1": (10,), "w2": (10, 3)}
EPS1 = 2.0
ALPHA = 0.05
PARTICIPATE = np.array([1.0, 0.0, 1.0, 1.0, 1.0], np.float32)
CHANNEL = np.array([1.0, 1.0, 0.0, 1.0, 1.0], np.float32)
SHARD_IDS = np.array([3, 4])


def _tree_params(step, dtype):
    """theta^k: a base point plus a small per-step move, so ||step||^2 is
    about 2 and eq. (8) censors some workers."""
    base = np.random.default_rng(0)
    rng = np.random.default_rng(50 + step)
    return {k: (base.standard_normal(s)
                + 0.1 * rng.standard_normal(s)).astype(dtype)
            for k, s in SHAPES.items()}


def _tree_grads(step, dtype, m):
    rng = np.random.default_rng(100 + step)
    scale = 0.5 ** np.arange(M)
    return {k: (rng.standard_normal((M,) + s)
                * scale.reshape((M,) + (1,) * len(s))).astype(dtype)[:m]
            for k, s in SHAPES.items()}


def _censors(pkg):
    return {"never": pkg.NeverCensor(), "eq8": pkg.Eq8Censor(EPS1),
            "adaptive": pkg.AdaptiveCensor(ADAPTIVE)}


def _check_margin(name, dsq, ssq, censor_state):
    dsq = np.asarray(dsq, np.float64)
    if name == "eq8":
        thr = EPS1 * float(ssq)
    elif name == "adaptive":
        thr = ADAPTIVE * np.asarray(censor_state, np.float64)
    else:
        return
    live = np.broadcast_to(thr, dsq.shape) > 0
    margin = np.abs(dsq - thr)[live] / np.broadcast_to(thr, dsq.shape)[live]
    assert margin.size == 0 or margin.min() > 1e-3, \
        "test data put a decision on a tie"


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("kw", [{}, {"quantize": "int8"}],
                         ids=["dense", "int8"])
@pytest.mark.parametrize("censor_kind", ["never", "eq8", "adaptive"])
@pytest.mark.parametrize("shard", [False, True],
                         ids=["population", "shard-of-2"])
def test_shard_step_matches_jax(censor_kind, kw, dtype, backend, shard):
    m = 2 if shard else M
    rows = slice(0, m)
    gates = {"participate": PARTICIPATE[rows],
             "channel_mask": CHANNEL[rows]}
    j = j_opt.ComposedOptimizer(
        censor=_censors(j_opt)[censor_kind],
        transport=j_opt.make_transport(kw.get("quantize")),
        server=j_opt.HeavyBall(ALPHA, 0.4), num_workers=m)
    o = opt.ComposedOptimizer(
        censor=_censors(opt)[censor_kind],
        transport=opt.make_transport(kw.get("quantize")),
        server=opt.HeavyBall(ALPHA, 0.4), num_workers=m, backend=backend)
    ids = {"worker_ids": SHARD_IDS} if shard else {}
    j_state = j.init(jax.tree_util.tree_map(jnp.asarray,
                                            _tree_params(0, dtype)))
    state = convert.opt_state(jax.tree_util.tree_map(np.asarray, j_state),
                              "cpu")
    eps = np.finfo(dtype).eps
    cut = set()
    for k in range(1, 5):
        params_np, grads_np = _tree_params(k, dtype), _tree_grads(k, dtype, m)
        j_censor_state = np.asarray(j_state.censor) \
            if censor_kind == "adaptive" else None
        j_state, j_partial, j_stats = j.shard_step(
            j_state, jax.tree_util.tree_map(jnp.asarray, params_np),
            jax.tree_util.tree_map(jnp.asarray, grads_np),
            **{n: jnp.asarray(v) for n, v in ids.items()},
            **{n: jnp.asarray(v) for n, v in gates.items()})
        state, partial, stats = o.shard_step(
            state, convert.params(params_np, "cpu"),
            convert.params(grads_np, "cpu"),
            **{n: torch.from_numpy(v) for n, v in ids.items()},
            **{n: torch.from_numpy(v) for n, v in gates.items()})
        _check_margin(censor_kind, j_stats.delta_sq, j_stats.step_sq,
                      j_censor_state)
        for f in ("mask", "attempted", "delivered"):
            np.testing.assert_array_equal(getattr(stats, f).numpy(),
                                          np.asarray(getattr(j_stats, f)))
        if (stats.mask > stats.attempted).any():
            cut.add("participate")
        if (stats.attempted > stats.delivered).any():
            cut.add("channel")
        np.testing.assert_allclose(stats.delta_sq.numpy(),
                                   np.asarray(j_stats.delta_sq), rtol=1e-5)
        np.testing.assert_allclose(stats.step_sq.numpy(),
                                   np.asarray(j_stats.step_sq), rtol=1e-5)
        for f in ("uplink_count", "uplink_mib", "uplink_rem",
                  "downlink_count", "iterations"):
            np.testing.assert_array_equal(
                getattr(state.comm, f).numpy(),
                np.asarray(getattr(j_state.comm, f)))
        for got, want in zip(
                tree.tree_leaves((state.ghat, state.err, state.prev_params)),
                jax.tree_util.tree_leaves((j_state.ghat, j_state.err,
                                           j_state.prev_params))):
            _exact(got, want)
        if censor_kind == "adaptive":
            np.testing.assert_allclose(state.censor.numpy(),
                                       np.asarray(j_state.censor),
                                       rtol=1e-6)
        for key in SHAPES:
            ng = np.asarray(j_state.ghat[key])
            bound = m * eps * np.abs(ng).sum(axis=0)
            assert np.all(np.abs(partial[key].numpy()
                                 - np.asarray(j_partial[key])) <= bound)
    # the gates really cut: a censor pass that did not go on the air, and
    # (over the whole population) an attempt that the channel dropped
    assert cut == ({"participate"} if shard else {"participate", "channel"})
    assert int(state.comm.uplink_count.sum()) > 0


class _ShardAnchor:
    """``shard_step`` + ``apply_server`` as an optimizer ``simulator.run``
    can drive: one shard holding every worker, no gates."""

    def __init__(self, o):
        self.o = o

    def init(self, params):
        return self.o.init(params)

    def step(self, state, params, grads):
        new_state, partial, st = self.o.shard_step(state, params, grads)
        new_params = self.o.apply_server(params, state.prev_params, partial)
        return new_state, new_params, opt.StepStats(
            mask=st.mask, delta_sq=st.delta_sq, step_sq=st.step_sq,
            agg_grad_sqnorm=tree_sqnorm(partial))


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("kw", [{}, {"quantize": "int8"}],
                         ids=["dense", "int8"])
def test_sync_anchor_shard_step_is_step(linreg, kw, dtype, backend):
    _, p = linreg
    task = simulator.task_to(p.task, dtype=dtype)
    o = opt.make("chb", p.alpha_paper, M, backend=backend, **kw)
    anchored = simulator.run(_ShardAnchor(o), task, 60, device="cpu")
    stepped = simulator.run(o, task, 60, device="cpu")
    _same_history(anchored, stepped)
    assert 0 < int(stepped.comm_cum[-1]) < 60 * M


# -------------------------------------------------------------- per_tensor
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_per_tensor_on_linreg_matches_jax(linreg, backend):
    j, p = linreg
    jh = _jax_run(j, j_opt.make("chb", j.alpha_paper, M,
                                granularity="per_tensor"), 80)
    ph = simulator.run(opt.make("chb", p.alpha_paper, M, backend=backend,
                                granularity="per_tensor"),
                       p.task, 80, device="cpu")
    _matches_jax(ph, jh, PER_TENSOR_UPLOADS)
    assert ph.final_state.comm.uplink_bytes_exact() == \
        PER_TENSOR_UPLOADS * 20 * 8


TREE = {"w1": (6, 10), "b1": (10,), "w2": (2, 3, 4)}
M_TREE = 6


def _tree_tasks(dtype):
    """The edge quadratics ``0.5*a_m*||theta - c_m||^2`` over a three-leaf
    tree of different shapes, for both packages from one numpy draw."""
    rng = np.random.default_rng(4)
    a = np.exp(rng.uniform(0.0, np.log(3.0), size=(M_TREE,))).astype(dtype)
    c = {k: rng.normal(size=(M_TREE,) + s).astype(dtype)
         for k, s in TREE.items()}

    def j_grad(theta, data):                 # one worker's slice
        am, cm = data
        return {k: am * (x - cm[k]) for k, x in theta.items()}

    def j_loss(theta, data):
        am, cm = data
        return sum(0.5 * am * jnp.sum((x - cm[k]) ** 2)
                   for k, x in theta.items())

    def p_grad(theta, data):                 # all workers at once
        am, cm = data
        return {k: am.reshape((-1,) + (1,) * x.dim()) * (x - cm[k])
                for k, x in theta.items()}

    def p_loss(theta, data):
        am, cm = data
        return sum(0.5 * am * torch.sum((x - cm[k]).reshape(M_TREE, -1) ** 2,
                                        dim=1)
                   for k, x in theta.items())

    init = {k: np.zeros(s, dtype) for k, s in TREE.items()}
    jt = JFedTask(init_params={k: jnp.asarray(v) for k, v in init.items()},
                  grad_fn=j_grad, loss_fn=j_loss,
                  worker_data=(jnp.asarray(a),
                               {k: jnp.asarray(v) for k, v in c.items()}))
    pt = simulator.FedTask(
        init_params={k: torch.from_numpy(v) for k, v in init.items()},
        grad_fn=p_grad, loss_fn=p_loss,
        worker_data=(torch.from_numpy(a),
                     {k: torch.from_numpy(v) for k, v in c.items()}))
    return jt, pt


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_per_tensor_on_a_three_leaf_tree_matches_jax(backend):
    jt, pt = _tree_tasks(np.float64)
    kw = {"eps1": 5.0, "granularity": "per_tensor"}
    alpha = 0.1 / M_TREE
    jh = jax.tree_util.tree_map(np.asarray, j_simulator.run(
        j_opt.make("chb", alpha, M_TREE, **kw), jt, 40))
    ph = simulator.run(opt.make("chb", alpha, M_TREE, backend=backend, **kw),
                       pt, 40, device="cpu")
    sent = int(ph.comm_cum[-1])
    _matches_jax(ph, jh, sent)
    # some worker-iterations ship only some of their tensors
    assert 0 < sent < 40 * M_TREE
    leaf_bytes = {k: int(np.prod(s)) * 8 for k, s in TREE.items()}
    assert ph.final_state.comm.uplink_bytes_exact() \
        < sent * sum(leaf_bytes.values())
    assert ph.final_state.comm.uplink_bytes_exact() % 8 == 0


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("name,kw", [("chb", {"eps1": 0.0}), ("hb", {}),
                                     ("chb", {"quantize": "int8",
                                              "eps1": 0.0})],
                         ids=["eps1-0", "never", "int8-eps1-0"])
def test_per_tensor_degenerates_to_global(linreg, name, kw, backend):
    _, p = linreg
    runs = [simulator.run(opt.make(name, p.alpha_paper, M, backend=backend,
                                   granularity=g, **kw), p.task, 30,
                          device="cpu")
            for g in ("per_tensor", "global")]
    _same_history(*runs)


def test_per_tensor_raises_for_stateful_transports_and_sharding():
    o = opt.make("chb", ALPHA, M, quantize="int8", eps1=EPS1,
                 granularity="per_tensor")
    params = convert.params(_tree_params(0, np.float32), "cpu")
    grads = convert.params(_tree_grads(0, np.float32, M), "cpu")
    with pytest.raises(NotImplementedError, match="stateful transport"):
        o.step(o.init(params), params, grads)
    o = opt.make("chb", ALPHA, M, eps1=EPS1, granularity="per_tensor")
    with pytest.raises(NotImplementedError, match="global granularity"):
        o.shard_step(o.init(params), params, grads)
    o = opt.make("chb", ALPHA, M, eps1=torch.tensor(EPS1),
                 granularity="per_tensor")
    with pytest.raises(NotImplementedError, match="host-scalar eps1"):
        o.step(o.init(params), params, grads)


# --------------------------------------------------------- adaptive censor
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_adaptive_censor_on_linreg_matches_jax(linreg, backend):
    j, p = linreg
    jh = _jax_run(j, j_opt.ComposedOptimizer(
        censor=j_opt.AdaptiveCensor(ADAPTIVE),
        transport=j_opt.DenseTransport(),
        server=j_opt.HeavyBall(j.alpha_paper, 0.4), num_workers=M), 80)
    ph = simulator.run(opt.ComposedOptimizer(
        censor=opt.AdaptiveCensor(ADAPTIVE), transport=opt.DenseTransport(),
        server=opt.HeavyBall(p.alpha_paper, 0.4), num_workers=M,
        backend=backend), p.task, 80, device="cpu")
    _matches_jax(ph, jh, ADAPTIVE_UPLOADS)
    np.testing.assert_allclose(ph.final_state.censor.numpy(),
                               jh.final_state.censor, rtol=1e-6)


def test_adaptive_censor_state_follows_the_device_rule(monkeypatch):
    c = opt.AdaptiveCensor(ADAPTIVE)
    assert c.init(3, "cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        c.init(3)


# ---------------------------------------------------------------- registry
def test_jax_specs_with_per_tensor_and_adaptive_load():
    j = j_opt.make("chb", 0.1, M, granularity="per_tensor", backend="pallas")
    spec = json.loads(json.dumps(j_opt.to_spec(j)))
    o = opt.from_spec(spec)
    assert o == opt.make("chb", 0.1, M, granularity="per_tensor",
                         backend="cuda")
    assert opt.to_spec(o) == dict(spec, backend="cuda")
    j = j_opt.ComposedOptimizer(censor=j_opt.AdaptiveCensor(1.5, 0.8),
                                transport=j_opt.Int8Transport(),
                                server=j_opt.HeavyBall(0.1, 0.4),
                                num_workers=M)
    spec = json.loads(json.dumps(j_opt.to_spec(j)))
    o = opt.from_spec(spec)
    assert o.censor == opt.AdaptiveCensor(1.5, 0.8)
    assert opt.to_spec(o) == spec and opt.from_spec(opt.to_spec(o)) == o
    with pytest.raises(ValueError, match="unknown granularity"):
        opt.from_spec(dict(spec, granularity="per_leaf"))
