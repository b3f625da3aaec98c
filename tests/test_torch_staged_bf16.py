"""bf16 banks off the fused route, on the CPU: the staged kernels B3
(``hb_update``), B4 (``censor_bank_advance``), B8 (``sqnorm_batched``), B9
(``bank_advance``) and the worker fold (``fold_workers``) in bf16 and
f32-on-bf16, and the routes that run them (``force_staged()`` dense,
``shard_step``, ``per_tensor``, ``fed.run_edge``, ``sweep.run_fed_sweep``,
``fed.run_mesh``), held against the JAX package.

Pairs (operand P, bank H): (bf16, bf16) and (f32, bf16): B4's g, B9's
payload and B3's theta in P, ghat and B3's worker sum in H; B8 and the
fold take one dtype. The port's ``cuda`` backend runs here on CPU tensors,
so its wrappers run their plain versions (no launch is counted).

Tolerances and why:
  * the plain versions against the JAX package's eager ``kernels/ref.py``
    (each bf16 op rounded, as PyTorch's): B3, B4 and B9 bit for bit, NaN
    where NaN, -0.0 included; B8 within rel 1e-5 (both sum f32 squares,
    in other orders); the fold against ``jnp.sum(axis=0)`` as values (XLA
    sums from +0.0, so a column of -0.0 gives +0.0 there, where the port's
    fold, as its fused kernels, keeps -0.0);
  * against the interpreted Pallas kernels: B4 and B9 bit for bit (a 0/1
    mask factor leaves one rounding that matters, the same in both); B8
    within rel 1e-5; B3 within 4 u32 (2^-24) of eq. (4)'s terms |t| +
    alpha |nabla| + beta |t - p| (XLA contracts its products and sums into
    FMAs, two roundings each at most) plus, for bf16 params, one bf16
    rounding (2^-8) of each side's result;
  * one step from one state, through the port's ``reference`` and
    ``cuda`` backends and JAX's ``reference`` (eager) and ``pallas``
    (interpreted) ones: masks, gates and counters exact (every eq.-(8)
    decision clears its threshold by more than 1e-3); ghat' and the worker
    sum bit for bit on all four; theta bit for bit on the port's two
    backends and JAX's reference for f32 params (eq. (4) in f32
    everywhere), and within the B3 bound above against JAX's pallas; for
    bf16 params the ``reference`` backends round each op of eq. (4) to
    bf16 and the kernels run it in f32, so the ``cuda`` theta lies within
    EQ4_UNITS bf16 roundings of the terms of the reference's and the
    reference backends agree bit for bit;
  * the runtimes (JAX's jitted): masks, counters and bytes exact; theta
    within EQ4_UNITS bf16 roundings of eq. (4)'s terms for bf16 params and
    4 u32 for f32 params; objectives within 2^-7 relative (bf16 losses).
    Whole bf16 runs part from JAX's at about iteration 8 (ROADMAP.md C),
    so the runtimes are held over two rounds.
"""
import jax

jax.config.update("jax_enable_x64", True)

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import fed as j_fed
from repro import opt as j_opt
from repro import sweep as j_sweep
from repro.data import edge_tasks as j_edge
from repro.fed.mesh import MeshScenario as JMeshScenario
from repro.fed.mesh import run_mesh as j_run_mesh
from repro.kernels import censor as j_censor
from repro.kernels import fused_step as j_fused
from repro.kernels import hb_update as j_hb
from repro.kernels import ref as j_ref
from repro_torch import fed, opt, sweep
from repro_torch.data import edge_tasks
from repro_torch.kernels import (build, censor, common, fused_step,
                                 hb_update, ref)
from repro_torch.launch.mesh import make_client_mesh

BF16, F32, F64, F16 = torch.bfloat16, torch.float32, torch.float64, \
    torch.float16
#: (operand dtype P, bank dtype H)
PAIRS = {"bf16": (BF16, BF16), "f32_bf16": (F32, BF16)}
LEAVES = [(1, (20,)), (4, (3, 50)), (9, (300, 129))]
ALPHA, BETA, EPS1 = 0.05, 0.4, 0.5
U32, U_BF16 = 2.0 ** -24, 2.0 ** -8
#: bf16 roundings of eq. (4)'s terms between a theta' computed in f32 and
#: rounded once and one whose five operations each round to bf16 (and
#: alpha, beta too): seven, and one more for the f32 side's own rounding
EQ4_UNITS = 8
_J = {BF16: jnp.bfloat16, F32: jnp.float32, F64: jnp.float64}
_INT = {BF16: torch.int16, F32: torch.int32, F64: torch.int64}


@pytest.fixture(autouse=True)
def _zero_launches():
    common.reset_launches()
    yield
    assert common.LAUNCHES == {k: 0 for k in common.KERNELS}, \
        "a CPU tensor reached a kernel launch"


def _j(t: torch.Tensor):
    """A tensor as a JAX array of its dtype (bf16 through f32, exactly)."""
    if not t.is_floating_point():
        return jnp.asarray(t.numpy())
    if t.dtype == BF16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(x).astype(np.float64)


def _exact(got: torch.Tensor, want) -> None:
    """The same dtype and bits, NaN where NaN (any NaN equals any NaN);
    ``want`` a tensor or a JAX array."""
    if isinstance(want, torch.Tensor):
        assert want.dtype == got.dtype
        want = np.asarray(_j(want))
    assert want.dtype == np.dtype(_J[got.dtype]), (want.dtype, got.dtype)
    assert tuple(got.shape) == want.shape
    nan = np.isnan(want.astype(np.float64))
    np.testing.assert_array_equal(torch.isnan(got).numpy(), nan)
    gb = got.contiguous().view(_INT[got.dtype]).numpy()
    wb = want.view({2: np.int16, 4: np.int32, 8: np.int64}[want.itemsize])
    np.testing.assert_array_equal(gb[~nan], wb[~nan])


def _inputs(m, shape, p_dt, seed=0):
    """g and theta, theta_prev in P, ghat in bf16, the (M,) f32 mask, from
    one numpy seed: -0.0 on every 7th (g) and 11th (ghat) column, one
    worker's g equal to its ghat, and (M > 2) NaN and +-inf in g's second
    and third rows and +inf in ghat's second."""
    rng = np.random.default_rng(seed + 17 * m + len(shape))
    g, h = (rng.standard_normal((m,) + shape).astype(np.float32)
            for _ in range(2))
    t, p = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    g.reshape(m, -1)[:, ::7] = -0.0
    h.reshape(m, -1)[:, ::11] = -0.0
    if m > 1:
        g[-1] = h[-1]
    if m > 2:
        g.reshape(m, -1)[1, 2] = np.nan
        g.reshape(m, -1)[2, 3] = -np.inf
        g.reshape(m, -1)[2, 0] = np.inf
        h.reshape(m, -1)[1, 4] = np.inf
    mask = np.array([1.0, 0.0, 1.0, 1.0, 0.0, 1.0, 1.0, 0.0, 1.0][:m],
                    np.float32)
    tt = lambda x, dt: torch.from_numpy(x).to(dt)   # noqa: E731
    return (tt(g, p_dt), tt(h, BF16), tt(t, p_dt), tt(p, p_dt),
            torch.from_numpy(mask))


def _eq4_terms(t, p, agg) -> np.ndarray:
    tt = _f64(t)
    return np.abs(tt) + ALPHA * np.abs(_f64(agg)) + BETA * np.abs(tt - _f64(p))


def _b3_bound(t, p, agg, got, want) -> np.ndarray:
    """|B3's plain version - the interpreted kernel|: 4 u32 of the terms,
    and for bf16 params one bf16 rounding of each result."""
    bound = 4 * U32 * _eq4_terms(t, p, agg)
    if t.dtype == BF16:
        bound = bound + U_BF16 * (np.abs(_f64(got)) + np.abs(_f64(want)))
    return bound


def _within(got, want, bound) -> None:
    a, b = _f64(got), _f64(want)
    nan = np.isnan(b)
    np.testing.assert_array_equal(np.isnan(a), nan)
    same = a[~nan] == b[~nan]           # infinities of one sign included
    assert np.all(same | (np.abs(a[~nan] - b[~nan])
                          <= np.broadcast_to(bound, a.shape)[~nan]))


# ----------------------------------------- plain versions against JAX
@pytest.mark.parametrize("m,shape", LEAVES)
@pytest.mark.parametrize("pair", list(PAIRS))
def test_plain_versions_equal_the_eager_oracles(pair, m, shape):
    p_dt, _ = PAIRS[pair]
    g, h, t, p, mask = _inputs(m, shape, p_dt)
    gj, hj, tj, pj, mj = map(_j, (g, h, t, p, mask))
    out = ref.censor_bank_advance(g, h, mask)
    assert out.dtype == BF16
    _exact(out, j_ref.censor_bank_advance(gj, hj, mj))
    _exact(ref.bank_advance(h, g, mask), j_ref.bank_advance(hj, gj, mj))
    nab = h[0]
    out = ref.hb_update(t, nab, p, ALPHA, BETA)
    assert out.dtype == p_dt
    _exact(out, j_ref.hb_update(tj, _j(nab), pj, ALPHA, BETA))
    pend = g.to(BF16) - h
    want = np.asarray(j_ref.sqnorm_batched(_j(pend)))
    got = ref.sqnorm_batched(pend)
    assert got.dtype == F32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    fold = ref.fold_workers(h)
    assert fold.dtype == BF16
    want = np.asarray(jnp.sum(hj, axis=0)).astype(np.float64)
    np.testing.assert_array_equal(_f64(fold), want)


@pytest.mark.parametrize("m,shape", LEAVES)
@pytest.mark.parametrize("pair", list(PAIRS))
def test_plain_versions_against_interpreted_kernels(pair, m, shape):
    p_dt, _ = PAIRS[pair]
    g, h, t, p, mask = _inputs(m, shape, p_dt, seed=1)
    gj, hj, tj, pj, mj = map(_j, (g, h, t, p, mask))
    _exact(ref.censor_bank_advance(g, h, mask),
           j_censor.censor_bank_advance(gj, hj, mj, interpret=True))
    _exact(ref.bank_advance(h, g, mask),
           j_censor.bank_advance(hj, gj, mj, interpret=True))
    nab = h[-1]
    got = ref.hb_update(t, nab, p, ALPHA, BETA)
    want = j_hb.hb_update(tj, _j(nab), pj, ALPHA, BETA, interpret=True)
    assert np.asarray(want).dtype == np.dtype(_J[p_dt])
    _within(got, want, _b3_bound(t, p, nab, got, want))
    pend = g.to(BF16) - h
    want = np.asarray(j_censor.sqnorm_batched(_j(pend), interpret=True))
    np.testing.assert_allclose(ref.sqnorm_batched(pend).numpy(), want,
                               rtol=1e-5)


# ------------------------------------------------ the wrappers' contract
@pytest.mark.parametrize("pair", list(PAIRS))
def test_wrappers_take_the_staged_pairs(pair):
    """On CPU tensors the wrappers run the plain versions, in the JAX
    kernels' out dtypes: ghat' and the fold in the bank dtype, theta' in
    the params', the sqnorms f32; empty leaves keep them too."""
    p_dt, _ = PAIRS[pair]
    g, h, t, p, mask = _inputs(4, (3, 50), p_dt, seed=2)
    pairs = ((censor.censor_bank_advance(g, h, mask),
              ref.censor_bank_advance(g, h, mask)),
             (censor.bank_advance(h, g, mask),
              ref.bank_advance(h, g, mask)),
             (hb_update.hb_update(t, h[1], p, ALPHA, BETA),
              ref.hb_update(t, h[1], p, ALPHA, BETA)),
             (censor.sqnorm_batched(h), ref.sqnorm_batched(h)),
             (fused_step.fold_workers(h), ref.fold_workers(h)))
    for got, want in pairs:
        assert got.dtype == want.dtype
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(got.nan_to_num(), want.nan_to_num())
    assert [x[0].dtype for x in pairs] == [BF16, BF16, p_dt, F32, BF16]
    g0, h0 = torch.empty((4, 0), dtype=p_dt), torch.empty((4, 0),
                                                           dtype=BF16)
    t0 = torch.empty((0,), dtype=p_dt)
    assert censor.censor_bank_advance(g0, h0, mask).dtype == BF16
    assert censor.bank_advance(h0, g0, mask).dtype == BF16
    assert hb_update.hb_update(t0, h0[0], t0, ALPHA, BETA).dtype == p_dt
    assert censor.sqnorm_batched(h0).dtype == F32
    assert fused_step.fold_workers(h0).dtype == BF16


#: (operand dtype, bank dtype) that stay refused, and the words each
#: refusal keeps
REFUSED = {"f16": (F16, F16), "f64_bf16": (F64, BF16),
           "bf16_f32": (BF16, F32), "f32_f16": (F32, F16)}


@pytest.mark.parametrize("case", list(REFUSED))
def test_other_pairs_are_refused_before_any_launch(case):
    p_dt, h_dt = REFUSED[case]
    g, h, t, p, mask = _inputs(2, (8,), F32)
    g, t, p, h = g.to(p_dt), t.to(p_dt), p.to(p_dt), h.to(h_dt)
    for call in (lambda: censor.censor_bank_advance(g, h, mask),
                 lambda: censor.bank_advance(h, g, mask),
                 lambda: hb_update.hb_update(t, h[0], p, ALPHA, BETA)):
        with pytest.raises(TypeError, match="bank dtype") as info:
            call()
        assert "ROADMAP queue B" in str(info.value)
    if h_dt == F16:
        for call in (lambda: censor.sqnorm_batched(h),
                     lambda: fused_step.fold_workers(h)):
            with pytest.raises(TypeError, match="float32 and float64"):
                call()
    x = torch.zeros((2, 3), dtype=torch.int32)
    for call in (lambda: censor.sqnorm_batched(x),
                 lambda: fused_step.fold_workers(x)):
        with pytest.raises(TypeError, match="float32 and float64"):
            call()


def test_dtype_tables():
    """KERNEL_DTYPES stays the f32/f64 table every kernel takes; B8, B7a and
    the fold take STAGED_DTYPES, B3, B4 and B9 FUSED_DTYPES, B7b, B10 and
    B11 EF_DTYPES (a bf16 pending leaf with err, and B11's payload, in
    bf16 or f32)."""
    assert set(common.KERNEL_DTYPES) == {F32, F64}
    assert set(common.STAGED_DTYPES) == {F32, F64, BF16}
    assert common.fused_suffix("x", (torch.zeros(1),),
                               torch.zeros(1, dtype=BF16)) == "f32_bf16"
    assert set(common.EF_DTYPES) == {"quantize_ef_batched",
                                     "select_pack_ef_batched",
                                     "residual_ef_batched"}
    for table in common.EF_DTYPES.values():
        assert {k[0] for k in table} == set(common.STAGED_DTYPES)
        assert {k for k in table if k[0] != BF16} == {
            (d,) * len(k) for k in table for d in common.KERNEL_DTYPES}
    assert common.ef_suffix("residual_ef_batched", *(
        torch.zeros(1, 2, dtype=d) for d in (BF16, F32, BF16))) \
        == "bf16_f32_bf16"
    assert common.EF_DTYPES["quantize_ef_batched"][(BF16, F32)] == "bf16_f32"


H100_SMS = 132
#: (M, n) of the picker's sides: the wide two-pass/one-pass shapes, and
#: tall banks of short rows on each side of the worker threshold
SHAPES = [(4, 4099), (9, 33), (1000, 16), (2000, 16), (100_000, 16)]


@pytest.fixture
def on_h100(monkeypatch):
    """The wrappers past the dispatch rule as on an H100: meta tensors count
    as on the card, and each ``launch`` is recorded, not run."""
    calls = []
    for mod in (censor, fused_step, hb_update):
        monkeypatch.setattr(mod, "on_card", lambda name, *ts: True)
        if hasattr(mod, "sm_count"):
            monkeypatch.setattr(mod, "sm_count", lambda index: H100_SMS)
        monkeypatch.setattr(mod, "launch", lambda lib, fn, dev, *args:
                            calls.append((lib, fn, len(args))))
    common.reset_launches()
    yield calls
    common.reset_launches()


def _c_arity(lib: str, fn: str) -> int:
    src = (build.CSRC / f"{lib}.cu").read_text()
    found = re.search(rf"\bint {fn}\(([^)]*)\)", src)
    assert found, f"{fn} is not defined in {lib}.cu"
    return len(found.group(1).split(","))


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("m,n", SHAPES)
def test_each_wrapper_launches_its_bf16_launcher(on_h100, m, n, pair):
    """On meta tensors: each wrapper calls the launcher of its dtype pair
    and of the design ``common.sqnorm_path`` / ``fold_path`` picks (B8, the
    fold; B3, B4 and B9 have one), bound in ``build.SIGNATURES`` with the C
    definition's arity, one count a call."""
    p_dt, h_dt = PAIRS[pair]
    g, h, mask = _meta((m, n), p_dt), _meta((m, n), h_dt), _meta((m,), F32)
    t = _meta((n,), p_dt)
    sq = common.sqnorm_path(m, n, H100_SMS)
    fold = common.fold_path(m, n, H100_SMS)
    calls = [
        (lambda: censor.censor_bank_advance(g, h, mask), "censor",
         "censor_bank_advance", f"censor_bank_advance_{pair}", BF16),
        (lambda: censor.bank_advance(h, g, mask), "censor", "bank_advance",
         f"bank_advance_{pair}", BF16),
        (lambda: hb_update.hb_update(t, h[0], t, ALPHA, BETA), "hb_update",
         "hb_update", f"hb_update_{pair}", p_dt),
        (lambda: censor.sqnorm_batched(h), "censor", "sqnorm_batched",
         f"sqnorm_batched{'_warp' if sq == 'warp' else ''}_bf16", F32),
        (lambda: fused_step.fold_workers(h), "fused_step", "fold_workers",
         f"fold_workers{'_tall' if fold == 'tall' else ''}_bf16", BF16)]
    for call, lib, base, fn, out_dt in calls:
        on_h100.clear()
        common.reset_launches()
        assert call().dtype == out_dt
        assert on_h100 == [(lib, fn, len(build.SIGNATURES[lib][fn]) - 2)]
        assert len(build.SIGNATURES[lib][fn]) == _c_arity(lib, fn)
        assert common.LAUNCHES[base] == 1
        assert sum(common.LAUNCHES.values()) == 1


@pytest.mark.parametrize("design", ["two_pass", "warp", "one_pass", "tall"])
def test_each_design_has_its_bf16_launcher(on_h100, design):
    """The designs a caller names (the card's checks call both) reach
    their bf16 launchers; an unknown design raises before any launch."""
    x = _meta((2000, 16), BF16)
    if design in fused_step.FOLD_PATHS:
        fused_step.fold_on_card(x, design)
        fn = "fold_workers" + ("_tall" if design == "tall" else "") + "_bf16"
    else:
        censor.sqnorm_on_card(x, design)
        fn = "sqnorm_batched" + ("_warp" if design == "warp" else "") \
            + "_bf16"
    assert [c[1] for c in on_h100] == [fn]
    with pytest.raises(ValueError, match="path must be one of"):
        fused_step.fold_on_card(x, "chunked")
    with pytest.raises(ValueError, match="path must be one of"):
        censor.sqnorm_on_card(x, "chunked")
    assert len(on_h100) == 1


# --------------------------------------- one step against the JAX package
SHAPES_TREE = {"w": (3, 40), "b": (17,)}
M = 5


def _tree_inputs(p_dt, seed=0):
    """theta^k, theta^{k-1}, ghat (bf16) and the (M, ...) gradients as numpy
    f32 draws, cast to their dtypes; the bank sits near the gradients so
    that eq. (8) censors some workers."""
    rng = np.random.default_rng(seed)
    mk = lambda s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    theta = {k: mk(s) for k, s in SHAPES_TREE.items()}
    prev = {k: v + 0.3 * mk(v.shape) for k, v in theta.items()}
    scale = (0.5 ** np.arange(M)).astype(np.float32)
    grads = {k: mk((M,) + s) for k, s in SHAPES_TREE.items()}
    ghat = {k: g + scale.reshape((M,) + (1,) * len(s)) * mk(g.shape)
            for (k, s), g in zip(SHAPES_TREE.items(), grads.values())}
    cast = lambda tree, dt: {k: torch.from_numpy(v).to(dt)   # noqa: E731
                             for k, v in tree.items()}
    return (cast(theta, p_dt), cast(prev, p_dt), cast(ghat, BF16),
            cast(grads, p_dt))


def _optimizers(p_dt, granularity="global"):
    """The port's two backends and JAX's two, chb with an eq.-(8) censor,
    on a bf16 bank."""
    bank = {} if p_dt == BF16 else {"bank_dtype": BF16}
    jbank = {} if p_dt == BF16 else {"bank_dtype": jnp.bfloat16}
    port = {b: opt.make("chb", ALPHA, M, eps1=EPS1, beta=BETA,
                        granularity=granularity, backend=b, **bank)
            for b in ("reference", "cuda")}
    jax_ = {b: j_opt.make("chb", ALPHA, M, eps1=EPS1, beta=BETA,
                          granularity=granularity, backend=b, **jbank)
            for b in ("reference", "pallas")}
    return port, jax_


def _states(port, jax_, theta, prev, ghat):
    """One state in each package: the optimizers' init, with theta^{k-1}
    and the bank replaced."""
    sp = port["reference"].init(theta)._replace(prev_params=prev, ghat=ghat)
    js = jax_["reference"].init({k: _j(v) for k, v in theta.items()})
    js = js._replace(prev_params={k: _j(v) for k, v in prev.items()},
                     ghat={k: _j(v) for k, v in ghat.items()})
    return sp, js


def _margin(dsq, ssq, eps1=EPS1) -> float:
    thr = eps1 * np.asarray(ssq, np.float64)
    dsq = np.asarray(dsq, np.float64)
    return float((np.abs(dsq - thr) / thr).min())


def _check_theta(p_dt, got, ref_theta, prev_k, agg, *, exact_ref):
    """theta' of the cuda backend against a reference backend's: bit for bit
    for f32 params (eq. (4) in f32 on both), within EQ4_UNITS bf16
    roundings of eq. (4)'s terms for bf16 params."""
    for k in SHAPES_TREE:
        if p_dt == F32 and exact_ref:
            _exact(got[k], np.asarray(ref_theta[k]))
            continue
        t = prev_k[k]
        bound = EQ4_UNITS * U_BF16 * _eq4_terms(t[0], t[1], agg[k])
        _within(got[k], ref_theta[k], bound)


def _run_step(route, o, state, theta, grads, gates, kernels):
    """One step of ``route`` (either package: ``kernels`` is its kernel
    module with ``force_staged``): ``(state', theta', stats)``."""
    if route == "staged":
        with kernels.force_staged():
            return o.step(state, theta, grads)
    if route == "shard":
        new_state, partial, st = o.shard_step(state, theta, grads, **gates)
        return new_state, o.apply_server(theta, state.prev_params,
                                         partial), st
    return o.step(state, theta, grads)


PARTICIPATE = np.array([1.0, 1.0, 0.0, 1.0, 1.0], np.float32)
CHANNEL = np.array([1.0, 0.0, 1.0, 1.0, 1.0], np.float32)
ROUTES = [(r, p) for r in ("staged", "shard", "per_tensor")
          for p in PAIRS]


@pytest.mark.parametrize("route,pair", ROUTES,
                         ids=[f"{r}-{p}" for r, p in ROUTES])
def test_one_step_matches_jax(route, pair):
    """``force_staged()`` dense, ``shard_step`` with both gates (then
    ``apply_server``) and ``per_tensor``, one step from one state on the
    four backends (see the module docstring for what is held how)."""
    p_dt, _ = PAIRS[pair]
    port, jax_ = _optimizers(p_dt, "per_tensor" if route == "per_tensor"
                             else "global")
    theta, prev, ghat, grads = _tree_inputs(p_dt, seed=len(route))
    sp, js = _states(port, jax_, theta, prev, ghat)
    gates = ({"participate": torch.from_numpy(PARTICIPATE),
              "channel_mask": torch.from_numpy(CHANNEL)}
             if route == "shard" else None)
    jgates = None if gates is None else {k: _j(v) for k, v in gates.items()}
    out = {b: _run_step(route, o, sp, theta, grads, gates, fused_step)
           for b, o in port.items()}
    jtheta = {k: _j(v) for k, v in theta.items()}
    jgrads = {k: _j(v) for k, v in grads.items()}
    jout = {b: _run_step(route, o, js, jtheta, jgrads, jgates, j_fused)
            for b, o in jax_.items()}
    # every decision clears its threshold
    if route == "per_tensor":
        for k in SHAPES_TREE:
            d = (grads[k].to(BF16) - ghat[k]).float()
            dsq = (d * d).reshape(M, -1).sum(1).double().numpy()
            ssq = float(((theta[k].float() - prev[k].float()) ** 2).sum())
            assert _margin(dsq, ssq) > 1e-3
    else:
        st = out["reference"][2]
        assert _margin(st.delta_sq.numpy(), st.step_sq.numpy()) > 1e-3
    stats = [o[2] for o in out.values()] + [o[2] for o in jout.values()]
    for f in (("mask", "attempted", "delivered") if route == "shard"
              else ("mask",)):
        for s in stats[1:]:
            np.testing.assert_array_equal(np.asarray(getattr(s, f)),
                                          getattr(stats[0], f).numpy())
    assert 0 < float(stats[0].mask.sum()) < M
    states = [o[0] for o in out.values()] + [o[0] for o in jout.values()]
    for s in states[1:]:
        for f in ("uplink_count", "uplink_mib", "uplink_rem",
                  "downlink_count", "iterations"):
            np.testing.assert_array_equal(
                np.asarray(getattr(s.comm, f)),
                getattr(states[0].comm, f).numpy(), err_msg=f)
        for k in SHAPES_TREE:
            _exact(states[0].ghat[k], s.ghat[k])
    assert states[1].ghat["w"].dtype == BF16
    for k in SHAPES_TREE:
        _exact(out["reference"][1][k], np.asarray(jout["reference"][1][k]))
    agg = {k: ref.fold_workers(v) for k, v in states[0].ghat.items()}
    pk = {k: (theta[k], prev[k]) for k in SHAPES_TREE}
    _check_theta(p_dt, out["cuda"][1], out["reference"][1], pk, agg,
                 exact_ref=True)
    if p_dt == F32:
        for k in SHAPES_TREE:
            _exact(out["cuda"][1][k], np.asarray(jout["reference"][1][k]))
    for k in SHAPES_TREE:
        want = jout["pallas"][1][k]
        got = out["cuda"][1][k]
        _within(got, want, _b3_bound(theta[k], prev[k], agg[k], got, want))


# ------------------------------------------------------------ the runtimes
D_EDGE, M_EDGE, EPS1_EDGE = 24, 6, 4.0


def _edge_tasks(p_dt):
    jt = j_edge.make_edge_quadratics(m=M_EDGE, d=D_EDGE, seed=0)
    jt = jt._replace(init_params=jt.init_params.astype(_J[p_dt]),
                     worker_data=tuple(x.astype(_J[p_dt])
                                       for x in jt.worker_data))
    pt = edge_tasks.make_edge_quadratics(m=M_EDGE, d=D_EDGE, seed=0,
                                         device="cpu", dtype=p_dt)
    return jt, pt


def _edge_opts(p_dt, jax_backend):
    bank = {} if p_dt == BF16 else {"bank_dtype": BF16}
    jbank = {} if p_dt == BF16 else {"bank_dtype": jnp.bfloat16}
    port = {b: opt.make("chb", 0.5 / M_EDGE, M_EDGE, eps1=EPS1_EDGE,
                        backend=b, **bank) for b in ("reference", "cuda")}
    jo = j_opt.make("chb", 0.5 / M_EDGE, M_EDGE, eps1=EPS1_EDGE,
                    backend=jax_backend, **jbank)
    return port, jo


def _theta_close(p_dt, got, want, theta0) -> None:
    """theta after the runtimes' rounds: EQ4_UNITS bf16 roundings (bf16
    params) or 4 u32 (f32 params) of the largest term of eq. (4)."""
    a, b = _f64(got), _f64(want)
    scale = np.abs(b).max() + np.abs(_f64(theta0)).max()
    unit = EQ4_UNITS * U_BF16 if p_dt == BF16 else 4 * U32
    assert np.abs(a - b).max() <= 2 * unit * scale


@pytest.mark.parametrize("pair", list(PAIRS))
def test_run_edge_rounds_match_jax(pair):
    """``fed.run_edge`` under ``sync_config``, two rounds, both port
    backends against JAX's ``pallas`` (and, for the masks, its
    ``reference``): masks, counters, bytes exact; for f32 params the bank
    and theta of the two port backends bit for bit."""
    p_dt, _ = PAIRS[pair]
    jt, pt = _edge_tasks(p_dt)
    port, jo = _edge_opts(p_dt, "pallas")
    hists = {b: fed.run_edge(o, pt, fed.sync_config(M_EDGE), 2,
                             device="cpu") for b, o in port.items()}
    jh = j_fed.run_edge(jo, jt, j_fed.sync_config(M_EDGE), 2)
    for h in hists.values():
        for f in ("mask", "comm_cum", "bytes_cum"):
            np.testing.assert_array_equal(np.asarray(getattr(h, f)),
                                          np.asarray(getattr(jh, f)),
                                          err_msg=f)
        assert h.stats.as_dict() == jh.stats.as_dict()
        _theta_close(p_dt, h.final_params, jh.final_params, pt.init_params)
        np.testing.assert_allclose(h.objective, np.asarray(jh.objective,
                                                           np.float64),
                                   rtol=2.0 ** -7)
    a, b = (hists[k].final_bank for k in ("cuda", "reference"))
    assert a.dtype == BF16
    if p_dt == F32:     # bf16 params: the backends' theta^1 differ (B3)
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
        assert torch.equal(hists["cuda"].final_params,
                           hists["reference"].final_params)
    assert 0 < int(jh.comm_cum[-1]) < 2 * M_EDGE


def test_run_fed_sweep_rounds_match_jax():
    """``sweep.run_fed_sweep`` on the bf16 task (its bank is the params'
    dtype), two scenarios, two rounds, both port backends against JAX's:
    masks, cohorts and counters exact, objective within 2^-7."""
    jt, pt = _edge_tasks(BF16)
    grid = {"loss_prob": (0.0, 0.3), "participation": (1.0, 0.7)}
    res = {b: sweep.run_fed_sweep(
        opt.make("chb", 0.5 / M_EDGE, M_EDGE, eps1=EPS1_EDGE, backend=b),
        pt, sweep.FedScenarioGrid(**grid), 2, device="cpu")
        for b in ("reference", "cuda")}
    jr = j_sweep.run_fed_sweep(
        j_opt.make("chb", 0.5 / M_EDGE, M_EDGE, eps1=EPS1_EDGE), jt,
        j_sweep.FedScenarioGrid(**grid), 2)
    for r in res.values():
        for f in ("transmit_mask", "delivered_mask", "participate_mask",
                  "quorum_met", "comm_cum", "delivered_cum", "bytes_cum"):
            np.testing.assert_array_equal(getattr(r, f),
                                          np.asarray(getattr(jr, f)),
                                          err_msg=f)
        assert r.objective.dtype == np.float32
        np.testing.assert_allclose(r.objective, np.asarray(
            jr.objective, np.float64), rtol=2.0 ** -7)
    np.testing.assert_array_equal(res["cuda"].objective,
                                  res["reference"].objective)
    assert res["cuda"].comm_cum[:, -1].min() > 0


@pytest.mark.parametrize("pair", list(PAIRS))
def test_run_mesh_rounds_match_jax(pair):
    """``fed.run_mesh`` over one and two CPU shards, the lossy scenario, two
    rounds, both port backends against JAX's over one device: masks,
    cohorts and bytes exact; theta at one shard within the runtimes' bound
    (at two, each shard's partial sum rounds to bf16 before the fold), and
    the two port backends' theta bit for bit for f32 params."""
    p_dt, _ = PAIRS[pair]
    jt, pt = _edge_tasks(p_dt)
    port, jo = _edge_opts(p_dt, "reference")
    sc = (0.8, 0.2, 0.5, 3)
    hists = {(b, k): fed.run_mesh(o, pt, 2,
                                  mesh=make_client_mesh(k, ["cpu"] * k),
                                  scenario=fed.MeshScenario(*sc))
             for b, o in port.items() for k in (1, 2)}
    jh = j_run_mesh(jo, jt, 2, scenario=JMeshScenario(*sc))
    for (b, k), h in hists.items():
        for f in ("mask", "participated", "attempted", "delivered",
                  "quorum_met", "comm_cum", "bytes_cum"):
            np.testing.assert_array_equal(np.asarray(getattr(h, f)),
                                          np.asarray(getattr(jh, f)),
                                          err_msg=f"{b} K={k} {f}")
        if k == 1:
            _theta_close(p_dt, h.final_params, jh.final_params,
                         pt.init_params)
    if p_dt == F32:
        for k in (1, 2):
            assert torch.equal(hists["cuda", k].final_params,
                               hists["reference", k].final_params)
    assert int(np.asarray(jh.comm_cum)[-1]) > 0
