"""bf16 and f32-on-bf16 banks on the fused CHB step (B1, B2, B5, B6), on
the CPU: the port's plain versions (what the wrappers run on CPU tensors)
held against the JAX package's eager ``kernels/ref.py`` oracles and its
Pallas kernels in interpret mode, the wrappers' dtype contract and
dispatch, the repaired worker fold, and whole runs against the JAX
package's.

Dtypes: params P (gradients and theta) and bank H: (bf16, bf16) and (f32,
bf16); err in H, or in P as ``transport.init`` makes it before the first
step ("f32_bf16_f32").

Tolerances and why:
  * the fold (``core.util.sum_leading``) on a bf16 bank: bit for bit
    against ``tree_sum_leading`` (``jnp.sum(axis=0)``, which accumulates
    bf16 in f32 and rounds once); f32 and f64 folds keep their bits;
  * against the eager oracles, which round each bf16 op as PyTorch does:
    ghat', agg, theta', pending, payload, codes, err' and the abs-max bit
    for bit; the sqnorms within rel 1e-5 (both sum f32 squares, in other
    orders);
  * against the interpreted kernels, where XLA keeps a bf16 expression
    unrounded in f32 (``g.astype(bf16) - h``, pending): the sqnorms within
    rel DSQ_RTOL = 2^-7 + 2^-16 + 1e-5, since each delta d is rounded to
    bf16 or not, d(1 + r) with |r| <= 2^-8, so each square moves by at most
    (2^-7 + 2^-16) d^2 and all the terms are positive; B2's agg within
    2^-7 sum_m |ghat'_m| (two roundings to bf16 of f32 sums of one set of
    terms) and theta' within alpha times that plus 2 unit roundoffs of P
    of eq. (4)'s terms; B6 the same plus, per worker, one code step
    (scale_m) where a pending value on a rounding boundary takes the other
    int8 code;
  * runs: masks, ``comm_cum`` and the counters exact where every eq.-(8)
    decision clears its threshold by more than DSQ_RTOL (the run's margin
    is asserted above it). The edge quadratics run under the JAX package's
    ``simulator.run`` whole; the golden linreg is held step by step from
    the port's state against the JAX step that ``simulator.run`` jits,
    since its bank's bf16 roundings compound over the run (whole runs
    part at iteration 8 with every margin above 3.8%).
"""
import jax

jax.config.update("jax_enable_x64", True)

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import opt as j_opt
from repro.core import simulator as j_simulator
from repro.core.util import tree_sum_leading as j_tree_sum_leading
from repro.data import edge_tasks as j_edge
from repro.data import paper_tasks as j_paper
from repro.kernels import censor as j_censor
from repro.kernels import fused_step as j_fused
from repro.kernels import ref as j_ref
from repro_torch import opt
from repro_torch.core import simulator
from repro_torch.core.quantize import int8_scale
from repro_torch.core.util import sum_leading
from repro_torch.data import edge_tasks, paper_tasks
from repro_torch.kernels import build, censor, common, fused_step, ops, ref

BF16, F32, F64 = torch.bfloat16, torch.float32, torch.float64
#: (params P, bank H, err E)
COMBOS = {"bf16": (BF16, BF16, BF16), "f32_bf16": (F32, BF16, BF16),
          "f32_bf16_f32": (F32, BF16, F32)}
LEAVES = [(1, (20,)), (4, (3, 50)), (9, (300, 129))]
ALPHA, BETA = 0.05, 0.4
DSQ_RTOL = 2.0 ** -7 + 2.0 ** -16 + 1e-5
U_BF16 = 2.0 ** -8          # bf16's unit roundoff
_J = {BF16: jnp.bfloat16, F32: jnp.float32, F64: jnp.float64}
_INT = {BF16: torch.int16, F32: torch.int32, F64: torch.int64}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(_INT[t.dtype]).numpy()


def _jbits(x, dtype: torch.dtype) -> np.ndarray:
    """The bits of a JAX array that should hold ``dtype``."""
    x = np.asarray(x)
    assert x.dtype == np.dtype(_J[dtype]), (x.dtype, dtype)
    return x.view({2: np.int16, 4: np.int32, 8: np.int64}[x.itemsize])


def _same(t: torch.Tensor, x) -> bool:
    return np.array_equal(_bits(t), _jbits(x, t.dtype))


def _j(t: torch.Tensor):
    """A tensor as a JAX array of the same dtype (bf16 through f32, exact)."""
    if not t.is_floating_point():
        return jnp.asarray(t.numpy())
    return jnp.asarray(t.to(F32 if t.dtype == BF16 else t.dtype).numpy()
                       ).astype(_J[t.dtype])


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(x).astype(np.float64)


def _inputs(m, shape, combo, seed=0):
    """g, ghat, err, theta, theta_prev in their dtypes and the (M,) f32
    mask, from one numpy seed; -0.0 salted on every 7th (g), 11th (ghat)
    and 5th (err) column, and one worker's pending all zero."""
    p_dt, h_dt, e_dt = combo
    rng = np.random.default_rng(seed + 17 * m + len(shape))
    g, h = (rng.standard_normal((m,) + shape).astype(np.float32)
            for _ in range(2))
    e = (0.01 * rng.standard_normal((m,) + shape)).astype(np.float32)
    t, p = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    g.reshape(m, -1)[:, ::7] = -0.0
    h.reshape(m, -1)[:, ::11] = -0.0
    e.reshape(m, -1)[:, ::5] = -0.0
    if m > 1:
        g[-1] = h[-1]
        e[-1] = 0.0
    mask = np.array([1.0, 0.0, 1.0, 1.0, 0.0, 1.0, 1.0, 0.0, 1.0][:m],
                    np.float32)
    tt = lambda x, dt: torch.from_numpy(x).to(dt)   # noqa: E731
    return (tt(g, p_dt), tt(h, h_dt), tt(e, e_dt), tt(t, p_dt),
            tt(p, p_dt), torch.from_numpy(mask))


# ---------------------------------------------------------------- the fold
@pytest.mark.parametrize("m", [1, 2, 4, 8, 9])
def test_bf16_fold_equals_jax(m):
    """bf16 banks: the f32 left fold rounded once is jnp.sum's bits."""
    rng = np.random.default_rng(m)
    x = torch.from_numpy(rng.standard_normal((m, 4099)).astype(
        np.float32)).to(BF16)
    got = sum_leading(x)
    assert got.dtype == BF16 and got.shape == (4099,)
    assert _same(got, j_tree_sum_leading(_j(x)))
    # the f32 fold, not M - 1 bf16 roundings
    if m > 2:
        acc = x[0].clone()
        for w in range(1, m):
            acc = acc + x[w]
        assert not np.array_equal(_bits(acc), _bits(got))


@pytest.mark.parametrize("dtype", [F32, F64, BF16], ids=["f32", "f64",
                                                         "bf16"])
@pytest.mark.parametrize("m", [1, 2, 5])
def test_fold_keeps_its_bits_and_negative_zero(dtype, m):
    """f32 and f64 fold in their own dtype from x[0], as before; a column
    of -0.0 stays -0.0 in every dtype (a fold from +0.0 would not)."""
    rng = np.random.default_rng(10 + m)
    x = torch.from_numpy(rng.standard_normal((m, 257))).to(dtype)
    x[:, 0] = -0.0
    x[:, 1] = 0.0
    x[:, 2] = -0.0
    x[-1, 2] = 0.0 if m > 1 else -0.0   # -0.0 + +0.0 is +0.0
    got = sum_leading(x)
    if dtype != BF16:
        acc = x[0].clone()
        for w in range(1, m):
            acc = acc + x[w]
        assert np.array_equal(_bits(got), _bits(acc))
    assert torch.signbit(got[0]) and not torch.signbit(got[1])
    assert bool(torch.signbit(got[2])) == (m == 1)


def test_plain_fold_is_the_repaired_fold():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (6, 99)).astype(np.float32)).to(BF16)
    assert np.array_equal(_bits(ref.fold_workers(x)), _bits(sum_leading(x)))
    g, h, e, t, p, mask = _inputs(6, (99,), COMBOS["f32_bf16"])
    new_ghat, agg, _ = ref.fused_dense_step(g, h, t, p, mask, ALPHA, BETA)
    assert np.array_equal(_bits(agg), _bits(sum_leading(new_ghat)))


# ----------------------------------------- plain versions against JAX
@pytest.mark.parametrize("m,shape", LEAVES)
@pytest.mark.parametrize("combo", list(COMBOS), ids=list(COMBOS))
def test_plain_versions_equal_the_eager_oracles(combo, m, shape):
    g, h, e, t, p, mask = _inputs(m, shape, COMBOS[combo])
    gj, hj, ej, tj, pj = map(_j, (g, h, e, t, p))
    mj = jnp.asarray(mask.numpy())
    np.testing.assert_allclose(
        ref.censor_delta_sqnorm_batched(g, h).numpy(),
        j_ref.censor_delta_sqnorm_batched(gj, hj), rtol=1e-5)
    out = ref.fused_dense_step(g, h, t, p, mask, ALPHA, BETA)
    want = j_ref.fused_dense_step(gj, hj, tj, pj, mj, ALPHA, BETA)
    assert [x.dtype for x in out] == [BF16, BF16, t.dtype]
    for a, b in zip(out, want):
        assert _same(a, b)
    sq, amax = ref.int8_stats_batched(g, h, e)
    sq_j, amax_j = j_ref.int8_stats_batched(gj, hj, ej)
    np.testing.assert_allclose(sq.numpy(), sq_j, rtol=1e-5)
    assert amax.dtype == BF16 and _same(amax, amax_j)
    scale = int8_scale(amax)
    sj = jnp.asarray(scale.numpy())
    # pending, its codes and the payload: the JAX oracle's expressions
    pend = (g.to(h.dtype) - h) + e.to(h.dtype)
    pend_j = (gj.astype(hj.dtype) - hj) + ej.astype(hj.dtype)
    assert _same(pend, pend_j)
    s = scale[:, None].expand(m, pend[0].numel()).reshape(pend.shape)
    codes = torch.clamp(torch.round(pend.float() / s), -127, 127)
    sj_b = s.numpy()
    codes_j = jnp.clip(jnp.round(pend_j.astype(jnp.float32) / sj_b),
                       -127, 127)
    assert _same(codes, codes_j)
    payload, new_err = ref.quantize_ef_batched(pend, e, mask, scale)
    want_q = j_ref.quantize_ef_batched(pend_j, ej, mj, sj)
    assert _same(payload, want_q[0]) and _same(new_err, want_q[1])
    out = ref.fused_int8_step(g, h, e, t, p, mask, scale, ALPHA, BETA)
    want = j_ref.fused_int8_step(gj, hj, ej, tj, pj, mj, sj, ALPHA, BETA)
    assert [x.dtype for x in out] == [BF16, BF16, BF16, t.dtype]
    for a, b in zip(out, want):
        assert _same(a, b)


def _sum_abs(bank: torch.Tensor) -> np.ndarray:
    return np.abs(_f64(bank)).sum(axis=0)


def _eq4_terms(t, p, agg) -> np.ndarray:
    tt = _f64(t)
    return np.abs(tt) + ALPHA * np.abs(_f64(agg)) + BETA * np.abs(tt - _f64(p))


def _unit(dtype) -> float:
    return U_BF16 if dtype == BF16 else 2.0 ** -24


@pytest.mark.parametrize("m,shape", LEAVES)
@pytest.mark.parametrize("combo", list(COMBOS), ids=list(COMBOS))
def test_plain_versions_against_interpreted_kernels(combo, m, shape):
    g, h, e, t, p, mask = _inputs(m, shape, COMBOS[combo], seed=1)
    gj, hj, ej, tj, pj = map(_j, (g, h, e, t, p))
    mj = jnp.asarray(mask.numpy())
    dsq = ref.censor_delta_sqnorm_batched(g, h).numpy()
    dsq_j = np.asarray(j_censor.censor_delta_sqnorm_batched(
        gj, hj, interpret=True))
    np.testing.assert_allclose(dsq, dsq_j, rtol=DSQ_RTOL)
    out = ref.fused_dense_step(g, h, t, p, mask, ALPHA, BETA)
    want = j_fused.fused_dense_step(gj, hj, tj, pj, mj, ALPHA, BETA,
                                    interpret=True)
    s_abs = _sum_abs(out[0])
    agg_tol = 2.0 ** -7 * s_abs.reshape(t.shape)
    assert np.all(np.abs(_f64(out[1]) - _f64(want[1])) <= agg_tol)
    theta_tol = ALPHA * agg_tol + 2 * _unit(t.dtype) * _eq4_terms(
        t, p, out[1])
    assert np.all(np.abs(_f64(out[2]) - _f64(want[2])) <= theta_tol)
    sq, amax = ref.int8_stats_batched(g, h, e)
    sq_j, amax_j = j_fused.int8_stats_batched(gj, hj, ej, interpret=True)
    np.testing.assert_allclose(sq.numpy(), np.asarray(sq_j), rtol=DSQ_RTOL)
    # rounding is monotone: max of rounded = rounded max, within its ulp
    assert np.all(np.abs(_f64(amax) - _f64(amax_j))
                  <= 2 * U_BF16 * _f64(amax_j))
    scale = int8_scale(amax)
    out = ref.fused_int8_step(g, h, e, t, p, mask, scale, ALPHA, BETA)
    want = j_fused.fused_int8_step(gj, hj, ej, tj, pj, mj,
                                   jnp.asarray(scale.numpy()), ALPHA, BETA,
                                   interpret=True)
    code_step = float(scale[mask != 0].sum()) * (1 + 2.0 ** -7)
    agg_tol = 2.0 ** -7 * _sum_abs(out[0]).reshape(t.shape) + code_step
    assert np.all(np.abs(_f64(out[2]) - _f64(want[2])) <= agg_tol)
    theta_tol = ALPHA * agg_tol + 2 * _unit(t.dtype) * _eq4_terms(
        t, p, out[2])
    assert np.all(np.abs(_f64(out[3]) - _f64(want[3])) <= theta_tol)


# ------------------------------------------------ the wrappers' contract
@pytest.mark.parametrize("combo", list(COMBOS), ids=list(COMBOS))
def test_wrappers_take_the_pairs_and_give_the_jax_dtypes(combo):
    """On CPU tensors the wrappers run the plain versions; the outputs are
    in the dtypes of the JAX kernels' out_shape: ghat', err' and agg in the
    bank dtype, theta' in the params dtype, sqnorms f32, abs-max bank."""
    g, h, e, t, p, mask = _inputs(4, (3, 50), COMBOS[combo], seed=2)
    assert censor.censor_delta_sqnorm_batched(g, h).dtype == F32
    sq, amax = fused_step.int8_stats_batched(g, h, e)
    assert (sq.dtype, amax.dtype) == (F32, BF16)
    out = fused_step.fused_dense_step(g, h, t, p, mask, ALPHA, BETA)
    assert [x.dtype for x in out] == [BF16, BF16, t.dtype]
    for a, b in zip(out, ref.fused_dense_step(g, h, t, p, mask, ALPHA,
                                              BETA)):
        assert np.array_equal(_bits(a), _bits(b))
    scale = int8_scale(amax)
    out = fused_step.fused_int8_step(g, h, e, t, p, mask, scale, ALPHA, BETA)
    assert [x.dtype for x in out] == [BF16, BF16, BF16, t.dtype]
    # empty leaves keep the dtypes too
    g0, h0, e0 = (torch.empty((4, 0), dtype=x.dtype) for x in (g, h, e))
    t0 = torch.empty((0,), dtype=t.dtype)
    out = fused_step.fused_int8_step(g0, h0, e0, t0, t0, mask, scale, ALPHA,
                                     BETA)
    assert [x.dtype for x in out] == [BF16, BF16, BF16, t.dtype]
    out = fused_step.fused_dense_step(g0, h0, t0, t0, mask, ALPHA, BETA)
    assert [x.dtype for x in out] == [BF16, BF16, t.dtype]


REFUSED = [(torch.float16, torch.float16, torch.float16),
           (F32, F64, F32), (F64, BF16, BF16), (BF16, F32, F32),
           (BF16, BF16, F32), (F32, F32, BF16), (F32, torch.float16,
                                                 torch.float16)]


@pytest.mark.parametrize("combo", REFUSED,
                         ids=["f16", "f32_f64", "f64_bf16", "bf16_f32",
                              "bf16_err_f32", "f32_err_bf16", "f32_f16"])
def test_other_pairs_are_refused_before_any_launch(combo):
    p_dt, h_dt, e_dt = combo
    g, h, e, t, p, mask = _inputs(2, (8,), (F32, F32, F32))
    g, t, p, h, e = g.to(p_dt), t.to(p_dt), p.to(p_dt), h.to(h_dt), \
        e.to(e_dt)
    scale = torch.ones(2)
    calls = [lambda: fused_step.int8_stats_batched(g, h, e),
             lambda: fused_step.fused_int8_step(g, h, e, t, p, mask, scale,
                                                ALPHA, BETA)]
    if e_dt == h_dt or e_dt == p_dt:     # B1 and B2 take no err
        calls += [lambda: censor.censor_delta_sqnorm_batched(g, h),
                  lambda: fused_step.fused_dense_step(g, h, t, p, mask,
                                                      ALPHA, BETA)]
    for call in calls:
        with pytest.raises(TypeError, match="ROADMAP queue B") as info:
            call()
        assert str(h_dt) in str(info.value)
    if e_dt not in (h_dt, p_dt) or (p_dt, h_dt) in common.FUSED_DTYPES:
        return
    with pytest.raises(TypeError, match="bank dtype"):
        censor.censor_delta_sqnorm_batched(g, h)


def test_dtype_maps_agree():
    """The Python map of pairs, the bound launchers and the C sources name
    the same suffixes."""
    assert set(common.FUSED_DTYPES.values()) == {"f32", "f64",
                                                 *build.SUB_F32_SUFFIXES}
    assert set(common.KERNEL_DTYPES) == {F32, F64}
    assert common.fused_suffix("x", (torch.zeros(1),), torch.zeros(
        1, dtype=BF16), torch.zeros(1)) == "f32_bf16_f32"


H100_SMS = 132
#: (kernel, design, wrapper call on meta tensors, library, base name)
DESIGNS = [("B1", "two_pass"), ("B1", "warp"), ("B5", "two_pass"),
           ("B5", "warp"), ("B2", "one_pass"), ("B2", "tall"),
           ("B6", "one_pass"), ("B6", "tall")]


@pytest.fixture
def on_h100(monkeypatch):
    """The wrappers past the dispatch rule as on an H100: meta tensors count
    as on the card, and each ``launch`` is recorded, not run."""
    calls = []
    for mod in (censor, fused_step):
        monkeypatch.setattr(mod, "on_card", lambda name, *ts: True)
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


@pytest.mark.parametrize("combo", list(COMBOS), ids=list(COMBOS))
@pytest.mark.parametrize("kernel,design", DESIGNS,
                         ids=[f"{k}-{d}" for k, d in DESIGNS])
def test_each_design_launches_its_sub_f32_launcher(on_h100, kernel, design,
                                                   combo):
    """On meta tensors: the launcher each design calls for each dtype
    combination, bound in ``build.SIGNATURES`` with the C definition's
    arity, one count a call."""
    p_dt, h_dt, e_dt = COMBOS[combo]
    m, n = 2000, 16

    def meta(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")

    g, h, e = meta((m, n), p_dt), meta((m, n), h_dt), meta((m, n), e_dt)
    t, p = meta((n,), p_dt), meta((n,), p_dt)
    mask = meta((m,), F32)
    pair = common.FUSED_DTYPES[(p_dt, h_dt)]
    suffix = pair + ("_f32" if e_dt != h_dt else "")
    if kernel == "B1":
        lib, base, name = "censor", "censor_delta_sqnorm_batched", pair
        censor.delta_sqnorm_on_card(g, h, design)
    elif kernel == "B5":
        lib, base, name = "fused_step", "int8_stats_batched", suffix
        fused_step.int8_stats_on_card(g, h, e, design)
    elif kernel == "B2":
        lib, base, name = "fused_step", "fused_dense_step", pair
        out = fused_step.dense_on_card(g, h, t, p, mask, ALPHA, BETA, design)
        assert [x.dtype for x in out] == [h_dt, h_dt, p_dt]
    else:
        lib, base, name = "fused_step", "fused_int8_step", suffix
        out = fused_step.int8_on_card(g, h, e, t, p, mask, mask, ALPHA,
                                      BETA, design)
        assert [x.dtype for x in out] == [h_dt, h_dt, h_dt, p_dt]
    infix = {"warp": "_warp", "tall": "_tall"}.get(design, "")
    fn = f"{base}{infix}_{name}"
    assert len(on_h100) == 1 and on_h100[0][:2] == (lib, fn)
    assert len(build.SIGNATURES[lib][fn]) == on_h100[0][2] + 2 \
        == _c_arity(lib, fn)
    assert common.LAUNCHES[base] == 1 and sum(common.LAUNCHES.values()) == 1


@pytest.mark.parametrize("combo", list(COMBOS), ids=list(COMBOS))
def test_wrappers_pick_a_design_for_sub_f32_banks(on_h100, combo):
    p_dt, h_dt, e_dt = COMBOS[combo]
    for m, n in ((4, 33), (2000, 16), (100_000, 16)):
        g = torch.empty((m, n), dtype=p_dt, device="meta")
        h = torch.empty((m, n), dtype=h_dt, device="meta")
        e = torch.empty((m, n), dtype=e_dt, device="meta")
        t = torch.empty((n,), dtype=p_dt, device="meta")
        mask = torch.empty((m,), dtype=F32, device="meta")
        censor.censor_delta_sqnorm_batched(g, h)
        fused_step.int8_stats_batched(g, h, e)
        fused_step.fused_dense_step(g, h, t, t, mask, ALPHA, BETA)
        fused_step.fused_int8_step(g, h, e, t, t, mask, mask, ALPHA, BETA)
    assert all(fn in build.SIGNATURES[lib] for lib, fn, _ in on_h100)
    assert len(on_h100) == 12


# ------------------------------------------------------------ the optimizer
def _linreg():
    j = j_paper.make_linear_regression(m=5, n_per=30, d=20, seed=0)
    p = paper_tasks.make_linear_regression(m=5, n_per=30, d=20, seed=0,
                                           device="cpu")
    return j, p


def _jtask(task, dtype):
    cast = lambda x: x.astype(dtype)   # noqa: E731
    return task._replace(init_params=jax.tree_util.tree_map(
        cast, task.init_params), worker_data=jax.tree_util.tree_map(
        cast, task.worker_data))


@pytest.mark.parametrize("kw", [{}, {"quantize": "int8"}],
                         ids=["dense", "int8"])
def test_kernel_backend_equals_reference_on_a_bf16_bank(kw):
    """f32 params on a bf16 bank: the cuda backend's plain versions and the
    reference backend give the same bits (eq. (4) runs in f32 on both)."""
    _, p = _linreg()
    task = simulator.task_to(p.task, dtype=F32)
    runs = [simulator.run(opt.make("chb", p.alpha_paper, 5, backend=b,
                                   bank_dtype=BF16, **kw),
                          task, 60, device="cpu") for b in ("cuda",
                                                            "reference")]
    for f in ("objective", "comm_cum", "mask", "agg_grad_sqnorm",
              "final_params"):
        a, b = (getattr(h, f) for h in runs)
        assert torch.equal(a, b), f
    for a, b in zip(*(h.final_state for h in runs)):
        for x, y in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b)):
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert runs[0].final_state.ghat.dtype == BF16


def test_init_honours_the_bank_dtype_on_cuda():
    params = torch.zeros(7)
    for kw, err_dtype in (({}, None), ({"quantize": "int8"}, F32)):
        s = opt.make("chb", 0.1, 3, bank_dtype=BF16, backend="cuda",
                     **kw).init(params)
        assert s.ghat.dtype == BF16 and s.ghat.shape == (3, 7)
        if err_dtype is not None:     # transport.init: the params' dtype
            assert s.err.dtype == err_dtype


#: the routes that stay closed on cuda: (bank dtype, opt.make keywords,
#: how the step runs, the params' shape). Every route off the fused one
#: takes f32, f64 and bf16 banks (bf16 runs there: see the test below and
#: tests/test_torch_stateful_bf16.py) and refuses an f16 one (the kernels'
#: f16 builds are ROADMAP queue B). Low-rank runs a matrix leaf, so the
#: reference half runs its factor products of an f16 pending leaf and f32
#: factors in f32, as jnp.matmul promotes them
CLOSED_ROUTES = {
    "staged": (torch.float16, {}, "staged", (8,)),
    "topk": (torch.float16, {"transport": "topk", "k": 3}, "step", (8,)),
    "lowrank": (torch.float16, {"transport": "lowrank", "rank": 1}, "step",
                (2, 4)),
    "per_tensor": (torch.float16, {"granularity": "per_tensor"}, "step",
                   (8,)),
    "shard_step": (torch.float16, {}, "shard_step", (8,)),
    "int8_staged": (torch.float16, {"quantize": "int8"}, "staged", (8,)),
    "int8_shard_step": (torch.float16, {"quantize": "int8"}, "shard_step",
                        (8,)),
}


def _run_route(o, how, params, grads):
    state = o.init(params)
    if how == "staged":
        with fused_step.force_staged():
            return o.step(state, params, grads)
    if how == "shard_step":
        return o.shard_step(state, params, grads)
    return o.step(state, params, grads)


@pytest.mark.parametrize("route", list(CLOSED_ROUTES))
def test_sub_f32_bank_off_the_fused_route_is_refused(route, monkeypatch):
    """On cuda the routes that CLOSED_ROUTES lists raise before any kernel
    is called; the reference backend runs them all."""
    called = []
    for name in ("censor_delta_sqnorm_batched", "sqnorm_batched",
                 "bank_advance", "censor_bank_advance"):
        monkeypatch.setattr(censor, name, lambda *a, **k: called.append(1))
    bank, kw, how, shape = CLOSED_ROUTES[route]
    o = opt.make("chb", 0.1, 3, eps1=1.0, bank_dtype=bank, backend="cuda",
                 **kw)
    params = torch.ones(shape)
    grads = torch.randn((3,) + shape,
                        generator=torch.Generator().manual_seed(0))
    with pytest.raises(TypeError, match="ROADMAP queue B") as info:
        _run_route(o, how, params, grads)
    assert str(bank) in str(info.value)
    assert not called
    monkeypatch.undo()
    o = opt.make("chb", 0.1, 3, eps1=1.0, bank_dtype=bank,
                 backend="reference", **kw)
    _run_route(o, how, params, grads)


OPENED = [(r, p) for r in ("staged", "per_tensor", "shard_step")
          for p in ("f32_bf16", "bf16")]


@pytest.mark.parametrize("route,combo", OPENED,
                         ids=[f"{r}-{p}" for r, p in OPENED])
def test_dense_routes_off_the_fused_one_run_on_a_bf16_bank(route, combo):
    """force_staged() dense, per_tensor and shard_step run a bf16 bank on
    cuda (their kernels' plain versions here): the bank, masks, counters
    and (on f32 params, where both backends run eq. (4) in f32) theta equal
    the reference backend's bit for bit."""
    p_dt = COMBOS[combo][0]
    kw = {"granularity": "per_tensor"} if route == "per_tensor" else {}
    if p_dt == F32:
        kw["bank_dtype"] = BF16
    gen = torch.Generator().manual_seed(1)
    params = {"a": torch.randn(8, generator=gen).to(p_dt),
              "b": torch.randn((2, 3), generator=gen).to(p_dt)}
    grads = {k: torch.randn((3,) + tuple(v.shape), generator=gen).to(p_dt)
             for k, v in params.items()}
    how = {"per_tensor": "step"}.get(route, route)
    outs = [_run_route(opt.make("chb", 0.1, 3, eps1=0.5, backend=b, **kw),
                       how, params, grads) for b in ("cuda", "reference")]
    (sc, tc, stc), (sr, tr, str_) = outs
    assert torch.equal(stc.mask, str_.mask)
    for x, y in zip(jax.tree_util.tree_leaves(sc),
                    jax.tree_util.tree_leaves(sr)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert sc.ghat["a"].dtype == BF16
    for x, y in zip(jax.tree_util.tree_leaves(tc),
                    jax.tree_util.tree_leaves(tr)):
        assert x.dtype == (BF16 if route == "shard_step" else p_dt)
        if p_dt == F32:
            assert torch.equal(x, y)


def test_tree_entry_points_take_sub_f32_banks():
    g, h, e, t, p, mask = _inputs(4, (3, 50), COMBOS["f32_bf16_f32"])
    tree_g, tree_h = {"a": g, "b": g[:, :1]}, {"a": h, "b": h[:, :1]}
    tree_e, tree_t = {"a": e, "b": e[:, :1]}, {"a": t, "b": t[:1]}
    dsq = ops.tree_delta_sqnorms(tree_g, tree_h)
    assert dsq.dtype == F32
    dsq8, scales = ops.tree_int8_stats(tree_g, tree_h, tree_e)
    assert dsq8.dtype == F32 and scales["a"].dtype == F32
    out = ops.tree_fused_dense_step(tree_g, tree_h, tree_t, tree_t, mask,
                                    ALPHA, BETA)
    assert out[1]["a"].dtype == BF16 and out[2]["b"].dtype == F32
    out = ops.tree_fused_int8_step(tree_g, tree_h, tree_e, tree_t, tree_t,
                                   mask, scales, ALPHA, BETA)
    assert out[1]["a"].dtype == BF16 and out[3]["a"].dtype == F32


# ------------------------------------------------------ runs against JAX
def _margin(o, stats) -> float:
    thr = float(o.eps1) * float(stats.step_sq)
    if thr <= 0:
        return float("inf")
    return float(((stats.delta_sq.double() - thr).abs() / thr).min())


class _Margins:
    """Wraps an optimizer and records each step's eq.-(8) margin."""

    def __init__(self, o):
        self.o, self.margins = o, []

    def init(self, params):
        return self.o.init(params)

    def step(self, state, params, grads):
        out = self.o.step(state, params, grads)
        self.margins.append(_margin(self.o, out[2]))
        return out


def _held_masks(got, want, margins) -> int:
    """Iterations whose masks are held equal: each one whose every
    decision clears its threshold by more than DSQ_RTOL, until a decision
    within it goes the other way (from there the two runs' states
    differ). Returns how many were held."""
    held = 0
    for k, margin in enumerate(margins):
        if margin > DSQ_RTOL:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"it {k}")
            held += 1
        elif not np.array_equal(got[k], want[k]):
            break
    return held


EDGE_CASES = [("f32_bf16", "reference"), ("f32_bf16", "cuda"),
              ("bf16", "reference"), ("bf16", "cuda")]


@pytest.mark.parametrize("combo,backend", EDGE_CASES,
                         ids=[f"{c}-{b}" for c, b in EDGE_CASES])
def test_edge_quadratics_run_matches_jax(combo, backend):
    """Dense chb on the edge quadratics (M = 16, d = 16, 30 iterations)
    under the JAX package's ``simulator.run`` and the port's, both
    backends (``cuda`` against ``pallas``): masks, comm_cum and counts
    exact; every decision's margin over DSQ_RTOL; theta within 2^-6 of
    its largest value (the bf16 banks' roundings of the two, 30 steps)."""
    p_dt = COMBOS[combo][0]
    jt = j_edge.make_edge_quadratics(m=16, d=16, seed=0)
    jt = jt._replace(init_params=jt.init_params.astype(_J[p_dt]),
                     worker_data=tuple(x.astype(_J[p_dt])
                                       for x in jt.worker_data))
    pt = edge_tasks.make_edge_quadratics(m=16, d=16, seed=0, device="cpu",
                                         dtype=p_dt)
    bank = {"bank_dtype": BF16} if p_dt == F32 else {}
    jbank = {"bank_dtype": jnp.bfloat16} if p_dt == F32 else {}
    jh = j_simulator.run(j_opt.make(
        "chb", 0.5 / 16, 16, eps1=4.0,
        backend="pallas" if backend == "cuda" else "reference", **jbank),
        jt, 30)
    rec = _Margins(opt.make("chb", 0.5 / 16, 16, eps1=4.0, backend=backend,
                            **bank))
    ph = simulator.run(rec, pt, 30, device="cpu")
    held = _held_masks(ph.mask.numpy(), np.asarray(jh.mask), rec.margins)
    assert held >= 25, (held, rec.margins)
    if held == 30:
        np.testing.assert_array_equal(ph.comm_cum.numpy(),
                                      np.asarray(jh.comm_cum))
        assert int(ph.final_state.comm.uplink_count.sum()) \
            == int(np.asarray(jh.comm_cum)[-1])
    assert ph.final_state.ghat.dtype == BF16
    want = _f64(jh.final_params)
    assert np.abs(_f64(ph.final_params) - want).max() \
        <= 2.0 ** -6 * np.abs(want).max()


def test_jax_scan_refuses_int8_on_a_bf16_bank_of_f32_params():
    """The JAX package's ``simulator.run`` scans its step: int8 with a bf16
    bank at f32 params changes err's dtype (f32 from transport.init, bf16
    after the first step) and the scan refuses it; the port's Python loop
    runs it (held against JAX's steps below)."""
    j, _ = _linreg()
    o = j_opt.make("chb", j.alpha_paper, 5, quantize="int8",
                   bank_dtype=jnp.bfloat16)
    with pytest.raises(TypeError, match="carry"):
        j_simulator.run(o, _jtask(j.task, jnp.float32), 2)


LINREG_CASES = [(c, q, b) for c in ("f32_bf16", "bf16")
                for q in ("dense", "int8") for b in ("reference", "cuda")]


def _to_jax_state(state, j_state0):
    """The port's OptState as the JAX package's (its leaves' dtypes)."""
    leaves = jax.tree_util.tree_leaves(
        (state.prev_params, state.ghat, state.err, tuple(state.comm),
         state.censor))
    j_leaves, treedef = jax.tree_util.tree_flatten(j_state0)
    assert len(leaves) == len(j_leaves)
    return jax.tree_util.tree_unflatten(treedef, [_j(x) for x in leaves])


@pytest.mark.parametrize("combo,quant,backend", LINREG_CASES,
                         ids=[f"{c}-{q}-{b}" for c, q, b in LINREG_CASES])
def test_golden_linreg_held_step_by_step_against_jax(combo, quant,
                                                     backend):
    """chb on the golden linreg (m=5, n_per=30, d=20, 60 iterations)
    through the port's ``simulator.run``; at every iteration the JAX
    package's jitted step (what its ``simulator.run`` scans) from the
    port's state: masks and counters exact where the margin is over
    DSQ_RTOL, dsq within it; ghat', err' and theta' within a bf16 unit
    roundoff of their terms, plus one int8 code step a worker."""
    j, p = _linreg()
    p_dt = COMBOS[combo][0]
    kw = {"quantize": "int8"} if quant == "int8" else {}
    bank = {"bank_dtype": BF16} if p_dt == F32 else {}
    o = opt.make("chb", p.alpha_paper, 5, backend=backend, **kw, **bank)
    jo = j_opt.make("chb", j.alpha_paper, 5,
                    backend="pallas" if backend == "cuda" else "reference",
                    **kw, **({"bank_dtype": jnp.bfloat16} if bank else {}))
    jstep = jax.jit(jo.step)
    task = simulator.task_to(p.task, dtype=p_dt)
    seen = {"margin": [], "held": 0}

    class Lockstep:
        def init(self, params):
            return o.init(params)

        def step(self, state, params, grads):
            out = o.step(state, params, grads)
            new_state, new_params, stats = out
            js, jp, jst = jstep(_to_jax_state(state, jo.init(_j(params))),
                                _j(params), _j(grads))
            margin = _margin(o, stats)
            seen["margin"].append(margin)
            np.testing.assert_allclose(stats.delta_sq.numpy(),
                                       np.asarray(jst.delta_sq),
                                       rtol=DSQ_RTOL)
            if margin <= DSQ_RTOL:
                return out
            seen["held"] += 1
            np.testing.assert_array_equal(stats.mask.numpy(),
                                          np.asarray(jst.mask))
            for a, b in zip(new_state.comm, js.comm):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            h, pend = _f64(state.ghat), _f64(grads.to(BF16)) \
                - _f64(state.ghat) + _f64(state.err.to(BF16)
                                          if quant == "int8" else 0 * grads)
            scale = (np.abs(pend).max(axis=1, keepdims=True) / 127
                     if quant == "int8" else 0.0)
            tol = 2 * U_BF16 * (np.abs(h) + np.abs(pend)) \
                + 2 * scale + 1e-30
            for a, b in zip((new_state.ghat, new_state.err),
                            (js.ghat, js.err)):
                if quant == "dense" and a is new_state.err:
                    continue
                assert a.dtype == BF16
                assert np.all(np.abs(_f64(a) - _f64(b)) <= tol)
            agg_tol = (2 * U_BF16 * (np.abs(h) + np.abs(pend))
                       + 2 * scale).sum(axis=0) \
                + 2.0 ** -7 * np.abs(_f64(new_state.ghat)).sum(axis=0)
            t, tp = _f64(params), _f64(state.prev_params)
            terms = np.abs(t) + o.alpha * np.abs(
                _f64(new_state.ghat).sum(axis=0)) + o.beta * np.abs(t - tp)
            theta_tol = o.alpha * agg_tol + 8 * _unit(p_dt) * terms
            assert new_params.dtype == p_dt
            assert np.all(np.abs(_f64(new_params) - _f64(jp)) <= theta_tol)
            return out

    hist = simulator.run(Lockstep(), task, 60, device="cpu")
    assert seen["held"] >= 55, seen
    assert int(hist.final_state.comm.uplink_count.sum()) \
        == int(hist.comm_cum[-1]) > 0
