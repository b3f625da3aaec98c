"""The stateful transports on bf16 banks, on the CPU: the bf16 builds of
B7a (``absmax_batched``), B7b (``quantize_ef_batched``), B10
(``select_pack_ef_batched``) and B11 (``residual_ef_batched``), the routes
they open on ``cuda`` (int8 under ``force_staged()``, top-k, low-rank and
their ``shard_step``, so ``fed.run_mesh``), and the repaired low-rank factor
products of f32 params over a bf16 bank, held against the JAX package.

Operands: a bf16 pending leaf; err in bf16 or in f32 (``transport.init``'s
on f32 params, before the first step); B11's payload in bf16 or in f32 (the
factor products of a bf16 pending leaf and f32 factors run in f32, as
``jnp.matmul`` promotes them). The port's ``cuda`` backend runs here on CPU
tensors, so its wrappers run their plain versions (no launch is counted).

Tolerances and why:
  * the plain versions against the JAX package's eager ``kernels/ref.py``
    (each bf16 op rounded, as PyTorch's): bit for bit, NaN where NaN,
    -0.0 included;
  * against the interpreted Pallas kernels: B7a, B10 and the B7b payload
    bit for bit (a max, a select, and an f32 product rounded once); B7b's
    and B11's err' within EXCESS_UNITS bf16 unit roundoffs (2^-8) of
    |pending| + |payload|: XLA may keep the payload (B7b's ``q32 * scale``,
    B11's f32 payload cast to bf16) unrounded in f32 inside the kernel, so
    that ``pending - payload`` rounds once there and twice here (the
    payload's own rounding u|q|, then u|p - q'| and u|p - q| on the two
    sides: at most 3u(|p| + |q|)). On jax 0.9.0's CPU backend they agree
    bit for bit;
  * the top-k keep sets against ``tree_topk_keep`` exactly, on bf16 rows
    salted with ties and signed zeros;
  * one step from one state through the port's two backends and JAX's two:
    masks and counters exact (every eq.-(8) decision clears its threshold
    by more than 1e-3); ghat', err' and q the JAX backend's dtypes; on f32
    params the ``reference`` backends bit for bit and the ``cuda`` one
    against JAX's ``pallas`` within the interpreted kernels' bounds above
    (err' and, through B9, ghat'), theta within 4 u32 of eq. (4)'s terms
    plus alpha times the bank's bound; on bf16 params theta within
    EQ4_UNITS bf16 roundings of eq. (4)'s terms of the reference's;
  * low-rank on f32 params over a bf16 bank: ``reference`` keeps err in f32
    (``_ef_blend`` promotes), ``cuda`` in bf16 (B11 writes the pending
    dtype), as JAX's two backends do; the two agree within one bf16
    rounding of |pending| + |payload| (ONE_ROUNDING);
  * the runtimes (JAX's jitted): masks, counters and bytes exact, theta
    within the bf16 runtimes' bound of ``tests/test_torch_staged_bf16.py``.
"""
import jax

jax.config.update("jax_enable_x64", True)

import contextlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import fed as j_fed
from repro import opt as j_opt
from repro.data import edge_tasks as j_edge
from repro.fed.mesh import MeshScenario as JMeshScenario
from repro.fed.mesh import run_mesh as j_run_mesh
from repro.kernels import fused_step as j_fused
from repro.kernels import lowrank_ef as j_lowrank
from repro.kernels import quantize_ef as j_quant
from repro.kernels import ref as j_ref
from repro.kernels import topk_pack as j_topk
from repro.opt import transport as j_transport
from repro_torch import fed, opt
from repro_torch.core.quantize import int8_scale
from repro_torch.data import edge_tasks
from repro_torch.kernels import (build, common, fused_step, lowrank_ef,
                                 quantize_ef, ref, topk_pack)
from repro_torch.launch.mesh import make_client_mesh
from repro_torch.opt import transport

BF16, F32, F64, F16 = torch.bfloat16, torch.float32, torch.float64, \
    torch.float16
LEAVES = [(1, (20,)), (4, (3, 50)), (9, (300, 129))]
U32, U_BF16 = 2.0 ** -24, 2.0 ** -8
EXCESS_UNITS = 3
ONE_ROUNDING = 2 * U_BF16
EQ4_UNITS = 8
ALPHA, BETA, EPS1 = 0.05, 0.4, 0.5
_J = {BF16: jnp.bfloat16, F32: jnp.float32, F64: jnp.float64}
_INT = {BF16: torch.int16, F32: torch.int32, F64: torch.int64}
#: err dtypes of a bf16 pending leaf (B7b, B10) and (payload, err) of B11
ERRS = {"bf16": BF16, "f32": F32}
B11_PAIRS = {"bf16": (BF16, BF16), "f32_bf16": (F32, BF16),
             "bf16_f32": (BF16, F32), "f32_f32": (F32, F32)}


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


def _jt(tree):
    return jax.tree_util.tree_map(_j, tree)


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
    want = np.asarray(want)
    assert want.dtype == np.dtype(_J[got.dtype]), (want.dtype, got.dtype)
    assert tuple(got.shape) == want.shape
    nan = np.isnan(want.astype(np.float64))
    np.testing.assert_array_equal(torch.isnan(got).numpy(), nan)
    gb = got.contiguous().view(_INT[got.dtype]).numpy()
    wb = want.view({2: np.int16, 4: np.int32, 8: np.int64}[want.itemsize])
    np.testing.assert_array_equal(gb[~nan], wb[~nan])


def _within(got, want, bound) -> None:
    a, b = _f64(got), _f64(want)
    nan = np.isnan(b)
    np.testing.assert_array_equal(np.isnan(a), nan)
    same = a[~nan] == b[~nan]           # infinities of one sign included
    with np.errstate(invalid="ignore"):
        assert np.all(same | (np.abs(a[~nan] - b[~nan])
                              <= np.broadcast_to(bound, a.shape)[~nan]))


def _leaf_inputs(m, shape, seed=0):
    """A bf16 pending leaf, an f32 err and payload near it, a bf16 0/1 keep
    and the (M,) f32 mask, from one numpy seed: -0.0 on every 7th pending
    and 5th err column, one worker's pending all zero (M > 1), and (M > 2)
    NaN and +-inf in the second and third pending rows."""
    rng = np.random.default_rng(seed + 17 * m + len(shape))
    p = rng.standard_normal((m,) + shape).astype(np.float32)
    e = (0.01 * rng.standard_normal((m,) + shape)).astype(np.float32)
    q = (p + 0.1 * rng.standard_normal((m,) + shape)).astype(np.float32)
    keep = (rng.random((m,) + shape) < 0.4).astype(np.float32)
    p.reshape(m, -1)[:, ::7] = -0.0
    e.reshape(m, -1)[:, ::5] = -0.0
    if m > 1:
        p[-1] = 0.0
    if m > 2:
        p.reshape(m, -1)[1, 2] = np.nan
        p.reshape(m, -1)[2, 3] = -np.inf
        p.reshape(m, -1)[2, 0] = np.inf
    mask = np.array([1.0, 0.0, 1.0, 1.0, 0.0, 1.0, 1.0, 0.0, 1.0][:m],
                    np.float32)
    tt = torch.from_numpy
    return (tt(p).to(BF16), tt(e), tt(q), tt(keep).to(BF16), tt(mask))


def _scale(pend: torch.Tensor) -> torch.Tensor:
    """The f32 scales of the staged route: ``int8_scale`` of B7a's bf16
    abs-max (a bf16 value, which ``ref`` and JAX's ``ref.py`` round through
    the pending dtype unchanged)."""
    return int8_scale(ref.absmax_batched(pend))


# ----------------------------------------- plain versions against JAX
@pytest.mark.parametrize("m,shape", LEAVES)
@pytest.mark.parametrize("err", list(ERRS))
def test_plain_versions_equal_the_eager_oracles(err, m, shape):
    """B7a, B7b, B10 and (each payload dtype) B11 against JAX's eager
    ``ref.py``, bit for bit, in the pending dtype."""
    p, e, q, keep, mask = _leaf_inputs(m, shape)
    e = e.to(ERRS[err])
    pj, ej, kj, mj = map(_j, (p, e, keep, mask))
    amax = ref.absmax_batched(p)
    assert amax.dtype == BF16
    _exact(amax, j_ref.absmax_batched(pj))
    scale = _scale(p)
    assert scale.dtype == F32
    got = ref.quantize_ef_batched(p, e, mask, scale)
    want = j_ref.quantize_ef_batched(pj, ej, mj, _j(scale))
    for a, b in zip(got, want):
        assert a.dtype == BF16
        _exact(a, b)
    got = ref.select_pack_ef_batched(p, e, keep, mask)
    want = j_ref.select_pack_ef_batched(pj, ej, kj, mj)
    for a, b in zip(got, want):
        _exact(a, b)
    for q_dt in (BF16, F32):
        qq = q.to(q_dt)
        out = ref.residual_ef_batched(p, qq, e, mask)
        assert out.dtype == BF16
        _exact(out, j_ref.residual_ef_batched(pj, _j(qq), ej, mj))


@pytest.mark.parametrize("m,shape", LEAVES)
@pytest.mark.parametrize("err", list(ERRS))
def test_plain_versions_against_interpreted_kernels(err, m, shape):
    """Against the Pallas kernels in interpret mode: B7a, B10 and B7b's
    payload bit for bit; B7b's and B11's err' within EXCESS_UNITS bf16
    unit roundoffs of |pending| + |payload| (XLA keeps the payload
    unrounded in f32 there)."""
    p, e, q, keep, mask = _leaf_inputs(m, shape, seed=1)
    e = e.to(ERRS[err])
    pj, ej, kj, mj = map(_j, (p, e, keep, mask))
    _exact(ref.absmax_batched(p), j_quant.absmax_batched(pj,
                                                          interpret=True))
    scale = _scale(p)
    pay, ne = ref.quantize_ef_batched(p, e, mask, scale)
    jpay, jne = j_quant.quantize_ef_batched(pj, ej, mj, _j(scale),
                                            interpret=True)
    _exact(pay, jpay)
    bound = EXCESS_UNITS * U_BF16 * (np.abs(_f64(p)) + np.abs(_f64(pay)))
    _within(ne, jne, bound)
    got = ref.select_pack_ef_batched(p, e, keep, mask)
    want = j_topk.select_pack_ef_batched(pj, ej, kj, mj, interpret=True)
    for a, b in zip(got, want):
        _exact(a, b)
    for q_dt in (BF16, F32):
        qq = q.to(q_dt)
        out = ref.residual_ef_batched(p, qq, e, mask)
        want = j_lowrank.residual_ef_batched(pj, _j(qq), ej, mj,
                                             interpret=True)
        assert np.asarray(want).dtype == np.dtype(jnp.bfloat16)
        bound = EXCESS_UNITS * U_BF16 * (np.abs(_f64(p)) + np.abs(_f64(qq)))
        _within(out, want, bound)


# ------------------------------------------------ the wrappers' contract
@pytest.mark.parametrize("err", list(ERRS))
def test_wrappers_take_the_bf16_operands(err):
    """On CPU tensors the wrappers run the plain versions, every output in
    the pending dtype (B7a's abs-max too); empty leaves keep it."""
    p, e, q, keep, mask = _leaf_inputs(4, (3, 50), seed=2)
    e = e.to(ERRS[err])
    scale = _scale(p)
    pairs = [(quantize_ef.absmax_batched(p), ref.absmax_batched(p)),
             *zip(quantize_ef.quantize_ef_batched(p, e, mask, scale),
                  ref.quantize_ef_batched(p, e, mask, scale)),
             *zip(topk_pack.select_pack_ef_batched(p, e, keep, mask),
                  ref.select_pack_ef_batched(p, e, keep, mask))]
    for q_dt in (BF16, F32):
        pairs.append((lowrank_ef.residual_ef_batched(p, q.to(q_dt), e, mask),
                      ref.residual_ef_batched(p, q.to(q_dt), e, mask)))
    for got, want in pairs:
        assert got.dtype == want.dtype == BF16
        _exact(got, want)
    p0, e0 = torch.empty((4, 0), dtype=BF16), torch.empty((4, 0),
                                                           dtype=ERRS[err])
    assert quantize_ef.absmax_batched(p0).dtype == BF16
    assert all(x.dtype == BF16 for x in quantize_ef.quantize_ef_batched(
        p0, e0, mask, scale))
    assert all(x.dtype == BF16 for x in topk_pack.select_pack_ef_batched(
        p0, e0, p0, mask))
    assert lowrank_ef.residual_ef_batched(p0, e0, e0, mask).dtype == BF16


#: operand dtypes that stay refused: (pending, err, B11's payload)
REFUSED = {"f16": (F16, F16, F16), "f32_pending_bf16_err": (F32, BF16, F32),
           "bf16_f64": (BF16, F64, BF16), "f64_bf16": (F64, BF16, F64),
           "bf16_f16": (BF16, F16, F16)}


@pytest.mark.parametrize("case", list(REFUSED))
def test_other_dtypes_are_refused_before_any_launch(case):
    """B7b, B10 and B11 take the keys of ``common.EF_DTYPES`` only, B7a
    ``STAGED_DTYPES``; anything else raises ``TypeError`` naming ROADMAP
    queue B (no launch: the fixture checks)."""
    p_dt, e_dt, q_dt = REFUSED[case]
    p, e, q, keep, mask = _leaf_inputs(2, (8,))
    p, e, q, keep = p.to(p_dt), e.to(e_dt), q.to(q_dt), keep.to(p_dt)
    for call in (lambda: quantize_ef.quantize_ef_batched(p, e, mask,
                                                         torch.ones(2)),
                 lambda: topk_pack.select_pack_ef_batched(p, e, keep, mask),
                 lambda: lowrank_ef.residual_ef_batched(p, q, e, mask)):
        with pytest.raises(TypeError, match="ROADMAP queue B") as info:
            call()
        assert str(p_dt) in str(info.value)
    if p_dt == F16:
        with pytest.raises(TypeError, match="ROADMAP queue B"):
            quantize_ef.absmax_batched(p)
    # B10's keep is in the pending dtype
    p, e, _, keep, mask = _leaf_inputs(2, (8,))
    with pytest.raises(TypeError, match="keep"):
        topk_pack.select_pack_ef_batched(p, e, keep.float(), mask)


def test_dtype_tables():
    """EF_DTYPES (one table, ``build``'s) names the bound launchers: each
    kernel's launchers in ``build.SIGNATURES`` are its suffixes, and every
    key is a bf16 pending leaf's or one dtype's."""
    assert common.EF_DTYPES is build.EF_DTYPES
    libs = {"quantize_ef_batched": "quantize_ef",
            "select_pack_ef_batched": "topk_pack",
            "residual_ef_batched": "lowrank_ef"}
    for name, table in common.EF_DTYPES.items():
        bound = {f for f in build.SIGNATURES[libs[name]]
                 if f.startswith(name + "_")}
        assert bound == {f"{name}_{s}" for s in table.values()}
        for key, suffix in table.items():
            assert key[0] == BF16 or len(set(key)) == 1, key
            assert suffix.startswith(common.STAGED_DTYPES[key[0]])
    assert set(common.EF_DTYPES["residual_ef_batched"]) == {
        (F32,) * 3, (F64,) * 3, *((BF16,) + pq for pq in B11_PAIRS.values())}


def test_launch_counts_each_launcher(monkeypatch):
    """``build.launch`` ticks ``common.LAUNCHERS`` once per call, under the
    C launcher's name (a fake library and stream stand in for the card),
    and ``reset_launches`` zeroes it with ``LAUNCHES``."""
    class _Lib:
        def __getattr__(self, fn):
            return lambda *args: 0           # cudaSuccess

    class _Stream:
        cuda_stream = None

    monkeypatch.setattr(build, "library", lambda name: _Lib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    card = torch.device("cuda", 0)
    for fn in ("quantize_ef_batched_bf16_f32", "residual_ef_batched_bf16",
               "residual_ef_batched_bf16"):
        build.launch("x", fn, card)
    assert {f: c for f, c in common.LAUNCHERS.items() if c} == {
        "quantize_ef_batched_bf16_f32": 1, "residual_ef_batched_bf16": 2}
    assert not any(common.LAUNCHES.values())   # the wrappers count those
    common.reset_launches()
    assert not any(common.LAUNCHERS.values())


H100_SMS = 132
#: (M, n): B7a's two designs (``common.sqnorm_path``), rows of a multiple
#: of 8 elements and not, tall banks of short rows
SHAPES = [(4, 4099), (9, 33), (1000, 16), (2000, 16), (100_000, 16)]


@pytest.fixture
def on_h100(monkeypatch):
    """The wrappers past the dispatch rule as on an H100: meta tensors count
    as on the card, and each ``launch`` is recorded, not run."""
    calls = []
    for mod in (quantize_ef, topk_pack, lowrank_ef):
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


@pytest.mark.parametrize("m,n", SHAPES)
def test_each_wrapper_launches_its_bf16_launcher(on_h100, m, n):
    """On meta tensors: each wrapper calls the launcher of its operand
    dtypes (B7a: of the design ``common.sqnorm_path`` picks), bound in
    ``build.SIGNATURES`` with the C definition's arity, one count a call:
    9 launchers a shape (B7a's other design: the test below)."""
    p, mask = _meta((m, n), BF16), _meta((m,), F32)
    sq = common.sqnorm_path(m, n, H100_SMS)
    calls = [(lambda: quantize_ef.absmax_batched(p), "quantize_ef",
              "absmax_batched",
              f"absmax_batched{'_warp' if sq == 'warp' else ''}_bf16")]
    for err, e_dt in ERRS.items():
        e = _meta((m, n), e_dt)
        suffix = "bf16" if err == "bf16" else "bf16_f32"
        calls += [
            (lambda e=e: quantize_ef.quantize_ef_batched(p, e, mask, mask),
             "quantize_ef", "quantize_ef_batched",
             f"quantize_ef_batched_{suffix}"),
            (lambda e=e: topk_pack.select_pack_ef_batched(p, e, p, mask),
             "topk_pack", "select_pack_ef_batched",
             f"select_pack_ef_batched_{suffix}")]
    for pair, (q_dt, e_dt) in B11_PAIRS.items():
        q, e = _meta((m, n), q_dt), _meta((m, n), e_dt)
        suffix = "bf16" if pair == "bf16" else \
            f"bf16_{common.STAGED_DTYPES[q_dt]}_{common.STAGED_DTYPES[e_dt]}"
        calls.append((lambda q=q, e=e: lowrank_ef.residual_ef_batched(
            p, q, e, mask), "lowrank_ef", "residual_ef_batched",
            f"residual_ef_batched_{suffix}"))
    for call, lib, base, fn in calls:
        on_h100.clear()
        common.reset_launches()
        out = call()
        outs = out if isinstance(out, tuple) else (out,)
        assert all(x.dtype == BF16 for x in outs)
        assert on_h100 == [(lib, fn, len(build.SIGNATURES[lib][fn]) - 2)]
        assert len(build.SIGNATURES[lib][fn]) == _c_arity(lib, fn)
        assert common.LAUNCHES[base] == 1
        assert sum(common.LAUNCHES.values()) == 1
    assert len({c[3] for c in calls}) == 9


@pytest.mark.parametrize("design", ["two_pass", "warp"])
def test_each_absmax_design_has_its_bf16_launcher(on_h100, design):
    """The design a caller names (the card's checks call both) reaches its
    bf16 launcher; an unknown design raises before any launch."""
    x = _meta((2000, 16), BF16)
    out = quantize_ef.absmax_on_card(x, design)
    assert out.dtype == BF16
    fn = "absmax_batched" + ("_warp" if design == "warp" else "") + "_bf16"
    assert [c[1] for c in on_h100] == [fn]
    with pytest.raises(ValueError, match="path must be one of"):
        quantize_ef.absmax_on_card(x, "chunked")
    assert len(on_h100) == 1


# ------------------------------------------------ top-k keep sets in bf16
def _tied_rows(m, n, seed):
    """bf16 rows salted with ties: values drawn from 9 magnitudes (so the
    k-th largest ties many entries), both signs, +0.0 and -0.0 among
    them."""
    rng = np.random.default_rng(seed)
    mags = np.array([0.0, 0.0, 0.5, 1.0, 1.0, 1.5, 2.0, 2.0, 3.0],
                    np.float32)
    x = rng.choice(mags, size=(m, n)) * rng.choice([-1.0, 1.0], size=(m, n))
    x = x.astype(np.float32)
    x[:, ::3] = np.where(x[:, ::3] == 0, -0.0, x[:, ::3])
    # bf16 rounds these two f32 values to one: a tie made by the cast
    x[:, 1] = 1.0 + 2.0 ** -10
    x[:, 2] = -(1.0 + 2.0 ** -11)
    return torch.from_numpy(x).to(BF16)


@pytest.mark.parametrize("k", [1, 17, 41, 100])
@pytest.mark.parametrize("m,n", [(1, 64), (4, 100), (3, 257)])
def test_bf16_keep_sets_equal_lax_top_k(m, n, k):
    """``transport.tree_topk_keep`` on bf16 rows with ties and signed zeros
    keeps exactly ``lax.top_k``'s set (lowest index wins a tie, -0.0 ties
    +0.0), batched and by row, in bf16."""
    x = _tied_rows(m, n, seed=m * 1000 + n + k)
    tree = {"a": x, "b": x[:, :7]}
    got = transport.tree_topk_keep(tree, k)
    want = j_transport.tree_topk_keep(_jt(tree), k)
    for name in tree:
        assert got[name].dtype == BF16
        _exact(got[name], want[name])
        assert int(got[name].float().sum()) == m * min(k, tree[name][0]
                                                       .numel())
    row = transport.tree_topk_keep_row({"a": x[m - 1]}, k)["a"]
    _exact(row, j_transport.tree_topk_keep_row({"a": _j(x[m - 1])}, k)["a"])
    _exact(row, got["a"][m - 1])


# --------------------------------------- one step against the JAX package
SHAPES_TREE = {"w": (3, 40), "b": (17,)}
M = 5
#: (params dtype, the state's err dtype): f32 params over a bf16 bank with
#: transport.init's f32 err (the first step) and with a bf16 one (every
#: later ``cuda`` step), and bf16 params
PAIRS = {"f32_bf16_f32": (F32, F32), "f32_bf16": (F32, BF16),
         "bf16": (BF16, BF16)}
TRANSPORTS = {"int8": {"quantize": "int8"},
              "topk": {"transport": "topk", "k": 11},
              "lowrank": {"transport": "lowrank", "rank": 2}}
#: low-rank against JAX: the factor products of the two packages sum in
#: other orders (f32: ~1e-6 relative), and a bf16 result near a rounding
#: boundary then rounds the other way: LR_UNITS bf16 unit roundoffs of
#: |pending| + |payload| for err' (pending - payload) and of that plus
#: |ghat'| for the bank (ghat + payload), LR_RTOL for f32 outputs
LR_UNITS = 4
LR_RTOL = 1e-4


def _tree_inputs(p_dt, e_dt, seed=0):
    """theta^k, theta^{k-1}, ghat (bf16), err (``e_dt``) and the (M, ...)
    gradients as numpy f32 draws cast to their dtypes; the bank sits near
    the gradients so that eq. (8) censors some workers."""
    rng = np.random.default_rng(seed)
    mk = lambda s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    theta = {k: mk(s) for k, s in SHAPES_TREE.items()}
    prev = {k: v + 0.3 * mk(v.shape) for k, v in theta.items()}
    scale = (0.5 ** np.arange(M)).astype(np.float32)
    grads = {k: mk((M,) + s) for k, s in SHAPES_TREE.items()}
    ghat = {k: g + scale.reshape((M,) + (1,) * len(s)) * mk(g.shape)
            for (k, s), g in zip(SHAPES_TREE.items(), grads.values())}
    err = {k: 0.05 * scale.reshape((M,) + (1,) * len(s)) * mk((M,) + s)
           for k, s in SHAPES_TREE.items()}
    cast = lambda tree, dt: {k: torch.from_numpy(v).to(dt)   # noqa: E731
                             for k, v in tree.items()}
    return (cast(theta, p_dt), cast(prev, p_dt), cast(ghat, BF16),
            cast(grads, p_dt), cast(err, e_dt))


def _optimizers(p_dt, kw):
    bank = {} if p_dt == BF16 else {"bank_dtype": BF16}
    jbank = {} if p_dt == BF16 else {"bank_dtype": jnp.bfloat16}
    port = {b: opt.make("chb", ALPHA, M, eps1=EPS1, beta=BETA, backend=b,
                        **kw, **bank) for b in ("reference", "cuda")}
    jax_ = {b: j_opt.make("chb", ALPHA, M, eps1=EPS1, beta=BETA, backend=b,
                          **kw, **jbank) for b in ("reference", "pallas")}
    return port, jax_


def _with_err(err_tree, state_err):
    """The transport's state with its EF bank replaced by ``err_tree``."""
    if isinstance(state_err, dict) and "q" in state_err:
        return {"err": err_tree, "q": state_err["q"]}
    return err_tree


def _states(port, jax_, theta, prev, ghat, err):
    sp = port["reference"].init(theta)
    sp = sp._replace(prev_params=prev, ghat=ghat,
                     err=_with_err(err, sp.err))
    js = jax_["reference"].init(_jt(theta))
    js = js._replace(prev_params=_jt(prev), ghat=_jt(ghat),
                     err=_with_err(_jt(err), js.err))
    return sp, js


def _run_step(route, o, state, theta, grads, kernels):
    """One step of ``route`` (either package: ``kernels`` is its fused-step
    module, for ``force_staged``): ``(state', theta', stats)``."""
    if route == "shard":
        new_state, partial, st = o.shard_step(state, theta, grads)
        return new_state, o.apply_server(theta, state.prev_params,
                                         partial), st
    with kernels.force_staged():
        return o.step(state, theta, grads)


def _ef_leaves(err):
    """The EF bank of a transport's state (low-rank's beside its
    factors)."""
    return err["err"] if isinstance(err, dict) and "q" in err else err


def _margin(dsq, ssq, eps1=EPS1) -> float:
    thr = eps1 * np.asarray(ssq, np.float64)
    dsq = np.asarray(dsq, np.float64)
    return float((np.abs(dsq - thr) / thr).min())


ROUTE_CASES = [(r, t, p) for r in ("staged", "shard") for t in TRANSPORTS
               for p in PAIRS]


@pytest.mark.parametrize("route,tkind,pair", ROUTE_CASES,
                         ids=[f"{r}-{t}-{p}" for r, t, p in ROUTE_CASES])
def test_one_step_matches_jax(route, tkind, pair):
    """int8 under ``force_staged()``, top-k and low-rank (``step``) and
    their ``shard_step`` + ``apply_server``, one step from one state on the
    port's two backends and JAX's two (see the module docstring)."""
    p_dt, e_dt = PAIRS[pair]
    port, jax_ = _optimizers(p_dt, TRANSPORTS[tkind])
    theta, prev, ghat, grads, err = _tree_inputs(p_dt, e_dt,
                                                 seed=len(route) + len(tkind))
    sp, js = _states(port, jax_, theta, prev, ghat, err)
    out = {b: _run_step(route, o, sp, theta, grads, fused_step)
           for b, o in port.items()}
    jout = {b: _run_step(route, o, js, _jt(theta), _jt(grads), j_fused)
            for b, o in jax_.items()}
    st = out["reference"][2]
    assert _margin(st.delta_sq.numpy(), st.step_sq.numpy()) > 1e-3
    stats = [o[2] for o in out.values()] + [o[2] for o in jout.values()]
    for s in stats[1:]:
        np.testing.assert_array_equal(np.asarray(s.mask),
                                      stats[0].mask.numpy())
    assert 0 < float(stats[0].mask.sum()) < M
    states = {**{("port", b): o[0] for b, o in out.items()},
              **{("jax", b): o[0] for b, o in jout.items()}}
    base = states["port", "reference"]
    for s in states.values():
        for f in ("uplink_count", "uplink_mib", "uplink_rem",
                  "downlink_count", "iterations"):
            np.testing.assert_array_equal(np.asarray(getattr(s.comm, f)),
                                          getattr(base.comm, f).numpy(),
                                          err_msg=f)
    # err' in each backend's dtype: the reference's promotes low-rank's f32
    # payload, the kernels write the pending dtype (bf16)
    ref_e = _ef_leaves(out["reference"][0].err)
    cuda_e = _ef_leaves(out["cuda"][0].err)
    jref_e = _ef_leaves(jout["reference"][0].err)
    jpal_e = _ef_leaves(jout["pallas"][0].err)
    # matrix leaves: a vector leaf ships dense, its payload the pending's
    promoted = {k: tkind == "lowrank" and p_dt == F32 and len(s) >= 2
                for k, s in SHAPES_TREE.items()}
    assert any(promoted.values()) == (tkind == "lowrank" and p_dt == F32)
    for k in SHAPES_TREE:
        assert ref_e[k].dtype == (F32 if promoted[k] else BF16)
        assert cuda_e[k].dtype == BF16
        assert np.asarray(jref_e[k]).dtype == np.dtype(_J[ref_e[k].dtype])
        assert np.asarray(jpal_e[k]).dtype == np.dtype(jnp.bfloat16)
        for (pkg, _), s in states.items():
            assert (s.ghat[k].dtype == BF16 if pkg == "port" else
                    np.asarray(s.ghat[k]).dtype == np.dtype(jnp.bfloat16))
    if tkind == "lowrank":
        for s in (out["reference"][0], out["cuda"][0]):
            assert all(q.dtype == p_dt for q in s.err["q"].values())
        assert all(np.asarray(q).dtype == np.dtype(_J[p_dt])
                   for q in jout["pallas"][0].err["q"].values())
    pend = {k: (grads[k].to(BF16) - ghat[k]) + err[k].to(BF16)
            for k in SHAPES_TREE}
    for k in SHAPES_TREE:
        # the port's two backends: one bank, err' bit for bit (low-rank on
        # f32 params: within one bf16 rounding, f32 against bf16)
        _exact(out["cuda"][0].ghat[k], out["reference"][0].ghat[k])
        if promoted[k]:
            payload = out["reference"][0].ghat[k].float() - ghat[k].float()
            bound = ONE_ROUNDING * (np.abs(_f64(pend[k]))
                                    + np.abs(_f64(payload)) + 1e-30)
            _within(cuda_e[k], ref_e[k], bound)
        else:
            _exact(cuda_e[k], ref_e[k])
    _check_against_jax(tkind, p_dt, out, jout, pend, ghat, theta, prev)


def _check_against_jax(tkind, p_dt, out, jout, pend, ghat, theta, prev):
    """The port's backends against JAX's: int8 and top-k bit for bit
    against JAX's reference (eager) and within the interpreted kernels'
    bound against its pallas route; low-rank within LR_UNITS / LR_RTOL;
    theta as the module docstring says."""
    pairs = (("reference", "reference"), ("cuda", "pallas"))
    for mine, theirs in pairs:
        s, js = out[mine][0], jout[theirs][0]
        e, je = _ef_leaves(s.err), _ef_leaves(js.err)
        for k in SHAPES_TREE:
            if tkind == "lowrank":
                # err' = pending - payload, ghat' = ghat + payload: the
                # payload's carry and their own rounding (the bank's |ghat'|)
                carry = np.abs(_f64(pend[k])) + np.abs(
                    _f64(s.ghat[k]) - _f64(ghat[k]))
                for a, b, scale in (
                        (s.ghat[k], js.ghat[k],
                         carry + np.abs(_f64(s.ghat[k]))),
                        (e[k], je[k], carry)):
                    if a.dtype == BF16:
                        _within(a, b, LR_UNITS * U_BF16 * scale)
                    else:
                        _within(a, b, LR_RTOL * scale)
                continue
            _exact(s.ghat[k], js.ghat[k])
            if mine == "reference":
                _exact(e[k], je[k])
            else:   # |payload| <= |pending| + one int8 code step
                p = np.abs(_f64(pend[k]))
                step = p.reshape(M, -1).max(axis=1).reshape(
                    (M,) + (1,) * (p.ndim - 1)) / 127
                _within(e[k], je[k], EXCESS_UNITS * U_BF16 * (2 * p + step))
        for k in SHAPES_TREE:
            got, want = out[mine][1][k], jout[theirs][1][k]
            assert got.dtype == p_dt
            t, tp = _f64(theta[k]), _f64(prev[k])
            agg = np.abs(_f64(s.ghat[k])).sum(axis=0)
            terms = np.abs(t) + ALPHA * agg + BETA * np.abs(t - tp)
            if tkind == "lowrank":
                bank = LR_UNITS * U_BF16 * (
                    np.abs(_f64(pend[k])) + np.abs(_f64(s.ghat[k]))
                    + np.abs(t).max()).sum(axis=0)
            else:
                bank = 0.0
            unit = EQ4_UNITS * U_BF16 if p_dt == BF16 else 4 * U32
            exact = p_dt == F32 and mine == "reference" and tkind != "lowrank"
            if exact:
                _exact(got, want)
            else:
                _within(got, want, unit * terms + ALPHA * bank)
    # bf16 params: the kernels' eq. (4) in f32 against the reference's in
    # bf16; f32 params: the same f32 arithmetic on the same bank
    for k in SHAPES_TREE:
        got, want = out["cuda"][1][k], out["reference"][1][k]
        if p_dt == F32:
            _exact(got, want)
        else:
            t, tp = _f64(theta[k]), _f64(prev[k])
            agg = np.abs(_f64(out["cuda"][0].ghat[k])).sum(axis=0)
            terms = np.abs(t) + ALPHA * agg + BETA * np.abs(t - tp)
            _within(got, want, EQ4_UNITS * U_BF16 * terms)


# ---------------------------------------- the repaired low-rank products
def test_lowrank_products_promote_as_jnp_matmul():
    """``_power_iter_slice`` on a bf16 pending slice and f32 factors: each
    product in f32 (``torch.matmul`` alone refuses the pair), P, Q' and the
    reconstruction f32 and within LR_RTOL of JAX's; one dtype keeps its
    bits (no cast)."""
    rng = np.random.default_rng(3)
    mat = torch.from_numpy(rng.standard_normal((6, 5)).astype(
        np.float32)).to(BF16)
    q = torch.eye(5, 2)
    with pytest.raises(RuntimeError):
        mat @ q
    recon, q_new = transport._power_iter_slice(mat, q)
    jrecon, jq = j_transport._power_iter_slice(_j(mat), _j(q))
    assert recon.dtype == q_new.dtype == F32
    assert np.asarray(jrecon).dtype == np.asarray(jq).dtype == np.float32
    for a, b in ((recon, jrecon), (q_new, jq)):
        np.testing.assert_allclose(_f64(a), _f64(b), rtol=LR_RTOL,
                                   atol=LR_RTOL * np.abs(_f64(b)).max())
    for dt in (BF16, F32):
        m2, q2 = mat.to(dt), q.to(dt)
        want = m2 @ q2
        assert transport._matmul(m2, q2).dtype == dt
        assert torch.equal(transport._matmul(m2, q2).view(_INT[dt]),
                           want.view(_INT[dt]))


D_EDGE, M_EDGE, EPS1_EDGE = 24, 6, 4.0


def _edge_tasks(p_dt, matrix=False):
    """The edge quadratics in ``p_dt``; ``matrix``: theta as a (4, 6)
    matrix leaf (low-rank factors it), the same objective."""
    jt = j_edge.make_edge_quadratics(m=M_EDGE, d=D_EDGE, seed=0)
    jt = jt._replace(init_params=jt.init_params.astype(_J[p_dt]),
                     worker_data=tuple(x.astype(_J[p_dt])
                                       for x in jt.worker_data))
    pt = edge_tasks.make_edge_quadratics(m=M_EDGE, d=D_EDGE, seed=0,
                                         device="cpu", dtype=p_dt)
    if not matrix:
        return jt, pt
    shape = (4, D_EDGE // 4)

    def wrap(task, lead):
        # JAX's grad_fn is one worker's (the package vmaps it), the port's
        # the (M, ...) batch
        g0, l0 = task.grad_fn, task.loss_fn
        return task._replace(
            init_params=task.init_params.reshape(shape),
            grad_fn=lambda th, d: g0(th.reshape(D_EDGE), d).reshape(
                lead + shape),
            loss_fn=lambda th, d: l0(th.reshape(D_EDGE), d))
    return wrap(jt, ()), wrap(pt, (-1,))


def _theta_close(p_dt, got, want, theta0) -> None:
    """theta after the runtimes' rounds: EQ4_UNITS bf16 roundings (bf16
    params) or 4 u32 (f32 params) of the largest term of eq. (4)."""
    a, b = _f64(got), _f64(want)
    scale = np.abs(b).max() + np.abs(_f64(theta0)).max()
    unit = EQ4_UNITS * U_BF16 if p_dt == BF16 else 4 * U32
    assert np.abs(a - b).max() <= 2 * unit * scale


EDGE_CASES = [(t, p) for t in TRANSPORTS for p in ("f32_bf16", "bf16")]


@pytest.mark.parametrize("tkind,pair", EDGE_CASES,
                         ids=[f"{t}-{p}" for t, p in EDGE_CASES])
def test_run_edge_rounds_match_jax(tkind, pair):
    """``fed.run_edge`` under ``sync_config``, two rounds, with the row
    entry points of int8, top-k and low-rank (a (4, 6) matrix leaf, whose
    factor products of f32 params over a bf16 bank run in f32), both port
    backends against JAX's ``reference``: masks, counters and bytes exact;
    theta within the runtimes' bound (low-rank: the bank's bf16 rounding
    flips that the factor products' summation order causes)."""
    p_dt = BF16 if pair == "bf16" else F32
    jt, pt = _edge_tasks(p_dt, matrix=tkind == "lowrank")
    kw = TRANSPORTS[tkind]
    bank = {} if p_dt == BF16 else {"bank_dtype": BF16}
    jbank = {} if p_dt == BF16 else {"bank_dtype": jnp.bfloat16}
    port = {b: opt.make("chb", 0.5 / M_EDGE, M_EDGE, eps1=EPS1_EDGE,
                        backend=b, **kw, **bank)
            for b in ("reference", "cuda")}
    jo = j_opt.make("chb", 0.5 / M_EDGE, M_EDGE, eps1=EPS1_EDGE, **kw,
                    **jbank)
    hists = {b: fed.run_edge(o, pt, fed.sync_config(M_EDGE), 2,
                             device="cpu") for b, o in port.items()}
    jh = j_fed.run_edge(jo, jt, j_fed.sync_config(M_EDGE), 2)
    for h in hists.values():
        for f in ("mask", "comm_cum", "bytes_cum"):
            np.testing.assert_array_equal(np.asarray(getattr(h, f)),
                                          np.asarray(getattr(jh, f)),
                                          err_msg=f)
        assert h.stats.as_dict() == jh.stats.as_dict()
        assert h.final_bank.dtype == BF16
        if tkind == "lowrank":
            # the factor products' summation order moves a payload entry
            # by ~1e-6 relative, and a bf16 bank entry near a rounding
            # boundary then takes the other bf16 value: alpha times one
            # bf16 unit of the bank a worker, each of the two rounds, with
            # the momentum's carry
            bound = 2 * (1 + port["cuda"].beta) * port["cuda"].alpha \
                * M_EDGE * 2 * U_BF16 * np.abs(_f64(h.final_bank)).max()
            assert np.abs(_f64(h.final_params)
                          - _f64(jh.final_params)).max() <= bound
        else:
            _theta_close(p_dt, h.final_params, jh.final_params,
                         pt.init_params)
    # the row paths are plain torch on both backends (B8 at M = 1 on
    # cuda); bf16 params: the backends' theta^1 differ (B3)
    a, b = (hists[k] for k in ("cuda", "reference"))
    if p_dt == F32:
        assert torch.equal(a.final_bank.view(torch.int16),
                           b.final_bank.view(torch.int16))
        assert torch.equal(a.final_params, b.final_params)
    assert 0 < int(jh.comm_cum[-1]) <= 2 * M_EDGE


@pytest.mark.parametrize("pair", ["f32_bf16", "bf16"])
def test_run_mesh_int8_rounds_match_jax(pair):
    """``fed.run_mesh`` with int8 over one and two CPU shards (``shard_step``
    on the staged int8 kernels' plain versions on ``cuda``), the lossy
    scenario, two rounds, both port backends against JAX's over one
    device: masks, cohorts and bytes exact; theta at one shard within the
    runtimes' bound, and the port's two backends' theta bit for bit for
    f32 params."""
    p_dt = BF16 if pair == "bf16" else F32
    jt, pt = _edge_tasks(p_dt)
    kw = TRANSPORTS["int8"]
    bank = {} if p_dt == BF16 else {"bank_dtype": BF16}
    jbank = {} if p_dt == BF16 else {"bank_dtype": jnp.bfloat16}
    port = {b: opt.make("chb", 0.5 / M_EDGE, M_EDGE, eps1=EPS1_EDGE,
                        backend=b, **kw, **bank)
            for b in ("reference", "cuda")}
    jo = j_opt.make("chb", 0.5 / M_EDGE, M_EDGE, eps1=EPS1_EDGE, **kw,
                    **jbank)
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


# ------------------------- runs the JAX scan refuses, held step by step
#: eq. (8)'s sums against jitted JAX, where XLA keeps the bf16 pending
#: unrounded in f32: each delta d is rounded or not, d(1 + r) with
#: |r| <= 2^-8, so each square moves by at most (2^-7 + 2^-16) d^2
DSQ_RTOL = 2.0 ** -7 + 2.0 ** -16 + 1e-5
LOCKSTEP_ITERS = 12


def _to_jax_state(state, j_state0):
    """The port's OptState as the JAX package's (its leaves' dtypes)."""
    leaves = jax.tree_util.tree_leaves(
        (state.prev_params, state.ghat, state.err, tuple(state.comm),
         state.censor))
    j_leaves, treedef = jax.tree_util.tree_flatten(j_state0)
    assert len(leaves) == len(j_leaves)
    return jax.tree_util.tree_unflatten(treedef, [_j(x) for x in leaves])


def _dsq_margin(o, stats) -> float:
    thr = float(o.eps1) * float(stats.step_sq)
    if thr <= 0:
        return float("inf")
    return float(((stats.delta_sq.double() - thr).abs() / thr).min())


LOCKSTEP_CASES = [(t, b) for t in TRANSPORTS for b in ("reference", "cuda")]


@pytest.mark.parametrize("tkind,backend", LOCKSTEP_CASES,
                         ids=[f"{t}-{b}" for t, b in LOCKSTEP_CASES])
def test_f32_params_on_a_bf16_bank_held_step_by_step(tkind, backend):
    """f32 params over a bf16 bank, int8 (``force_staged()`` on ``cuda``),
    top-k and low-rank (a matrix leaf) on the edge quadratics, which the
    JAX package's ``simulator.run`` refuses (err changes dtype across its
    scan; low-rank on ``pallas`` only). The port's ``simulator.run``; at
    every iteration JAX's jitted step from the port's state (``pallas``
    against ``cuda``): dsq within DSQ_RTOL, masks and counters exact where
    every decision clears its threshold by more than DSQ_RTOL; ghat' and
    err' within two bf16 roundings of |ghat| + |pending| plus, for int8,
    one code step a worker (a pending value on a rounding boundary of
    XLA's f32 pending takes the other code) and, for top-k, the entries
    whose keep decision differs (each at most |pending|); theta within
    alpha M times that plus 4 u32 of eq. (4)'s terms."""
    from repro.core import simulator as j_simulator
    from repro_torch.core import simulator
    jt, pt = _edge_tasks(F32, matrix=tkind == "lowrank")
    kw = TRANSPORTS[tkind]
    o = opt.make("chb", 0.5 / M_EDGE, M_EDGE, eps1=EPS1_EDGE,
                 backend=backend, bank_dtype=BF16, **kw)
    jo = j_opt.make("chb", 0.5 / M_EDGE, M_EDGE, eps1=EPS1_EDGE,
                    backend="pallas" if backend == "cuda" else "reference",
                    bank_dtype=jnp.bfloat16, **kw)
    if tkind != "lowrank" or backend == "cuda":
        with pytest.raises(TypeError, match="carry"):
            j_simulator.run(jo, jt, 2)
    jstep = jax.jit(jo.step)
    grad = jax.vmap(jt.grad_fn, in_axes=(None, 0))
    seen = {"held": 0, "swapped": 0}

    class Lockstep:
        def init(self, params):
            return o.init(params)

        def step(self, state, params, grads):
            ctx = fused_step.force_staged() if backend == "cuda" \
                else contextlib.nullcontext()
            with ctx:
                out = o.step(state, params, grads)
            new_state, new_params, stats = out
            js, jp, jst = jstep(_to_jax_state(state, jo.init(_j(params))),
                                _j(params), grad(_j(params), jt.worker_data))
            np.testing.assert_allclose(stats.delta_sq.numpy(),
                                       np.asarray(jst.delta_sq),
                                       rtol=DSQ_RTOL)
            if _dsq_margin(o, stats) <= DSQ_RTOL:
                return out
            seen["held"] += 1
            np.testing.assert_array_equal(stats.mask.numpy(),
                                          np.asarray(jst.mask))
            for a, b in zip(new_state.comm, js.comm):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            err0 = _ef_leaves(state.err)
            h = _f64(state.ghat)
            pend = _f64(grads.to(BF16)) - h + _f64(err0.to(BF16))
            tol = 2 * U_BF16 * (np.abs(h) + np.abs(pend)) + 1e-30
            if tkind == "int8":
                tol = tol + 2 * np.abs(pend).reshape(M_EDGE, -1).max(
                    axis=1).reshape((M_EDGE,) + (1,) * (pend.ndim - 1)) / 127
            if tkind == "lowrank":
                tol = tol + LR_UNITS * U_BF16 * np.abs(pend)
            for a, b in ((new_state.ghat, js.ghat),
                         (_ef_leaves(new_state.err),
                          _ef_leaves(js.err))):
                assert a.dtype == _torch_dtype(b)
                gap = np.abs(_f64(a) - _f64(b))
                if tkind == "topk":   # an entry kept on one side only
                    swapped = gap > tol
                    seen["swapped"] += int(swapped.sum())
                    tol_k = np.where(swapped, np.abs(pend) * (1 + 2 * U_BF16)
                                     + tol, tol)
                    assert np.all(gap <= tol_k)
                else:
                    assert np.all(gap <= tol)
            t, tp = _f64(params), _f64(state.prev_params)
            terms = np.abs(t) + o.alpha * np.abs(
                _f64(new_state.ghat)).sum(axis=0) + o.beta * np.abs(t - tp)
            bank = (tol + (np.abs(pend) if tkind == "topk" else 0)).sum(
                axis=0)
            assert np.all(np.abs(_f64(new_params) - _f64(jp))
                          <= o.alpha * bank + 4 * U32 * terms)
            return out

    hist = simulator.run(Lockstep(), pt, LOCKSTEP_ITERS, device="cpu")
    assert seen["held"] >= LOCKSTEP_ITERS - 2, seen
    assert int(hist.final_state.comm.uplink_count.sum()) \
        == int(hist.comm_cum[-1]) > 0
    assert hist.final_state.ghat.dtype == BF16


def _torch_dtype(x):
    return {np.dtype(jnp.bfloat16): BF16, np.dtype(np.float32): F32,
            np.dtype(np.float64): F64}[np.asarray(x).dtype]
