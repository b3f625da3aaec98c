"""B10, B9, B4, B7b, B1, B8, B5 and B7a on tall worker banks
(``kernels/csrc/topk_pack.cu``, ``kernels/csrc/censor.cu``,
``kernels/csrc/fused_step.cu``, ``kernels/csrc/quantize_ef.cu``), on the
CPU.

B10 (top-k select/pack + EF), B9 (the bank advance by a payload), B4 (the
bank advance by the raw gradient) and B7b (the staged int8 round trip +
EF) have one design each, tiled over workers and columns like B2's tall
pass 1, so they need no picker. B1 (the eq.-(8) censor norm), B8 (the norm of a
pending delta), B5 (the int8 step's norm and abs-max) and B7a (the staged
int8 step's abs-max) have two, which their wrappers pick by shape with one
rule (``common.sqnorm_path``): one launch for rows of one reduction chunk
on many workers (a warp a worker; B7a a power-of-two segment of a warp's
lanes a worker); elsewhere the two-pass design (a block a (chunk,
worker), then a block a worker over the partials). The kernels run only
on the card (``tests/test_torch_cuda.py`` and ``chip_smoke.py``'s phase
tall_paths hold the designs against each other there); here:

  * the picker at the full-width shape (M = 4, n = 163,597,056), Fig. 11's
    (M = 9, n = 50), the fed-mesh frontier and ladder top (M = 10^5 and
    10^6, n = 16), each side of its worker threshold and of the chunk's
    2048 elements; the threshold moves with the card's SM count; an
    unknown design or a row too wide for the warp design is refused before
    any launch;
  * the wrappers of B1, B8, B5 and B7a past the dispatch rule (meta
    tensors, ``launch`` recorded): the launcher of the picked design, and
    the one launcher of B9, B4 and B7b at every picker shape, bound in
    ``build.SIGNATURES`` with the arity its C definition has, one count a
    call;
  * the plain versions at tall shapes, salted with -0.0, NaN and +-inf, in
    f32 and f64, against the JAX package's oracles (``repro/kernels/ref.py``)
    and Pallas kernels (interpret mode), with ``test_torch_kernels.py``'s
    tolerances: B10, B9, B4, B7a and B7b's payload exact (-0.0 included,
    +0 for a row of -0.0; NaN where NaN), B7b's err' exact against the
    oracle and the f64 kernel and within 4 eps |pending| of the f32
    kernel (XLA contracts an FMA there, as ``test_torch_staged.py``
    says), B4 equal to B2's ghat' and B7b's err' to B6's (the plain
    versions), B1, B8 and B5's sums within rel 1e-5 (both sides
    accumulate in f32, in other orders; NaN where NaN), B5's abs-max exact
    (NaN where NaN).
"""
import re

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels import censor as j_censor  # noqa: E402
from repro.kernels import fused_step as j_fused  # noqa: E402
from repro.kernels import quantize_ef as j_quant  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels import topk_pack as j_topk  # noqa: E402
from repro_torch.core.quantize import int8_scale  # noqa: E402
from repro_torch.kernels import (build, censor, common,  # noqa: E402
                                 fused_step, quantize_ef, ref, topk_pack)
from repro_torch.kernels.build import REDUCE_CHUNK  # noqa: E402

H100_SMS = 132
T = common.warp_rows_min_workers(H100_SMS)     # 1056 workers


PICKER_CASES = [
    (4, 163_597_056, "two_pass"),       # full width, chb-paper-lm-124m
    (9, 50, "two_pass"),                # Fig. 11's linreg
    (100_000, 16, "warp"),              # the fed-mesh frontier
    (70_000, 16, "warp"),               # its staged and top-k steps
    (12_500, 16, "warp"),               # a shard of it at K = 8
    (1_000_000, 16, "warp"),            # fed_mesh.py's ladder top
    (70_000, 2049, "two_pass"),         # two chunks a row
    (1, 16, "two_pass"),                # an M=1 row call
    (T, 16, "two_pass"),
    (T + 1, 16, "warp"),
    (T + 1, REDUCE_CHUNK, "warp"),
    (T + 1, REDUCE_CHUNK + 1, "two_pass"),
    (T, REDUCE_CHUNK, "two_pass"),
]


@pytest.mark.parametrize("m,n,path", PICKER_CASES)
def test_sqnorm_path_by_shape(m, n, path):
    assert common.sqnorm_path(m, n, H100_SMS) == path


def _b1(x):
    return censor.censor_delta_sqnorm_batched(x, x)


def _b5(x):
    return fused_step.int8_stats_batched(x, x, x)


# wrapper: (call on one (M, n) operand, library, C launcher base name)
WRAPPERS = {"B1": (_b1, "censor", "censor_delta_sqnorm_batched"),
            "B8": (censor.sqnorm_batched, "censor", "sqnorm_batched"),
            "B5": (_b5, "fused_step", "int8_stats_batched"),
            "B7a": (quantize_ef.absmax_batched, "quantize_ef",
                    "absmax_batched")}


@pytest.fixture
def on_h100(monkeypatch):
    """The wrappers past the dispatch rule as on an H100: meta tensors
    count as on the card, and each ``launch`` is recorded, not run."""
    calls = []
    for mod in (censor, fused_step, quantize_ef):
        monkeypatch.setattr(mod, "on_card", lambda name, *ts: True)
        monkeypatch.setattr(mod, "sm_count", lambda index: H100_SMS)
        monkeypatch.setattr(mod, "launch", lambda lib, fn, dev, *args:
                            calls.append((lib, fn, len(args))))
    common.reset_launches()
    return calls


def _c_arity(lib: str, fn: str) -> int:
    """Parameters of the C launcher ``fn`` as ``csrc/<lib>.cu`` defines
    it (the device and stream included)."""
    src = (build.CSRC / f"{lib}.cu").read_text()
    found = re.search(rf"\bint {fn}\(([^)]*)\)", src)
    assert found, f"{fn} is not defined in {lib}.cu"
    return len(found.group(1).split(","))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("kernel", WRAPPERS)
@pytest.mark.parametrize("m,n,path", PICKER_CASES)
def test_wrapper_launches_the_picked_design(on_h100, kernel, m, n, path,
                                            dtype):
    call, lib, base = WRAPPERS[kernel]
    call(torch.empty((m, n), dtype=dtype, device="meta"))
    suffix = common.KERNEL_DTYPES[dtype]
    fn = f"{base}_warp_{suffix}" if path == "warp" else f"{base}_{suffix}"
    assert len(on_h100) == 1 and on_h100[0][:2] == (lib, fn)
    argtypes = build.SIGNATURES[lib][fn]
    assert len(argtypes) == on_h100[0][2] + 2 == _c_arity(lib, fn)
    assert common.LAUNCHES[base] == 1
    assert sum(common.LAUNCHES.values()) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("m,n,_path", PICKER_CASES)
def test_bank_advance_launches_its_one_design(on_h100, m, n, _path, dtype):
    """B9 has one design (B10's tiling) at every picker shape: one
    launcher, bound with its C arity, one count a call."""
    x = torch.empty((m, n), dtype=dtype, device="meta")
    mask = torch.empty((m,), dtype=torch.float32, device="meta")
    censor.bank_advance(x, x, mask)
    fn = f"bank_advance_{common.KERNEL_DTYPES[dtype]}"
    assert len(on_h100) == 1 and on_h100[0][:2] == ("censor", fn)
    argtypes = build.SIGNATURES["censor"][fn]
    assert len(argtypes) == on_h100[0][2] + 2 == _c_arity("censor", fn)
    assert common.LAUNCHES["bank_advance"] == 1
    assert sum(common.LAUNCHES.values()) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("m,n,_path", PICKER_CASES)
def test_censor_bank_advance_launches_its_design(on_h100, m, n, _path,
                                                 dtype):
    """B4 has one design (B9's tall tiling) at every picker shape: one
    launcher, bound with its C arity, one count a call."""
    x = torch.empty((m, n), dtype=dtype, device="meta")
    mask = torch.empty((m,), dtype=torch.float32, device="meta")
    censor.censor_bank_advance(x, x, mask)
    fn = f"censor_bank_advance_{common.KERNEL_DTYPES[dtype]}"
    assert len(on_h100) == 1 and on_h100[0][:2] == ("censor", fn)
    argtypes = build.SIGNATURES["censor"][fn]
    assert len(argtypes) == on_h100[0][2] + 2 == _c_arity("censor", fn)
    assert common.LAUNCHES["censor_bank_advance"] == 1
    assert sum(common.LAUNCHES.values()) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("m,n,_path", PICKER_CASES)
def test_quantize_ef_launches_its_design(on_h100, m, n, _path, dtype):
    """B7b has one design (the tall tiling of B9 and B4) at every picker
    shape: one launcher, bound with its C arity, one count a call."""
    x = torch.empty((m, n), dtype=dtype, device="meta")
    mask, scale = (torch.empty((m,), dtype=torch.float32, device="meta")
                   for _ in range(2))
    quantize_ef.quantize_ef_batched(x, x, mask, scale)
    fn = f"quantize_ef_batched_{common.KERNEL_DTYPES[dtype]}"
    assert len(on_h100) == 1 and on_h100[0][:2] == ("quantize_ef", fn)
    argtypes = build.SIGNATURES["quantize_ef"][fn]
    assert len(argtypes) == on_h100[0][2] + 2 \
        == _c_arity("quantize_ef", fn)
    assert common.LAUNCHES["quantize_ef_batched"] == 1
    assert sum(common.LAUNCHES.values()) == 1


def test_sqnorm_path_threshold_follows_the_sm_count():
    assert T == 1056
    half = common.warp_rows_min_workers(H100_SMS // 2)
    assert half == T // 2
    assert common.sqnorm_path(half + 1, 16, H100_SMS) == "two_pass"
    assert common.sqnorm_path(half + 1, 16, H100_SMS // 2) == "warp"
    assert common.sqnorm_path(half, 16, H100_SMS // 2) == "two_pass"


def test_unknown_or_too_wide_design_is_refused_before_a_launch():
    common.reset_launches()
    g = torch.zeros((T + 1, REDUCE_CHUNK + 1), dtype=torch.float64)
    with pytest.raises(ValueError, match="path must be one of"):
        censor.delta_sqnorm_on_card(g, g, "one_pass")
    with pytest.raises(ValueError, match="at most 2048 elements"):
        censor.delta_sqnorm_on_card(g, g, "warp")
    assert censor.SQNORM_PATHS == ("two_pass", "warp")
    assert common.LAUNCHES["censor_delta_sqnorm_batched"] == 0


# kernel: (its design entry point on one (M, n) operand, LAUNCHES key)
ON_CARD = {
    "B8": (censor.sqnorm_on_card, "sqnorm_batched"),
    "B5": (lambda x, d: fused_step.int8_stats_on_card(x, x, x, d),
           "int8_stats_batched"),
}


@pytest.mark.parametrize("kernel", ON_CARD)
def test_b8_b5_refuse_an_unknown_or_too_wide_design(kernel):
    run, name = ON_CARD[kernel]
    common.reset_launches()
    g = torch.zeros((T + 1, REDUCE_CHUNK + 1), dtype=torch.float64)
    with pytest.raises(ValueError, match="path must be one of"):
        run(g, "one_pass")
    with pytest.raises(ValueError, match="at most 2048 elements"):
        run(g, "warp")
    assert sum(common.LAUNCHES.values()) == 0


def test_b7a_refuses_an_unknown_or_too_wide_design():
    common.reset_launches()
    x = torch.zeros((T + 1, REDUCE_CHUNK + 1), dtype=torch.float64)
    with pytest.raises(ValueError, match="path must be one of"):
        quantize_ef.absmax_on_card(x, "one_pass")
    with pytest.raises(ValueError, match="at most 2048 elements"):
        quantize_ef.absmax_on_card(x, "warp")
    assert sum(common.LAUNCHES.values()) == 0


def _salted(m, n, dtype):
    """pending/g, err, ghat, keep and mask of a tall bank: column 0 all
    -0.0 (g and ghat), a kept and a dropped -0.0 in every 7th column, -0.0
    in the keep mask itself, and where n >= 3 NaN and +-inf in the last
    columns."""
    rng = np.random.default_rng(3 * m + n)
    g, h = (rng.standard_normal((m, n)).astype(dtype) for _ in range(2))
    e = (0.01 * rng.standard_normal((m, n))).astype(dtype)
    g[:, ::7] = -0.0
    g[:, 0], h[:, 0], e[:, 0] = -0.0, -0.0, -0.0
    if n >= 3:
        g[m // 2, n - 1] = np.nan
        h[m - 1, n - 2] = np.inf
        g[0, n - 1] = -np.inf
    keep = (rng.random((m, n)) < 0.4).astype(dtype)
    keep[:, ::7] = 1.0
    keep[:, ::14] = 0.0
    keep[:, 3::29] = -0.0
    mask = (np.arange(m) % 3 != 1).astype(np.float32)
    return g, h, e, keep, mask


def _same_or_nan(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint8),
                                  want[~nan].view(np.uint8))


TALL = [(65, 16), (66, 33), (300, 1), (300, 16), (130, 2049)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("m,n", TALL)
def test_tall_select_pack_against_jax(m, n, dtype):
    g, _, e, keep, mask = _salted(m, n, dtype)
    got = topk_pack.select_pack_ef_batched(
        *(torch.from_numpy(x) for x in (g, e, keep, mask)))
    args = [jnp.asarray(x) for x in (g, e, keep, mask)]
    for want in (j_topk.select_pack_ef_batched(*args, interpret=True),
                 j_ref.select_pack_ef_batched(*args)):
        for a, b in zip(got, want):
            _same_or_nan(a.numpy(), b)
    if n > 7:
        kept = (keep != 0) & (g == 0) & np.signbit(g)
        assert np.signbit(got[0].numpy()[kept]).all() and kept.any()


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("m,n", TALL)
def test_tall_delta_sqnorm_against_jax(m, n, dtype):
    g, h, *_ = _salted(m, n, dtype)
    got = censor.censor_delta_sqnorm_batched(torch.from_numpy(g),
                                             torch.from_numpy(h)).numpy()
    assert got.dtype == np.float32 and got.shape == (m,)
    args = [jnp.asarray(x) for x in (g, h)]
    for want in (j_censor.censor_delta_sqnorm_batched(*args, interpret=True),
                 j_ref.censor_delta_sqnorm_batched(*args)):
        want = np.asarray(want)
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan)
        np.testing.assert_allclose(got[~nan], want[~nan], rtol=1e-5)
        if n >= 3:
            assert nan[m // 2] and np.isinf(got[m - 1]) and nan.sum() == 1


def _within_or_nan(got, want):
    got, want = np.asarray(got), np.asarray(want)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_allclose(got[~nan], want[~nan], rtol=1e-5)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("m,n", TALL)
def test_tall_sqnorm_against_jax(m, n, dtype):
    g, h, e, *_ = _salted(m, n, dtype)
    x = (g - h) + e
    got = censor.sqnorm_batched(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (m,)
    for want in (j_censor.sqnorm_batched(jnp.asarray(x), interpret=True),
                 j_ref.sqnorm_batched(jnp.asarray(x))):
        _within_or_nan(got, want)
    if n >= 3:
        assert np.isnan(got[m // 2]) and np.isinf(got[m - 1])


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("m,n", TALL)
def test_tall_int8_stats_against_jax(m, n, dtype):
    g, h, e, *_ = _salted(m, n, dtype)
    sq, am = fused_step.int8_stats_batched(
        *(torch.from_numpy(a) for a in (g, h, e)))
    assert sq.dtype == torch.float32 and am.dtype == torch.from_numpy(g).dtype
    sq, am = sq.numpy(), am.numpy()
    args = [jnp.asarray(a) for a in (g, h, e)]
    for want_sq, want_am in (
            j_fused.int8_stats_batched(*args, interpret=True),
            j_ref.int8_stats_batched(*args)):
        _within_or_nan(sq, want_sq)
        _same_or_nan(am, np.asarray(want_am))
    # the sum is B8's on pending (the plain versions)
    pending = torch.from_numpy((g - h) + e)
    _same_or_nan(sq, censor.sqnorm_batched(pending).numpy())
    if n >= 3:
        assert np.isnan(am[m // 2]) and np.isinf(am[m - 1])
        assert np.isinf(am[0])


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("m,n", TALL)
def test_tall_absmax_against_jax(m, n, dtype):
    g, h, e, *_ = _salted(m, n, dtype)
    x = (g - h) + e
    x[1] = -0.0                             # a row of -0.0 gives +0
    got = quantize_ef.absmax_batched(torch.from_numpy(x)).numpy()
    assert got.dtype == dtype and got.shape == (m,)
    for want in (j_quant.absmax_batched(jnp.asarray(x), interpret=True),
                 j_ref.absmax_batched(jnp.asarray(x))):
        _same_or_nan(got, np.asarray(want))
    assert got[1] == 0 and not np.signbit(got[1])
    if n >= 3:
        assert np.isnan(got[m // 2]) and np.isinf(got[m - 1])
        assert np.isinf(got[0])


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("m,n", TALL)
def test_tall_bank_advance_against_jax(m, n, dtype):
    g, h, _, _, mask = _salted(m, n, dtype)
    got = censor.bank_advance(*(torch.from_numpy(a)
                                for a in (h, g, mask))).numpy()
    args = [jnp.asarray(a) for a in (h, g, mask)]
    for want in (j_censor.bank_advance(*args, interpret=True),
                 j_ref.bank_advance(*args)):
        _same_or_nan(got, np.asarray(want))
    # column 0: -0.0 + mask * -0.0 stays -0.0 on every row
    assert np.signbit(got[:, 0]).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("m,n", TALL)
def test_tall_censor_bank_advance_against_jax(m, n, dtype):
    g, h, _, _, mask = _salted(m, n, dtype)
    gt, ht, mt = (torch.from_numpy(a) for a in (g, h, mask))
    got = censor.censor_bank_advance(gt, ht, mt).numpy()
    args = [jnp.asarray(a) for a in (g, h, mask)]
    for want in (j_censor.censor_bank_advance(*args, interpret=True),
                 j_ref.censor_bank_advance(*args)):
        _same_or_nan(got, np.asarray(want))
    # B2's ghat' of the same operands (the plain versions)
    t = torch.zeros((n,), dtype=gt.dtype)
    _same_or_nan(got, ref.fused_dense_step(gt, ht, t, t, mt, 0.1,
                                           0.4)[0].numpy())


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("m,n", TALL)
def test_tall_quantize_ef_against_jax(m, n, dtype):
    g, h, e, _, mask = _salted(m, n, dtype)
    pend = (g - h) + e
    pt, et, mt = (torch.from_numpy(a) for a in (pend, e, mask))
    scale = int8_scale(ref.absmax_batched(pt))
    got = quantize_ef.quantize_ef_batched(pt, et, mt, scale)
    args = [jnp.asarray(a) for a in (pend, e, mask, scale.numpy())]
    rp, re_ = j_ref.quantize_ef_batched(*args)
    jp, je = j_quant.quantize_ef_batched(*args, interpret=True)
    _same_or_nan(got[0].numpy(), np.asarray(rp))
    _same_or_nan(got[1].numpy(), np.asarray(re_))
    _same_or_nan(got[0].numpy(), np.asarray(jp))
    if dtype == np.float64:
        _same_or_nan(got[1].numpy(), np.asarray(je))
    else:
        # XLA contracts pending - q*scale into an FMA in the interpreted
        # kernel (as in tests/test_torch_staged.py)
        je = np.asarray(je)
        nan = np.isnan(je)
        np.testing.assert_array_equal(np.isnan(got[1].numpy()), nan)
        bound = 4 * np.finfo(np.float32).eps * np.abs(pend)
        assert np.all(np.abs(got[1].numpy()[~nan] - je[~nan])
                      <= bound[~nan])
    # B6's err' of the same operands (the plain versions)
    gt, ht = torch.from_numpy(g), torch.from_numpy(h)
    t = torch.zeros((n,), dtype=gt.dtype)
    err6 = ref.fused_int8_step(gt, ht, et, t, t, mt, scale, 0.1, 0.4)[1]
    _same_or_nan(got[1].numpy(), err6.numpy())
    if n >= 3:
        # a NaN row's scale is 1 and its NaN stays in the payload; the
        # inf row's scale is inf and its payload NaN
        assert float(scale[m // 2]) == 1.0
        assert np.isnan(got[0].numpy()[m // 2, n - 1])
        assert np.isnan(got[0].numpy()[m - 1]).all()
