"""B10 and B1 on tall worker banks (``kernels/csrc/topk_pack.cu``,
``kernels/csrc/censor.cu``), on the CPU.

B10 (top-k select/pack + EF) has one design, tiled over workers and
columns like B2's tall pass 1, so it needs no picker. B1 (the eq.-(8)
censor norm) has two, which its wrapper picks by shape
(``common.sqnorm_path``): a warp a worker, in one launch, for rows of one
reduction chunk on many workers; elsewhere the two-pass design (a block a
(chunk, worker), then a block a worker over the partials). The kernels run
only on the card (``tests/test_torch_cuda.py`` and ``chip_smoke.py``'s
phase tall_paths hold the designs against each other there); here:

  * the picker at the full-width shape (M = 4, n = 163,597,056), Fig. 11's
    (M = 9, n = 50), the fed-mesh frontier and ladder top (M = 10^5 and
    10^6, n = 16), each side of its worker threshold and of the chunk's
    2048 elements; the threshold moves with the card's SM count; an
    unknown design or a row too wide for the warp design is refused before
    any launch;
  * the plain versions at tall shapes, salted with -0.0, NaN and +-inf, in
    f32 and f64, against the JAX package's oracles (``repro/kernels/ref.py``)
    and Pallas kernels (interpret mode), with ``test_torch_kernels.py``'s
    tolerances: B10 exact (-0.0 included; NaN where NaN), B1 within rel
    1e-5 (both sides accumulate in f32, in other orders; NaN where NaN).
"""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels import censor as j_censor  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels import topk_pack as j_topk  # noqa: E402
from repro_torch.kernels import censor, common, topk_pack  # noqa: E402
from repro_torch.kernels.build import REDUCE_CHUNK  # noqa: E402

H100_SMS = 132
T = common.warp_rows_min_workers(H100_SMS)     # 1056 workers


@pytest.mark.parametrize("m,n,path", [
    (4, 163_597_056, "two_pass"),       # full width, chb-paper-lm-124m
    (9, 50, "two_pass"),                # Fig. 11's linreg
    (100_000, 16, "warp"),              # the fed-mesh frontier
    (12_500, 16, "warp"),               # a shard of it at K = 8
    (1_000_000, 16, "warp"),            # fed_mesh.py's ladder top
    (70_000, 2049, "two_pass"),         # two chunks a row
    (1, 16, "two_pass"),                # an M=1 row call
    (T, 16, "two_pass"),
    (T + 1, 16, "warp"),
    (T + 1, REDUCE_CHUNK, "warp"),
    (T + 1, REDUCE_CHUNK + 1, "two_pass"),
    (T, REDUCE_CHUNK, "two_pass"),
])
def test_sqnorm_path_by_shape(m, n, path):
    assert common.sqnorm_path(m, n, H100_SMS) == path


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
