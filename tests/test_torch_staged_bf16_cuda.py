"""The bf16 and f32-on-bf16 builds of B3, B4, B8, B9 and the worker fold
against their plain versions, on the card, and the routes that run them.

Marked ``cuda``: these need an NVIDIA card with ``nvcc`` and skip without
one (``tests/test_torch_staged_bf16.py`` holds the plain versions and the
routes against the JAX package on the CPU). On a card they run with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_staged_bf16_cuda.py

Each launcher and design against its plain version on the card: B3, B4,
B9 and the fold bit for bit (NaN where NaN, -0.0 included), B8 within rel
1e-5 (its chunks and trees sum the f32 squares in another order than
torch.sum); B4 against B2's ghat', the designs against each other, a
repeat and the M=1 calls against the batched slice bit for bit; each
wrapper one launch a call of the design its picker names. Then
``force_staged()`` dense, ``shard_step`` + ``apply_server`` and
``per_tensor`` on a bf16 bank on the card against the ``reference``
backend (f32 params: every field bit for bit; bf16 params: masks, counters
and ghat' bit for bit, theta within eq. (4)'s bf16 roundings) and the
staged and sharded steps against the fused one bit for bit.
``chip_smoke.py`` phase staged_bf16_banks runs the same over more shapes.
"""
import pytest
import torch

from repro_torch import opt
from repro_torch.kernels import censor, common, fused_step, hb_update, ref

pytestmark = pytest.mark.cuda

BF16, F32 = torch.bfloat16, torch.float32
PAIRS = {"bf16": BF16, "f32_bf16": F32}      # the operand's dtype
SHAPES = [(1, 33), (4, 2049), (9, 128 * 257 + 3), (2000, 16), (70_000, 16)]
SQNORM_RTOL = 1e-5
ALPHA, BETA = 0.0123, 0.4
#: bf16 roundings of eq. (4)'s terms between the kernel's f32 theta' and
#: the reference backend's, which rounds each operation to bf16
EQ4_UNITS = 8


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bits(t):
    return t.view({BF16: torch.int16, F32: torch.int32}[t.dtype])


def _same_or_nan(a, b):
    nan = torch.isnan(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and torch.equal(torch.isnan(a), nan) \
        and torch.equal(_bits(a)[~nan], _bits(b)[~nan])


def _close_or_nan(a, b):
    nan = torch.isnan(b)
    return torch.equal(torch.isnan(a), nan) and torch.allclose(
        a[~nan], b[~nan], rtol=SQNORM_RTOL, atol=0.0)


def _inputs(m, n, p_dt, device, off=0):
    """g in ``p_dt`` and ghat in bf16 (M, n), theta and theta_prev in
    ``p_dt``, each ``off`` elements into its storage; salted with -0.0 and,
    where n > 3, NaN and +-inf; the mask alternates."""
    gen = torch.Generator(device=device).manual_seed(m * 7919 + n + off)

    def leaf(shape, dtype):
        flat = torch.randn(off + torch.Size(shape).numel(), generator=gen,
                           device=device)
        return flat.to(dtype)[off:].view(shape)

    g, h = leaf((m, n), p_dt), leaf((m, n), BF16)
    t, p = leaf((n,), p_dt), leaf((n,), p_dt)
    g[:, ::7] = -0.0
    h[:, ::11] = -0.0
    if n > 3:
        g[m // 2, n - 1] = float("nan")
        h[m - 1, n - 2] = float("inf")
        g[0, n - 3] = float("-inf")
    mask = torch.tensor([float(i % 2 == 0) for i in range(m)], device=device)
    return g, h, t, p, mask


def _rows(m):
    return sorted({0, m // 2, m - 1})


@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("m,n", SHAPES)
def test_sqnorm_and_fold_on_both_designs(card, m, n, off):
    """B8 on a bf16 pending leaf and the fold of a bf16 bank, each design."""
    g, h, _, _, _ = _inputs(m, n, BF16, card, off)
    x = g - h
    plain_sq, plain_fold = ref.sqnorm_batched(x), ref.fold_workers(h)
    designs = censor.SQNORM_PATHS if n <= 2048 else ("two_pass",)
    first = None
    for design in designs:
        sq = censor.sqnorm_on_card(x, design)
        assert sq.dtype == F32 and _close_or_nan(sq, plain_sq), design
        first = sq if first is None else first
        assert _same_or_nan(sq, first), design
        assert _same_or_nan(censor.sqnorm_on_card(x, design), sq), design
        for w in _rows(m):
            one = censor.sqnorm_on_card(x[w:w + 1], design)
            assert _same_or_nan(one, sq[w:w + 1]), (design, w)
    if m == 70_000:    # the plain fold is 70,000 eager adds: one design
        folds = {"tall": fused_step.fold_on_card(h, "tall")}
    else:
        folds = {d: fused_step.fold_on_card(h, d)
                 for d in fused_step.FOLD_PATHS}
    for design, out in folds.items():
        assert out.dtype == BF16 and _same_or_nan(out, plain_fold), design
        assert _same_or_nan(fused_step.fold_on_card(h, design), out)


@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("m,n", SHAPES[:4])
@pytest.mark.parametrize("pair", list(PAIRS))
def test_advances_and_hb_update(card, pair, m, n, off):
    """B4, B9 and B3 bit for bit against their plain versions; B4 against
    B2's ghat'; the M=1 calls against the batched slices."""
    p_dt = PAIRS[pair]
    g, h, t, p, mask = _inputs(m, n, p_dt, card, off)
    b4 = censor.censor_bank_advance(g, h, mask)
    assert _same_or_nan(b4, ref.censor_bank_advance(g, h, mask))
    assert _same_or_nan(censor.censor_bank_advance(g, h, mask), b4)
    fused = fused_step.fused_dense_step(g, h, t, p, mask, ALPHA, BETA)
    assert _same_or_nan(b4, fused[0])
    b9 = censor.bank_advance(h, g, mask)
    assert _same_or_nan(b9, ref.bank_advance(h, g, mask))
    for w in _rows(m):
        r = slice(w, w + 1)
        assert _same_or_nan(censor.censor_bank_advance(g[r], h[r], mask[r]),
                            b4[r])
        assert _same_or_nan(censor.bank_advance(h[r], g[r], mask[r]), b9[r])
    for nab in (h[m - 1], fused[1]):
        b3 = hb_update.hb_update(t, nab, p, ALPHA, BETA)
        assert b3.dtype == p_dt
        assert _same_or_nan(b3, ref.hb_update(t, nab, p, ALPHA, BETA))
    # B2's theta' is B3 on its own worker sum
    assert _same_or_nan(hb_update.hb_update(t, fused[1], p, ALPHA, BETA),
                        fused[2])


@pytest.mark.parametrize("m,n", SHAPES)
@pytest.mark.parametrize("pair", list(PAIRS))
def test_each_wrapper_launches_once(card, pair, m, n):
    p_dt = PAIRS[pair]
    g, h, t, p, mask = _inputs(m, n, p_dt, card)
    calls = {"censor_bank_advance":
             lambda: censor.censor_bank_advance(g, h, mask),
             "bank_advance": lambda: censor.bank_advance(h, g, mask),
             "hb_update": lambda: hb_update.hb_update(t, h[0], p, ALPHA,
                                                      BETA),
             "sqnorm_batched": lambda: censor.sqnorm_batched(h),
             "fold_workers": lambda: fused_step.fold_workers(h)}
    for name, call in calls.items():
        common.reset_launches()
        call()
        torch.cuda.synchronize()
        assert common.LAUNCHES[name] == 1, name
        assert sum(common.LAUNCHES.values()) == 1, name
    common.reset_launches()


class _Shard:
    """``shard_step`` over every worker, then ``apply_server``."""

    def __init__(self, o):
        self.o = o

    def step(self, state, params, grads):
        new_state, partial, st = self.o.shard_step(state, params, grads)
        return new_state, self.o.apply_server(params, state.prev_params,
                                              partial), st


ROUTES = [(r, p) for r in ("staged", "shard", "per_tensor") for p in PAIRS]
#: the kernels each route launches once a leaf a step
ROUTE_KERNELS = {
    "staged": ("censor_delta_sqnorm_batched", "censor_bank_advance",
               "fold_workers", "hb_update"),
    "shard": ("censor_delta_sqnorm_batched", "censor_bank_advance",
              "fold_workers", "hb_update"),
    "per_tensor": ("sqnorm_batched", "bank_advance", "fold_workers",
                   "hb_update")}


@pytest.mark.parametrize("route,pair", ROUTES,
                         ids=[f"{r}-{p}" for r, p in ROUTES])
def test_routes_on_a_bf16_bank(card, route, pair):
    """Three steps of ``route`` on the card against the ``reference``
    backend from one state each step, and (staged, shard) against the fused
    step bit for bit; each route's kernels once a leaf a step."""
    p_dt = PAIRS[pair]
    m, shapes = 4, {"w": (33, 65), "b": (129,)}
    gen = torch.Generator(device=card).manual_seed(5)
    kw = {} if p_dt == BF16 else {"bank_dtype": BF16}
    if route == "per_tensor":
        kw["granularity"] = "per_tensor"
    ops = {b: opt.make("chb", ALPHA, m, eps1=0.25, beta=BETA, backend=b,
                       **kw) for b in ("cuda", "reference")}
    params = {k: torch.randn(s, generator=gen, device=card).to(p_dt)
              for k, s in shapes.items()}
    state = ops["cuda"].init(params)
    fused = ops["cuda"]
    for step in range(3):
        grads = {k: (torch.randn((m,) + s, generator=gen, device=card)
                     + params[k].float()).to(p_dt) for k, s in shapes.items()}
        common.reset_launches()
        if route == "staged":
            with fused_step.force_staged():
                out = ops["cuda"].step(state, params, grads)
        elif route == "shard":
            out = _Shard(ops["cuda"]).step(state, params, grads)
        else:
            out = ops["cuda"].step(state, params, grads)
        torch.cuda.synchronize()
        want = {n: (len(shapes) if n in ROUTE_KERNELS[route] else 0)
                for n in common.KERNELS}
        assert common.LAUNCHES == want, step
        common.reset_launches()
        if route == "shard":
            ref_out = _Shard(ops["reference"]).step(state, params, grads)
        else:
            ref_out = ops["reference"].step(state, params, grads)
        (sc, tc, stc), (sr, tr, str_) = out, ref_out
        assert torch.equal(stc.mask, str_.mask), step
        assert all(torch.equal(a, b) for a, b in zip(sc.comm, sr.comm))
        for k in shapes:
            assert _same_or_nan(sc.ghat[k], sr.ghat[k]), (step, k)
            if p_dt == F32:
                assert _same_or_nan(tc[k], tr[k]), (step, k)
            else:
                agg = ref.fold_workers(sc.ghat[k]).float()
                t, tp = params[k].float(), state.prev_params[k].float()
                terms = t.abs() + ALPHA * agg.abs() + BETA * (t - tp).abs()
                gap = (tc[k].float() - tr[k].float()).abs()
                assert bool((gap <= EQ4_UNITS * 2.0 ** -8 * terms).all())
        if route != "per_tensor":
            fs, ft, fst = fused.step(state, params, grads)
            assert torch.equal(fst.mask, stc.mask)
            for k in shapes:
                assert _same_or_nan(fs.ghat[k], sc.ghat[k])
                assert _same_or_nan(ft[k], tc[k])
        state, params = sc, tc
    assert int(state.comm.uplink_count.sum()) > 0
