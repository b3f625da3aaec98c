"""The bf16 builds of B7a, B7b, B10 and B11 against their plain versions,
on the card, and the routes that run them.

Marked ``cuda``: these need an NVIDIA card with ``nvcc`` and skip without
one (``tests/test_torch_stateful_bf16.py`` holds the plain versions and the
routes against the JAX package on the CPU). On a card they run with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_stateful_bf16_cuda.py

Each launcher against its plain version on the card, bit for bit (NaN where
NaN, -0.0 included): B7a's two designs against each other, B7b's err'
against B6's on the same pending, the M=1 calls against the batched slice,
16-byte tiles and element paths (views one element off), a repeat; each
wrapper one launch a call. Then ``force_staged()`` int8, top-k and
low-rank and their ``shard_step`` on a bf16 bank on the card against the
``reference`` backend from one state each step (f32 params: masks,
counters, ghat' and theta bit for bit, err' too except low-rank's, f32 on
``reference`` and bf16 here, within one bf16 rounding; bf16 params: theta
within eq. (4)'s bf16 roundings) and the staged and sharded int8 steps
against the fused one bit for bit. ``chip_smoke.py`` phase
stateful_bf16_banks runs the same over more shapes.
"""
import pytest
import torch

from repro_torch import opt
from repro_torch.core.quantize import int8_scale
from repro_torch.kernels import (common, fused_step, lowrank_ef, quantize_ef,
                                 ref, topk_pack)

pytestmark = pytest.mark.cuda

BF16, F32 = torch.bfloat16, torch.float32
ERRS = {"bf16": BF16, "f32": F32}
SHAPES = [(1, 33), (4, 2048), (4, 2049), (9, 128 * 257 + 3), (2000, 16),
          (70_000, 16)]
ALPHA, BETA = 0.0123, 0.4
EQ4_UNITS = 8
ONE_ROUNDING = 2.0 ** -7


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


def _inputs(m, n, device, off=0):
    """A bf16 pending leaf, err and payload in f32, a bf16 0/1 keep and
    the alternating mask, each ``off`` elements into its storage; salted
    with -0.0 and, where n > 3, NaN and +-inf in pending."""
    gen = torch.Generator(device=device).manual_seed(m * 7919 + n + off)

    def leaf(scale=1.0):
        return torch.randn((m, n), generator=gen, device=device) * scale

    p, e, q = leaf().to(BF16), leaf(0.01), leaf()
    keep = (leaf() > 0.25).to(BF16)
    p[:, ::7] = -0.0
    e[:, ::5] = -0.0
    if n > 3:
        p[m // 2, n - 1] = float("nan")
        p[m - 1, n - 2] = float("inf")
        p[0, n - 3] = float("-inf")
    mask = torch.tensor([float(i % 2 == 0) for i in range(m)], device=device)
    return (*(_offset(x, off) for x in (p, e, q, keep)), mask)


def _offset(x, off):
    """``x`` as a view ``off`` elements into a larger buffer (off 16-byte
    alignment for an odd ``off``)."""
    if not off:
        return x
    buf = torch.empty(x.numel() + off, dtype=x.dtype, device=x.device)
    view = buf[off:].view(x.shape)
    view.copy_(x)
    return view


def _rows(m):
    return sorted({0, m // 2, m - 1})


@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("m,n", SHAPES)
def test_absmax_on_both_designs(card, m, n, off):
    """B7a on a bf16 leaf: each design against the plain version and the
    two-pass design, a repeat, the M=1 calls; B5's abs-max on the same
    pending."""
    p, e, _, _, _ = _inputs(m, n, card, off)
    plain = ref.absmax_batched(p)
    designs = ("two_pass", "warp") if n <= 2048 else ("two_pass",)
    first = None
    for design in designs:
        am = quantize_ef.absmax_on_card(p, design)
        assert am.dtype == BF16 and _same_or_nan(am, plain), design
        first = am if first is None else first
        assert _same_or_nan(am, first), design
        assert torch.equal(_bits(quantize_ef.absmax_on_card(p, design)),
                           _bits(am))
        for w in _rows(m):
            one = quantize_ef.absmax_on_card(p[w:w + 1], design)
            assert _same_or_nan(one, am[w:w + 1]), (design, w)
    if m <= 9:     # B5 on g = pending, ghat = 0, err = 0: its abs-max
        z = torch.zeros_like(p)
        assert _same_or_nan(fused_step.int8_stats_batched(p, z, z)[1], plain)


@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("m,n", SHAPES)
@pytest.mark.parametrize("err", list(ERRS))
def test_quantize_select_residual(card, err, m, n, off):
    """B7b, B10 and B11 (each payload dtype) bit for bit against their
    plain versions, a repeat and the M=1 calls; B7b's err' against B6's on
    B6's pending (g - ghat) + err."""
    p, e, q, keep, mask = _inputs(m, n, card, off)
    e = _offset(e.to(ERRS[err]), off)
    scale = int8_scale(ref.absmax_batched(p))
    calls = {
        "B7b": lambda p, e, q, keep, mask, scale:
            quantize_ef.quantize_ef_batched(p, e, mask, scale),
        "B10": lambda p, e, q, keep, mask, scale:
            topk_pack.select_pack_ef_batched(p, e, keep, mask),
        "B11_bf16": lambda p, e, q, keep, mask, scale:
            lowrank_ef.residual_ef_batched(p, _offset(q.to(BF16), off), e,
                                           mask),
        "B11_f32": lambda p, e, q, keep, mask, scale:
            lowrank_ef.residual_ef_batched(p, q, e, mask)}
    plains = {
        "B7b": lambda: ref.quantize_ef_batched(p, e, mask, scale),
        "B10": lambda: ref.select_pack_ef_batched(p, e, keep, mask),
        "B11_bf16": lambda: ref.residual_ef_batched(p, q.to(BF16), e, mask),
        "B11_f32": lambda: ref.residual_ef_batched(p, q, e, mask)}
    for name, call in calls.items():
        out = call(p, e, q, keep, mask, scale)
        outs = out if isinstance(out, tuple) else (out,)
        want = plains[name]()
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(outs, want):
            assert a.dtype == BF16 and _same_or_nan(a, b), name
        again = call(p, e, q, keep, mask, scale)
        again = again if isinstance(again, tuple) else (again,)
        assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(again,
                                                                   outs))
        for w in _rows(m):
            r = slice(w, w + 1)
            one = call(p[r], e[r], q[r], keep[r], mask[r], scale[r])
            one = one if isinstance(one, tuple) else (one,)
            assert all(_same_or_nan(a, b[r]) for a, b in zip(one, outs)), \
                (name, w)
    if m <= 9:   # B6 on g (the params' dtype: f32 with an f32 err), ghat
        g = q if err == "f32" else q.to(BF16)
        pend = (g.to(BF16) - p) + e.to(BF16)
        sc = int8_scale(ref.absmax_batched(pend))
        t = torch.zeros((n,), dtype=g.dtype, device=card)
        b6 = fused_step.fused_int8_step(g, p, e, t, t, mask, sc, ALPHA,
                                        BETA)[1]
        b7b = quantize_ef.quantize_ef_batched(pend, e, mask, sc)[1]
        assert _same_or_nan(b7b, b6)


@pytest.mark.parametrize("m,n", SHAPES)
def test_each_wrapper_launches_once(card, m, n):
    p, e, q, keep, mask = _inputs(m, n, card)
    scale = torch.ones((m,), device=card)
    calls = {"absmax_batched": lambda: quantize_ef.absmax_batched(p),
             "quantize_ef_batched":
                 lambda: quantize_ef.quantize_ef_batched(p, e, mask, scale),
             "select_pack_ef_batched":
                 lambda: topk_pack.select_pack_ef_batched(p, e, keep, mask),
             "residual_ef_batched":
                 lambda: lowrank_ef.residual_ef_batched(p, q, e, mask)}
    for name, call in calls.items():
        common.reset_launches()
        call()
        torch.cuda.synchronize()
        assert common.LAUNCHES[name] == 1, name
        assert sum(common.LAUNCHES.values()) == 1, name
        # one bf16 launcher of this kernel, counted where it was called
        (launcher,) = [f for f, c in common.LAUNCHERS.items() if c]
        assert common.LAUNCHERS[launcher] == 1, launcher
        assert launcher.startswith(name + "_") and "bf16" in launcher, \
            launcher
    common.reset_launches()


class _Shard:
    """``shard_step`` over every worker, then ``apply_server``."""

    def __init__(self, o):
        self.o = o

    def step(self, state, params, grads):
        new_state, partial, st = self.o.shard_step(state, params, grads)
        return new_state, self.o.apply_server(params, state.prev_params,
                                              partial), st


TRANSPORTS = {"int8": {"quantize": "int8"},
              "topk": {"transport": "topk", "k": 500},
              "lowrank": {"transport": "lowrank", "rank": 2}}
#: the kernels a step launches once a leaf
KERNELS = {"int8": ("sqnorm_batched", "absmax_batched", "quantize_ef_batched",
                    "bank_advance", "fold_workers", "hb_update"),
           "topk": ("sqnorm_batched", "select_pack_ef_batched",
                    "bank_advance", "fold_workers", "hb_update"),
           "lowrank": ("sqnorm_batched", "residual_ef_batched",
                       "bank_advance", "fold_workers", "hb_update")}
ROUTES = [(r, t, p) for r in ("staged", "shard") for t in TRANSPORTS
          for p in ("f32_bf16", "bf16")]
#: the stateful kernel of each transport
EF_KERNEL = {"int8": "quantize_ef_batched", "topk": "select_pack_ef_batched",
             "lowrank": "residual_ef_batched"}


def _want_launchers(tkind, p_dt, step, shapes) -> dict:
    """The launchers of a step's stateful kernel and B9, one a leaf: err is
    f32 only in the first step on f32 params (``transport.init``'s), and
    low-rank's payload f32 only on a matrix leaf of f32 params (a vector
    leaf ships its bf16 pending leaf)."""
    name, want = EF_KERNEL[tkind], {}
    e = "f32" if p_dt == F32 and step == 0 else "bf16"
    for s in shapes.values():
        q = "f32" if tkind == "lowrank" and p_dt == F32 and len(s) >= 2 \
            else "bf16"
        ops = (q, e) if tkind == "lowrank" else (e,)
        ef = f"{name}_bf16" + ("" if set(ops) == {"bf16"} else
                               "".join(f"_{d}" for d in ops))
        bank = "bank_advance_f32_bf16" if q == "f32" else "bank_advance_bf16"
        for f in (ef, bank):
            want[f] = want.get(f, 0) + 1
    return want


def _ef(err):
    return err["err"] if isinstance(err, dict) and "q" in err else err


@pytest.mark.parametrize("route,tkind,pair", ROUTES,
                         ids=[f"{r}-{t}-{p}" for r, t, p in ROUTES])
def test_routes_on_a_bf16_bank(card, route, tkind, pair):
    """Three steps of ``route`` on the card against the ``reference``
    backend from one state each step, and int8 against the fused step bit
    for bit; each route's kernels once a leaf a step."""
    p_dt = BF16 if pair == "bf16" else F32
    m, shapes = 4, {"w": (33, 65), "b": (129,)}
    gen = torch.Generator(device=card).manual_seed(5)
    kw = dict(TRANSPORTS[tkind])
    if p_dt == F32:
        kw["bank_dtype"] = BF16
    ops = {b: opt.make("chb", ALPHA, m, eps1=0.25, beta=BETA, backend=b,
                       **kw) for b in ("cuda", "reference")}
    params = {k: torch.randn(s, generator=gen, device=card).to(p_dt)
              for k, s in shapes.items()}
    state = ops["cuda"].init(params)
    for step in range(3):
        grads = {k: (torch.randn((m,) + s, generator=gen, device=card)
                     + params[k].float()).to(p_dt) for k, s in shapes.items()}

        def run(o):
            if route == "shard":
                return _Shard(o).step(state, params, grads)
            with fused_step.force_staged():
                return o.step(state, params, grads)
        common.reset_launches()
        out = run(ops["cuda"])
        torch.cuda.synchronize()
        want = {n: (len(shapes) if n in KERNELS[tkind] else 0)
                for n in common.KERNELS}
        assert common.LAUNCHES == want, step
        got = {f: c for f, c in common.LAUNCHERS.items()
               if c and f.startswith((EF_KERNEL[tkind], "bank_advance_"))}
        assert got == _want_launchers(tkind, p_dt, step, shapes), step
        common.reset_launches()
        ref_out = run(ops["reference"])
        (sc, tc, stc), (sr, tr, str_) = out, ref_out
        assert torch.equal(stc.mask, str_.mask), step
        assert all(torch.equal(a, b) for a, b in zip(sc.comm, sr.comm))
        ec, er = _ef(sc.err), _ef(sr.err)
        if tkind == "lowrank":   # the payload the reference step sent
            pend = ops["reference"]._pending(state, grads)
            payload, _ = ops["reference"].transport.encode(pend, state.err)
        for k in shapes:
            assert _same_or_nan(sc.ghat[k], sr.ghat[k]), (step, k)
            promoted = tkind == "lowrank" and p_dt == F32 \
                and len(shapes[k]) >= 2
            assert ec[k].dtype == BF16
            if promoted:    # reference: f32 (the payload's), cuda: bf16
                assert er[k].dtype == F32 and payload[k].dtype == F32
                bound = ONE_ROUNDING * (pend[k].float().abs()
                                        + payload[k].abs())
                assert bool(((ec[k].float() - er[k]).abs() <= bound).all())
            else:
                assert _same_or_nan(ec[k], er[k]), (step, k)
            if p_dt == F32:
                assert _same_or_nan(tc[k], tr[k]), (step, k)
            else:
                agg = ref.fold_workers(sc.ghat[k]).float()
                t, tp = params[k].float(), state.prev_params[k].float()
                terms = t.abs() + ALPHA * agg.abs() + BETA * (t - tp).abs()
                gap = (tc[k].float() - tr[k].float()).abs()
                assert bool((gap <= EQ4_UNITS * 2.0 ** -8 * terms).all())
        if tkind == "int8":
            fs, ft, fst = ops["cuda"].step(state, params, grads)
            assert torch.equal(fst.mask, stc.mask)
            for k in shapes:
                assert _same_or_nan(fs.ghat[k], sc.ghat[k])
                assert _same_or_nan(_ef(fs.err)[k], ec[k])
                assert _same_or_nan(ft[k], tc[k])
        state, params = sc, tc
    assert int(state.comm.uplink_count.sum()) > 0
