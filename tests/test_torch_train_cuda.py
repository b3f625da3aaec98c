"""Training's kernels against their plain versions, on the card.

Marked ``cuda``: these need an NVIDIA card with ``nvcc`` and skip without
one (tests/test_torch_train.py holds the plain versions against the JAX
package on the CPU). On a card they run with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_cuda.py

B14 with its log-sum-exp and the flash backward kernel against their
plain versions and an f64 version of the same function: the kernel's max
abs error against f64 at most ATTN_FACTOR times the f32 plain version's
plus ATTN_FLOOR (the rule ``chip_smoke.py`` holds B13/B14 to); B14's
output the same bits with the log-sum-exp as without it; the backward's
bits the same from run to run (no atomics); one launch a call. Then
``trainer.train`` of the reduced LM on both backends: the same uploads,
losses within TRAIN_RTOL, each step's launches the scan step's.
``chip_smoke.py`` runs the same comparisons at full width.
"""
import pytest
import torch

from repro_torch.configs import get
from repro_torch.kernels import common, flash_attention, flash_backward, ref
from repro_torch.tree import tree_leaves
from repro_torch.train import trainer

pytestmark = pytest.mark.cuda

ATTN_FACTOR = 4.0
ATTN_FLOOR = 1e-6
TRAIN_RTOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bits(t):
    return t.view(torch.int32)


def flash_f64(q, k, v, do, causal, window):
    """B14's log-sum-exp and the backward's (dq, dk, dv) in f64: the same
    function without the f32 roundings. A row with no valid key has p = 1
    on every key, as in ``repro/models/flash.py``."""
    b, h, lq, d = q.shape
    kh, s_len = k.shape[1], k.shape[2]
    g, scale = h // kh, d ** -0.5
    q5 = q.double().reshape(b, kh, g, lq, d)
    do5 = do.double().reshape(b, kh, g, lq, d)
    k64, v64 = k.double(), v.double()
    s = torch.einsum("bkgqd,bksd->bkgqs", q5, k64) * scale
    qpos = torch.arange(lq, device=q.device)[:, None]
    kpos = torch.arange(s_len, device=q.device)[None, :]
    m = torch.ones((lq, s_len), dtype=torch.bool, device=q.device)
    if causal:
        m = m & (kpos <= qpos)
    if window is not None:
        m = m & (kpos > qpos - window)
    s = torch.where(m, s, ref.NEG)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", torch.softmax(s, dim=-1), v64)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bkgqd,bksd->bkgqs", do5, v64)
    ds = p * (dp - torch.sum(do5 * o, dim=-1)[..., None])
    dq = scale * torch.einsum("bkgqs,bksd->bkgqd", ds, k64)
    dk = scale * torch.einsum("bkgqs,bkgqd->bksd", ds, q5)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, do5)
    return lse.reshape(b, h, lq), dq.reshape(b, h, lq, d), dk, dv


def _rule(got, plain, exact, what):
    err_k = float((got.double() - exact).abs().max())
    err_p = float((plain.double() - exact).abs().max())
    assert err_k <= ATTN_FACTOR * err_p + ATTN_FLOOR, (what, err_k, err_p)


# (b, h, kh, lq, s, d, causal, window, offset): GQA 1, 2 and 4; L on and
# off the 64-row tiles (64, 65, 200, 256) and Lq != S; d 33 (element
# loads), 64 and 80; causal with and without a window, non-causal;
# operands one element off their storage's alignment (offset 1);
# training's (4, 12, 256, 64)
CASES = [(2, 4, 4, 64, 64, 64, True, None, 0),
         (2, 4, 2, 65, 65, 64, True, None, 0),
         (1, 8, 2, 200, 200, 80, True, 48, 0),
         (2, 4, 2, 200, 200, 33, True, None, 1),
         (1, 8, 2, 256, 256, 64, False, None, 0),
         (1, 4, 4, 100, 160, 80, False, 20, 1),
         (1, 4, 2, 160, 100, 64, True, 30, 0),
         (4, 12, 12, 256, 256, 64, True, None, 0)]


@pytest.mark.parametrize("case", CASES)
def test_lse_and_backward_match_their_plain_versions(card, case):
    b, h, kh, lq, s_len, d, causal, window, off = case
    gen = torch.Generator(device=card).manual_seed(lq + d + off + h)

    def view(n, x):            # a (b, x, n, d) view of a (b, n, x, d) tensor
        flat = torch.randn(off + b * n * x * d, generator=gen, device=card)
        return flat[off:].view(b, n, x, d).transpose(1, 2)

    q, k, v, do = view(lq, h), view(s_len, kh), view(s_len, kh), view(lq, h)
    kw = {"causal": causal, "window": window}
    common.reset_launches()
    out, lse = flash_attention.flash_attention(q, k, v, return_lse=True,
                                               **kw)
    assert torch.equal(_bits(out), _bits(flash_attention.flash_attention(
        q, k, v, **kw)))
    grads = flash_backward.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert common.LAUNCHES["flash_attention"] == 2
    assert common.LAUNCHES["flash_attention_bwd"] == 1
    _, lse_p = ref.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    plain = ref.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    exact = flash_f64(q, k, v, do, causal, window)
    for name, got, pl, ex, like in zip(("lse", "dq", "dk", "dv"),
                                       (lse,) + grads, (lse_p,) + plain,
                                       exact, (lse, q, k, v)):
        assert got.dtype == torch.float32 and got.shape == like.shape
        _rule(got, pl, ex, name)
    again = flash_backward.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    assert all(torch.equal(_bits(a), _bits(b_)) for a, b_ in zip(grads,
                                                                 again))


def test_backward_refuses_mixed_devices(card):
    q = torch.zeros((1, 2, 8, 16), device=card)
    lse = torch.zeros((1, 2, 8), device=card)
    with pytest.raises(ValueError, match="device"):
        flash_backward.flash_attention_bwd(q, q, q, q, lse, q.cpu())


def _want_launches(cfg, m: int, leaves: int, int8: bool) -> dict:
    """One scan step's launches (remat "none", eps1 > 0): B1 and B2 (dense)
    or B5 and B6 (int8) once a leaf; B14 and the backward once a layer a
    worker."""
    want = {"flash_attention": m * cfg.num_layers,
            "flash_attention_bwd": m * cfg.num_layers}
    if int8:
        want.update(int8_stats_batched=leaves, fused_int8_step=leaves)
    else:
        want.update(censor_delta_sqnorm_batched=leaves,
                    fused_dense_step=leaves)
    return want


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["dense", "int8"])
def test_train_on_the_card(card, quantize):
    """Two ``train()`` steps of the reduced LM on both backends: the same
    uploads and counters, losses within TRAIN_RTOL, each step's launches
    the scan step's and none on the reference backend."""
    cfg = get("chb-paper-lm-124m").reduced()
    tc = trainer.TrainConfig(num_workers=2, global_batch=4, seq_len=64,
                             steps=2, log_every=1, eps1_scale=4.0,
                             alpha=0.05, quantize=quantize)
    common.reset_launches()
    params, state, hist = trainer.train(cfg, tc, verbose=False, device=card)
    torch.cuda.synchronize()
    launches = {k: c for k, c in common.LAUNCHES.items() if c}
    common.reset_launches()
    _, ref_state, ref_hist = trainer.train(cfg, tc, verbose=False,
                                           device=card, backend="reference")
    assert not any(common.LAUNCHES.values())
    for a, b in zip(hist, ref_hist):
        assert a["transmitted"] == b["transmitted"]
        assert a["comms"] == b["comms"]
        assert a["loss"] == pytest.approx(b["loss"], rel=TRAIN_RTOL)
    assert torch.equal(state.comm.uplink_count, ref_state.comm.uplink_count)
    want = _want_launches(cfg, 2, len(tree_leaves(params)), bool(quantize))
    assert launches == {k: 2 * c for k, c in want.items()}
