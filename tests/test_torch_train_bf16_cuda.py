"""Training the bf16 configs on the card: the bf16 flash backward and the
scan step on bf16 params against their plain versions.

Marked ``cuda``: these need an NVIDIA card with ``nvcc`` and skip without
one (tests/test_torch_train_bf16.py holds the plain versions against the
JAX package on the CPU). On a card they run with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_bf16_cuda.py

``flash_attention_bwd_bf16`` from B14 bf16's output and log-sum-exp, on
the key-tile design's edges (L one short of and one past its tiles, G 1-6,
windows, rows with no valid key, Lq != S, d 33 to 256, views off their
storage's alignment), held to ``chip_smoke.bf16_bwd_excess``: each output
element within half a bf16 ulp of the f64 function of the same residuals
plus ATTN_FACTOR times the f32 plain version's error, and within one bf16
ulp of the bf16 plain version plus (ATTN_FACTOR + 1) times it; the same
bits over three calls, one launch of the bf16 launcher a call, dq, dk and
dv in the operands' strides; an f16 or mixed call refused before any
launch. Then two ``trainer.train`` steps of qwen3-4b and gemma3-12b
reduced in bf16 (``chip_smoke.bf16_pin_config``: GQA at head dim 128 and
256, gemma3's "S" window shorter than the sequence): every launcher a bf16
build, B14 and the backward once a layer a worker; and
``chip_smoke._bf16_lockstep`` on them (margins asserted, masks and
counters equal, ghat' and params within their derived bounds).
"""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the repository root's script)
from repro_torch.configs import get  # noqa: E402
from repro_torch.kernels import (common, flash_attention,  # noqa: E402
                                 flash_backward, ref)
from repro_torch.train import trainer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

pytestmark = pytest.mark.cuda

# (b, h, kh, lq, s, d, causal, window, offset)
CASES = [
    (1, 4, 2, 63, 63, 64, True, None, 0),       # 64-row tiles: one short
    (1, 4, 2, 65, 65, 64, True, None, 0),       # and one past
    (1, 4, 2, 129, 95, 64, True, None, 0),      # 32-key tiles: one short
    (1, 4, 4, 97, 97, 64, True, None, 0),       # and one past
    (1, 4, 2, 31, 33, 64, False, None, 0),
    (1, 4, 2, 31, 31, 80, True, None, 0),       # 32 x 32 tiles (d <= 128)
    (1, 4, 2, 33, 33, 128, True, None, 0),
    (1, 2, 1, 63, 65, 128, False, 20, 0),
    (1, 2, 2, 33, 31, 256, True, None, 0),      # 32 x 32 tiles (d <= 256)
    (2, 6, 6, 100, 100, 64, True, None, 0),     # G = 1
    (1, 8, 2, 100, 100, 64, True, None, 0),     # G = 4
    (1, 12, 2, 100, 100, 64, True, None, 0),    # G = 6
    (1, 4, 2, 200, 200, 64, True, 16, 0),       # window 16, 64-row tiles
    (1, 4, 2, 150, 100, 64, True, 20, 0),       # rows 119+ have no key
    (1, 4, 2, 100, 160, 72, False, 20, 0),      # d 72: 16-byte loads of 8
    (2, 8, 4, 256, 256, 128, True, None, 0),    # qwen3-4b's heads, L 256
    (1, 4, 2, 300, 300, 256, True, 100, 0),     # gemma3-12b's "S" heads
    (1, 4, 2, 97, 97, 33, True, 16, 1),         # d = 33, misaligned
    (2, 4, 2, 130, 130, 128, True, None, 1),    # d 128, misaligned
    # the tensor-core design's tiles: 64 query rows and keys (32-row
    # stages at d 256), one short of and one past each, causal and windowed
    (1, 4, 2, 63, 63, 128, True, None, 0),
    (1, 4, 2, 65, 65, 128, True, 40, 0),
    (1, 4, 2, 127, 129, 64, True, 48, 0),
    (1, 4, 2, 129, 127, 64, False, 70, 0),
    (1, 2, 2, 31, 31, 256, True, None, 0),
    (1, 4, 2, 33, 33, 256, True, 20, 0),
    (1, 4, 2, 63, 65, 256, True, None, 0),
    (1, 4, 2, 65, 63, 256, True, 40, 0),
    (1, 4, 2, 160, 65, 128, True, 30, 0),       # Lq > S: rows 94+ no key
]
IDS = [f"b{c[0]}h{c[1]}k{c[2]}q{c[3]}s{c[4]}d{c[5]}"
       f"{'c' if c[6] else 'n'}w{c[7]}o{c[8]}" for c in CASES]
ARCHS = ("qwen3-4b", "gemma3-12b")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(case, device, seed, dtype=torch.bfloat16):
    """q, k, v, dO as the model's (B, H, L, d) views (``offset`` elements
    into their storage), and B14's o and lse of them."""
    b, h, kh, lq, s_len, d, causal, window, off = case
    gen = torch.Generator(device=device).manual_seed(seed)

    def view(n, x):
        flat = torch.randn(off + b * n * x * d, generator=gen,
                           device=device).to(dtype)
        return flat[off:].view(b, n, x, d).transpose(1, 2)

    q, k, v, do = view(lq, h), view(s_len, kh), view(s_len, kh), view(lq, h)
    o, lse = flash_attention.flash_attention(q, k, v, causal=causal,
                                             window=window, return_lse=True)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bf16_backward_edge_cases(card, case):
    b, h, kh, lq, s_len, d, causal, window, off = case
    q, k, v, o, lse, do = _inputs(case, card, lq + 3 * d + off)
    kw = {"causal": causal, "window": window}
    assert flash_attention.tc_copy_ok(q) == (d % 8 == 0 and off == 0)
    runs = []
    for _ in range(3):
        common.reset_launches()
        runs.append(flash_backward.flash_attention_bwd(q, k, v, o, lse, do,
                                                       **kw))
        torch.cuda.synchronize()
        assert {n: c for n, c in common.LAUNCHES.items() if c} == {
            "flash_attention_bwd": 1}
        assert {n: c for n, c in common.LAUNCHERS.items() if c} == {
            "flash_attention_bwd_bf16": 1}
    plain = ref.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    plain32 = ref.flash_attention_bwd(q.float(), k.float(), v.float(),
                                      o.float(), lse, do.float(), **kw)
    exact = chip_smoke.flash_bwd_f64(q, k, v, do, causal, window, o=o)
    for name, got, pl, p32, ex, like in zip(("dq", "dk", "dv"), runs[0],
                                            plain, plain32, exact,
                                            (q, k, v)):
        assert got.dtype == torch.bfloat16 and got.shape == like.shape
        assert got.stride() == like.stride(), name
        assert chip_smoke.bf16_bwd_excess(got, pl, p32, ex) <= 1.0, name
    for again in runs[1:]:
        assert all(chip_smoke.same_bits(a, b_)
                   for a, b_ in zip(runs[0], again))


def test_bf16_backward_refuses_other_dtypes(card):
    """f16 operands, or operands of two dtypes, raise ``TypeError`` naming
    ROADMAP queue B before any launch."""
    case = CASES[0]
    q, k, v, o, lse, do = _inputs(case, card, 3)
    common.reset_launches()
    half = [x.half() for x in (q, k, v, o, do)]
    with pytest.raises(TypeError, match="ROADMAP queue B"):
        flash_backward.flash_attention_bwd(*half[:4], lse, half[4])
    with pytest.raises(TypeError, match="ROADMAP queue B"):
        flash_backward.flash_attention_bwd(q, k, v, o, lse, do.float())
    assert not any(common.LAUNCHERS.values())


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["dense", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_bf16_on_the_card(card, arch, quantize):
    """Two ``train()`` steps of the reduced bf16 config: params and bank in
    bf16, finite losses, each step's launches the scan step's, every
    launcher a bf16 build."""
    cfg = chip_smoke.bf16_pin_config(get, arch)
    tc = trainer.TrainConfig(num_workers=2, global_batch=4, seq_len=64,
                             steps=2, log_every=1, eps1_scale=4.0,
                             alpha=0.05, quantize=quantize)
    common.reset_launches()
    params, state, hist = trainer.train(cfg, tc, verbose=False, device=card)
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    assert all(x.dtype == torch.bfloat16 for x in leaves)
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(state.ghat))
    assert all(torch.isfinite(torch.tensor(h["loss"])) for h in hist)
    want = chip_smoke.train_launches(cfg, 2, len(leaves), bool(quantize))
    assert {k: c for k, c in common.LAUNCHES.items() if c} == {
        k: 2 * c for k, c in want.items() if c}
    launchers = {k: c for k, c in common.LAUNCHERS.items() if c}
    assert all(k.endswith("_bf16") for k in launchers), launchers
    assert launchers["flash_attention_bf16"] == \
        launchers["flash_attention_bwd_bf16"] == 2 * 2 * cfg.num_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_lockstep_on_both_backends(card, arch):
    """One state's first three steps on the cuda and reference backends
    (chip_smoke._bf16_lockstep's checks), the first two sending every
    worker, the third censoring every one (dsq near a tenth of eps1 ssq
    at eps1_scale 64)."""
    cfg = chip_smoke.bf16_pin_config(get, arch)
    tc = trainer.TrainConfig(num_workers=4, global_batch=8, seq_len=64,
                             steps=2, eps1_scale=4.0, alpha=0.05)
    out = chip_smoke._bf16_lockstep(arch, cfg, tc, card,
                                    scales=(4.0, 4.0, 64.0))
    assert [out[f"step{t}"]["transmitted"] for t in range(3)] == [
        4.0, 4.0, 0.0]
