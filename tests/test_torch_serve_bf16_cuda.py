"""Serving's attention kernels in bf16 at the dense bf16 configs' shapes,
on the card.

Marked ``cuda``: these need an NVIDIA card with ``nvcc`` and skip without
one (tests/test_torch_serve_bf16.py holds the plain versions and the model
against the JAX package on the CPU). On a card they run with

    PYTHONPATH=src python -m pytest -q -m cuda \\
        tests/test_torch_serve_bf16_cuda.py

B14 at one batch row of qwen3-4b's and gemma3-12b's serve_long prefill
(GQA 32/8 at head dim 128; 16/8 at 256, causal and gemma3's window 1024)
and B13 at their last serve_long decode step (full caches and gemma3's
wrapped 1024-slot ring), on the model's strided views, against their
plain versions and an f64 version of the same function: the kernel's max
abs error against f64 at most ATTN_FACTOR times the plain version's plus
ATTN_FLOOR, over the whole tensor and on each row (query) (the rule
``chip_smoke.py`` holds B13/B14 to); one launch a
call, the same bits twice. Then ``launch.serve.generate`` of a reduced
bf16 gemma3-12b on both backends: the launch counts of a prefill and its
steps, logits within chip_smoke.SERVE_BF16_LOGIT_ULPS of the largest.
``chip_smoke.py`` phase serve_bf16 runs both models at full width.
"""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the repository root's script)
from repro_torch import random as jrandom
from repro_torch.configs import get
from repro_torch.kernels import common, decode_attention, flash_attention, ref
from repro_torch.launch import serve
from repro_torch.models import model
from repro_torch.models.kvcache import slot_positions

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rule(kernel, plain, exact):
    """chip_smoke's B13/B14 rule: over the whole tensor and, for a bf16
    output, row by row."""
    chip_smoke._attn_check(kernel, plain, exact, "rule")


# (h, kh, d, window): qwen3-4b; gemma3-12b's "A" and "S" layers
@pytest.mark.parametrize("h,kh,d,window", [(32, 8, 128, None),
                                           (16, 8, 256, None),
                                           (16, 8, 256, 1024)])
def test_flash_bf16_at_the_models_prefill(card, h, kh, d, window):
    gen = torch.Generator(device=card).manual_seed(h + d)
    l = 2048

    def view(n):
        """(1, n, L, d) view of a (1, L, n, d) tensor, as the model's."""
        return torch.randn((1, l, n, d), generator=gen, device=card) \
            .to(torch.bfloat16).transpose(1, 2)
    q, k, v = view(h), view(kh), view(kh)
    assert not flash_attention.async_copy_ok(q, k, v)
    common.reset_launches()
    out = flash_attention.flash_attention(q, k, v, causal=True,
                                          window=window)
    assert common.LAUNCHES["flash_attention"] == 1
    assert out.dtype == torch.bfloat16 and out.shape == (1, h, l, d)
    plain = ref.flash_attention_fwd(q, k, v, causal=True, window=window)
    _rule(out, plain, chip_smoke._flash_f64(q, k, v, True, window))
    again = flash_attention.flash_attention(q, k, v, causal=True,
                                            window=window)
    assert torch.equal(out.view(torch.int16), again.view(torch.int16))


# (h, kh, d, c): qwen3-4b; gemma3-12b's full cache and its wrapped ring
@pytest.mark.parametrize("h,kh,d,c", [(32, 8, 128, 2081), (16, 8, 256, 2081),
                                      (16, 8, 256, 1024)])
def test_decode_bf16_at_the_models_last_step(card, h, kh, d, c):
    gen = torch.Generator(device=card).manual_seed(h + d + c)
    b, pos = 8, 2078

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=card) \
            .to(torch.bfloat16)
    q = randn(b, h, d)
    k, v = (randn(b, c, kh, d).transpose(1, 2) for _ in range(2))
    cpos = slot_positions(pos + 1, c, card)
    common.reset_launches()
    out = decode_attention.decode_attention(q, k, v, cpos, pos)
    assert common.LAUNCHES["decode_attention"] == 1
    assert out.dtype == torch.bfloat16 and out.shape == (b, h, d)
    plain = ref.decode_attention_ref(q, k, v, cpos, pos)
    _rule(out, plain, chip_smoke._decode_f64(q, k, v, cpos, pos))
    again = decode_attention.decode_attention(q, k, v, cpos, pos)
    assert torch.equal(out.view(torch.int16), again.view(torch.int16))


def test_generate_bf16_on_both_backends(card):
    """A narrow gemma3-12b in bf16 at head dim 256, two superblocks of
    "SSSSSA" (window 16, so its rings wrap), on the card: B14 once a layer in
    the prefill, B13 once a layer a step, logits of the two backends
    within the card's tolerance."""
    full = get("gemma3-12b")
    cfg = dataclasses.replace(
        full, num_layers=12, d_model=256, d_ff=1024, vocab_size=512,
        num_heads=4, num_kv_heads=2, sliding_window=16).validate()
    params = model.init_params(jrandom.PRNGKey(0, device=card), cfg)
    prompts = serve.prompts_of(cfg, 2, 40, card)
    ref_run = serve.generate(params, cfg, prompts, 6, backend="reference",
                             device=card)
    common.reset_launches()
    cud = serve.generate(params, cfg, prompts, 6, feed=ref_run.tokens,
                         device=card)
    assert common.LAUNCHES["flash_attention"] == cfg.num_layers
    assert common.LAUNCHES["decode_attention"] == cfg.num_layers * 5
    assert not torch.backends.cuda.matmul \
        .allow_bf16_reduced_precision_reduction
    a, b = torch.stack(cud.logits), torch.stack(ref_run.logits)
    tol = chip_smoke.SERVE_BF16_LOGIT_ULPS * chip_smoke.bf16_ulp(
        float(b.abs().max()))
    assert float((a - b).abs().max()) <= tol
