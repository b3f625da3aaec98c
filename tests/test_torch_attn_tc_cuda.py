"""B14's bf16 tensor-core kernel and B13's bf16 kernel on their edges, on
the card.

Marked ``cuda``: these need an NVIDIA card with ``nvcc`` and skip without
one (tests/test_torch_attn_tc_numerics.py holds the tensor-core arithmetic
against the JAX package on the CPU). On a card they run with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_attn_tc_cuda.py

B14 in bf16 (``flash_tc_kernel``: 128-row blocks of two warpgroups, 64-key
tiles) at Lq and S in {1, 63, 64, 65, 127, 129, 2047}, head dims 33, 64,
72, 128 and 256, GQA 1 to 8, windows whose band crosses a tile edge, rows
with no valid key (Lq > S under a window), views one element off their
storage's alignment (the element-by-element loads) and rectangular
non-causal shapes; with its log-sum-exp too. B13 in bf16
(``decode_bf16_partials``) at C in {1, 31, 257, 2081}, a wrapped ring, an
empty cache, two head groups, head dims 64 to 256 and a strided cache (the
element loads). Each against its plain version and an f64 version of the
same function: the kernel's max abs error against f64 at most
``chip_smoke.ATTN_FACTOR`` times the plain version's plus ``ATTN_FLOOR``,
over the whole tensor and on each row (query) of a bf16 output; one
launch a call; the same bits twice. And B13 bf16's chunk plan, which the
kernel's library works out for the card, at the served models' shapes.
"""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the repository root's script)
from repro_torch.kernels import common, decode_attention, flash_attention, ref
from repro_torch.models.kvcache import slot_positions

pytestmark = pytest.mark.cuda
BF = torch.bfloat16


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rule(kernel, plain, exact):
    """chip_smoke's B13/B14 rule: over the whole tensor and, for a bf16
    output, row by row."""
    chip_smoke._attn_check(kernel, plain, exact, "rule")


def _same_bits(a, b):
    return torch.equal(a.view(torch.int16), b.view(torch.int16))


# (b, h, kh, lq, s, d, causal, window, offset)
FLASH_CASES = [
    *[(1, 8, 2, n, n, 128, True, None, 0)
      for n in (1, 63, 64, 65, 127, 129, 2047)],
    *[(2, 4, 2, 129, 129, d, True, None, 0) for d in (33, 64, 72, 256)],
    (1, 4, 4, 200, 200, 64, True, 48, 0),      # G 1, band crosses 64 keys
    (1, 6, 3, 300, 300, 128, True, 100, 0),    # G 2
    (1, 8, 2, 257, 257, 256, True, 65, 0),     # G 4
    (1, 8, 1, 190, 190, 64, True, 7, 0),       # G 8, a narrow band
    (1, 8, 2, 1030, 1030, 256, True, 1024, 0),
    (1, 4, 2, 77, 333, 128, False, None, 0),   # rectangular, no mask
    (1, 4, 2, 200, 150, 72, False, 40, 0),
    (1, 4, 2, 150, 80, 64, True, 16, 0),       # rows with no valid key
    (1, 4, 2, 300, 140, 128, True, 30, 0),
    (2, 8, 4, 130, 130, 128, True, None, 1),   # off alignment
    (1, 4, 2, 129, 129, 33, True, 50, 1),
]


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=["-".join(map(str, c)) for c in FLASH_CASES])
def test_flash_bf16_on_its_edges(card, case):
    b, h, kh, lq, s_len, d, causal, window, off = case
    gen = torch.Generator(device=card).manual_seed(lq + 7 * d + h)

    def view(n, x):
        """A (B, n, x, d) view of a (B, x, n, d) tensor, ``off`` elements
        into its storage."""
        flat = torch.randn(off + b * n * x * d, generator=gen,
                           device=card).to(BF)
        return flat[off:].view(b, x, n, d).transpose(1, 2)

    q, k, v = view(h, lq), view(kh, s_len), view(kh, s_len)
    assert flash_attention.tc_copy_ok(q, k, v) == (d % 8 == 0 and off == 0)
    common.reset_launches()
    out = flash_attention.flash_attention(q, k, v, causal=causal,
                                          window=window)
    assert common.LAUNCHES["flash_attention"] == 1
    assert out.dtype == BF and out.shape == (b, h, lq, d)
    plain = ref.flash_attention_fwd(q, k, v, causal=causal, window=window)
    _rule(out, plain, chip_smoke._flash_f64(q, k, v, causal, window))
    assert _same_bits(out, flash_attention.flash_attention(
        q, k, v, causal=causal, window=window))
    out_l, lse = flash_attention.flash_attention(
        q, k, v, causal=causal, window=window, return_lse=True)
    assert _same_bits(out_l, out)
    _, lse_p = ref.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == lse_p.shape
    _rule(lse, lse_p, chip_smoke._lse_f64(q, k, causal, window))
    _, again = flash_attention.flash_attention(
        q, k, v, causal=causal, window=window, return_lse=True)
    assert torch.equal(lse.view(torch.int32), again.view(torch.int32))


# (b, h, kh, c, d, pos; None: every slot empty, strided)
DECODE_CASES = [
    (2, 8, 8, 1, 64, 0, False),
    (3, 8, 4, 31, 128, 40, False),
    (2, 8, 2, 257, 128, 300, False),         # a wrapped ring
    (8, 32, 8, 2081, 128, 2078, False),      # qwen3-4b's last step
    (8, 16, 8, 2081, 256, 2078, False),      # gemma3-12b's "A" layers
    (8, 16, 8, 1024, 256, 2078, False),      # ... its "S" ring, wrapped
    (2, 4, 2, 97, 64, None, False),          # empty: the mean of v
    (1, 32, 2, 97, 64, 50, False),           # G 16: two head groups
    (2, 8, 2, 257, 256, 120, True),          # strided: the element loads
]


@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=["-".join(map(str, c)) for c in DECODE_CASES])
def test_decode_bf16_on_its_edges(card, case):
    b, h, kh, c, d, pos, strided = case
    gen = torch.Generator(device=card).manual_seed(c + d + h)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=card).to(BF)

    q = randn(b, h, d)
    if strided:    # every other element of a (B, C, K, 2d) cache
        k, v = (randn(b, c, kh, 2 * d)[..., ::2].transpose(1, 2)
                for _ in range(2))
    else:          # (B, K, C, d) views of the model's (B, C, K, d) cache
        k, v = (randn(b, c, kh, d).transpose(1, 2) for _ in range(2))
    assert decode_attention.cache_copy_ok(k, v) == (not strided)
    if pos is None:
        cpos, pos = torch.full((c,), -1, dtype=torch.int32,
                               device=card), 10
    else:
        cpos = slot_positions(pos + 1, c, card)
    common.reset_launches()
    out = decode_attention.decode_attention(q, k, v, cpos, pos)
    assert common.LAUNCHES["decode_attention"] == 1
    assert out.dtype == BF and out.shape == (b, h, d)
    plain = ref.decode_attention_ref(q, k, v, cpos, pos)
    _rule(out, plain, chip_smoke._decode_f64(q, k, v, cpos, pos))
    assert _same_bits(out, decode_attention.decode_attention(
        q, k, v, cpos, pos))


@pytest.mark.parametrize("h,kh,d,c,chunk", [(32, 8, 128, 2081, 192),
                                            (16, 8, 256, 2081, 352),
                                            (16, 8, 256, 1024, 192)])
def test_decode_plan_fills_one_wave_at_the_models_shapes(card, h, kh, d, c,
                                                         chunk):
    """B13 bf16's chunks at qwen3-4b's and gemma3-12b's last serve_long
    step (B 8, K 8) on an H100 (132 SMs; 6 resident blocks at d 128, 3 at
    256): whole 32-slot sub-tiles, one wave, a few partials a (b, h)."""
    index = card.index or 0
    assert common.sm_count(index) == 132
    got = decode_attention.plan(8, h, kh, c, d, index)
    assert got == chunk and got % 32 == 0
    assert decode_attention.plan(8, h, kh, 1, d, index) == 32
    assert decode_attention.plan(64, h, kh, c, d, index) >= chunk
