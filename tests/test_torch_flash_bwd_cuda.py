"""The flash backward kernel on its design's edge cases, on the card.

Marked ``cuda``: these need an NVIDIA card with ``nvcc`` and skip without
one (tests/test_torch_flash_bwd_plan.py holds the kernel's plan against
the mask on the CPU). On a card they run with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_bwd_cuda.py

The kernel walks key tiles (32 keys) against query tiles (64 rows at
d <= 64, 32 above), writes each pair's dq partial to a slot, and its last
grid sums each query tile's slots in key-tile order. Each case
holds dq, dk and dv to the rule of ``chip_smoke.py``'s B13/B14 checks
(the kernel's max abs error against an f64 version at most ATTN_FACTOR
times the f32 plain version's plus ATTN_FLOOR), the same bits over three
calls (no float atomics), and one count of ``flash_attention_bwd`` a call.
Cases: L one row past and one row short of a multiple of each tile; G =
1, 2, 4 and 6; a window of 16 on 64-row tiles, causal and not; rows with
no valid key in a tile that also holds valid rows; d = 33 on views one
element off alignment (the element loads); then two shapes called in
turns, a call on a stream of its own, and a scratch of the wrong size,
which the launcher refuses.
"""
import ctypes
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the repository root's script)
from repro_torch.kernels import (build, common, flash_attention,  # noqa: E402
                                 flash_backward, ref)

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
    (1, 4, 2, 100, 100, 64, True, None, 0),     # G = 2
    (1, 8, 2, 100, 100, 64, True, None, 0),     # G = 4
    (1, 12, 2, 100, 100, 64, True, None, 0),    # G = 6
    (1, 4, 2, 200, 200, 64, True, 16, 0),       # window 16, 64-row tiles
    (1, 4, 2, 200, 200, 64, False, 16, 0),
    (1, 4, 2, 150, 100, 64, True, 20, 0),       # rows 119+ have no key
    (1, 4, 2, 97, 97, 33, True, 16, 1),         # d = 33, misaligned
    (2, 4, 2, 65, 63, 33, False, None, 1),
]
IDS = [f"b{c[0]}h{c[1]}k{c[2]}q{c[3]}s{c[4]}d{c[5]}"
       f"{'c' if c[6] else 'n'}w{c[7]}o{c[8]}" for c in CASES]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bits(t):
    return t.view(torch.int32)


def _inputs(case, device, seed):
    """q, k, v, dO as the model's (B, H, L, d) views (``offset`` elements
    into their storage), and B14's o and lse of them."""
    b, h, kh, lq, s_len, d, causal, window, off = case
    gen = torch.Generator(device=device).manual_seed(seed)

    def view(n, x):
        flat = torch.randn(off + b * n * x * d, generator=gen, device=device)
        return flat[off:].view(b, n, x, d).transpose(1, 2)

    q, k, v, do = view(lq, h), view(s_len, kh), view(s_len, kh), view(lq, h)
    o, lse = flash_attention.flash_attention(q, k, v, causal=causal,
                                             window=window, return_lse=True)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_backward_edge_cases(card, case):
    b, h, kh, lq, s_len, d, causal, window, off = case
    q, k, v, o, lse, do = _inputs(case, card, lq + 3 * d + off)
    kw = {"causal": causal, "window": window}
    assert flash_attention.async_copy_ok(q) == (d % 4 == 0 and off == 0)
    runs = []
    for _ in range(3):
        common.reset_launches()
        runs.append(flash_backward.flash_attention_bwd(q, k, v, o, lse, do,
                                                       **kw))
        torch.cuda.synchronize()
        assert {n: c for n, c in common.LAUNCHES.items() if c} == {
            "flash_attention_bwd": 1}
    plain = ref.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    exact = chip_smoke.flash_bwd_f64(q, k, v, do, causal, window)
    for name, got, pl, ex, like in zip(("dq", "dk", "dv"), runs[0], plain,
                                       exact, (q, k, v)):
        assert got.dtype == torch.float32 and got.shape == like.shape
        assert got.stride() == like.stride(), name
        err_k = float((got.double() - ex).abs().max())
        err_p = float((pl.double() - ex).abs().max())
        assert err_k <= chip_smoke.ATTN_FACTOR * err_p + \
            chip_smoke.ATTN_FLOOR, (name, err_k, err_p)
    for again in runs[1:]:
        assert all(torch.equal(_bits(a), _bits(b_))
                   for a, b_ in zip(runs[0], again))


def test_two_shapes_in_turns(card):
    """Two calls of different plans alternate (the scratch of one does
    not leak into the other): each repeats its first bits."""
    ca, cb = CASES[1], CASES[13]
    ins = {c: _inputs(c, card, 7) for c in (ca, cb)}
    first = {}
    for c in (ca, cb, ca, cb, ca, cb):
        kw = {"causal": c[6], "window": c[7]}
        got = flash_backward.flash_attention_bwd(*ins[c], **kw)
        if c not in first:
            first[c] = got
        else:
            assert all(torch.equal(_bits(a), _bits(b_))
                       for a, b_ in zip(first[c], got))


def test_call_on_a_stream_of_its_own(card):
    """The kernel launches on PyTorch's current stream: a side stream's
    call gives the default stream's bits."""
    case = CASES[12]
    q, k, v, o, lse, do = _inputs(case, card, 11)
    kw = {"causal": case[6], "window": case[7]}
    want = flash_backward.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(card)
    with torch.cuda.stream(side):
        got = flash_backward.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    side.synchronize()
    assert all(torch.equal(_bits(a), _bits(b_)) for a, b_ in zip(want, got))


def test_launcher_refuses_a_scratch_of_another_size(card):
    case = CASES[0]
    q, k, v, o, lse, do = _inputs(case, card, 5)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    need = flash_backward.plan(*case[:5], case[5], case[6],
                               case[7]).scratch_bytes
    scratch = torch.empty(need + 16, dtype=torch.uint8, device=card)
    dims = flash_backward._dims(q, k, v, o, do, dq, dk, dv, case[6],
                                case[7], need + 16)
    with pytest.raises(RuntimeError, match="CUDA error"):
        build.launch("flash_backward", "flash_attention_bwd_f32", q.device,
                     q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     do.data_ptr(), lse.data_ptr(), dq.data_ptr(),
                     dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(),
                     ctypes.addressof(dims), float(case[5] ** -0.5))
