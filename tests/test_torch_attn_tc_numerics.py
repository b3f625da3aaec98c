"""The arithmetic of B14's bf16 tensor-core kernel, emulated in plain torch
on the CPU and held against the JAX package.

``csrc/flash_attention.cu:flash_tc_kernel`` runs both products of the
flash forward on the bf16 tensor cores with f32 accumulation: S = Q K^T
of bf16 operands (exact products, f32 sums), the scale applied after the
product, JAX's online softmax in f32 over key tiles of 64, and O += P V
as two products, p_hi = bf16(p) and p_lo = bf16(p - p_hi), into one f32
accumulator, with expf for the exps. ``tc_flash`` below repeats that
arithmetic tile by tile (only the order of the f32 sums inside a product,
and an exp's last bits, torch.exp's against CUDA's expf, may differ from
the card's).
The card itself is held to the same rules by
tests/test_torch_attn_tc_cuda.py and ``chip_smoke.py``.

Tolerances and why:
  * the split: p_hi + p_lo within 2^-16 |p| of p (two roundings of 8
    significant bits), the bound the kernel's note states;
  * against the Pallas kernel (interpret mode) at small seeded inputs:
    the emulation's max abs error against ``chip_smoke._flash_f64`` at most
    ``chip_smoke.ATTN_FACTOR`` times the Pallas kernel's plus
    ``ATTN_FLOOR``, over the whole output and on each row (query), the rule
    the card holds B14 to (``chip_smoke._attn_check``); its log-sum-exp the
    same against ``chip_smoke._lse_f64`` and the port's plain version;
  * at the full depth of qwen3-4b and gemma3-12b (narrow widths), the
    emulation in place of the plain prefill attention moves the logits by
    at most DEPTH_ULPS bf16 ulps of the largest |logit|, the carry
    tests/test_torch_serve_bf16.py bounds for summation order, under
    ``chip_smoke.SERVE_BF16_LOGIT_ULPS``.
The file also holds the bf16 kernels' host rules: which views take the
TMA / 16-byte path, that the predicates keep no reference to what they
look at, and the C arity of B13 bf16's entry points.
"""
import dataclasses
import gc
import re
import sys
import weakref
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the repository root's script)
from repro.kernels import flash_attention as j_flash
from repro_torch import convert
from repro_torch import random as jrandom
from repro_torch.configs import get
from repro_torch.kernels import build, decode_attention, flash_attention, ref
from repro_torch.launch import serve
from repro_torch.models import model

#: keys of one of the kernel's tiles (kTcBN in csrc/flash_attention.cu)
TILE = 64
#: the carry of attention's rounding flips through every layer
#: (tests/test_torch_serve_bf16.py's DEPTH_ULPS)
DEPTH_ULPS = 3
F32 = torch.float32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the port's CPU work here: in a parallel test
    run a pool of threads in every worker process contends for the same
    cores, and the full-depth runs and the weights' PRNG then run dozens
    of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tc_flash(q, k, v, *, causal=True, window=None, scale=None,
             return_lse=False):
    """B14's bf16 tensor-core arithmetic in plain torch: q (B, H, Lq, d),
    k, v (B, K, S, d) in bf16; the online softmax over key tiles of TILE;
    out in bf16 (and the f32 log-sum-exp with ``return_lse``)."""
    b, h, lq, d = q.shape
    kh, s_len = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    q5 = q.to(F32).reshape(b, kh, h // kh, lq, d)
    m = torch.full((b, kh, h // kh, lq), -1e30, dtype=F32)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kh, h // kh, lq, d), dtype=F32)
    qpos = torch.arange(lq)[:, None]
    for k0 in range(0, s_len, TILE):
        kt = k[:, :, k0:k0 + TILE].to(F32)
        vt = v[:, :, k0:k0 + TILE].to(F32)
        s = torch.einsum("bkgqd,bksd->bkgqs", q5, kt) * scale
        kpos = k0 + torch.arange(kt.shape[2])[None, :]
        mask = torch.ones((lq, kt.shape[2]), dtype=torch.bool)
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        s = torch.where(mask, s, torch.tensor(-1e30, dtype=F32))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        p_hi = p.to(torch.bfloat16).to(F32)
        p_lo = (p - p_hi).to(torch.bfloat16).to(F32)
        acc = acc * alpha[..., None] \
            + torch.einsum("bkgqs,bksd->bkgqd", p_hi, vt) \
            + torch.einsum("bkgqs,bksd->bkgqd", p_lo, vt)
        m = m_new
    ls = torch.clamp(l, min=1e-37)
    out = (acc / ls[..., None]).reshape(b, h, lq, d).to(q.dtype)
    if not return_lse:
        return out
    return out, (m + torch.log(ls)).reshape(b, h, lq)


def _bf16_qkv(b, h, kh, lq, s, d, seed):
    """Seeded normal q, k, v as bf16 values: torch tensors and jnp arrays
    of the same bits."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((b, h, lq, d), (b, kh, s, d), (b, kh, s, d)):
        x = convert.bf16_values(rng.standard_normal(shape))
        out.append((torch.tensor(x).bfloat16(),
                    jnp.asarray(x).astype(jnp.bfloat16)))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_the_split_keeps_p_within_its_bound(seed):
    """p_hi + p_lo is p within 2^-16 |p| across p's range in (0, 1]."""
    rng = np.random.default_rng(seed)
    p = torch.tensor(np.exp(-rng.uniform(0, 80, 100_000)), dtype=F32)
    p_hi = p.to(torch.bfloat16).to(F32)
    p_lo = (p - p_hi).to(torch.bfloat16).to(F32)
    assert torch.equal(p - p_hi + p_hi, p)           # p - p_hi is exact
    err = (p_hi.double() + p_lo.double() - p.double()).abs()
    assert bool((err <= 2.0 ** -16 * p.double()).all())
    assert float(err.max()) > 0                      # the bound is reached


# (h, kh, lq, s, d, causal, window): GQA 1, 2 and 4; d 64, 128, 256; Lq and
# S off the 64-key tile; causal, windowed (a band crossing the tile edge),
# non-causal rectangular, and Lq > S under a window, whose last rows have
# no valid key (the mean of v)
CASES = [
    (2, 2, 65, 65, 64, True, None),
    (4, 2, 100, 100, 128, True, 40),
    (8, 2, 129, 129, 64, True, None),
    (4, 1, 70, 70, 256, True, None),
    (4, 2, 63, 129, 128, False, None),
    (4, 4, 127, 127, 256, True, 64),
    (4, 2, 150, 80, 64, True, 16),
]


@pytest.mark.parametrize("case", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_tc_arithmetic_within_the_card_rule_of_the_pallas_kernel(case):
    h, kh, lq, s_len, d, causal, window = case
    (q, jq), (k, jk), (v, jv) = _bf16_qkv(1, h, kh, lq, s_len, d,
                                          seed=lq + d + h)
    exact = chip_smoke._flash_f64(q, k, v, causal, window)
    got, lse = tc_flash(q, k, v, causal=causal, window=window,
                        return_lse=True)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = j_flash.flash_attention_pallas(jq, jk, jv, causal=causal,
                                          window=window, interpret=True)
    assert want.dtype == jnp.bfloat16
    want = torch.tensor(np.asarray(want.astype(jnp.float32))).bfloat16()
    chip_smoke._attn_check(got, want, exact, "tc emulation")
    # the log-sum-exp (training's forward) against the plain version's
    lse_exact = chip_smoke._lse_f64(q, k, causal, window)
    _, lse_plain = ref.flash_attention_fwd(q, k, v, causal=causal,
                                           window=window, return_lse=True)
    err_l = float((lse.double() - lse_exact).abs().max())
    err_lp = float((lse_plain.double() - lse_exact).abs().max())
    assert err_l <= chip_smoke.ATTN_FACTOR * err_lp + chip_smoke.ATTN_FLOOR


def _depth_config(arch):
    """``arch`` at every layer (pattern, window ring, superblocks) with
    narrow widths: d 256, 4 heads over 2 kv heads of 64, vocab 4096."""
    full = get(arch)
    return dataclasses.replace(
        full, d_model=256, d_ff=1024, vocab_size=4096, num_heads=4,
        num_kv_heads=2, head_dim=64,
        sliding_window=min(full.sliding_window, 32)).validate()


def _scale_ulps(got, want) -> float:
    """Largest difference in bf16 ulps of ``want``'s largest magnitude."""
    diff = float((got.double() - want.double()).abs().max())
    return diff / chip_smoke.bf16_ulp(float(want.abs().max()))


@pytest.mark.parametrize("arch", list(chip_smoke.SERVE_BF16_ARCHS))
def test_tc_arithmetic_carries_within_the_card_tolerance(arch, monkeypatch):
    """The reference backend at the model's full depth with the emulated
    tensor-core arithmetic in place of the plain prefill attention,
    teacher-forced with the plain run's tokens: the logits stay within
    DEPTH_ULPS of the largest |logit|."""
    cfg = _depth_config(arch)
    assert cfg.num_layers == {"qwen3-4b": 36, "gemma3-12b": 48}[arch]
    params = model.init_params(jrandom.PRNGKey(0, device="cpu"), cfg)
    prompts = serve.prompts_of(cfg, 2, 80, "cpu")
    plain = serve.generate(params, cfg, prompts, 4, backend="reference",
                           device="cpu")
    monkeypatch.setattr(ref, "flash_attention_fwd", tc_flash)
    tc = serve.generate(params, cfg, prompts, 4, backend="reference",
                        feed=plain.tokens, device="cpu")
    a, b = torch.stack(plain.logits), torch.stack(tc.logits)
    assert not torch.equal(a, b)             # the arithmetic does differ
    assert _scale_ulps(b, a) <= DEPTH_ULPS
    assert DEPTH_ULPS < chip_smoke.SERVE_BF16_LOGIT_ULPS


# ------------------------------------------- the bf16 kernels' host rules
def _views(b, h, l, d, dtype=torch.bfloat16, off=0):
    """(B, H, L, d) views of a (B, L, H, d) tensor ``off`` elements into
    its storage, as the models pass them."""
    flat = torch.zeros(off + b * l * h * d, dtype=dtype)
    return flat[off:].view(b, l, h, d).transpose(1, 2)


@pytest.mark.parametrize("case,want", [("model", True), ("d72", True),
                                       ("d33", False), ("offset", False),
                                       ("last-stride", False),
                                       ("f32", False)])
def test_tc_copy_path_is_taken_exactly_where_tma_can_copy(case, want):
    """The bf16 kernel's TMA path (flash_attention.tc_copy_ok) and the
    bf16 decode kernel's 16-byte copies (decode_attention.cache_copy_ok):
    a unit last stride, the head dim and the other strides multiples of 8
    elements, 16-byte aligned bases."""
    t = {"model": lambda: _views(2, 8, 16, 128),
         "d72": lambda: _views(1, 4, 16, 72),
         "d33": lambda: _views(1, 4, 16, 33),
         "offset": lambda: _views(1, 4, 16, 64, off=1),
         "last-stride": lambda: _views(1, 4, 16, 128)[..., ::2],
         "f32": lambda: _views(1, 4, 16, 64, torch.float32)}[case]()
    assert flash_attention.tc_copy_ok(t, t, t) == want
    if case != "f32":
        assert decode_attention.cache_copy_ok(t, t) == want
    assert not flash_attention.tc_copy_ok(_views(1, 4, 16, 64), t) \
        or want


def test_the_copy_predicates_keep_no_reference():
    """The predicates run on every launch: they must not hold the tensors
    they look at (a cache on them kept every prefill's q, k and v alive)."""
    t = _views(1, 4, 16, 64)
    ref_t = weakref.ref(t)
    flash_attention.tc_copy_ok(t, t, t)
    flash_attention.async_copy_ok(t)
    decode_attention.cache_copy_ok(t, t)
    flash_attention.copy_flag(t, t, t)
    del t
    gc.collect()
    assert ref_t() is None


@pytest.mark.parametrize("fn", ["decode_attention_bf16",
                                "decode_attention_bf16_chunk"])
def test_decode_bf16_entry_points_are_bound_with_their_c_arity(fn):
    """B13 bf16's launcher and its plan query (the slots of one partial,
    which the kernel's library works out from its own launch
    configuration) are bound in ``build.SIGNATURES`` with the arity of
    their C definitions."""
    src = (build.CSRC / "decode_attention.cu").read_text()
    found = re.search(rf"\bint {fn}\(([^)]*)\)", src)
    assert found, f"{fn} is not defined in decode_attention.cu"
    assert len(build.SIGNATURES["decode_attention"][fn]) \
        == len(found.group(1).split(","))
