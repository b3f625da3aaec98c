"""The port's B12a, B12b, B13 and B14 (their plain versions, on CPU
tensors) and the four single-tensor ``ops`` entry points, held against the
JAX package's Pallas kernels (interpret mode) and its oracles.

Tolerances and why:
  * B14 and B13, f32: rtol = atol = 2e-5, the JAX package's own for these
    kernels (tests/test_kernels.py); the blocked online softmax and the
    naive one sum in other orders;
  * B12a: rel 1e-5, both sides accumulate f32 squares in other orders;
  * B12b: exact, -0.0 and NaN included (a select copies bits);
  * ``hb_param_update``: exact against the JAX oracle; against the
    interpreted kernel within 2 eps of the terms, as in
    tests/test_torch_kernels.py (XLA may contract an FMA there).
The CUDA kernels themselves are held against these plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import censor as j_censor
from repro.kernels import decode_attention as j_decode
from repro.kernels import flash_attention as j_flash
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.models.kvcache import slot_positions as j_slot_positions
from repro_torch.kernels import (censor, common, decode_attention,
                                 flash_attention, ops, ref)

ATOL = RTOL = 2e-5


def _close(got: torch.Tensor, want, tol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def _qkv(b, h, kh, lq, s, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, lq, d)).astype(np.float32)
    k = rng.standard_normal((b, kh, s, d)).astype(np.float32)
    v = rng.standard_normal((b, kh, s, d)).astype(np.float32)
    return q, k, v


# ------------------------------------------------------------------ B14
@pytest.mark.parametrize("h,kh", [(4, 4), (8, 2)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 32),
                                           (False, None)],
                         ids=["causal", "window32", "full"])
def test_flash_plain_matches_jax_kernel_and_oracle(h, kh, causal, window):
    q, k, v = _qkv(2, h, kh, 128, 128, 32, seed=h + kh)
    got = flash_attention.flash_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal,
        window=window)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    _close(got, j_flash.flash_attention_pallas(
        jq, jk, jv, causal=causal, window=window, q_block=32, kv_block=64,
        interpret=True))
    _close(got, j_ref.flash_attention_fwd(jq, jk, jv, causal=causal,
                                          window=window))


@pytest.mark.parametrize("causal,window", [(False, None), (True, 24)],
                         ids=["full", "causal-window24"])
def test_flash_plain_rectangular(causal, window):
    """Lq != S: 64 queries against 256 keys (masks on absolute positions,
    no q offset, as the Pallas kernel has them)."""
    q, k, v = _qkv(1, 4, 2, 64, 256, 16, seed=4)
    got = flash_attention.flash_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal,
        window=window)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    _close(got, j_flash.flash_attention_pallas(
        jq, jk, jv, causal=causal, window=window, q_block=32, kv_block=64,
        interpret=True))
    _close(got, j_ref.flash_attention_fwd(jq, jk, jv, causal=causal,
                                          window=window))


def test_flash_takes_strided_views():
    """The model hands q, k, v over as (B, H, L, d) views of (B, L, H, d)."""
    q, k, v = _qkv(2, 4, 2, 40, 40, 16, seed=9)
    views = [torch.tensor(x).transpose(1, 2).contiguous().transpose(1, 2)
             for x in (q, k, v)]
    assert not views[0].is_contiguous()
    got = flash_attention.flash_attention(*views, window=8)
    want = flash_attention.flash_attention(
        *(torch.tensor(x) for x in (q, k, v)), window=8)
    assert torch.equal(got, want)


@pytest.mark.parametrize("lq,d,causal,window", [
    (1, 32, True, None), (127, 32, True, None), (128, 16, True, None),
    (129, 32, True, None), (129, 80, False, None), (200, 16, True, 60)],
    ids=["L1", "L127", "L128", "L129", "L129-d80-full", "L200-window60"])
def test_flash_plain_at_the_kernel_tile_edges(lq, d, causal, window):
    """The plain version (the CUDA kernel's oracle on the card) against the
    Pallas kernel and JAX's oracle where the kernel's 128-row query tiles
    and 64-key tiles end: Lq = S on either side of 128, d = 80 (zero-filled
    up to 128 in the kernel), and a 60-key window whose band crosses the
    query tile edge at 128."""
    q, k, v = _qkv(1, 4, 2, lq, lq, d, seed=lq + d)
    got = flash_attention.flash_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal,
        window=window)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    _close(got, j_flash.flash_attention_pallas(
        jq, jk, jv, causal=causal, window=window, interpret=True))
    _close(got, j_ref.flash_attention_fwd(jq, jk, jv, causal=causal,
                                          window=window))


def _views(b, h, lq, d, dtype=torch.float32):
    """(B, H, L, d) views of a contiguous (B, L, H, d), as the model
    passes them."""
    return torch.zeros((b, lq, h, d), dtype=dtype).transpose(1, 2)


def test_async_copy_path_for_the_models_views():
    """serve_long's operands (transposes of contiguous (B, L, H, 64)) and
    contiguous (B, H, L, d) tensors take the kernel's 16-byte cp.async
    copies."""
    qkv = [_views(8, 12, 2048, 64) for _ in range(3)]
    assert flash_attention.async_copy_ok(*qkv)
    assert flash_attention.async_copy_ok(torch.zeros(2, 4, 129, 80))


@pytest.mark.parametrize("case", ["d33", "offset", "last-stride", "bf16",
                                  "8-bytes-off"])
def test_async_copy_path_refuses_what_it_cannot_copy(case):
    """d = 33, a view one float (or two) off its storage's alignment, a
    non-unit last stride and bf16 take the kernel's element-by-element
    loads, and one such operand among three is enough."""
    good = _views(1, 4, 16, 64)
    if case == "d33":
        bad = _views(1, 4, 16, 33)
    elif case == "offset":
        bad = torch.zeros(1 * 16 * 4 * 64 + 1)[1:].view(1, 16, 4, 64) \
            .transpose(1, 2)
        assert bad.storage_offset() == 1
    elif case == "last-stride":
        bad = torch.zeros(1, 4, 16, 128)[..., ::2]
        assert bad.stride(-1) == 2
    elif case == "bf16":
        bad = _views(1, 4, 16, 64, torch.bfloat16)
    else:
        bad = torch.zeros(2 + 4 * 16 * 64)[2:].view(1, 4, 16, 64)
        assert bad.is_contiguous() and bad.data_ptr() % 16 == 8
    assert flash_attention.async_copy_ok(good)
    assert not flash_attention.async_copy_ok(bad)
    assert not flash_attention.async_copy_ok(good, good, bad)


# ------------------------------------------------------------------ B13
@pytest.mark.parametrize("h,kh", [(4, 4), (8, 2)])
@pytest.mark.parametrize("pos", [5, 63, 200])
def test_decode_plain_matches_jax_kernel_and_oracle(h, kh, pos):
    """C = 128; pos 5 leaves most slots empty, pos 200 wraps the ring."""
    rng = np.random.default_rng(7 * pos + h)
    b, c, d = 2, 128, 32
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, kh, c, d)).astype(np.float32)
    v = rng.standard_normal((b, kh, c, d)).astype(np.float32)
    cpos = np.asarray(j_slot_positions(jnp.asarray(pos + 1), c))
    got = decode_attention.decode_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        torch.tensor(cpos), pos)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
             jnp.asarray(cpos), jnp.asarray(pos))
    _close(got, j_decode.decode_attention_pallas(*jargs, block=32,
                                                 interpret=True))
    _close(got, j_decode.decode_attention_ref(*jargs))


def test_decode_plain_with_every_slot_empty():
    """No valid slot: every score is -1e30, so the softmax is uniform and
    the output the mean of v, in both packages."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 2, 64, 16)).astype(np.float32)
    v = rng.standard_normal((1, 2, 64, 16)).astype(np.float32)
    cpos = np.full((64,), -1, np.int32)
    got = decode_attention.decode_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        torch.tensor(cpos), 10)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
             jnp.asarray(cpos), jnp.asarray(10))
    _close(got, j_decode.decode_attention_pallas(*jargs, block=32,
                                                 interpret=True))
    _close(got, np.repeat(v.mean(axis=2), 2, axis=1))


def test_decode_takes_the_cache_as_a_transposed_view():
    """The model's cache is (B, C, K, d); the kernel sees (B, K, C, d)."""
    rng = np.random.default_rng(5)
    cache_k = torch.tensor(rng.standard_normal((2, 48, 2, 16)),
                           dtype=torch.float32)
    cache_v = torch.tensor(rng.standard_normal((2, 48, 2, 16)),
                           dtype=torch.float32)
    q = torch.tensor(rng.standard_normal((2, 4, 16)), dtype=torch.float32)
    cpos = torch.tensor(np.asarray(j_slot_positions(jnp.asarray(60), 48)))
    got = decode_attention.decode_attention(
        q, cache_k.transpose(1, 2), cache_v.transpose(1, 2), cpos, 59)
    want = decode_attention.decode_attention(
        q, cache_k.transpose(1, 2).contiguous(),
        cache_v.transpose(1, 2).contiguous(), cpos, 59)
    assert torch.equal(got, want)


# ----------------------------------------------------------- B12a, B12b
SHAPES = [(0,), (1,), (7, 13), (3, 5, 129)]
PAIRS = [(np.float32, np.float32), (np.float64, np.float64),
         (np.float64, np.float32)]


def _pair(shape, dg, dh, seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(shape).astype(dg)
    h = (g + 0.1 * rng.standard_normal(shape)).astype(dh)
    g.reshape(-1)[::5] = -0.0
    h.reshape(-1)[::7] = -0.0
    return g, h


def _bits(x: np.ndarray) -> np.ndarray:
    return x.view(np.uint32 if x.dtype == np.float32 else np.uint64)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dg,dh", PAIRS, ids=["f32", "f64", "f64-f32"])
def test_delta_sqnorm_plain_matches_jax(shape, dg, dh):
    g, h = _pair(shape, dg, dh, seed=len(shape))
    got = censor.censor_delta_sqnorm(torch.tensor(g), torch.tensor(h))
    assert got.dtype == torch.float32 and got.shape == ()
    want = j_censor.censor_delta_sqnorm(jnp.asarray(g), jnp.asarray(h),
                                        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(j_ref.censor_delta_sqnorm(jnp.asarray(g),
                                                          jnp.asarray(h))),
        rtol=1e-5)


def test_delta_sqnorm_casts_before_it_subtracts():
    """B12a casts g and ghat to f32 first; B1 subtracts in the bank dtype.
    At f64 the two differ, and B12a takes the JAX kernel's order."""
    g = np.array([1.0 + 2.0 ** -40], np.float64)
    h = np.array([1.0], np.float64)
    got = censor.censor_delta_sqnorm(torch.tensor(g), torch.tensor(h))
    assert float(got) == 0.0 == float(j_censor.censor_delta_sqnorm(
        jnp.asarray(g), jnp.asarray(h), interpret=True))
    assert float(censor.censor_delta_sqnorm_batched(
        torch.tensor(g[None]), torch.tensor(h[None]))[0]) > 0.0


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dg,dh", PAIRS, ids=["f32", "f64", "f64-f32"])
@pytest.mark.parametrize("transmit", [0, 1])
def test_select_plain_matches_jax_bitwise(shape, dg, dh, transmit):
    g, h = _pair(shape, dg, dh, seed=3 + len(shape))
    if g.size > 2:
        g.reshape(-1)[1] = np.nan
        h.reshape(-1)[2] = np.nan
    got = censor.censor_select(torch.tensor(g), torch.tensor(h), transmit)
    want = np.asarray(j_censor.censor_select(
        jnp.asarray(g), jnp.asarray(h), jnp.asarray(transmit),
        interpret=True))
    assert got.numpy().dtype == want.dtype == np.dtype(dh)
    assert np.array_equal(_bits(got.numpy()), _bits(want))
    oracle = np.asarray(j_ref.censor_select(jnp.asarray(g), jnp.asarray(h),
                                            jnp.asarray(transmit)))
    assert np.array_equal(_bits(got.numpy()), _bits(oracle))


def test_select_takes_an_integer_flag_only():
    g = torch.zeros(3)
    with pytest.raises(TypeError, match="transmit"):
        censor.censor_select(g, g, 0.5)
    with pytest.raises(ValueError, match="shape"):
        censor.censor_select(g, torch.zeros(4), 1)
    assert torch.equal(censor.censor_select(g + 1, g, torch.tensor(True)),
                       g + 1)


# -------------------------------------------- ops single-tensor entry points
@pytest.mark.parametrize("use_pallas", [True, False])
def test_ops_entry_points_match_jax(use_pallas):
    """Each of the four entry points, both ways, against the JAX package's
    jitted wrapper of the same name on the same inputs."""
    rng = np.random.default_rng(11)
    g = rng.standard_normal((33, 70)).astype(np.float32)
    h = rng.standard_normal((33, 70)).astype(np.float32)
    p = rng.standard_normal((33, 70)).astype(np.float32)
    tg, th, tp = (torch.tensor(x) for x in (g, h, p))
    jg, jh, jp = (jnp.asarray(x) for x in (g, h, p))
    common.reset_launches()
    np.testing.assert_allclose(
        ops.censor_delta_sqnorm(tg, th, use_pallas=use_pallas).numpy(),
        np.asarray(j_ops.censor_delta_sqnorm(jg, jh, use_pallas=use_pallas)),
        rtol=1e-5)
    for t in (0, 1):
        got = ops.censor_select(tg, th, t, use_pallas=use_pallas).numpy()
        want = np.asarray(j_ops.censor_select(jg, jh, jnp.asarray(t),
                                              use_pallas=use_pallas))
        assert np.array_equal(_bits(got), _bits(want))
    got = ops.hb_param_update(tg, th, tp, 0.05, 0.4,
                              use_pallas=use_pallas).numpy()
    assert np.array_equal(_bits(got), _bits(np.asarray(
        j_ref.hb_update(jg, jh, jp, 0.05, 0.4))))
    jitted = np.asarray(j_ops.hb_param_update(jg, jh, jp, 0.05, 0.4,
                                              use_pallas=use_pallas))
    terms = np.abs(g) + np.abs(0.05 * h) + np.abs(0.4 * (g - p))
    assert np.all(np.abs(got - jitted) <= 2 * np.finfo(np.float32).eps
                  * terms)
    q, k, v = _qkv(1, 4, 2, 48, 48, 16, seed=12)
    got = ops.flash_attention_fwd(torch.tensor(q), torch.tensor(k),
                                  torch.tensor(v), window=16,
                                  use_pallas=use_pallas)
    _close(got, j_ops.flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=16,
        q_block=16, kv_block=16, use_pallas=use_pallas))
    # on CPU tensors no kernel launches, whichever way
    assert not any(common.LAUNCHES.values())


def test_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros(1, 3, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="cache_pos"):
        decode_attention.decode_attention(
            torch.zeros(1, 2, 16), k, k, torch.zeros(8, dtype=torch.int64), 3)
    with pytest.raises(TypeError, match="dtype"):
        censor.censor_delta_sqnorm(torch.zeros(2, dtype=torch.int32),
                                   torch.zeros(2, dtype=torch.int32))
    assert ref.NEG == -1e30
