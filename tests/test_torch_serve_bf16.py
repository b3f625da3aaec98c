"""Serving the dense bf16 configs: the port against the JAX package.

qwen3-4b, gemma3-12b, phi3-medium-14b and nemotron-4-15b, each reduced
(``reduced()`` in bf16: d 256, 4 heads, vocab 512) and as
``chip_smoke.bf16_pin_config`` has it (GQA 4/2 at the model's head dim,
128 or gemma3's 256; gemma3 in two "SA" superblocks with a 16-slot ring
that wraps). Weights come from ``convert.numpy_model_params`` (bf16
values), carried into both packages exactly.

bf16 values are compared in ulps, the spacing of bf16 at a value's
binade (8 significant bits). Tolerances and why:
  * ``init_params(PRNGKey(0))``: bit for bit (the f32 normals agree within
    4 f32 ulps, tests/test_torch_models.py, and none of them sits on a bf16
    rounding edge here);
  * elementwise layers (rmsnorm, RoPE, q/k norm, the activations): each
    element within ELEMENT_ULPS of itself; both sides compute in f32 and
    round once, and an f32 result a few f32 ulps apart may round to the
    other neighbour;
  * layers that end in a sum (the q/k/v projections, attention, decode
    attention, the MLP) against eager JAX, and the plain B13/B14 against
    the Pallas kernels: within SUM_ULPS of the tensor's largest magnitude.
    A sum's f32 error scales with its terms, not its result, and one input
    of the sum that rounded the other way moves the result by its own ulp
    times a weight, whatever the result's size;
  * ``prefill``'s last logits, every cache leaf and the teacher-forced
    ``serve_step`` logits against JAX's ``prefill`` / ``serve_step``
    (jitted, as its ``launch.serve`` runs them): within MODEL_ULPS of each
    tensor's largest magnitude, the flips above carried through two
    layers and the head; greedy tokens equal wherever JAX's top-2 gap
    exceeds twice that.
"""
import ast
import dataclasses
import math
import sys
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (the repository root's script)
from repro.configs import get as j_get
from repro.kernels import decode_attention as j_decode
from repro.kernels import flash_attention as j_flash
from repro.models import layers as j_layers
from repro.models import model as j_model
from repro.models.kvcache import slot_positions as j_slot_positions
from repro_torch import convert
from repro_torch import random as jrandom
from repro_torch.configs import get
from repro_torch.kernels import common, decode_attention, flash_attention, ref
from repro_torch.launch import serve
from repro_torch.models import layers, model

ARCHS = ("qwen3-4b", "gemma3-12b", "phi3-medium-14b", "nemotron-4-15b")
VARIANTS = [(a, v) for a in ARCHS for v in ("reduced", "gqa")]
ELEMENT_ULPS = 1
SUM_ULPS = 1
MODEL_ULPS = 4
# the full-depth check of chip_smoke.SERVE_BF16_LOGIT_ULPS: the carry of one
# attention's rounding flips through every layer stays within this
DEPTH_ULPS = 3
PROMPT, GEN, BATCH = 24, 16, 2
CACHE = PROMPT + GEN + 1


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the port's CPU work here: in a parallel test
    run a pool of threads in every worker process contends for the same
    cores, and the weights' PRNG and the full-depth runs then run dozens
    of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(get_fn, arch):
    return {"reduced": dataclasses.replace(get_fn(arch).reduced(),
                                           dtype="bfloat16").validate(),
            "gqa": chip_smoke.bf16_pin_config(get_fn, arch)}


CFGS = {a: _cfgs(get, a) for a in ARCHS}
J_CFGS = {a: _cfgs(j_get, a) for a in ARCHS}


def _ids(case):
    return "-".join(str(x) for x in case)


def _weights(arch, variant, seed=0):
    """The port's and the JAX package's trees of the same bf16 weights."""
    cfg = CFGS[arch][variant]
    tree = convert.numpy_model_params(cfg, seed)
    return (convert.model_params(tree, cfg, "cpu"),
            jax.tree_util.tree_map(
                lambda x: jnp.asarray(x).astype(jnp.bfloat16), tree))


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32)).astype(np.float64)


def _ulp(x) -> np.ndarray:
    """bf16's spacing at |x| (elementwise; at 2^-126 and below, there)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
                   - 7)


def _element_ulps(got, want) -> float:
    """Largest difference in ulps of the larger of the two elements."""
    a, b = _f64(got), _f64(want)
    assert a.shape == b.shape
    return float((np.abs(a - b) / _ulp(np.maximum(np.abs(a),
                                                  np.abs(b)))).max())


def _scale_ulps(got, want) -> float:
    """Largest difference in ulps of ``want``'s largest magnitude."""
    a, b = _f64(got), _f64(want)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / _ulp(np.abs(b).max()))


def _bf16(x: np.ndarray):
    """A torch and a jnp bf16 array of the same values."""
    x = convert.bf16_values(x)
    return torch.tensor(x).bfloat16(), jnp.asarray(x).astype(jnp.bfloat16)


def _layer(tree):
    return jax.tree_util.tree_map(lambda x: x[0], tree["blocks"]["l0"])


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("case", VARIANTS, ids=_ids)
def test_param_count_and_tree_match_jax(case):
    arch, variant = case
    cfg, jc = CFGS[arch][variant], J_CFGS[arch][variant]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jc)
    assert model.param_count(cfg) == j_model.param_count(jc)
    shapes = jax.eval_shape(lambda k: j_model.init_params(k, jc),
                            jax.random.PRNGKey(0))
    meta = convert.named_leaves(model.init_params(
        jrandom.PRNGKey(0, device="cpu"), cfg, device="meta"))
    want = convert.named_leaves(shapes)
    assert set(meta) == set(want)
    for name, x in meta.items():
        assert tuple(x.shape) == want[name].shape, name
        assert x.dtype == torch.bfloat16 == getattr(torch,
                                                    want[name].dtype.name)


@pytest.mark.parametrize("case", VARIANTS, ids=_ids)
def test_init_params_from_a_key_are_the_jax_package_s(case):
    """``init_params(PRNGKey(0), cfg)`` in bf16: the JAX package's weights
    as its ``launch.serve`` draws them (x64 off: f32 normals times the
    scale, then ``.astype(bfloat16)``), bit for bit."""
    arch, variant = case
    cfg, jc = CFGS[arch][variant], J_CFGS[arch][variant]
    with jax.enable_x64(False):
        jp = j_model.init_params(jax.random.PRNGKey(0), jc)
    tp = model.init_params(jrandom.PRNGKey(0, device="cpu"), cfg)
    got, want = convert.named_leaves(tp), convert.named_leaves(jp)
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].dtype == torch.bfloat16, name
        assert np.array_equal(got[name].view(torch.int16).numpy(),
                              np.asarray(w).view(np.int16)), name


# ----------------------------------------------------------------- layers
@pytest.mark.parametrize("arch", ARCHS)
def test_layers_match_eager_jax(arch):
    """Each layer of the GQA variant on the same bf16 inputs, against the
    JAX package's layer functions called eagerly (each op rounds)."""
    cfg, jc = CFGS[arch]["gqa"], J_CFGS[arch]["gqa"]
    tp, jp = _weights(arch, "gqa")
    lp, jlp = _layer(tp), _layer(jp)
    rng = np.random.default_rng(1)
    x, jx = _bf16(rng.standard_normal((BATCH, PROMPT, cfg.d_model)))
    pos = np.arange(PROMPT, dtype=np.int32)
    tpos, jpos = torch.tensor(pos), jnp.asarray(pos)
    heads = x.reshape(BATCH, PROMPT, -1, cfg.head_dim)
    jheads = jx.reshape(BATCH, PROMPT, -1, cfg.head_dim)
    elementwise = {
        "rmsnorm": (layers.rmsnorm(lp["norm1"], x, cfg.rmsnorm_eps),
                    j_layers.rmsnorm(jlp["norm1"], jx, jc.rmsnorm_eps)),
        "rope": (layers.rope(heads, tpos, cfg.rope_theta),
                 j_layers.rope(jheads, jpos, jc.rope_theta)),
    }
    if cfg.qk_norm:
        elementwise["q_norm"] = (
            layers.rmsnorm(lp["mixer"]["q_norm"], heads, cfg.rmsnorm_eps),
            j_layers.rmsnorm(jlp["mixer"]["q_norm"], jheads, jc.rmsnorm_eps))
    h, jh = _bf16(3 * rng.standard_normal((64, 1024)))
    for name, (tf, jf) in {
            "silu": (layers._silu, jax.nn.silu),
            "gelu": (layers._gelu, jax.nn.gelu),
            "squared_relu": (lambda t: torch.square(torch.relu(t)),
                             lambda t: jnp.square(jax.nn.relu(t)))}.items():
        elementwise[name] = (tf(h), jf(jh))
    for name, (got, want) in elementwise.items():
        assert got.dtype == torch.bfloat16, name
        assert _element_ulps(got, want) <= ELEMENT_ULPS, name
    sums = {
        "qkv": (torch.cat([t.flatten(2) for t in layers._project_qkv(
            lp["mixer"], cfg, x, x)], -1),
            jnp.concatenate([t.reshape(BATCH, PROMPT, -1)
                             for t in j_layers._project_qkv(
                                 jlp["mixer"], jc, jx, jx)], -1)),
        "kv": (torch.cat(layers.compute_kv(lp["mixer"], cfg, x, tpos), -1),
               jnp.concatenate(j_layers.compute_kv(jlp["mixer"], jc, jx,
                                                   jpos), -1)),
        "mlp": (layers.mlp(lp["ffn"], cfg, x),
                j_layers.mlp(jlp["ffn"], jc, jx)),
    }
    for window in (None, 8):
        sums[f"attention window={window}"] = (
            layers.attention(lp["mixer"], cfg, x, tpos, window=window,
                             backend="reference"),
            j_layers.attention(jlp["mixer"], jc, jx, jpos, window=window))
    c = 20
    kc, jkc = _bf16(rng.standard_normal((BATCH, c, 2, cfg.head_dim)))
    vc, jvc = _bf16(rng.standard_normal((BATCH, c, 2, cfg.head_dim)))
    for p in (10, 30):                     # 30 wraps the 20-slot ring
        cpos = np.asarray(j_slot_positions(jnp.asarray(p + 1), c))
        sums[f"decode pos={p}"] = (
            layers.decode_attention(lp["mixer"], cfg, x[:, :1], kc, vc,
                                    torch.tensor(cpos), p,
                                    backend="reference"),
            j_layers.decode_attention(jlp["mixer"], jc, jx[:, :1], jkc, jvc,
                                      jnp.asarray(cpos), jnp.asarray(p)))
    for name, (got, want) in sums.items():
        assert got.dtype == torch.bfloat16, name
        assert _scale_ulps(got, want) <= SUM_ULPS, name


# ------------------------------------------------------ prefill + decode
def _gap(logits: np.ndarray) -> np.ndarray:
    top = np.sort(logits, axis=-1)
    return top[..., -1] - top[..., -2]


def _jax_greedy(jc, jp, prompts):
    """The JAX package's greedy run, jitted as its ``launch.serve`` runs
    it: (logit rows (gen, B, V) f32, tokens (B, gen), final cache)."""
    logits, cache = jax.jit(lambda p, t: j_model.prefill(
        p, jc, t, cache_len=CACHE))(jp, jnp.asarray(prompts.numpy(),
                                                    jnp.int32))
    step = jax.jit(lambda p, c, t, pos: j_model.serve_step(p, jc, c, t, pos))
    first_cache = cache
    rows = [np.asarray(logits)]
    toks = [np.argmax(rows[-1], -1)]
    for i in range(GEN - 1):
        logits, cache = step(jp, cache,
                             jnp.asarray(toks[-1][:, None], jnp.int32),
                             jnp.asarray(PROMPT + i))
        rows.append(np.asarray(logits))
        toks.append(np.argmax(rows[-1], -1))
    return np.stack(rows), np.stack(toks, axis=1), first_cache, cache


_JAX_RUNS: dict = {}


def _jax_run(arch, variant):
    """The JAX package's greedy run of a variant, computed once."""
    if (arch, variant) not in _JAX_RUNS:
        _, jp = _weights(arch, variant)
        prompts = serve.prompts_of(CFGS[arch][variant], BATCH, PROMPT, "cpu")
        _JAX_RUNS[arch, variant] = (prompts,) + _jax_greedy(
            J_CFGS[arch][variant], jp, prompts)
    return _JAX_RUNS[arch, variant]


@pytest.mark.parametrize("backend", ["cuda", "reference"])
@pytest.mark.parametrize("case", VARIANTS, ids=_ids)
def test_prefill_and_serve_step_match_jax(case, backend):
    arch, variant = case
    cfg = CFGS[arch][variant]
    prompts, jlogits, jtoks, jcache0, jcache = _jax_run(arch, variant)
    tp, _ = _weights(arch, variant)
    logits, cache = model.prefill(tp, cfg, prompts, cache_len=CACHE,
                                  backend=backend)
    assert logits.dtype == torch.float32
    assert _scale_ulps(logits, jlogits[0]) <= MODEL_ULPS
    for a, b in zip(jax.tree_util.tree_leaves(cache),
                    jax.tree_util.tree_leaves(jcache0)):
        assert a.dtype == torch.bfloat16 and tuple(a.shape) == b.shape
        assert _scale_ulps(a, b) <= MODEL_ULPS
    rows = [logits]
    for i in range(GEN - 1):        # teacher-forced with JAX's tokens
        logits, cache = model.serve_step(
            tp, cfg, cache, torch.tensor(jtoks[:, i:i + 1]), PROMPT + i,
            backend=backend)
        assert _scale_ulps(logits, jlogits[i + 1]) <= MODEL_ULPS
        rows.append(logits)
    for a, b in zip(jax.tree_util.tree_leaves(cache),
                    jax.tree_util.tree_leaves(jcache)):
        assert _scale_ulps(a, b) <= MODEL_ULPS
    tol = MODEL_ULPS * _ulp(np.abs(jlogits).max())
    clear = _gap(jlogits).T > 2 * tol
    got = torch.stack(rows, 1).argmax(-1).numpy()
    assert clear.any() and np.array_equal(got[clear], jtoks[clear])


def test_generate_serves_a_bf16_config_on_the_cpu():
    """``launch.serve.generate`` on a bf16 config: f32 logit rows, greedy
    tokens, the plain versions on CPU tensors (no launch counted), and
    bf16 GEMMs held to f32 accumulation on the card."""
    cfg = CFGS["gemma3-12b"]["gqa"]
    tp, _ = _weights("gemma3-12b", "gqa")
    prompts, jlogits, jtoks, _, _ = _jax_run("gemma3-12b", "gqa")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    common.reset_launches()
    out = serve.generate(tp, cfg, prompts, GEN, cache_len=CACHE,
                         feed=torch.tensor(jtoks), device="cpu")
    assert not torch.backends.cuda.matmul \
        .allow_bf16_reduced_precision_reduction
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not any(common.LAUNCHES.values())
    assert all(x.dtype == torch.float32 for x in out.logits)
    assert out.tokens.shape == (BATCH, GEN)
    assert _scale_ulps(torch.stack(out.logits), jlogits) <= MODEL_ULPS


def test_the_kernels_get_the_models_bf16_views(monkeypatch):
    """On the ``cuda`` backend B14 and B13 receive the model's bf16 tensors
    as they are: (B, H, L, d) views of the (B, L, H, d) projections and
    (B, K, C, d) views of the (B, C, K, d) caches, no copy and no cast; an
    "S" layer passes its window (JAX's kpos > qpos - window)."""
    cfg = CFGS["gemma3-12b"]["gqa"]
    tp, _ = _weights("gemma3-12b", "gqa")
    seen = []

    def spy(kernel, name):
        def wrapper(*args, **kw):
            seen.append((name, args, kw))
            return kernel(*args, **kw)
        monkeypatch.setattr(sys.modules[kernel.__module__], name, wrapper)
    spy(flash_attention.flash_attention, "flash_attention")
    spy(decode_attention.decode_attention, "decode_attention")
    prompts = serve.prompts_of(cfg, BATCH, PROMPT, "cpu")
    logits, cache = model.prefill(tp, cfg, prompts, cache_len=CACHE)
    model.serve_step(tp, cfg, cache, torch.argmax(logits, -1)[:, None],
                     PROMPT)
    flash = [(a, kw) for n, a, kw in seen if n == "flash_attention"]
    decode = [a for n, a, _ in seen if n == "decode_attention"]
    assert len(flash) == len(decode) == cfg.num_layers
    windows = [kw["window"] for _, kw in flash]
    assert windows == [16, None] * (cfg.num_layers // 2)
    for (q, k, v), _ in flash:
        for t, heads in ((q, cfg.num_heads), (k, cfg.num_kv_heads),
                         (v, cfg.num_kv_heads)):
            assert t.dtype == torch.bfloat16
            assert t.shape == (BATCH, heads, PROMPT, cfg.head_dim)
            assert t.stride() == (PROMPT * heads * cfg.head_dim,
                                  cfg.head_dim, heads * cfg.head_dim, 1)
    for q, k, v, cpos, pos in decode:
        assert q.dtype == k.dtype == v.dtype == torch.bfloat16
        assert not k.is_contiguous() and k.transpose(1, 2).is_contiguous()
        assert k.shape[2] in (16, CACHE)          # the ring, the full cache


def _depth_config(arch):
    """``arch`` at every layer (pattern, window ring, superblocks) with
    narrow widths: d 256, 4 heads over 2 kv heads of 64, vocab 4096."""
    full = get(arch)
    return dataclasses.replace(
        full, d_model=256, d_ff=1024, vocab_size=4096, num_heads=4,
        num_kv_heads=2, head_dim=64,
        sliding_window=min(full.sliding_window, 32)).validate()


@pytest.mark.parametrize("arch", list(chip_smoke.SERVE_BF16_ARCHS))
def test_attention_order_carries_within_the_card_tolerance(arch,
                                                           monkeypatch):
    """The derivation of chip_smoke.SERVE_BF16_LOGIT_ULPS: on the card the
    two backends differ only in the order B14 and B13 sum in. Here the
    reference backend runs at the model's full depth with its attention
    summed in f64 instead of f32 (a few roundings to bf16 land on the other
    neighbour, as between kernel and plain version), teacher-forced with
    the plain run's tokens: the logits stay within DEPTH_ULPS of the
    largest |logit|."""
    cfg = _depth_config(arch)
    assert cfg.num_layers == {"qwen3-4b": 36, "gemma3-12b": 48}[arch]
    params = model.init_params(jrandom.PRNGKey(0, device="cpu"), cfg)
    prompts = serve.prompts_of(cfg, 2, 40, "cpu")
    plain = serve.generate(params, cfg, prompts, 8, backend="reference",
                           device="cpu")
    monkeypatch.setattr(ref, "flash_attention_fwd",
                        lambda q, k, v, **kw: chip_smoke._flash_f64(
                            q, k, v, kw.get("causal", True),
                            kw.get("window")).to(q.dtype))
    monkeypatch.setattr(ref, "decode_attention_ref",
                        lambda q, k, v, cpos, pos, scale=None:
                        chip_smoke._decode_f64(q, k, v, cpos, pos)
                        .to(q.dtype))
    f64 = serve.generate(params, cfg, prompts, 8, backend="reference",
                         feed=plain.tokens, device="cpu")
    a, b = torch.stack(plain.logits), torch.stack(f64.logits)
    assert not torch.equal(a, b)             # the orders do differ
    assert _scale_ulps(b, a) <= DEPTH_ULPS
    assert DEPTH_ULPS < chip_smoke.SERVE_BF16_LOGIT_ULPS


# -------------------------------------------- plain B13/B14 in bf16
def _bf16_qkv(b, h, kh, lq, s, d, seed):
    rng = np.random.default_rng(seed)
    return [_bf16(rng.standard_normal(shape))
            for shape in ((b, h, lq, d), (b, kh, s, d), (b, kh, s, d))]


@pytest.mark.parametrize("h,kh,d,window", [(4, 2, 128, None),
                                           (8, 2, 128, 40),
                                           (4, 2, 256, None),
                                           (2, 1, 256, 40)])
def test_flash_plain_in_bf16_matches_the_pallas_kernel(h, kh, d, window):
    """The plain B14 in bf16 at head dims 128 and 256, causal and windowed
    (the ``S`` layers' mask), against the Pallas kernel (interpret)."""
    (q, jq), (k, jk), (v, jv) = _bf16_qkv(1, h, kh, 128, 128, d, d + h)
    got = flash_attention.flash_attention(q, k, v, causal=True,
                                          window=window)
    assert got.dtype == torch.bfloat16
    want = j_flash.flash_attention_pallas(jq, jk, jv, causal=True,
                                          window=window, q_block=64,
                                          kv_block=64, interpret=True)
    assert want.dtype == jnp.bfloat16
    assert _scale_ulps(got, want) <= SUM_ULPS


@pytest.mark.parametrize("h,kh,d,c,pos", [(8, 2, 128, 64, 40),
                                          (4, 2, 256, 64, 50),
                                          (4, 2, 256, 32, 50),
                                          (8, 2, 128, 32, 200)])
def test_decode_plain_in_bf16_matches_the_pallas_kernel(h, kh, d, c, pos):
    """The plain B13 in bf16 over a full cache (pos < C) and wrapped ring
    caches, head dims 128 and 256, against the Pallas kernel (interpret)."""
    rng = np.random.default_rng(pos + d)
    q, jq = _bf16(rng.standard_normal((2, h, d)))
    k, jk = _bf16(rng.standard_normal((2, kh, c, d)))
    v, jv = _bf16(rng.standard_normal((2, kh, c, d)))
    cpos = np.asarray(j_slot_positions(jnp.asarray(pos + 1), c))
    got = decode_attention.decode_attention(q, k, v, torch.tensor(cpos), pos)
    assert got.dtype == torch.bfloat16
    want = j_decode.decode_attention_pallas(jq, jk, jv, jnp.asarray(cpos),
                                            jnp.asarray(pos), block=32,
                                            interpret=True)
    assert _scale_ulps(got, want) <= SUM_ULPS


# ------------------------------------------------------------- convert
def test_model_params_carries_the_jax_package_s_bf16_trees():
    """A JAX bf16 tree (numpy sees ``ml_dtypes.bfloat16``) becomes the
    same bits in ``torch.bfloat16``; ``numpy_model_params`` gives f32
    arrays of bf16 values that both packages take exactly."""
    cfg, jc = CFGS["qwen3-4b"]["gqa"], J_CFGS["qwen3-4b"]["gqa"]
    with jax.enable_x64(False):
        jp = jax.tree_util.tree_map(
            np.asarray, j_model.init_params(jax.random.PRNGKey(3), jc))
    tp = convert.model_params(jp, cfg, "cpu")
    for name, w in convert.named_leaves(jp).items():
        got = convert.named_leaves(tp)[name]
        assert w.dtype == ml_dtypes.bfloat16 and got.dtype == torch.bfloat16
        assert np.array_equal(got.view(torch.int16).numpy(),
                              w.view(np.int16)), name
    tree = convert.numpy_model_params(cfg, 0)
    for name, x in convert.named_leaves(tree).items():
        assert x.dtype == np.float32, name
        assert np.array_equal(x.astype(ml_dtypes.bfloat16).astype(
            np.float32), x), name
    tp = convert.model_params(tree, cfg, "cpu")
    for name, x in convert.named_leaves(tree).items():
        got = convert.named_leaves(tp)[name]
        assert got.dtype == torch.bfloat16
        assert np.array_equal(got.float().numpy(), x), name


def test_bf16_values_round_half_to_even():
    """``convert.bf16_values`` is ``.astype(bfloat16)`` from f32, ties and
    values at the top of a binade included."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(100_000).astype(np.float32) * 10.0 ** \
        rng.integers(-30, 30, 100_000)
    ties = (rng.integers(0, 0x7F80, 1000).astype(np.uint32) << 16
            | 0x8000).view(np.float32)      # halfway, finite and subnormal
    top = np.array([1.9999999, 3.9999998, -255.99998, 1e-30],
                   dtype=np.float32)
    for v in (x.astype(np.float32), ties, top):
        want = v.astype(ml_dtypes.bfloat16).astype(np.float32)
        assert np.array_equal(convert.bf16_values(v), want)


def test_model_params_refuses_what_it_cannot_carry():
    cfg = CFGS["gemma3-12b"]["gqa"]
    tree = convert.numpy_model_params(cfg, 0)
    off = dict(tree, embed=tree["embed"] + np.float32(1e-3))
    with pytest.raises(ValueError, match="not bf16 values"):
        convert.model_params(off, cfg, "cpu")
    half = dict(tree, embed=tree["embed"].astype(np.float16))
    with pytest.raises(NotImplementedError, match="ROADMAP.md A13"):
        convert.model_params(half, cfg, "cpu")
    with pytest.raises(ValueError, match="embed"):
        convert.model_params(dict(tree, embed=tree["embed"][:-1]), cfg,
                             "cpu")


# ------------------------------------------------------------ refusals
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_training_and_other_dtypes_still_raise(arch):
    """bf16 serving runs, and so do bf16 ``forward`` and ``train_loss``,
    the same bits on both backends (on the CPU the cuda backend runs the
    kernels' plain versions); an f16 config raises naming ROADMAP.md
    A13. (The name is the one this test had while bf16 training raised;
    it is kept so that the test's record runs on.)"""
    cfg = CFGS[arch]["reduced"]
    tp, _ = _weights(arch, "reduced")
    tokens = torch.arange(8, dtype=torch.int64)[None] % cfg.vocab_size
    batch = {"tokens": tokens, "labels": tokens.roll(-1, dims=1)}
    outs = {b: (model.forward(tp, cfg, tokens, backend=b)[0],
                model.train_loss(tp, cfg, batch, backend=b)[0])
            for b in ("cuda", "reference")}
    for x, loss in outs.values():
        assert x.dtype == torch.bfloat16 and x.shape == (1, 8, cfg.d_model)
        assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
    (xc, lc), (xr, lr) = outs["cuda"], outs["reference"]
    assert torch.equal(xc.view(torch.int16), xr.view(torch.int16))
    assert torch.equal(lc, lr)
    f16 = dataclasses.replace(cfg, dtype="float16")
    with pytest.raises(NotImplementedError, match="ROADMAP.md A13"):
        model.param_count(f16)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A13"):
        model.prefill(tp, f16, tokens, backend="reference")
    logits, _ = model.prefill(tp, cfg, tokens, backend="reference")
    assert logits.dtype == torch.float32
    assert model.param_count(get(arch)) == j_model.param_count(j_get(arch))


def _port_files():
    return sorted((REPO / "src" / "repro_torch").rglob("*.py")) \
        + sorted((REPO / "benchmarks_torch").glob("*.py")) \
        + [REPO / "chip_smoke.py"]


def test_the_port_imports_no_ml_dtypes():
    """The card's machine has numpy but no ``ml_dtypes``: bf16 crosses
    from the JAX package by its bits."""
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) \
                else []
            assert not any(n.split(".")[0] == "ml_dtypes" for n in names), \
                path


# ------------------------------------------------------------------ pins
def _pin_run(arch):
    """The JAX package's bf16 pin run (chip_smoke.SERVE_BF16_PIN)."""
    cfg = chip_smoke.bf16_pin_config(get, arch)
    jc = chip_smoke.bf16_pin_config(j_get, arch)
    assert cfg == CFGS[arch]["gqa"]
    tree = convert.numpy_model_params(cfg,
                                      chip_smoke.SERVE_BF16_PIN_SEEDS[arch])
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x).astype(jnp.bfloat16),
                                tree)
    sh = chip_smoke.SERVE_PIN_SHAPE
    assert (sh["batch"], sh["prompt"], sh["gen"], sh["cache"]) == \
        (BATCH, PROMPT, GEN, CACHE)
    prompts = serve.prompts_of(cfg, BATCH, PROMPT, "cpu")
    jlogits, jtoks, _, _ = _jax_greedy(jc, jp, prompts)
    return cfg, tree, jlogits, jtoks


@pytest.mark.parametrize("arch", list(chip_smoke.SERVE_BF16_PIN_SEEDS))
def test_chip_smoke_bf16_pins_are_the_jax_package_s(arch):
    """chip_smoke.py holds the port on the card to these JAX values; the
    port on the CPU passes the same check."""
    cfg, tree, jlogits, jtoks = _pin_run(arch)
    toks, total, abs_total = chip_smoke.SERVE_BF16_PIN[arch]
    assert np.array_equal(jtoks, np.array(toks))
    got = (float(jlogits.astype(np.float64).sum()),
           float(np.abs(jlogits.astype(np.float64)).sum()))
    assert math.isclose(got[0], total, rel_tol=0, abs_tol=1e-4 * abs_total)
    assert math.isclose(got[1], abs_total, rel_tol=1e-4)
    out = chip_smoke.bf16_pin_check(convert.model_params(tree, cfg, "cpu"),
                                    cfg, chip_smoke.SERVE_BF16_PIN[arch],
                                    "cpu")
    assert out["argmax_compared"] > out["argmax_total"] // 4
