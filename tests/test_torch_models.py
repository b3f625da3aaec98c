"""The port's model stack for serving held against the JAX package's:
configs, ``MarkovLM``, the layers, the ring caches, ``prefill`` +
``serve_step``, the serving entry point and ``convert.model_params``.

Weights come from ``convert.numpy_model_params`` (numpy, seeded) and are
carried into both packages, so both compute with the same numbers.

Tolerances and why:
  * layers (norm, RoPE, MLP, attention, decode attention, k/v): rtol =
    atol = 2e-5, matmuls of 256 to 1024 terms summed in other orders by
    XLA and PyTorch, and a blocked against a naive softmax;
  * ``prefill`` / ``serve_step`` logits and caches: rtol = atol = 2e-4,
    as tests/test_kernels.py holds the model's decode attention; greedy
    tokens exactly, with every compared argmax's top-2 gap above 1e-3
    (asserted), so no token turns on rounding;
  * integer outputs (slot positions, prompts, configs): exact.
"""
import dataclasses
import sys
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the repository root's script)
from repro.configs import ARCHS as J_ARCHS
from repro.configs import get as j_get
from repro.data.lm_data import MarkovLM as JMarkovLM
from repro.models import kvcache as j_kvcache
from repro.models import layers as j_layers
from repro.models import model as j_model
from repro_torch import convert
from repro_torch import random as jrandom
from repro_torch.configs import ARCHS, get
from repro_torch.data.lm_data import MarkovLM
from repro_torch.kernels import common
from repro_torch.launch import serve
from repro_torch.models import kvcache, layers, model

TOL = 2e-5
MODEL_TOL = 2e-4
PROMPT, GEN, BATCH = 24, 16, 2
CACHE = PROMPT + GEN + 1


def _variants(get_fn):
    """chb-paper-lm-124m's reduced() (2 layers, d 256, vocab 512, MHA) and
    a GQA variant of it that the JAX model runs: 2 kv heads, a full and a
    sliding-window layer (window 16, so the "S" ring wraps during prefill
    and decode) and qk_norm."""
    base = get_fn("chb-paper-lm-124m").reduced()
    gqa = dataclasses.replace(base, num_kv_heads=2, layer_pattern="AS",
                              sliding_window=16, qk_norm=True).validate()
    return {"reduced": base, "gqa": gqa}


CFGS, J_CFGS = _variants(get), _variants(j_get)
# seeds whose greedy decodes keep every top-2 gap above 1e-3
SEEDS = dict(chip_smoke.SERVE_PIN_SEEDS)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _weights(name, seed=None):
    cfg = CFGS[name]
    tree = convert.numpy_model_params(cfg, SEEDS[name] if seed is None
                                      else seed)
    return (convert.model_params(tree, cfg, "cpu"),
            jax.tree_util.tree_map(jnp.asarray, tree))


def _layer(tree, i=0):
    """Layer ``l{i}`` of superblock 0 of either package's tree."""
    return jax.tree_util.tree_map(lambda x: x[0], tree["blocks"][f"l{i}"])


def _x(shape, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.tensor(x), jnp.asarray(x)


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_configs_and_their_reductions_match_jax(arch):
    c, jc = get(arch), j_get(arch)
    assert dataclasses.asdict(c) == dataclasses.asdict(jc)
    assert dataclasses.asdict(c.reduced()) == dataclasses.asdict(jc.reduced())
    assert c.layer_plan() == jc.layer_plan()
    assert c.block_plan() == jc.block_plan()
    assert c.torch_dtype == getattr(torch, jc.jnp_dtype.name)
    assert set(ARCHS) == set(J_ARCHS)


def test_markov_prompts_match_jax():
    lm, jlm = MarkovLM(512, seed=3), JMarkovLM(512, seed=3)
    assert np.array_equal(lm.next_tokens, jlm.next_tokens)
    a = lm.sample(np.random.default_rng(1), 3, 20)
    assert np.array_equal(a, jlm.sample(np.random.default_rng(1), 3, 20))
    assert lm.entropy_floor() == jlm.entropy_floor()
    assert np.array_equal(
        serve.prompts_of(CFGS["reduced"], BATCH, PROMPT, "cpu").numpy(),
        JMarkovLM(512, seed=0).sample(np.random.default_rng(0), BATCH,
                                      PROMPT)[:, :-1])


@pytest.mark.parametrize("name", ["reduced", "gqa"])
def test_param_count_and_tree_match_jax(name):
    cfg, jc = CFGS[name], J_CFGS[name]
    assert model.param_count(cfg) == j_model.param_count(jc)
    shapes = jax.eval_shape(lambda k: j_model.init_params(k, jc),
                            jax.random.PRNGKey(0))
    ours = model.init_params(jrandom.PRNGKey(0, device="cpu"), cfg,
                             device="meta")
    assert jax.tree_util.tree_structure(shapes) == \
        jax.tree_util.tree_structure(ours)
    for a, b in zip(jax.tree_util.tree_leaves(shapes),
                    jax.tree_util.tree_leaves(ours)):
        assert tuple(a.shape) == tuple(b.shape)
    assert model.param_count(get("chb-paper-lm-124m")) == 163_597_056


# ----------------------------------------------------------------- layers
def test_rmsnorm_and_rope_match_jax():
    tp, jp = _weights("gqa")
    x, jx = _x((2, 7, 4, 64))
    _close(layers.rmsnorm(_layer(tp)["mixer"]["q_norm"], x, 1e-6),
           j_layers.rmsnorm(_layer(jp)["mixer"]["q_norm"], jx, 1e-6))
    pos = np.array([0, 1, 2, 30, 31, 500, 4095], np.int32)
    _close(layers.rope(x, torch.tensor(pos), 1e4),
           j_layers.rope(jx, jnp.asarray(pos), 1e4))


@pytest.mark.parametrize("activation", ["swiglu", "squared_relu", "gelu"])
def test_mlp_matches_jax(activation):
    cfg = dataclasses.replace(CFGS["reduced"], activation=activation)
    jc = dataclasses.replace(J_CFGS["reduced"], activation=activation)
    tree = convert.numpy_model_params(cfg, 5)
    p = convert.model_params(tree, cfg, "cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    assert ("wg" in _layer(p)["ffn"]) == (activation == "swiglu")
    x, jx = _x((2, 5, 256), seed=1)
    _close(layers.mlp(_layer(p)["ffn"], cfg, x),
           j_layers.mlp(_layer(jp)["ffn"], jc, jx))


@pytest.mark.parametrize("name", ["reduced", "gqa"])
@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_attention_and_kv_match_jax(name, backend):
    cfg, jc = CFGS[name], J_CFGS[name]
    tp, jp = _weights(name)
    x, jx = _x((2, 20, 256), seed=2)
    pos = np.arange(20, dtype=np.int32)
    for i, (mixer, _) in enumerate(cfg.block_plan()):
        kind, window = kvcache.effective_mixer(cfg, mixer, False)
        p, q = _layer(tp, i)["mixer"], _layer(jp, i)["mixer"]
        _close(layers.attention(p, cfg, x, torch.tensor(pos), window=window,
                                backend=backend),
               j_layers.attention(q, jc, jx, jnp.asarray(pos),
                                  window=window, q_block=4, kv_block=4))
        for a, b in zip(layers.compute_kv(p, cfg, x, torch.tensor(pos)),
                        j_layers.compute_kv(q, jc, jx, jnp.asarray(pos))):
            _close(a, b)


@pytest.mark.parametrize("name", ["reduced", "gqa"])
@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_decode_attention_matches_jax(name, backend):
    """Against ``layers.decode_attention``'s einsums, on a wrapped ring."""
    cfg, jc = CFGS[name], J_CFGS[name]
    tp, jp = _weights(name)
    kh, hd = cfg.num_kv_heads, cfg.head_dim
    x, jx = _x((2, 1, 256), seed=3)
    kc, jkc = _x((2, 32, kh, hd), seed=4)
    vc, jvc = _x((2, 32, kh, hd), seed=5)
    pos = 45
    cpos = kvcache.slot_positions(pos + 1, 32, "cpu")
    jcpos = j_kvcache.slot_positions(jnp.asarray(pos + 1), 32)
    _close(layers.decode_attention(_layer(tp)["mixer"], cfg, x, kc, vc, cpos,
                                   pos, backend=backend),
           j_layers.decode_attention(_layer(jp)["mixer"], jc, jx, jkc, jvc,
                                     jcpos, jnp.asarray(pos)))


# ----------------------------------------------------------------- caches
@pytest.mark.parametrize("pos", [0, 1, 5, 16, 17, 40, 200])
def test_slot_positions_across_wraps(pos):
    got = kvcache.slot_positions(pos, 16, "cpu")
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(
        j_kvcache.slot_positions(jnp.asarray(pos), 16)))


@pytest.mark.parametrize("l", [10, 16, 40])
def test_fill_from_prefill_matches_jax(l):
    """L < C, L = C and L > C (the ring keeps the last C positions)."""
    k, jk = _x((2, l, 2, 8), seed=l)
    v, jv = _x((2, l, 2, 8), seed=l + 1)
    got = kvcache.fill_from_prefill(CFGS["gqa"], k, v, 16)
    want = j_kvcache.fill_from_prefill(J_CFGS["gqa"], jk, jv, 16)
    for key in ("k", "v"):
        assert np.array_equal(got[key].numpy(), np.asarray(want[key]))


def test_init_cache_and_write_kv_match_jax():
    cfg, jc = CFGS["gqa"], J_CFGS["gqa"]
    cache = kvcache.init_cache(cfg, 2, 40, device="cpu")
    jcache = j_kvcache.init_cache(jc, 2, 40)
    assert jax.tree_util.tree_structure(cache) == \
        jax.tree_util.tree_structure(jcache)
    for a, b in zip(jax.tree_util.tree_leaves(cache),
                    jax.tree_util.tree_leaves(jcache)):
        assert tuple(a.shape) == b.shape and not a.any()
    k, jk = _x((2, 1, 2, 64), seed=8)
    v, jv = _x((2, 1, 2, 64), seed=9)
    for pos in (3, 16, 35):                  # 16 and 35 wrap the "S" ring
        one = {x: cache["l1"][x][0] for x in ("k", "v")}
        ptr = one["k"].data_ptr()
        out = kvcache.write_kv(one, k * pos, v * pos, pos)
        assert out["k"].data_ptr() == ptr    # in place
        jone = j_kvcache.write_kv({x: jcache["l1"][x][0] for x in ("k", "v")},
                                  jk * pos, jv * pos, jnp.asarray(pos))
        jcache["l1"] = {x: jcache["l1"][x].at[0].set(jone[x])
                        for x in ("k", "v")}
    for x in ("k", "v"):
        assert np.array_equal(cache["l1"][x].numpy(),
                              np.asarray(jcache["l1"][x]))


# ------------------------------------------------------ prefill + decode
def _gap(logits: np.ndarray) -> float:
    top = np.sort(logits, axis=-1)
    return float((top[..., -1] - top[..., -2]).min())


def _jax_greedy(jc, jp, prompts):
    """The JAX package's greedy run: (logit rows, tokens, final cache)."""
    logits, cache = jax.jit(lambda p, t: j_model.prefill(
        p, jc, t, cache_len=CACHE))(jp, jnp.asarray(prompts.numpy(),
                                                    jnp.int32))
    step = jax.jit(lambda p, c, t, pos: j_model.serve_step(p, jc, c, t, pos))
    rows = [np.asarray(logits)]
    toks = [np.argmax(rows[-1], -1)]
    for i in range(GEN - 1):
        logits, cache = step(jp, cache,
                             jnp.asarray(toks[-1][:, None], jnp.int32),
                             jnp.asarray(PROMPT + i))
        rows.append(np.asarray(logits))
        toks.append(np.argmax(rows[-1], -1))
    return (np.stack(rows), np.stack(toks, axis=1),
            jax.tree_util.tree_map(np.asarray, cache))


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's greedy run of each variant: prompt 24, gen 16."""
    out = {}
    for name, jc in J_CFGS.items():
        _, jp = _weights(name)
        prompts = serve.prompts_of(CFGS[name], BATCH, PROMPT, "cpu")
        out[name] = (prompts,) + _jax_greedy(jc, jp, prompts)
    return out


@pytest.mark.parametrize("name", ["reduced", "gqa"])
@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_prefill_and_serve_step_match_jax(jax_runs, name, backend):
    prompts, jlogits, jtoks, jcache = jax_runs[name]
    assert _gap(jlogits) > 1e-3
    tp, _ = _weights(name)
    cfg = CFGS[name]
    logits, cache = model.prefill(tp, cfg, prompts, cache_len=CACHE,
                                  backend=backend)
    _close(logits, jlogits[0], MODEL_TOL)
    toks = [torch.argmax(logits, -1)]
    for i in range(GEN - 1):
        logits, cache = model.serve_step(tp, cfg, cache, toks[-1][:, None],
                                         PROMPT + i, backend=backend)
        _close(logits, jlogits[i + 1], MODEL_TOL)
        toks.append(torch.argmax(logits, -1))
    assert np.array_equal(torch.stack(toks, 1).numpy(), jtoks)
    assert jax.tree_util.tree_structure(cache) == \
        jax.tree_util.tree_structure(jcache)
    for a, b in zip(jax.tree_util.tree_leaves(cache),
                    jax.tree_util.tree_leaves(jcache)):
        _close(a, b, MODEL_TOL)


@pytest.mark.parametrize("name", ["reduced", "gqa"])
def test_chip_smoke_pins_are_the_jax_package_s(jax_runs, name):
    """chip_smoke.py holds the port on the card to these JAX values."""
    _, jlogits, jtoks, _ = jax_runs[name]
    toks, total, abs_total = chip_smoke.SERVE_PIN[name]
    assert np.array_equal(jtoks, np.array(toks))
    tol = chip_smoke.SERVE_PIN_RTOL * abs_total
    assert abs(float(jlogits[0].sum()) - total) <= tol
    assert abs(float(np.abs(jlogits[0]).sum()) - abs_total) <= tol


def test_generate_feeds_and_times(jax_runs):
    """``generate`` is the greedy loop above; ``feed`` forces the tokens."""
    prompts, jlogits, jtoks, _ = jax_runs["gqa"]
    tp, _ = _weights("gqa")
    out = serve.generate(tp, CFGS["gqa"], prompts, GEN, cache_len=CACHE,
                         device="cpu")
    assert np.array_equal(out.tokens.numpy(), jtoks)
    assert len(out.logits) == GEN and len(out.step_ms) == GEN - 1
    _close(torch.stack(out.logits), jlogits, MODEL_TOL)
    forced = torch.zeros_like(out.tokens)
    again = serve.generate(tp, CFGS["gqa"], prompts, 3, feed=forced,
                           backend="reference", device="cpu")
    want, cache = model.prefill(tp, CFGS["gqa"], prompts)
    assert torch.equal(again.logits[0], want)
    assert out.prefill_ms > 0 and min(out.step_ms) > 0


@pytest.mark.parametrize("name", ["reduced", "gqa"])
def test_init_params_from_a_key_are_the_jax_package_s(name):
    """``init_params(PRNGKey(0), cfg)``: the JAX package's weights as its
    ``launch.serve`` draws them (x64 off, f32 normals), each within the
    ``normal`` ulp bound of ``tests/test_torch_random.py`` (a weight is
    the normal times a scale, so one ulp more), and the same greedy
    tokens."""
    cfg, jc = CFGS[name], J_CFGS[name]
    with jax.enable_x64(False):
        jp = j_model.init_params(jax.random.PRNGKey(0), jc)
    tp = model.init_params(jrandom.PRNGKey(0, device="cpu"), cfg)
    got, want = convert.named_leaves(tp), convert.named_leaves(jp)
    assert set(got) == set(want)
    differ = 0
    for k, w in want.items():
        a = got[k].numpy().view(np.int32).astype(np.int64)
        b = np.asarray(w).view(np.int32).astype(np.int64)
        assert np.abs(a - b).max() <= 4, k
        differ += np.count_nonzero(a != b)
    assert differ <= 1e-4 * model.param_count(cfg)
    prompts = serve.prompts_of(cfg, BATCH, PROMPT, "cpu")
    jlogits, jtoks, _ = _jax_greedy(jc, jp, prompts)
    assert _gap(jlogits) > 1e-3
    out = serve.generate(tp, cfg, prompts, GEN, cache_len=CACHE,
                         device="cpu")
    assert np.array_equal(out.tokens.numpy(), jtoks)


# ------------------------------------------------------------ entry point
def test_serve_main_runs_on_the_cpu(capsys):
    common.reset_launches()
    out = serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "12", "--gen", "4"])
    assert out.tokens.shape == (2, 4) and out.tokens.max() < 512
    assert all(torch.isfinite(x).all() for x in out.logits)
    assert "tok/s" in capsys.readouterr().out
    assert not any(common.LAUNCHES.values())      # CPU: plain versions


def test_serve_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tp, _ = _weights("reduced")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.generate(tp, CFGS["reduced"], torch.zeros(1, 4,
                                                        dtype=torch.int64), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--reduced"])
    with pytest.raises(RuntimeError, match="CUDA"):
        kvcache.init_cache(CFGS["reduced"], 1, 8)


@pytest.mark.parametrize("arch", sorted(a for a in J_ARCHS
                                        if a != "chb-paper-lm-124m"))
def test_unported_configs_raise_naming_the_roadmap(arch):
    """bf16 configs, and (also when reduced to f32) mamba2, cross-attention,
    frontends and MoE."""
    cfg = get(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A13"):
        model.init_params(jrandom.PRNGKey(0, device="cpu"), cfg,
                          device="meta")
    small = cfg.reduced()
    if set(small.layer_pattern) - {"A", "S"} or small.num_experts \
            or small.frontend:
        with pytest.raises(NotImplementedError, match="ROADMAP.md A13"):
            model.param_count(small)
    else:
        assert model.param_count(small) == j_model.param_count(
            j_get(arch).reduced())


def test_model_params_rejects_other_trees():
    cfg = CFGS["reduced"]
    tree = convert.numpy_model_params(cfg, 0)
    bad = dict(tree, embed=tree["embed"][:-1])
    with pytest.raises(ValueError, match="embed"):
        convert.model_params(bad, cfg, "cpu")
    with pytest.raises(ValueError, match="lm_head"):
        convert.model_params({k: v for k, v in tree.items()
                              if k != "lm_head"}, cfg, "cpu")
    import ml_dtypes
    half = dict(tree, embed=tree["embed"].astype(ml_dtypes.bfloat16))
    with pytest.raises(NotImplementedError, match="ROADMAP.md A13"):
        convert.model_params(half, cfg, "cpu")
