"""Training the dense bf16 configs: the attention's backward and the whole
model's gradients in the port, held against the JAX package on the CPU.

The plain bf16 flash backward (``ref.flash_attention_bwd``, which
``flash_attention_bwd_bf16`` is held to on the card) under
``models.flash.flash_attention`` and ``layers.attention`` against
``jax.vjp`` of the JAX package's custom VJP; ``train_loss`` and every
leaf's gradient of qwen3-4b and gemma3-12b reduced in bf16
(``chip_smoke.bf16_pin_config``: GQA 4/2 at head dim 128, and 256 with
gemma3's "SASA" and a 16-key window shorter than the 32-token sequence)
against ``jax.value_and_grad(train_loss)``, jitted and op by op; the
kernel wrappers past the dispatch rule on meta tensors; the depth cuts of
``chip_smoke.TRAIN_BF16`` against the JAX package's ``param_count``.
tests/test_torch_train_bf16_steps.py holds the scan steps, ``train()``,
its checkpoints and the CLI. Weights and inputs are bf16 values drawn with
numpy (``convert.numpy_model_params``), carried into both packages
exactly.

bf16 values are compared in ulps: ``ulp(x)`` is bf16's spacing at |x|.
Tolerances and why:
  * the flash backward (dq, dk, dv) and output: each element within one
    ulp of the larger of the two values plus FLASH_TOL (1 + |x|). Both
    packages compute in f32 from the same bf16 operands (JAX's ``bwd``
    upcasts dO, o, k and v, and ``_sdot`` sums bf16 products in f32) and
    round once; their f32 sums run in other orders (FLASH_TOL, the f32
    tests' 1e-5), and two f32 values that close may round to neighbouring
    bf16 values. The log-sum-exp is f32: FLASH_TOL;
  * ``layers.attention``'s VJP (x and the four projections): within
    LAYER_ULPS ulps of each tensor's largest magnitude: the projections,
    RoPE and the q/k norms round once an op in both packages, and a sum
    over one operand that rounded the other way moves by its ulp times a
    weight;
  * the model's gradients, leaf by leaf, in ulps of the leaf's largest
    |g|: each bf16 activation that rounds to the other neighbour in one
    package moves every sum it enters by its ulp times a weight, and the
    cotangent carries such flips back through every layer, so the bound
    grows with depth L: against JAX jitted, which keeps bf16 expressions
    in f32 inside its fusions and so rounds less often than op by op
    (ROADMAP.md §C, "XLA's excess bf16 precision"), GRAD_ULPS_JIT + L;
    against ``jax.disable_jit()``, op by op as the port runs,
    GRAD_ULPS_EAGER + L / 2. Measured at these sizes: at most 4.5 and 3
    ulps (qwen3, L = 2), 4 and 3 (gemma3, L = 4). The tied embedding's
    gradient adds the head's product to a scatter over repeated tokens,
    which XLA and PyTorch sum in other orders and precisions: EMBED_ULPS
    against either;
  * the loss, an f32 mean of per-token terms from bf16 logits: relative
    LOSS_RTOL_JIT against jitted JAX, LOSS_RTOL_EAGER op by op;
  * ``remat="full"`` against ``"none"``, and the cuda backend's plain
    versions against the reference backend's: the same bits (the
    checkpoint recomputes the bf16 logits and activations exactly);
  * launcher names, arities, launch counts, parameter counts: exact.
"""
import dataclasses
import re
import sys
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the repository root's script)
from repro.configs import get as j_get  # noqa: E402
from repro.models import flash as j_flash  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import model as j_model  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.data import lm_data  # noqa: E402
from repro_torch.kernels import build, common  # noqa: E402
from repro_torch.kernels import flash_attention as kflash  # noqa: E402
from repro_torch.kernels import flash_backward as kbwd  # noqa: E402
from repro_torch.models import flash, layers, model  # noqa: E402
from repro_torch.random import PRNGKey  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

FLASH_TOL = 1e-5
LAYER_ULPS = 2
GRAD_ULPS_JIT = 4
GRAD_ULPS_EAGER = 3
EMBED_ULPS = 4
LOSS_RTOL_JIT = 2.0 ** -9
LOSS_RTOL_EAGER = 2.0 ** -12
ARCHS = ("qwen3-4b", "gemma3-12b")
CFGS = {a: chip_smoke.bf16_pin_config(get, a) for a in ARCHS}
J_CFGS = {a: chip_smoke.bf16_pin_config(j_get, a) for a in ARCHS}
BATCH, SEQ = 2, 32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the port's CPU work here: in a parallel test
    run a pool of threads in every worker process contends for the same
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32)).astype(np.float64)


def _ulp(x) -> np.ndarray:
    """bf16's spacing at |x| (elementwise; at 2^-126 and below, there)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
                   - 7)


def _within_one_ulp(got, want) -> float:
    """The largest ratio of |got - want| to one ulp of the larger value
    plus FLASH_TOL (1 + |want|), elementwise."""
    a, b = _f64(got), _f64(want)
    bound = _ulp(np.maximum(np.abs(a), np.abs(b))) + FLASH_TOL * (1 + abs(b))
    return float((np.abs(a - b) / bound).max())


def _ulps_of_largest(got, want) -> float:
    """max |got - want| in ulps of want's largest magnitude."""
    a, b = _f64(got), _f64(want)
    top = np.abs(b).max()
    if top == 0:
        return float(np.abs(a).max())
    return float(np.abs(a - b).max() / _ulp(top))


def _bf16(rng, shape, scale=1.0) -> np.ndarray:
    """bf16 values (as f32) of a standard normal times ``scale``."""
    return convert.bf16_values(rng.standard_normal(shape) * scale)


# ------------------------------------------------------------ the backward
# (b, h, kh, l, d, causal, window, block): GQA 1, 2 and 4, d 64 and 256
# (gemma3's), causal with and without a window shorter than L,
# non-causal, blocks of 16 and the whole sequence
BWD_CASES = [(2, 4, 2, 48, 64, True, None, 16),
             (1, 8, 2, 64, 64, True, 20, 16),
             (2, 4, 4, 48, 256, True, None, 48),
             (1, 4, 2, 32, 256, True, 12, 16),
             (1, 4, 1, 40, 64, False, None, 40),
             (1, 8, 2, 48, 128, False, 16, 16)]


_JAX_FLASH = {}


def _jax_flash(case):
    """The bf16 inputs of one case, and JAX's o, lse (the custom VJP's
    residual) and vjp (dq, dk, dv), computed once a case (both backends
    compare with them)."""
    if case not in _JAX_FLASH:
        b, h, kh, l, d, causal, window, block = case
        rng = np.random.default_rng(sum(case[:5]))
        ins = [_bf16(rng, s) for s in ((b, h, l, d), (b, kh, l, d),
                                       (b, kh, l, d), (b, h, l, d))]
        jq, jk, jv, jdo = (jnp.asarray(x).astype(jnp.bfloat16) for x in ins)
        fn = j_flash._make_flash(causal, window, d ** -0.5, block, block, 0)

        @jax.jit
        def run(q_, k_, v_, do_):
            o, vjp = jax.vjp(lambda a, b_, c: j_flash.flash_attention(
                a, b_, c, causal=causal, window=window, q_block=block,
                kv_block=block), q_, k_, v_)
            _, res = fn.fwd(q_.reshape(b, kh, h // kh, l, d), k_, v_)
            return o, res[4].reshape(b, h, l), vjp(do_)

        _JAX_FLASH[case] = (ins, *run(jq, jk, jv, jdo))
    return _JAX_FLASH[case]


@pytest.mark.parametrize("backend", ["cuda", "reference"])
@pytest.mark.parametrize("case", BWD_CASES,
                         ids=["-".join(map(str, c)) for c in BWD_CASES])
def test_bf16_flash_vjp_matches_jax(case, backend):
    """``models.flash.flash_attention`` under autograd on bf16 (B, H, L, d)
    views of (B, L, H, d) tensors: o, the saved log-sum-exp and dq, dk, dv
    of one bf16 cotangent against ``jax.vjp`` of the JAX package's custom
    VJP, each in its operand's dtype."""
    b, h, kh, l, d, causal, window, block = case
    (q, k, v, do), jo, jlse, jgrads = _jax_flash(case)
    leaves = [torch.tensor(x.transpose(0, 2, 1, 3)).to(
        torch.bfloat16).requires_grad_() for x in (q, k, v)]
    out = flash.flash_attention(*(x.transpose(1, 2) for x in leaves),
                                causal=causal, window=window, q_block=block,
                                kv_block=block, backend=backend)
    assert out.dtype == torch.bfloat16
    assert _within_one_ulp(out, jo) <= 1.0
    lse = out.grad_fn.saved_tensors[4]
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse),
                               rtol=FLASH_TOL, atol=FLASH_TOL)
    out.backward(torch.tensor(do).to(torch.bfloat16))
    for x, w in zip(leaves, jgrads):
        assert x.grad.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        assert _within_one_ulp(x.grad.transpose(1, 2), w) <= 1.0


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_attention_layer_vjp_matches_jax(arch):
    """``layers.attention(..., train=True)`` (projections, q/k norms, RoPE,
    the flash attention and its backward) against ``jax.vjp`` of the JAX
    package's ``layers.attention``: the output and the gradients of x and
    of every weight, each "S" layer's window included."""
    cfg, jcfg = CFGS[arch], J_CFGS[arch]
    tree = convert.numpy_model_params(cfg, 4)
    jlp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a[0]).astype(jnp.bfloat16),
        tree["blocks"]["l0"]["mixer"])
    tp = tree_map(lambda a: a[0].detach().clone().requires_grad_(),
                  convert.model_params(tree, cfg, "cpu")["blocks"]["l0"][
                      "mixer"])
    rng = np.random.default_rng(5)
    x, dy = (_bf16(rng, (BATCH, SEQ, cfg.d_model)) for _ in range(2))
    window = cfg.sliding_window if cfg.layer_pattern[0] == "S" else None
    pos = np.arange(SEQ, dtype=np.int32)

    @jax.jit
    def run(p, a, ct):
        y, vjp = jax.vjp(lambda p_, a_: j_layers.attention(
            p_, jcfg, a_, jnp.asarray(pos), window=window, q_block=SEQ,
            kv_block=SEQ), p, a)
        return y, vjp(ct)

    jy, (jgp, jgx) = run(jlp, jnp.asarray(x).astype(jnp.bfloat16),
                         jnp.asarray(dy).astype(jnp.bfloat16))
    tx = torch.tensor(x).to(torch.bfloat16).requires_grad_()
    y = layers.attention(tp, cfg, tx, torch.tensor(pos), window=window,
                         backend="cuda", train=True)
    y.backward(torch.tensor(dy).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    assert _ulps_of_largest(y, jy) <= LAYER_ULPS
    assert _ulps_of_largest(tx.grad, jgx) <= LAYER_ULPS
    named = convert.named_leaves(tp)
    jnamed = convert.named_leaves(jgp)
    assert set(named) == set(jnamed)
    for key, g in jnamed.items():
        got = named[key].grad
        assert got.dtype == torch.bfloat16
        assert _ulps_of_largest(got, g) <= LAYER_ULPS, key


# ------------------------------------------------------------ the model
def _batch(cfg, seed=3):
    tb = next(lm_data.batch_iterator(cfg, global_batch=BATCH, seq_len=SEQ,
                                     seed=seed, device="cpu"))
    return tb, {k: jnp.asarray(v.numpy().astype(np.int32))
                for k, v in tb.items()}


@pytest.fixture(scope="module")
def jax_grads():
    """Per arch: the batch, and JAX's (loss, gradients) of train_loss,
    jitted and op by op (``jax.disable_jit()``)."""
    out = {}
    for arch in ARCHS:
        tree = convert.numpy_model_params(CFGS[arch], 2)
        jp = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x).astype(jnp.bfloat16), tree)
        tb, jb = _batch(CFGS[arch])

        def loss(p, arch=arch, jb=jb):
            return j_model.train_loss(p, J_CFGS[arch], jb)[0]

        jit = jax.jit(jax.value_and_grad(loss))(jp)
        with jax.disable_jit():
            eager = jax.value_and_grad(loss)(jp)
        out[arch] = (tree, tb, jit, eager)
    return out


def _port_grads(tree, cfg, tb, remat, backend):
    tp = convert.model_params(tree, cfg, "cpu")
    leaves = {k: v.requires_grad_() for k, v
              in convert.named_leaves(tp).items()}
    loss, parts = model.train_loss(tp, cfg, tb, remat=remat,
                                   backend=backend)
    loss.backward()
    assert set(parts) == {"xent", "router_aux"}
    return loss.detach(), {k: v.grad for k, v in leaves.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_train_loss_and_grads_match_jax(jax_grads, arch):
    """``train_loss`` and every leaf's gradient, bf16 like its leaf, on
    both backends and both remats, against JAX's jitted and op-by-op
    ``value_and_grad``; the port's four runs give the same bits."""
    cfg = CFGS[arch]
    tree, tb, (jl, jg), (el, eg) = jax_grads[arch]
    runs = {(remat, backend): _port_grads(tree, cfg, tb, remat, backend)
            for remat in ("none", "full") for backend in ("cuda",
                                                          "reference")}
    loss, grads = runs[("none", "cuda")]
    for other_loss, other in runs.values():
        assert torch.equal(other_loss, loss)
        assert all(torch.equal(other[k].view(torch.int16),
                               grads[k].view(torch.int16)) for k in grads)
    assert loss.dtype == torch.float32
    assert abs(float(loss) - float(jl)) <= LOSS_RTOL_JIT * abs(float(jl))
    assert abs(float(loss) - float(el)) <= LOSS_RTOL_EAGER * abs(float(el))
    jnamed, enamed = convert.named_leaves(jg), convert.named_leaves(eg)
    assert set(jnamed) == set(enamed) == set(grads)
    n = cfg.num_layers
    for key, g in grads.items():
        assert g.dtype == torch.bfloat16 and jnamed[key].dtype == jnp.bfloat16
        jit_bound = EMBED_ULPS if key == "embed" else GRAD_ULPS_JIT + n
        eager_bound = EMBED_ULPS if key == "embed" \
            else GRAD_ULPS_EAGER + n / 2
        assert _ulps_of_largest(g, jnamed[key]) <= jit_bound, key
        assert _ulps_of_largest(g, enamed[key]) <= eager_bound, key


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_runs_and_keeps_bf16(arch):
    """``forward`` of a bf16 config: bf16 hidden states of (B, L, D) and
    the f32 zero aux loss, the same bits on both backends."""
    cfg = CFGS[arch]
    tp = convert.model_params(convert.numpy_model_params(cfg, 1), cfg,
                              "cpu")
    tb, _ = _batch(cfg, seed=8)
    outs = [model.forward(tp, cfg, tb["tokens"], backend=b)
            for b in ("cuda", "reference")]
    for x, aux in outs:
        assert x.dtype == torch.bfloat16 and x.shape == (BATCH, SEQ,
                                                         cfg.d_model)
        assert aux.dtype == torch.float32 and float(aux) == 0.0
        assert bool(torch.isfinite(x).all())
    assert torch.equal(outs[0][0].view(torch.int16),
                       outs[1][0].view(torch.int16))


# --------------------------------------------------- the depth cuts (pins)
@pytest.mark.parametrize("arch", sorted(chip_smoke.TRAIN_BF16))
def test_train_bf16_pins_are_the_jax_param_counts(arch):
    """Each cut config of phase train_bf16 (and of its lockstep): the
    published widths, the port's parameter count the JAX package's."""
    spec = chip_smoke.TRAIN_BF16[arch]
    cuts = [({"num_layers": r["num_layers"]}, r["params"])
            for r in spec["runs"].values()]
    cuts.append((chip_smoke.TRAIN_BF16_LOCKSTEP[arch], None))
    full = get(arch)
    for cut, want in cuts:
        cfg = chip_smoke.train_bf16_config(arch, **cut)
        jcfg = dataclasses.replace(j_get(arch), **cut).validate()
        for attr in ("d_model", "num_heads", "num_kv_heads", "head_dim",
                     "d_ff", "vocab_size", "dtype", "tie_embeddings"):
            assert getattr(cfg, attr) == getattr(full, attr)
        n = model.param_count(cfg)
        assert n == j_model.param_count(jcfg)
        if want is not None:
            assert n == want
        if "layer_pattern" in cut:
            assert set(cfg.layer_pattern) == {"S", "A"}


# ------------------------------------------------- the kernels past dispatch
@pytest.fixture
def on_card(monkeypatch):
    """B14 and the backward past the dispatch rule as on a card: meta
    tensors count as on the card, each ``launch`` is recorded (and counted
    per launcher, as ``build.launch`` counts it)."""
    calls = []

    def record(lib, fn, dev, *args):
        calls.append((lib, fn, args))
        common.LAUNCHERS[fn] = common.LAUNCHERS.get(fn, 0) + 1

    for mod in (kflash, kbwd):
        monkeypatch.setattr(mod, "on_card", lambda name, *ts, **kw: True)
        monkeypatch.setattr(mod, "launch", record)
    common.reset_launches()
    return calls


def _c_arity(lib: str, fn: str) -> int:
    src = (build.CSRC / f"{lib}.cu").read_text()
    found = re.search(rf"\bint {fn}\(([^)]*)\)", src)
    assert found, f"{fn} is not defined in {lib}.cu"
    return len(found.group(1).split(","))


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("d", [64, 128, 256])
def test_bf16_backward_launcher_matches_its_c_definition(on_card, d):
    """bf16 operands: B14 bf16 with its lse, then one launch of
    ``flash_attention_bwd_bf16`` with the C arity, the f32 lse, bf16 dq,
    dk and dv in the operands' shapes; one count of the kernel and one of
    the launcher."""
    q = _meta(2, 8, 40, d).transpose(1, 2)
    k = _meta(2, 40, 2, d).transpose(1, 2)
    out, lse = kflash.flash_attention(q, k, k, return_lse=True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    dq, dk, dv = kbwd.flash_attention_bwd(q, k, k, out, lse, q, window=16)
    assert all(t.dtype == torch.bfloat16 for t in (dq, dk, dv))
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
    assert [c[:2] for c in on_card] == [
        ("flash_attention", "flash_attention_bf16"),
        ("flash_backward", "flash_attention_bwd_bf16")]
    for lib, fn, args in on_card:
        assert len(build.SIGNATURES[lib][fn]) == len(args) + 2 \
            == _c_arity(lib, fn)
    assert {k_: c for k_, c in common.LAUNCHES.items() if c} == {
        "flash_attention": 1, "flash_attention_bwd": 1}
    assert {k_: c for k_, c in common.LAUNCHERS.items() if c} == {
        "flash_attention_bf16": 1, "flash_attention_bwd_bf16": 1}
    assert set(build.SIGNATURES["flash_backward"]) == {
        "flash_attention_bwd_f32", "flash_attention_bwd_bf16"}


@pytest.mark.parametrize("dtypes", [
    (torch.float16,) * 5, (torch.float64,) * 5,
    (torch.bfloat16,) * 4 + (torch.float32,),
    (torch.float32,) * 4 + (torch.bfloat16,)],
    ids=["f16", "f64", "bf16-do-f32", "f32-do-bf16"])
def test_backward_refuses_other_dtypes_naming_queue_b(on_card, dtypes):
    """On the card an f16 or f64 backward, or one of mixed operand
    dtypes, raises ``TypeError`` naming ROADMAP queue B before any
    launch; so does an lse that is not f32."""
    q, k, v, o, do = (_meta(1, 2, 8, 16, dtype=dt) for dt in dtypes)
    lse = _meta(1, 2, 8, dtype=torch.float32)
    with pytest.raises(TypeError, match="ROADMAP queue B"):
        kbwd.flash_attention_bwd(q, k, v, o, lse, do)
    b = _meta(1, 2, 8, 16)
    with pytest.raises(TypeError, match="ROADMAP queue B"):
        kbwd.flash_attention_bwd(b, b, b, b, _meta(1, 2, 8), b)
    assert on_card == [] and not any(common.LAUNCHERS.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_training_routes_through_the_bf16_builds(on_card, arch):
    """A bf16 layer's training forward runs B14 bf16 with its lse and its
    backward the bf16 launcher, at the model's head dim, on the model's
    strided (B, H, L, d) views, which the 16-byte loads take."""
    cfg = CFGS[arch]
    lp = model.init_params(PRNGKey(0, device="cpu"), cfg,
                           device="meta")["blocks"]["l0"]["mixer"]
    lp = {k: ({"scale": v["scale"][0]} if isinstance(v, dict) else v[0])
          for k, v in lp.items()}
    q = _meta(2, 8, cfg.num_heads, cfg.head_dim).transpose(1, 2)
    assert kflash.tc_copy_ok(q)
    x = _meta(2, 8, cfg.d_model)
    pos = torch.arange(8, dtype=torch.int32, device="meta")
    y = layers.attention(lp, cfg, x, pos, train=True)
    assert y.dtype == torch.bfloat16
    assert [c[1] for c in on_card] == ["flash_attention_bf16"]
    assert on_card[0][2][4] is not None        # the lse pointer
