"""LM training in the port held against the JAX package's, on the CPU.

``lm_data.batch_iterator``; ``models.flash.flash_attention`` (its output,
log-sum-exp and dq/dk/dv against ``jax.vjp`` of the JAX package's custom
VJP; the plain backward against autograd through ``reference_attention``);
``chunked_xent``, ``forward`` and ``train_loss`` with the gradient of every
named leaf; three ``make_scan_step`` steps of the scan strategy on both
backends, dense and int8; ``trainer.train``'s history; checkpoints both
ways; the CLI; what raises naming ROADMAP.md A13; and the kernel wrappers
past the dispatch rule (their launchers, arities and counts). The model is
chb-paper-lm-124m's ``reduced()`` (2 layers, d 256, 4 heads of 64, vocab
512) with weights from ``convert.numpy_model_params`` carried into both
packages, or each package's ``init_params(PRNGKey(0))`` in ``train()``.
On the CPU the ``cuda`` backend runs the kernels' plain versions.

Tolerances and why:
  * tokens, labels, masks, ``transmitted``, the counters, checkpoint keys
    and arrays, launcher names and arities: exact;
  * attention (o, lse, dq, dk, dv): rtol = atol = FLASH_TOL = 1e-5. The
    JAX package's flash attention computes in f32 whatever its inputs
    (``preferred_element_type=float32`` and f32 accumulators), and so do
    the port's plain versions, so the f64 cases are held to the f32
    tolerance too: f32 products of up to 32 terms and softmax sums in
    another order, about 6e-7 relative;
  * the model (hidden states, loss, gradients): rtol = atol = MODEL_TOL =
    1e-4, two layers of f32 matmuls of 256-1024 terms summed in other
    orders, the backward on top (tests/test_torch_models.py holds
    prefill's logits to 2e-4);
  * three scan steps (theta, the bank, the error feedback, the metrics):
    rtol = 1e-5 with atol = STEP_ATOL = 1e-6 (the bank holds gradients of
    1e-3 and below); every eq.-(8) decision clears its threshold by more
    than MARGIN = 1e-3 relative (asserted), so masks and counters are
    exact. Under int8 a code whose pending value lies within rounding of
    a half step may round the other way in one package: at most
    FLIP_SHARE of a leaf's elements may then differ, by up to one
    quantization step (max |ghat' - ghat| / 127 of the leaf), theta by
    alpha / (1 - beta) times it a step;
  * ``train()``, 4 steps: the two packages' weights differ by up to 4
    ulps (tests/test_torch_models.py), so losses and norms within
    HIST_RTOL = 1e-4; masks and counters exact (margins asserted).
"""
import dataclasses
import json
import re

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import checkpoint as j_ckpt  # noqa: E402
from repro.configs import get as j_get  # noqa: E402
from repro.core import distributed as j_dist  # noqa: E402
from repro.data import lm_data as j_lm_data  # noqa: E402
from repro.models import flash as j_flash  # noqa: E402
from repro.models import model as j_model  # noqa: E402
from repro.train import trainer as j_trainer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.data import lm_data  # noqa: E402
from repro_torch.kernels import build, common  # noqa: E402
from repro_torch.kernels import flash_attention as kflash  # noqa: E402
from repro_torch.kernels import flash_backward as kbwd  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import flash, layers, model  # noqa: E402
from repro_torch.opt import censor as opt_censor  # noqa: E402
from repro_torch.random import PRNGKey  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

FLASH_TOL = 1e-5
MODEL_TOL = 1e-4
STEP_RTOL = 1e-5
STEP_ATOL = 1e-6
HIST_RTOL = 1e-4
MARGIN = 1e-3
FLIP_SHARE = 1e-3
A13 = "ROADMAP.md A13"

CFG = get("chb-paper-lm-124m").reduced()
J_CFG = j_get("chb-paper-lm-124m").reduced()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the port's CPU work here: the model is
    small, and in a parallel test run a pool of threads in every worker
    process contends for the same cores (the weights' PRNG then runs
    30 times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol, atol=None):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol,
                               atol=rtol if atol is None else atol)


def _weights(seed=0):
    tree = convert.numpy_model_params(CFG, seed)
    return (convert.model_params(tree, CFG, "cpu"),
            jax.tree_util.tree_map(jnp.asarray, tree))


def _jax_batch(tb):
    return {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in tb.items()}


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("workers,hetero", [(None, False), (4, False),
                                            (4, True)],
                         ids=["flat", "chunked", "heterogeneous"])
def test_batch_iterator_is_the_jax_package_s(workers, hetero):
    kw = dict(global_batch=8, seq_len=16, num_workers=workers, seed=5,
              heterogeneous=hetero)
    ours = lm_data.batch_iterator(CFG, device="cpu", **kw)
    theirs = j_lm_data.batch_iterator(J_CFG, **kw)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert set(a) == set(b) == {"tokens", "labels"}
        for key in a:
            assert a[key].dtype == torch.int64
            assert a[key].device.type == "cpu"
            assert tuple(a[key].shape) == b[key].shape
            np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]))


def test_batch_iterator_refuses_a_frontend_naming_the_roadmap():
    cfg = dataclasses.replace(CFG, frontend="audio")
    with pytest.raises(NotImplementedError, match=A13):
        next(lm_data.batch_iterator(cfg, global_batch=2, seq_len=4,
                                    device="cpu"))
    with pytest.raises(ValueError, match="worker"):
        next(lm_data.batch_iterator(CFG, global_batch=2, seq_len=4,
                                    heterogeneous=True, device="cpu"))


# ------------------------------------------------------------------ flash
# (b, h, kh, l, d, causal, window, block): GQA 1, 2 and 4, causal with and
# without a window, non-causal, L in {48, 64} in blocks of 16 or the
# whole sequence, d in {16, 32}
FLASH_CASES = [(2, 4, 4, 48, 16, True, None, 16),
               (2, 4, 2, 64, 32, True, None, 16),
               (1, 8, 2, 64, 16, True, 7, 512),
               (2, 4, 1, 48, 32, False, None, 16),
               (1, 8, 2, 48, 16, True, 20, 16),
               (1, 4, 1, 64, 32, False, 12, 512)]
DTYPES = {"f32": np.float32, "f64": np.float64}


def _qkvd(case, dtype, seed):
    b, h, kh, l, d = case[:5]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype)
            for s in ((b, h, l, d), (b, kh, l, d), (b, kh, l, d),
                      (b, h, l, d))]


_JAX_FLASH = {}


def _jax_flash(q, k, v, do, causal, window, block):
    """JAX's o, lse (the custom VJP's residual) and vjp (dq, dk, dv),
    computed once for each input (both backends compare with them)."""
    key = (q.tobytes(), q.dtype.str, causal, window, block)
    if key not in _JAX_FLASH:
        _JAX_FLASH[key] = _jax_flash_run(q, k, v, do, causal, window, block)
    return _JAX_FLASH[key]


def _jax_flash_run(q, k, v, do, causal, window, block):
    b, h, l, d = q.shape
    kh = k.shape[1]
    fn = j_flash._make_flash(causal, window, d ** -0.5, block if l % block
                             == 0 else l, block if l % block == 0 else l, 0)
    q5 = jnp.asarray(q).reshape(b, kh, h // kh, l, d)
    _, res = fn.fwd(q5, jnp.asarray(k), jnp.asarray(v))
    o, vjp = jax.vjp(lambda a, b_, c: j_flash.flash_attention(
        a, b_, c, causal=causal, window=window, q_block=block,
        kv_block=block), *(jnp.asarray(x) for x in (q, k, v)))
    return o, res[4].reshape(b, h, l), vjp(jnp.asarray(do))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("backend", ["cuda", "reference"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_and_its_vjp_match_jax(case, backend, dtype):
    """``models.flash.flash_attention`` under autograd on (B, H, L, d) views
    of (B, L, H, d) tensors, as the model passes them: o, the saved
    log-sum-exp and dq, dk, dv of one cotangent against JAX's."""
    b, h, kh, l, d, causal, window, block = case
    q, k, v, do = _qkvd(case, DTYPES[dtype], sum(case[:5]))
    jo, jlse, jgrads = _jax_flash(q, k, v, do, causal, window, block)
    leaves = [torch.tensor(x.transpose(0, 2, 1, 3)).requires_grad_()
              for x in (q, k, v)]
    out = flash.flash_attention(*(x.transpose(1, 2) for x in leaves),
                                causal=causal, window=window,
                                q_block=block, kv_block=block,
                                backend=backend)
    assert out.dtype == torch.from_numpy(q).dtype
    _close(out, jo, FLASH_TOL)
    assert out.grad_fn.saved_tensors[4].dtype == torch.float32
    _close(out.grad_fn.saved_tensors[4], jlse, FLASH_TOL)
    out.backward(torch.tensor(do))
    for x, w in zip(leaves, jgrads):
        assert x.grad.dtype == x.dtype
        _close(x.grad.transpose(1, 2), w, FLASH_TOL)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_plain_backward_is_autograd_through_reference_attention(case):
    """``ref.flash_attention_bwd`` (the kernel's plain version) from the
    plain forward's o and lse against autograd through the naive oracle,
    and B14's plain log-sum-exp against the blocked forward's."""
    b, h, kh, l, d, causal, window, block = case
    q, k, v, do = (torch.tensor(x) for x in _qkvd(case, np.float32, 9))
    kw = dict(causal=causal, window=window)
    o, lse = ref.flash_attention_blocked(q, k, v, q_block=block,
                                         kv_block=block, **kw)
    got = kbwd.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = flash.reference_attention(*leaves, **kw)
    want.backward(do)
    _close(o, want.detach(), FLASH_TOL)
    for a, x in zip(got, leaves):
        _close(a, x.grad, FLASH_TOL)
    o2, lse2 = kflash.flash_attention(q, k, v, return_lse=True, **kw)
    _close(o2, o, FLASH_TOL)
    _close(lse2, lse, FLASH_TOL)
    assert torch.equal(kflash.flash_attention(q, k, v, **kw), o2)
    _close(flash.reference_attention(q, k, v, q_offset=16, **kw),
           j_flash.reference_attention(*(jnp.asarray(x.numpy())
                                         for x in (q, k, v)),
                                       q_offset=16, **kw), FLASH_TOL)


def test_flash_attention_takes_a_query_offset_on_the_plain_path():
    """Queries at positions 32.. against the whole key range: JAX's VJP
    with ``q_offset``; the kernels take none and the cuda backend on CUDA
    tensors refuses it (checked on meta tensors here)."""
    q, k, v, do = _qkvd((1, 4, 2, 64, 16), np.float32, 4)
    q, do = q[:, :, 32:], do[:, :, 32:]
    o, vjp = jax.vjp(lambda a, b, c: j_flash.flash_attention(
        a, b, c, q_offset=32, q_block=16, kv_block=16),
        *(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.tensor(x).requires_grad_() for x in (q, k, v)]
    out = flash.flash_attention(*leaves, q_offset=32, q_block=16,
                                kv_block=16, backend="cuda")
    _close(out, o, FLASH_TOL)
    out.backward(torch.tensor(do))
    for x, w in zip(leaves, vjp(jnp.asarray(do))):
        _close(x.grad, w, FLASH_TOL)
    meta = torch.empty((1, 4, 8, 16), device="meta")
    with pytest.raises(ValueError, match="backend"):
        flash.flash_attention(meta, meta, meta, backend="pallas")


# ------------------------------------------------------------------ model
def test_chunked_xent_matches_jax():
    """The chunks of ``_pick_block(L, chunk)`` (48 in chunks of 16, and a
    length with no divisor up to the chunk but 1: 7) and the gold logit
    picked by a select, against JAX's value and gradients."""
    rng = np.random.default_rng(4)
    for l, chunk in ((48, 16), (7, 4)):
        x = rng.standard_normal((2, l, 16)).astype(np.float32)
        w = rng.standard_normal((16, 40)).astype(np.float32)
        y = rng.integers(0, 40, size=(2, l))
        tx, tw = (torch.tensor(a).requires_grad_() for a in (x, w))
        loss = model.chunked_xent(tx, tw, torch.tensor(y), chunk=chunk)
        loss.backward()
        jl, (gx, gw) = jax.value_and_grad(
            lambda a, b: j_model.chunked_xent(a, b, jnp.asarray(y),
                                              chunk=chunk),
            argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
        assert loss.dtype == torch.float32
        _close(loss, jl, FLASH_TOL)
        _close(tx.grad, gx, FLASH_TOL)
        _close(tw.grad, gw, FLASH_TOL)


@pytest.fixture(scope="module")
def jax_loss_run():
    """JAX's forward, train_loss and gradients of one batch (remat "full",
    the JAX default; "none" computes the same function)."""
    _, jp = _weights(seed=2)
    tb = next(lm_data.batch_iterator(CFG, global_batch=4, seq_len=24,
                                     seed=3, device="cpu"))
    jb = _jax_batch(tb)
    jx, jaux = jax.jit(lambda p, t: j_model.forward(p, J_CFG, t))(
        jp, jb["tokens"])
    (jloss, jparts), jgrads = jax.jit(jax.value_and_grad(
        lambda p: j_model.train_loss(p, J_CFG, jb), has_aux=True))(jp)
    return tb, jx, jaux, jloss, jparts, jgrads


@pytest.mark.parametrize("backend", ["cuda", "reference"])
@pytest.mark.parametrize("remat", ["none", "full"])
def test_forward_train_loss_and_grads_match_jax(jax_loss_run, remat,
                                                backend):
    tb, jx, jaux, jloss, jparts, jgrads = jax_loss_run
    tp, _ = _weights(seed=2)
    x, aux = model.forward(tp, CFG, tb["tokens"], remat=remat,
                           backend=backend)
    _close(x, jx, MODEL_TOL)
    assert float(aux) == float(jaux) == 0.0
    leaves = {k: v.requires_grad_() for k, v
              in convert.named_leaves(tp).items()}
    loss, parts = model.train_loss(tp, CFG, tb, remat=remat,
                                   backend=backend)
    loss.backward()
    assert set(parts) == set(jparts) == {"xent", "router_aux"}
    _close(loss, jloss, MODEL_TOL)
    _close(parts["xent"], jparts["xent"], MODEL_TOL)
    jnamed = convert.named_leaves(jgrads)
    assert set(jnamed) == set(leaves)
    for key, g in jnamed.items():
        _close(leaves[key].grad, g, MODEL_TOL)


# ------------------------------------------------------- the scan strategy
def _tc(**kw):
    base = dict(algorithm="chb", num_workers=4, alpha=0.05, beta=0.4,
                eps1_scale=8.0, global_batch=8, seq_len=16, steps=4,
                log_every=1, remat="none")
    base.update(kw)
    return base


def _margins(jloss, jp, jstate, jbatch, o):
    """Each worker's |dsq - eps1 ssq| / (eps1 ssq), from JAX's gradients
    (the step's own arithmetic in f32)."""
    ssq = sum(jnp.sum((a - b) ** 2) for a, b in zip(
        jax.tree_util.tree_leaves(jp),
        jax.tree_util.tree_leaves(jstate.prev_params)))
    grad = jax.jit(jax.grad(jloss))
    out = []
    for m in range(o.num_workers):
        g = grad(jp, {k: v[m] for k, v in jbatch.items()})
        delta = jax.tree_util.tree_map(lambda a, h: a - h[m], g, jstate.ghat)
        if o.quantize:
            delta = jax.tree_util.tree_map(lambda a, e: a + e[m], delta,
                                           jstate.err)
        dsq = sum(jnp.sum(x ** 2) for x in jax.tree_util.tree_leaves(delta))
        thr = o.eps1 * float(ssq)
        out.append(abs(float(dsq) - thr) / thr)
    return out


def _code_close(got, want, step):
    """An int8 leaf: within the step tolerance but for at most FLIP_SHARE
    of its elements, which may differ by up to one quantization step (a
    code that rounds the other way)."""
    got, want = got.numpy(), np.asarray(want)
    off = np.abs(got - want) > STEP_ATOL + STEP_RTOL * np.abs(want)
    assert off.mean() <= FLIP_SHARE
    assert np.abs(got - want).max() <= step + STEP_ATOL


SCAN_STEPS = 3


@pytest.fixture(scope="module")
def jax_scan_runs():
    """For dense and int8: one JAX state after one step (so ssq > 0), as
    numpy, then SCAN_STEPS more jitted JAX steps with each step's outputs
    and each step's decision margins."""
    runs = {}
    _, jp0 = _weights(seed=1)
    it = lm_data.batch_iterator(CFG, global_batch=8, seq_len=16,
                                num_workers=4, seed=7, device="cpu")
    batches = [next(it) for _ in range(SCAN_STEPS + 1)]

    def jloss(p, b):
        return j_model.train_loss(p, J_CFG, b, remat="none")[0]

    for quantize in (None, "int8"):
        jo = j_trainer.make_optimizer(j_trainer.TrainConfig(
            **_tc(quantize=quantize)))
        jstep = jax.jit(j_dist.make_scan_step(jo, jloss))
        jp, jstate, _ = jstep(jp0, j_dist.init_scan_state(jo, jp0),
                              _jax_batch(batches[0]))
        start = jax.tree_util.tree_map(np.asarray, (jp, jstate))
        steps = []
        for tb in batches[1:]:
            jb = _jax_batch(tb)
            margins = _margins(jloss, jp, jstate, jb, jo)
            jp, jstate, met = jstep(jp, jstate, jb)
            steps.append((jp, jstate, met, margins))
        runs[quantize] = (start, batches[1:], steps)
    return runs


@pytest.mark.parametrize("backend", ["cuda", "reference"])
@pytest.mark.parametrize("quantize", [None, "int8"], ids=["dense", "int8"])
def test_three_scan_steps_match_jax(jax_scan_runs, quantize, backend):
    """From one converted JAX state, SCAN_STEPS steps in each package:
    theta, the bank, the error feedback, prev_params, the counters and the
    metrics after every step; some workers censored, some not."""
    (np_params, np_state), batches, steps = jax_scan_runs[quantize]
    tc = trainer.TrainConfig(**_tc(quantize=quantize))
    o = trainer.make_optimizer(tc)
    assert o.eps1 > 0
    step = distributed.make_scan_step(
        o, lambda p, b: model.train_loss(p, CFG, b, remat="none",
                                         backend=backend)[0],
        backend=backend)
    tp = convert.model_params(np_params, CFG, "cpu")
    tstate = convert.dist_state(np_state, "cpu")
    sends = []
    # int8: a leaf's quantization step so far (a worker's payload is its
    # codes times amax / 127, so max |ghat' - ghat| / 127 bounds a step)
    code_step = [0.0] * len(jax.tree_util.tree_leaves(np_state.ghat))
    jbank = np_state.ghat
    for t, (tb, (jp, jstate, jmet, margins)) in enumerate(zip(batches,
                                                              steps)):
        assert min(margins) > MARGIN, (t, margins)
        prev = tp
        tp, tstate, met = step(tp, tstate, tb)
        assert tstate.prev_params is prev
        assert set(met) == set(jmet) == {"loss", "transmitted",
                                         "step_sqnorm", "agg_grad_sqnorm"}
        assert float(met["transmitted"]) == float(jmet["transmitted"])
        sends.append(float(met["transmitted"]))
        for f in tstate.comm._fields:
            np.testing.assert_array_equal(
                getattr(tstate.comm, f).numpy(),
                np.asarray(getattr(jstate.comm, f)))
        assert int(tstate.step) == int(jstate.step) == t + 2
        for key in met:
            _close(met[key], jmet[key], STEP_RTOL, STEP_ATOL)
        trees = [jax.tree_util.tree_leaves(x) for x in (
            tp, jp, tstate.ghat, jstate.ghat)]
        if not quantize:
            for a, w, h, jh in zip(*trees):
                _close(a, w, STEP_RTOL, STEP_ATOL)
                _close(h, jh, STEP_RTOL, STEP_ATOL)
            assert tstate.err == () and jstate.err == ()
            continue
        trees += [jax.tree_util.tree_leaves(x) for x in (
            tstate.err, jstate.err, jbank)]
        for i, (a, w, h, jh, e, je, jh0) in enumerate(zip(*trees)):
            moved = np.abs(np.asarray(jh) - np.asarray(jh0)).max()
            code_step[i] = max(code_step[i], float(moved) / 127 * 1.001)
            # theta moves by alpha times a flipped code, carried on by the
            # momentum (at most 1 / (1 - beta) of it), once a step
            _code_close(a, w, o.alpha * code_step[i] * (t + 1)
                        / (1 - o.beta))
            _code_close(h, jh, code_step[i])
            _code_close(e, je, code_step[i])
        jbank = jstate.ghat
    # the steps censor some workers and not others
    assert 0 < sum(sends) < SCAN_STEPS * o.num_workers


def test_scan_step_refuses_what_it_does_not_carry():
    o = trainer.make_optimizer(trainer.TrainConfig(**_tc()))
    with pytest.raises(NotImplementedError):
        distributed.make_scan_step(
            dataclasses.replace(o, transport=trainer.opt.make_transport(
                "topk", k=4)), None)
    with pytest.raises(ValueError, match="backend"):
        distributed.make_scan_step(o, None, backend="pallas")
    with pytest.raises(NotImplementedError, match=A13):
        distributed.make_pod_step(o, None, None)
    with pytest.raises(NotImplementedError, match=A13):
        distributed.init_pod_state(o, {}, None)


# ------------------------------------------------------------- the trainer
def test_train_history_matches_jax(monkeypatch):
    """``train()`` of 4 steps in both packages from each one's
    ``init_params(PRNGKey(0))``: the same records, masks and counters
    exact, floats within HIST_RTOL; every decision's margin above MARGIN
    (from step 1 on; step 0 has ssq = 0)."""
    tc = _tc()
    seen = []
    real = opt_censor.transmit_mask

    def recording(dsq, ssq, eps1):
        thr = eps1 * float(ssq)
        seen.extend(abs(float(x) - thr) / thr for x in dsq if thr > 0)
        return real(dsq, ssq, eps1)

    monkeypatch.setattr(opt_censor, "transmit_mask", recording)
    _, tstate, hist = trainer.train(CFG, trainer.TrainConfig(**tc),
                                    verbose=False, device="cpu")
    with jax.enable_x64(False):
        _, jstate, jhist = j_trainer.train(
            J_CFG, j_trainer.TrainConfig(**tc), verbose=False)
    assert len(seen) == 3 * tc["num_workers"] and min(seen) > MARGIN
    assert len(hist) == len(jhist) == 4
    for t, (a, b) in enumerate(zip(hist, jhist)):
        assert set(a) == set(b)
        for key in ("step", "comms", "transmitted"):
            assert a[key] == b[key], (t, key)
        for key in ("loss", "step_sqnorm", "agg_grad_sqnorm",
                    "comm_savings"):
            assert a[key] == pytest.approx(b[key], rel=HIST_RTOL,
                                           abs=1e-7), (t, key)
    assert 0 < hist[-1]["comms"] < 4 * tc["num_workers"]
    np.testing.assert_array_equal(tstate.comm.uplink_count.numpy(),
                                  np.asarray(jstate.comm.uplink_count))


def test_train_config_and_optimizer_match_jax():
    ours, theirs = trainer.TrainConfig(), j_trainer.TrainConfig()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for algo in ("gd", "hb", "lag", "chb"):
        for quantize in (None, "int8"):
            tc = _tc(algorithm=algo, quantize=quantize)
            o = trainer.make_optimizer(trainer.TrainConfig(**tc))
            jo = j_trainer.make_optimizer(j_trainer.TrainConfig(**tc))
            for attr in ("alpha", "beta", "eps1", "quantize", "num_workers"):
                assert getattr(o, attr) == getattr(jo, attr), (algo, attr)


# -------------------------------------------------------------- checkpoint
def test_checkpoints_cross_both_ways_bit_for_bit(tmp_path):
    tp, jp = _weights(seed=6)
    kw = _tc(quantize="int8")
    o = trainer.make_optimizer(trainer.TrainConfig(**kw))
    jo = j_trainer.make_optimizer(j_trainer.TrainConfig(**kw))
    tree = {"params": tp, "state": distributed.init_scan_state(o, tp)}
    jtree = {"params": jp, "state": j_dist.init_scan_state(jo, jp)}
    ours, theirs = str(tmp_path / "ours_step3"), str(tmp_path / "jax_step3")
    meta = {"step": 3, "arch": CFG.name}
    ckpt.save(ours, tree, metadata=meta)
    j_ckpt.save(theirs, jtree, metadata=meta)
    with np.load(ours + ".npz") as a, np.load(theirs + ".npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert "['params']['blocks']['l0']['mixer']['wq']" in a.files
        assert "['state'].comm.uplink_count" in a.files
        for key in a.files:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    assert ckpt.load_metadata(theirs) == j_ckpt.load_metadata(ours) == meta
    back = ckpt.restore(theirs, tree)
    for (k1, a), (k2, b) in zip(ckpt.keyed_leaves(back).items(),
                                ckpt.keyed_leaves(tree).items()):
        assert k1 == k2 and a.dtype == b.dtype and np.array_equal(a, b)
    assert isinstance(back["state"], distributed.DistFedState)
    assert back["state"].step.dtype == torch.int32
    jback = j_ckpt.restore(ours, jtree)
    for a, b in zip(jax.tree_util.tree_leaves(jback),
                    jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(ours, {"params": {"embed": torch.zeros(3)}})


def test_train_writes_checkpoints_every_ckpt_every_steps(tmp_path):
    tc = trainer.TrainConfig(**_tc(steps=5, ckpt_every=2, seq_len=8,
                                   num_workers=2, global_batch=4,
                                   ckpt_path=str(tmp_path / "run")))
    params, _, _ = trainer.train(CFG, tc, verbose=False, device="cpu")
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "run_step2.meta.json", "run_step2.npz", "run_step4.meta.json",
        "run_step4.npz"]
    assert json.loads((tmp_path / "run_step4.meta.json").read_text()) == {
        "step": 4, "arch": CFG.name}
    # the checkpoint of step 4 holds the params after that step's update
    back = ckpt.restore(str(tmp_path / "run_step4"), {"params": params})
    assert back["params"]["embed"].shape == params["embed"].shape
    jback = j_ckpt.restore(str(tmp_path / "run_step4"),
                           {"params": jax.tree_util.tree_map(
                               lambda x: jnp.zeros(x.shape, jnp.float32),
                               convert.to_numpy(params))})
    assert jback["params"]["embed"].shape == tuple(params["embed"].shape)


# -------------------------------------------------------------------- CLI
def test_cli_trains_on_the_cpu(capsys, tmp_path, monkeypatch):
    """The CLI on the CPU: a log line a logged step, the history, the
    checkpoints of ``--ckpt-every`` (at TrainConfig's relative
    ``checkpoints/run``); int8 on the reference backend too."""
    monkeypatch.chdir(tmp_path)
    argv = ["--reduced", "--device", "cpu", "--steps", "3",
            "--global-batch", "4", "--seq-len", "8", "--num-workers", "2",
            "--eps1-scale", "4.0", "--seed", "1"]
    _, state, hist = launch_train.main(argv + ["--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert re.search(r"step +0 loss=\d+\.\d+ tx=2/2 comms=2", out)
    assert [h["step"] for h in hist] == [0, 2]
    assert int(state.step) == 3
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == [
        "run_step2.meta.json", "run_step2.npz"]
    _, state8, hist8 = launch_train.main(
        argv + ["--quantize", "int8", "--backend", "reference"])
    assert len(hist8) == 2 and state8.err != ()


@pytest.mark.parametrize("flags", [["--strategy", "pod"], ["--use-mesh"],
                                   ["--pods", "2"]])
def test_cli_refuses_meshes_naming_the_roadmap(flags):
    with pytest.raises(NotImplementedError, match=A13):
        launch_train.main(["--reduced", "--device", "cpu"] + flags)


# ------------------------------------------------------ what is not ported
def test_what_is_not_ported_raises_naming_the_roadmap():
    tc = trainer.TrainConfig(**_tc(steps=1))
    with pytest.raises(NotImplementedError, match=A13):
        trainer.train(CFG, dataclasses.replace(tc, strategy="pod"),
                      device="cpu")
    with pytest.raises(NotImplementedError, match=A13):
        trainer.train(CFG, tc, mesh=object(), device="cpu")
    tp, _ = _weights()
    tb = next(lm_data.batch_iterator(CFG, global_batch=2, seq_len=8,
                                     device="cpu"))
    with pytest.raises(NotImplementedError, match=A13):
        model.train_loss(tp, CFG, tb, remat="dots", backend="reference")
    with pytest.raises(NotImplementedError, match=A13):
        next(lm_data.batch_iterator(CFG, global_batch=2, seq_len=4,
                                    mesh=object(), device="cpu"))
    with pytest.raises(NotImplementedError, match=A13):
        model.forward(tp, CFG, tb["tokens"], act_spec=object())
    moe = get("mixtral-8x22b").reduced()
    with pytest.raises(NotImplementedError, match=A13):
        model.forward(tp, moe, tb["tokens"])


def test_training_entry_points_default_to_cuda(monkeypatch):
    """``device=None`` means the card: without one the entry points raise
    rather than train on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer.train(CFG, trainer.TrainConfig(**_tc(steps=1)),
                      verbose=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(lm_data.batch_iterator(CFG, global_batch=2, seq_len=4))
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--reduced", "--steps", "1"])


# ------------------------------------------------- the kernels past dispatch
@pytest.fixture
def on_card(monkeypatch):
    """B14 and the backward past the dispatch rule as on a card: meta
    tensors count as on the card, and each ``launch`` is recorded."""
    calls = []

    def record(lib, fn, dev, *args):
        calls.append((lib, fn, args))

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


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_lse_and_backward_launchers_match_their_c_definitions(on_card):
    """B14 takes a null lse pointer from serving and a buffer from
    training, through one launcher; the backward is one launch of one
    launcher; both bound with their C arity; one count a launch."""
    q, k = _meta(2, 4, 40, 64), _meta(2, 2, 40, 64)
    out, lse = kflash.flash_attention(q, k, k, return_lse=True)
    assert lse.shape == (2, 4, 40) and lse.dtype == torch.float32
    kflash.flash_attention(q, k, k)
    dq, dk, dv = kbwd.flash_attention_bwd(q, k, k, out, lse, q,
                                          causal=True, window=16)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
    assert [c[:2] for c in on_card] == [
        ("flash_attention", "flash_attention_f32"),
        ("flash_attention", "flash_attention_f32"),
        ("flash_backward", "flash_attention_bwd_f32")]
    assert on_card[0][2][4] is not None and on_card[1][2][4] is None
    for lib, fn, args in on_card:
        assert len(build.SIGNATURES[lib][fn]) == len(args) + 2 \
            == _c_arity(lib, fn)
    assert "flash_backward" in build.SOURCES
    assert "flash_attention_bwd" in common.KERNELS
    assert {k: c for k, c in common.LAUNCHES.items() if c} == {
        "flash_attention": 2, "flash_attention_bwd": 1}


def test_backward_refuses_bf16_naming_the_roadmap(on_card):
    """bf16 operands launch the bf16 build (``flash_attention_bwd_bf16``,
    bf16 dq, dk and dv); f16 raises ``TypeError`` naming ROADMAP queue B,
    a wrong lse shape ``ValueError``, both before any launch. (The name is
    the one this test had while the backward refused bf16; it is kept so
    that the test's record runs on.)"""
    q = _meta(1, 2, 8, 16, dtype=torch.bfloat16)
    lse = _meta(1, 2, 8)
    half = _meta(1, 2, 8, 16, dtype=torch.float16)
    with pytest.raises(TypeError, match="ROADMAP queue B"):
        kbwd.flash_attention_bwd(half, half, half, half, lse, half)
    with pytest.raises(ValueError, match="lse"):
        kbwd.flash_attention_bwd(q, q, q, q, _meta(1, 2, 9), q)
    assert on_card == []
    kflash.flash_attention(q, q, q)          # bf16 prefill is ported
    kflash.flash_attention(q, q, q, return_lse=True)
    grads = kbwd.flash_attention_bwd(q, q, q, q, lse, q)
    assert all(g.dtype == torch.bfloat16 for g in grads)
    assert [c[1] for c in on_card] == ["flash_attention_bf16"] * 2 + [
        "flash_attention_bwd_bf16"]


def test_model_routes_training_through_the_gradient_path(on_card):
    """The training forward runs ``models.flash`` (B14 with its
    log-sum-exp), prefill the forward alone (a null lse pointer)."""
    lp = model.init_params(PRNGKey(0, device="cpu"), CFG,
                           device="meta")["blocks"]["l0"]["mixer"]
    lp = {k: v[0] for k, v in lp.items()}
    x = _meta(2, 8, CFG.d_model)
    pos = torch.arange(8, dtype=torch.int32, device="meta")
    layers.attention(lp, CFG, x, pos)
    layers.attention(lp, CFG, x, pos, train=True)
    assert [c[2][4] is None for c in on_card] == [True, False]
