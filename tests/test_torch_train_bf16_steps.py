"""Training the dense bf16 configs: the scan steps, ``train()``, its
checkpoints and the CLI, held against the JAX package on the CPU.

qwen3-4b and gemma3-12b reduced in bf16 (``chip_smoke.bf16_pin_config``,
as in tests/test_torch_train_bf16.py), bf16 params with the bank and the
error feedback in the params' dtype (``init_scan_state``, as the JAX
package's makes them). Three ``make_scan_step`` steps, dense and int8, on
the port's two backends (on the CPU both run plain versions: the cuda
backend's are those of B14, the bf16 flash backward and B1/B2 or B5/B6),
each step from the JAX package's state before it (a state carried across
by its bits, ``convert.dist_state``), against JAX's jitted step.

JAX's scan step promotes a bf16 bank to f32 (``h + send * q`` with an f32
``send``), so after its first step its bank and err are f32; the port
keeps them in the params' dtype. Each JAX step here starts from its state
with the bank and err rounded to bf16, the port's from the same bits; the
outputs compare with JAX's f32 bank and err within half a bf16 ulp more.

Tolerances and why:
  * masks, ``transmitted``, the comm counters and the step: exact, after
    asserting each worker's margin: |dsq - eps1 ssq| above
    ``chip_smoke.dsq_bound`` of the difference e between the packages'
    eq.-(8) deltas (plus SQNORM_RTOL of the threshold, its own f32 sum).
    e is measured: the port's delta bf16(g - ghat) (+ err, bf16 ops)
    against JAX's from a jitted ``jax.grad`` of each worker's loss, plus
    the bf16 rounding of JAX's delta (its jitted step may keep it in f32).
    That gradient is the one inside JAX's scan bit for bit: the fixture
    asserts it on JAX's first step, whose bank is the gradients;
  * ghat', leaf by leaf: within GHAT_ULPS + 1 ulps of the leaf's largest
    |ghat'| (the gradients' bound of tests/test_torch_train_bf16.py,
    GRAD_ULPS_JIT + L, and one rounding of the advance); under int8 plus
    one quantization step of the leaf (max |ghat' - ghat| / 127 of JAX's),
    a code that rounds the other way, and err' likewise;
  * theta', each element within BF16_EQ4_UNITS bf16 unit roundoffs of the
    magnitudes of eq. (4)'s terms (the reference backend rounds each of
    its operations to bf16, JAX and B2's plain version once: Lockstep's
    rule in chip_smoke.py) plus alpha M times the leaf's ghat' bound;
  * the loss: LOSS_RTOL_JIT of the JAX package's; step_sqnorm, from equal
    inputs: 1e-5 relative (f32 sums in other orders); agg_grad_sqnorm:
    AGG_RTOL, the worker sums being within a few bf16 ulps;
  * checkpoints: bit for bit both ways.
"""
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (the repository root's script)
from repro.checkpoint import checkpoint as j_ckpt  # noqa: E402
from repro.configs import get as j_get  # noqa: E402
from repro.core import distributed as j_dist  # noqa: E402
from repro.models import model as j_model  # noqa: E402
from repro.train import trainer as j_trainer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.data import lm_data  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.train import trainer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

GHAT_ULPS = 4            # GRAD_ULPS_JIT of tests/test_torch_train_bf16.py
LOSS_RTOL_JIT = 2.0 ** -9
AGG_RTOL = 2.0 ** -5
STEP_RTOL = 1e-5
ARCHS = ("qwen3-4b", "gemma3-12b")
CFGS = {a: chip_smoke.bf16_pin_config(get, a) for a in ARCHS}
J_CFGS = {a: chip_smoke.bf16_pin_config(j_get, a) for a in ARCHS}
SCAN_STEPS = 3
# (arch, transport): dense and int8 on qwen3-4b, dense on gemma3-12b (its
# window and head dim 256)
SCAN_RUNS = (("qwen3-4b", None), ("qwen3-4b", "int8"), ("gemma3-12b", None))
# eps1_scale by arch: each censors some workers over the three steps, every
# decision clear of its bound
EPS1_SCALE = {"qwen3-4b": 7.0, "gemma3-12b": 5.0}
HISTORY_KEYS = {"loss", "transmitted", "step_sqnorm", "agg_grad_sqnorm",
                "step", "comms", "comm_savings", "wall_s"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the port's CPU work here: in a parallel test
    run a pool of threads in every worker process contends for the same
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tc(**kw):
    base = dict(algorithm="chb", num_workers=4, alpha=0.05, beta=0.4,
                eps1_scale=8.0, global_batch=8, seq_len=32, steps=4,
                log_every=1, remat="none")
    base.update(kw)
    return base


def _jax_batch(tb):
    return {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in tb.items()}


def _tensor(x) -> torch.Tensor:
    """A JAX array as a tensor (a bf16 one by its bits)."""
    return convert.params(np.asarray(x), "cpu")


def ckpt_leaves(tree) -> list:
    """The tensors of a checkpointed tree in its key-path order (a
    ``DistFedState`` is a named tuple, which ``tree_leaves`` keeps whole)."""
    out: list = []
    ckpt._flatten_with_path(tree, "", out)
    return [x for _, x in out]


def _ulp(x: float) -> float:
    return chip_smoke.bf16_ulp(x) if x > 0 else 0.0


# ------------------------------------------------------- the scan strategy
@pytest.fixture(scope="module")
def jax_scan_runs():
    """For each arch and transport: the JAX state after one step (so ssq >
    0), then SCAN_STEPS jitted steps, each with its state before as numpy,
    its batch, the workers' gradients from a jitted ``jax.grad`` and its
    outputs."""
    runs = {}

    def bf16_bank(state):
        return state._replace(**{f: jax.tree_util.tree_map(
            lambda x: x.astype(jnp.bfloat16), getattr(state, f))
            for f in ("ghat", "err")})

    for arch, quantize in SCAN_RUNS:
        cfg = CFGS[arch]
        jp0 = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x).astype(jnp.bfloat16),
            convert.numpy_model_params(cfg, 1))
        it = lm_data.batch_iterator(cfg, global_batch=8, seq_len=32,
                                    num_workers=4, seed=7, device="cpu")
        batches = [next(it) for _ in range(SCAN_STEPS + 1)]

        def jloss(p, b, arch=arch):
            return j_model.train_loss(p, J_CFGS[arch], b, remat="none")[0]

        jgrad = jax.jit(jax.grad(jloss))
        jo = j_trainer.make_optimizer(j_trainer.TrainConfig(
            **_tc(quantize=quantize, eps1_scale=EPS1_SCALE[arch])))
        jstep = jax.jit(j_dist.make_scan_step(jo, jloss))
        jb0 = _jax_batch(batches[0])
        jp, jstate, _ = jstep(jp0, j_dist.init_scan_state(jo, jp0), jb0)
        if quantize is None:
            # from zero banks every worker sends its gradient: the bank is
            # the scan's gradients, the standalone ones bit for bit
            for m in range(jo.num_workers):
                g = jgrad(jp0, {k: v[m] for k, v in jb0.items()})
                for h, gl in zip(jax.tree_util.tree_leaves(jstate.ghat),
                                 jax.tree_util.tree_leaves(g)):
                    np.testing.assert_array_equal(
                        np.asarray(h[m].astype(jnp.float32)),
                        np.asarray(gl.astype(jnp.float32)))
        steps = []
        for tb in batches[1:]:
            jb = _jax_batch(tb)
            jstate = bf16_bank(jstate)
            grads = [jgrad(jp, {k: v[m] for k, v in jb.items()})
                     for m in range(jo.num_workers)]
            before = jax.tree_util.tree_map(np.asarray, (jp, jstate))
            jp, jstate, met = jstep(jp, jstate, jb)
            steps.append((before, tb, grads, jp, jstate, met))
        runs[arch, quantize] = (jo, steps)
    return runs


def _margins(jo, before, grads, port_grads, err):
    """Each worker's (margin, bound) of its eq.-(8) decision (see the
    module's docstring), from JAX's state before the step, JAX's and the
    port's gradients (bf16 tensors, one list of leaves a worker)."""
    jp, jstate = before
    ssq = sum(float(np.sum((np.asarray(a, np.float64)
                            - np.asarray(b, np.float64)) ** 2))
              for a, b in zip(jax.tree_util.tree_leaves(jp),
                              jax.tree_util.tree_leaves(jstate.prev_params)))
    thr = jo.eps1 * ssq
    banks = [_tensor(h) for h in jax.tree_util.tree_leaves(jstate.ghat)]
    errs = [_tensor(e) for e in jax.tree_util.tree_leaves(
        jstate.err)] if err else [None] * len(banks)
    out = []
    for m, gm in enumerate(grads):
        dsq = e_port = e_round = 0.0
        for g_j, g_p, h, e in zip(gm, port_grads[m], banks, errs):
            g_j = _tensor(g_j)
            d_j, d_p = g_j - h[m], g_p - h[m]          # bf16 ops
            d32 = g_j.double() - h[m].double()
            if e is not None:
                d_j, d_p = d_j + e[m], d_p + e[m]
                d32 = d32 + e[m].double()
            dsq += float(torch.sum(d_j.double() ** 2))
            e_port += float(torch.sum((d_p.double() - d_j.double()) ** 2))
            e_round += float(torch.sum((d_j.double() - d32) ** 2))
        e = math.sqrt(e_port) + math.sqrt(e_round)
        out.append((abs(dsq - thr), chip_smoke.dsq_bound(dsq, e)
                    + chip_smoke.SQNORM_RTOL * thr))
    return out


class _GradWatch:
    """Keeps the gradient bank of each port step (per worker, a list of
    leaves), wrapping ``core.distributed._worker_grads``."""

    def __init__(self, monkeypatch):
        self.banks = None
        real = distributed._worker_grads

        def watched(*args):
            loss_sum, grads = real(*args)
            self.banks = [[g[m] for g in grads]
                          for m in range(grads[0].shape[0])]
            return loss_sum, grads

        monkeypatch.setattr(distributed, "_worker_grads", watched)


@pytest.mark.parametrize("backend", ["cuda", "reference"])
@pytest.mark.parametrize("arch,quantize", SCAN_RUNS,
                         ids=[f"{a}-{q or 'dense'}" for a, q in SCAN_RUNS])
def test_three_bf16_scan_steps_match_jax(jax_scan_runs, arch, quantize,
                                         backend, monkeypatch):
    """SCAN_STEPS steps, each from JAX's state before it: theta, the bank,
    the error feedback, prev_params, the counters and the metrics against
    JAX's step; every decision's margin asserted; some workers censored
    and some not over the steps."""
    cfg = CFGS[arch]
    jo, steps = jax_scan_runs[arch, quantize]
    tc = trainer.TrainConfig(**_tc(quantize=quantize,
                                   eps1_scale=EPS1_SCALE[arch]))
    o = trainer.make_optimizer(tc)
    assert o.eps1 == jo.eps1 > 0
    step = distributed.make_scan_step(
        o, lambda p, b: model.train_loss(p, cfg, b, remat="none",
                                         backend=backend)[0],
        backend=backend)
    watch = _GradWatch(monkeypatch)
    ulps = GHAT_ULPS + cfg.num_layers + 1
    sends = []
    for t, (before, tb, grads, jp, jstate, jmet) in enumerate(steps):
        tp = convert.model_params(before[0], cfg, "cpu")
        tstate = convert.dist_state(before[1], "cpu")
        assert all(x.dtype == torch.bfloat16 for x in tree_leaves(
            (tp, tstate.prev_params, tstate.ghat, tstate.err)))
        new_p, new_s, met = step(tp, tstate, tb)
        for margin, bound in _margins(jo, before, [
                jax.tree_util.tree_leaves(g) for g in grads], watch.banks,
                quantize):
            assert margin > bound, (t, margin, bound)
        assert new_s.prev_params is tp
        assert float(met["transmitted"]) == float(jmet["transmitted"])
        sends.append(float(met["transmitted"]))
        for f in new_s.comm._fields:
            np.testing.assert_array_equal(getattr(new_s.comm, f).numpy(),
                                          np.asarray(getattr(jstate.comm, f)))
        assert int(new_s.step) == int(jstate.step)
        assert abs(float(met["loss"]) - float(jmet["loss"])) <= \
            LOSS_RTOL_JIT * abs(float(jmet["loss"]))
        np.testing.assert_allclose(float(met["step_sqnorm"]),
                                   float(jmet["step_sqnorm"]), rtol=STEP_RTOL)
        np.testing.assert_allclose(float(met["agg_grad_sqnorm"]),
                                   float(jmet["agg_grad_sqnorm"]),
                                   rtol=AGG_RTOL)
        leaves = zip(*(tree_leaves(x) for x in (
            new_s.ghat, tp, tstate.prev_params, new_p)),
            *(jax.tree_util.tree_leaves(x) for x in (
                jstate.ghat, before[1].ghat, jp)))
        errs = zip(tree_leaves(new_s.err), jax.tree_util.tree_leaves(
            jstate.err)) if quantize else None
        for h, th, thp, th_new, jh, jh0, jth in leaves:
            jh, jh0, jth = (_tensor(x) for x in (jh, jh0, jth))
            assert h.dtype == th_new.dtype == torch.bfloat16
            bound = ulps * _ulp(float(jh.float().abs().max()))
            if quantize:
                bound += float((jh.float() - jh0.float()).abs().max()) \
                    / 127 * 1.001
            assert float((h.float() - jh.float()).abs().max()) <= bound, t
            if errs is not None:
                e, je = next(errs)
                assert e.dtype == torch.bfloat16
                assert float((e.float() - _tensor(je).float()).abs()
                             .max()) <= bound, t
            th, thp = th.float(), thp.float()
            terms = th.abs() + o.alpha * jh.float().sum(0).abs() \
                + o.beta * (th - thp).abs()
            eq4 = chip_smoke.BF16_EQ4_UNITS * 2.0 ** -8 * terms \
                + o.alpha * o.num_workers * bound
            assert bool(((th_new.float() - jth.float()).abs()
                         <= eq4).all()), t
    assert 0 < sum(sends) < SCAN_STEPS * o.num_workers


# ------------------------------------------------------------- the trainer
def test_train_bf16_history_counters_and_checkpoints(tmp_path):
    """``train()`` of the reduced qwen3-4b in bf16 on the CPU: the JAX
    package's history keys, counters that add up, params and bank in bf16,
    a checkpoint every ``ckpt_every`` steps that restores the params' bits."""
    cfg = CFGS["qwen3-4b"]
    tc = trainer.TrainConfig(**_tc(steps=3, ckpt_every=2, seq_len=16,
                                   quantize="int8",
                                   ckpt_path=str(tmp_path / "run")))
    params, state, hist = trainer.train(cfg, tc, verbose=False,
                                        device="cpu")
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(set(h) == HISTORY_KEYS for h in hist)
    assert all(math.isfinite(h["loss"]) for h in hist)
    assert hist[-1]["comms"] == int(state.comm.total_uplinks) \
        == sum(h["transmitted"] for h in hist)
    assert int(state.step) == 3
    for tree in (params, state.prev_params, state.ghat, state.err):
        assert all(x.dtype == torch.bfloat16 for x in tree_leaves(tree))
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "run_step2.meta.json", "run_step2.npz"]
    back = ckpt.restore(str(tmp_path / "run_step2"), {"params": params})
    assert all(x.dtype == torch.bfloat16
               for x in tree_leaves(back["params"]))
    assert ckpt.load_metadata(str(tmp_path / "run_step2")) == {
        "step": 2, "arch": cfg.name}


def test_bf16_training_state_checkpoints_cross_both_ways(tmp_path):
    """A bf16 training state after two int8 steps (params, prev_params, the
    bank and err): the port's checkpoint restores into the port and into
    the JAX package bit for bit, and the JAX package's back into the port."""
    cfg = CFGS["gemma3-12b"]
    tc = trainer.TrainConfig(**_tc(steps=2, seq_len=16, quantize="int8"))
    params, state, _ = trainer.train(cfg, tc, verbose=False, device="cpu")
    tree = {"params": params, "state": state}
    ours = str(tmp_path / "ours")
    ckpt.save(ours, tree, metadata={"step": 2})
    back = ckpt.restore(ours, tree)
    for (k1, a), (k2, b) in zip(ckpt.keyed_leaves(back).items(),
                                ckpt.keyed_leaves(tree).items()):
        assert k1 == k2 and a.dtype == b.dtype and np.array_equal(a, b)
    bits = [x.view(torch.int16) for x in ckpt_leaves(tree)
            if x.dtype == torch.bfloat16]
    back_bits = [x.view(torch.int16) for x in ckpt_leaves(back)
                 if x.dtype == torch.bfloat16]
    assert len(bits) == len(back_bits) > 0
    assert all(torch.equal(a, b) for a, b in zip(bits, back_bits))
    jo = j_trainer.make_optimizer(j_trainer.TrainConfig(
        **_tc(quantize="int8")))
    jp = jax.tree_util.tree_map(
        lambda t: jnp.zeros(tuple(t.shape), jnp.bfloat16), params)
    jlike = {"params": jp, "state": j_dist.init_scan_state(jo, jp)}
    jback = j_ckpt.restore(ours, jlike)
    for a, b in zip(jax.tree_util.tree_leaves(jback), ckpt_leaves(tree)):
        assert a.dtype == (jnp.bfloat16 if b.dtype == torch.bfloat16
                           else a.dtype)
        got = np.asarray(jnp.asarray(a).astype(jnp.float32)) \
            if a.dtype == jnp.bfloat16 else np.asarray(a)
        want = b.float().numpy() if b.dtype == torch.bfloat16 else b.numpy()
        np.testing.assert_array_equal(got, want)
    theirs = str(tmp_path / "theirs")
    j_ckpt.save(theirs, jback)
    again = ckpt.restore(theirs, tree)
    assert all(torch.equal(a.view(torch.int16), b.view(torch.int16))
               if a.dtype == torch.bfloat16 else torch.equal(a, b)
               for a, b in zip(ckpt_leaves(again), ckpt_leaves(tree)))
    assert isinstance(again["state"], distributed.DistFedState)


# -------------------------------------------------------------------- CLI
def test_cli_trains_a_bf16_config_on_the_cpu(capsys, monkeypatch):
    """The CLI with a bf16 ``--arch`` (its config swapped for the reduced
    bf16 gemma3-12b, two layers "SA", so that it fits the CPU): params,
    bank and err in bf16, dense and int8, both backends."""
    monkeypatch.setattr(launch_train, "get",
                        lambda arch: dataclasses.replace(
                            CFGS[arch], num_layers=2, layer_pattern="SA",
                            scan_period=2).validate())
    argv = ["--arch", "gemma3-12b", "--device", "cpu",
            "--steps", "2", "--global-batch", "4", "--seq-len", "16",
            "--num-workers", "2", "--eps1-scale", "4.0"]
    for extra in ([], ["--quantize", "int8", "--backend", "reference"]):
        params, state, hist = launch_train.main(argv + extra)
        assert len(hist) == 2 and int(state.step) == 2
        assert params["blocks"]["l0"]["mixer"]["wq"].shape[0] == 1
        assert all(x.dtype == torch.bfloat16 for x in tree_leaves(
            (params, state.ghat, state.err)))
    assert "step     0 loss=" in capsys.readouterr().out


def test_cli_module_exits_zero():
    """``python -m repro_torch.launch.train --arch qwen3-4b --reduced
    --device cpu --steps 2`` as a process: exit 0, a loss line a step."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-4b", "--reduced", "--device", "cpu", "--steps", "2"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO / "src"),
                       "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert sum(ln.startswith("step") for ln in proc.stdout.splitlines()) \
        == 2


def test_launcher_cuts_keep_the_published_widths():
    """A depth cut keeps every width (qwen3-4b at phase train_bf16's 16
    layers)."""
    cfg = dataclasses.replace(get("qwen3-4b"), num_layers=16).validate()
    assert (cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.vocab_size) == (
        2560, 32, 128, 151936)
    assert model.param_count(cfg) == chip_smoke.TRAIN_BF16["qwen3-4b"][
        "runs"]["chb"]["params"]
