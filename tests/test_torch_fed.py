"""The slice as a whole: the port's event-driven edge runtime
(``repro_torch.fed.run_edge``).

  * The sync anchor: on the paper's linreg (m=5, n_per=30, d=20, 60
    rounds, f64) ``run_edge(sync_config(5))`` equals the port's
    ``simulator.run`` bit for bit (objective, ``comm_cum``, masks, theta)
    for gd, hb, lag, chb, csgd and chb with the int8, top-k (k=8) and
    low-rank (rank 2) transports, on both backends (``cuda`` over CPU
    tensors runs the kernels' plain versions), and on the paper's
    nonconvex NN task.
  * Deployment scenarios against the JAX package's ``run_edge``: masks,
    ``comm_cum``, ``bytes_cum``, ``wall_clock``, ``energy_cum`` and
    ``stats.as_dict()`` exactly (the host draws are the same numpy draws
    in the same order, so one flipped censor decision would show in all
    of them); objective and theta within rel 1e-9 (torch's and XLA's
    matmuls reduce in other orders). Every eq.-(8) decision of these runs
    clears its threshold by more than the f32 noise of the two norms.
  * Aliasing: a straggler whose upload lands two and more server updates
    late computes against the theta it was dispatched with.
  * JAX's rejections.
"""
import dataclasses
import sys
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the repository root's script)
from repro import fed as j_fed
from repro import opt as j_opt
from repro.core import simulator as j_simulator
from repro.data import paper_tasks as j_paper
from repro_torch import convert, fed, obs, opt
from repro_torch.core import simulator
from repro_torch.data import paper_tasks
from repro_torch.kernels import ops as kernel_ops
from repro_torch.tree import tree_leaves, tree_map

M = 5
ROUNDS = 60
CASES = [("gd", {}), ("hb", {}), ("lag", {}), ("chb", {}),
         ("csgd", {"tau0": 0.05}),
         ("chb", {"quantize": "int8"}),
         ("chb", {"transport": "topk", "k": 8}),
         ("chb", {"transport": "lowrank", "rank": 2})]
IDS = ["gd", "hb", "lag", "chb", "csgd", "chb-int8", "chb-topk",
       "chb-lowrank"]


@pytest.fixture(scope="module")
def linreg():
    return paper_tasks.make_linear_regression(m=M, n_per=30, d=20, seed=0,
                                              device="cpu")


def _assert_anchor(hist, ref):
    np.testing.assert_array_equal(hist.objective, ref.objective.numpy())
    np.testing.assert_array_equal(hist.comm_cum, ref.comm_cum.numpy())
    np.testing.assert_array_equal(hist.mask,
                                  ref.mask.numpy().astype(np.int8))
    np.testing.assert_array_equal(hist.agg_grad_sqnorm,
                                  ref.agg_grad_sqnorm.numpy())
    for a, b in zip(tree_leaves(hist.final_params),
                    tree_leaves(ref.final_params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(hist.final_bank),
                    tree_leaves(ref.final_state.ghat)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("algo,kw", CASES, ids=IDS)
def test_sync_anchor(linreg, algo, kw, backend):
    o = opt.make(algo, linreg.alpha_paper, M, backend=backend, **kw)
    ref = simulator.run(o, linreg.task, ROUNDS, device="cpu")
    hist = fed.run_edge(o, linreg.task, fed.sync_config(M), ROUNDS,
                        device="cpu")
    _assert_anchor(hist, ref)
    assert 0 < hist.comm_cum[-1]
    if algo in ("lag", "chb", "csgd"):
        assert hist.comm_cum[-1] < M * ROUNDS     # the censor censored


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_sync_anchor_nn_task(backend):
    b = paper_tasks.make_neural_network(m=4, n_per=40, d=8, hidden=6,
                                        device="cpu")
    o = opt.make("chb", 0.02, 4, backend=backend)
    ref = simulator.run(o, b.task, 25, device="cpu")
    hist = fed.run_edge(o, b.task, fed.sync_config(4), 25, device="cpu")
    _assert_anchor(hist, ref)


@pytest.mark.parametrize("transport,kw", [
    ("dense", {}), ("int8", {}), ("topk", {"k": 5}), ("lowrank", {"rank": 2})])
def test_row_entries_equal_the_batched_slice(transport, kw):
    """Each transport's row entries, and the row norm, give the batched
    entries' worker slice at mask 1, bit for bit."""
    rng = np.random.default_rng(4)
    m = 4
    params = {"w": torch.zeros((6, 3), dtype=torch.float64),
              "b": torch.zeros((5,), dtype=torch.float64)}
    t = opt.make_transport(transport, **kw)
    err = t.init(params, m)
    delta = {k: torch.tensor(rng.standard_normal((m,) + tuple(v.shape)))
             for k, v in params.items()}
    if t.stateful:      # a live EF bank (and, for low-rank, live factors)
        err = _random_like(err, rng)
    pending = t.prepare(delta, err)
    payload, aux = t.encode(pending, err)
    ones = torch.ones((m,), dtype=torch.float32)
    new_err = t.feedback(ones, pending, payload, aux, err)
    dsq = kernel_ops.tree_sqnorms(pending)
    for i in range(m):
        row = lambda tree: tree_map(lambda x: x[i].clone(), tree)
        err_i = row(err) if t.stateful else ()
        p_i = t.prepare_row(row(delta), err_i)
        q_i, aux_i = t.encode_row(p_i, err_i)
        e_i = t.feedback_row(p_i, q_i, aux_i, err_i)
        for a, b in zip(tree_leaves([p_i, q_i]), tree_leaves(
                [row(pending), row(payload)])):
            assert torch.equal(a, b)
        if t.stateful:
            for a, b in zip(tree_leaves(e_i), tree_leaves(row(new_err))):
                assert torch.equal(a, b)
        assert torch.equal(kernel_ops.tree_sqnorm_row(p_i), dsq[i])


def _random_like(err, rng):
    """A transport state of random values of the same structure."""
    return tree_map(lambda x: torch.tensor(rng.standard_normal(
        tuple(x.shape))).to(x.dtype), err)


# ------------------------------------------------- against the JAX runtime
def _populations(pkg, m):
    """Scenario name -> (population, channel, energy, quorum, seed)."""
    return {
        # examples/edge_deployment.py
        "deployment": (pkg.straggler_population(
            m, compute_mean_s=1.0, straggler_frac=0.22,
            straggler_slowdown=12.0, jitter="exp", availability="bernoulli",
            avail_p=0.8, seed=0),
            pkg.ChannelConfig.lossy(0.15, uplink_rate_bps=1e6),
            pkg.EnergyModel(uplink_j_per_byte=5e-6, uplink_j_per_tx=1e-3),
            8.0 / 9.0, 0),
        "fading": (pkg.uniform_population(m, jitter="lognormal"),
                   pkg.ChannelConfig.fading(uplink_rate_bps=1e6,
                                            fading_floor=0.1, loss_prob=0.1),
                   pkg.EnergyModel(), 1.0, 3),
        "intermittent": (pkg.intermittent_population(m, avail_p=0.5),
                         pkg.ChannelConfig(), pkg.EnergyModel(), 0.6, 2),
        "partial": (pkg.uniform_population(m, participation=0.4,
                                           jitter="exp"),
                    pkg.ChannelConfig(overhead_s=0.01), pkg.EnergyModel(),
                    1.0, 1),
        # one client 25x slower than the rest: its uploads land several
        # server updates late
        "straggler": (pkg.straggler_population(
            m, compute_mean_s=1.0, straggler_frac=0.2,
            straggler_slowdown=25.0, jitter="fixed", seed=0),
            pkg.ChannelConfig(), pkg.EnergyModel(), 0.8, 0),
    }


def _edge(pkg, name, m):
    pop, ch, en, q, seed = _populations(pkg, m)[name]
    return pkg.EdgeConfig(population=pop, channel=ch, energy=en, quorum=q,
                          seed=seed)


SCENARIOS = [
    ("deployment", "chb", {}, 9),
    ("deployment", "hb", {}, 9),
    ("fading", "chb", {"quantize": "int8"}, 5),
    ("intermittent", "csgd", {"tau0": 0.05}, 5),
    ("partial", "lag", {}, 5),
    ("straggler", "chb", {"transport": "topk", "k": 8}, 5),
]


def _jax_task(m):
    if m == 9:                 # the example's paper Fig. 2 setting
        return j_paper.make_linear_regression()
    return j_paper.make_linear_regression(m=m, n_per=30, d=20, seed=0)


def _port_task(m):
    if m == 9:
        return paper_tasks.make_linear_regression(device="cpu")
    return paper_tasks.make_linear_regression(m=m, n_per=30, d=20, seed=0,
                                              device="cpu")


@pytest.fixture(scope="module")
def jax_scenarios():
    out = {}
    for name, algo, kw, m in SCENARIOS:
        b = _jax_task(m)
        o = j_opt.make(algo, b.alpha_paper, m, **kw)
        out[name, algo] = convert.edge_history(j_fed.run_edge(
            o, b.task, _edge(j_fed, name, m), ROUNDS,
            collect_metrics=True))
    return out


@pytest.mark.parametrize("name,algo,kw,m", SCENARIOS,
                         ids=[f"{s[0]}-{s[1]}" for s in SCENARIOS])
def test_scenario_matches_jax(jax_scenarios, name, algo, kw, m):
    want = jax_scenarios[name, algo]
    b = _port_task(m)
    o = opt.make(algo, b.alpha_paper, m, **kw)
    hist = fed.run_edge(o, b.task, _edge(fed, name, m), ROUNDS,
                        collect_metrics=True, device="cpu")
    got = convert.edge_history(hist)
    for f in ("mask", "comm_cum", "bytes_cum", "wall_clock", "energy_cum"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert got["stats"] == want["stats"]
    np.testing.assert_allclose(got["objective"], want["objective"],
                               rtol=1e-9)
    np.testing.assert_allclose(got["final_params"], want["final_params"],
                               rtol=1e-9, atol=1e-12)
    assert 0 < got["comm_cum"][-1]
    if name == "straggler":
        # the straggler's uploads fold two and more rounds late, and the
        # stale folds are counted
        late = hist.metrics["staleness/h2_3"] + hist.metrics["staleness/h4p"]
        assert late.sum() > 0 and got["stats"]["stale_folds"] > 0


def test_scenario_on_both_backends():
    """A deployment gives the same bits on ``cuda`` (the kernels' plain
    versions on CPU tensors) as on ``reference``."""
    b = _port_task(M)
    hists = [convert.edge_history(fed.run_edge(
        opt.make("chb", b.alpha_paper, M, backend=backend), b.task,
        _edge(fed, "straggler", M), ROUNDS, device="cpu"))
        for backend in ("reference", "cuda")]
    for f in ("mask", "comm_cum", "bytes_cum", "wall_clock", "energy_cum",
              "objective", "final_params"):
        np.testing.assert_array_equal(hists[0][f], hists[1][f], err_msg=f)


def test_straggler_computes_against_its_dispatch_theta(linreg):
    """Aliasing: the theta a busy client holds is the theta it was sent.

    The straggler is dispatched at round 0 and its upload lands after
    several server updates. Its delta must be ``g(theta^0) - ghat``: had a
    later update written into theta^0 in place, the folded delta would
    be a later theta's gradient.
    """
    pop = fed.straggler_population(M, straggler_frac=0.2,
                                   straggler_slowdown=25.0, jitter="fixed",
                                   seed=0)
    slow = int(np.argmax([p.compute_mean_s for p in pop.profiles]))
    edge = fed.EdgeConfig(population=pop, channel=fed.ChannelConfig(),
                          quorum=0.8, seed=0)
    o = opt.make("gd", linreg.alpha_paper, M)
    theta0 = linreg.task.init_params.clone()
    hist = fed.run_edge(o, linreg.task, edge, 30, device="cpu")
    first = int(np.argmax(hist.mask[:, slow]))
    assert first >= 2                  # two server updates went by
    g0 = linreg.task.grad_fn(theta0, tuple(
        t[slow:slow + 1] for t in linreg.task.worker_data))[0]
    # the straggler's bank row after its first fold is g(theta^0) exactly
    # (gd transmits every delta; nothing else writes the row); rerun to
    # the round of that fold and read the bank
    at_fold = fed.run_edge(o, linreg.task, edge, first + 1, device="cpu")
    np.testing.assert_array_equal(at_fold.mask, hist.mask[:first + 1])
    assert torch.equal(at_fold.final_bank[slow], g0)


def test_edge_metrics_to_accuracy(linreg):
    o = opt.make("chb", linreg.alpha_paper, M)
    hist = fed.run_edge(o, linreg.task, fed.sync_config(M), 200,
                        device="cpu")
    fstar = float(simulator.estimate_fstar(linreg.task, linreg.alpha_paper,
                                           3000, device="cpu"))
    for tol in (1e-2, 1e-6, -1.0):
        assert fed.edge_metrics_to_accuracy(hist, fstar, tol) == \
            j_fed.edge_metrics_to_accuracy(hist, fstar, tol)
    assert fed.edge_metrics_to_accuracy(hist, fstar, -1.0)["rounds"] == -1
    assert fed.quorum_need(8 / 9, 9) == j_fed.quorum_need(8 / 9, 9) == 8


def test_rejections(linreg):
    edge = fed.sync_config(M)
    with pytest.raises(NotImplementedError):
        fed.run_edge(opt.make("chb", 0.1, M, granularity="per_tensor"),
                     linreg.task, edge, 2, device="cpu")
    with pytest.raises(NotImplementedError):
        fed.run_edge(dataclasses.replace(opt.make("chb", 0.1, M),
                                         censor=opt.AdaptiveCensor(0.5)),
                     linreg.task, edge, 2, device="cpu")
    with pytest.raises(ValueError):
        fed.run_edge(opt.make("chb", 0.1, M + 1), linreg.task, edge, 2,
                     device="cpu")
    # a runlog is taken since repro_torch.obs: one event a round
    log = obs.RunLog(run="edge")
    fed.run_edge(opt.make("chb", 0.1, M), linreg.task, edge, 2,
                 runlog=log, device="cpu")
    assert len(log.lines) == 2
    with pytest.raises(TypeError):
        fed.run_edge(object(), linreg.task, edge, 2, device="cpu")
    with pytest.raises(ValueError):
        fed.EdgeConfig(population=fed.uniform_population(M), quorum=0.0)
    with pytest.raises(ValueError):
        fed.uniform_population(M, participation=1.5)


class _Recorder:
    """An optimizer that records each step's censor state and norms."""

    def __init__(self, o):
        self.o, self.rows = o, []

    def init(self, params):
        return self.o.init(params)

    def step(self, state, params, grads):
        out = self.o.step(state, params, grads)
        self.rows.append((int(state.censor), out[2].delta_sq.clone()))
        return out


def test_chip_smoke_csgd_pins_are_the_jax_package_s():
    """chip_smoke.py holds csgd on the card to these JAX values (uploads,
    each iteration's mask, objective), and every decision clears its
    threshold by more than CSGD_MIN_MARGIN of it, so no platform's
    rounding of the norms turns one."""
    sent, rows, obj = chip_smoke.GOLDEN_CSGD
    tau0 = chip_smoke.GOLDEN_CSGD_TAU0
    j_b = j_paper.make_linear_regression(m=M, n_per=30, d=20, seed=0)
    j_hist = j_simulator.run(j_opt.make("csgd", j_b.alpha_paper, M,
                                        tau0=tau0), j_b.task, ROUNDS)
    bits = lambda mask: [int(sum(int(v) << w for w, v in enumerate(r)))
                         for r in np.asarray(mask).tolist()]
    assert int(j_hist.comm_cum[-1]) == sent
    assert bits(j_hist.mask) == rows
    assert float(j_hist.objective[-1]) == obj
    p_b = paper_tasks.make_linear_regression(m=M, n_per=30, d=20, seed=0,
                                             device="cpu")
    rec = _Recorder(opt.make("csgd", p_b.alpha_paper, M, tau0=tau0))
    hist = simulator.run(rec, p_b.task, ROUNDS, device="cpu")
    assert bits(hist.mask) == rows
    c = rec.o.censor
    margin = min(float(torch.min(torch.abs(dsq.double() - thr) / thr))
                 for k, dsq in rec.rows
                 for thr in [c._uniform(k, torch.arange(M), "cpu")
                             * c._tau(k).double()])
    assert margin > chip_smoke.CSGD_MIN_MARGIN, margin
