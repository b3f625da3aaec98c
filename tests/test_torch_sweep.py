"""The sweep engine of the port (``repro_torch.sweep``) against its own
``simulator.run`` and against the JAX package's ``repro.sweep``.

Setting: the paper's linreg (m=5, n_per=30, d=20), 40-80 iterations, as
``tests/test_sweep.py``. Tolerances and why:
  * every sweep point equals the port's ``simulator.run`` of the same
    optimizer bit for bit, at f32 and f64 and on both backends (``cuda``
    over CPU tensors runs the kernels' plain versions): the engine builds
    each point from host floats as a user would and runs the same code;
  * against JAX's ``run_sweep`` at f64 (60 iterations): masks,
    ``comm_cum`` and uplink bytes exact; objective and final theta within
    rtol 1e-9, atol 1e-12 (torch's and XLA's matmuls reduce in other
    orders). Past 60 iterations the masks stop being comparable: this
    grid's lag int8 point reaches deltas of about 1e-11 at iteration 70,
    where the two packages' f32 delta norms differ by 5-30% (the gradients'
    own rounding), and at iteration 76 one decision follows each package's
    noise; theta still agrees within 1e-12 there;
  * ``run_fed_sweep``: participation, transmit, delivered and the quorum
    records exact against JAX's at f64 (the same PRNG draws, compared in
    f64), objective within rtol 1e-9; the ideal scenario equals the port's
    ``simulator.run`` bit for bit.
"""
import dataclasses
import json

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest
import torch

from repro import opt as j_opt
from repro import sweep as j_sweep
from repro.data import paper_tasks as j_paper
from repro_torch import opt, sweep
from repro_torch.core import simulator
from repro_torch.core.censoring import paper_eps1
from repro_torch.data import paper_tasks
from repro_torch.launch.mesh import make_client_mesh
from repro_torch.obs import compile_log
from repro_torch.tree import tree_leaves

M = 5


def _task(seed, m=M):
    return paper_tasks.make_linear_regression(
        m=m, n_per=30, d=20, seed=seed, device="cpu").task


def _j_task(seed, m=M):
    return j_paper.make_linear_regression(m=m, n_per=30, d=20,
                                          seed=seed).task


@pytest.fixture(scope="module")
def linreg():
    return paper_tasks.make_linear_regression(m=M, n_per=30, d=20, seed=0,
                                              device="cpu")


def _assert_same_run(h, ref):
    """Bitwise: objective, comm_cum, masks, agg sqnorm, theta, bank, bytes."""
    for f in ("objective", "comm_cum", "mask", "agg_grad_sqnorm"):
        assert torch.equal(getattr(h, f), getattr(ref, f)), f
    for a, b in zip(tree_leaves([h.final_params, h.final_state.ghat,
                                 h.final_state.err]),
                    tree_leaves([ref.final_params, ref.final_state.ghat,
                                 ref.final_state.err])):
        assert torch.equal(a, b)
    assert h.final_state.comm.uplink_bytes_exact() == \
        ref.final_state.comm.uplink_bytes_exact()


# ------------------------------------------------------------------- grid
GRIDS = [
    dict(alpha=(0.1, 0.2), beta=(0.0, 0.4), eps1=(0.0, 1.0), seed=(0, 1)),
    dict(alpha=(0.1,), eps1_scale=(0.01, 0.5, 1.0), quantize=(None, "int8"),
         num_workers=(None, 3)),
    dict(alpha=(0.05,), beta=(0.4,), quantize=("topk", "lowrank")),
]


@pytest.mark.parametrize("kw", GRIDS, ids=["abes", "scale-q-m", "zoo"])
def test_grid_points_equal_jax(kw):
    g, jg = sweep.ConfigGrid(**kw), j_sweep.ConfigGrid(**kw)
    assert g.num_points == jg.num_points
    pts, jpts = g.points(default_num_workers=4), jg.points(4)
    assert [tuple(p) for p in pts] == [tuple(p) for p in jpts]
    assert [p.algo_name for p in pts] == [p.algo_name for p in jpts]


def test_grid_validation_errors():
    g = sweep.ConfigGrid(alpha=(0.1,), eps1_scale=(0.5,))
    (p,) = g.points(default_num_workers=4)
    assert p.eps1 == paper_eps1(0.1, 4, 0.5)
    with pytest.raises(ValueError, match="num_workers"):
        g.points()
    with pytest.raises(ValueError, match="not both"):
        sweep.ConfigGrid(alpha=(0.1,), eps1=(1.0,), eps1_scale=(0.5,))
    with pytest.raises(ValueError, match="int4"):
        sweep.ConfigGrid(alpha=(0.1,), quantize=("int4",))
    with pytest.raises(ValueError, match="alpha"):
        sweep.ConfigGrid(alpha=())


# -------------------------------------------------- sweep == simulator.run
def _continuum(a):
    eps = paper_eps1(a, M)
    return [sweep.GridPoint(alpha=a, beta=0.4, eps1=eps),
            sweep.GridPoint(alpha=a / 2, beta=0.0, eps1=eps),
            sweep.GridPoint(alpha=a, beta=0.4, eps1=0.0),
            sweep.GridPoint(alpha=a, beta=0.4, eps1=eps, quantize="int8"),
            sweep.GridPoint(alpha=a / 2, beta=0.0, eps1=0.0,
                            quantize="int8")]


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_continuum_points_equal_run(linreg, dtype, backend):
    """Dense and int8 points (two partitions) against ``simulator.run`` of
    the optimizer each point describes, built by hand."""
    task = simulator.task_to(linreg.task, dtype=dtype)
    base = opt.make("chb", linreg.alpha_paper, M, backend=backend)
    pts = _continuum(linreg.alpha_paper)
    res = sweep.run_sweep(pts, task, num_iters=60, base_cfg=base,
                          device="cpu")
    assert res.num_programs == 2
    for p, h in zip(pts, res.histories):
        o = opt.ComposedOptimizer(
            censor=opt.Eq8Censor(p.eps1),
            transport=opt.make_transport(p.quantize),
            server=opt.HeavyBall(p.alpha, p.beta), num_workers=M,
            backend=backend)
        _assert_same_run(h, simulator.run(o, task, 60, device="cpu"))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_per_tensor_points_equal_run(dtype):
    """``per_tensor`` makes eps1 a partition axis (host-scalar eps1); a
    two-leaf task so the per-leaf test differs from the global one."""
    b = paper_tasks.make_neural_network(m=4, n_per=40, d=8, hidden=6,
                                        device="cpu", dtype=dtype)
    base = opt.make("chb", 0.02, 4, granularity="per_tensor")
    eps = paper_eps1(0.02, 4)
    pts = [sweep.GridPoint(alpha=0.02, beta=0.4, eps1=eps),
           sweep.GridPoint(alpha=0.02, beta=0.4, eps1=2 * eps),
           sweep.GridPoint(alpha=0.01, beta=0.4, eps1=eps)]
    res = sweep.run_sweep(pts, b.task, num_iters=40, base_cfg=base,
                          device="cpu")
    assert res.num_programs == 2
    for p, h in zip(pts, res.histories):
        o = opt.make("chb", p.alpha, 4, beta=p.beta, eps1=p.eps1,
                     granularity="per_tensor")
        _assert_same_run(h, simulator.run(o, b.task, 40, device="cpu"))


def test_seed_axis_with_factory_equals_run():
    grid = sweep.ConfigGrid(alpha=(0.01,), beta=(0.4,),
                            eps1_scale=(0.1, 1.0), seed=(0, 1),
                            num_workers=(M,))
    with compile_log.track() as log:
        res = sweep.run_sweep(grid, task_factory=_task, num_iters=60,
                              device="cpu")
    assert len(res) == 4 and res.num_programs == 2
    assert log.counts["sweep/partition"] == 2
    assert log.counts["simulator/trajectory"] == 4
    for p, h in zip(res.points, res.histories):
        o = opt.make("chb", p.alpha, M, beta=p.beta, eps1=p.eps1)
        _assert_same_run(h, simulator.run(o, _task(p.seed), 60,
                                          device="cpu"))


def test_named_points_equal_registered_algorithms(linreg):
    """Named points run the registry's builders with their defaults for
    the axes they leave at 0.0; each (algo, axes) is its own partition."""
    a = linreg.alpha_paper
    pts = [sweep.GridPoint(alpha=a, algo=n) for n in ("gd", "hb", "lag",
                                                        "chb")]
    pts.append(sweep.GridPoint(alpha=a, beta=0.2, algo="chb"))
    pts.append(sweep.GridPoint(alpha=a, eps1=0.5, algo="csgd"))
    res = sweep.run_sweep(pts, linreg.task, num_iters=50, device="cpu")
    assert res.num_programs == 6
    refs = [opt.make(n, a, M) for n in ("gd", "hb", "lag", "chb")]
    refs += [opt.make("chb", a, M, beta=0.2),
             opt.make("csgd", a, M, tau0=0.5)]
    for o, h, spec in zip(refs, res.histories, res.specs):
        assert opt.from_spec(spec) == o
        _assert_same_run(h, simulator.run(o, linreg.task, 50, device="cpu"))


def test_template_transport_instance_survives(linreg):
    base = opt.make("chb", linreg.alpha_paper, M, transport="topk", k=3)
    pts = [sweep.GridPoint(alpha=linreg.alpha_paper, beta=0.4, eps1=1.0,
                           quantize="topk")]
    res = sweep.run_sweep(pts, linreg.task, num_iters=30, base_cfg=base,
                          device="cpu")
    assert res.specs[0]["transport"] == {"kind": "topk", "k": 3}
    o = opt.make("chb", linreg.alpha_paper, M, eps1=1.0, transport="topk",
                 k=3)
    _assert_same_run(res.history(0), simulator.run(o, linreg.task, 30,
                                                   device="cpu"))


# ------------------------------------------------------- against JAX's
JAX_ITERS = 60


@pytest.fixture(scope="module")
def jax_pair(linreg):
    """One grid through both engines at f64: 8 points, dense and int8."""
    a = linreg.alpha_paper
    kw = dict(alpha=(a, a / 2), beta=(0.0, 0.4), eps1_scale=(0.1, 1.0),
              quantize=(None, "int8"))
    res = sweep.run_sweep(sweep.ConfigGrid(**kw), linreg.task,
                          num_iters=JAX_ITERS, device="cpu")
    jres = j_sweep.run_sweep(j_sweep.ConfigGrid(**kw), _j_task(0),
                             num_iters=JAX_ITERS)
    fstar = float(simulator.estimate_fstar(linreg.task, a, 4000,
                                           device="cpu"))
    return res, jres, fstar


def test_sweep_matches_jax(jax_pair):
    res, jres, _ = jax_pair
    assert res.points == jres.points
    assert res.num_programs == jres.num_programs == 2
    np.testing.assert_array_equal(res.comm_cum, jres.comm_cum)
    np.testing.assert_array_equal(res.uplink_bytes, jres.uplink_bytes)
    for h, jh in zip(res.histories, jres.histories):
        np.testing.assert_array_equal(h.mask.numpy(), np.asarray(jh.mask))
        np.testing.assert_allclose(h.final_params.numpy(),
                                   np.asarray(jh.final_params),
                                   rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(res.objective, jres.objective, rtol=1e-9,
                               atol=1e-12)


def test_frontier_and_export_match_jax(jax_pair, tmp_path):
    res, jres, fstar = jax_pair
    rows, jrows = res.frontier(fstar, 1e-6), jres.frontier(fstar, 1e-6)
    ints = ("index", "algo", "seed", "quantize", "num_workers",
            "iters_to_tol", "comms_to_tol", "total_comms", "uplink_bytes")
    assert [{k: r[k] for k in ints} for r in rows] == \
        [{k: r[k] for k in ints} for r in jrows]
    assert any(r["iters_to_tol"] > 0 for r in rows)
    doc = json.loads(res.to_json(str(tmp_path / "s.json"), fstar=fstar,
                                 tol=1e-6))
    jdoc = json.loads(jres.to_json(fstar=fstar, tol=1e-6))
    assert set(doc) == set(jdoc)
    assert doc["points"] == jdoc["points"]
    assert doc["comm_cum"] == jdoc["comm_cum"]
    assert json.loads((tmp_path / "s.json").read_text()) == doc
    lines = res.to_csv(fstar, 1e-6).splitlines()
    assert lines[0] == jres.to_csv(fstar, 1e-6).splitlines()[0]
    assert len(lines) == 1 + len(res)


# ----------------------------------------------------------- rejections
def test_sweep_rejections(linreg):
    a = linreg.alpha_paper
    with pytest.raises(NotImplementedError, match="A8b"):
        sweep.run_sweep([sweep.GridPoint(alpha=a)], linreg.task,
                        num_iters=2, vectorize=True, device="cpu")
    with pytest.raises(ValueError, match="task_factory"):
        sweep.run_sweep(sweep.ConfigGrid(alpha=(a,), seed=(0, 1)),
                        linreg.task, num_iters=2, device="cpu")
    with pytest.raises(ValueError, match="task_factory"):
        sweep.run_sweep([sweep.GridPoint(alpha=a, seed=3)], linreg.task,
                        num_iters=2, device="cpu")
    adaptive = opt.ComposedOptimizer(
        censor=opt.AdaptiveCensor(1.0), transport=opt.DenseTransport(),
        server=opt.HeavyBall(a, 0.4), num_workers=M)
    with pytest.raises(ValueError, match="eps1 hook"):
        sweep.run_sweep(sweep.ConfigGrid(alpha=(a,), eps1=(0.5, 1.0)),
                        linreg.task, num_iters=2, base_cfg=adaptive,
                        device="cpu")
    with pytest.raises(TypeError, match="ComposedOptimizer"):
        sweep.run_sweep([sweep.GridPoint(alpha=a)], linreg.task,
                        num_iters=2, base_cfg=object(), device="cpu")


def test_tensor_hyperparameters_take_the_branch_free_forms(linreg):
    """A tensor eps1 is the port's traced scalar: ``per_tensor`` refuses
    it, and an optimizer holding one names itself "swept" (the reason the
    engine builds every point from host floats)."""
    o = opt.make("chb", linreg.alpha_paper, M, granularity="per_tensor")
    swept = o.with_hparams(eps1=torch.tensor(1.0, dtype=torch.float64))
    assert swept.name == "swept"
    with pytest.raises(NotImplementedError, match="host-scalar"):
        simulator.run(swept, linreg.task, 2, device="cpu")
    assert o.with_hparams(eps1=1.0).name == "chb"


# ------------------------------------------------------------ fed sweep
FED_GRID = dict(loss_prob=(0.0, 0.4), participation=(1.0, 0.5),
                quorum=(1.0, 0.6), seed=(0, 3))


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_fed_sweep_ideal_point_equals_run(linreg, backend):
    o = opt.make("chb", linreg.alpha_paper, M, backend=backend)
    grid = sweep.FedScenarioGrid(loss_prob=(0.0, 0.4))
    res = sweep.run_fed_sweep(o, linreg.task, grid, 60, device="cpu")
    ref = simulator.run(o, linreg.task, 60, device="cpu")
    i = res.points.index(sweep.FedScenarioPoint(0.0, 1.0, 1.0, 0))
    np.testing.assert_array_equal(res.objective[i], ref.objective.numpy())
    np.testing.assert_array_equal(res.agg_grad_sqnorm[i],
                                  ref.agg_grad_sqnorm.numpy())
    np.testing.assert_array_equal(res.comm_cum[i], ref.comm_cum.numpy())
    np.testing.assert_array_equal(res.transmit_mask[i],
                                  ref.mask.numpy().astype(np.int8))
    assert bool(res.quorum_met[i].all())
    lossy = res.points.index(sweep.FedScenarioPoint(0.4, 1.0, 1.0, 0))
    assert res.delivered_cum[lossy, -1] < res.comm_cum[lossy, -1]


@pytest.fixture(scope="module")
def fed_pair(linreg):
    a = linreg.alpha_paper
    res = {b: sweep.run_fed_sweep(opt.make("chb", a, M, backend=b),
                                  linreg.task,
                                  sweep.FedScenarioGrid(**FED_GRID), 80,
                                  device="cpu")
           for b in ("reference", "cuda")}
    jres = j_sweep.run_fed_sweep(j_opt.make("chb", a, M), _j_task(0),
                                 j_sweep.FedScenarioGrid(**FED_GRID), 80)
    return res, jres


EXACT = ("transmit_mask", "delivered_mask", "participate_mask", "quorum_met",
         "comm_cum", "delivered_cum", "bytes_cum", "energy_cum")


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_fed_sweep_matches_jax(fed_pair, backend):
    res, jres = fed_pair
    r = res[backend]
    assert r.points == jres.points
    for f in EXACT:
        np.testing.assert_array_equal(getattr(r, f), getattr(jres, f),
                                      err_msg=f)
    np.testing.assert_allclose(r.objective, jres.objective, rtol=1e-9)
    # the grid reaches every branch: partial cohorts, drops, failed quorums
    assert 0 < r.participate_mask.mean() < 1
    assert (r.delivered_cum < r.comm_cum).any()
    assert not r.quorum_met.all()
    fstar, tol = float(jres.objective.min()), 1e-3
    keys = ("index", "rounds", "uplinks", "bytes")
    assert [{k: x[k] for k in keys} for x in r.frontier(fstar, tol)] == \
        [{k: x[k] for k in keys} for x in jres.frontier(fstar, tol)]
    assert set(json.loads(r.to_json(fstar=fstar, tol=tol))) == \
        set(json.loads(jres.to_json(fstar=fstar, tol=tol)))


def test_fed_sweep_backends_agree(fed_pair):
    res, _ = fed_pair
    for f in EXACT + ("objective", "agg_grad_sqnorm"):
        np.testing.assert_array_equal(getattr(res["cuda"], f),
                                      getattr(res["reference"], f),
                                      err_msg=f)


def test_fed_sweep_rejections(linreg):
    a = linreg.alpha_paper
    grid = sweep.FedScenarioGrid()
    bad = [opt.make("chb", a, M, quantize="int8"),
           opt.make("chb", a, M, granularity="per_tensor"),
           opt.ComposedOptimizer(censor=opt.AdaptiveCensor(1.0),
                                 transport=opt.DenseTransport(),
                                 server=opt.HeavyBall(a, 0.4),
                                 num_workers=M)]
    for o in bad:
        with pytest.raises(NotImplementedError):
            sweep.run_fed_sweep(o, linreg.task, grid, 2, device="cpu")
    o = opt.make("chb", a, M)
    # the mesh splits the scenarios into equal blocks, one a shard
    with pytest.raises(ValueError, match="divisible"):
        sweep.run_fed_sweep(o, linreg.task,
                            sweep.FedScenarioGrid(seed=(0, 1, 2)), 2,
                            mesh=make_client_mesh(2, ["cpu"] * 2))
    with pytest.raises(NotImplementedError, match="A8b"):
        sweep.run_fed_sweep(o, linreg.task, grid, 2, vectorize=True,
                            device="cpu")
    with pytest.raises(ValueError, match="num_workers"):
        sweep.run_fed_sweep(dataclasses.replace(o, num_workers=4),
                            linreg.task, grid, 2, device="cpu")


def test_sweeps_default_to_cuda_and_raise_without_it(linreg, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    o = opt.make("chb", linreg.alpha_paper, M, backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep.run_sweep([sweep.GridPoint(alpha=0.01)], linreg.task,
                        num_iters=1, base_cfg=o)
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep.run_fed_sweep(o, linreg.task, sweep.FedScenarioGrid(), 1)
    res = sweep.run_sweep([sweep.GridPoint(alpha=0.01)], linreg.task,
                          num_iters=1, base_cfg=o, device="cpu")
    assert res.history(0).final_params.device.type == "cpu"
