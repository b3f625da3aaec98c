"""The mesh-sharded federated runtime of the port (``repro_torch.fed.mesh``)
against its own ``simulator.run`` and against the JAX package's
``repro.fed.mesh``, on the CPU (shards on ``["cpu"] * K``).

Setting: linreg m=8, n_per=20, d=12, seed 1, x64, chb at the paper's
alpha (as ``tests/test_distributed.py``'s fed-mesh legs), 10 rounds;
inputs are the same numpy draws in both packages. Tolerances and why:
  * against JAX's ``run_mesh`` over one device (``backend="reference"`` on
    both sides), port at K in {1, 2, 8}, the ideal scenario and
    ``MeshScenario(0.7, 0.2, 0.5, seed=3)``: masks, participated,
    attempted, delivered, ``quorum_met`` and ``bytes_cum`` exact (the
    per-client draws are the JAX PRNG's, bit for bit); objective and final
    params within rtol 1e-12 (XLA sums the workers with ``jnp.sum``, the
    port with a left fold);
  * anchor (a): the ideal scenario at K = 1 equals the port's
    ``simulator.run`` bit for bit, on both backends, dense and int8 (and
    lag, csgd, top-k);
  * anchor (b): masks, counts and quorum bit-equal across K in {1, 2, 8};
    floats within 1e-12 (the K-way fold's order);
  * ``donate`` and ``bake_data`` change nothing, bit for bit;
  * ``collect_metrics`` merges to the simulator's bags within rtol 1e-12;
  * ``run_fed_sweep(mesh=...)`` is the unsharded sweep bit for bit at K in
    {1, 2, 4}, and has JAX's unsharded masks exactly.
"""
import dataclasses

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest
import torch

from repro import opt as j_opt
from repro import sweep as j_sweep
from repro.data import paper_tasks as j_paper
from repro.fed.mesh import MeshScenario as JMeshScenario
from repro.fed.mesh import run_mesh as j_run_mesh
from repro_torch import fed, opt, sweep
from repro_torch.core import simulator
from repro_torch.core.distributed import make_client_fold
from repro_torch.data import paper_tasks
from repro_torch.fed import MeshScenario, run_mesh
from repro_torch.fed.clients import uniform_vector_population
from repro_torch.launch.mesh import ClientMesh, make_client_mesh
from repro_torch.launch.sharding import (client_shard_sizes,
                                         per_device_views, replicated,
                                         stack_shards)
from repro_torch.tree import tree_leaves

M = 8
ROUNDS = 10
SCENARIOS = {"ideal": (1.0, 0.0, 1.0, 0), "mixed": (0.7, 0.2, 0.5, 3)}
EXACT = ("mask", "participated", "attempted", "delivered", "quorum_met",
         "bytes_cum", "comm_cum", "delivered_cum")


def cpu_mesh(k):
    return make_client_mesh(k, ["cpu"] * k)


@pytest.fixture(scope="module")
def bundle():
    return paper_tasks.make_linear_regression(m=M, n_per=20, d=12, seed=1,
                                              device="cpu")


@pytest.fixture(scope="module")
def jax_runs():
    jb = j_paper.make_linear_regression(m=M, n_per=20, d=12, seed=1)
    o = j_opt.make("chb", jb.alpha_paper, M, backend="reference")
    return {name: j_run_mesh(o, jb.task, ROUNDS,
                             scenario=JMeshScenario(*sc))
            for name, sc in SCENARIOS.items()}


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _same(a, b):
    return all(x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


# -------------------------------------------------------- against JAX
@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("name", SCENARIOS)
def test_matches_jax(bundle, jax_runs, name, k):
    o = opt.make("chb", bundle.alpha_paper, M, backend="reference")
    got = run_mesh(o, bundle.task, ROUNDS, mesh=cpu_mesh(k),
                   scenario=MeshScenario(*SCENARIOS[name]))
    want = jax_runs[name]
    for f in EXACT:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    np.testing.assert_allclose(got.objective, want.objective, rtol=1e-12)
    np.testing.assert_allclose(got.final_params.numpy(),
                               np.asarray(want.final_params), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(got.energy_cum, want.energy_cum, rtol=1e-12)
    np.testing.assert_array_equal(got.wall_clock, want.wall_clock)
    if name == "mixed":   # the draws reach every branch
        assert got.participated.min() < M
        assert (got.delivered < got.attempted).any()


# ----------------------------------------------------------- anchor (a)
ANCHOR_PATHS = {"chb": ("chb", {}), "chb_int8": ("chb", {"quantize": "int8"}),
                "lag": ("lag", {}), "csgd": ("csgd", {}),
                "topk": ("chb", {"transport": "topk", "k": 5})}


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("path", ANCHOR_PATHS)
def test_sync_anchor_bitwise(bundle, path, backend):
    """The ideal scenario over one shard is ``simulator.run`` bit for bit."""
    algo, kw = ANCHOR_PATHS[path]
    o = opt.make(algo, bundle.alpha_paper, M, backend=backend, **kw)
    hist = simulator.run(o, bundle.task, 12, device="cpu")
    mh = run_mesh(o, bundle.task, 12, mesh=cpu_mesh(1))
    np.testing.assert_array_equal(hist.objective.numpy(), mh.objective)
    np.testing.assert_array_equal(hist.mask.numpy().astype(np.int8), mh.mask)
    np.testing.assert_array_equal(hist.agg_grad_sqnorm.numpy(),
                                  mh.agg_grad_sqnorm)
    np.testing.assert_array_equal(hist.comm_cum.numpy(), mh.comm_cum)
    assert _same(hist.final_params, mh.final_params)
    assert mh.quorum_met.all() and (mh.participated == M).all()
    np.testing.assert_array_equal(mh.attempted, mh.delivered)


# ----------------------------------------------------------- anchor (b)
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_shard_count_invariance(bundle, backend):
    o = opt.make("chb", bundle.alpha_paper, M, backend=backend)
    sc = MeshScenario(*SCENARIOS["mixed"])
    runs = {k: run_mesh(o, bundle.task, ROUNDS, mesh=cpu_mesh(k),
                        scenario=sc) for k in (1, 2, 8)}
    for k in (2, 8):
        for f in EXACT:
            np.testing.assert_array_equal(getattr(runs[k], f),
                                          getattr(runs[1], f), err_msg=f)
        np.testing.assert_allclose(runs[k].objective, runs[1].objective,
                                   rtol=1e-12)
        np.testing.assert_allclose(runs[k].final_params.numpy(),
                                   runs[1].final_params.numpy(), rtol=0,
                                   atol=1e-12)


def test_sync_anchor_on_eight_shards(bundle):
    o = opt.make("chb", bundle.alpha_paper, M)
    hist = simulator.run(o, bundle.task, ROUNDS, device="cpu")
    mh = run_mesh(o, bundle.task, ROUNDS, mesh=cpu_mesh(8))
    np.testing.assert_array_equal(hist.mask.numpy().astype(np.int8), mh.mask)
    np.testing.assert_array_equal(hist.comm_cum.numpy(), mh.comm_cum)
    np.testing.assert_allclose(mh.objective, hist.objective.numpy(),
                               rtol=1e-13)


@pytest.mark.parametrize("k", [1, 2])
def test_donate_and_bake_data_give_the_same_bits(bundle, k):
    o = opt.make("chb", bundle.alpha_paper, M)
    sc = MeshScenario(participation=0.8, loss_prob=0.3, quorum=0.6, seed=5)
    runs = [run_mesh(o, bundle.task, 12, mesh=cpu_mesh(k), scenario=sc,
                     donate=d, bake_data=b)
            for d, b in ((False, True), (True, True), (False, False),
                         (True, False))]
    for r in runs[1:]:
        for f in EXACT + ("objective", "agg_grad_sqnorm", "energy_cum"):
            np.testing.assert_array_equal(getattr(r, f), getattr(runs[0], f),
                                          err_msg=f)
        assert _same(r.final_params, runs[0].final_params)


def test_scenario_draws_replay_exactly(bundle):
    o = opt.make("chb", bundle.alpha_paper, M)
    sc = MeshScenario(participation=0.6, loss_prob=0.25, seed=11)
    a = run_mesh(o, bundle.task, 10, mesh=cpu_mesh(1), scenario=sc)
    b = run_mesh(o, bundle.task, 10, mesh=cpu_mesh(2), scenario=sc)
    np.testing.assert_array_equal(a.mask, b.mask)
    c = run_mesh(o, bundle.task, 10, mesh=cpu_mesh(1),
                 scenario=dataclasses.replace(sc, seed=12))
    assert not np.array_equal(a.mask, c.mask)


def test_quorum_semantics_pinned_by_counts(bundle):
    o = opt.make("chb", bundle.alpha_paper, M)
    sc = MeshScenario(participation=0.8, loss_prob=0.4, quorum=0.7, seed=7)
    mh = run_mesh(o, bundle.task, 30, mesh=cpu_mesh(2), scenario=sc)
    arrived = mh.participated - (mh.attempted - mh.delivered)
    want = (arrived >= np.ceil(sc.quorum * mh.participated)) \
        & (mh.participated > 0)
    np.testing.assert_array_equal(mh.quorum_met, want)
    assert not mh.quorum_met.all(), "scenario too easy to pin the gate"
    frozen = np.nonzero(~mh.quorum_met[:-1])[0]
    np.testing.assert_array_equal(mh.objective[frozen + 1],
                                  mh.objective[frozen])
    assert (mh.delivered <= mh.attempted).all()
    assert (mh.attempted <= mh.participated).all()


def test_accounting_bytes_energy_wall(bundle):
    o = opt.make("chb", bundle.alpha_paper, M)
    sc = MeshScenario(participation=0.7, loss_prob=0.2, seed=3)
    pop = uniform_vector_population(M, compute_mean_s=0.5,
                                    straggler_frac=0.2)
    em = fed.EnergyModel()
    mh = run_mesh(o, bundle.task, 10, mesh=cpu_mesh(2), scenario=sc,
                  population=pop, channel=fed.ChannelConfig(), energy=em)
    payload = o.transport.payload_bytes(bundle.task.init_params)
    np.testing.assert_array_equal(mh.bytes_cum,
                                  np.cumsum(mh.attempted) * payload)
    assert (np.diff(mh.wall_clock) > 0).all()
    assert (np.diff(mh.energy_cum) > 0).all()
    radio = np.cumsum(em.round_energy(mh.attempted, mh.participated,
                                      payload))
    assert (mh.energy_cum >= radio - 1e-9).all()


def test_collect_metrics_merges_to_simulator_bag(bundle):
    o = opt.make("chb", bundle.alpha_paper, M)
    hist = simulator.run(o, bundle.task, 8, device="cpu",
                         collect_metrics=True)
    mh = run_mesh(o, bundle.task, 8, mesh=cpu_mesh(1), collect_metrics=True)
    assert len(mh.metrics) == 8
    for k in ("censor_rate", "bank_sqnorm", "agg_grad_sqnorm",
              "step_sqnorm"):
        np.testing.assert_allclose(
            np.asarray([bag[k] for bag in mh.metrics]),
            hist.metrics[k].numpy(), rtol=1e-12, err_msg=k)
    # sharded: the rates are the shard-weighted means
    mh2 = run_mesh(o, bundle.task, 8, mesh=cpu_mesh(2), collect_metrics=True)
    np.testing.assert_allclose(
        [b["censor_rate"] for b in mh2.metrics],
        [b["censor_rate"] for b in mh.metrics], rtol=1e-6)
    np.testing.assert_allclose([b["agg_grad_sqnorm"] for b in mh2.metrics],
                               mh2.agg_grad_sqnorm, rtol=0)


# ------------------------------------------------------------ rejections
def test_rejects_non_composed_adaptive_and_per_tensor(bundle):
    class Wrapped:
        num_workers = M

    with pytest.raises(TypeError, match="ComposedOptimizer"):
        run_mesh(Wrapped(), bundle.task, 2, mesh=cpu_mesh(1))
    adaptive = opt.ComposedOptimizer(
        censor=opt.AdaptiveCensor(0.25), transport=opt.DenseTransport(),
        server=opt.HeavyBall(bundle.alpha_paper, 0.4), num_workers=M)
    with pytest.raises(NotImplementedError, match="adaptive"):
        run_mesh(adaptive, bundle.task, 2, mesh=cpu_mesh(1))
    with pytest.raises(NotImplementedError, match="global"):
        run_mesh(opt.make("chb", bundle.alpha_paper, M,
                          granularity="per_tensor"), bundle.task, 2,
                 mesh=cpu_mesh(1))


def test_rejects_mismatched_sizes(bundle):
    with pytest.raises(ValueError, match="num_workers"):
        run_mesh(opt.make("chb", bundle.alpha_paper, M + 1), bundle.task, 2,
                 mesh=cpu_mesh(1))
    o = opt.make("chb", bundle.alpha_paper, M)
    with pytest.raises(ValueError, match="clients"):
        run_mesh(o, bundle.task, 2, mesh=cpu_mesh(1),
                 population=uniform_vector_population(M + 2))
    with pytest.raises(ValueError, match="divisible"):
        run_mesh(o, bundle.task, 2, mesh=cpu_mesh(3))


def test_scenario_validation():
    with pytest.raises(ValueError, match="participation"):
        MeshScenario(participation=0.0)
    with pytest.raises(ValueError, match="loss_prob"):
        MeshScenario(loss_prob=1.0)
    with pytest.raises(ValueError, match="quorum"):
        MeshScenario(quorum=1.5)
    assert MeshScenario().sync_draws
    assert not MeshScenario(participation=0.9).sync_draws
    assert not MeshScenario(loss_prob=0.1).sync_draws


def test_client_mesh_needs_its_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="devices="):
        make_client_mesh(2)
    with pytest.raises(ValueError, match="devices="):
        make_client_mesh(1)
    with pytest.raises(ValueError, match=">= 1"):
        make_client_mesh(0)
    with pytest.raises(ValueError, match="2 devices"):
        make_client_mesh(3, ["cpu", "cpu"])
    mesh = make_client_mesh(8, ["cpu"] * 8)
    assert isinstance(mesh, ClientMesh) and mesh.size == 8
    assert mesh.axis_names == ("clients",) and mesh.shape == {"clients": 8}
    assert mesh.server == torch.device("cpu")


def test_run_mesh_defaults_to_cuda_and_raises_without_it(bundle,
                                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="CUDA"):
        run_mesh(opt.make("chb", bundle.alpha_paper, M), bundle.task, 1)


# ------------------------------------------------------ sharding helpers
def test_sharding_helpers_move_without_copies():
    mesh = cpu_mesh(4)
    x = torch.arange(24.0).reshape(8, 3)
    assert client_shard_sizes(8, mesh) == 2
    with pytest.raises(ValueError, match="divisible"):
        client_shard_sizes(6, mesh)
    views = per_device_views({"x": x}, mesh)
    assert [v["x"].data_ptr() for v in views] == \
        [x[i * 2].data_ptr() for i in range(4)]
    assert torch.equal(stack_shards(views, mesh)["x"], x)
    rep = per_device_views(x, mesh, replicated=True)
    assert all(r is x for r in rep)
    assert replicated(x, mesh) is x
    with pytest.raises(ValueError, match="pieces"):
        stack_shards(views[:3], mesh)


def test_client_fold_is_a_left_fold_from_minus_zero():
    one = make_client_fold(cpu_mesh(1))
    v = torch.tensor([[-0.0, 1.5, float("nan")]], dtype=torch.float64)
    out = one({"a": v, "n": torch.tensor([7])})
    assert torch.equal(_bits(out["a"][:2]), _bits(v[0, :2]))
    assert torch.isnan(out["a"][2]) and int(out["n"]) == 7
    three = make_client_fold(cpu_mesh(3))
    rows = torch.tensor([[1e16], [1.0], [-1e16]], dtype=torch.float64)
    assert float(three(rows)) == ((1e16 + 1.0) + -1e16)
    with pytest.raises(ValueError, match="3 shard rows"):
        three(rows[:2])


# ------------------------------------------------- run_fed_sweep(mesh=)
FED_GRID = dict(loss_prob=(0.0, 0.4), participation=(1.0, 0.5),
                quorum=(1.0, 0.6), seed=(0, 3))
FED_FIELDS = ("objective", "agg_grad_sqnorm", "transmit_mask",
              "delivered_mask", "participate_mask", "quorum_met",
              "comm_cum", "delivered_cum", "bytes_cum", "energy_cum")


@pytest.fixture(scope="module")
def fed_unsharded():
    lin = paper_tasks.make_linear_regression(m=5, n_per=30, d=20, seed=0,
                                             device="cpu")
    o = opt.make("chb", lin.alpha_paper, 5, backend="cuda")
    grid = sweep.FedScenarioGrid(**FED_GRID)
    return lin, o, grid, sweep.run_fed_sweep(o, lin.task, grid, 30,
                                             device="cpu")


@pytest.mark.parametrize("k", [1, 2, 4])
def test_fed_sweep_mesh_is_the_unsharded_sweep(fed_unsharded, k):
    lin, o, grid, want = fed_unsharded
    got = sweep.run_fed_sweep(o, lin.task, grid, 30, mesh=cpu_mesh(k))
    assert got.points == want.points
    for f in FED_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


def test_fed_sweep_mesh_has_jax_masks(fed_unsharded):
    lin, o, grid, _ = fed_unsharded
    got = sweep.run_fed_sweep(o, lin.task, grid, 30, mesh=cpu_mesh(4))
    jb = j_paper.make_linear_regression(m=5, n_per=30, d=20, seed=0)
    want = j_sweep.run_fed_sweep(j_opt.make("chb", jb.alpha_paper, 5),
                                 jb.task, j_sweep.FedScenarioGrid(**FED_GRID),
                                 30)
    for f in ("transmit_mask", "delivered_mask", "participate_mask",
              "quorum_met", "comm_cum", "bytes_cum"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    np.testing.assert_allclose(got.objective, want.objective, rtol=1e-9)
