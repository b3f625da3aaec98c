"""The slice as a whole: the port's ``simulator.run`` held against the JAX
package's on the paper's golden linreg task (m=5, n_per=30, d=20, seed=0,
60 iterations), with the dense, int8, top-k (k=8) and low-rank (rank 2)
transports, and on the edge quadratics, flat and as a three-leaf tree
that runs the low-rank factors through the whole loop.

Tolerances and why:
  * f64: masks, ``comm_cum`` and the uplink counters exact over all 60
    iterations (every eq.-(8) decision of these runs clears its threshold
    by more than 2%); objective and final theta within rel 1e-9, since
    torch's and XLA's matmuls reduce in other orders and the differences
    compound over 60 iterations;
  * f32: objective and final theta within rel 1e-4, for the same reason;
    masks and ``comm_cum`` exact up to the iteration where the run reaches
    the f32 noise floor (the step falls below 256 ulps of theta). Past it
    both sides of eq. (8) are rounding noise, so the decisions follow each
    platform's rounding of the gradient: the JAX package itself gives 260
    uploads for dense chb on an AVX-512 Xeon where ``tests/test_backend.py``
    pins the 262 of the host that recorded it. Top-k's deferred mass keeps
    its steps above that floor, but its f32 top-k choices carry each
    package's rounding forward: its masks are held exactly up to the first
    eq.-(8) decision within 2% of its threshold, and its upload total to
    within 2%;
  * low-rank on the three-leaf edge quadratics (f64, 30 iterations):
    masks exact, objective within rel 1e-9 and theta within 1e-8 of its
    max |theta|: the factor products sum in other orders in torch and XLA,
    and 30 rounds of subspace iteration carry those differences forward.
The port's kernel backend on CPU tensors (the kernels' plain versions) is
held to its reference backend bit for bit.
"""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import opt as j_opt
from repro.core import simulator as j_simulator
from repro.data import edge_tasks as j_edge
from repro.data import paper_tasks as j_paper
from repro_torch import opt
from repro_torch.core import simulator
from repro_torch.data import edge_tasks, paper_tasks

M = 5
ITERS = 60
CASES = [("gd", {}), ("hb", {}), ("lag", {}), ("chb", {}),
         ("chb", {"quantize": "int8"}),
         ("chb", {"transport": "topk", "k": 8}),
         ("chb", {"transport": "lowrank", "rank": 2})]
IDS = ["gd", "hb", "lag", "chb", "chb-int8", "chb-topk", "chb-lowrank"]
# the JAX package's f64 uploads of the golden run, per transport
GOLDEN_F64_UPLOADS = {"dense": 240, "int8": 240, "topk": 295, "lowrank": 240}


def _cast(t, dtype):
    return jax.tree_util.tree_map(lambda x: x.astype(dtype), t)


@pytest.fixture(scope="module")
def tasks():
    j = j_paper.make_linear_regression(m=M, n_per=30, d=20, seed=0)
    p = paper_tasks.make_linear_regression(m=M, n_per=30, d=20, seed=0,
                                           device="cpu")
    j_tasks = {np.float64: j.task._replace(
        init_params=_cast(j.task.init_params, jnp.float64),
        worker_data=_cast(j.task.worker_data, jnp.float64)),
        np.float32: j.task._replace(
            init_params=_cast(j.task.init_params, jnp.float32),
            worker_data=_cast(j.task.worker_data, jnp.float32))}
    p_tasks = {np.float64: p.task,
               np.float32: simulator.task_to(p.task, dtype=torch.float32)}
    return j, p, j_tasks, p_tasks


@pytest.fixture(scope="module")
def jax_runs(tasks):
    j, _, j_tasks, _ = tasks
    cache = {}

    def get(name, extra, dtype):
        key = (name, tuple(extra.items()), dtype)
        if key not in cache:
            o = j_opt.make(name, j.alpha_paper, M, **extra)
            h = j_simulator.run(o, j_tasks[dtype], ITERS)
            cache[key] = jax.tree_util.tree_map(np.asarray, h)
        return cache[key]
    return get


def _port_run(p, task, name, extra, backend):
    """``simulator.run`` plus each step's ||theta^k||^2 and step sqnorm."""
    o = opt.make(name, p.alpha_paper, M, backend=backend, **extra)
    seen = {"theta": [], "ssq": [], "margin": []}

    class Recorder:
        def init(self, params):
            return o.init(params)

        def step(self, state, params, grads):
            seen["theta"].append(float(torch.sum(params.double() ** 2)))
            out = o.step(state, params, grads)
            ssq = float(out[2].step_sq)
            seen["ssq"].append(ssq)
            thr = float(o.eps1) * ssq
            seen["margin"].append(
                float(((out[2].delta_sq.double() - thr).abs() / thr).min())
                if thr > 0 else np.inf)
            return out

    return simulator.run(Recorder(), task, ITERS, device="cpu"), seen


def _noise_floor(seen) -> int:
    eps = np.finfo(np.float32).eps
    for k, (ssq, th) in enumerate(zip(seen["ssq"], seen["theta"])):
        if 0 < ssq < (256 * eps) ** 2 * th:
            return k
    return ITERS


def _first_close_call(seen, within=0.02) -> int:
    """First iteration with an eq.-(8) decision within ``within`` of its
    threshold (relative), or ITERS."""
    return next((k for k, mg in enumerate(seen["margin"]) if mg < within),
                ITERS)


def test_tasks_draw_identical_data(tasks):
    j, p, _, _ = tasks
    for a, b in zip(j.task.worker_data, p.task.worker_data):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert p.alpha_paper == j.alpha_paper and p.L == j.L


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("name,extra", CASES, ids=IDS)
def test_f64_run_matches_jax(tasks, jax_runs, name, extra, backend):
    _, p, _, p_tasks = tasks
    jh = jax_runs(name, extra, np.float64)
    ph, _ = _port_run(p, p_tasks[np.float64], name, extra, backend)
    np.testing.assert_array_equal(ph.mask.numpy(), jh.mask)
    np.testing.assert_array_equal(ph.comm_cum.numpy(), jh.comm_cum)
    pc, jc = ph.final_state.comm, jh.final_state.comm
    np.testing.assert_array_equal(pc.uplink_count.numpy(), jc.uplink_count)
    assert pc.uplink_bytes_exact() == int(jc.uplink_mib) * 2 ** 20 \
        + int(jc.uplink_rem)
    np.testing.assert_allclose(ph.objective.numpy(), jh.objective,
                               rtol=1e-9)
    np.testing.assert_allclose(ph.final_params.numpy(), jh.final_params,
                               rtol=1e-9, atol=1e-12)
    if name == "chb":
        kind = extra.get("transport", extra.get("quantize", "dense"))
        assert int(ph.comm_cum[-1]) == int(ph.mask.sum()) \
            == GOLDEN_F64_UPLOADS[kind]


@pytest.mark.parametrize("name,extra", CASES, ids=IDS)
def test_f32_run_matches_jax_to_the_noise_floor(tasks, jax_runs, name,
                                                extra):
    _, p, _, p_tasks = tasks
    jh = jax_runs(name, extra, np.float32)
    ph, seen = _port_run(p, p_tasks[np.float32], name, extra, "cuda")
    floor = _noise_floor(seen)
    if extra.get("transport") == "topk":
        # top-k's deferred mass keeps its steps far above the f32 floor, so
        # the 256-ulp rule finds none; instead its f32 top-k choices and
        # the momentum carry each package's rounding forward, and a
        # decision 2.5% from its threshold at iteration 54 (273 times one
        # rounding of the gradient) falls the other way on an AVX-512
        # Xeon. Its masks are held exactly to the first decision within 2%
        # of its threshold (iteration 24 there), its total to within 2%
        assert floor == ITERS
        floor = _first_close_call(seen)
        assert abs(int(ph.comm_cum[-1]) - int(jh.comm_cum[-1])) \
            <= 0.02 * int(jh.comm_cum[-1])
    assert floor >= 20
    np.testing.assert_array_equal(ph.mask.numpy()[:floor], jh.mask[:floor])
    np.testing.assert_array_equal(ph.comm_cum.numpy()[:floor],
                                  jh.comm_cum[:floor])
    np.testing.assert_allclose(ph.objective.numpy(), jh.objective,
                               rtol=1e-4)
    # after its masks part, top-k defers other mass: theta to 1e-3 of max
    atol = 1e-3 * np.abs(jh.final_params).max() \
        if extra.get("transport") == "topk" else 1e-6
    np.testing.assert_allclose(ph.final_params.numpy(), jh.final_params,
                               rtol=1e-4, atol=atol)
    comm = ph.final_state.comm
    payload = {"int8": 20 + 4, "topk": 8 * (4 + 4)}.get(
        extra.get("quantize", extra.get("transport")), 20 * 4)
    assert int(comm.uplink_count.sum()) == int(ph.comm_cum[-1]) \
        == int(ph.mask.sum())
    assert comm.uplink_bytes_exact() == int(ph.comm_cum[-1]) * payload


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("kw", [{}, {"quantize": "int8"},
                                {"transport": "topk", "k": 8},
                                {"transport": "lowrank", "rank": 2}],
                         ids=["dense", "int8", "topk", "lowrank"])
def test_kernel_backend_on_cpu_equals_reference(tasks, kw, dtype):
    _, p, _, _ = tasks
    task = simulator.task_to(p.task, dtype=dtype)
    runs = [simulator.run(opt.make("chb", p.alpha_paper, M, backend=b,
                                   **kw),
                          task, ITERS, device="cpu")
            for b in ("cuda", "reference")]
    for f in ("objective", "comm_cum", "mask", "agg_grad_sqnorm",
              "final_params"):
        a, b = (getattr(h, f) for h in runs)
        assert torch.equal(a, b), f
    assert runs[0].final_state.comm.uplink_bytes_exact() == \
        runs[1].final_state.comm.uplink_bytes_exact()


def test_edge_quadratics_match_jax():
    jt = j_edge.make_edge_quadratics(m=16, d=16, seed=0)
    pt = edge_tasks.make_edge_quadratics(m=16, d=16, seed=0, device="cpu")
    for a, b in zip(jt.worker_data, pt.worker_data):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_allclose(edge_tasks.edge_quadratics_fstar(pt),
                               j_edge.edge_quadratics_fstar(jt), rtol=1e-12)
    jh = j_simulator.run(j_opt.make("chb", 0.5 / 16, 16, eps1=4.0), jt, 30)
    ph = simulator.run(opt.make("chb", 0.5 / 16, 16, eps1=4.0,
                                backend="cuda"), pt, 30, device="cpu")
    np.testing.assert_array_equal(ph.mask.numpy(), np.asarray(jh.mask))
    np.testing.assert_allclose(ph.objective.numpy(),
                               np.asarray(jh.objective), rtol=1e-9)
    assert 0 < int(ph.comm_cum[-1]) < 30 * 16
    assert simulator.iterations_to_accuracy(ph, 0.0, 1e30) == 0
    assert simulator.comms_to_accuracy(ph, 0.0, -1.0) == -1



TREE = {"w1": (6, 10), "b1": (10,), "w2": (2, 3, 4)}
M_TREE = 6


def _tree_tasks():
    """The edge quadratics ``0.5*a_m*||theta - c_m||^2`` over a three-leaf
    tree, built here for both packages from one numpy draw."""
    from repro.core.simulator import FedTask as JFedTask
    rng = np.random.default_rng(4)
    a = np.exp(rng.uniform(0.0, np.log(3.0), size=(M_TREE,)))
    c = {k: rng.normal(size=(M_TREE,) + s) for k, s in TREE.items()}

    def j_grad(theta, data):                 # one worker's slice
        am, cm = data
        return {k: am * (x - cm[k]) for k, x in theta.items()}

    def j_loss(theta, data):
        am, cm = data
        return sum(0.5 * am * jnp.sum((x - cm[k]) ** 2)
                   for k, x in theta.items())

    def p_grad(theta, data):                 # all workers at once
        am, cm = data
        return {k: am.reshape((-1,) + (1,) * x.dim()) * (x - cm[k])
                for k, x in theta.items()}

    def p_loss(theta, data):
        am, cm = data
        return sum(0.5 * am * torch.sum((x - cm[k]).reshape(M_TREE, -1) ** 2,
                                        dim=1)
                   for k, x in theta.items())

    init = {k: np.zeros(s) for k, s in TREE.items()}
    jt = JFedTask(init_params={k: jnp.asarray(v) for k, v in init.items()},
                  grad_fn=j_grad, loss_fn=j_loss,
                  worker_data=(jnp.asarray(a),
                               {k: jnp.asarray(v) for k, v in c.items()}))
    pt = simulator.FedTask(
        init_params={k: torch.from_numpy(v) for k, v in init.items()},
        grad_fn=p_grad, loss_fn=p_loss,
        worker_data=(torch.from_numpy(a),
                     {k: torch.from_numpy(v) for k, v in c.items()}))
    return jt, pt


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_lowrank_on_matrix_leaves_matches_jax(backend):
    jt, pt = _tree_tasks()
    # a step small enough for the rank-2 error feedback to converge, and
    # an eps1 at which some workers censor (every decision clears its
    # threshold by more than 2%)
    kw = {"eps1": 60.0, "transport": "lowrank", "rank": 2}
    alpha = 0.15 / M_TREE
    jh = j_simulator.run(j_opt.make("chb", alpha, M_TREE, **kw), jt, 30)
    ph = simulator.run(opt.make("chb", alpha, M_TREE, backend=backend,
                                **kw), pt, 30, device="cpu")
    np.testing.assert_array_equal(ph.mask.numpy(), np.asarray(jh.mask))
    np.testing.assert_array_equal(ph.comm_cum.numpy(),
                                  np.asarray(jh.comm_cum))
    assert 0 < int(ph.comm_cum[-1]) < 30 * M_TREE
    np.testing.assert_allclose(ph.objective.numpy(),
                               np.asarray(jh.objective), rtol=1e-9)
    assert float(ph.objective[-1]) < float(ph.objective[0])
    for k in TREE:
        want = np.asarray(jh.final_params[k])
        np.testing.assert_allclose(ph.final_params[k].numpy(), want,
                                   rtol=0, atol=1e-8 * np.abs(want).max())
    pc, jc = ph.final_state.comm, jh.final_state.comm
    assert pc.uplink_bytes_exact() == int(jc.uplink_mib) * 2 ** 20 \
        + int(jc.uplink_rem)
    # the factors of the matrix leaves really moved
    q = ph.final_state.err["q"]
    assert q["b1"].shape == (M_TREE, 0)
    assert not torch.equal(q["w1"], opt.LowRankTransport(2).init(
        pt.init_params, M_TREE)["q"]["w1"])
