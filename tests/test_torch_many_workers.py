"""The port at the fed-mesh's scale: 70,000 clients, against the JAX
package, and the fused routes' worker sum.

``benchmarks/fed_mesh.py`` runs chb (alpha 0.5/M, eps1 4.0) on
``make_edge_quadratics(M, d=16, seed=0)`` at M = 10^5 and up. Here both
packages build the task at M = 70,000 (past the 65,535 blocks of a CUDA
grid's y axis, where the port's per-worker kernels walk the workers) and
run 3 iterations in f64, dense and int8: the JAX package on its
``reference`` backend, the port on ``reference`` and on ``cuda`` over CPU
tensors (the kernels' plain versions).

Tolerances and why:
  * masks and ``comm_cum`` exact: every eq.-(8) decision of these runs
    clears its threshold by far more than the f32 sums' rounding;
  * objective and final theta within rel 1e-9 of the JAX package's, the
    tolerance of ``tests/test_torch_simulator.py`` (torch and XLA reduce
    in other orders);
  * the port's ``cuda`` backend on CPU tensors equals its ``reference``
    backend bit for bit.

The fused routes (B2/B6) return the worker sum themselves; the optimizer
keeps it instead of folding the bank again. The last test holds that sum,
and ``agg_grad_sqnorm``, to ``tree_sum_leading`` of the new bank bit for
bit, on a leaf whose every worker slice is -0.0 (a sum started from zeros
would give +0.0 there).
"""
import jax

jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest
import torch

from repro import opt as j_opt
from repro.core import simulator as j_simulator
from repro.data import edge_tasks as j_edge
from repro_torch import opt
from repro_torch.core import simulator
from repro_torch.core.util import tree_sqnorm, tree_sum_leading
from repro_torch.data import edge_tasks
from repro_torch.kernels import ops as kernel_ops
from repro_torch.opt import optimizer as optimizer_module
from repro_torch.tree import tree_leaves

M = 70_000
D = 16
ITERS = 3
ALPHA = 0.5 / M
EPS1 = 4.0
KINDS = {"dense": {}, "int8": {"quantize": "int8"}}


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The raw bits of a float tensor (tells -0.0 from +0.0); other
    dtypes as they are."""
    as_int = {torch.float32: torch.int32, torch.float64: torch.int64}
    return t.view(as_int[t.dtype]) if t.dtype in as_int else t


@pytest.fixture(scope="module")
def tasks():
    return (j_edge.make_edge_quadratics(M, d=D, seed=0),
            edge_tasks.make_edge_quadratics(M, d=D, seed=0, device="cpu"))


@pytest.fixture(scope="module")
def port_runs(tasks):
    _, pt = tasks
    return {(kind, backend): simulator.run(
        opt.make("chb", ALPHA, M, eps1=EPS1, backend=backend, **kw), pt,
        ITERS, device="cpu")
        for kind, kw in KINDS.items() for backend in ("reference", "cuda")}


def test_tasks_draw_identical_data(tasks):
    jt, pt = tasks
    for a, b in zip(jt.worker_data, pt.worker_data):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert pt.worker_data[1].dtype == torch.float64


@pytest.mark.parametrize("kind", KINDS)
def test_port_matches_jax_at_fed_mesh_scale(tasks, port_runs, kind):
    jt, _ = tasks
    jh = j_simulator.run(j_opt.make("chb", ALPHA, M, eps1=EPS1,
                                    **KINDS[kind]), jt, ITERS)
    for backend in ("reference", "cuda"):
        ph = port_runs[kind, backend]
        np.testing.assert_array_equal(ph.mask.numpy(), np.asarray(jh.mask))
        np.testing.assert_array_equal(ph.comm_cum.numpy(),
                                      np.asarray(jh.comm_cum))
        np.testing.assert_allclose(ph.objective.numpy(),
                                   np.asarray(jh.objective), rtol=1e-9)
        np.testing.assert_allclose(ph.final_params.numpy(),
                                   np.asarray(jh.final_params), rtol=1e-9)
    # some workers censor, and most transmit
    assert M < int(ph.comm_cum[-1]) < ITERS * M


@pytest.mark.parametrize("kind", KINDS)
def test_cuda_backend_on_cpu_equals_reference(port_runs, kind):
    runs = [port_runs[kind, b] for b in ("cuda", "reference")]
    for f in ("objective", "comm_cum", "mask", "agg_grad_sqnorm",
              "final_params"):
        a, b = (getattr(h, f) for h in runs)
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b)), f
    assert runs[0].final_state.comm.uplink_bytes_exact() == \
        runs[1].final_state.comm.uplink_bytes_exact()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m", [1, 4, 9])
def test_fused_routes_return_the_left_fold(monkeypatch, m, kind):
    """One fused step on the ``cuda`` backend (CPU tensors): the kernels'
    agg is ``tree_sum_leading`` of the new bank bit for bit, and so is
    ``agg_grad_sqnorm`` of it; the optimizer folds nothing itself. Leaf
    ``z`` ends the step -0.0 in every worker slice: theta^{k-1} lies far
    from theta^k, so eq. (8) censors every worker, and ghat + 0*(g - ghat)
    with g - ghat < 0 stays -0.0."""
    gen = np.random.default_rng(m)
    params = {"a": torch.from_numpy(gen.normal(size=(5,))),
              "z": torch.zeros(3, dtype=torch.float64)}
    grads = {"a": torch.from_numpy(gen.normal(size=(m, 5))),
             "z": torch.full((m, 3), -1.0, dtype=torch.float64)}
    o = opt.make("chb", 0.1, m, eps1=EPS1, backend="cuda", **KINDS[kind])
    state = o.init(params)
    state = state._replace(
        prev_params={k: v + 100.0 for k, v in params.items()},
        ghat={"a": torch.from_numpy(gen.normal(size=(m, 5))),
              "z": torch.full((m, 3), -0.0, dtype=torch.float64)})
    seen = []
    fused = "tree_fused_dense_step" if kind == "dense" \
        else "tree_fused_int8_step"
    step_fn = getattr(kernel_ops, fused)

    def record(*args):
        out = step_fn(*args)
        seen.append(out[-2])            # agg
        return out

    def no_fold(tree):
        raise AssertionError("the fused route folded the bank again")

    monkeypatch.setattr(kernel_ops, fused, record)
    monkeypatch.setattr(optimizer_module, "tree_sum_leading", no_fold)
    new_state, _, stats = o.step(state, params, grads)
    assert len(seen) == 1 and not bool(stats.mask.any())
    want = tree_sum_leading(new_state.ghat)
    assert torch.equal(_bits(new_state.ghat["z"]),
                       _bits(torch.full((m, 3), -0.0, dtype=torch.float64)))
    for a, b in zip(tree_leaves(seen[0]), tree_leaves(want)):
        assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(_bits(seen[0]["z"]), _bits(new_state.ghat["z"][0]))
    assert torch.equal(_bits(stats.agg_grad_sqnorm), _bits(tree_sqnorm(want)))
