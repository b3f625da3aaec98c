"""The port's remaining tasks and the feasibility checks, held against the
JAX package in one process (x64 on): logistic regression, lasso, the
neural network, the dataset stand-ins and the edge least squares;
``theoretical_params``, ``check_feasible`` and ``estimate_fstar``.

Tolerances and why:
  * data, ``L``, ``L_m`` and ``alpha_paper``: exact (the same numpy draws
    in the same order);
  * the network's initial weights: exact (the JAX PRNG's f64 normals, see
    ``tests/test_torch_random.py``);
  * losses and gradients at f64: within rel 1e-12 of the largest entry,
    since torch's and XLA's matmuls and sums reduce in other orders, and
    the port writes out the gradients that JAX takes with ``jax.grad``;
  * ``estimate_fstar``: rel 1e-9, after a heavy-ball run whose steps
    compound those differences;
  * the feasibility checks are pure floats: exact.
"""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import censoring as j_censoring
from repro.core import simulator as j_simulator
from repro.data import edge_tasks as j_edge
from repro.data import paper_tasks as j_paper
from repro_torch import convert
from repro_torch.core import censoring, simulator
from repro_torch.data import edge_tasks, paper_tasks
from repro_torch.tree import tree_leaves

REL = 1e-12


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _params_pair(j_task, p_task, rng):
    """The init params and a random point near them, for both packages."""
    pts = [jax.tree_util.tree_map(np.asarray, j_task.init_params)]
    pts.append(jax.tree_util.tree_map(
        lambda x: x + 0.3 * rng.standard_normal(x.shape), pts[0]))
    return [(jax.tree_util.tree_map(jnp.asarray, p),
             convert.params(p, "cpu")) for p in pts]


def _check_task(j_task, p_task):
    for jx, px in zip(jax.tree_util.tree_leaves(j_task.worker_data),
                      convert.to_numpy(p_task.worker_data)):
        np.testing.assert_array_equal(px, np.asarray(jx))
    for jx, px in zip(jax.tree_util.tree_leaves(j_task.init_params),
                      convert.to_numpy(tree_leaves(p_task.init_params))):
        np.testing.assert_array_equal(px, np.asarray(jx))
    rng = np.random.default_rng(0)
    for j_params, p_params in _params_pair(j_task, p_task, rng):
        want_l = jax.vmap(j_task.loss_fn, in_axes=(None, 0))(
            j_params, j_task.worker_data)
        want_g = jax.vmap(j_task.grad_fn, in_axes=(None, 0))(
            j_params, j_task.worker_data)
        got_l = p_task.loss_fn(p_params, p_task.worker_data)
        got_g = p_task.grad_fn(p_params, p_task.worker_data)
        _close(got_l.numpy(), want_l)
        for gw, gj in zip(convert.to_numpy(tree_leaves(got_g)),
                          jax.tree_util.tree_leaves(want_g)):
            assert gw.shape == np.asarray(gj).shape
            _close(gw, gj)


def _check_bundle(j_b, p_b):
    assert p_b.L == j_b.L or (np.isnan(p_b.L) and np.isnan(j_b.L))
    np.testing.assert_array_equal(p_b.L_m, j_b.L_m)
    assert p_b.alpha_paper == j_b.alpha_paper
    assert p_b.task.name == j_b.task.name
    _check_task(j_b.task, p_b.task)


BUILDERS = [
    ("logistic", dict(m=4, n_per=20, d=6)),
    ("logistic", dict(m=9, n_per=50, d=50)),
    ("lasso", dict(m=4, n_per=20, d=6)),
    ("lasso", dict(m=9, n_per=50, d=50)),
    ("nn", dict(m=4, n_per=40, d=8, hidden=6)),
    ("nn", dict(m=3, n_per=25, d=22, hidden=30, seed=5)),
]


@pytest.mark.parametrize("kind,kw", BUILDERS)
def test_paper_task(kind, kw):
    name = {"logistic": "make_logistic_regression", "lasso": "make_lasso",
            "nn": "make_neural_network"}[kind]
    _check_bundle(getattr(j_paper, name)(**kw),
                  getattr(paper_tasks, name)(device="cpu", **kw))


@pytest.mark.parametrize("name,kind", [("housing", "linear"),
                                       ("bodyfat", "logistic"),
                                       ("abalone", "lasso"),
                                       ("derm", "nn")])
def test_standin(name, kind):
    _check_bundle(j_paper.make_standin(name, kind),
                  paper_tasks.make_standin(name, kind, device="cpu"))
    assert paper_tasks.STAND_INS == j_paper.STAND_INS


@pytest.mark.parametrize("m,n_per,d", [(5, 2, 16), (40, 3, 7)])
def test_edge_linreg(m, n_per, d):
    _check_task(j_edge.make_edge_linreg(m, n_per=n_per, d=d, seed=2),
                edge_tasks.make_edge_linreg(m, n_per=n_per, d=d, seed=2,
                                            device="cpu"))


def test_split_workers():
    rng = np.random.default_rng(1)
    x, y = rng.standard_normal((23, 4)), rng.standard_normal(23)
    for a, b in zip(paper_tasks._split_workers(x, y, 5),
                    j_paper._split_workers(x, y, 5)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("L,mu,m,delta", [(10.0, 0.1, 9, 0.5),
                                          (3.7, 0.02, 3, 0.2),
                                          (120.0, 1.5, 25, 0.9)])
def test_feasibility(L, mu, m, delta):
    want = j_censoring.theoretical_params(L, mu, m, delta=delta)
    got = censoring.theoretical_params(L, mu, m, delta=delta)
    assert (got.alpha, got.beta, got.eps1, got.rate) == \
        (want.alpha, want.beta, want.eps1, want.rate)
    for a, b, e in [(got.alpha, got.beta, got.eps1),
                    (got.alpha, got.beta, 2 * got.eps1),
                    (2 / L, 0.1, 0.0), (got.alpha, 0.99, 0.0)]:
        assert censoring.check_feasible(a, b, e, L, m) == \
            j_censoring.check_feasible(a, b, e, L, m)
    with pytest.raises(ValueError):
        censoring.theoretical_params(L, mu, m, delta=1.0)


@pytest.mark.parametrize("kind", ["linear", "nn"])
def test_estimate_fstar(kind):
    if kind == "linear":
        j_b = j_paper.make_linear_regression(m=5, n_per=30, d=20, seed=0)
        p_b = paper_tasks.make_linear_regression(m=5, n_per=30, d=20,
                                                 seed=0, device="cpu")
        alpha = j_b.alpha_paper
    else:
        j_b = j_paper.make_neural_network(m=4, n_per=40, d=8, hidden=6)
        p_b = paper_tasks.make_neural_network(m=4, n_per=40, d=8, hidden=6,
                                              device="cpu")
        alpha = 0.02
    want = float(j_simulator.estimate_fstar(j_b.task, alpha, 400))
    got = simulator.estimate_fstar(p_b.task, alpha, 400, device="cpu")
    assert got.shape == ()
    assert abs(float(got) - want) <= 1e-9 * abs(want)
