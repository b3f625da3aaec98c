"""The paper's experiment tasks (port of ``repro.data.paper_tasks``):
linear / logistic / lasso regression and a 1-hidden-layer neural network,
distributed over M workers, and the dataset-shaped synthetic stand-ins.

The data come from the same ``numpy.random.default_rng(seed)`` draws in
the same order as the JAX builders, so both packages see identical
inputs; the network's initial weights come from the JAX PRNG
(``repro_torch.random``). Each task's ``grad_fn`` and ``loss_fn`` take all
M workers at once; the gradients are written out by hand where JAX takes
``jax.grad``.

The event runtime evaluates one worker's gradient at a time, the
simulator all M at once, and its sync anchor wants the same bits. The
tasks with a ``sigmoid`` (logistic, the network) run their batched
gradient on one worker's slice at a time: PyTorch's CPU kernels evaluate
it differently in their vector body and scalar tail, where a worker's
samples land depending on M. Linear regression and lasso keep one
batched product, whose f64 rows on the CPU do not depend on M (their f32
rows do, and so may a product's on CUDA, where cuBLAS picks its algorithm
by the batch's size).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from .. import random as jrandom
from ..core.simulator import FedTask
from ..device import resolve_device
from ..tree import tree_leaves


def _split_workers(x: np.ndarray, y: np.ndarray, m: int):
    n = (x.shape[0] // m) * m
    xs = x[:n].reshape(m, n // m, x.shape[1])
    ys = y[:n].reshape(m, n // m)
    return xs, ys


def _rescale_to_smoothness(x: np.ndarray, target_hess_lmax: float
                           ) -> np.ndarray:
    """Scale X so that lambda_max(X^T X) == target_hess_lmax."""
    lmax = float(np.linalg.eigvalsh(x.T @ x)[-1])
    return x * np.sqrt(target_hess_lmax / lmax)


def _features(rng, n: int, d: int, condition: float) -> np.ndarray:
    """Gaussian features with a geometric per-column scale."""
    x = rng.standard_normal((n, d))
    if condition > 1.0:
        scale = condition ** (-np.arange(d) / max(d - 1, 1))
        x = x * scale[None, :]
    return x


@dataclasses.dataclass
class TaskBundle:
    task: FedTask
    L: float                 # global smoothness constant of f = sum_m f_m
    L_m: np.ndarray          # (M,) per-worker smoothness constants
    alpha_paper: float       # the step size the paper uses for this setup


def _linreg_loss(theta, data):
    x, y = data
    r = x @ theta - y
    return 0.5 * torch.sum(r * r, dim=1)


def _linreg_grad(theta, data):
    """All M workers' ``X_m^T (X_m theta - y_m)`` in one batched product."""
    x, y = data
    r = x @ theta - y
    return (x.transpose(1, 2) @ r.unsqueeze(-1)).squeeze(-1)


def make_linear_regression(m: int = 9, n_per: int = 50, d: int = 50,
                           worker_L: Sequence[float] | None = None,
                           seed: int = 0, condition: float = 1.0,
                           device=None,
                           dtype: torch.dtype = torch.float64
                           ) -> TaskBundle:
    """f_m(theta) = 0.5 ||X_m theta - y_m||^2.

    Default worker smoothness follows the paper's Fig. 1/2 setting
    L_m = (1.3^(m-1))^2. ``grad_fn`` is ``X_m^T (X_m theta - y_m)``.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if worker_L is None:
        worker_L = [(1.3 ** i) ** 2 for i in range(m)]
    xs, X, Y = _regression_data(rng, m, n_per, d, worker_L, condition,
                                lambda lm: lm)     # X (M, n, d), Y (M, n)
    H = sum(x.T @ x for x in xs)
    L = float(np.linalg.eigvalsh(H)[-1])
    task = FedTask(
        init_params=torch.zeros((d,), dtype=dtype, device=dev),
        grad_fn=_linreg_grad,
        loss_fn=_linreg_loss,
        worker_data=_worker_data(X, Y, dtype, dev),
        name="linear_regression")
    return TaskBundle(task=task, L=L, L_m=np.asarray(worker_L),
                      alpha_paper=1.0 / L)


def _per_worker(grad_fn, params, data):
    """``grad_fn`` (batched over the workers) called on one worker's
    (1, ...) slice at a time, the results concatenated."""
    m = data[0].shape[0]
    outs = [grad_fn(params, tuple(t[k:k + 1] for t in data))
            for k in range(m)]
    if isinstance(outs[0], dict):
        return {key: torch.cat([o[key] for o in outs]) for key in outs[0]}
    return torch.cat(outs)


def _worker_data(X, Y, dtype, dev):
    return (torch.as_tensor(X, dtype=dtype, device=dev),
            torch.as_tensor(Y, dtype=dtype, device=dev))


def _regression_data(rng, m, n_per, d, worker_L, condition, target):
    """The per-worker (labels, features) draws of the regression builders:
    ``target(L_m)`` is the lambda_max each worker's features scale to."""
    xs, ys = [], []
    for i in range(m):
        y = rng.choice([-1.0, 1.0], size=n_per)
        x = _rescale_to_smoothness(_features(rng, n_per, d, condition),
                                   target(worker_L[i]))
        xs.append(x)
        ys.append(y)
    return xs, np.stack(xs), np.stack(ys)


# ----------------------------------------------------- logistic regression
def make_logistic_regression(m: int = 9, n_per: int = 50, d: int = 50,
                             worker_L: Sequence[float] | None = None,
                             reg: float = 0.001, seed: int = 1,
                             condition: float = 25.0, device=None,
                             dtype: torch.dtype = torch.float64
                             ) -> TaskBundle:
    """f_m = sum_n log(1+exp(-y x.theta)) + (reg/(2M))||theta||^2.

    Default: the paper's Fig. 3 setting with common L_1=..=L_9=4. The
    gradient is ``X_m^T (-y * sigmoid(z)) + (reg/M) theta`` with
    ``z = -y * X_m theta``.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if worker_L is None:
        worker_L = [4.0] * m
    # logistic Hessian bound: X^T X / 4 (+ reg/M); rescale the data term
    xs, X, Y = _regression_data(rng, m, n_per, d, worker_L, condition,
                                lambda lm: 4.0 * (lm - reg / m))
    H = sum(x.T @ x for x in xs) / 4.0
    L = float(np.linalg.eigvalsh(H)[-1]) + reg

    def loss_fn(theta, data):
        x, y = data
        z = -y * (x @ theta)
        return torch.sum(torch.logaddexp(torch.zeros_like(z), z), dim=1) \
            + reg / (2.0 * m) * torch.sum(theta * theta)

    def grad_fn(theta, data):
        x, y = data
        r = -y * torch.sigmoid(-y * (x @ theta))
        return (x.transpose(1, 2) @ r.unsqueeze(-1)).squeeze(-1) \
            + reg / m * theta

    task = FedTask(init_params=torch.zeros((d,), dtype=dtype, device=dev),
                   grad_fn=functools.partial(_per_worker, grad_fn),
                   loss_fn=loss_fn,
                   worker_data=_worker_data(X, Y, dtype, dev),
                   name="logistic_regression")
    return TaskBundle(task=task, L=L, L_m=np.asarray(worker_L),
                      alpha_paper=1.0 / L)


# ----------------------------------------------------------- lasso (subgrad)
def make_lasso(m: int = 9, n_per: int = 50, d: int = 50,
               reg: float = 0.5, seed: int = 2,
               worker_L: Sequence[float] | None = None,
               condition: float = 6.0, device=None,
               dtype: torch.dtype = torch.float64) -> TaskBundle:
    """f_m = 0.5||X_m theta - y||^2 + (reg/M)||theta||_1, subgradient used."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if worker_L is None:
        worker_L = [(1.2 ** i) ** 2 for i in range(m)]
    xs, X, Y = _regression_data(rng, m, n_per, d, worker_L, condition,
                                lambda lm: lm)
    H = sum(x.T @ x for x in xs)
    L = float(np.linalg.eigvalsh(H)[-1])

    def loss_fn(theta, data):
        return _linreg_loss(theta, data) \
            + reg / m * torch.sum(torch.abs(theta))

    def grad_fn(theta, data):  # subgradient
        return _linreg_grad(theta, data) + reg / m * torch.sign(theta)

    task = FedTask(init_params=torch.zeros((d,), dtype=dtype, device=dev),
                   grad_fn=grad_fn,
                   loss_fn=loss_fn,
                   worker_data=_worker_data(X, Y, dtype, dev), name="lasso")
    return TaskBundle(task=task, L=L, L_m=np.asarray(worker_L),
                      alpha_paper=1.0 / L)


# ------------------------------------------------- 1-hidden-layer NN (paper)
def make_neural_network(m: int = 9, n_per: int = 200, d: int = 22,
                        hidden: int = 30, reg: float | None = None,
                        seed: int = 3, device=None,
                        dtype: torch.dtype = torch.float64) -> TaskBundle:
    """The paper's nonconvex task: one hidden layer, 30 nodes, sigmoid.

    Binary labels; sigmoid output with squared loss + L2 regularization.
    The weights are the JAX package's draws under x64:
    ``split(PRNGKey(seed))`` then f64 ``normal`` scaled by ``1/sqrt(d)``
    and ``1/sqrt(hidden)``, cast to ``dtype``. Backpropagation is written
    out.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_total = m * n_per
    if reg is None:
        reg = 1.0 / n_total
    w_true = rng.standard_normal((d,))
    X = rng.standard_normal((n_total, d))
    Y = (np.tanh(X @ w_true) + 0.1 * rng.standard_normal(n_total) > 0)
    Y = Y.astype(np.float64)
    Xs, Ys = _split_workers(X, Y, m)

    k1, k2 = jrandom.split(jrandom.PRNGKey(seed, device=dev))
    params = {
        "w1": (jrandom.normal(k1, (d, hidden), torch.float64)
               * (1.0 / np.sqrt(d))).to(dtype),
        "b1": torch.zeros((hidden,), dtype=dtype, device=dev),
        "w2": (jrandom.normal(k2, (hidden, 1), torch.float64)
               * (1.0 / np.sqrt(hidden))).to(dtype),
        "b2": torch.zeros((1,), dtype=dtype, device=dev),
    }

    def forward(p, x):
        h = torch.sigmoid(x @ p["w1"] + p["b1"])
        return h, torch.sigmoid(h @ p["w2"] + p["b2"])[..., 0]

    def l2(p):
        return sum(torch.sum(v * v) for v in tree_leaves(p))

    def loss_fn(p, data):
        x, y = data
        _, out = forward(p, x)
        return torch.sum((out - y) ** 2, dim=1) + reg / (2.0 * m) * l2(p)

    def grad_fn(p, data):
        x, y = data
        h, out = forward(p, x)
        d_a2 = 2.0 * (out - y) * out * (1.0 - out)              # (M, n)
        d_a1 = d_a2[..., None] * p["w2"][:, 0] * h * (1.0 - h)   # (M, n, H)
        grads = {"w1": x.transpose(1, 2) @ d_a1,
                 "b1": torch.sum(d_a1, dim=1),
                 "w2": h.transpose(1, 2) @ d_a2[..., None],
                 "b2": torch.sum(d_a2, dim=1, keepdim=True)}
        return {k: g + reg / m * p[k] for k, g in grads.items()}

    task = FedTask(init_params=params,
                   grad_fn=functools.partial(_per_worker, grad_fn),
                   loss_fn=loss_fn,
                   worker_data=_worker_data(Xs, Ys, dtype, dev),
                   name="neural_network")
    # nonconvex: no meaningful global L
    return TaskBundle(task=task, L=float("nan"),
                      L_m=np.full((m,), np.nan), alpha_paper=0.02)


# ------------------------------------------- dataset-shaped synthetic stand-ins
STAND_INS = {
    # name: (n_samples, n_features, paper_workers)
    "ijcnn1": (49990, 22, 9),
    "mnist": (60000, 196, 9),     # 196 = 14x14 downsample scale
    "housing": (506, 13, 3),
    "bodyfat": (252, 14, 3),
    "abalone": (4177, 8, 3),
    "ionosphere": (351, 33, 3),
    "adult": (1605, 14, 3),
    "derm": (366, 34, 3),
}


def make_standin(name: str, kind: str, seed: int = 7, **kw) -> TaskBundle:
    """Synthetic stand-in with a real dataset's (n, d, M) signature."""
    n, d, m = STAND_INS[name]
    n_per = n // m
    mk = {"linear": make_linear_regression,
          "logistic": make_logistic_regression,
          "lasso": make_lasso,
          "nn": make_neural_network}[kind]
    if kind == "nn":
        return mk(m=m, n_per=min(n_per, 400), d=d, seed=seed, **kw)
    # ill-conditioning matched to the paper's iteration counts
    condition = {"linear": 8.0, "logistic": 30.0, "lasso": 8.0}[kind]
    bundle = mk(m=m, n_per=min(n_per, 800), d=d, seed=seed,
                condition=condition,
                worker_L=[4.0 * (1.25 ** i) for i in range(m)], **kw)
    return dataclasses.replace(bundle, task=bundle.task._replace(
        name=f"{name}_{kind}"))
