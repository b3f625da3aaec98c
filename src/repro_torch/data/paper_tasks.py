"""The paper's linear-regression task (port of ``repro.data.paper_tasks``).

The data come from the same ``numpy.random.default_rng(seed)`` draws in
the same order as the JAX builder, so both packages see identical inputs.
Logistic regression, lasso and the neural-network task are not ported
yet.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..core.simulator import FedTask
from ..device import resolve_device


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
    L_m = (1.3^(m-1))^2. ``grad_fn`` is ``X_m^T (X_m theta - y_m)`` for
    every worker at once.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if worker_L is None:
        worker_L = [(1.3 ** i) ** 2 for i in range(m)]
    xs, ys = [], []
    for i in range(m):
        y = rng.choice([-1.0, 1.0], size=n_per)
        x = _features(rng, n_per, d, condition)
        x = _rescale_to_smoothness(x, worker_L[i])
        xs.append(x)
        ys.append(y)
    X = np.stack(xs)    # (M, n, d)
    Y = np.stack(ys)    # (M, n)
    H = sum(x.T @ x for x in xs)
    L = float(np.linalg.eigvalsh(H)[-1])
    task = FedTask(
        init_params=torch.zeros((d,), dtype=dtype, device=dev),
        grad_fn=_linreg_grad, loss_fn=_linreg_loss,
        worker_data=(torch.as_tensor(X, dtype=dtype, device=dev),
                     torch.as_tensor(Y, dtype=dtype, device=dev)),
        name="linear_regression")
    return TaskBundle(task=task, L=L, L_m=np.asarray(worker_L),
                      alpha_paper=1.0 / L)
