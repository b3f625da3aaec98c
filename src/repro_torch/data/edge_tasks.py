"""Vectorized edge-client tasks (port of ``repro.data.edge_tasks``).

  * :func:`make_edge_quadratics` -- ``f_m(theta) = 0.5 * a_m *
    ||theta - c_m||^2`` with O(M*d) memory and a closed-form optimum.
  * :func:`make_edge_linreg` -- per-client least squares with shared
    feature statistics, O(M*n*d) memory.

The data are the JAX builders' numpy draws. For the quadratics ``dtype``
casts the centers on the way to the device in blocks of rows of at most
64 MB of f64, so a full-width f32 task never holds an f64 copy of the
center bank on the card, and 10^5 clients take a few copies, not one a
row.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.simulator import FedTask
from ..device import resolve_device
from .paper_tasks import _linreg_grad, _linreg_loss

#: f64 bytes of the centers copied to the device at a time
COPY_BLOCK_BYTES = 64 << 20


def _quad_loss(theta, data):
    a, c = data
    r = theta - c
    return 0.5 * a * torch.sum(r * r, dim=1)


def _quad_grad(theta, data):
    a, c = data
    return a[:, None] * (theta - c)


def make_edge_quadratics(m: int, d: int = 16, seed: int = 0,
                         hetero: float = 3.0, device=None,
                         dtype: torch.dtype = torch.float64) -> FedTask:
    """f_m(theta) = 0.5 * a_m * ||theta - c_m||^2 for M clients.

    Args:
      m: client count.
      d: parameter dimension.
      seed: numpy seed for centers and curvatures.
      hetero: ``a_m`` is log-uniform over ``[1, hetero]``.
      device: ``None`` -> CUDA (raises without it); ``"cpu"`` explicit.
      dtype: floating dtype of the task's tensors on ``device``.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(m, d)).astype(np.float64)
    curv = np.exp(rng.uniform(0.0, np.log(max(hetero, 1.0)), size=(m,)))
    c = torch.empty((m, d), dtype=dtype, device=dev)
    rows = max(1, COPY_BLOCK_BYTES // (8 * max(d, 1)))
    for i in range(0, m, rows):
        c[i:i + rows].copy_(torch.from_numpy(centers[i:i + rows]))
    return FedTask(init_params=torch.zeros((d,), dtype=dtype, device=dev),
                   grad_fn=_quad_grad, loss_fn=_quad_loss,
                   worker_data=(torch.as_tensor(curv, dtype=dtype,
                                                device=dev), c),
                   name=f"edge_quadratics_m{m}")


def edge_quadratics_fstar(task: FedTask) -> float:
    """Closed-form optimum of :func:`make_edge_quadratics`, in f64.

    theta* is the a-weighted center mean. Computed on the task's device
    one worker row at a time, so a full-width task needs two f64 rows of
    scratch, not an f64 copy of the whole center bank.
    """
    a, c = task.worker_data
    a64 = a.to(torch.float64)
    theta_star = torch.zeros(c.shape[1], dtype=torch.float64,
                             device=c.device)
    for i in range(c.shape[0]):
        theta_star += a64[i] * c[i].to(torch.float64)
    theta_star /= a64.sum()
    fstar = 0.0
    for i in range(c.shape[0]):
        r = theta_star - c[i].to(torch.float64)
        fstar += 0.5 * float(a64[i]) * float(torch.sum(r * r))
    return fstar


def make_edge_linreg(m: int, n_per: int = 2, d: int = 16, seed: int = 0,
                     label_noise: float = 0.1, device=None,
                     dtype: torch.dtype = torch.float64) -> FedTask:
    """Vectorized per-client least squares: f_m = 0.5||X_m theta - y_m||^2.

    One ``(m, n_per, d)`` normal draw scaled by ``1/sqrt(d)`` and one
    shared ground-truth theta with per-client label noise; pick the step
    size as ``1 / (m * n_per)`` to stay stable at any M. The gradient is
    one batched product for all M clients (a loop would be M launches at
    10^5 clients), so on CUDA one client's gradient alone may differ from
    its row of the batched one in the last bits: cuBLAS picks its
    algorithm by the batch's size.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, n_per, d)).astype(np.float64) / np.sqrt(d)
    theta_true = rng.normal(size=(d,))
    y = x @ theta_true + label_noise * rng.normal(size=(m, n_per))
    return FedTask(init_params=torch.zeros((d,), dtype=dtype, device=dev),
                   grad_fn=_linreg_grad, loss_fn=_linreg_loss,
                   worker_data=(torch.as_tensor(x, dtype=dtype, device=dev),
                                torch.as_tensor(y, dtype=dtype, device=dev)),
                   name=f"edge_linreg_m{m}")
