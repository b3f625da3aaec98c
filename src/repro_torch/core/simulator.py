"""Federated M-worker simulator running Algorithm 1 (port of
``repro.core.simulator``).

The JAX package jits a ``lax.scan``; here ``trajectory`` is a plain Python
step loop. Per-iteration records stay on the task's device and are
stacked once at the end, so a run on the card never waits on the host
inside the loop.

A :class:`FedTask`'s ``grad_fn``/``loss_fn`` are batched over the leading
worker axis of ``worker_data`` (``grad_fn(params, data) -> (M, ...)``,
``loss_fn(params, data) -> (M,)``): the JAX package's ``vmap`` written out.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..device import resolve_device
from ..tree import tree_leaves, tree_map


class FedTask(NamedTuple):
    """A distributed problem f(theta) = sum_m f_m(theta).

    ``worker_data`` is a tuple of tensors stacked with leading axis M.
    """
    init_params: Any
    grad_fn: Callable[[Any, Any], Any]            # (params, data) -> (M, ...)
    loss_fn: Callable[[Any, Any], torch.Tensor]   # (params, data) -> (M,)
    worker_data: Any
    name: str = "task"


class History(NamedTuple):
    """Per-iteration trajectory of one Algorithm-1 run.

    Attributes:
      objective: (K,) f(theta^k) recorded before iteration k's update.
      comm_cum: (K,) cumulative uplink transmissions after iteration k.
      mask: (K, M) per-iteration transmit indicators.
      agg_grad_sqnorm: (K,) ||sum_m ghat_m^k||^2 on the post-update bank.
      final_params: theta^K.
      final_state: the ``opt.OptState`` after iteration K (its
        ``CommStats`` holds the exact uplink counts and bytes).
      metrics: always ``()`` (metric collection is not ported yet).
    """
    objective: torch.Tensor
    comm_cum: torch.Tensor
    mask: torch.Tensor
    agg_grad_sqnorm: torch.Tensor
    final_params: Any
    final_state: Any
    metrics: Any = ()


def task_to(task: FedTask, device=None, dtype=None) -> FedTask:
    """The task with its tensors moved to ``device`` and, if given, its
    floating tensors cast to ``dtype``."""
    def move(x):
        if dtype is not None and x.is_floating_point():
            x = x.to(dtype)
        return x.to(device) if device is not None else x
    return task._replace(init_params=tree_map(move, task.init_params),
                         worker_data=tree_map(move, task.worker_data))


def global_loss(task: FedTask, params) -> torch.Tensor:
    """f(theta) = sum_m f_m(theta)."""
    return torch.sum(task.loss_fn(params, task.worker_data))


def trajectory(opt, task: FedTask, num_iters: int) -> History:
    """Run ``num_iters`` iterations of Algorithm 1 on the task's device."""
    params = task.init_params
    state = opt.init(params)
    objs, comms, masks, gsqs = [], [], [], []
    for _ in range(num_iters):
        grads = task.grad_fn(params, task.worker_data)
        objs.append(global_loss(task, params))
        state, params, info = opt.step(state, params, grads)
        comms.append(state.comm.total_uplinks)
        masks.append(info.mask)
        gsqs.append(info.agg_grad_sqnorm)
    return History(objective=torch.stack(objs), comm_cum=torch.stack(comms),
                   mask=torch.stack(masks),
                   agg_grad_sqnorm=torch.stack(gsqs),
                   final_params=params, final_state=state)


def run(opt, task: FedTask, num_iters: int, device=None) -> History:
    """Run Algorithm 1 for ``num_iters`` iterations on one configuration.

    Args:
      opt: a ``repro_torch.opt`` optimizer (anything with init/step).
      task: the distributed problem; its tensors are moved to ``device``.
      num_iters: number of server iterations K.
      device: ``None`` runs on CUDA and raises without it; ``"cpu"`` is
        the explicit CPU opt-in.
    """
    dev = resolve_device(device)
    if num_iters < 1:
        raise ValueError("num_iters must be >= 1")
    return trajectory(opt, task_to(task, dev), num_iters)


def estimate_fstar(task: FedTask, alpha: float, num_iters: int = 20000,
                   beta: float = 0.9, device=None) -> torch.Tensor:
    """Estimate f(theta^*) by running uncensored heavy ball to convergence:
    the min of the recorded objective and the final loss (a 0-d tensor)."""
    from ..opt.censor import NeverCensor
    from ..opt.optimizer import ComposedOptimizer
    from ..opt.server import HeavyBall
    from ..opt.transport import DenseTransport
    m = tree_leaves(task.worker_data)[0].shape[0]
    opt = ComposedOptimizer(censor=NeverCensor(), transport=DenseTransport(),
                            server=HeavyBall(alpha, beta), num_workers=m)
    dev = resolve_device(device)
    task = task_to(task, dev)
    hist = trajectory(opt, task, num_iters)
    return torch.minimum(torch.min(hist.objective),
                         global_loss(task, hist.final_params))


def iterations_to_accuracy(history: History, fstar, tol: float) -> int:
    """First iteration k with f(theta^k) - f* < tol, or -1."""
    hit = torch.nonzero(history.objective - fstar < tol)
    return int(hit[0, 0]) if hit.numel() else -1


def comms_to_accuracy(history: History, fstar, tol: float) -> int:
    """Cumulative uplink communications when accuracy tol is first reached."""
    k = iterations_to_accuracy(history, fstar, tol)
    if k < 0:
        return -1
    return int(history.comm_cum[k])
