"""CHB at datacenter scale: the scan training strategy and the server-side
fold of the sharded federated runtime (port of ``repro.core.distributed``).

scan strategy
-------------
Federated workers are M logical batch groups. A loop over the workers
takes each worker's gradient of the whole model on its own chunk of the
batch (autograd) and writes it into row m of a per-leaf (M, ...) gradient
bank. Then the step is the optimizer's own step on that bank
(``opt.ComposedOptimizer.step``), so the scan strategy and the simulator
share one implementation. On ``backend="cuda"`` (``_step_kernels``) it
runs, per leaf, B1 (``censor_delta_sqnorm_batched``: the eq.-(8) norms
||g_m - ghat_m||^2, summed over the leaves), the decision
``dsq > eps1 * ssq``, then B2 (``fused_dense_step``: bank advance, worker
sum and the eq.-(4) heavy-ball update in one pass); under
``quantize="int8"`` B5 (``int8_stats_batched``) and B6
(``fused_int8_step``). On ``"reference"`` (``_step``) the plain stage
calls. The JAX package folds each worker into the aggregate inside its
``lax.scan``; the values are the same, the worker sum here is a left fold
from ghat'_0.

The JAX module's pod strategy (workers are pods; the only cross-pod
collective is the censored ``psum`` of eq. (5)) needs one process a card
and ``torch.distributed``: ``init_pod_state`` and ``make_pod_step`` raise
``NotImplementedError`` (ROADMAP.md A13).

make_client_fold
----------------
The JAX package folds the K shard partials with one ``psum`` over the
``("clients",)`` mesh axis. Here the runtime is single-controller, so the
fold is a left fold on the server device, in shard order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from .accounting import CommStats

POD_TODO = ("the pod strategy (one process a card over torch.distributed) "
            "is not ported yet (ROADMAP.md A13)")


class DistFedState(NamedTuple):
    prev_params: Any
    ghat: Any          # scan: (M, ...) stacked
    nabla: Any         # pod strategy only: eq.(5) server aggregate (else ())
    err: Any           # quantization error feedback (or ())
    comm: CommStats
    step: torch.Tensor


def _check_realizable(cfg) -> None:
    """The scan strategy realizes censoring as ``dsq > eps1 * ssq`` only,
    with dense or int8 uploads. Refuse any other censor policy or
    transport loudly instead of running it uncensored or uncompressed."""
    censor = getattr(cfg, "censor", None)
    if censor is not None:
        from ..opt.censor import Eq8Censor, NeverCensor
        if not isinstance(censor, (Eq8Censor, NeverCensor)):
            raise NotImplementedError(
                f"censor policy {type(censor).__name__} is not realizable "
                "by the scan/pod training strategies (eq.-8 / uncensored "
                "only); run it through core.simulator or repro_torch.fed "
                "instead")
    if cfg.quantize not in (None, "int8"):
        raise NotImplementedError(f"transport {cfg.quantize!r}: the scan "
                                  "strategy carries dense and int8 uploads")


# ============================================================ scan strategy
def init_scan_state(cfg, params) -> DistFedState:
    """Zero banks (M, ...) of every leaf, a copy of params as the momentum
    anchor, zero counters; all on the params' device."""
    device = tree_leaves(params)[0].device
    bank = tree_map(lambda x: torch.zeros(
        (cfg.num_workers,) + tuple(x.shape), dtype=cfg.bank_dtype or x.dtype,
        device=x.device), params)
    err = tree_map(torch.zeros_like, bank) if cfg.quantize else ()
    # a copy: prev_params must not alias params
    prev = tree_map(torch.clone, params)
    return DistFedState(prev_params=prev, ghat=bank, nabla=(), err=err,
                        comm=CommStats.init(cfg.num_workers, device=device),
                        step=torch.zeros((), dtype=torch.int32,
                                         device=device))


def _worker_grads(loss_fn, leaves, treedef, batch, banks):
    """Each worker's loss and gradient: the gradient of worker m's chunk
    written into row m of a per-leaf (M, ...) bank in the bank's dtype.
    Returns (the f32 sum of the workers' losses, the gradient banks)."""
    m_workers = banks[0].shape[0]
    grads = [torch.empty_like(h) for h in banks]
    loss_sum = torch.zeros((), dtype=torch.float32, device=banks[0].device)
    for m in range(m_workers):
        with torch.enable_grad():
            wrt = [p.detach().requires_grad_(True) for p in leaves]
            loss = loss_fn(tree_unflatten(treedef, wrt),
                           {key: val[m] for key, val in batch.items()})
            g = torch.autograd.grad(loss, wrt)
        with torch.no_grad():
            for bank, gl in zip(grads, g):
                bank[m].copy_(gl)
        # the JAX scan's f32 fold of the workers' losses, from 0
        loss_sum = loss_sum + loss.detach().to(torch.float32)
        del g, loss, wrt
    return loss_sum, grads


def make_scan_step(cfg, loss_fn: Callable[[Any, Any], torch.Tensor], *,
                   backend: str = "cuda"):
    """Build train_step(params, state, batch) -> (params, state, metrics)
    for the scan strategy.

    cfg: the ``opt.ComposedOptimizer`` that ``train.trainer.make_optimizer``
    builds. loss_fn(params, worker_batch) -> scalar loss for ONE worker's
    chunk; batch: a dict of tensors with leading axis M (worker chunks).
    After the gradient bank, the step is ``cfg.step`` on ``backend``. The
    metrics are the JAX package's: loss (the workers' mean), transmitted,
    step_sqnorm and agg_grad_sqnorm, f32 tensors on the device (nothing is
    read to the host here).
    """
    from ..opt.api import OptState
    _check_realizable(cfg)
    o = dataclasses.replace(cfg, backend=backend)

    def train_step(params, state: DistFedState, batch):
        leaves, treedef = tree_flatten(params)
        loss_sum, grads = _worker_grads(loss_fn, leaves, treedef, batch,
                                        tree_leaves(state.ghat))
        with torch.no_grad():
            new, new_params, stats = o.step(
                OptState(prev_params=state.prev_params, ghat=state.ghat,
                         err=state.err, comm=state.comm, censor=()),
                params, tree_unflatten(treedef, grads))
        del grads
        new_state = DistFedState(prev_params=new.prev_params, ghat=new.ghat,
                                 nabla=(), err=new.err, comm=new.comm,
                                 step=state.step + 1)
        metrics = {"loss": loss_sum / o.num_workers,
                   "transmitted": torch.sum(stats.mask),
                   "step_sqnorm": stats.step_sq,
                   "agg_grad_sqnorm": stats.agg_grad_sqnorm}
        return new_params, new_state, metrics

    return train_step


# ============================================================= pod strategy
def init_pod_state(cfg, params, mesh) -> DistFedState:
    raise NotImplementedError(f"init_pod_state: {POD_TODO}")


def make_pod_step(cfg, loss_fn, mesh):
    raise NotImplementedError(f"make_pod_step: {POD_TODO}")


# ============================================================ client fold
def make_client_fold(mesh, axis: str = "clients"):
    """Build the server-side fold for a client mesh.

    The fold takes a tree whose leaves are ``(K, ...)`` stacks of per-shard
    partials on the server device (one row a shard, assembled with
    ``launch.sharding.stack_shards``) and returns each leaf's total: the
    rows folded left to right in shard order, a float leaf from -0.0 and an
    integer leaf from 0. As -0.0 + x is x for every x, the fold over one
    shard is the identity, bit for bit, which the sync anchor needs.
    """
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no {axis!r} axis: {mesh.axis_names}")
    k = mesh.size

    def fold_leaf(v: torch.Tensor) -> torch.Tensor:
        if v.shape[0] != k:
            raise ValueError(f"the client fold takes {k} shard rows, got "
                             f"{v.shape[0]}")
        acc = torch.full(v.shape[1:], -0.0 if v.is_floating_point() else 0,
                         dtype=v.dtype, device=v.device)
        for row in v:
            acc = acc + row
        return acc

    def fold(stacked):
        return tree_map(fold_leaf, stacked)

    return fold
