"""Per-round metric collection: the ``MetricBag`` and its collectors (port
of ``repro.obs.metrics``).

A **MetricBag** is a flat ``dict[str, torch.Tensor]`` of named 0-d
observables for one round. ``simulator.trajectory(collect_metrics=True)``
stacks the bags of a run into ``{name: (K,) tensor}`` series.

Collection is read-only: every entry is computed from the state and step
stats the run already produced and never fed back, so a metrics-on run is
bit-identical to a metrics-off one and launches the same kernels. The
norms here (``bank_sqnorm`` and the stage hooks') are plain PyTorch on
either backend: one more read of the bank, with no kernel launch.

Two layers, with the JAX package's keys and dtypes:

  * base metrics (:func:`step_metrics`): ``censor_rate`` and
    ``transmit_rate`` (f32 means of the mask), ``agg_grad_sqnorm``,
    ``step_sqnorm``, ``delta_sqnorm_mean``, ``bank_sqnorm`` (f32), and
    ``CommStats.metrics()`` (``comm/uplink_total``, exact
    ``comm/uplink_bytes`` in f64, ``comm/downlink_count``,
    ``comm/iterations``);
  * stage metrics (:func:`stage_metrics`): each censor, transport and
    server ``metrics`` hook, namespaced by the stage's registry kind
    (``censor/eq8/eps1``, ``transport/int8/ef_residual_sqnorm``,
    ``server/hb/alpha``).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..core.util import tree_sqnorm
from ..tree import tree_leaves

#: One round's named scalar observables (a flat dict of 0-d tensors).
MetricBag = Dict[str, torch.Tensor]


def _stage_kind(stage, table: dict[str, type]) -> str:
    """Registry kind of a stage, falling back to its lowercased class."""
    for kind, cls in table.items():
        if type(stage) is cls:
            return kind
    return type(stage).__name__.lower()


def stage_metrics(opt, state) -> MetricBag:
    """The stage-hook half of the bag, keys namespaced by registry kind.

    Each stage's ``metrics`` hook gets its own slice of the state (censor
    state, transport state, nothing); a stage without the hook adds
    nothing. Values land on the bank's device.
    """
    from ..opt.registry import CENSOR_KINDS, SERVER_KINDS, TRANSPORT_KINDS
    device = tree_leaves(state.ghat)[0].device
    bag: MetricBag = {}
    for stage, table, ns, arg in (
            (opt.censor, CENSOR_KINDS, "censor", (state.censor,)),
            (opt.transport, TRANSPORT_KINDS, "transport", (state.err,)),
            (opt.server, SERVER_KINDS, "server", ())):
        hook = getattr(stage, "metrics", None)
        if hook is None:
            continue
        kind = _stage_kind(stage, table)
        for k, v in hook(*arg).items():
            bag[f"{ns}/{kind}/{k}"] = torch.as_tensor(v, device=device)
    return bag


def step_metrics(opt, state, stats) -> MetricBag:
    """The full per-round bag of one composed step.

    Args:
      opt: the ``ComposedOptimizer`` (or anything with the three stage
        attributes) that made the step.
      state: the post-step ``OptState``.
      stats: the step's ``StepStats``.
    """
    mask = stats.mask.to(torch.float32)
    bag: MetricBag = {
        "censor_rate": 1.0 - torch.mean(mask),
        "transmit_rate": torch.mean(mask),
        "agg_grad_sqnorm": stats.agg_grad_sqnorm,
        "step_sqnorm": stats.step_sq,
        "delta_sqnorm_mean": torch.mean(stats.delta_sq),
        "bank_sqnorm": tree_sqnorm(state.ghat),
    }
    bag.update(state.comm.metrics())
    bag.update(stage_metrics(opt, state))
    return bag


def merge_shard_bags(bags, weights=None) -> MetricBag:
    """Fold per-shard MetricBags into one cohort-level bag.

    Merge rule per key, by suffix: ``*rate`` / ``*mean`` a weighted mean
    (uniform weights by default; pass per-shard worker counts for uneven
    shards), ``*max`` the max, ``*min`` the min, anything else the sum.
    Cross-shard observables that do not add (``agg_grad_sqnorm``) are the
    caller's to overwrite with the post-fold value.
    """
    bags = list(bags)
    if not bags:
        return {}
    if weights is None:
        weights = [1.0] * len(bags)
    total_w = sum(weights)
    out: MetricBag = {}
    for key in bags[0]:
        vals = [b[key] for b in bags]
        if key.endswith("rate") or key.endswith("mean"):
            out[key] = sum(w * v for w, v in zip(weights, vals)) / total_w
        elif key.endswith("max"):
            out[key] = torch.stack([torch.as_tensor(v) for v in vals]).max()
        elif key.endswith("min"):
            out[key] = torch.stack([torch.as_tensor(v) for v in vals]).min()
        else:
            out[key] = sum(vals)
    return out


def metric_names(opt, params) -> tuple[str, ...]:
    """The bag's sorted key set for a composition, from the iteration-0
    state (one small evaluation; no step runs and no kernel launches)."""
    from ..opt.api import StepStats
    state = opt.init(params)
    m = opt.num_workers
    device = tree_leaves(state.ghat)[0].device
    stats = StepStats(
        mask=torch.ones((m,), dtype=torch.float32, device=device),
        delta_sq=torch.zeros((m,), dtype=torch.float32, device=device),
        step_sq=torch.zeros((), dtype=torch.float32, device=device),
        agg_grad_sqnorm=torch.zeros((), dtype=torch.float32, device=device))
    return tuple(sorted(step_metrics(opt, state, stats)))


def summarize(series: Any, reducer=None) -> dict[str, float]:
    """Collapse a stacked ``{name: (K,) series}`` bag to host floats: the
    last round's value by default (cumulative metrics), or
    ``reducer(array)`` (``np.mean`` for rate-like series)."""
    out = {}
    for k, v in series.items():
        arr = v.cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
        out[k] = float(reducer(arr) if reducer is not None else arr[-1])
    return out
