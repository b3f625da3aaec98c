"""Carry state across from the JAX package.

The JAX package's parameters and ``OptState``, given as numpy arrays (for
example ``jax.tree_util.tree_map(np.asarray, state)``), become this
package's tensors on a given device, so both packages can step from one
state. :func:`to_numpy` goes the other way for comparisons;
:func:`prng_key` carries a JAX PRNG key across and :func:`edge_history`
takes an ``EdgeHistory`` of either package to numpy.
:func:`model_params` carries a JAX model's weights across, checked against
this package's parameter tree, and :func:`numpy_model_params` makes one
set of weights from a numpy seed that both packages can load.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.accounting import CommStats
from .opt.api import OptState
from .tree import tree_map

BF16_TODO = ("bf16 model weights are not ported yet (ROADMAP.md A13, bf16 "
             "configs)")


def params(tree, device) -> object:
    """A tree of numpy arrays (dicts / tuples / lists) as tensors."""
    return tree_map(lambda x: torch.tensor(np.asarray(x), device=device), tree)


def comm_stats(comm, device) -> CommStats:
    """A JAX ``CommStats`` (numpy fields) as this package's int32 counters."""
    return CommStats(*(torch.tensor(np.asarray(getattr(comm, f)),
                                    dtype=torch.int32, device=device)
                       for f in CommStats._fields))


def opt_state(state, device) -> OptState:
    """A JAX ``OptState`` with numpy leaves as this package's ``OptState``."""
    return OptState(prev_params=params(state.prev_params, device),
                    ghat=params(state.ghat, device),
                    err=params(state.err, device),
                    comm=comm_stats(state.comm, device),
                    censor=params(state.censor, device))


def prng_key(key_data, device) -> torch.Tensor:
    """A JAX key's ``key_data`` (a (..., 2) uint32 array) as this package's
    key (``repro_torch.random``): the same words in int64."""
    return torch.tensor(np.asarray(key_data).astype(np.int64), device=device)


def edge_history(hist) -> dict:
    """The numpy fields of an ``EdgeHistory`` (either package's), theta as
    numpy, and ``stats.as_dict()``: what two runs are compared on."""
    out = {f: np.asarray(getattr(hist, f))
           for f in ("objective", "comm_cum", "mask", "agg_grad_sqnorm",
                     "wall_clock", "energy_cum", "bytes_cum")}
    out["final_params"] = tree_map(
        lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
        else np.asarray(t), hist.final_params)
    out["stats"] = hist.stats.as_dict()
    return out


def to_numpy(tree):
    """A tree of tensors as numpy arrays on the host."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def named_leaves(tree, prefix: str = "") -> dict:
    """{dotted path: leaf} of a tree of dicts (keys sorted)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(named_leaves(tree[k], f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _model_shapes(cfg) -> dict:
    from .models.model import init_params
    from .random import PRNGKey
    return named_leaves(init_params(PRNGKey(0, device="cpu"), cfg,
                                    device="meta"))


def model_params(tree, cfg, device) -> dict:
    """A JAX ``models.model.init_params`` tree of numpy arrays as this
    package's parameter tree on ``device``.

    Every leaf must sit where this package's ``init_params`` for ``cfg``
    puts one, with the same shape: ``ValueError`` otherwise.
    ``NotImplementedError`` on a bf16 leaf, and for a config the model does
    not run yet.
    """
    want = _model_shapes(cfg)
    got = named_leaves(tree)
    if set(got) != set(want):
        raise ValueError(f"model_params: leaves {sorted(set(got) ^ set(want))}"
                         f" are in one tree and not the other")
    for name, x in got.items():
        x = np.asarray(x)
        if x.dtype.name == "bfloat16":
            raise NotImplementedError(f"model_params: {name}: {BF16_TODO}")
        if tuple(x.shape) != tuple(want[name].shape):
            raise ValueError(f"model_params: {name} has shape {x.shape}, "
                             f"the model wants {tuple(want[name].shape)}")
    return params(tree, device)


def numpy_model_params(cfg, seed: int) -> dict:
    """Weights for ``cfg`` drawn with ``numpy.random.default_rng(seed)``, as
    a tree of numpy arrays in the config's dtype that the JAX model takes as
    it is and :func:`model_params` carries here. Leaves in sorted path
    order: the embedding normal * d_model^-0.5, each matrix normal *
    fan_in^-0.5, each norm scale 1 + 0.1 * normal (so the scales matter)."""
    rng = np.random.default_rng(seed)
    dtype = np.dtype(cfg.dtype)
    out: dict = {}
    for name, leaf in _model_shapes(cfg).items():
        shape = tuple(leaf.shape)
        if name.endswith("scale"):
            x = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            std = cfg.d_model ** -0.5 if name == "embed" else shape[-2] ** -0.5
            x = std * rng.standard_normal(shape)
        node = out
        *parents, last = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = x.astype(dtype)
    return out
