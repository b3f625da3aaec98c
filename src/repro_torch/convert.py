"""Carry state across from the JAX package.

The JAX package's parameters and ``OptState``, given as numpy arrays (for
example ``jax.tree_util.tree_map(np.asarray, state)``), become this
package's tensors on a given device, so both packages can step from one
state. :func:`to_numpy` goes the other way for comparisons.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.accounting import CommStats
from .opt.api import OptState
from .tree import tree_map


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


def to_numpy(tree):
    """A tree of tensors as numpy arrays on the host."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
