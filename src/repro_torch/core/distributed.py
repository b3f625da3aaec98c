"""The server-side fold of the sharded federated runtime (port of
``repro.core.distributed.make_client_fold``).

The JAX package folds the K shard partials with one ``psum`` over the
``("clients",)`` mesh axis. Here the runtime is single-controller, so the
fold is a left fold on the server device, in shard order. The rest of the
JAX module (the ``scan`` and ``pod`` training strategies, ``DistFedState``
and their steps) belongs to LM training and is not ported here (ROADMAP.md
A13).
"""
from __future__ import annotations

import torch

from ..tree import tree_map


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
