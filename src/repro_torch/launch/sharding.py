"""Client-axis placement for the sharded federated runtime (port of the
client helpers of ``repro.launch.sharding``).

A client bank's leading axis splits into K contiguous, equally sized
blocks, block i on the mesh's device i (``launch.mesh.ClientMesh``). The
JAX package assembles the blocks into one mesh-sharded array; PyTorch has
no such array, so a global ``(K*local, ...)`` leaf lives on the server
device, and these helpers move between it and the per-shard pieces:

  * ``per_device_views`` splits a tree into per-shard trees: a block of
    the leading axis each (a view where it already lies on that device),
    or the whole tree each (``replicated=True``, the server state; the
    same tensor where the device repeats);
  * ``stack_shards`` concatenates per-shard trees onto the server device
    (a shard already there is not copied before the concatenation).

The model-parallel partition specs of ``repro.launch.sharding`` are not
ported: training here runs on one device (ROADMAP.md A13).
"""
from __future__ import annotations

from typing import Any

import torch

from ..tree import tree_map


def client_shard_sizes(num_clients: int, mesh, axis: str = "clients") -> int:
    """Per-shard client count, validating divisibility loudly.

    The K-invariance anchor relies on every shard holding a contiguous,
    equally sized client block, so ``num_clients`` must divide evenly; a
    ragged split would silently change which clients share a shard's
    batched program and is refused here.
    """
    k = int(mesh.shape[axis])
    if num_clients % k != 0:
        raise ValueError(
            f"num_clients={num_clients} is not divisible by the "
            f"'{axis}' mesh axis size {k}; pad the population or pick a "
            "shard count that divides it")
    return num_clients // k


def per_device_views(tree: Any, mesh, *, replicated: bool = False) -> list:
    """Per-shard trees of ``tree``: ``result[i]`` lives on mesh device i.

    Sharded (the default), each leaf's leading axis splits into K
    contiguous blocks and block i moves to device i; replicated, every
    shard gets the whole tree on its device. A piece that already lies on
    its device is a view, not a copy.
    """
    devices = mesh.devices
    k = len(devices)
    if replicated:
        return [tree_map(lambda x, d=d: x.to(d), tree) for d in devices]

    def block(x, i):
        if x.shape[0] % k:
            raise ValueError(f"leading axis {x.shape[0]} does not split "
                             f"into {k} equal shards")
        local = x.shape[0] // k
        return x[i * local:(i + 1) * local].to(devices[i])
    return [tree_map(lambda x, i=i: block(x, i), tree) for i in range(k)]


def stack_shards(pieces: list, mesh) -> Any:
    """Assemble per-shard trees into one tree of ``(K*local, ...)`` leaves
    on the server device (the inverse of ``per_device_views``)."""
    if len(pieces) != mesh.size:
        raise ValueError(f"stack_shards got {len(pieces)} pieces for a "
                         f"{mesh.size}-device 'clients' mesh")
    server = mesh.server
    return tree_map(lambda *xs: torch.cat([x.to(server) for x in xs]),
                    *pieces)


def replicated(tree: Any, mesh) -> Any:
    """The server state (params, theta_prev) on the mesh's server device:
    the port of ``replicated_sharding``'s placement."""
    return tree_map(lambda x: x.to(mesh.server), tree)
