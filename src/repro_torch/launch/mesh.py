"""The client mesh of the sharded federated runtime (port of the client
part of ``repro.launch.mesh``).

A ``ClientMesh`` is the 1-D ``("clients",)`` axis ``fed.mesh.run_mesh``
shards its client banks over: K devices, shard i on ``devices[i]``. The
runtime is single-controller, as the JAX package's is: one host loop runs
each shard's round on its device, then one fold on the first (server)
device. So a device may repeat: ``["cpu"] * 8`` runs 8 shards in one
process on the CPU, ``["cuda:0"] * 8`` 8 shards on one card, the port's
counterpart of ``--xla_force_host_platform_device_count``.

The JAX package's model-parallel meshes (``make_auto_mesh``,
``make_production_mesh``, ``make_local_mesh``, ``dp_axes``) are not
ported: training here runs the scan strategy on one device, and a mesh
raises (ROADMAP.md A13).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class ClientMesh:
    """K shard devices on the ``("clients",)`` axis, in shard order."""
    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("clients",)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis_names[0]: self.size}

    @property
    def server(self) -> torch.device:
        """The device the fold and the server update run on: shard 0's."""
        return self.devices[0]


def _require_devices(needed: int, what: str) -> None:
    """Loud failure when a mesh wants more CUDA cards than are visible."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if needed > have:
        raise ValueError(
            f"{what} needs {needed} CUDA devices but only {have} are "
            "visible; pass devices= to place several shards on one device "
            f"(for example devices=['cuda:0'] * {needed}, or ['cpu'] * "
            f"{needed} on the CPU) or request a smaller mesh")


def make_client_mesh(num_shards: int,
                     devices: Optional[Sequence] = None) -> ClientMesh:
    """1-D ``("clients",)`` mesh of ``num_shards`` shards.

    ``devices=None`` takes the first ``num_shards`` CUDA devices and
    raises when fewer are visible: a mesh never degrades to fewer shards
    or to the CPU. An explicit ``devices`` sequence (one entry a shard,
    repeats allowed) places the shards there.
    """
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if devices is None:
        _require_devices(num_shards, f"client mesh ({num_shards} shards)")
        devs = tuple(torch.device("cuda", i) for i in range(num_shards))
    else:
        devs = tuple(torch.device(d) for d in devices)
        if len(devs) != num_shards:
            raise ValueError(f"client mesh of {num_shards} shards got "
                             f"{len(devs)} devices")
    return ClientMesh(devices=devs)
