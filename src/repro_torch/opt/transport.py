"""Transports: what bits a transmitted delta carries (port of
``repro.opt.transport``).

  * :class:`DenseTransport` -- the paper's uplink: the raw delta tree.
  * :class:`Int8Transport` -- symmetric int8 with a per-worker scale and
    error feedback, so worker and server views never diverge.

The top-k and low-rank transports and the per-client row entry points
are not ported yet. Stage anatomy of one batched step:

    pending = prepare(delta, err)
    payload, aux = encode(pending, err)
    new_err = feedback(mask, pending, payload, aux, err)
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import torch

from ..core.quantize import (payload_bytes_dense, payload_bytes_int8,
                             tree_quantize_roundtrip_per_worker)
from ..core.util import tree_stack_zeros
from ..tree import tree_map


def _bcast(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-worker mask (M,) against a leading-M leaf."""
    return mask.reshape((-1,) + (1,) * (leaf.dim() - 1)).to(leaf.dtype)


def _ef_blend(mask, pending, payload, err):
    """Masked error-feedback update ``mk*(p - q) + (1 - mk)*e``: the
    arithmetic-blend form the fused int8 kernel evaluates too."""
    return tree_map(
        lambda p, q, e: _bcast(mask, p) * (p - q)
        + (1.0 - _bcast(mask, p)) * e.to(p.dtype),
        pending, payload, err)


@dataclasses.dataclass(frozen=True)
class DenseTransport:
    """Raw-delta uplinks (the paper's transport)."""

    mode: ClassVar[Optional[str]] = None
    stateful: ClassVar[bool] = False

    def init(self, params, num_workers: int):
        # empty leaves keep the state's tree structure the same across
        # transports, as in the JAX package
        return tree_map(lambda x: torch.zeros((0,), dtype=x.dtype,
                                              device=x.device), params)

    def prepare(self, delta, err):
        return delta

    def encode(self, pending, err):
        return pending, ()

    def feedback(self, mask, pending, payload, aux, err):
        return err

    def payload_bytes(self, params) -> int:
        return payload_bytes_dense(params)

    def ef_bank(self, err):
        return None


@dataclasses.dataclass(frozen=True)
class Int8Transport:
    """Int8 uplinks with per-worker scales and error feedback."""

    mode: ClassVar[Optional[str]] = "int8"
    stateful: ClassVar[bool] = True

    def init(self, params, num_workers: int):
        return tree_stack_zeros(params, num_workers)

    def prepare(self, delta, err):
        return tree_map(lambda d, e: d + e.to(d.dtype), delta, err)

    def encode(self, pending, err):
        # per-worker scales: worker m quantizes its own delta slice
        return tree_quantize_roundtrip_per_worker(pending), ()

    def feedback(self, mask, pending, payload, aux, err):
        return _ef_blend(mask, pending, payload, err)

    def payload_bytes(self, params) -> int:
        return payload_bytes_int8(params)

    def ef_bank(self, err):
        return err
