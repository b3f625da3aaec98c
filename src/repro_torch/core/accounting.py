"""Communication accounting (port of ``repro.core.accounting``).

The headline metric is the number of worker->server (uplink)
transmissions. Byte accounting is precision-safe: a float32 cell loses
integer precision past 2^24 bytes, and an int32 cell wraps past 2^31, so
the cumulative payload is carried as a split int32 pair (whole MiB,
remainder bytes) with an explicit carry at every update -- exact up to
2^31 MiB (2 PiB). ``uplink_bytes_exact()`` gives the exact Python int.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device

MIB = 1 << 20


def split_bytes(nbytes: int) -> tuple[int, int]:
    """Split a Python int byte count into (whole_mib, rem_bytes)."""
    return divmod(int(nbytes), MIB)


def carry_bytes(mib: torch.Tensor, rem: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalize a split counter so that 0 <= rem < MIB."""
    c = torch.div(rem, MIB, rounding_mode="floor")
    return mib + c, rem - c * MIB


class CommStats(NamedTuple):
    """Carried inside optimizer state; every field is an int32 tensor."""
    uplink_count: torch.Tensor     # (M,) cumulative transmissions per worker
    uplink_mib: torch.Tensor       # () whole MiB of cumulative uplink payload
    uplink_rem: torch.Tensor       # () remainder bytes (< MIB)
    downlink_count: torch.Tensor   # () cumulative server broadcasts
    iterations: torch.Tensor       # () iterations taken

    @classmethod
    def init(cls, num_workers: int, device=None) -> "CommStats":
        """Zero counters on ``device`` (``None`` means CUDA, see
        ``repro_torch.device.resolve_device``)."""
        dev = resolve_device(device)

        def z(shape):
            return torch.zeros(shape, dtype=torch.int32, device=dev)
        return cls(uplink_count=z((num_workers,)), uplink_mib=z(()),
                   uplink_rem=z(()), downlink_count=z(()), iterations=z(()))

    def update(self, mask: torch.Tensor, payload_bytes: int) -> "CommStats":
        """Fold one iteration's (M,) transmit indicators.

        ``payload_bytes`` is the per-transmission payload size, a Python
        int, divmod-split on the host so the counters stay exact.
        """
        mask_i = mask.to(torch.int32)
        n_tx = torch.sum(mask_i).to(torch.int32)
        pb_mib, pb_rem = split_bytes(payload_bytes)
        mib, rem = carry_bytes(self.uplink_mib + n_tx * pb_mib,
                               self.uplink_rem + n_tx * pb_rem)
        return CommStats(
            uplink_count=self.uplink_count + mask_i,
            uplink_mib=mib,
            uplink_rem=rem,
            downlink_count=self.downlink_count + 1,
            iterations=self.iterations + 1,
        )

    def add_bytes_split(self, mib_inc, rem_inc) -> "CommStats":
        """Fold a pre-split (mib, rem) byte increment."""
        mib, rem = carry_bytes(self.uplink_mib + mib_inc,
                               self.uplink_rem + rem_inc)
        return self._replace(uplink_mib=mib, uplink_rem=rem)

    @property
    def uplink_bytes(self) -> torch.Tensor:
        """Cumulative uplink payload bytes as f64 (for reporting)."""
        return self.uplink_mib.to(torch.float64) * MIB \
            + self.uplink_rem.to(torch.float64)

    def uplink_bytes_exact(self) -> int:
        """Exact cumulative byte count as a Python int."""
        return int(self.uplink_mib) * MIB + int(self.uplink_rem)

    @property
    def total_uplinks(self) -> torch.Tensor:
        return torch.sum(self.uplink_count)

    def metrics(self) -> dict:
        """The counters as a flat ``repro_torch.obs`` MetricBag fragment:
        the exact cumulative uplink bytes (f64) and the raw counts."""
        return {
            "comm/uplink_total": self.total_uplinks,
            "comm/uplink_bytes": self.uplink_bytes,
            "comm/downlink_count": self.downlink_count,
            "comm/iterations": self.iterations,
        }

    def savings_vs_dense(self) -> torch.Tensor:
        """Fraction of uplinks censored vs. transmit-every-iteration."""
        m = self.uplink_count.shape[0]
        dense = self.iterations.to(torch.float32) * m
        return 1.0 - self.total_uplinks.to(torch.float32) \
            / torch.clamp(dense, min=1.0)
