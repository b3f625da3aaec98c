"""Per-client energy + wall-clock accounting for the edge runtime (port of
``repro.fed.energy``).

Extends the core's uplink-count accounting (``core/accounting.CommStats``)
with the quantities the paper motivates but never measures (Sec. I:
"wireless and battery-driven devices"): joules spent computing gradients and
joules spent radiating bytes, plus wall-clock time. Benchmarks can then
report *energy-to-accuracy* and *wall-clock-to-accuracy* instead of uplink
counts alone.

All accounting here is host-side Python ints / numpy float64 — exact byte
counts (no float-accumulator precision cliff), never on the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    """First-order radio + compute energy model.

    Defaults are in the right ballpark for a WiFi/LTE-class mobile device:
    a few microjoules per transmitted byte and a few watts while computing.
    The *relative* numbers across algorithms are what the benchmarks use.

    Attributes:
      uplink_j_per_byte: radio energy per transmitted payload byte.
      uplink_j_per_tx: fixed per-transmission radio wakeup cost (joules).
      downlink_j_per_byte: receive energy per broadcast byte.
      compute_w: when set, overrides every ``ClientProfile.compute_w``.
    """
    uplink_j_per_byte: float = 5e-6   # radio energy per transmitted byte
    uplink_j_per_tx: float = 1e-3     # fixed per-transmission wakeup cost
    downlink_j_per_byte: float = 1e-6  # receive energy per broadcast byte
    compute_w: float | None = None    # override ClientProfile.compute_w

    def tx_energy(self, nbytes: int) -> float:
        """Joules to transmit one uplink (spent even if the packet drops)."""
        return self.uplink_j_per_tx + self.uplink_j_per_byte * nbytes

    def rx_energy(self, nbytes: int) -> float:
        return self.downlink_j_per_byte * nbytes

    def compute_energy(self, seconds: float, profile_w: float) -> float:
        w = self.compute_w if self.compute_w is not None else profile_w
        return w * seconds

    def round_energy(self, attempted, cohort, payload_bytes: int):
        """Radio joules for one synchronous round (or a whole (B, R) grid).

        ``attempted`` uplinks each pay the tx cost (drops burn air energy
        too); every ``cohort`` member receives the broadcast. This is the
        shared accounting for the synchronous surfaces —
        ``sweep.fed_sweep`` and the mesh runtime (``fed.mesh``) — so their
        energy frontiers are comparable by construction; the event runtime
        (``fed.runner``) accrues the same model per transmission instead.
        Accepts scalars or numpy arrays (vectorized over rounds/points).
        """
        return (attempted * self.tx_energy(payload_bytes)
                + cohort * self.rx_energy(payload_bytes))


@dataclasses.dataclass
class EdgeStats:
    """Mutable per-client deployment accounting, owned by ``fed.runner``.

    ``uplink_bytes`` are exact Python ints; everything else float64.
    """
    num_clients: int
    uplink_count: np.ndarray = None       # (M,) transmissions attempted
    delivered_count: np.ndarray = None    # (M,) transmissions that arrived
    dropped_count: np.ndarray = None      # (M,) transmissions lost in channel
    censored_count: np.ndarray = None     # (M,) gradient evals self-censored
    stale_count: np.ndarray = None        # (M,) uplinks folded after their round
    uplink_bytes: list = None             # (M,) exact ints
    compute_s: np.ndarray = None          # (M,) seconds spent computing
    tx_s: np.ndarray = None               # (M,) seconds spent transmitting
    energy_j: np.ndarray = None           # (M,) total joules per client
    rounds: int = 0
    wall_clock_s: float = 0.0

    def __post_init__(self):
        m = self.num_clients
        z = lambda dt: np.zeros((m,), dt)
        if self.uplink_count is None:
            self.uplink_count = z(np.int64)
            self.delivered_count = z(np.int64)
            self.dropped_count = z(np.int64)
            self.censored_count = z(np.int64)
            self.stale_count = z(np.int64)
            self.uplink_bytes = [0] * m
            self.compute_s = z(np.float64)
            self.tx_s = z(np.float64)
            self.energy_j = z(np.float64)

    # ------------------------------------------------------------- fold-ins
    def record_compute(self, i: int, seconds: float, joules: float) -> None:
        self.compute_s[i] += seconds
        self.energy_j[i] += joules

    def record_uplink(self, i: int, nbytes: int, seconds: float,
                      joules: float, delivered: bool) -> None:
        self.uplink_count[i] += 1
        self.uplink_bytes[i] += int(nbytes)
        self.tx_s[i] += seconds
        self.energy_j[i] += joules
        if delivered:
            self.delivered_count[i] += 1
        else:
            self.dropped_count[i] += 1

    def record_censored(self, i: int) -> None:
        self.censored_count[i] += 1

    def record_downlink(self, i: int, joules: float) -> None:
        self.energy_j[i] += joules

    def record_stale(self, i: int) -> None:
        self.stale_count[i] += 1

    # ------------------------------------------------------------ summaries
    @property
    def total_uplinks(self) -> int:
        return int(self.uplink_count.sum())

    @property
    def total_uplink_bytes(self) -> int:
        return sum(self.uplink_bytes)

    @property
    def total_energy_j(self) -> float:
        return float(self.energy_j.sum())

    def as_dict(self) -> dict:
        return {
            "rounds": self.rounds,
            "wall_clock_s": self.wall_clock_s,
            "uplinks": self.total_uplinks,
            "delivered": int(self.delivered_count.sum()),
            "dropped": int(self.dropped_count.sum()),
            "censored": int(self.censored_count.sum()),
            "stale_folds": int(self.stale_count.sum()),
            "uplink_bytes": self.total_uplink_bytes,
            "compute_s": float(self.compute_s.sum()),
            "tx_s": float(self.tx_s.sum()),
            "energy_j": self.total_energy_j,
        }
