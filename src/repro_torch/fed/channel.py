"""Wireless channel models: payload bytes -> transmission time + drop events
(port of ``repro.fed.channel``: host numpy, the fading gain drawn before
the loss, as there).

The CHB core already knows the exact payload of every uplink
(``core/quantize.py: payload_bytes_dense / payload_bytes_int8``); this module
turns those bytes into air time, delivery outcomes, and (via ``energy.py``)
joules. Three models, all host-side sampling:

  * ``fixed``     — deterministic bitrate; time = overhead + 8B/rate.
  * ``bernoulli`` — fixed bitrate, but each uplink is lost i.i.d. with
                    probability ``loss_prob``. A lost uplink still costs the
                    full air time and transmit energy; the server's stale
                    bank row is left untouched (the delta never arrives) and
                    the client keeps its local bank copy unchanged, so
                    worker/server views never diverge.
  * ``fading``    — block-fading bitrate: per-transmission rate multiplier
                    drawn from an exponential(1) channel-power gain, floored
                    at ``fading_floor`` (outage => crawling rate, the
                    straggler-by-channel case). Composes with loss_prob.

``kind`` is a preset over the same knobs, so scenario sweeps can also mix
knobs freely (e.g. fading + loss).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np


class Transmission(NamedTuple):
    """Outcome of one (up/down)link transmission."""
    time_s: float        # air time actually spent
    delivered: bool      # False => packet lost, payload discarded
    rate_bps: float      # effective bitrate used for this transmission


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """Air-interface model for every uplink/downlink transmission.

    Attributes:
      kind: ``"fixed"`` | ``"bernoulli"`` | ``"fading"`` (see module
        docstring); a preset over the shared knobs below.
      uplink_rate_bps: nominal worker->server bitrate.
      downlink_rate_bps: server broadcast bitrate (deterministic,
        lossless).
      overhead_s: per-packet protocol overhead, charged even to zero-byte
        censor beacons.
      loss_prob: i.i.d. uplink loss probability in [0, 1).
      fading_floor: minimum rate multiplier under block fading (outage
        turns into a crawling transmission instead of a loss).
    """
    kind: str = "fixed"             # "fixed" | "bernoulli" | "fading"
    uplink_rate_bps: float = 1e6    # nominal uplink bitrate
    downlink_rate_bps: float = 2e7  # server broadcast bitrate (fast, reliable)
    overhead_s: float = 0.0         # per-packet protocol overhead
    loss_prob: float = 0.0          # Bernoulli uplink loss probability
    fading_floor: float = 0.05      # minimum rate multiplier under fading

    def __post_init__(self):
        if self.kind not in ("fixed", "bernoulli", "fading"):
            raise ValueError(f"unknown channel kind {self.kind!r}")
        if not 0.0 <= self.loss_prob < 1.0:
            raise ValueError("loss_prob must be in [0, 1)")

    # ------------------------------------------------------------- presets
    @classmethod
    def ideal(cls) -> "ChannelConfig":
        """Zero-latency lossless channel — the sync-mode degenerate case."""
        return cls(kind="fixed", uplink_rate_bps=float("inf"),
                   downlink_rate_bps=float("inf"), overhead_s=0.0)

    @classmethod
    def lossy(cls, loss_prob: float, **kw) -> "ChannelConfig":
        return cls(kind="bernoulli", loss_prob=loss_prob, **kw)

    @classmethod
    def fading(cls, **kw) -> "ChannelConfig":
        return cls(kind="fading", **kw)

    # ------------------------------------------------------------ sampling
    def _effective_rate(self, rng: np.random.Generator) -> float:
        rate = self.uplink_rate_bps
        if self.kind == "fading":
            gain = max(float(rng.exponential(1.0)), self.fading_floor)
            rate = rate * gain
        return rate

    def uplink(self, nbytes: int, rng: np.random.Generator) -> Transmission:
        """Sample one uplink transmission of ``nbytes`` payload bytes."""
        rate = self._effective_rate(rng)
        air = self.overhead_s + (8.0 * nbytes / rate if nbytes else 0.0)
        lost = self.loss_prob > 0.0 and bool(rng.random() < self.loss_prob)
        return Transmission(time_s=air, delivered=not lost, rate_bps=rate)

    def downlink_time(self, nbytes: int) -> float:
        """Broadcast latency for ``nbytes`` (deterministic, lossless)."""
        if nbytes == 0 or self.downlink_rate_bps == float("inf"):
            return self.overhead_s
        return self.overhead_s + 8.0 * nbytes / self.downlink_rate_bps
