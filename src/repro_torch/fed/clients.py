"""Heterogeneous edge-client population for the event-driven runtime
(port of ``repro.fed.clients``: host numpy, the same draws in the same
order).

Each client is described by a static :class:`ClientProfile` (compute speed,
jitter law, availability trace, radio power draw); the population bundles M
profiles plus the per-round participation-sampling policy. All randomness is
host-side ``numpy.random.Generator`` draws — the event loop lives on the
host, only the math (gradients, bank folds, server updates) runs on the
device.

Availability models
  * ``always``     — the client can be dispatched whenever idle.
  * ``bernoulli``  — available with probability ``avail_p`` per dispatch
                     attempt (intermittent duty-cycling, e.g. deep sleep).
  * ``cycle``      — deterministic on/off square wave in wall-clock time:
                     available iff ((t + phase) mod period) < duty*period
                     (e.g. a phone that charges at night).

Compute-latency models (seconds per local gradient evaluation)
  * ``fixed``      — exactly ``compute_mean_s``.
  * ``exp``        — exponential with mean ``compute_mean_s`` (memoryless
                     interference from other on-device work).
  * ``lognormal``  — lognormal with mean ``compute_mean_s`` and shape
                     ``jitter_sigma`` (heavy-tailed stragglers).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClientProfile:
    """Static description of one edge device.

    Attributes:
      compute_mean_s: mean seconds per local gradient evaluation.
      jitter: latency law — ``"fixed"`` | ``"exp"`` | ``"lognormal"``
        (see module docstring).
      jitter_sigma: lognormal shape parameter (heavier tail when larger).
      availability: ``"always"`` | ``"bernoulli"`` | ``"cycle"``.
      avail_p: per-dispatch availability probability (bernoulli model).
      cycle_period_s / cycle_duty / cycle_phase_s: square-wave on/off
        availability trace parameters (cycle model).
      compute_w: device power draw while computing, in watts.
    """
    compute_mean_s: float = 1.0       # mean seconds per gradient evaluation
    jitter: str = "fixed"             # "fixed" | "exp" | "lognormal"
    jitter_sigma: float = 0.5         # lognormal shape parameter
    availability: str = "always"      # "always" | "bernoulli" | "cycle"
    avail_p: float = 1.0              # bernoulli availability probability
    cycle_period_s: float = 60.0      # cycle model: full period
    cycle_duty: float = 0.5           # cycle model: fraction of period on
    cycle_phase_s: float = 0.0        # cycle model: per-client offset
    compute_w: float = 2.0            # device power draw while computing (W)

    def draw_compute_time(self, rng: np.random.Generator) -> float:
        if self.jitter == "fixed":
            return self.compute_mean_s
        if self.jitter == "exp":
            return float(rng.exponential(self.compute_mean_s))
        if self.jitter == "lognormal":
            # parameterize so the mean is compute_mean_s regardless of sigma
            mu = math.log(self.compute_mean_s) - 0.5 * self.jitter_sigma ** 2
            return float(rng.lognormal(mu, self.jitter_sigma))
        raise ValueError(f"unknown jitter model {self.jitter!r}")

    def is_available(self, t: float, rng: np.random.Generator) -> bool:
        if self.availability == "always":
            return True
        if self.availability == "bernoulli":
            return bool(rng.random() < self.avail_p)
        if self.availability == "cycle":
            pos = math.fmod(t + self.cycle_phase_s, self.cycle_period_s)
            return pos < self.cycle_duty * self.cycle_period_s
        raise ValueError(f"unknown availability model {self.availability!r}")


@dataclasses.dataclass(frozen=True)
class Population:
    """M client profiles + the server's per-round sampling policy.

    Attributes:
      profiles: one ``ClientProfile`` per client; the tuple length is M.
      participation: fraction of the idle+available candidates the server
        dispatches each round, in (0, 1].
    """
    profiles: tuple[ClientProfile, ...]
    participation: float = 1.0    # fraction of idle+available clients sampled

    def __post_init__(self):
        if not 0.0 < self.participation <= 1.0:
            raise ValueError("participation must be in (0, 1]")

    @property
    def num_clients(self) -> int:
        return len(self.profiles)

    def as_vector(self) -> "VectorPopulation":
        """Columnar view for the mesh runtime (``fed.mesh`` in the JAX
        package; its port is ROADMAP.md A10).

        Keeps the mean compute latency and power per client; jitter and
        availability laws are event-runtime concepts and are dropped (the
        mesh runtime's wall-clock model is the nominal mean-latency
        straggler bound — see docs/fed_scaling.md).
        """
        return VectorPopulation(
            compute_mean_s=np.asarray(
                [p.compute_mean_s for p in self.profiles], np.float64),
            compute_w=np.asarray(
                [p.compute_w for p in self.profiles], np.float64),
            participation=self.participation)

    def sample_cohort(self, idle_available: Sequence[int],
                      rng: np.random.Generator) -> list[int]:
        """Server-side client sampling: choose ceil(p * |candidates|)."""
        cands = list(idle_available)
        if not cands:
            return []
        k = max(1, math.ceil(self.participation * len(cands)))
        if k >= len(cands):
            return cands
        return sorted(rng.choice(cands, size=k, replace=False).tolist())


@dataclasses.dataclass(frozen=True)
class VectorPopulation:
    """Columnar client population for the mesh runtime (``fed.mesh``).

    ``Population`` keeps one ``ClientProfile`` object per client — fine
    for the event runtime's hundreds of clients, hopeless for 10^5–10^6
    (a million Python objects before the first round). This is the same
    information as plain arrays, sliceable into contiguous per-shard
    blocks. Only the knobs the synchronous mesh rounds consume are
    carried: per-client compute latency/power (wall-clock + energy
    models) — availability/jitter laws stay event-runtime-only.

    Attributes:
      compute_mean_s: (M,) mean seconds per local gradient evaluation.
      compute_w: (M,) device power draw while computing, in watts.
      participation: per-client per-round cohort-join probability (the
        mesh runtime's i.i.d. Bernoulli analogue of cohort sampling,
        matching ``sweep.fed_sweep``).
    """
    compute_mean_s: np.ndarray
    compute_w: np.ndarray
    participation: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "compute_mean_s",
                           np.asarray(self.compute_mean_s, np.float64))
        object.__setattr__(self, "compute_w",
                           np.asarray(self.compute_w, np.float64))
        if self.compute_mean_s.shape != self.compute_w.shape or \
                self.compute_mean_s.ndim != 1:
            raise ValueError("compute_mean_s/compute_w must be matching "
                             "(M,) vectors")
        if not 0.0 < self.participation <= 1.0:
            raise ValueError("participation must be in (0, 1]")

    @property
    def num_clients(self) -> int:
        return int(self.compute_mean_s.shape[0])


def uniform_vector_population(num_clients: int, compute_mean_s: float = 1.0,
                              compute_w: float = 2.0,
                              participation: float = 1.0,
                              straggler_frac: float = 0.0,
                              straggler_slowdown: float = 10.0,
                              seed: int = 0) -> VectorPopulation:
    """Columnar population, optionally with a straggler tail."""
    mean = np.full((num_clients,), compute_mean_s, np.float64)
    if straggler_frac > 0.0:
        rng = np.random.default_rng(seed)
        n_slow = int(round(straggler_frac * num_clients))
        slow = rng.choice(num_clients, size=n_slow, replace=False)
        mean[slow] *= straggler_slowdown
    return VectorPopulation(
        compute_mean_s=mean,
        compute_w=np.full((num_clients,), compute_w, np.float64),
        participation=participation)


# ------------------------------------------------------------ constructors
def uniform_population(num_clients: int, compute_mean_s: float = 1.0,
                       participation: float = 1.0,
                       **profile_kw) -> Population:
    """Identical clients (the paper's implicit deployment)."""
    p = ClientProfile(compute_mean_s=compute_mean_s, **profile_kw)
    return Population(profiles=(p,) * num_clients,
                      participation=participation)


def straggler_population(num_clients: int, compute_mean_s: float = 1.0,
                         straggler_frac: float = 0.1,
                         straggler_slowdown: float = 10.0,
                         jitter: str = "exp",
                         participation: float = 1.0,
                         seed: int = 0, **profile_kw) -> Population:
    """A fraction of clients is ``straggler_slowdown``x slower (tail latency)."""
    rng = np.random.default_rng(seed)
    n_slow = int(round(straggler_frac * num_clients))
    slow = set(rng.choice(num_clients, size=n_slow, replace=False).tolist())
    profiles = tuple(
        ClientProfile(
            compute_mean_s=compute_mean_s * (straggler_slowdown
                                             if i in slow else 1.0),
            jitter=jitter, **profile_kw)
        for i in range(num_clients))
    return Population(profiles=profiles, participation=participation)


def intermittent_population(num_clients: int, compute_mean_s: float = 1.0,
                            avail_p: float = 0.7,
                            participation: float = 1.0,
                            **profile_kw) -> Population:
    """Clients that answer a dispatch only with probability ``avail_p``."""
    p = ClientProfile(compute_mean_s=compute_mean_s,
                      availability="bernoulli", avail_p=avail_p, **profile_kw)
    return Population(profiles=(p,) * num_clients,
                      participation=participation)


def duty_cycle_population(num_clients: int, compute_mean_s: float = 1.0,
                          period_s: float = 60.0, duty: float = 0.5,
                          participation: float = 1.0, seed: int = 0,
                          **profile_kw) -> Population:
    """Deterministic on/off traces with random per-client phase offsets."""
    rng = np.random.default_rng(seed)
    profiles = tuple(
        ClientProfile(compute_mean_s=compute_mean_s, availability="cycle",
                      cycle_period_s=period_s, cycle_duty=duty,
                      cycle_phase_s=float(rng.uniform(0.0, period_s)),
                      **profile_kw)
        for _ in range(num_clients))
    return Population(profiles=profiles, participation=participation)
