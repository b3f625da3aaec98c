"""Censor policies: who uploads this round (port of ``repro.opt.censor``).

  * :class:`NeverCensor` -- everyone transmits (GD/HB family).
  * :class:`Eq8Censor` -- the paper's eq. (8).
  * :class:`AdaptiveCensor` -- beyond the paper: a relative-novelty EMA
    test.
  * :class:`StochasticCensor` -- CSGD-style (Li et al., arXiv:1909.03631):
    worker m transmits iff ``||delta_m||^2 > u_m * tau0 * decay^k`` with
    ``u_m ~ U(0, 1)`` drawn per (round, worker) from the JAX PRNG.

Each has the batched ``decide(state, delta_sq, step_sq)`` and
``decide_ids(state, delta_sq, step_sq, worker_ids)``, the form
``shard_step`` calls for a shard of workers with absolute ids (the
stochastic policy draws by absolute id, so any split of the population
draws the same uniforms). ``client_decide(round_index, worker, delta_sq,
step_sq)`` is one worker's decision in the event runtime (``fed.runner``);
the policies that can decide per client set ``supports_event_runtime``
and decide there as ``decide`` does in a synchronous round, draw for
draw. Decisions are evaluated in the norms' f32 precision for
host-scalar and tensor eps1 alike (``core.censoring._eps_cast``).
``metrics(state)`` is each policy's read-only ``repro_torch.obs`` hook,
namespaced ``censor/<kind>/<key>`` in the MetricBag.
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar

import torch

from .. import random as jrandom
from ..core.censoring import _eps_cast, transmit_mask
from ..device import resolve_device
from .api import static_pos


@dataclasses.dataclass(frozen=True)
class NeverCensor:
    """Every worker transmits every round (classical GD/HB)."""

    supports_event_runtime: ClassVar[bool] = True

    def init(self, num_workers: int, device=None):
        return ()

    def decide(self, state, delta_sq, step_sq):
        return torch.ones(delta_sq.shape, dtype=torch.float32,
                          device=delta_sq.device), state

    def client_decide(self, round_index, worker, delta_sq, step_sq):
        return torch.ones((), dtype=torch.bool, device=delta_sq.device)

    def decide_ids(self, state, delta_sq, step_sq, worker_ids):
        return self.decide(state, delta_sq, step_sq)

    def metrics(self, state) -> dict:
        return {}


@dataclasses.dataclass(frozen=True)
class Eq8Censor:
    """The paper's skip condition (eq. 8).

    ``eps1`` is a Python float or a 0-d tensor; a tensor takes the
    branch-free form, which decides exactly like the host-scalar branches.
    """

    eps1: Any
    supports_event_runtime: ClassVar[bool] = True

    def init(self, num_workers: int, device=None):
        return ()

    def decide(self, state, delta_sq, step_sq):
        ones = torch.ones(delta_sq.shape, dtype=torch.float32,
                          device=delta_sq.device)
        pos = static_pos(self.eps1)
        if pos is None:
            eps = torch.as_tensor(self.eps1, device=delta_sq.device)
            mask = torch.where(eps > 0,
                               transmit_mask(delta_sq, step_sq, self.eps1),
                               ones)
        elif pos:
            mask = transmit_mask(delta_sq, step_sq, self.eps1)
        else:
            mask = ones
        return mask, state

    def client_decide(self, round_index, worker, delta_sq, step_sq):
        if static_pos(self.eps1) is False:
            return torch.ones((), dtype=torch.bool, device=delta_sq.device)
        return delta_sq > _eps_cast(self.eps1, step_sq) * step_sq

    def decide_ids(self, state, delta_sq, step_sq, worker_ids):
        # eq. (8) reads only the norms; the shard's ids are irrelevant
        return self.decide(state, delta_sq, step_sq)

    def metrics(self, state) -> dict:
        # the threshold itself, so a sweep's bags name each point's eps1
        return {"eps1": torch.as_tensor(self.eps1).to(torch.float32)}


@dataclasses.dataclass(frozen=True)
class AdaptiveCensor:
    """Beyond the paper: transmit iff ``||delta_m||^2 > adaptive * EMA_m``.

    A scale-free relative-novelty test. The state is the (M,) f32 EMA of
    each worker's delta norm; a worker whose EMA is still 0 transmits and
    seeds it. The test is elementwise per worker, so a shard holding its
    own EMA slice decides as the whole population would. The EMA update
    needs the whole cohort's deltas, so it cannot run in the event
    runtime.
    """

    adaptive: float
    decay: float = 0.9
    supports_event_runtime: ClassVar[bool] = False

    def init(self, num_workers: int, device=None):
        return torch.zeros((num_workers,), dtype=torch.float32,
                           device=resolve_device(device))

    def decide(self, ema, delta_sq, step_sq):
        warm = ema > 0
        mask = torch.where(warm,
                           (delta_sq > self.adaptive * ema).to(torch.float32),
                           1.0)
        new_ema = torch.where(warm,
                              self.decay * ema
                              + (1 - self.decay) * delta_sq, delta_sq)
        return mask, new_ema

    def decide_ids(self, ema, delta_sq, step_sq, worker_ids):
        return self.decide(ema, delta_sq, step_sq)

    def client_decide(self, round_index, worker, delta_sq, step_sq):
        raise NotImplementedError(
            "adaptive censoring needs the whole cohort's deltas; it cannot "
            "run in the event-driven fed runtime")

    def metrics(self, ema) -> dict:
        return {"ema_mean": torch.mean(ema), "ema_max": torch.max(ema)}


@dataclasses.dataclass(frozen=True)
class StochasticCensor:
    """CSGD-style stochastic censoring (Li et al., arXiv:1909.03631).

    Worker m transmits at round k iff ``||delta_m||^2 > u * tau_k`` with
    ``tau_k = tau0 * decay^k`` and ``u`` uniform from the key
    ``fold_in(fold_in(PRNGKey(seed), k), m)``: the JAX package's draws,
    bit for bit, so the batched ``decide`` and the event runtime's
    ``client_decide`` see the same uniforms. The state is the round
    counter k (an int32 tensor).

    The uniforms are f64: the JAX package draws them in JAX's default
    float, which is f64 under x64, as its experiments and tests run. So
    ``u * tau_k`` and the comparison with the f32 norm run in f64, as JAX
    promotes them.

    ``tau_k`` is an f32 ``pow(decay, f32(k))`` times ``f32(tau0)``,
    computed on the host (JAX lowers ``f32 ** i32`` to ``pow(f32,
    convert(k))``, which PyTorch's CPU ``pow`` with an f32 exponent
    matches bit for bit) and then moved to the norms' device; each
    decision reads k on the host.
    """

    tau0: Any
    decay: float = 0.99
    seed: int = 0
    supports_event_runtime: ClassVar[bool] = True

    def init(self, num_workers: int, device=None):
        return torch.zeros((), dtype=torch.int32,
                           device=resolve_device(device))

    def _tau(self, k: int) -> torch.Tensor:
        """tau_k as a 0-d f32 tensor on the host."""
        tau0 = torch.as_tensor(self.tau0).to("cpu", torch.float32)
        decay = torch.tensor(self.decay, dtype=torch.float32)
        return tau0 * torch.pow(decay,
                                torch.tensor(float(k), dtype=torch.float32))

    def _uniform(self, k: int, worker, device) -> torch.Tensor:
        """The uniforms of round k for one worker id or a tensor of ids."""
        key = jrandom.fold_in(jrandom.PRNGKey(self.seed, device=device), k)
        return jrandom.uniform(jrandom.fold_in(key, worker),
                               dtype=torch.float64)

    def decide(self, k, delta_sq, step_sq):
        workers = torch.arange(delta_sq.shape[0], device=delta_sq.device)
        return self.decide_ids(k, delta_sq, step_sq, workers)

    def client_decide(self, round_index, worker, delta_sq, step_sq):
        u = self._uniform(int(round_index), int(worker), delta_sq.device)
        return delta_sq > u * self._tau(int(round_index)).to(delta_sq.device)

    def decide_ids(self, k, delta_sq, step_sq, worker_ids):
        # the shard's absolute ids, not a local arange, so that any split
        # of the population draws the same uniforms
        kk = int(k)
        dev = delta_sq.device
        u = self._uniform(kk, torch.as_tensor(worker_ids, device=dev), dev)
        mask = (delta_sq > u * self._tau(kk).to(dev)).to(torch.float32)
        return mask, k + 1

    def metrics(self, k) -> dict:
        # k is the post-step round counter: tau is the threshold the next
        # round tests against
        return {"tau": self._tau(int(k)), "round": k}
