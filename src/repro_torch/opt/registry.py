"""String-keyed algorithm registry + config-dict round-tripping (port of
``repro.opt.registry``).

    from repro_torch import opt
    o = opt.make("chb", alpha=0.05, num_workers=9, backend="cuda")
    assert opt.from_spec(opt.to_spec(o)) == o

The spec schema is the JAX package's, so a JAX ``opt.to_spec(...)`` dict
loads unchanged. Backend mapping: the JAX kernel backend ``"pallas"`` loads
as this package's kernel backend ``"cuda"``; ``"reference"`` stays
``"reference"``. Registered here: gd, hb, lag, chb, csgd, with the censor
kinds never/eq8/adaptive/stochastic, the transport kinds
dense/int8/topk/lowrank, the server kinds gd/hb and the granularities
global/per_tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..core.censoring import paper_eps1
from .censor import (AdaptiveCensor, Eq8Censor, NeverCensor,
                     StochasticCensor)
from .optimizer import ComposedOptimizer
from .server import GradientDescent, HeavyBall
from .transport import (DenseTransport, Int8Transport, LowRankTransport,
                        TopKTransport)

Builder = Callable[..., ComposedOptimizer]

_ALGORITHMS: dict[str, Builder] = {}

CENSOR_KINDS: dict[str, type] = {"never": NeverCensor, "eq8": Eq8Censor,
                                 "adaptive": AdaptiveCensor,
                                 "stochastic": StochasticCensor}
TRANSPORT_KINDS: dict[str, type] = {"dense": DenseTransport,
                                    "int8": Int8Transport,
                                    "topk": TopKTransport,
                                    "lowrank": LowRankTransport}
SERVER_KINDS: dict[str, type] = {"gd": GradientDescent, "hb": HeavyBall}

#: JAX spec backends and the backend each one loads as here
BACKEND_ALIASES = {"pallas": "cuda", "reference": "reference",
                   "cuda": "cuda"}


def register(name: str) -> Callable[[Builder], Builder]:
    """Decorator: add a builder to the registry under ``name``."""
    def deco(fn: Builder) -> Builder:
        _ALGORITHMS[name] = fn
        return fn
    return deco


def names() -> tuple[str, ...]:
    """The registered algorithm names, sorted."""
    return tuple(sorted(_ALGORITHMS))


def make(name: str, alpha, num_workers: int, **hyper) -> ComposedOptimizer:
    """Build a registered algorithm by name (unknown names raise)."""
    if name not in _ALGORITHMS:
        raise ValueError(f"unknown algorithm {name!r}; valid names: "
                         f"{', '.join(names())}")
    return _ALGORITHMS[name](alpha, num_workers, **hyper)


def make_transport(kind: Optional[str], **hyper):
    """Build a transport by kind (``None`` is the dense passthrough).

    ``hyper`` holds the transport's hyperparameters (``k`` for topk,
    ``rank`` for lowrank); one the transport does not have raises.
    """
    kind = "dense" if kind is None else kind
    if kind not in TRANSPORT_KINDS:
        raise ValueError(f"unknown quantize mode {kind!r} (expected None "
                         f"or one of {sorted(TRANSPORT_KINDS)})")
    return TRANSPORT_KINDS[kind](**hyper)


def _resolve_transport(quantize, transport, k, rank):
    """The transport that the keywords of ``opt.make`` describe.

    ``transport`` may be a kind string, a ready transport instance (its
    hyperparameters already bound), or ``None``; ``quantize`` is the
    legacy alias for the kind string. ``k`` and ``rank`` go to the
    matching transport's constructor.
    """
    if transport is not None and not isinstance(transport, str):
        if quantize is not None or k is not None or rank is not None:
            raise ValueError(
                "a Transport instance already binds its hyperparameters; "
                "do not also pass quantize/k/rank")
        return transport
    if transport is not None and quantize is not None \
            and transport != quantize:
        raise ValueError(
            f"conflicting transport={transport!r} and quantize={quantize!r} "
            "(quantize is the legacy alias; pass one)")
    hyper = {}
    if k is not None:
        hyper["k"] = k
    if rank is not None:
        hyper["rank"] = rank
    return make_transport(transport if transport is not None else quantize,
                          **hyper)


def _compose(censor, server, num_workers, quantize, transport, k, rank,
             granularity, bank_dtype, backend) -> ComposedOptimizer:
    return ComposedOptimizer(
        censor=censor, server=server, num_workers=num_workers,
        transport=_resolve_transport(quantize, transport, k, rank),
        granularity=granularity, bank_dtype=bank_dtype, backend=backend)


@register("gd")
def _gd(alpha, num_workers, *, quantize=None, transport=None, k=None,
        rank=None, granularity="global", bank_dtype=None,
        backend="reference"):
    """Classical distributed gradient descent (every worker transmits)."""
    return _compose(NeverCensor(), GradientDescent(alpha), num_workers,
                    quantize, transport, k, rank, granularity, bank_dtype,
                    backend)


@register("hb")
def _hb(alpha, num_workers, *, beta=0.4, quantize=None, transport=None,
        k=None, rank=None, granularity="global", bank_dtype=None,
        backend="reference"):
    """Classical heavy ball (eq. 2); paper default beta=0.4."""
    return _compose(NeverCensor(), HeavyBall(alpha, beta), num_workers,
                    quantize, transport, k, rank, granularity, bank_dtype,
                    backend)


@register("lag")
def _lag(alpha, num_workers, *, eps1=None, eps1_scale=0.1, quantize=None,
         transport=None, k=None, rank=None, granularity="global",
         bank_dtype=None, backend="reference"):
    """Censoring-based GD (LAG-WK) with the shared eq. (8)."""
    if eps1 is None:
        eps1 = paper_eps1(alpha, num_workers, eps1_scale)
    return _compose(Eq8Censor(eps1), GradientDescent(alpha), num_workers,
                    quantize, transport, k, rank, granularity, bank_dtype,
                    backend)


@register("chb")
def _chb(alpha, num_workers, *, beta=0.4, eps1=None, eps1_scale=0.1,
         quantize=None, transport=None, k=None, rank=None,
         granularity="global", bank_dtype=None, backend="reference"):
    """The paper's algorithm with its Sec.-IV default constants."""
    if eps1 is None:
        eps1 = paper_eps1(alpha, num_workers, eps1_scale)
    return _compose(Eq8Censor(eps1), HeavyBall(alpha, beta), num_workers,
                    quantize, transport, k, rank, granularity, bank_dtype,
                    backend)


@register("csgd")
def _csgd(alpha, num_workers, *, tau0=None, decay=0.99, eps1=None, seed=0,
          quantize=None, transport=None, k=None, rank=None,
          granularity="global", bank_dtype=None, backend="reference"):
    """CSGD-style stochastically censored GD (Li et al., arXiv:1909.03631).

    ``tau0`` is the initial squared-norm threshold (``eps1`` is its
    alias); ``tau0 = 0`` transmits unless a delta is exactly zero.
    """
    if tau0 is None:
        tau0 = eps1 if eps1 is not None else 0.0
    return _compose(StochasticCensor(tau0=tau0, decay=decay, seed=seed),
                    GradientDescent(alpha), num_workers, quantize, transport,
                    k, rank, granularity, bank_dtype, backend)


# --------------------------------------------------------- spec round-trip
def _kind_of(stage, table: dict[str, type], what: str) -> str:
    for kind, cls in table.items():
        if type(stage) is cls:
            return kind
    raise ValueError(f"{what} stage {type(stage).__name__} is not in the "
                     f"spec vocabulary {sorted(table)}")


def _stage_spec(stage, table: dict[str, type], what: str) -> dict:
    spec = {"kind": _kind_of(stage, table, what)}
    for f in dataclasses.fields(stage):
        v = getattr(stage, f.name)
        if isinstance(v, torch.Tensor):
            v = v.item()
        spec[f.name] = v
    return spec


def _stage_from_spec(spec: dict, table: dict[str, type], what: str):
    spec = dict(spec)
    kind = spec.pop("kind", None)
    if kind not in table:
        raise ValueError(f"unknown or unported {what} kind {kind!r}; "
                         f"valid kinds: {sorted(table)}")
    return table[kind](**spec)


def to_spec(o: ComposedOptimizer) -> dict:
    """The full, JSON-serializable composition of an optimizer."""
    return {
        "num_workers": o.num_workers,
        "granularity": o.granularity,
        "backend": o.backend,
        "bank_dtype": (None if o.bank_dtype is None
                       else str(o.bank_dtype).removeprefix("torch.")),
        "censor": _stage_spec(o.censor, CENSOR_KINDS, "censor"),
        "transport": _stage_spec(o.transport, TRANSPORT_KINDS, "transport"),
        "server": _stage_spec(o.server, SERVER_KINDS, "server"),
    }


def from_spec(spec: dict) -> ComposedOptimizer:
    """Rebuild a ``ComposedOptimizer`` from a ``to_spec`` dict, this
    package's or the JAX package's (``"pallas"`` loads as ``"cuda"``)."""
    backend = spec.get("backend", "reference")
    if backend not in BACKEND_ALIASES:
        raise ValueError(f"unknown backend {backend!r}; valid: "
                         f"{sorted(BACKEND_ALIASES)}")
    bank_dtype = spec.get("bank_dtype")
    return ComposedOptimizer(
        censor=_stage_from_spec(spec["censor"], CENSOR_KINDS, "censor"),
        transport=_stage_from_spec(spec["transport"], TRANSPORT_KINDS,
                                   "transport"),
        server=_stage_from_spec(spec["server"], SERVER_KINDS, "server"),
        num_workers=int(spec["num_workers"]),
        granularity=spec.get("granularity", "global"),
        bank_dtype=None if bank_dtype is None else getattr(torch, bank_dtype),
        backend=BACKEND_ALIASES[backend],
    )
