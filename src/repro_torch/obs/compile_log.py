"""Process-wide counters for every execution surface (port of
``repro.obs.compile_log``).

The JAX package ticks these counters while a program is traced, so they
count compiled programs. PyTorch runs eagerly and compiles nothing per
call, so here each tick counts what the port really repeats:

  * ``kernels``   -- launches of each hand-written CUDA kernel (the live
    dict is ``kernels.common.LAUNCHES``; every kernel name is always
    present, at 0 until launched);
  * ``launchers`` -- the same launches per C launcher, a kernel's design
    and dtype build (``kernels.common.LAUNCHERS``, ticked by
    ``kernels.build.launch``);
  * ``build``     -- ``nvcc`` builds of each kernel library
    (``kernels.build.build``);
  * ``simulator`` -- ``trajectory``: one tick a call (a run), where the
    JAX package ticks once a traced scan program;
  * ``sweep``     -- ``partition``: one tick a static partition of a sweep,
    as in the JAX package (which compiles one program each);
  * ``fed``       -- ``client_eval`` and ``server_update``: one tick a call
    of the event runtime's stages (a client evaluation, a server round),
    where the JAX package ticks once a jitted closure's trace.

``namespace(name)`` returns the live counter dict, ``snapshot()`` flattens
every counter to ``"ns/key"``, and ``track()`` captures the delta across a
block:

    with compile_log.track() as log:
        sweep.run_sweep(grid, task, num_iters=300, base_cfg=base,
                        device="cpu")
    assert log.counts["sweep/partition"] == 1
"""
from __future__ import annotations

import contextlib
import dataclasses

_namespaces: dict[str, dict[str, int]] = {}
# namespaces whose keys always exist: reset zeroes them instead of removing
_fixed: dict[str, tuple[str, ...]] = {}


def namespace(name: str, keys: tuple[str, ...] = ()) -> dict[str, int]:
    """The live counter dict for ``name`` (created on first use).

    ``keys`` declares counters that always exist: they start at 0, and
    :func:`reset` zeroes them instead of removing them (the ``kernels``
    namespace, whose readers compare whole dicts).
    """
    d = _namespaces.setdefault(name, {})
    if keys:
        _fixed[name] = tuple(dict.fromkeys(_fixed.get(name, ()) + keys))
        for k in keys:
            d.setdefault(k, 0)
    return d


def record(ns: str, key: str, n: int = 1) -> None:
    """Tick ``ns/key`` by ``n``."""
    d = namespace(ns)
    d[key] = d.get(key, 0) + n


def snapshot() -> dict[str, int]:
    """Every counter flattened to ``"ns/key"`` (a copy, artifact-ready)."""
    return {f"{ns}/{k}": v for ns, d in sorted(_namespaces.items())
            for k, v in sorted(d.items())}


def counts(ns: str) -> dict[str, int]:
    """A copy of one namespace's counters."""
    return dict(namespace(ns))


def reset(ns: str | None = None) -> None:
    """Zero one namespace (or every namespace) in place.

    Clearing in place keeps live views (``kernels.common.LAUNCHES``)
    attached; declared keys stay, at 0.
    """
    for name in ([ns] if ns is not None else list(_namespaces)):
        d = namespace(name)
        d.clear()
        d.update(dict.fromkeys(_fixed.get(name, ()), 0))


@dataclasses.dataclass
class TrackedCounts:
    """The delta captured by :func:`track` (filled at block exit)."""

    counts: dict[str, int] = dataclasses.field(default_factory=dict)

    def total(self, ns: str | None = None) -> int:
        """Sum of all ticks, optionally restricted to one namespace."""
        return sum(v for k, v in self.counts.items()
                   if ns is None or k.startswith(ns + "/"))


@contextlib.contextmanager
def track():
    """Capture the counter delta across a block, without resetting.

    Yields a :class:`TrackedCounts` whose ``counts`` maps flattened
    ``"ns/key"`` names to how many ticks happened inside the block.
    Nested tracking works; ticks from other threads are attributed to
    every open tracker (the counters are process-global by design).
    """
    before = snapshot()
    out = TrackedCounts()
    try:
        yield out
    finally:
        after = snapshot()
        out.counts = {k: v - before.get(k, 0) for k, v in after.items()
                      if v != before.get(k, 0)}
