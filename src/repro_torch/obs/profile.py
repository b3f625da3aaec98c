"""Profiler hooks: named spans and trace capture around hot paths (port of
``repro.obs.profile``).

  * :func:`annotate` -- a named span on the profiler timeline
    (``torch.profiler.record_function``) and, on a CUDA machine, an NVTX
    range (``torch.cuda.nvtx``) that external CUDA tools show.
  * :func:`annotate_fn` -- the decorator form of :func:`annotate`.
  * :data:`named_scope` -- ``torch.profiler.record_function``: a span that
    only ``torch.profiler`` sees (the JAX package's ``jax.named_scope``,
    which tags compiled ops, has no eager counterpart closer than this).
  * :func:`trace` -- capture a ``torch.profiler`` trace of a block (CPU
    activity, and CUDA activity where a card is present) and write it as
    a Chrome trace, ``<log_dir>/trace.json`` (Perfetto opens it). A
    profiler that cannot start leaves the block running unprofiled.

None of these changes what the block computes.
"""
from __future__ import annotations

import contextlib
import functools
import os
from typing import Iterator, Optional

import torch

#: A span that ``torch.profiler`` records (no NVTX range).
named_scope = torch.profiler.record_function


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named span on the profiler timeline, and an NVTX range on a CUDA
    machine."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def annotate_fn(name: Optional[str] = None):
    """Decorator: run the function under :func:`annotate`."""
    def deco(fn):
        label = name or fn.__name__

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with annotate(label):
                return fn(*args, **kwargs)
        return wrapped
    return deco


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[Optional[torch.profiler.profile]]:
    """Profile the block into ``<log_dir>/trace.json``.

    Yields the ``torch.profiler.profile`` (for ``key_averages()``), or
    ``None`` if the profiler could not start; the block runs either way.
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    try:
        prof.__enter__()
    except RuntimeError:          # a runtime without profiler support
        yield None
        return
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
