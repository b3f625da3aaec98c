"""repro_torch.obs: per-round telemetry and host-side sinks (port of
``repro.obs``).

  * ``obs.metrics`` -- the ``MetricBag``: a flat dict of named 0-d
    observables that ``simulator.trajectory(collect_metrics=True)``,
    ``sweep.run_sweep`` and ``fed.run_edge`` collect without changing the
    run (a metrics-on run is bit-identical to a metrics-off one).
  * ``obs.runlog`` -- JSONL event writer; ``obs.compile_log`` --
    process-wide counters (kernel launches and builds, simulator runs,
    sweep partitions, edge-runtime stage calls); ``obs.profile`` --
    profiler spans and trace capture; ``obs.bench`` -- schema-versioned
    ``BENCH_*.json`` artifacts, valid under the JAX package's validator.

The JAX package's ``obs.hlo_report`` reads compiled XLA programs and has
no counterpart here.
"""
from . import bench, compile_log, metrics, profile, runlog
from .compile_log import TrackedCounts
from .metrics import (MetricBag, metric_names, stage_metrics, step_metrics,
                      summarize)
from .profile import annotate, annotate_fn, named_scope, trace
from .runlog import EVENT_SCHEMA_VERSION, RunLog, read_jsonl

__all__ = [
    "bench", "compile_log", "metrics", "profile", "runlog",
    "TrackedCounts", "MetricBag", "metric_names", "stage_metrics",
    "step_metrics", "summarize", "annotate", "annotate_fn", "named_scope",
    "trace", "RunLog", "read_jsonl", "EVENT_SCHEMA_VERSION",
]
