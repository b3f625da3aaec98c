"""JSONL run logging: one event per round or sweep point (port of
``repro.obs.runlog``).

``RunLog`` writes the run's MetricBags, with its identity (the
``repro_torch.opt`` registry spec, the backend, free-form tags), as
newline-delimited JSON, one self-contained object a line, appended as
rounds complete. The event schema is the JAX package's
(``EVENT_SCHEMA_VERSION``):

    {"schema_version": 1, "event": "<kind>", "step": <int|null>,
     "run": "<name>", "backend": "<reference|cuda|null>",
     "spec": {...} | null, "metrics": {"<name>": <float>, ...}, ...tags}

``metrics`` values are plain numbers (tensors are read back to the host
when the event is written).
"""
from __future__ import annotations

import json
import os
from typing import IO, Any, Optional

import numpy as np
import torch

#: Version of the per-line event schema (bump on breaking layout changes).
EVENT_SCHEMA_VERSION = 1


def _jsonable(v: Any) -> Any:
    """Tensors, numpy scalars and arrays as JSON-native values."""
    if isinstance(v, (str, bool, int, float)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    arr = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)
    return arr.item() if arr.ndim == 0 else arr.tolist()


class RunLog:
    """Append-only JSONL writer for run events.

    Args:
      path: file to append to (created with its directory if missing), or
        ``None`` to keep the lines in memory only (``.lines``).
      run: run name stamped on every event.
      backend: execution backend stamped on every event (``"reference"``,
        ``"cuda"`` or ``None``).
      spec: the run's ``repro_torch.opt`` registry spec, stamped on every
        event that does not carry its own.

    A context manager; ``close`` flushes and releases the file.
    """

    def __init__(self, path: Optional[str] = None, *, run: str = "run",
                 backend: Optional[str] = None,
                 spec: Optional[dict] = None):
        self.path = path
        self.run = run
        self.backend = backend
        self.spec = spec
        self.lines: list[str] = []
        self._fh: Optional[IO[str]] = None
        if path is not None:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(path, "a")

    def write(self, event: str, *, step: Optional[int] = None,
              metrics: Optional[dict] = None,
              spec: Optional[dict] = None, **tags: Any) -> dict:
        """Append one event line; returns the event dict written."""
        doc: dict[str, Any] = {
            "schema_version": EVENT_SCHEMA_VERSION,
            "event": event,
            "step": step,
            "run": self.run,
            "backend": self.backend,
            "spec": _jsonable(spec if spec is not None else self.spec),
            "metrics": {k: _jsonable(v)
                        for k, v in (metrics or {}).items()},
        }
        for k, v in tags.items():
            doc.setdefault(k, _jsonable(v))
        line = json.dumps(doc, sort_keys=True)
        self.lines.append(line)
        if self._fh is not None:
            self._fh.write(line + "\n")
            self._fh.flush()
        return doc

    def write_round(self, step: int, metrics: dict, **tags: Any) -> dict:
        """One optimization round's MetricBag (event kind ``"round"``)."""
        return self.write("round", step=step, metrics=metrics, **tags)

    def write_point(self, index: int, metrics: dict,
                    spec: Optional[dict] = None, **tags: Any) -> dict:
        """One sweep point's summary (event kind ``"point"``)."""
        return self.write("point", step=index, metrics=metrics, spec=spec,
                          **tags)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "RunLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_jsonl(path: str) -> list[dict]:
    """Every event of a JSONL run log (blank lines skipped)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
