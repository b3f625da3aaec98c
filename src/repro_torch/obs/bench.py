"""Schema-versioned ``BENCH_*.json`` artifacts (port of
``repro.obs.bench``).

The envelope is the JAX package's, so a port artifact passes
``python -m repro.obs.bench --validate`` unchanged:

    {"schema_version": 1,
     "kind": "repro-bench",
     "name": "<artifact name>",
     "env": {"jax_version": null, "backend": "gpu|cpu", "x64": true,
             "torch_version": "...", "cuda_version": "...|null",
             "device": "<nvidia-smi name, power.limit>|null"},
     "registry": ["chb", "gd", ...],
     "failed": ["<benchmark name>", ...],
     "benchmarks": {"<name>": {"row": "name,us_per_call,derived",
                               "seconds": <float>, ...payload}}}

``env.jax_version`` is null (the port runs without JAX); ``x64`` is true
because the port draws and decides as the JAX package does under
``jax_enable_x64`` (f64 uniforms, int64 seeds). ``device`` is the line
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
for the first card, so every time in an artifact stands beside the card
and the power limit it was taken at.

    python -m repro_torch.obs.bench --validate BENCH_x.json
"""
from __future__ import annotations

import json
import shutil
import subprocess
from typing import Any, Optional

import torch

#: Version of the artifact envelope (bump on breaking layout changes).
SCHEMA_VERSION = 1

#: The ``kind`` tag distinguishing these artifacts from other JSON files.
KIND = "repro-bench"


def card_line() -> Optional[str]:
    """``nvidia-smi``'s "name, power limit" line of the first card, or
    ``None`` where there is no ``nvidia-smi`` or it fails."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None


def environment() -> dict:
    """The execution environment stamped into every artifact."""
    cuda = torch.cuda.is_available()
    return {
        "jax_version": None,
        "backend": "gpu" if cuda else "cpu",
        "x64": True,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device": card_line() if cuda else None,
    }


def make_artifact(name: str, benchmarks: dict, *,
                  failed: Optional[list] = None,
                  registry: Optional[list] = None,
                  extra: Optional[dict] = None) -> dict:
    """Assemble a schema-conforming artifact (validated: a malformed one
    raises ``ValueError`` here, not later in a reader).

    Args:
      name: artifact name (conventionally the ``BENCH_<name>.json`` stem).
      benchmarks: ``{bench_name: payload}``; every payload carries a
        ``row`` CSV string.
      failed: benchmark names that raised.
      registry: the ``repro_torch.opt`` algorithm names of the run.
      extra: additional top-level keys (must not collide with the schema).
    """
    doc: dict[str, Any] = {
        "schema_version": SCHEMA_VERSION,
        "kind": KIND,
        "name": name,
        "env": environment(),
        "registry": list(registry or []),
        "failed": list(failed or []),
        "benchmarks": dict(benchmarks),
    }
    for k, v in (extra or {}).items():
        if k in doc:
            raise ValueError(f"extra key {k!r} collides with the schema")
        doc[k] = v
    errors = validate_artifact(doc)
    if errors:
        raise ValueError("malformed artifact: " + "; ".join(errors))
    return doc


def validate_artifact(doc: Any) -> list[str]:
    """Every schema violation in ``doc`` (empty list = valid): the
    envelope, and the per-benchmark conventions where their keys are
    present (``specs`` a list or name-keyed object of specs or nulls,
    ``backend`` a string or list, byte counts objects). Unknown extra keys
    are allowed."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return [f"artifact must be a JSON object, got {type(doc).__name__}"]
    ver = doc.get("schema_version")
    if not isinstance(ver, int):
        errs.append("schema_version missing or not an int")
    elif ver > SCHEMA_VERSION:
        errs.append(f"schema_version {ver} is newer than supported "
                    f"{SCHEMA_VERSION}")
    if doc.get("kind") != KIND:
        errs.append(f"kind must be {KIND!r}, got {doc.get('kind')!r}")
    if not isinstance(doc.get("name"), str) or not doc.get("name"):
        errs.append("name missing or empty")
    env = doc.get("env")
    if not isinstance(env, dict):
        errs.append("env missing or not an object")
    else:
        for k in ("jax_version", "backend", "x64"):
            if k not in env:
                errs.append(f"env.{k} missing")
    if not isinstance(doc.get("failed"), list):
        errs.append("failed missing or not a list")
    benches = doc.get("benchmarks")
    if not isinstance(benches, dict):
        errs.append("benchmarks missing or not an object")
        return errs
    for bname, payload in benches.items():
        where = f"benchmarks[{bname!r}]"
        if not isinstance(payload, dict):
            errs.append(f"{where} is not an object")
            continue
        if not isinstance(payload.get("row"), str):
            errs.append(f"{where}.row missing or not a string")
        if "seconds" in payload and \
                not isinstance(payload["seconds"], (int, float)):
            errs.append(f"{where}.seconds is not a number")
        if "specs" in payload:
            specs = payload["specs"]
            vals = list(specs.values()) if isinstance(specs, dict) \
                else specs if isinstance(specs, list) else None
            if vals is None or any(
                    s is not None and not isinstance(s, dict)
                    for s in vals):
                errs.append(f"{where}.specs must be a list (per point) or "
                            "name-keyed object of spec objects/nulls")
        if "backend" in payload and not isinstance(payload["backend"],
                                                   (str, list)):
            errs.append(f"{where}.backend must be a string or list")
        for k in ("measured_bytes", "analytic_bytes"):
            if k in payload and not isinstance(payload[k], dict):
                errs.append(f"{where}.{k} must be an object "
                            "(per-backend/per-kernel byte counts)")
    return errs


def write_artifact(doc: dict, path: str) -> str:
    """Validate and write an artifact; returns ``path``."""
    errors = validate_artifact(doc)
    if errors:
        raise ValueError("refusing to write malformed artifact: "
                         + "; ".join(errors))
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def load_artifact(path: str, *, validate: bool = True) -> dict:
    """Load (and by default validate) a ``BENCH_*.json`` artifact."""
    with open(path) as f:
        doc = json.load(f)
    if validate:
        errors = validate_artifact(doc)
        if errors:
            raise ValueError(f"{path}: " + "; ".join(errors))
    return doc


def _main(argv: Optional[list] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.bench",
        description="Validate BENCH_*.json artifacts against the schema.")
    ap.add_argument("--validate", metavar="PATH", action="append",
                    default=[], help="artifact file to validate "
                    "(repeatable); exits 1 on any violation")
    args = ap.parse_args(argv)
    if not args.validate:
        ap.error("nothing to do; pass --validate PATH")
    bad = 0
    for path in args.validate:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"{path}: unreadable: {e}")
            bad += 1
            continue
        errors = validate_artifact(doc)
        if errors:
            bad += 1
            for e in errors:
                print(f"{path}: {e}")
        else:
            n = len(doc.get("benchmarks", {}))
            print(f"{path}: ok (schema_version="
                  f"{doc.get('schema_version')}, {n} benchmark(s))")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(_main())
