"""Tree checkpointing: flattened-path npz (port of
``repro/checkpoint/checkpoint.py``).

A file's keys are ``jax.tree_util.keystr`` paths (``['params']['embed']``,
``.prev_params`` for a named tuple's field, ``[0]`` for a sequence's
entry), with ``/`` written as ``||``, and its arrays are numpy's, bf16
saved as f32 (lossless). So a file written by either package restores in
the other. ``save`` copies the leaves to the host; ``restore`` places
each leaf on the device and in the dtype of the matching leaf of
``like``. The JAX package's ``shardings`` argument has no counterpart
here (one device).
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch

_SEP = "||"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_path(tree: Any, prefix: str, out: list) -> None:
    """(keystr path, leaf) pairs in ``jax.tree_util``'s order: dict keys
    sorted, named-tuple fields and sequence entries in order, ``None`` and
    empty containers holding no leaf."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            _flatten_with_path(tree[key], f"{prefix}[{key!r}]", out)
    elif _is_namedtuple(tree):
        for field in tree._fields:
            _flatten_with_path(getattr(tree, field), f"{prefix}.{field}",
                               out)
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            _flatten_with_path(x, f"{prefix}[{i}]", out)
    elif tree is not None:
        out.append((prefix, tree))


def _rebuild(tree: Any, leaves) -> Any:
    """``tree``'s structure with its leaves taken in order from ``leaves``."""
    if isinstance(tree, dict):
        return {key: _rebuild(tree[key], leaves) for key in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, f), leaves)
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(x, leaves) for x in tree)
    if tree is None:
        return None
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:     # no numpy bf16: f32, lossless
            leaf = leaf.to(torch.float32)
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def keyed_leaves(tree: Any) -> dict[str, np.ndarray]:
    """{keystr path: numpy array} of every leaf of ``tree``."""
    out: list = []
    _flatten_with_path(tree, "", out)
    return {path: _to_numpy(leaf) for path, leaf in out}


def save(path: str, tree: Any, metadata: Optional[dict] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = keyed_leaves(tree)
    np.savez(path if path.endswith(".npz") else path + ".npz",
             **{k.replace("/", _SEP): v for k, v in flat.items()})
    if metadata is not None:
        # the JAX package's naming, rstrip and all
        with open(path.rstrip(".npz") + ".meta.json", "w") as f:
            json.dump(metadata, f)


def restore(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors): each
    leaf in the dtype and on the device of ``like``'s leaf at its path."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    paths: list = []
    _flatten_with_path(like, "", paths)
    with np.load(path) as data:
        leaves = []
        for key, leaf in paths:
            arr = data[key.replace("/", _SEP)]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"restore: {key} has shape {arr.shape} in "
                                 f"{path}, the tree wants "
                                 f"{tuple(leaf.shape)}")
            leaves.append(torch.from_numpy(np.array(arr)).to(
                device=leaf.device, dtype=leaf.dtype))
    return _rebuild(like, iter(leaves))


def load_metadata(path: str) -> dict:
    with open(path.rstrip(".npz") + ".meta.json") as f:
        return json.load(f)
