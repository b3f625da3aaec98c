"""KV caches for decode (port of ``repro/models/kvcache.py``).

Cache layout per sub-layer kind, stacked over superblocks (leading S axis):
  "A" full attention : {"k", "v"}: (S, B, C, K, hd) with C = cache_len
  "S" sliding window : the same with C = min(window, cache_len), a ring
                       buffer, slot = pos % C

The JAX package's (B, C, K, hd) layout is kept, so caches compare directly.
Slot positions come from the scalar ``pos`` (``slot_positions``); no
per-slot metadata is stored. Unlike the JAX package, ``write_kv`` updates
the cache in place: a functional copy would rewrite the whole cache on
every decode step. ``%`` on tensors and on Python ints is floor-mod here,
as ``jnp``'s is; C's ``%`` is not, so no slot arithmetic runs in a kernel.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device

UNPORTED = "is not ported yet (ROADMAP.md A13)"


def effective_mixer(cfg: ModelConfig, mixer: str,
                    long_mode: bool) -> tuple[str, int | None]:
    """Resolve (kind, window) given the long-context variant flag."""
    if mixer == "A":
        if long_mode and cfg.long_context_window:
            return "S", cfg.long_context_window
        return "A", None
    if mixer == "S":
        return "S", cfg.sliding_window
    return mixer, None


def slot_positions(pos, c: int, device=None) -> torch.Tensor:
    """(C,) int32: the absolute position held by each ring slot given the
    current pos. Slot i holds the latest q < pos with q % C == i; -1 if
    never written. ``device`` defaults to ``pos``'s if it is a tensor,
    else to the card."""
    if device is None and isinstance(pos, torch.Tensor):
        device = pos.device
    i = torch.arange(c, dtype=torch.int32, device=resolve_device(device))
    q = (pos - 1 - torch.remainder(pos - 1 - i, c)).to(torch.int32)
    return torch.where(q >= 0, q, torch.full_like(q, -1))


def cache_len_of(cfg: ModelConfig, kind: str, window, cache_len: int) -> int:
    """The slots of one sub-layer's cache: ``cache_len`` for "A",
    ``min(window, cache_len)`` for "S"."""
    return cache_len if kind == "A" else min(window, cache_len)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               long_mode: bool = False, device=None) -> dict:
    """Zeroed cache tree, leaves stacked over superblocks (leading S
    axis)."""
    device = resolve_device(device)
    kh, hd, s = cfg.num_kv_heads, cfg.head_dim, cfg.num_superblocks
    out = {}
    for i, (mixer, _) in enumerate(cfg.block_plan()):
        kind, window = effective_mixer(cfg, mixer, long_mode)
        if kind not in ("A", "S"):
            raise NotImplementedError(f"the {kind!r} cache {UNPORTED}")
        c = cache_len_of(cfg, kind, window, cache_len)
        out[f"l{i}"] = {
            x: torch.zeros((s, batch, c, kh, hd), dtype=cfg.torch_dtype,
                           device=device) for x in ("k", "v")}
    return out


def write_kv(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
             pos: int) -> dict:
    """Write one token's k/v (B, 1, K, hd) at ring slot pos % C, in place;
    returns ``cache``."""
    slot = int(pos) % cache["k"].shape[1]
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    return cache


def fill_from_prefill(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor,
                      c: int) -> dict:
    """Arrange prefill k/v (B, L, K, hd) into a C-slot ring cache."""
    l = k.shape[1]
    i = torch.arange(c, dtype=torch.int64, device=k.device)
    src = l - 1 - torch.remainder(l - 1 - i, c)      # latest pos per slot
    src_c = torch.clamp(src, 0, l - 1)
    return {"k": k.index_select(1, src_c), "v": v.index_select(1, src_c)}
