"""LM composition for serving: embeddings -> pattern-driven blocks -> head.

A port of ``repro/models/model.py``'s ``init_params``, ``param_count``,
``_lm_head``, ``prefill`` and ``serve_step``:

  * prefill     -- the full prompt, returns (last_logits, populated cache)
  * serve_step  -- one token against the cache (decode shapes)

The parameter tree is the JAX package's, with ``blocks`` stacked on a
leading superblock axis, so a JAX tree carries across as it is
(``convert.model_params``). A Python loop over superblocks stands in for
``lax.scan``. ``backend="cuda"`` runs each layer's attention through B14
(prefill) and B13 (decode); ``"reference"`` through their plain versions.
``forward``, ``train_loss`` and ``chunked_xent`` wait for training, and
mamba2, cross-attention, frontends, MoE and sub-f32 configs raise
``NotImplementedError`` (ROADMAP.md A13).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..tree import tree_leaves, tree_map
from . import kvcache, layers
from .kvcache import UNPORTED, effective_mixer


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    mixers = set(cfg.layer_pattern) - {"A", "S"}
    if mixers:
        raise NotImplementedError(
            f"{cfg.name}: mixer(s) {sorted(mixers)} (mamba2 'M', "
            f"cross-attention 'X') {UNPORTED}")
    if cfg.num_experts:
        raise NotImplementedError(f"{cfg.name}: MoE layers {UNPORTED}")
    if cfg.frontend:
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend} frontend "
                                  f"{UNPORTED}")
    if cfg.torch_dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(f"{cfg.name}: dtype {cfg.dtype} (bf16 "
                                  f"configs) {UNPORTED}")


# ------------------------------------------------------------------- init
def _init_layer(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    dt = cfg.torch_dtype
    p = {"norm1": layers.init_rmsnorm(cfg.d_model, dt, device),
         "norm2": layers.init_rmsnorm(cfg.d_model, dt, device),
         "mixer": layers.init_attention(gen, cfg, device)}
    if cfg.d_ff > 0:
        p["ffn"] = layers.init_mlp(gen, cfg, device=device)
    else:
        del p["norm2"]
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    """Random weights drawn from ``gen``, on ``device`` (default the
    generator's; ``"meta"`` gives the shapes alone). Normal draws scaled by
    fan-in^-0.5 as in the JAX package, whose ``PRNGKey`` weights these are
    not: the same weights wait for the JAX PRNG (ROADMAP.md A5)."""
    check_supported(cfg)
    device = gen.device if device is None else torch.device(device)
    dt = cfg.torch_dtype
    std = cfg.d_model ** -0.5
    params = {
        "embed": layers.init_normal(gen, (cfg.vocab_size, cfg.d_model), std,
                                    dt, device),
        "final_norm": layers.init_rmsnorm(cfg.d_model, dt, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.init_normal(
            gen, (cfg.d_model, cfg.vocab_size), std, dt, device)
    blocks = [{f"l{i}": _init_layer(gen, cfg, device)
               for i in range(cfg.scan_period)}
              for _ in range(cfg.num_superblocks)]
    params["blocks"] = tree_map(lambda *xs: torch.stack(xs), *blocks)
    return params


def param_count(cfg: ModelConfig) -> int:
    shapes = init_params(torch.Generator(), cfg, device="meta")
    return sum(math.prod(x.shape) for x in tree_leaves(shapes))


def _lm_head(params: dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def _superblock(tree, s: int):
    """Superblock ``s`` of a tree stacked on a leading superblock axis (a
    view: writes land in the stacked tensors)."""
    return tree_map(lambda x: x[s], tree)


def _ffn(lp: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    if "ffn" not in lp:
        return h
    h2 = layers.rmsnorm(lp["norm2"], h, cfg.rmsnorm_eps)
    return h + layers.mlp(lp["ffn"], cfg, h2)


# ---------------------------------------------------------------- prefill
def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            cache_len: Optional[int] = None, long_mode: bool = False,
            backend: str = "cuda"):
    """Full-sequence pass; returns (last-token logits (B, V) f32, the
    populated cache)."""
    check_supported(cfg)
    layers.check_backend(backend)
    x = params["embed"][tokens]
    l_total = x.shape[1]
    cache_len = cache_len or l_total
    positions = torch.arange(l_total, dtype=torch.int32, device=x.device)
    plan = cfg.block_plan()
    caches = []
    for s in range(cfg.num_superblocks):
        block = _superblock(params["blocks"], s)
        cache = {}
        for i, (mixer, _) in enumerate(plan):
            lp = block[f"l{i}"]
            kind, window = effective_mixer(cfg, mixer, long_mode)
            hn = layers.rmsnorm(lp["norm1"], x, cfg.rmsnorm_eps)
            mo = layers.attention(lp["mixer"], cfg, hn, positions,
                                  window=window, backend=backend)
            k, v = layers.compute_kv(lp["mixer"], cfg, hn, positions)
            c = kvcache.cache_len_of(cfg, kind, window, cache_len)
            cache[f"l{i}"] = kvcache.fill_from_prefill(cfg, k, v, c)
            x = _ffn(lp, cfg, x + mo)
        caches.append(cache)
    cache = tree_map(lambda *xs: torch.stack(xs), *caches)
    x = layers.rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps)
    last = x[:, -1, :] @ _lm_head(params, cfg)
    return last.to(torch.float32), cache


# ----------------------------------------------------------------- decode
def serve_step(params: dict, cfg: ModelConfig, cache: dict,
               tokens: torch.Tensor, pos: int, *, backend: str = "cuda"):
    """One decode step; tokens (B, 1), pos the current position (an int).

    Writes the token's k/v into ``cache`` in place and returns
    (logits (B, V) f32, cache). Each cache's slot count (set by
    ``prefill``, long-context variant included) decides its ring.
    """
    check_supported(cfg)
    layers.check_backend(backend)
    pos = int(pos)
    x = params["embed"][tokens]                       # (B, 1, D)
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    plan = cfg.block_plan()
    slots: dict[int, torch.Tensor] = {}                # cache_pos by C
    for s in range(cfg.num_superblocks):
        block = _superblock(params["blocks"], s)
        block_cache = _superblock(cache, s)
        for i in range(len(plan)):
            lp, cc = block[f"l{i}"], block_cache[f"l{i}"]
            hn = layers.rmsnorm(lp["norm1"], x, cfg.rmsnorm_eps)
            k, v = layers.compute_kv(lp["mixer"], cfg, hn, positions)
            kvcache.write_kv(cc, k, v, pos)
            c = cc["k"].shape[1]
            if c not in slots:
                slots[c] = kvcache.slot_positions(pos + 1, c, x.device)
            mo = layers.decode_attention(lp["mixer"], cfg, hn, cc["k"],
                                         cc["v"], slots[c], pos,
                                         backend=backend)
            x = _ffn(lp, cfg, x + mo)
    x = layers.rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps)
    logits = (x[:, 0, :] @ _lm_head(params, cfg)).to(torch.float32)
    return logits, cache
