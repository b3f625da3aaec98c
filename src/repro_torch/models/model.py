"""LM composition: embeddings -> pattern-driven blocks -> head.

A port of ``repro/models/model.py``'s ``init_params``, ``param_count``,
``forward``, ``chunked_xent``, ``train_loss``, ``_lm_head``, ``prefill``
and ``serve_step``:

  * train_loss  -- the full sequence, flash attention with its gradient,
                   the chunked cross-entropy (training)
  * prefill     -- the full prompt, returns (last_logits, populated cache)
  * serve_step  -- one token against the cache (decode shapes)

The parameter tree is the JAX package's, with ``blocks`` stacked on a
leading superblock axis, so a JAX tree carries across as it is
(``convert.model_params``). A Python loop over superblocks stands in for
``lax.scan``, and ``torch.utils.checkpoint`` for ``jax.checkpoint``.
``backend="cuda"`` runs each layer's attention through B14 (prefill, and
training's forward with its log-sum-exp), the flash backward kernel
(training) and B13 (decode); ``"reference"`` through their plain
versions. Serving and training run f32, f64 and bf16 configs (bf16 as the
JAX package rounds it: f32 statistics, softmax and attention, one rounding
to bf16 an op; in training the attention's backward too, and autograd
through the same bf16 ops). mamba2, cross-attention, frontends, MoE, other
dtypes and ``remat="dots"`` raise ``NotImplementedError`` (ROADMAP.md
A13).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from .. import random as jrandom
from ..configs.base import ModelConfig
from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from . import kvcache, layers
from .kvcache import UNPORTED, effective_mixer


#: the dtypes of the configs ``prefill`` and ``serve_step`` run, and of
#: those ``forward`` and ``train_loss`` run (bf16 through B14 bf16 with its
#: log-sum-exp and the bf16 build of the flash backward)
SERVE_DTYPES = (torch.float32, torch.float64, torch.bfloat16)
TRAIN_DTYPES = (torch.float32, torch.float64, torch.bfloat16)


def check_supported(cfg: ModelConfig, train: bool = False) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet:
    mamba2, cross-attention, MoE and frontends, checked first; then a dtype
    outside ``SERVE_DTYPES``, or with ``train`` outside ``TRAIN_DTYPES``."""
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
    if cfg.torch_dtype not in (TRAIN_DTYPES if train else SERVE_DTYPES):
        what = f"training in {cfg.dtype} (forward, train_loss)" \
            if cfg.torch_dtype in SERVE_DTYPES else f"dtype {cfg.dtype}"
        raise NotImplementedError(f"{cfg.name}: {what} {UNPORTED}")


# ------------------------------------------------------------------- init
def _init_layer(key: torch.Tensor, cfg: ModelConfig, device) -> dict:
    dt = cfg.torch_dtype
    k1, k2 = jrandom.split(key)
    p = {"norm1": layers.init_rmsnorm(cfg.d_model, dt, device),
         "norm2": layers.init_rmsnorm(cfg.d_model, dt, device),
         "mixer": layers.init_attention(k1, cfg, device)}
    if cfg.d_ff > 0:
        p["ffn"] = layers.init_mlp(k2, cfg, device=device)
    else:
        del p["norm2"]
    return p


def init_params(key: torch.Tensor, cfg: ModelConfig, device=None) -> dict:
    """The JAX package's ``init_params(key, cfg)`` weights from a port PRNG
    key (``repro_torch.random.PRNGKey``), split in the JAX package's order,
    on ``device`` (default the key's; ``"meta"`` gives the shapes alone).

    The normals are f32, JAX's default float without x64, as the JAX
    package's ``launch.serve`` draws them. A large matrix is drawn in
    chunks (``random.CHUNK``), so its int64 temporaries stay small."""
    check_supported(cfg)
    device = key.device if device is None else torch.device(device)
    dt = cfg.torch_dtype
    std = cfg.d_model ** -0.5
    keys = jrandom.split(key, cfg.num_superblocks + 3)
    params = {
        "embed": layers.init_normal(keys[0], (cfg.vocab_size, cfg.d_model),
                                    std, dt, device),
        "final_norm": layers.init_rmsnorm(cfg.d_model, dt, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.init_normal(
            keys[1], (cfg.d_model, cfg.vocab_size), std, dt, device)
    blocks = []
    for s in range(cfg.num_superblocks):
        ks = jrandom.split(keys[3 + s], cfg.scan_period)
        blocks.append({f"l{i}": _init_layer(ks[i], cfg, device)
                       for i in range(cfg.scan_period)})
    params["blocks"] = tree_map(lambda *xs: torch.stack(xs), *blocks)
    return params


def param_count(cfg: ModelConfig) -> int:
    shapes = init_params(jrandom.PRNGKey(0, device="cpu"), cfg,
                         device="meta")
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


# ---------------------------------------------------------------- forward
#: the ``remat`` settings of ``forward``: none, or a checkpoint per
#: superblock (``jax.checkpoint`` with ``nothing_saveable``)
REMATS = ("none", "full")


def _pick_block(l: int, target: int) -> int:
    for b in range(min(target, l), 0, -1):
        if l % b == 0:
            return b
    return 1


def _superblock_forward(block: dict, cfg: ModelConfig, x: torch.Tensor,
                        positions: torch.Tensor, long_mode: bool,
                        backend: str) -> torch.Tensor:
    """One superblock of ``forward`` (JAX's ``superblock`` scan body)."""
    for i, (mixer, _) in enumerate(cfg.block_plan()):
        lp = block[f"l{i}"]
        _, window = effective_mixer(cfg, mixer, long_mode)
        h = layers.rmsnorm(lp["norm1"], x, cfg.rmsnorm_eps)
        mo = layers.attention(lp["mixer"], cfg, h, positions, window=window,
                              backend=backend, train=True)
        x = _ffn(lp, cfg, x + mo)
    return x


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            enc_embeddings: Optional[torch.Tensor] = None, *,
            long_mode: bool = False, moe_mode: str = "scan",
            remat: str = "full", act_spec=None, backend: str = "cuda"):
    """Returns (final hidden states (B, L, D), router aux loss ()).

    The aux loss is the f32 zero of a model without MoE layers (the JAX
    package adds MoE's there). ``remat="full"`` recomputes each superblock
    in the backward pass, ``"none"`` keeps its activations. ``moe_mode`` is
    taken for the JAX signature (no MoE layer runs); ``enc_embeddings``,
    ``act_spec`` (a sharding hint) and ``remat="dots"`` raise."""
    del moe_mode
    check_supported(cfg, train=True)
    layers.check_backend(backend)
    if enc_embeddings is not None or act_spec is not None:
        raise NotImplementedError(f"forward: enc_embeddings and act_spec "
                                  f"(frontends, sharding hints) {UNPORTED}")
    if remat == "dots":
        raise NotImplementedError(f"forward: remat='dots' (saving the "
                                  f"matmuls of a superblock) {UNPORTED}")
    if remat not in REMATS:
        raise ValueError(f"remat must be one of {REMATS + ('dots',)}, got "
                         f"{remat!r}")
    x = params["embed"][tokens]
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    # one unbind a leaf, not a select a superblock: the gradient of the
    # stacked leaf is then one stack of the superblocks' gradients, where
    # selects would each add a zero-filled stacked tensor
    stacked, treedef = tree_flatten(params["blocks"])
    parts = [leaf.unbind(0) for leaf in stacked]
    for s in range(cfg.num_superblocks):
        block = tree_unflatten(treedef, [p[s] for p in parts])
        if remat == "full":
            x = checkpoint(_superblock_forward, block, cfg, x, positions,
                           long_mode, backend, use_reentrant=False)
        else:
            x = _superblock_forward(block, cfg, x, positions, long_mode,
                                    backend)
    x = layers.rmsnorm(params["final_norm"], x, cfg.rmsnorm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _xent_chunk(tot: torch.Tensor, xb: torch.Tensor, yb: torch.Tensor,
                w_head: torch.Tensor) -> torch.Tensor:
    """One chunk of ``chunked_xent``: tot + sum(logsumexp - gold logit)."""
    logits = (xb @ w_head).to(torch.float32)             # (B, ck, V)
    lse = torch.logsumexp(logits, dim=-1)
    # the gold logit by a select over the vocabulary, as the JAX package
    # picks it (an iota compare and a sum, no gather)
    iota = torch.arange(logits.shape[-1], device=logits.device)
    gold = torch.sum(torch.where(iota == yb[..., None], logits, 0.0), dim=-1)
    return tot + torch.sum(lse - gold)


def chunked_xent(x: torch.Tensor, w_head: torch.Tensor,
                 labels: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """Mean cross-entropy without holding the (B, L, V) logits: the
    sequence in chunks of the largest divisor of L up to ``chunk``, each
    recomputed in the backward pass (``jax.checkpoint``'s
    counterpart), the f32 logits of one chunk alive at a time."""
    b, l, d = x.shape
    ck = _pick_block(l, chunk)
    nc = l // ck
    xc = x.reshape(b, nc, ck, d).transpose(0, 1)          # (nc, B, ck, D)
    yc = labels.reshape(b, nc, ck).transpose(0, 1)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for xb, yb in zip(xc.unbind(0), yc.unbind(0)):
        tot = checkpoint(_xent_chunk, tot, xb, yb, w_head,
                         use_reentrant=False)
    return tot / (b * l)


def train_loss(params: dict, cfg: ModelConfig, batch: dict, *,
               moe_mode: str = "scan", remat: str = "full", act_spec=None,
               backend: str = "cuda"):
    """(loss, {"xent", "router_aux"}) of one batch {"tokens", "labels"}."""
    if "enc_embeddings" in batch:
        raise NotImplementedError(f"train_loss: enc_embeddings (frontends) "
                                  f"{UNPORTED}")
    x, aux = forward(params, cfg, batch["tokens"], moe_mode=moe_mode,
                     remat=remat, act_spec=act_spec,
                     long_mode=batch.get("long_mode", False),
                     backend=backend)
    loss = chunked_xent(x, _lm_head(params, cfg), batch["labels"])
    total = loss + cfg.router_aux_coef * aux
    return total, {"xent": loss, "router_aux": aux}


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
