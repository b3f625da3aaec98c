"""Transformer building blocks: norms, RoPE, GQA attention, MLPs.

A port of ``repro/models/layers.py`` without its cross-attention (which
waits for the frontends, ROADMAP.md A13) and without the sharding hints of
``models/tuning.py``, which are off by default and add no arithmetic.
``init_*`` build a parameter dict from a JAX PRNG key
(``repro_torch.random``), splitting it as the JAX package does, so the
weights are the JAX package's; the other functions apply one. Parameters
and activations stay in the config's dtype; softmax and norm statistics
run in f32.

``backend`` picks the attention of ``attention`` and ``decode_attention``:
``"cuda"`` runs the kernels B14 and B13 (which run their plain versions on
CPU tensors), ``"reference"`` their plain versions. The JAX package
computes the same two functions in ``jnp`` (its blocked flash attention
and an einsum), never through its Pallas kernels.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import random as jrandom
from ..configs.base import ModelConfig
from ..kernels import decode_attention as decode_kernel
from ..kernels import ops, ref

BACKENDS = ("cuda", "reference")


def check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")


def init_normal(key: torch.Tensor, shape, std: float, dtype, device
                ) -> torch.Tensor:
    """``(normal(key, shape) * std).astype(dtype)`` as the JAX package's
    ``launch.serve`` draws it (without x64: f32 normals), on ``device``;
    on the meta device only the shape."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    x = jrandom.normal(key.to(device), shape, torch.float32)
    return (x * std).to(dtype)


# ------------------------------------------------------------------ norms
def init_rmsnorm(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


# ------------------------------------------------------------------- RoPE
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., L, H, d); positions: (L,)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs     # (L, half)
    cos = torch.cos(ang)[..., None, :]                       # (L, 1, half)
    sin = torch.sin(ang)[..., None, :]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- attention
def init_attention(key: torch.Tensor, cfg: ModelConfig,
                   device=None) -> dict:
    device = key.device if device is None else device
    d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = cfg.torch_dtype
    std = d ** -0.5
    ks = jrandom.split(key, 4)
    p = {
        "wq": init_normal(ks[0], (d, h * hd), std, dt, device),
        "wk": init_normal(ks[1], (d, kh * hd), std, dt, device),
        "wv": init_normal(ks[2], (d, kh * hd), std, dt, device),
        "wo": init_normal(ks[3], (h * hd, d), (h * hd) ** -0.5, dt, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, dt, device)
        p["k_norm"] = init_rmsnorm(hd, dt, device)
    return p


def _project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 kv_src: torch.Tensor):
    b, l, _ = x.shape
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, l, h, hd)
    k = (kv_src @ p["wk"]).reshape(b, kv_src.shape[1], kh, hd)
    v = (kv_src @ p["wv"]).reshape(b, kv_src.shape[1], kh, hd)
    if "q_norm" in p:
        q = rmsnorm(p["q_norm"], q, cfg.rmsnorm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.rmsnorm_eps)
    return q, k, v


def attention(p: dict, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, *, window: Optional[int] = None,
              backend: str = "cuda") -> torch.Tensor:
    """Causal self-attention over x: (B, L, D); positions: (L,)."""
    check_backend(backend)
    b, l, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, x)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    # (B, H, L, d) views of (B, L, H, d): B14 reads them by strides
    o = ops.flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=True,
                                window=window,
                                use_pallas=backend == "cuda")
    o = o.transpose(1, 2).reshape(b, l, -1)
    return o @ p["wo"]


def decode_attention(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_pos: torch.Tensor, pos: int, *,
                     backend: str = "cuda") -> torch.Tensor:
    """Single-token decode: x (B, 1, D) against a populated cache.

    k_cache/v_cache: (B, C, K, hd), already holding the new token's k/v;
    cache_pos: (C,) absolute position of each slot (-1 empty); pos: the
    current absolute position.
    """
    check_backend(backend)
    b = x.shape[0]
    h, hd = cfg.num_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, 1, h, hd)
    if "q_norm" in p:
        q = rmsnorm(p["q_norm"], q, cfg.rmsnorm_eps)
    # a fill, not a copy from the host: a copy would wait for the stream
    q = rope(q, torch.full((1,), pos, dtype=torch.int32, device=x.device),
             cfg.rope_theta)
    # (B, K, C, hd) views of the (B, C, K, hd) cache: no copy a step
    kt, vt = k_cache.transpose(1, 2), v_cache.transpose(1, 2)
    attend = decode_kernel.decode_attention if backend == "cuda" \
        else ref.decode_attention_ref
    o = attend(q[:, 0], kt, vt, cache_pos, pos)
    return o.reshape(b, 1, h * hd) @ p["wo"]


def compute_kv(p: dict, cfg: ModelConfig, x: torch.Tensor,
               positions: Optional[torch.Tensor]):
    """k, v for cache fill: (B, L, K, hd); RoPE applied iff positions
    given."""
    b, l, _ = x.shape
    kh, hd = cfg.num_kv_heads, cfg.head_dim
    k = (x @ p["wk"]).reshape(b, l, kh, hd)
    v = (x @ p["wv"]).reshape(b, l, kh, hd)
    if "k_norm" in p:
        k = rmsnorm(p["k_norm"], k, cfg.rmsnorm_eps)
    if positions is not None:
        k = rope(k, positions, cfg.rope_theta)
    return k, v


# -------------------------------------------------------------------- MLP
def init_mlp(key: torch.Tensor, cfg: ModelConfig,
             d_ff: Optional[int] = None, device=None) -> dict:
    device = key.device if device is None else device
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = cfg.torch_dtype
    std_in, std_out = d ** -0.5, f ** -0.5
    ks = jrandom.split(key, 3)
    p = {"wi": init_normal(ks[0], (d, f), std_in, dt, device)}
    if cfg.activation == "swiglu":
        p["wg"] = init_normal(ks[1], (d, f), std_in, dt, device)
    p["wo"] = init_normal(ks[2], (f, d), std_out, dt, device)
    return p


def mlp(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.activation == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    elif cfg.activation == "squared_relu":
        h = torch.square(torch.relu(x @ p["wi"]))
    elif cfg.activation == "gelu":
        h = F.gelu(x @ p["wi"], approximate="tanh")
    else:
        raise ValueError(cfg.activation)
    return h @ p["wo"]
