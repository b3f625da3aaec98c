"""Model configuration schema shared by every assigned architecture.

A port of ``repro/configs/base.py``: the same fields, derived properties,
``layer_plan``, ``block_plan``, ``validate`` and ``reduced``, with
``torch_dtype`` in place of ``jnp_dtype``. The config files beside it are
plain data, copied as they are.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


# Mixer kinds (per-layer): A full attention, S sliding-window attention,
# M mamba2 (SSD), X cross-attention (VLM image layers).
MIXERS = ("A", "S", "M", "X")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention / layer pattern ---
    # repeated cyclically to num_layers; one char per layer from MIXERS
    layer_pattern: str = "A"
    sliding_window: int = 4096
    qk_norm: bool = False
    rope_theta: float = 1e4

    # --- feedforward ---
    activation: str = "swiglu"       # swiglu | squared_relu | gelu
    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    d_ff_expert: int = 0
    moe_layer_period: int = 1        # layer l uses MoE iff num_experts>0 and
    moe_layer_offset: int = 0        # (l % period) == offset
    router_aux_coef: float = 0.01

    # --- SSM (mamba2 / SSD) ---
    ssm_state_dim: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4

    # --- modality frontend stubs (vlm / audio) ---
    frontend: Optional[str] = None   # "vision" | "audio"
    num_frontend_tokens: int = 0
    d_frontend: int = 0

    # --- misc ---
    rmsnorm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # period used for scan-over-layers; must divide num_layers and be a
    # multiple of the layer_pattern / MoE interleave periods
    scan_period: int = 1
    # if set, 'A' layers are lowered as sliding-window with this window for
    # the long_500k shape (the explicit long-context VARIANT; DESIGN.md §4)
    long_context_window: Optional[int] = None
    # source citation
    source: str = ""

    # ------------------------------------------------------------ derived
    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def mixer_at(self, layer: int) -> str:
        return self.layer_pattern[layer % len(self.layer_pattern)]

    def is_moe_layer(self, layer: int) -> bool:
        return (self.num_experts > 0
                and layer % self.moe_layer_period == self.moe_layer_offset)

    def layer_plan(self) -> Tuple[Tuple[str, bool], ...]:
        """(mixer, is_moe) per layer."""
        return tuple((self.mixer_at(l), self.is_moe_layer(l))
                     for l in range(self.num_layers))

    def block_plan(self) -> Tuple[Tuple[str, bool], ...]:
        """The repeating super-block pattern (length scan_period)."""
        plan = self.layer_plan()
        period = self.scan_period
        assert self.num_layers % period == 0, (self.name, period)
        proto = plan[:period]
        for s in range(self.num_layers // period):
            assert plan[s * period:(s + 1) * period] == proto, \
                f"{self.name}: layer plan not periodic with scan_period={period}"
        return proto

    @property
    def num_superblocks(self) -> int:
        return self.num_layers // self.scan_period

    def validate(self) -> "ModelConfig":
        assert self.num_heads % max(self.num_kv_heads, 1) == 0
        if "M" in self.layer_pattern:
            assert self.ssm_state_dim > 0
            assert self.d_inner % self.ssm_head_dim == 0
        if self.num_experts:
            assert 0 < self.num_experts_per_tok <= self.num_experts
            assert self.d_ff_expert > 0
        if self.frontend:
            assert self.num_frontend_tokens > 0 and self.d_frontend > 0
        self.block_plan()
        return self

    def reduced(self, num_layers: int = 2, d_model: int = 256,
                max_experts: int = 4, vocab: int = 512) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        # keep the pattern FLAVOUR: ordered-unique mixers, fit to num_layers
        seen = []
        for l in range(self.num_layers):
            mx = self.mixer_at(l)
            if mx not in seen:
                seen.append(mx)
        pattern = "".join((seen * num_layers)[:num_layers])
        heads = 4
        kv = min(self.num_kv_heads, heads)
        kv = next(k for k in range(kv, 0, -1) if heads % k == 0)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=num_layers,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=d_model // heads,
            d_ff=d_model * 4 if self.d_ff > 0 else 0,
            vocab_size=vocab,
            layer_pattern=pattern or "A",
            sliding_window=64,
            num_experts=min(self.num_experts, max_experts),
            num_experts_per_tok=min(self.num_experts_per_tok, 2),
            d_ff_expert=d_model * 2 if self.num_experts else 0,
            ssm_state_dim=32 if self.ssm_state_dim else 0,
            ssm_head_dim=32 if self.ssm_state_dim else 64,
            ssm_chunk=16,
            num_frontend_tokens=8 if self.frontend else 0,
            d_frontend=64 if self.frontend else 0,
            scan_period=num_layers,
            dtype="float32",
            long_context_window=None,
        ).validate()
