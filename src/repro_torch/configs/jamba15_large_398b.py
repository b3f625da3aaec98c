"""Jamba-1.5-Large 398B [arXiv:2403.19887].

72L d_model=8192 64H (GQA kv=8, head_dim 128) d_ff=24576, MoE 16 experts
top-2 on every other layer, Mamba:attention 7:1 interleave (1 attention
layer per 8-layer block). long_500k native (SSM + 9 attention layers).

Adaptation note (DESIGN.md §3): Jamba uses Mamba-1 selective scan; we use
the Mamba-2 SSD mixer (state 64) — the TPU-native chunked dual form.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    layer_pattern="MMMAMMMM",    # attention at index 3 of each 8-block
    activation="swiglu",
    num_experts=16,
    num_experts_per_tok=2,
    d_ff_expert=24576,
    moe_layer_period=2,
    moe_layer_offset=1,
    ssm_state_dim=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    scan_period=8,
    source="arXiv:2403.19887",
).validate()
