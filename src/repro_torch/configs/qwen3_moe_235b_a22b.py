"""Qwen3-MoE 235B-A22B [hf:Qwen/Qwen3-30B-A3B family, scaled per assignment].

94L d_model=4096 64H (GQA kv=4, head_dim 128, qk-norm) 128 experts top-8,
expert d_ff=1536, vocab 151936. MoE on every layer (no shared dense MLP).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    layer_pattern="A",
    qk_norm=True,
    activation="swiglu",
    num_experts=128,
    num_experts_per_tok=8,
    d_ff_expert=1536,
    rope_theta=1e6,
    scan_period=1,
    long_context_window=4096,   # explicit long-context VARIANT for long_500k
    source="hf:Qwen/Qwen3-30B-A3B (scaled)",
).validate()
