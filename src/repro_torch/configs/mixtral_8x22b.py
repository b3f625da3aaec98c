"""Mixtral 8x22B [arXiv:2401.04088].

56L d_model=6144 48H (GQA kv=8, head_dim 128) expert d_ff=16384,
8 experts top-2, vocab 32768, sliding-window attention (4096) per the
assignment. long_500k supported natively via SWA.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    layer_pattern="S",
    sliding_window=4096,
    activation="swiglu",
    num_experts=8,
    num_experts_per_tok=2,
    d_ff_expert=16384,
    rope_theta=1e6,
    scan_period=1,
    source="arXiv:2401.04088",
).validate()
