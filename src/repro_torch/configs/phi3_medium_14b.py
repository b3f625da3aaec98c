"""Phi-3-medium 14B [arXiv:2404.14219].

40L d_model=5120 40H (GQA kv=10, head_dim 128) d_ff=17920 vocab=100352,
RoPE + SwiGLU + GQA.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100352,
    layer_pattern="A",
    activation="swiglu",
    rope_theta=1e4,
    scan_period=1,
    long_context_window=4096,    # long_500k via sliding-window VARIANT
    source="arXiv:2404.14219",
).validate()
