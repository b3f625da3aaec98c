"""Llama-3.2-Vision 90B [hf:meta-llama/Llama-3.2-11B-Vision, scaled].

100L d_model=8192 64H (GQA kv=8, head_dim 128) d_ff=28672 vocab=128256.
Every 5th layer is a cross-attention image layer. The ViT vision encoder is
STUBBED: input_specs provides (B, 1600, 7680) patch embeddings consumed via
a learned projector + cross-attention (DESIGN.md §4).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    layer_pattern="AAAAX",
    activation="swiglu",
    rope_theta=5e5,
    frontend="vision",
    num_frontend_tokens=1600,
    d_frontend=7680,
    scan_period=5,
    long_context_window=4096,    # long_500k via sliding-window VARIANT
    source="hf:meta-llama/Llama-3.2-11B-Vision (scaled)",
).validate()
