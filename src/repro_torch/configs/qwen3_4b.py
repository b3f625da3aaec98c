"""Qwen3 4B [hf:Qwen/Qwen3-8B family, scaled per assignment].

36L d_model=2560 32H (GQA kv=8, head_dim 128, qk-norm) d_ff=9728
vocab=151936, SwiGLU.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    layer_pattern="A",
    qk_norm=True,
    activation="swiglu",
    rope_theta=1e6,
    scan_period=1,
    tie_embeddings=True,
    long_context_window=4096,    # long_500k via sliding-window VARIANT
    source="hf:Qwen/Qwen3-8B (scaled)",
).validate()
