"""Nemotron-4 15B [arXiv:2402.16819].

32L d_model=6144 48H (GQA kv=8, head_dim 128) d_ff=24576 vocab=256000,
squared-ReLU MLP (no gating), RoPE.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    layer_pattern="A",
    activation="squared_relu",
    rope_theta=1e4,
    scan_period=1,
    long_context_window=4096,    # long_500k via sliding-window VARIANT
    source="arXiv:2402.16819",
).validate()
