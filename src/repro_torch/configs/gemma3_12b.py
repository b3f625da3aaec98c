"""Gemma-3 12B [hf:google/gemma-3-1b-pt family, scaled per assignment].

48L d_model=3840 16H (GQA kv=8, head_dim 256) d_ff=15360 vocab=262144.
5:1 local:global attention (sliding window 1024), 128k context class.
long_500k is supported natively: 40/48 layers are sliding-window.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    layer_pattern="SSSSSA",      # 5 local : 1 global
    sliding_window=1024,
    qk_norm=True,
    activation="gelu",
    rope_theta=1e6,
    scan_period=6,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt (scaled)",
).validate()
