"""MusicGen-medium [arXiv:2306.05284].

48L d_model=1536 24H (MHA kv=24, head_dim 64) d_ff=6144, vocab 2048
(EnCodec codebook). Decoder-only over EnCodec tokens; the conditioning
frontend (text/melody -> frame embeddings) is STUBBED: input_specs provides
precomputed (B, 256, 768) frame embeddings consumed as a prefix via a
learned projector (DESIGN.md §4).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    layer_pattern="A",
    activation="gelu",
    frontend="audio",
    num_frontend_tokens=256,
    d_frontend=768,
    scan_period=1,
    long_context_window=4096,    # long_500k via sliding-window VARIANT
    source="arXiv:2306.05284",
).validate()
