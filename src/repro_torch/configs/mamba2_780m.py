"""Mamba-2 780m [arXiv:2405.21060].

48L d_model=1536, attention-free SSD (state-space duality), ssm_state=128,
head_dim 64, expand 2, vocab 50280. No MLP blocks (d_ff=0): the mamba mixer
IS the layer, as in the paper. long_500k native (constant-size state).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=1,          # unused (attention-free)
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    layer_pattern="M",
    ssm_state_dim=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    scan_period=1,
    tie_embeddings=True,
    source="arXiv:2405.21060",
).validate()
