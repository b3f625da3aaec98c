"""A ~124M decoder LM used by the end-to-end CHB training example
(examples/train_llm_chb.py). Not part of the assigned pool; sized so a few
hundred CHB steps run on CPU/laptop scale as the paper's "train a neural
network" experiment scaled up to the LLM era.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chb-paper-lm-124m",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=32768,
    layer_pattern="A",
    activation="swiglu",
    scan_period=1,
    dtype="float32",
    source="paper Sec. IV NN experiment, scaled to an LM",
).validate()
