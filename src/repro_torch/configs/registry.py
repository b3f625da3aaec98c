"""Architecture registry: --arch <id> resolution (port of
``repro/configs/registry.py``)."""
from __future__ import annotations

from . import (chb_paper_lm, gemma3_12b, jamba15_large_398b,
               llama32_vision_90b, mamba2_780m, mixtral_8x22b,
               musicgen_medium, nemotron4_15b, phi3_medium_14b, qwen3_4b,
               qwen3_moe_235b_a22b)
from .base import ModelConfig

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [
        qwen3_moe_235b_a22b.CONFIG,
        gemma3_12b.CONFIG,
        musicgen_medium.CONFIG,
        mixtral_8x22b.CONFIG,
        mamba2_780m.CONFIG,
        llama32_vision_90b.CONFIG,
        jamba15_large_398b.CONFIG,
        qwen3_4b.CONFIG,
        phi3_medium_14b.CONFIG,
        nemotron4_15b.CONFIG,
        chb_paper_lm.CONFIG,
    ]
}

ASSIGNED = [n for n in ARCHS if n != "chb-paper-lm-124m"]


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
