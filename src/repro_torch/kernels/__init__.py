"""Hand-written CUDA kernels of the CHB step, with their plain versions.

``censor`` (B1, B4, B8, B9, B12a, B12b), ``fused_step`` (B2, B5, B6),
``hb_update`` (B3), ``quantize_ef`` (B7a, B7b), ``topk_pack`` (B10),
``lowrank_ef`` (B11), ``decode_attention`` (B13), ``flash_attention``
(B14) and ``flash_backward`` (the port-only attention backward of
training) hold the kernel wrappers; ``ref`` the plain PyTorch versions;
``ops`` the tree-level dispatch the ``backend="cuda"`` optimizer runs and
the single-tensor entry points; ``build`` compiles ``csrc/`` with ``nvcc``
on first use. See ``common`` for the dispatch rule.
"""
from . import (build, censor, common, decode_attention, flash_attention,
               flash_backward, fused_step, hb_update, lowrank_ef, ops,
               quantize_ef, ref, topk_pack)
