"""The decoder LM of the JAX package's ``repro/models``, for training and
serving.

``layers`` (norms, RoPE, GQA attention, MLPs), ``flash`` (attention with
its gradient), ``kvcache`` (ring caches) and ``model`` (``init_params``,
``forward``, ``chunked_xent``, ``train_loss``, ``prefill``,
``serve_step``). The ``cuda`` backend runs the attention of prefill
through B14, of a training step through B14 and the flash backward
kernel, and of every decode step through B13; the ``reference`` backend
runs their plain versions. Only the dense attention family is ported,
served in f32, f64 and bf16 and trained in f32 and f64: mamba2 (``M``),
cross-attention and frontends (``X``), MoE, bf16 training and other
dtypes raise ``NotImplementedError`` (ROADMAP.md A13).
"""
from . import flash, kvcache, layers, model
