"""repro_torch: the CHB federated-optimization core in PyTorch, for CUDA.

The package mirrors ``repro``'s layout (``core/``, ``data/``, ``opt/``,
``fed/``, ``kernels/``, ``models/``, ...) so every module has a
counterpart of the same name; ``random`` is the part of ``jax.random``
the package draws from, bit for bit. It runs Algorithm 1
(``core.simulator.run`` -> ``opt.ComposedOptimizer.step``) and the
event-driven edge runtime (``fed.run_edge``) on an NVIDIA Hopper card
through hand-written CUDA kernels (``kernels/csrc/``), with a plain
PyTorch version beside each kernel.

Device rule: every entry point takes ``device=None``, which resolves to
``cuda`` and raises ``RuntimeError`` when no card is present (see
``device.resolve_device``). ``device="cpu"`` is the only way onto the
CPU. Parameter trees are a single tensor or (nested) dicts of tensors,
flattened in sorted-key order (``tree.py``).
"""
__version__ = "0.1.0"
