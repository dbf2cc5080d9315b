"""FLAME on PyTorch and CUDA — the port of the JAX package ``repro``.

The JAX package stays the reference; this package imports neither it nor
JAX.  Module names mirror the JAX package (``repro_torch/core/climber.py``
ports ``repro/core/climber.py`` and so on).  Entry points run on the GPU
(``device="cuda"``) unless the caller asks for the CPU; on the GPU the
serving paths run five hand-written CUDA kernels (``kernels/``): K1-K4 on
Climber scoring and generation, K5 on the text engine's rwkv6-7b
prefill."""
