"""FLAME on PyTorch and CUDA — the port of the JAX package ``repro``.

The JAX package stays the reference; this package imports neither it nor
JAX.  Module names mirror the JAX package (``repro_torch/core/climber.py``
ports ``repro/core/climber.py`` and so on).  Entry points run on the GPU
(``device="cuda"``) unless the caller asks for the CPU; on the GPU the
attention of the serving path runs two hand-written CUDA kernels
(``kernels/flash_attention`` and ``kernels/fused_score``)."""
