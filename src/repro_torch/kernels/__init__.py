"""The port's hand-written CUDA kernels (Hopper, sm_90a).

Each kernel keeps the JAX package's layout, one subpackage per TPU kernel:

  ops.py   the wrapper (launches the CUDA kernel on CUDA tensors, runs the
           plain PyTorch version on CPU tensors, counts launches) and the
           plain version itself, with a note on what bounds the kernel;
           inside a CUDA graph no wrapper runs on a replay, so the
           executor that captured it adds the capture's counts instead
           (``_build.add_launches``, ``core/dso.py``);
  ref.py   the oracle, ported from the JAX ``ref.py``.

The CUDA sources live in ``repro_torch/csrc`` and are built by ``_build``.
Kernels: fused_score (K1: two-segment candidate scoring over pooled,
quantized history KV), flash_attention (K2: GQA flash attention, four
masks), fused_ffn (K3: fused norm + FFN), flash_decode (K4: single-token
decode attention over a valid cache prefix) and rwkv6_scan (K5: the chunked
RWKV-6 wkv scan on the text engine's prefill).  Every TPU kernel of the JAX
package now has its Hopper counterpart."""
