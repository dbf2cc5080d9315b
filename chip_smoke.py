#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, in order (any failure exits non-zero; no phase's failure is caught):

1. prints the card (``nvidia-smi`` name and power limit) and builds every
   CUDA kernel of the port from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all started together), printing the build time;
2. kernel phases (K1 fused_score, K2 flash_attention, K3 fused_ffn, K4
   flash_decode, K5 rwkv6_scan): each kernel's wrapper on CUDA tensors
   against its plain PyTorch version on the same inputs, at the serving
   path's shapes and over a sweep of edge cases, within a stated tolerance
   (K1 also: bf16 over int8 and bf16 history, in cached mode and in extend
   mode — the latter at M = 1, 16, 17 and 129, with and without lengths (a
   prefix of length 0 among them), suffix operands contiguous and strided
   as views of one QKV projection —, the rows of an M = 5 call bitwise
   those of an M = 128 (cached) or 129 (extend) call, lengths == S bitwise
   no lengths, a padded history bitwise the tight one, two calls bitwise,
   and head dims between the instantiations — 24 at the examples' shapes,
   40, 8 and 100 — padded by the wrapper, every mode and dtype;
   K2 also: two
   calls bitwise equal, the pool-off ``full`` family's monolithic SUMI
   shapes [4, 257 + bucket, 4, 64] checked, and the pallas ``cached``
   shape and the ``full`` shape [4, 385, 4, 64] timed beside SDPA with the
   SUMI mask, the latter with its bound; K3 also: the
   rows of T = 1028 and T = 5 calls bitwise those of a T = 2100 call, and
   two calls bitwise equal; K4 both forms — the self-slot form the pallas
   ``decode`` / ``append`` families run, with padded == tight, rows
   independent of M and two calls bitwise, timed beside SDPA on the
   materialized operands and on the per-candidate cache copies the TPU
   route builds, and those copies timed; the single-token form with padded
   == tight and two calls bitwise at G = 1 and 4 with a window, timed at
   [512, 266, 4, 64] beside SDPA with a length mask; K1-K5 print their
   launch's grid and shared memory beside the ptxas registers; K5 also:
   strong-decay runs, a ragged tail, the token-by-token oracle, the state
   carried over two calls, each row of a batch bitwise the row called
   alone, and the ``submit`` shape [1, 300, 64, 64] timed beside the path
   shape, with every term of its bound; K1 and K4's self-slot form also
   with a per-candidate (packed) pool-row index at alignments 1, 8 and 16,
   each live slot bitwise the unpacked call of its row; K1's ``extend``
   mode at the ``extend`` family's shapes, [4, 1, 4, 64] over 256 prefix
   rows and [4, 129, 4, 64] over 128, its launch plan on the tensor cores,
   timed beside SDPA causal with an offset mask);
   then times the kernel, the plain version and
   one PyTorch library call of the same function
   (``scaled_dot_product_attention``; matmul-gelu-matmul for K3; none
   exists for K5) with CUDA events, median of repeats, both on the device
   alone (calls replayed from a CUDA graph: the JSON line's times) and as
   eager calls with their host work; then F2's remainder (``f2_phase``):
   each kernel's any-dims variant, which its wrapper picks from the dims
   past the tiled kernels' instantiations (K1 past head dim 128
   (``k1_any_phase``, ``csrc/score_any.cu``): against its twin at D 160,
   192, 256, 320 and 512 in both modes, for bf16 and f32 q over int8,
   bf16 and f32 history, with and without the dedup index and lengths,
   packed at alignments 1, 8 and 16 with each live slot bitwise its
   unpacked call, rows of M = 5 bitwise those of M = 128 / 129, padded
   past lengths == tight and two calls bitwise at D 192, 256 and 512,
   timed at the wide-head Climber's ``cached``, ``extend`` and packed
   shapes beside SDPA and the bound, one launch a call, each shape's plan
   (cluster, CTAs, shared bytes, resident clusters, waves) printed; then
   one call of K1 (both routes),
   K2's tiled kernel and K4's self-slot form at B * H just past 65535
   against their plain versions (``grid_limit_checks``); K2 at [4, 500,
   8, D], D 320
   and 512 in bf16 and 256 in f32, ``causal`` and ``sliding``; K4's split
   decode, the single-token form at D 512 and at G 8 x D 256 over 528
   keys and at [1, 16, 256] over 4096, its self-slot form at D 256; K3 in
   f32 at d 1024, d_ff 4096, T 4 and 512, and in bf16 at d 1020, d_ff
   4100; K5 at [4, 500, 32, 128]), each against its plain twin, one
   call's launches (its ``plan()``'s) counted under its TPU kernel, K2-K5
   bitwise across two calls and K4 on a cache padded past ``lengths``,
   timed beside its bound and its library call; K2 also checked under
   ``full`` (Sq != Sk) and sumi with ``q_offset``, at ragged head dims
   and at 17 head-dim passes (D 4100); K5 at head sizes 100 and 256,
   split in the middle of a chunk against the whole sequence, and a row
   alone bitwise the same row in a batch;
3. scoring engine phase: ``create_engine("flame", ...)`` at the published
   Climber width (d_model 256, 4 x 64 heads, d_ff 1024, 2 blocks x 12
   layers, vocab 2,000,000, bf16 weights from a seeded generator),
   history-KV pool with int8 storage, ``impl="fused"``; after a warm-up
   round, 14 requests from 4 repeat users so that misses, single-flight
   waits, hits and dedup occur.
   Every executor of the engine is a CUDA graph captured at construction,
   one per (kind, bucket, dispatcher) with a stream of its own.
   Checks that every future resolves, that a user's hit equals its miss
   bitwise, that both kernels launched on the main path (24 launches per
   encode / cached dispatch, counted per replay), that every captured
   executor equals its eager function bitwise and that a dispatch's
   outputs survive the next dispatch on its executor, and that the scores
   match the port's plain path on the CPU (same weights copied to the CPU)
   within tolerance.  Prints the capture time and the graphs' memory,
   per-request encode and scoring times, per-dispatch times in the engine,
   and each executor's work called outside the engine (one eager call; the
   captured executor on one thread; a CUDA-graph replay);
4. generation phases, ``impl="pallas"`` then ``impl="fused"``: the same
   engine with ``generate=8, gen_vocab=256``, int8 pool, four users asking
   for top-k and beam generation twice (miss, then hit) plus one scoring
   request.  Checks the output shapes, hit == miss, each kernel's launches
   per dispatch (pallas: 24 K2 + 24 K3 per encode / cached, 24 K4 (its
   self-slot form) + 24 K3 per decode / append; fused: K1 on cached /
   decode / append, no K3 or K4), and under pallas the first decode step against the port's plain
   path on the CPU from the same stored root, under fused the root decode
   against cached scoring, bitwise; every captured executor equals its
   eager function bitwise and keeps its outputs over the next dispatch.
   Prints the decode and append executors' times (in the engine, one eager
   call alone, the captured executor alone, CUDA graph).
   Then "extend + packing" (``extend_pack_phase``): engines with
   ``incremental_history=True, pack_tails=True`` at the same width serve
   12 stale hits (a tail append, edits at window positions 400 and 300)
   through the ``extend`` family (K1's extend mode, K2 where a block's
   prefix is empty), each extended entry within 5e-2 (int8; 5e-3 on a
   bf16 pool) of a fresh encode; 12 ragged scoring requests at once
   through the packed ``cached`` family (K1 with a 2-D index) against an
   unpacked engine from the same stored rows (within 2e-3; bitwise at the
   unpacked row count); ragged top-k and beam generation through the
   packed ``decode`` family under fused and pallas (K4's self-slot form
   with a 2-D index; tokens equal the unpacked engine's at its row
   count); every executor's launches per replay against the counters,
   replay == eager for every executor; prints the padded fractions and
   the new executors' times.  Then "full + implicit"
   (``full_implicit_phase``): ``FlameEngine(history_cache=False)`` at the
   same width and on the scoring phase's traffic under fused, pallas and
   chunked (24 K2 launches per ``full`` replay, and 24 K3 under pallas,
   no K1 or K4; no kernel under chunked; replay == eager; 8 requests
   served alone bitwise as served concurrently; scores within 2e-2 of the
   CPU plain path, chunked's within 5e-3 of fused's), then the
   ``"implicit"`` engine under fused over M in {40, 77, 130}, three
   requests each, twice (``jit_compiles`` == 3, graphs captured in band,
   scores within 2e-3 of the ``full`` family's; first requests and
   replays timed apart, the graphs' memory printed).  Then "dso pool"
   (``dso_pool_phase``): the paper's fixed executor pool — the ``full``
   family under fused as an ``ExecutorPool`` over (128, 64, 32), two
   executors a bucket, each its own capture on its own stream, behind a
   ``DynamicStreamOrchestrator`` of 8 workers — serving 16 requests at
   once, M over {128, 256, 512, 1024} and {40, 77, 130, 300, 1000}: scores
   within 5e-3 of one eager reference call of each whole M, no executor
   held by two threads at once, 24 K2 launches a chunk; each M's time
   through the pool beside the implicit engine's and its padded
   fraction.  Then "wide heads" (``wide_head_phase``): the published
   Climber with only its head dim widened, to 256 and then 192, through
   one ``FlameEngine(impl="fused")`` each (int8 pool, incremental history,
   generation): scoring misses and hits, four stale hits through
   ``extend`` (within 5e-2 of a fresh encode), top-k and beam generation
   (``decode`` / ``append``) on a miss and a hit; hit == miss bitwise,
   every kernel launch an executor replay's (K1's any-dims variant two
   kernels a call: 48 a replay of ``cached``, ``decode``, ``append`` and
   ``extend``), replay == eager for every executor, and top-k generation
   == repeated prefill (each beam's cache rebuilt from the stored root at
   every step).  Then a small engine under ``impl="reference"`` (generate
   4): every family captures
   (its decode route reads no length on the host), each executor equals
   its eager function bitwise, and a generation's hit equals its miss;
5. text phase: ``create_engine("text", ...)`` serving rwkv6-7b at full
   width (32 layers, d_model 4096, 64 x 64 heads, d_ff 14336, vocab 65536,
   bf16 weights from a seeded generator): 4 prompts of 500 tokens through
   ``generate``, then prompts of 130 and 300 tokens through ``submit``, 16
   greedy tokens each.  Checks the outputs, 32 K5 launches per prefill call
   and none in decode, the engine's captured decode step (one CUDA graph
   per number of prompt rows) against an eager decode loop token for token
   at batch 4, greedy == repeated prefill on one prompt (near ties
   reported), and a 2-layer cut of the model on the card against the
   port's plain path on the CPU.  Prints prefill ms per request and decode
   ms per token, and the batch-4 prefill and decode step alone (eager, the
   captured step, and replayed from a CUDA graph) with K5's share of the
   prefill;
6. text shapes and text attention phases: K2, K3, K4 (single-token form)
   and K5 at the attention text kinds' shapes against their plain versions
   and timed beside their bounds and library calls (K2 at gemma3-12b's
   prefill q [4, 500, 16, 240], ``sliding`` window 1024 and ``causal``, at
   h2o-danube-3-4b's [4, 500, 32, 120] ``sliding`` 4096, and at [4, 1100,
   16, 240] window 1024, SDPA with the mask beside; K3's wide form at d
   3840, T in {2000, 1100, 33, 32, 4, 1} (its prefill and decode paths),
   gelu d_ff 15360 and swiglu d_ff 10240, the matmul chain beside, its
   launch plan (path, grids, ring stages, workspace) checked against the
   wrapper's, and the prefill path's rows of a T 300 call bitwise those of
   a T 2100 call; K4 at q [4, 16, 240] over 528 keys, SDPA with a
   length mask beside; K5 at head size 48, padded); then
   ``create_engine("text", ...)`` serving gemma3-12b (48 layers, 5 ``swa``
   : 1 ``attn``, d_model 3840, 16 x 240 heads over 8, d_ff 15360 gelu,
   vocab 262144) and then h2o-danube-3-4b (24 ``swa`` layers, 32 x 120
   heads over 8, d_ff 10240 swiglu, vocab 32000) at full width with bf16
   weights from a seeded generator, each freed before the next, under
   ``impl="pallas"``: 4 prompts of 500 tokens through ``generate``, prompts
   of 130 and 300 tokens through ``submit`` (caches of 528 positions), and
   for gemma3 a 1100-token prompt through an engine of max_len 1152 (its
   1024-slot ``swa`` rings wrap), 16 greedy tokens each.  Checks the
   outputs, the launches (per prefill one K2 and one K3 a layer, per decode
   step one K3 a layer and one K4 a non-ring ``attn`` layer), the captured
   decode steps against an eager decode loop token for token, greedy ==
   repeated prefill (near ties reported), and the pallas logits against the
   same bundle's kernel-free routes on the card (prefill against
   ``chunked``, a decode step against ``reference``; mean error gated at
   the bf16 contract).  Prints prefill and decode times, a decode step
   alone at batch 4 and 1 beside the weight bound, capture time and graph
   memory;
7. the other text families: K2, K3 and K4 at their shapes
   (``family_kernel_shapes``: K2 ``full`` with Sq != Sk — seamless's
   cross-attention 32 x 1024, 1024 x 32, an unaligned 37 x 1001, two calls
   bitwise —, seamless's encoder and decoder, the ``causal`` prefills of
   jamba, kimi (head dim 112 padded to 128), llama4, qwen2-72b,
   qwen1.5-32b and llava at 3380 positions; K3's wide form at each
   family's (d, d_ff, activation) at T 4 and its prefill T, 13,520 for
   llava; K4 at kimi's G 8, llama4's G 5, qwen2-72b's G 8 and
   qwen1.5-32b's G 1), each against its plain version and timed beside its
   bound and library call; then seven phases at full width with seeded
   bf16 weights, each model freed before the next: jamba-v0.1-52b (16 of
   32 layers, 14 ``mamba`` + 2 ``attn``, 8 MoE of 16 experts top-2; 51.6
   GB), kimi-k2-1t-a32b (1 of 61 layers, MoE of 384 experts top-8 with a
   shared expert; 38.9 GB), llama4-maverick-400b-a17b (2 of 48 layers, one
   dense and one MoE of 128 experts top-1 with a shared expert; 37.1 GB),
   qwen2-72b and qwen1.5-32b (``attn`` with QKV bias, cut to the depths of
   ``FAMILY_CUTS``) through the text engine as the attention kinds above
   (launches: K2 once an attention layer, K3 once a layer with a dense FFN
   or a shared expert, K4 once an ``attn`` layer per decode step; the
   kernel-free routes replay the pallas route's expert choices; jamba's
   prefill held against the chunked route in f32, pallas no further from
   it than bf16 chunked + 5e-3; greedy == repeated prefill on the same
   weights at a capacity that drops nothing, a step reported where the
   decode step and the prefill route the token fed to other experts;
   the prefill's shares of the Mamba blocks, their scan, the MoE layers and
   their expert GEMMs printed); llava-next-mistral-7b (all 32 layers)
   through the text engine on tokens, then through its bundle with 2880
   stub patch embeddings + 500 tokens at batch 4 (K2 at 3380 positions, K3
   at T 13,520, K4 over 3396 keys) and 16 eager decode steps;
   seamless-m4t-large-v2 (12 + 12 layers) through its bundle: 1024 stub
   frames and a 32-token prefix at batch 4 (K2 ``full`` / ``causal`` /
   cross ``full``, K3 gelu; no K4), 16 eager decode steps; each path's
   pallas logits against the kernel-free routes on the card and greedy ==
   repeated prefill;
8. training (``train_phase``; no kernel: Climber under ``reference``,
   text under ``chunked``): Climber at its published width through
   ``launch.train.main`` (batch 16, 512 history items + 64 candidates a
   user, 30 steps) into a checkpoint, every loss finite and the mean of
   the last 5 below the first 5's, step 0's loss on 2 users within 5e-3
   of the port's plain path on the CPU from the same weights and batch
   and its global grad norm within 2e-2 relative, the checkpoint restored
   bitwise and served through the flame engine as in phase 3 (int8 pool,
   fused: hit == miss, 24 K2 launches per ``encode`` and 24 K1 per
   ``cached`` dispatch, scores against the CPU plain path); then
   h2o-danube-3-4b at full width and depth (batch 8 x 512 tokens, 10
   steps, peak lr 3e-4, remat), every loss finite and the last below the
   first, step 0's loss on 2 layers of the same weights and a [1, 128]
   batch within 5e-3 of the CPU's; a loss under ``impl="pallas"`` with
   weights requiring grad raises.  Prints the step time (median of steps
   3 onward), AdamW and forward + backward apart (CUDA events), user-item
   pairs/s or tokens/s, 6·N·tokens over the step time against 989 TFLOP/s
   and the peak memory, beside the card;
9. examples (``examples_phase``): the five ``examples/torch_*.py``, a
   process each, three at a time, at their JAX twins' sizes through the entry points a user
   calls (quickstart under pallas, serve_e2e — training, the pool-off
   engine, the pooled engine within 2e-3 of it —, mixed_traffic_dso, the
   text example on gemma3-12b and on rwkv6-7b, train_climber cut to 30
   steps): each exits 0, prints its own checks OK and the launches of its
   path's kernels, which count toward the JSON line; each one's seconds
   printed;
10. roofline (``roofline_phase``): ``roofline.analyse`` with
   ``types.H100`` for the Climber families at batch 4 (``encode``,
   ``cached``, ``extend``, ``decode``, ``append``, ``full``; counted on
   their ``reference`` route with fake tensors, timed as the fused
   executor's replay), the captured decode steps of gemma3-12b and
   h2o-danube-3-4b and the training steps of Climber and h2o-danube-3-4b
   (counted and timed by phases 6 and 8): FLOPs, bytes, ``memory_s_est``,
   the bound and its term, the measured time and bound / measured (gated
   at 1.05), the unfused ``memory_s`` as a ceiling, and a training step's
   model FLOPs share of the peak;
11. prints one JSON line listing every ported kernel (launches summed over
   the main paths, K4's two forms together; K1's any-dims variant its own
   entry, ``fused_score_any``, launched by the wide-head phases), then the
   result line.

Without CUDA, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
sys.path.insert(0, SRC)
try:
    from repro_torch.types import H100
except ImportError:         # not a checkout: main() says so and exits 3
    H100 = None

# published H100 SXM peaks (NVIDIA data sheet, dense), for bound_ms: the
# bf16 tensor cores and HBM from the port's HardwareSpec (one source)
HBM_BYTES_PER_S = H100.hbm_bw if H100 else None
BF16_FLOP_PER_S = H100.peak_flops if H100 else None
F32_FLOP_PER_S = 67e12     # f32 outside the tensor cores
TF32_FLOP_PER_S = 495e12   # TF32 on the tensor cores
EXP_PER_SM_CLOCK = 16      # special-function unit: exponentials
SM_CLOCK_HZ = 1.98e9       # published boost clock
F32_TOL = 2e-5          # f32 operands: reassociated softmax / scale math
BF16_ATOL, BF16_RTOL = 1e-3, 1.6e-2   # bf16 outputs: 2 bf16 ulps
SCORE_TOL = 2e-2        # engine vs CPU plain path, int8 pool (tests' QTOL)
# first decode step on the card vs the CPU plain path from the same stored
# int8 root: bf16 rounding at other places over 2 x 12 layers
GEN_TOL = 2e-2
GEN_STEPS = 8           # generation capacity and steps per request
# an extended int8 pool entry vs a fresh encode of the same history: the
# extension re-quantizes its basis (new absmax scales over prefix and
# suffix), so the codes move by a rounding each time (tests/test_pda_v2.py
# :446 bounds one extension's drift at 2e-2 on a small model); bf16 pool:
# one bf16 rounding of the stored rows
EXT_TOL_INT8 = 5e-2
EXT_TOL_BF16 = 5e-3
# packed (pack_rows = max_batch // 4) vs unpacked engines from the same
# stored rows: the packed executors' products have fewer rows, and cuBLAS
# rounds a product of the same rows otherwise at another row count, so a
# score may move in its last bits (measured up to 1.5e-7 on an H100); the
# JAX package's cross-executable tolerance for this A/B
# (tests/test_dso_v2.py).  At the unpacked row count packing is bitwise.
PACK_TOL = 2e-3
GEN_VOCAB = 256         # token universe of a request without candidates
# the pool-off ``full`` family under chunked (plain PyTorch, f32 softmax
# over bf16 operands) vs fused (K2) on the same requests: bf16 rounding at
# other places over 2 x 12 layers, the bf16 kernel tolerance of
# ROADMAP.md's numeric contract
CHUNKED_TOL = 5e-3
# the implicit engine (batch 1, each request at its own M) vs the full
# family (batch 4, bucket-padded chunks): the layers' products run at other
# shapes, so cuBLAS rounds otherwise; the packed-vs-unpacked bound
IMPLICIT_TOL = 2e-3
IMPLICIT_COUNTS = (40, 77, 130)   # candidate counts of the implicit engine
# K5 vs its plain version, relative to the output's scale.  f32: the
# exponents are differences of per-chunk cumulative log decays reaching
# 1280 in magnitude (f32 spacing 1.2e-4), summed in another order by the
# kernel (sequentially) and torch.cumsum; bf16 outputs: 2 bf16 ulps
K5_F32_TOL = 5e-4
K5_BF16_TOL = 8e-3
# chunked vs token by token, relative to the scale: the JAX test's 2e-3
# (tests/test_kernels.py); under strong decay the chunked form's exponents
# cancel at |la| ~ 1e3, a few 1e-3 absolute on outputs of scale ~10
K5_ORACLE_TOL = 2e-3
TEXT_PROMPT = 500       # tokens per prompt of the batched generate
TEXT_TOKENS = 16        # generated tokens per request
# rwkv6-7b on the card vs the port's plain path on the CPU, 2 layers at
# full width, logits relative to their scale.  f32 weights: the same
# function on both sides; the group norm of the first positions is
# ill-conditioned (there a head's output is a multiple of v, normalised by
# its own small size) and turns 1e-6 differences of the scan into 1e-4 of
# its output on an H100.  bf16 weights: one-ulp rounding flips of the
# projections (cuBLAS and CPU sums) compound over two layers; on an H100
# the mean stayed near 1.3e-2 while the max went from 2.4e-2 on one set of
# weights to 0.108 on another, at those first positions, so the bf16 max
# is reported and the mean gated
TEXT_F32_TOL = 1e-3
TEXT_BF16_MEAN_TOL = 3e-2
# a model with Mamba layers: the pallas prefill's mean error against the
# kernel-free route in f32 may exceed the kernel-free bf16 route's own by
# at most this (the port's bf16 / kernel-path tolerance, ROADMAP.md)
TEXT_F32_MARGIN = 5e-3
# greedy steps whose reference top-2 logit gap is below this are reported,
# not gated: prefill and decode round bf16 at other places over 32 layers
TIE_GAP = 0.1

# the decoder families the text engine serves at full width after the
# attention kinds, with the depth each is cut to (0: all its layers) so
# that it fits 80 GB: jamba 16 of 32 layers (51.6 GB), kimi 1 of 61 (38.9
# GB), llama4 one dense and one MoE layer of 48 (128 experts of 3 x 5120 x
# 8192: 33.0 GB a period, 4.1 GB of embeddings and head).  qwen2-72b is
# 1.756 GB a layer + 5.0 GB of embeddings and head: at 42 layers its phase
# peaked at 81.5 GB of the 84.0 free, so 40 leave ~6 GB for what earlier
# phases hold.  qwen1.5-32b is 1.052 GB a layer + 3.1 GB, and its 40 KV
# heads make the caches large: a prefill's new caches of 528 positions,
# listed per layer and then stacked, with the engine's own, take 0.13 GB a
# layer more, and all 64 layers ran out of memory in the prefill; 58 leave
# ~5 GB (the initializer draws a stacked leaf one layer at a time, so its
# f32 draw no longer sets the depth)
FAMILY_CUTS = (("jamba-v0.1-52b", 16), ("kimi-k2-1t-a32b", 1),
               ("llama4-maverick-400b-a17b", 2), ("qwen2-72b", 40),
               ("qwen1.5-32b", 58))

REPLACES = {
    "fused_score": "src/repro/kernels/fused_score/kernel.py:138",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:165",
    "fused_ffn": "src/repro/kernels/fused_ffn/kernel.py:60",
    "flash_decode": "src/repro/kernels/flash_decode/kernel.py:67",
    "rwkv6_scan": "src/repro/kernels/rwkv6_scan/kernel.py:70",
}


def fail(msg: str):
    raise SystemExit(f"[chip_smoke] FAIL: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def call_ms(fn, reps: int = 50, warm: int = 5) -> float:
    """Median time of one eager call, host work included: CUDA events
    around the call on an idle device, so the Python wrapper's own time
    counts whenever it is longer than the kernel's (warm L2)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


def host_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median wall time of one call that ends in a device synchronize (host
    clock): what one thread pays for a call, host work and device work."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, per_graph: int = 20, reps: int = 20) -> float:
    """Median device time of one call, host work excluded: ``per_graph``
    calls captured in one CUDA graph, each replay timed with CUDA events
    and divided by ``per_graph`` (warm L2)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm up off the capture stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / per_graph)
    times.sort()
    return times[len(times) // 2]


def timings(name: str, kernel, plain, library):
    """Device and eager-call times of the kernel, its plain version and
    the library call (None where no one PyTorch call computes the same
    function); prints them and returns the device times."""
    fns = [f for f in (kernel, plain, library) if f is not None]
    dev = [device_ms(f) for f in fns]
    eager = [call_ms(f) for f in fns]
    lib = (f"library {dev[2]:.4f} / {eager[2]:.4f}" if library is not None
           else "library none")
    print(f"[chip_smoke] {name} ms per call, device (CUDA graph) / eager "
          f"call: kernel {dev[0]:.4f} / {eager[0]:.4f}, plain "
          f"{dev[1]:.4f} / {eager[1]:.4f}, {lib}")
    return dev + [None] * (3 - len(dev))


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(n_bytes: float, flops: float, peak: float = BF16_FLOP_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def close(got, want, what: str):
    """Max abs error of ``got`` vs ``want``; fails past the dtype's
    tolerance."""
    import torch
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail(f"{what}: non-finite kernel output")
    if got.dtype == torch.float32:
        atol, rtol = F32_TOL, F32_TOL
    else:
        atol, rtol = BF16_ATOL, BF16_RTOL
    err = (g - w).abs()
    if bool((err > atol + rtol * w.abs()).any()):
        fail(f"{what}: max abs err {err.max().item():.3g} beyond "
             f"atol {atol:g} + rtol {rtol:g}")
    return err.max().item()


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

#: the local dims the mesh phase's (1, 2) ranks launch K1-K3 at:
#: Climber's 4 heads and 4 KV heads, 2 a rank; the pool-off ``full``
#: family's FFN at b128 (4 rows of 257 + 128 tokens), d_ff 1024 / 2
MESH_LOCAL_HEADS = (2, 2)
MESH_LOCAL_FFN = (4 * (257 + 128), 256, 512)


def k1_phase(device):
    """fused_score (K1): every mode and history dtype against the plain
    version; returns its JSON entry measured at the cached-scoring shapes
    of the engine phase."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.fused_score import ops as fs
    from repro_torch.serving.kv_cache import _int8

    g = torch.Generator(device=device).manual_seed(1)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=device).to(dtype)

    def case(b, m, u, s, h, hkv, d, *, qdt, hist, mode, dedup, lengths,
             unaligned=False, fused_qkv=False):
        if fused_qkv:     # views of one projection, as project_qkv's
            qkv = rnd(b, m, h + 2 * hkv, d, dtype=qdt)
            q, kc, vc = (qkv[:, :, :h], qkv[:, :, h:h + hkv],
                         qkv[:, :, h + hkv:])
        else:
            q, kc, vc = (rnd(b, m, n, d, dtype=qdt) for n in (h, hkv, hkv))
        kf, vf = rnd(u, s, hkv, d, dtype=torch.float32), \
            rnd(u, s, hkv, d, dtype=torch.float32)
        if unaligned:     # rows off 16-byte boundaries: the scalar loads
            kc, vc = (torch.cat([t[..., :1], t], -1)[..., 1:]
                      for t in (kc, vc))
        ks = vs = None
        if hist == "int8":
            (kh, ks), (vh, vs) = _int8(kf[:, None]), _int8(vf[:, None])
            kh, vh, ks, vs = kh[:, 0], vh[:, 0], ks[:, 0], vs[:, 0]
        else:
            kh, vh = kf.to(hist), vf.to(hist)
        if unaligned:
            kh, vh = (torch.cat([t[..., :1], t], -1)[..., 1:]
                      for t in (kh, vh))
        args = dict(mode=mode, k_scale=fs._norm_scale(ks, u, hkv),
                    v_scale=fs._norm_scale(vs, u, hkv),
                    row_index=(torch.arange(b, device=device) % u)
                    .to(torch.int32) if dedup else None,
                    lengths=torch.tensor([0] + [s - 1] * (u - 1),
                                         device=device, dtype=torch.int32)
                    if lengths else None)
        out = fs.fused_score(q, kh, vh, kc, vc, **args)
        torch.cuda.synchronize()
        want = fs.fused_score_plain(q, kh, vh, kc, vc, **args)
        err = close(out, want, f"fused_score {mode} q={qdt} hist={hist} "
                               f"dedup={dedup} lengths={lengths} "
                               f"{(b, m, u, s, h, hkv, d)}")
        return err, (q, kh, vh, kc, vc, args)

    shapes = [(4, 128, 4, 257, 4, 4, 64),      # engine's cached bucket 128
              (4, 32, 2, 257, 4, 4, 64),       # engine's bucket 32, deduped
              (3, 37, 3, 70, 4, 2, 32),        # ragged M and S, GQA
              (2, 9, 2, 5, 2, 1, 16)]          # tiny, S < one tile
    # the mesh phase's (1, 2) ``cached`` dispatches: each rank's 2 of the
    # 4 heads at every bucket
    shapes += [(4, m, u, 257, *MESH_LOCAL_HEADS, 64)
               for m, u in ((128, 4), (64, 2), (32, 1))]
    n_cases = 0
    for qdt in (torch.bfloat16, torch.float32):
        for hist in ("int8", torch.bfloat16, torch.float32):
            for mode in ("cached", "extend"):
                for i, shp in enumerate(shapes):
                    for dedup in (True, False):
                        if not dedup:      # one pool row per batch row
                            shp = (shp[0], shp[1], shp[0]) + shp[3:]
                        case(*shp, qdt=qdt, hist=hist, mode=mode,
                             dedup=dedup, lengths=(i % 2 == 1))
                        n_cases += 1
            case(3, 37, 2, 70, 4, 2, 32, qdt=qdt, hist=hist, mode="extend",
                 dedup=True, lengths=True, unaligned=True)
            n_cases += 1
    # extend mode's tensor-core kernel: bf16 q over int8 and bf16 prefixes
    # at M = 1, 16 and 17 (and 129), suffix operands strided as the QKV
    # projection hands them; with lengths, pool row 0 has a prefix of 0
    for hist in ("int8", torch.bfloat16):
        for shp in [(4, 1, 4, 256, 4, 4, 64), (4, 16, 2, 100, 4, 4, 64),
                    (3, 17, 2, 70, 4, 2, 32), (2, 17, 2, 40, 2, 1, 128),
                    (2, 1, 2, 9, 4, 2, 16), (4, 129, 4, 128, 4, 4, 64)]:
            for lengths in (False, True):
                for fused_qkv in (False, True):
                    case(*shp, qdt=torch.bfloat16, hist=hist, mode="extend",
                         dedup=True, lengths=lengths, fused_qkv=fused_qkv)
                    n_cases += 1
    # head dims between the instantiations, padded by the wrapper
    # (``fs.fused_score_padded``): the examples' Climber at head dim 24
    # (serve_e2e: 4 heads over 64 history items, buckets 64 / 32 / 16;
    # mixed_traffic_dso: 256 items, buckets up to 128), ragged GQA at 40,
    # 8 and 100; every mode, history dtype and q dtype, with and without
    # the dedup index and lengths
    padded = [(4, 64, 4, 65, 4, 4, 24), (4, 16, 2, 65, 4, 4, 24),
              (4, 128, 4, 257, 4, 4, 24), (3, 37, 3, 70, 4, 2, 40),
              (2, 9, 2, 5, 2, 1, 8), (2, 17, 2, 40, 4, 2, 100)]
    n_padded = 0
    for qdt in (torch.bfloat16, torch.float32):
        for hist in ("int8", torch.bfloat16, torch.float32):
            for mode in ("cached", "extend"):
                for i, shp in enumerate(padded):
                    if shp[-1] in fs.HEAD_DIMS:
                        fail(f"K1 padded case {shp} is at an instantiated "
                             f"head dim")
                    for dedup in (True, False):
                        if not dedup:
                            shp = (shp[0], shp[1], shp[0]) + shp[3:]
                        case(*shp, qdt=qdt, hist=hist, mode=mode,
                             dedup=dedup, lengths=(i % 2 == 0),
                             fused_qkv=(mode == "extend" and dedup))
                        n_padded += 1
    # the serving path's case: bf16 q, int8 history, 1-D dedup index
    main_err, (q, kh, vh, kc, vc, args) = case(
        4, 128, 4, 257, 4, 4, 64, qdt=torch.bfloat16, hist="int8",
        mode="cached", dedup=True, lengths=False)
    n_bitwise = k1_bitwise(device, rnd)
    n_packed = k1_packed(device, rnd)
    print(f"[chip_smoke] K1 fused_score: {n_cases + 1} cases within "
          f"tolerance, and {n_padded} at head dims 24, 40, 8 and 100 "
          f"(padded to {fs.HEAD_DIMS}); {n_bitwise} bitwise checks held (cached and extend: "
          f"rows of M = 5 == rows of M = 128 / 129, lengths == S == no "
          f"lengths, padded == tight, two calls); {n_packed} packed-index "
          f"cases (align 1, 8, 16) "
          f"within tolerance, bf16 ones bitwise the unpacked call of each "
          f"slot's pool row; serving shape max abs err {main_err:.3g}")
    from repro_torch.configs import CLIMBER_BASE
    k1_extend(device, rnd, CLIMBER_BASE.seq_len)
    k1_packed_times(device, rnd)
    p = fs.plan(q, kh)
    print(f"[chip_smoke] K1 launch at the cached shape {tuple(q.shape)}: "
          f"grid {p['grid']}, {p['threads']} threads per block, "
          f"{p['smem_bytes']} B shared memory, tensor cores "
          f"{p['tensor_cores']}")
    # library yardstick: SDPA on the dequantized, gathered, concatenated
    # operands with the SUMI mask (their preparation is not timed)
    b, m, h, d = q.shape
    s = kh.shape[1]
    idx = args["row_index"].long()
    kd = (kh.float() * args["k_scale"][:, None, :, None])[idx]
    vd = (vh.float() * args["v_scale"][:, None, :, None])[idx]
    kk = torch.cat([kd.to(q.dtype), kc], 1).transpose(1, 2).contiguous()
    vv = torch.cat([vd.to(q.dtype), vc], 1).transpose(1, 2).contiguous()
    qq = q.transpose(1, 2).contiguous()
    mask = torch.cat([torch.ones(m, s, dtype=torch.bool, device=device),
                      torch.eye(m, dtype=torch.bool, device=device)], 1)
    ms, plain_ms, library_ms = timings(
        "K1 fused_score",
        lambda: fs.fused_score(q, kh, vh, kc, vc, **args),
        lambda: fs.fused_score_plain(q, kh, vh, kc, vc, **args),
        lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask))
    uniq = int(idx.unique().numel())
    n_bytes = nbytes(q, kc, vc, args["row_index"], q) \
        + (kh[0].numel() * 2 + 2 * args["k_scale"][0].numel() * 4) * uniq
    flops = 4 * b * h * m * (s + 1) * d
    bound_ms, bound_by = bound(n_bytes, flops)
    return dict(name="fused_score", route="cuda",
                source="src/repro_torch/csrc/fused_score.cu",
                replaces=REPLACES["fused_score"], max_abs_err=main_err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def k1_bitwise(device, rnd) -> int:
    """K1's bitwise rules for bf16 q over int8 and bf16 history (the
    tensor-core kernels), in cached and extend mode: a row's output does
    not depend on M (rows 0-4 of M = 5 against M = 128 cached, 129
    extend), on lengths == S versus no lengths, on how far the history is
    padded, or on the call.  Returns the number of checks."""
    import torch
    from repro_torch.kernels.fused_score import ops as fs
    from repro_torch.serving.kv_cache import _int8

    n = 0
    for mode, m, lens_of in (
            ("cached", 128, lambda s: [s, s - 1, s // 2 + 3, 1]),
            ("extend", 129, lambda s: [s, 0, s // 2 + 3, 1])):
        for hist in ("int8", torch.bfloat16):
            for (b, u, s, h, hkv, d) in [(4, 4, 257, 4, 4, 64),
                                         (3, 2, 70, 4, 2, 32)]:
                n += k1_bitwise_case(device, rnd, fs, _int8, mode, hist,
                                     (b, m, u, s, h, hkv, d), lens_of(s))
    return n


def k1_bitwise_case(device, rnd, fs, _int8, mode, hist, shape, lens,
                    qdt=None) -> int:
    import torch
    b, m, u, s, h, hkv, d = shape
    qdt = qdt or torch.bfloat16
    q = rnd(b, m, h, d, dtype=qdt)
    kc, vc = rnd(b, m, hkv, d, dtype=qdt), rnd(b, m, hkv, d, dtype=qdt)
    kf = rnd(u, s, hkv, d, dtype=torch.float32)
    vf = rnd(u, s, hkv, d, dtype=torch.float32)
    ks = vs = None
    if hist == "int8":
        (kh, ks), (vh, vs) = _int8(kf[:, None]), _int8(vf[:, None])
        kh, vh, ks, vs = kh[:, 0], vh[:, 0], ks[:, 0], vs[:, 0]
        fill = torch.full((u, 23, hkv, d), 77, dtype=torch.int8,
                          device=device)
    else:
        kh, vh = kf.to(hist), vf.to(hist)
        fill = torch.full((u, 23, hkv, d), 3.75, dtype=hist, device=device)
    idx = (torch.arange(b, device=device) % u).to(torch.int32)
    kw = dict(mode=mode, k_scale=fs._norm_scale(ks, u, hkv),
              v_scale=fs._norm_scale(vs, u, hkv), row_index=idx)
    what = f"fused_score {mode} q={qdt} hist={hist} {shape}"
    full = fs.fused_score(q, kh, vh, kc, vc, **kw)
    lens = torch.tensor(lens[:u], dtype=torch.int32, device=device)
    part = fs.fused_score(q, kh, vh, kc, vc, lengths=lens, **kw)
    checks = {
        f"rows of M = 5 != the same rows of M = {m}": (
            fs.fused_score(q[:, :5].contiguous(), kh, vh,
                           kc[:, :5].contiguous(), vc[:, :5].contiguous(),
                           **kw),
            full[:, :5]),
        "lengths == S != no lengths": (
            fs.fused_score(q, kh, vh, kc, vc,
                           lengths=torch.full_like(lens, s), **kw), full),
        "padded history != tight": (
            fs.fused_score(q, torch.cat([kh, fill], 1),
                           torch.cat([vh, fill], 1), kc, vc, lengths=lens,
                           **kw), part),
        "two calls differ": (
            fs.fused_score(q, kh, vh, kc, vc, lengths=lens, **kw), part),
    }
    torch.cuda.synchronize()
    for msg, (got, want) in checks.items():
        if not torch.equal(got, want):
            fail(f"{what}: {msg}")
    return len(checks)


def packed_seg(b: int, m: int, u: int, align: int, device, seed: int):
    """A [B, M] segment-packed pool-row index laid out as the DSO's
    SegmentPacker lays it: runs of one pool row (1 to 2 ``align`` long)
    starting on multiples of ``align``; the holes are dead slots (row 0).
    Returns (seg, live), ``live`` the mask of the slots the runs fill."""
    import numpy as np
    import torch
    r = np.random.default_rng(seed)
    seg = np.zeros((b, m), np.int32)
    live = np.zeros((b, m), bool)
    for row in range(b):
        off = 0
        while off < m:
            n = int(r.integers(1, 2 * align + 1))
            seg[row, off:off + n] = r.integers(0, u)
            live[row, off:off + n] = True
            off = -(-(off + n) // align) * align
    return (torch.from_numpy(seg).to(device),
            torch.from_numpy(live).to(device))


def k1_packed(device, rnd) -> int:
    """K1 with a per-candidate (2-D, segment-packed) pool-row index at
    alignments 1, 8 and 16: bf16 q over int8 and bf16 history (the
    tensor-core kernel, with and without lengths) and f32 q over f32 (the
    scalar kernel) against the plain version; and, for the tensor-core
    kernel, each live slot bitwise the unpacked call of its pool row.
    Returns the number of cases."""
    import torch
    from repro_torch.kernels.fused_score import ops as fs
    from repro_torch.serving.kv_cache import _int8

    n = 0
    for qdt, hist in ((torch.bfloat16, "int8"),
                      (torch.bfloat16, torch.bfloat16),
                      (torch.float32, torch.float32)):
        for (b, m, u, s, h, hkv, d) in [(1, 128, 4, 257, 4, 4, 64),
                                        (4, 32, 4, 257, 4, 4, 64),
                                        (4, 64, 4, 257, 4, 4, 64),
                                        (3, 37, 3, 70, 4, 2, 32),
                                        # padded head dims
                                        (4, 64, 4, 65, 4, 4, 24),
                                        (3, 37, 3, 70, 4, 2, 40)]:
            q, kc, vc = (rnd(b, m, x, d, dtype=qdt) for x in (h, hkv, hkv))
            kf = rnd(u, s, hkv, d, dtype=torch.float32)
            vf = rnd(u, s, hkv, d, dtype=torch.float32)
            ks = vs = None
            if hist == "int8":
                (kh, ks), (vh, vs) = _int8(kf[:, None]), _int8(vf[:, None])
                kh, vh, ks, vs = kh[:, 0], vh[:, 0], ks[:, 0], vs[:, 0]
            else:
                kh, vh = kf.to(hist), vf.to(hist)
            lens = torch.tensor([s, s - 1, s // 2 + 3, 1][:u],
                                dtype=torch.int32, device=device)
            for align in (1, 8, 16):
                seg, live = packed_seg(b, m, u, align, device, seed=n)
                for lengths in (None, lens):
                    kw = dict(mode="cached",
                              k_scale=fs._norm_scale(ks, u, hkv),
                              v_scale=fs._norm_scale(vs, u, hkv),
                              lengths=lengths)
                    what = (f"fused_score packed q={qdt} hist={hist} "
                            f"{(b, m, u, s, h, hkv, d)} align {align} "
                            f"lengths {lengths is not None}")
                    out = fs.fused_score(q, kh, vh, kc, vc, row_index=seg,
                                         **kw)
                    torch.cuda.synchronize()
                    close(out, fs.fused_score_plain(q, kh, vh, kc, vc,
                                                    row_index=seg, **kw),
                          what)
                    n += 1
                    if qdt != torch.bfloat16:
                        continue
                    for row in range(u):
                        one = fs.fused_score(
                            q, kh, vh, kc, vc, row_index=torch.full(
                                (b,), row, dtype=torch.int32,
                                device=device), **kw)
                        pick = live & (seg == row)
                        torch.cuda.synchronize()
                        if not torch.equal(out[pick], one[pick]):
                            fail(f"{what}: packed != unpacked for pool row "
                                 f"{row}")
    return n


def k1_packed_times(device, rnd):
    """K1 with a packed index at the packed ``cached`` family's shape (one
    row of 128 candidates from 4 users' int8 rows of 257 positions, the
    packer's default alignment of 8) beside the same call unpacked (one
    pool row) and SDPA over all 4 rows' history and the candidates with a
    mask of each candidate's own row and itself; prints the times and the
    bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.fused_score import ops as fs
    from repro_torch.serving.kv_cache import _int8

    b, m, u, s, h, d = 1, 128, 4, 257, 4, 64
    q, kc, vc = rnd(b, m, h, d), rnd(b, m, h, d), rnd(b, m, h, d)
    (kh, ks), (vh, vs) = (_int8(rnd(u, 1, s, h, d, dtype=torch.float32))
                          for _ in range(2))
    kh, vh = kh[:, 0], vh[:, 0]
    kw = dict(mode="cached", k_scale=fs._norm_scale(ks[:, 0], u, h),
              v_scale=fs._norm_scale(vs[:, 0], u, h))
    seg, _ = packed_seg(b, m, u, 8, device, seed=5)
    one = torch.zeros((b,), dtype=torch.int32, device=device)
    kd = (kh.float() * kw["k_scale"][:, None, :, None]).to(q.dtype)
    vd = (vh.float() * kw["v_scale"][:, None, :, None]).to(q.dtype)
    kk = torch.cat([kd.reshape(1, u * s, h, d), kc], 1).transpose(1, 2) \
        .contiguous()
    vv = torch.cat([vd.reshape(1, u * s, h, d), vc], 1).transpose(1, 2) \
        .contiguous()
    qq = q.transpose(1, 2).contiguous()
    own = (torch.arange(u * s, device=device)[None, :] // s
           == seg[0].long()[:, None])
    mask = torch.cat([own, torch.eye(m, dtype=torch.bool, device=device)], 1)
    fns = {"packed": lambda: fs.fused_score(q, kh, vh, kc, vc,
                                            row_index=seg, **kw),
           "unpacked": lambda: fs.fused_score(q, kh, vh, kc, vc,
                                              row_index=one, **kw),
           "SDPA": lambda: F.scaled_dot_product_attention(
               qq, kk, vv, attn_mask=mask)}
    dev = {k: device_ms(f) for k, f in fns.items()}
    eager = {k: call_ms(f) for k, f in fns.items()}
    n_bytes = nbytes(q, kc, vc, seg, q, kh, vh) + 2 * u * h * 4
    bound_ms, bound_by = bound(n_bytes, 4 * h * m * (s + 1) * d)
    print(f"[chip_smoke] K1 packed index {list(q.shape)} over {u} int8 rows "
          f"of {s}, align 8, ms per call, device (CUDA graph) / eager call: "
          + ", ".join(f"{k} {dev[k]:.4f} / {eager[k]:.4f}" for k in fns)
          + f"; bound {bound_ms:.5f} ms ({bound_by})")


def k1_extend(device, rnd, n_history: int):
    """K1's ``extend`` mode (its tensor-core kernel) at the serving shapes
    of the ``extend`` family: a tail-append past the window re-encodes 1
    query row per block against a 256-row prefix (buckets 512; block 0 of
    384 and 256), an edit at window position 384 129 rows against 128
    (block 1 of bucket 384).  Each against the plain version over the
    path's bf16 (dequantized) prefix and over int8 prefix rows; prints the
    launch plan (fails unless the tensor cores run); then times the path's
    two shapes beside SDPA causal on the prefix and suffix concatenated
    with an explicit mask for the prefix offset.  Returns the shapes'
    timing rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.fused_score import ops as fs
    from repro_torch.serving.kv_cache import _int8

    w = n_history // 2
    rows = []
    for s_suf, p in ((1, w), (w // 2 + 1, w // 2)):
        q = rnd(4, s_suf, 4, 64)
        kc, vc = rnd(4, s_suf, 4, 64), rnd(4, s_suf, 4, 64)
        kf = rnd(4, p, 4, 64, dtype=torch.float32)
        vf = rnd(4, p, 4, 64, dtype=torch.float32)
        (k8, ks), (v8, vs) = _int8(kf[:, None]), _int8(vf[:, None])
        for hist, kh, vh, kw in (
                ("bf16", kf.to(torch.bfloat16), vf.to(torch.bfloat16), {}),
                ("int8", k8[:, 0], v8[:, 0],
                 dict(k_scale=fs._norm_scale(ks[:, 0], 4, 4),
                      v_scale=fs._norm_scale(vs[:, 0], 4, 4)))):
            out = fs.fused_score(q, kh, vh, kc, vc, mode="extend", **kw)
            torch.cuda.synchronize()
            err = close(out, fs.fused_score_plain(q, kh, vh, kc, vc,
                                                  mode="extend", **kw),
                        f"fused_score extend {list(q.shape)} over {p} "
                        f"{hist} prefix rows")
        kh, vh = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
        plan = fs.plan(q, kh, mode="extend")
        print(f"[chip_smoke] K1 extend launch {list(q.shape)} over {p}: "
              f"grid {plan['grid']}, {plan['threads']} threads per block, "
              f"{plan['smem_bytes']} B shared memory, tensor cores "
              f"{plan['tensor_cores']}")
        if not plan["tensor_cores"]:
            fail(f"K1 extend {list(q.shape)}: the launch plan reports the "
                 f"scalar kernel")
        kk = torch.cat([kh, kc], 1).transpose(1, 2).contiguous()
        vv = torch.cat([vh, vc], 1).transpose(1, 2).contiguous()
        qq = q.transpose(1, 2).contiguous()
        mask = (torch.arange(p + s_suf, device=device)[None, :]
                <= p + torch.arange(s_suf, device=device)[:, None])
        fn = lambda: fs.fused_score(q, kh, vh, kc, vc,  # noqa: E731
                                    mode="extend")
        plain = lambda: fs.fused_score_plain(q, kh, vh, kc, vc,  # noqa: E731
                                             mode="extend")
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qq, kk, vv, attn_mask=mask)
        dev = [device_ms(f) for f in (fn, plain, sdpa)]
        eager = [call_ms(f) for f in (fn, plain, sdpa)]
        keys = 4 * 4 * sum(p + i + 1 for i in range(s_suf))
        n_bytes = nbytes(q, kh, vh, kc, vc, q)
        bound_ms, bound_by = bound(n_bytes, 4 * 64 * keys)
        rows.append((list(q.shape), p, dev, eager, bound_ms, bound_by, err))
        print(f"[chip_smoke] K1 extend {list(q.shape)} over {p} bf16 prefix "
              f"rows (max abs err {err:.3g}) ms per call, device (CUDA "
              f"graph) / eager call: kernel {dev[0]:.4f} / {eager[0]:.4f}, "
              f"plain {dev[1]:.4f} / {eager[1]:.4f}, SDPA causal with the "
              f"offset mask {dev[2]:.4f} / {eager[2]:.4f}; bound "
              f"{bound_ms:.5f} ms ({bound_by})")
    return rows


def k2_phase(device):
    """flash_attention (K2): all four masks and q_offset against the plain
    version; returns its JSON entry measured at the encode shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa

    g = torch.Generator(device=device).manual_seed(2)

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=g, device=device).to(dtype)

    def case(b, sq, sk, h, hkv, d, dtype, mode, unaligned=False, **kw):
        q = rnd(b, sq, h, d, dtype=dtype)
        k, v = rnd(b, sk, hkv, d, dtype=dtype), rnd(b, sk, hkv, d, dtype=dtype)
        if unaligned:     # rows off 16-byte boundaries: the scalar loads
            k, v = (torch.cat([t[..., :1], t], -1)[..., 1:] for t in (k, v))
        out = fa.flash_attention(q, k, v, mode, **kw)
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, k, v, mode, **kw)
        return close(out, want, f"flash_attention {mode} {kw} {dtype} "
                                f"{(b, sq, sk, h, hkv, d)}"), (q, k, v)

    n_cases = 0
    for dtype in (torch.bfloat16, torch.float32):
        for (b, sq, h, hkv, d) in [(4, 257, 4, 4, 64), (2, 37, 4, 2, 32),
                                   (1, 5, 2, 1, 16), (2, 70, 2, 2, 128),
                                   (4, 257, *MESH_LOCAL_HEADS, 64)]:
            for mode, kw in [("full", {}), ("causal", {}),
                             ("sliding", dict(window=40)),
                             ("sumi", dict(n_history=sq)),
                             ("sumi", dict(n_history=sq // 2 + 1)),
                             ("causal", dict(q_offset=30)),
                             ("sumi", dict(n_history=50, q_offset=50))]:
                sk = sq + kw.get("q_offset", 0)
                case(b, sq, sk, h, hkv, d, dtype, mode, **kw)
                n_cases += 1
        case(2, 37, 37, 4, 2, 32, dtype, "sumi", unaligned=True, n_history=20)
        n_cases += 1
    # the pallas ``cached`` shape: candidates after 257 history keys
    cached_err, (qc, kc, vc) = case(4, 128, 385, 4, 4, 64, torch.bfloat16,
                                    "sumi", n_history=257, q_offset=257)
    # the serving path's case: causal history encode (SUMI, n_history == S)
    main_err, (q, k, v) = case(4, 257, 257, 4, 4, 64, torch.bfloat16,
                               "sumi", n_history=257)
    # the pool-off ``full`` family's monolithic SUMI pass at each bucket:
    # 257 history rows (256 of a block and the side token), then the
    # candidates; the q tile holding rows 256-271 sees both key segments
    full_err, full_qkv = {}, {}
    for bucket in (128, 64, 32):
        full_err[bucket], full_qkv[bucket] = case(
            4, 257 + bucket, 257 + bucket, 4, 4, 64, torch.bfloat16, "sumi",
            n_history=257)
    qf, kf, vf = full_qkv[128]
    n_cases += 5
    # the mesh phase's (1, 2) ranks: the pool-off ``full`` pass at b128 at
    # their 2 heads (their encode is the 257-row SUMI case of the sweep)
    mesh_err = case(4, 257 + 128, 257 + 128, *MESH_LOCAL_HEADS, 64,
                    torch.bfloat16, "sumi", n_history=257)[0]
    n_cases += 1
    # one warp finishes each row in a fixed key order: bitwise repeatable
    for args, kw in [((q, k, v), dict(n_history=257)),
                     ((qc, kc, vc), dict(n_history=257, q_offset=257)),
                     ((qf, kf, vf), dict(n_history=257))]:
        if not torch.equal(fa.flash_attention(*args, "sumi", **kw),
                           fa.flash_attention(*args, "sumi", **kw)):
            fail(f"flash_attention: two calls differ at {kw}")
    print(f"[chip_smoke] K2 flash_attention: {n_cases} cases within "
          f"tolerance, two calls bitwise equal; serving shape max abs err "
          f"{main_err:.3g}, cached shape {cached_err:.3g}, full shapes "
          + ", ".join(f"[4, {257 + b}, 4, 64] {e:.3g}"
                      for b, e in full_err.items())
          + f", the mesh's [4, 385, 2, 64] {mesh_err:.3g}")
    for what, qq_ in (("encode", q), ("cached", qc), ("full", qf)):
        p = fa.plan(qq_)
        print(f"[chip_smoke] K2 launch at the {what} shape "
              f"{tuple(qq_.shape)}: grid {p['grid']}, {p['threads']} "
              f"threads per block, {p['smem_bytes']} B shared memory")
    # the pallas cached shape: kernel, plain, SDPA with the SUMI mask
    a = torch.arange(128, device=device)[:, None] + 257
    c = torch.arange(385, device=device)[None, :]
    sumi_mask = torch.where(a < 257, c <= a, (c < 257) | (c == a))
    qcc, kcc, vcc = (t.transpose(1, 2).contiguous() for t in (qc, kc, vc))
    timings(
        "K2 flash_attention at the cached shape",
        lambda: fa.flash_attention(qc, kc, vc, "sumi", n_history=257,
                                   q_offset=257),
        lambda: fa.flash_attention_plain(qc, kc, vc, "sumi", n_history=257,
                                         q_offset=257),
        lambda: F.scaled_dot_product_attention(qcc, kcc, vcc,
                                               attn_mask=sumi_mask))
    # the ``full`` shape: kernel, plain, SDPA with the SUMI mask, the bound
    a = torch.arange(385, device=device)[:, None]
    c = torch.arange(385, device=device)[None, :]
    full_mask = torch.where(a < 257, c <= a, (c < 257) | (c == a))
    qff, kff, vff = (t.transpose(1, 2).contiguous() for t in (qf, kf, vf))
    full_ms, full_plain, full_lib = timings(
        "K2 flash_attention at the full shape",
        lambda: fa.flash_attention(qf, kf, vf, "sumi", n_history=257),
        lambda: fa.flash_attention_plain(qf, kf, vf, "sumi", n_history=257),
        lambda: F.scaled_dot_product_attention(qff, kff, vff,
                                               attn_mask=full_mask))
    b, s, h, d = qf.shape
    pairs = 257 * 258 // 2 + (s - 257) * 258   # history causal, then each
    full_bound, full_by = bound(nbytes(qf, kf, vf, qf), 4 * b * h * d * pairs)
    print(f"[chip_smoke] K2 at the full shape {tuple(qf.shape)}: bound "
          f"{full_bound:.5f} ms ({full_by}); kernel {full_ms:.4f} ms = "
          f"{full_ms / full_bound:.1f}x its bound, SDPA {full_lib:.4f} ms "
          f"(kernel / SDPA {full_ms / full_lib:.2f})")
    # the kernel alone at the other buckets' shapes, for K2's share of
    # their replays
    full_ms = {128: full_ms}
    for bucket in (64, 32):
        qb, kb, vb = full_qkv[bucket]
        full_ms[bucket] = device_ms(lambda: fa.flash_attention(
            qb, kb, vb, "sumi", n_history=257))
    print("[chip_smoke] K2 at the other full shapes, device (CUDA graph): "
          + ", ".join(f"[4, {257 + b}, 4, 64] {full_ms[b]:.4f} ms"
                      for b in (64, 32)))
    qq, kk, vv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    ms, plain_ms, library_ms = timings(
        "K2 flash_attention",
        lambda: fa.flash_attention(q, k, v, "sumi", n_history=257),
        lambda: fa.flash_attention_plain(q, k, v, "sumi", n_history=257),
        lambda: F.scaled_dot_product_attention(qq, kk, vv, is_causal=True))
    b, s, h, d = q.shape
    flops = 4 * b * h * d * s * (s + 1) // 2
    bound_ms, bound_by = bound(nbytes(q, k, v, q), flops)
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces=REPLACES["flash_attention"], max_abs_err=main_err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, full_ms=full_ms)


def k4_phase(device, *, rows: int, cands: int, s_pad: int):
    """flash_decode (K4), both forms.  (a) the self-slot form the pallas
    ``decode`` / ``append`` families run: a sweep against its plain version
    (lengths 0, 1, partial, full; GQA; M of 1 and more; D 16-128; f32 and
    bf16), padded == tight, rows of M = 5 == rows of M = ``cands``, and two
    calls, bitwise; its JSON entry measured at the ``decode`` shape of the
    pallas generation phase (``rows`` beams x ``cands`` candidates against
    a cache of ``s_pad`` positions).  (b) the single-token form: the sweep
    against its plain version with windows and G in {1, 2, 4, 8, 16},
    padded == tight and two calls bitwise at G in {1, 4} with a window,
    and its time at [``rows`` x ``cands``, ``s_pad`` + 1, 4, 64] (the
    per-candidate copies the TPU route decodes) beside SDPA's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import ops as fd

    g = torch.Generator(device=device).manual_seed(4)

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=g, device=device).to(dtype)

    def equal(got, want, what):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"{what} (max diff "
                 f"{(got.float() - want.float()).abs().max().item():.3g})")

    # (a) the self-slot form
    def self_case(b, m, s, h, hkv, d, dtype, lens):
        q = rnd(b, m, h, d, dtype=dtype)
        ks, vs = rnd(b, m, hkv, d, dtype=dtype), rnd(b, m, hkv, d, dtype=dtype)
        k, v = rnd(b, s, hkv, d, dtype=dtype), rnd(b, s, hkv, d, dtype=dtype)
        lengths = torch.tensor(lens, dtype=torch.int32, device=device)
        ops = (q, k, v, lengths, ks, vs)
        out = fd.flash_decode_with_self(*ops)
        torch.cuda.synchronize()
        want = fd.flash_decode_with_self_plain(*ops)
        err = close(out, want, f"flash_decode_with_self {dtype} "
                               f"{(b, m, s, h, hkv, d)} lengths {lens}")
        return err, ops, out

    n_cases = n_bitwise = 0
    for dtype in (torch.bfloat16, torch.float32):
        for (m, s, h, hkv, d) in [(cands, s_pad, 4, 4, 64), (1, s_pad, 4, 4, 64),
                                  (37, 100, 8, 2, 64), (5, 37, 2, 2, 32),
                                  (9, 70, 4, 4, 16), (20, 130, 8, 4, 128)]:
            self_case(4, m, s, h, hkv, d, dtype, [0, 1, s // 2 + 3, s])
            n_cases += 1
        for (m, h, hkv, d) in [(cands, 4, 4, 64), (64, 8, 2, 32)]:
            _, (q, k, v, lengths, ks, vs), tight = self_case(
                6, m, 70, h, hkv, d, dtype, [70, 69, 33, 64, 1, 0])
            pad = torch.full((6, 23, hkv, d), 3.75, dtype=dtype,
                             device=device)
            what = f"flash_decode_with_self {dtype} M={m} H={h}/{hkv} D={d}"
            equal(fd.flash_decode_with_self(q, torch.cat([k, pad], 1),
                                            torch.cat([v, pad], 1), lengths,
                                            ks, vs), tight,
                  f"{what}: padded cache != tight cache")
            equal(fd.flash_decode_with_self(
                q[:, :5].contiguous(), k, v, lengths,
                ks[:, :5].contiguous(), vs[:, :5].contiguous()),
                tight[:, :5], f"{what}: rows of M = 5 != the same rows of "
                              f"M = {m}")
            equal(fd.flash_decode_with_self(q, k, v, lengths, ks, vs), tight,
                  f"{what}: two calls differ")
            n_bitwise += 3
    # the packed decode form: a [B, M] index into U stacked beam caches
    n_packed = 0
    for dtype in (torch.bfloat16, torch.float32):
        for (b, u, m) in [(1, rows, cands), (3, 3, 37)]:
            q = rnd(b, m, 4, 64, dtype=dtype)
            ks, vs = (rnd(b, m, 4, 64, dtype=dtype) for _ in range(2))
            k, v = (rnd(u, s_pad, 4, 64, dtype=dtype) for _ in range(2))
            lengths = torch.tensor([s_pad - 8, s_pad - 1, 0, s_pad // 2][:u],
                                   dtype=torch.int32, device=device)
            for align in (1, 8, 16):
                seg, live = packed_seg(b, m, u, align, device,
                                       seed=n_packed)
                what = (f"flash_decode_with_self packed {dtype} "
                        f"{(b, m, u, s_pad)} align {align}")
                out = fd.flash_decode_with_self(q, k, v, lengths, ks, vs,
                                                row_index=seg)
                torch.cuda.synchronize()
                close(out, fd.flash_decode_with_self_plain(
                    q, k, v, lengths, ks, vs, row_index=seg), what)
                n_packed += 1
                if dtype != torch.bfloat16:
                    continue
                for row in range(u):
                    one = fd.flash_decode_with_self(
                        q, k[row:row + 1].repeat(b, 1, 1, 1),
                        v[row:row + 1].repeat(b, 1, 1, 1),
                        lengths[row:row + 1].repeat(b), ks, vs)
                    pick = live & (seg == row)
                    equal(out[pick], one[pick],
                          f"{what}: packed != unpacked for row {row}")
    # the serving path's case: every beam's candidates at its decode length
    lens = [s_pad - 8, s_pad - 6, s_pad - 4, s_pad - 1][:rows]
    main_err, (q, k, v, lengths, ks, vs), _ = self_case(
        rows, cands, s_pad, 4, 4, 64, torch.bfloat16, lens)
    print(f"[chip_smoke] K4 (a) flash_decode_with_self: {n_cases + 1} cases "
          f"within tolerance, {n_bitwise} bitwise checks held (padded == "
          f"tight, rows of M = 5 == rows of M = {cands}, two calls); "
          f"{n_packed} packed-index cases (align 1, 8, 16) within tolerance, "
          f"bf16 ones bitwise the unpacked call of each slot's row; "
          f"serving shape max abs err {main_err:.3g}")
    p = fd.plan(q, k)
    print(f"[chip_smoke] K4 (a) launch at the decode shape {tuple(q.shape)}: "
          f"grid {p['grid']}, {p['threads']} threads per block, "
          f"{p['smem_bytes']} B shared memory")
    # yardsticks: SDPA on the materialized operands (each row's cache and
    # its candidates' keys concatenated, a boolean mask of the valid prefix
    # and the diagonal; library_ms), and SDPA on the per-candidate cache
    # copies the TPU route builds (printed); their preparation is not timed
    b, m, h, d = q.shape
    s = k.shape[1]
    hkv = k.shape[2]
    kk = torch.cat([k, ks], 1).transpose(1, 2).contiguous()
    vv = torch.cat([v, vs], 1).transpose(1, 2).contiguous()
    qq = q.transpose(1, 2).contiguous()
    hist_ok = (torch.arange(s, device=device)[None, :]
               < lengths[:, None].long())[:, None, :].expand(b, m, s)
    diag = torch.eye(m, dtype=torch.bool, device=device)[None].expand(b, m, m)
    mask = torch.cat([hist_ok, diag], -1)[:, None]
    ms, plain_ms, library_ms = timings(
        "K4 (a) flash_decode_with_self",
        lambda: fd.flash_decode_with_self(q, k, v, lengths, ks, vs),
        lambda: fd.flash_decode_with_self_plain(q, k, v, lengths, ks, vs),
        lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask,
                                               enable_gqa=True))
    rows_ = torch.arange(b * m, device=device)
    lens_m = lengths.long().repeat_interleave(m)

    def copies():
        kcopy = F.pad(k[:, None].expand(b, m, s, hkv, d),
                      (0, 0, 0, 0, 0, 1)).reshape(b * m, s + 1, hkv, d)
        vcopy = F.pad(v[:, None].expand(b, m, s, hkv, d),
                      (0, 0, 0, 0, 0, 1)).reshape(b * m, s + 1, hkv, d)
        kcopy[rows_, lens_m] = ks.reshape(b * m, hkv, d)
        vcopy[rows_, lens_m] = vs.reshape(b * m, hkv, d)
        return kcopy, vcopy

    kcopy, vcopy = copies()
    qc = q.reshape(b * m, h, d)[:, :, None].contiguous()
    kc_, vc_ = (t.transpose(1, 2).contiguous() for t in (kcopy, vcopy))
    cmask = (torch.arange(s + 1, device=device)[None, :]
             <= lens_m[:, None])[:, None, None, :]
    copies_sdpa = device_ms(lambda: F.scaled_dot_product_attention(
        qc, kc_, vc_, attn_mask=cmask, enable_gqa=True))
    copies_ms = device_ms(copies)
    print(f"[chip_smoke] K4 (a) yardstick: SDPA on the per-candidate cache "
          f"copies {list(kc_.shape)} (the TPU route's operands) "
          f"{copies_sdpa:.4f} ms device; building those copies (pad, "
          f"reshape, two index writes: what the parent's caller ran per "
          f"layer) {copies_ms:.4f} ms device")
    del kcopy, vcopy, kc_, vc_
    valid = int(lengths.long().sum())
    n_bytes = 2 * valid * hkv * d * k.element_size() \
        + nbytes(q, ks, vs, lengths, q)
    flops = 4 * h * d * m * (valid + b)
    bound_ms, bound_by = bound(n_bytes, flops)

    # (b) the single-token form
    def case(b, s, h, hkv, d, dtype, lens, window=0):
        q = rnd(b, h, d, dtype=dtype)
        k, v = rnd(b, s, hkv, d, dtype=dtype), rnd(b, s, hkv, d, dtype=dtype)
        lengths = torch.tensor(lens, dtype=torch.int32, device=device)
        out = fd.flash_decode(q, k, v, lengths, window=window)
        torch.cuda.synchronize()
        want = fd.flash_decode_plain(q, k, v, lengths, window=window)
        what = (f"flash_decode {dtype} {(b, s, h, hkv, d)} lengths {lens} "
                f"window {window}")
        err = close(out, want, what)
        # with its log-sum-exp: the same output, the lse as the plain one's
        o2, lse = fd.flash_decode(q, k, v, lengths, window=window,
                                  return_lse=True)
        equal(o2, out, f"{what}: the output differs with the log-sum-exp")
        close_lse(lse, fd.flash_decode_plain(q, k, v, lengths, window=window,
                                             return_lse=True)[1], what)
        return err, (q, k, v, lengths, out)

    n_single = 0
    for dtype in (torch.bfloat16, torch.float32):
        for (s, h, hkv, d) in [(266, 4, 4, 64), (100, 4, 2, 64),
                               (70, 8, 2, 64), (37, 2, 2, 32),
                               (130, 8, 4, 128), (90, 16, 2, 64),
                               (45, 16, 1, 32)]:     # G = 1, 2, 4, 8, 16
            lens = [0, 1, s // 2 + 3, s]          # empty, one, partial, full
            for window in (0, 17):
                case(4, s, h, hkv, d, dtype, lens, window)
                n_single += 1
    # padding adds exactly nothing: a cache padded with a non-zero fill
    # decodes bitwise like the tight one; two calls agree bitwise
    for dtype, h, window in ((torch.bfloat16, 4, 0), (torch.bfloat16, 4, 29),
                             (torch.bfloat16, 16, 29), (torch.float32, 4, 0)):
        _, (q, k, v, lengths, tight) = case(6, 170, h, 4, 64, dtype,
                                            [170, 169, 33, 164, 1, 0],
                                            window)
        pad = torch.full((6, 23, 4, 64), 3.75, dtype=dtype, device=device)
        what = f"flash_decode {dtype} G={h // 4} window {window}"
        equal(fd.flash_decode(q, torch.cat([k, pad], 1),
                              torch.cat([v, pad], 1), lengths, window=window),
              tight, f"{what}: padded cache != tight cache")
        equal(fd.flash_decode(q, k, v, lengths, window=window), tight,
              f"{what}: two calls differ")
        n_single += 1
    # the shape the pallas route ran before the self-slot form: every
    # candidate row against its private cache copy
    s_all = s_pad + 1
    err_b, (qb, kb, vb, lb, _) = case(rows * cands, s_all, 4, 4, 64,
                                      torch.bfloat16,
                                      [s_all - 8] * (rows * cands))
    print(f"[chip_smoke] K4 (b) flash_decode: {n_single + 1} cases within "
          f"tolerance (padded == tight and two calls bitwise at G = 1, 4 "
          f"with and without a window); [{rows * cands}, {s_all}, 4, 64] "
          f"with {s_all - 8} valid max abs err {err_b:.3g}")
    p = fd.plan(qb, kb, self_slot=False)
    print(f"[chip_smoke] K4 (b) launch at {list(kb.shape)}: grid "
          f"{p['grid']}, {p['threads']} threads per block, "
          f"{p['smem_bytes']} B dynamic shared memory")
    qq = qb[:, :, None].contiguous()                       # [B,H,1,D]
    kk, vv = (t.transpose(1, 2).contiguous() for t in (kb, vb))
    lmask = (torch.arange(s_all, device=device)[None, :]
             < lb[:, None].long())[:, None, None, :]
    dev_b = timings(
        "K4 (b) flash_decode",
        lambda: fd.flash_decode(qb, kb, vb, lb),
        lambda: fd.flash_decode_plain(qb, kb, vb, lb),
        lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=lmask,
                                               enable_gqa=True))
    valid_b = int(lb.long().sum())
    bound_b, by_b = bound(2 * valid_b * 4 * 64 * kb.element_size()
                          + nbytes(qb, lb, qb), 4 * 4 * 64 * valid_b)
    print(f"[chip_smoke] K4 (b) at {list(kb.shape)}: kernel {dev_b[0]:.4f} "
          f"ms, SDPA {dev_b[2]:.4f} ms, bound {bound_b:.4f} ms ({by_b}; "
          f"{bound_b / dev_b[0]:.0%} of it reached)")
    return dict(name="flash_decode", route="cuda",
                source="src/repro_torch/csrc/flash_decode.cu",
                replaces=REPLACES["flash_decode"], max_abs_err=main_err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def k3_phase(device, *, d_model: int, d_ff: int, rows=(1028, 512, 4)):
    """fused_ffn (K3): the sweep (has_norm x activation x dtype, ragged T
    and d_ff) against the plain version, then the path's shapes — gelu, no
    norm, bf16, x [T, d_model] with T = ``rows`` (encode, cached/decode,
    append dispatches) — and its JSON entry measured at the first."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.fused_ffn import ops as ff

    g = torch.Generator(device=device).manual_seed(3)

    def rnd(*shape, dtype, scale=1.0):
        return (torch.randn(*shape, generator=g, device=device)
                * scale).to(dtype)

    def operands(t, d, f, dtype, act, norm):
        x = rnd(t, d, dtype=dtype)
        wu = rnd(d, f, dtype=dtype, scale=d ** -0.5)
        wd = rnd(f, d, dtype=dtype, scale=f ** -0.5)
        wg = rnd(d, f, dtype=dtype, scale=d ** -0.5) if act == "swiglu" \
            else None
        ns = rnd(d, dtype=dtype, scale=0.1) if norm else None
        return x, wu, wd, wg, ns

    def case(t, d, f, dtype, act, norm):
        ops = operands(t, d, f, dtype, act, norm)
        out = ff.fused_ffn_2d(*ops, activation=act)
        torch.cuda.synchronize()
        want = ff.fused_ffn_plain(*ops, activation=act)
        return close(out, want, f"fused_ffn {act} norm={norm} {dtype} "
                                f"T={t} d={d} f={f}"), ops

    n_cases = 0
    for dtype in (torch.bfloat16, torch.float32):
        for act in ("gelu", "relu", "swiglu"):
            for norm in (False, True):
                for (t, d, f) in [(37, 256, 1024), (16, 256, 100),
                                  (5, 64, 77), MESH_LOCAL_FFN]:
                    case(t, d, f, dtype, act, norm)
                    n_cases += 1
    errs, per_t = [], []
    for t in rows:
        err, ops = case(t, d_model, d_ff, torch.bfloat16, "gelu", False)
        errs.append(err)
        per_t.append(device_ms(lambda: ff.fused_ffn_2d(
            *ops[:3], activation="gelu")))
        if t == rows[0]:
            main = ops
    # a row's output does not depend on T or on its tile's other rows: the
    # rows of smaller calls (their 64-row tiles shared with other rows or
    # with padding) are bitwise those of a larger one; gelu on the path's
    # shapes, swiglu with the norm at d 64 and a ragged d_ff
    for (d, f, act, norm) in [(d_model, d_ff, "gelu", False),
                              (64, 200, "swiglu", True)]:
        big = operands(2100, d, f, torch.bfloat16, act, norm)
        want = ff.fused_ffn_2d(*big, activation=act)
        for t in (1028, 5):
            got = ff.fused_ffn_2d(big[0][:t].contiguous(), *big[1:],
                                  activation=act)
            if not torch.equal(got, want[:t]):
                fail(f"fused_ffn {act} norm={norm} d={d} f={f}: rows of a "
                     f"T={t} call differ from the same rows at T=2100")
        if not torch.equal(ff.fused_ffn_2d(*big, activation=act), want):
            fail(f"fused_ffn {act} d={d} f={f}: two calls differ")
    print(f"[chip_smoke] K3 fused_ffn: {n_cases + len(rows)} cases within "
          f"tolerance, rows bitwise equal across T = 2100, 1028, 5 and "
          f"between two calls; serving shapes T={list(rows)} max abs err "
          f"{max(errs):.3g}, device ms " + ", ".join(
              f"T={t} {ms:.4f}" for t, ms in zip(rows, per_t)))
    for t in rows + (2100,):
        p = ff.plan(torch.empty(t, d_model, dtype=torch.bfloat16),
                    torch.empty(d_model, d_ff, dtype=torch.bfloat16))
        print(f"[chip_smoke] K3 launch at T={t}: grid {p['grid']} CTAs in "
              f"clusters of {p['cluster']}, {p['rows']} rows per CTA, "
              f"{p['threads']} threads, {p['smem_bytes']} B shared memory, "
              f"{p['slots']} weight slots")
    x, wu, wd, _, _ = main
    ms, plain_ms, library_ms = timings(
        "K3 fused_ffn",
        lambda: ff.fused_ffn_2d(x, wu, wd, activation="gelu"),
        lambda: ff.fused_ffn_plain(x, wu, wd, activation="gelu"),
        lambda: torch.matmul(F.gelu(torch.matmul(x, wu), approximate="tanh"),
                             wd))
    t = x.shape[0]
    bound_ms, bound_by = bound(nbytes(x, wu, wd, x),
                               4 * t * d_model * d_ff)
    return dict(name="fused_ffn", route="cuda",
                source="src/repro_torch/csrc/fused_ffn.cu",
                replaces=REPLACES["fused_ffn"], max_abs_err=errs[0],
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


# ---------------------------------------------------------------------------
# engine phase
# ---------------------------------------------------------------------------

def make_traffic(n_history: int, vocab: int, seed: int):
    """A warm-up round, then 4 repeat users (0-3) in three measured rounds.
    W — users 4-7, each with a 128- and a 96-candidate request at once:
        every executor family and bucket runs before the measured rounds, so
        their latencies are not first-call set-up (allocator, cuBLAS);
    A — each user's first request (128 candidates) plus a second request
        of two users (96 candidates) arriving with it: misses, encodes and
        single-flight waits, co-batched chunks of one pool entry (dedup);
    B — every user again with its round-A candidates: pool hits that must
        equal round A bitwise;
    C — two users twice each with 96-candidate slates: hits whose same-
        bucket chunks of one pool entry may share a dispatch (dedup).
    Returns (histories, warm-up round, measured rounds)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    users = range(8)
    hist = [rng.integers(0, vocab, n_history + 8).astype(np.int32)
            for _ in users]
    first, second, third = ([rng.integers(0, vocab, m).astype(np.int32)
                             for _ in users] for m in (128, 96, 96))
    warm = [(u, c[u]) for u in range(4, 8) for c in (first, second)]
    rounds = [
        [(u, first[u]) for u in range(4)] + [(0, second[0]), (1, second[1])],
        [(u, first[u]) for u in range(4)],
        [(2, third[2]), (2, second[2]), (3, third[3]), (3, second[3])],
    ]
    return hist, warm, rounds


def family_args(eng, kind: str, bucket: int, vocab: int, seed: int):
    """Full-batch arguments of an executor of ``eng`` at its shapes: pool
    rows from the engine's own encode executor (an ``extend`` executor's
    basis), valid lengths inside the padded beam caches, ids in the
    vocabulary, and under ``pack_tails`` [rows, bucket] seg-index and
    candidate planes."""
    import numpy as np
    from repro_torch.core.climber import N_SIDE_FEATURES
    from repro_torch.tree import leaves
    rng = np.random.default_rng(seed)
    B = eng.dso.policy.batch
    hist = rng.integers(0, vocab, (B, eng.n_history)).astype(np.int32)
    side = rng.normal(size=(B, N_SIDE_FEATURES)).astype(np.float32)
    if kind == "encode":
        return [hist, side]
    if kind == "full":
        return [hist, rng.integers(0, vocab, (B, bucket)).astype(np.int32),
                side]
    raw = leaves(eng.dso.executors[("encode", eng.n_history)][0](hist, side))
    if kind == "extend":
        return raw + [hist, side]
    idx = rng.permutation(B).astype(np.int32)
    cands = rng.integers(0, vocab, (B, bucket)).astype(np.int32)
    steer = [idx, cands]
    if eng._pack_tails:      # [rows, bucket] seg-index and candidate planes
        rows = eng.dso.policy.rows
        steer = [rng.integers(0, B, (rows, bucket)).astype(np.int32),
                 rng.integers(0, vocab, (rows, bucket)).astype(np.int32)]
    if kind == "cached":
        # without KV-row dedup (kv_dedup=False, the default for the
        # framework impls on the CPU) the family takes no row index
        return raw + (steer if eng._kv_dedup or eng._pack_tails
                      else [cands])
    rows = list(eng._pad_beam_leaves(raw))
    lengths = rng.integers(1, eng._s0 + eng._generate, B).astype(np.int32)
    if kind == "decode":
        return rows + [lengths] + steer
    return rows + [lengths, cands[:, :1].copy()]


def check_executors(eng, what: str, vocab: int, seed: int = 21) -> int:
    """Every (kind, bucket, dispatcher) executor of ``eng`` is a captured
    CUDA graph; its call (staging, replay, fetch) equals its eager ``fn``
    on the same inputs bitwise; and a call's outputs are unchanged after
    the next call on other inputs.  Returns how many executors held."""
    import numpy as np
    import torch
    from repro_torch.tree import leaves

    def host(out):
        return [torch.from_numpy(a) if isinstance(a, np.ndarray)
                else a.cpu() for a in leaves(out)]

    n = 0
    for (kind, b), exs in eng.dso.executors.items():
        for s, ex in enumerate(exs):
            where = f"{what}: executor ({kind}, {b}) of dispatcher {s}"
            if ex.graph is None:
                fail(f"{where} was not captured")
            a1 = family_args(eng, kind, b, vocab, seed)
            a2 = family_args(eng, kind, b, vocab, seed + 1)
            got = host(ex(*a1))
            ts = [torch.from_numpy(a).to(ex.device)
                  if isinstance(a, np.ndarray) else a for a in a1]
            with torch.inference_mode():
                want = host(ex.fn(*ts))
            for g, w in zip(got, want):
                if not torch.equal(g, w):
                    fail(f"{where}: replay != eager fn (max diff "
                         f"{(g.float() - w.float()).abs().max().item():.3g})")
            first = ex(*a1)
            kept = [t.clone() for t in host(first)]
            ex(*a2)
            for g, k in zip(host(first), kept):
                if not torch.equal(g, k):
                    fail(f"{where}: outputs changed by the next dispatch")
            n += 1
    print(f"[chip_smoke] {what}: {n} captured executors: replay == eager fn "
          f"bitwise, outputs survive the next dispatch; CUDA-graph capture "
          f"{eng.dso.graph_capture_s:.2f}s of {eng.dso.build_time_s:.2f}s "
          f"construction, which left "
          f"{eng.dso.graph_bytes / 2**20:.1f} MiB reserved on the card")
    return n


def executor_ms(eng, kind: str, bucket: int, vocab: int) -> float:
    """The engine's captured executor called alone on one thread at its
    shapes: staging (host rows through its pinned buffer), replay, fetch,
    until its stream finished (host clock, median)."""
    args = family_args(eng, kind, bucket, vocab, seed=31)
    ex = eng.dso.executors[(kind, bucket)][0]
    return host_ms(lambda: ex(*args), reps=10)


def dispatch_times(eng, bundle, params, hist, n_history: int, cfg, device,
                   seed: int):
    """What the engine's two executors compute, called outside the engine
    at its shapes (batch 4; cached bucket 128, int8 pool rows): as one
    eager call on one thread, as the engine's captured executor (staging,
    replay, fetch) on one thread, and replayed from a CUDA graph (the device
    alone).  Printed beside the in-engine times, it splits a dispatch into
    device work, host work and the engine's threading."""
    import numpy as np
    import torch
    from repro_torch.core.climber import N_SIDE_FEATURES
    from repro_torch.serving.kv_cache import quantize_kv_graph
    g = torch.Generator(device=device).manual_seed(seed)
    batch = {"history": torch.from_numpy(np.stack(
                 [h[:n_history] for h in hist[:4]])).to(device),
             "side": torch.randn(4, N_SIDE_FEATURES, generator=g,
                                 device=device)}
    cands = torch.randint(0, cfg.vocab_size, (4, 128), generator=g,
                          device=device, dtype=torch.int32)
    idx = torch.arange(4, dtype=torch.int32, device=device)

    def encode():
        return quantize_kv_graph(bundle.encode_history(
            params, batch, impl="fused"), "int8")

    with torch.inference_mode():
        raw = encode()
        fns = {"encode": encode,
               "cached b128": lambda: bundle.score_candidates(
                   params, raw, cands, impl="fused", row_index=idx)}
        for (name, fn), key in zip(fns.items(), (("encode", n_history),
                                                 ("cached", 128))):
            eager = host_ms(fn)
            captured = executor_ms(eng, *key, vocab=cfg.vocab_size)
            dev = device_ms(fn, per_graph=1, reps=10)
            print(f"[chip_smoke] dispatch {name} (batch 4), alone: one "
                  f"eager call {eager:.2f} ms, captured executor "
                  f"{captured:.2f} ms, device (CUDA graph) {dev:.2f} ms")


def engine_phase(cfg, device, *, n_history: int, buckets, seed: int = 0,
                 reference_device="cpu", params=None):
    """Drive the port's engine (on ``params``, else seeded random
    weights); returns the kernels' launch counts over the measured
    rounds."""
    import numpy as np
    import torch
    from repro_torch.core import climber as C
    from repro_torch.core.pda import RemoteFeatureStore
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.fused_score import ops as fs
    from repro_torch.serving import ServeRequest, create_engine
    from repro_torch.serving.kv_cache import quantize_kv_graph

    t0 = time.perf_counter()
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = C.climber_init(cfg, gen, device)
    bundle = C.build_climber(cfg)
    eng = create_engine(
        "flame", bundle, params, n_history=n_history, buckets=buckets,
        max_batch=4, pool_dtype="int8", impl="fused", device=device,
        store=RemoteFeatureStore(feature_dim=C.N_SIDE_FEATURES, seed=seed))
    print(f"[chip_smoke] engine: Climber d_model {cfg.d_model}, "
          f"{cfg.n_heads}x{cfg.head_dim} heads, d_ff {cfg.d_ff}, "
          f"{cfg.climber.num_blocks} blocks x {cfg.climber.layers_per_block} "
          f"layers, vocab {cfg.vocab_size}; n_history {n_history}, buckets "
          f"{tuple(buckets)}, pool int8, impl fused "
          f"(set-up {time.perf_counter() - t0:.1f}s)")
    hist, warm, rounds = make_traffic(n_history, cfg.vocab_size, seed)

    def serve(rnd):
        futs = [eng.submit(ServeRequest(history=hist[u], candidates=c,
                                        user_id=u)) for u, c in rnd]
        return [f.result(timeout=600) for f in futs]

    outs, lat = [], []
    try:
        t_warm = time.perf_counter()
        outs.append([r.output for r in serve(warm)])
        t_warm = time.perf_counter() - t_warm
        before = eng.metrics()
        fa.flash_attention.launches = 0
        fs.fused_score.launches = 0
        t_run = time.perf_counter()
        phases = []
        for rnd in rounds:
            res = serve(rnd)
            outs.append([r.output for r in res])
            lat += [r.latency_s for r in res]
            phases += [r.timings for r in res]
        wall = time.perf_counter() - t_run
        launches = {"flash_attention": fa.flash_attention.launches,
                    "fused_score": fs.fused_score.launches}
        metrics = eng.metrics()
    finally:
        eng.shutdown()
    dispatches = {k: metrics[f"dso_dispatches_{k}"]
                  - before[f"dso_dispatches_{k}"]
                  for k in ("encode", "cached")}
    n_req = sum(len(r) for r in rounds)
    print(f"[chip_smoke] engine: warm-up round of {len(warm)} requests "
          f"{t_warm:.3f}s; {n_req} requests resolved in {wall:.3f}s "
          f"({n_req / wall:.2f} requests/s), latency p50 "
          f"{np.percentile(lat, 50) * 1e3:.1f} ms p99 "
          f"{np.percentile(lat, 99) * 1e3:.1f} ms; pool hits "
          f"{metrics['pool_hits']} misses {metrics['pool_misses']} (all "
          f"rounds), dispatches encode {dispatches['encode']} cached "
          f"{dispatches['cached']}, dedup rows saved "
          f"{metrics['dso_dedup_rows_saved']}")

    # every output finite, [M, num_tasks]
    for rnd, got in zip([warm] + rounds, outs):
        for (u, c), o in zip(rnd, got):
            if o.shape != (len(c), cfg.climber.num_tasks) \
                    or not np.isfinite(o).all():
                fail(f"user {u}: output {o.shape} not finite "
                     f"[{len(c)}, {cfg.climber.num_tasks}]")
    outs = outs[1:]                         # the measured rounds
    # a user's hit (round B) equals its miss (round A) bitwise
    for u in range(4):
        if not np.array_equal(outs[0][u], outs[1][u]):
            fail(f"user {u}: hit != miss (max diff "
                 f"{np.abs(outs[0][u] - outs[1][u]).max():.3g})")
    hits = metrics["pool_hits"] - before["pool_hits"]
    misses = metrics["pool_misses"] - before["pool_misses"]
    if hits < 6 or misses < 4:
        fail(f"measured rounds: pool hits {hits} / misses {misses}: the "
             f"traffic did not hit and miss")
    n_layers = cfg.climber.num_blocks * cfg.climber.layers_per_block
    want = {"flash_attention": n_layers * dispatches["encode"],
            "fused_score": n_layers * dispatches["cached"]}
    for name, n in launches.items():
        if n <= 0 or n != want[name]:
            fail(f"{name}: {n} launches on the main path, want "
                 f"{want[name]} ({n_layers} per dispatch)")
    print(f"[chip_smoke] engine: hit == miss bitwise for 4 users; launches "
          f"{launches} ({n_layers} per dispatch, counted per replay)")
    print(f"[chip_smoke] engine: per dispatch in the engine (captured "
          f"executor until its stream finished), mean / longest over every "
          f"round: " + ", ".join(
              f"{k} {metrics[f'dso_dispatch_ms_{k}']:.2f} / "
              f"{metrics[f'dso_dispatch_max_ms_{k}']:.2f} ms"
              for k in ("encode", "cached")))

    enc = [t["encode_s"] for t in phases if t["encode_s"] > 0]
    print(f"[chip_smoke] engine: per request, mean encode "
          f"{np.mean(enc) * 1e3:.1f} ms over {len(enc)} encodes, mean "
          f"candidate scoring (chunk dispatches incl. coalescing wait) "
          f"{np.mean([t['execute_s'] for t in phases]) * 1e3:.1f} ms")
    check_executors(eng, "engine", cfg.vocab_size)
    dispatch_times(eng, bundle, params, hist, n_history, cfg, device, seed)
    del eng

    # scores vs the port's plain path on the reference device (same
    # weights): encode -> int8 in the epilogue -> score_candidates
    t0 = time.perf_counter()
    ref_params = C.params_to(params, reference_device)
    del params
    store = RemoteFeatureStore(feature_dim=C.N_SIDE_FEATURES, latency_s=0.0,
                               seed=seed)
    worst = 0.0
    with torch.inference_mode():
        for u in range(4):
            feats = store.query([int(i) for i in hist[u]])
            side = np.mean(list(feats.values()), axis=0,
                           keepdims=True).astype(np.float32)
            kv = C.encode_history(ref_params, {
                "history": torch.from_numpy(hist[u][None, :n_history]),
                "side": torch.from_numpy(side)}, cfg, impl="fused")
            raw = quantize_kv_graph(kv, "int8")
            for rnd, got in zip(rounds, outs):
                for (uu, c), o in zip(rnd, got):
                    if uu != u:
                        continue
                    want = torch.sigmoid(C.score_candidates(
                        ref_params, raw, torch.from_numpy(c[None]), cfg,
                        impl="fused")).numpy()[0]
                    worst = max(worst, float(np.abs(o - want).max()))
    if not worst <= SCORE_TOL:
        fail(f"engine scores vs the {reference_device} plain path: max abs "
             f"err {worst:.3g} > {SCORE_TOL}")
    print(f"[chip_smoke] engine: scores match the {reference_device} plain "
          f"path within {SCORE_TOL} (max abs err {worst:.3g}; "
          f"{time.perf_counter() - t0:.1f}s)")
    return launches


# ---------------------------------------------------------------------------
# generation phases
# ---------------------------------------------------------------------------

def make_gen_traffic(n_history: int, vocab: int, seed: int):
    """Four users; users 0 and 2 ask for top-k (k 4), 1 and 3 for beam
    search (width 4), all over ``range(GEN_VOCAB)`` for GEN_STEPS steps.
    Round A: every user's first request (misses, encodes); round B: the same
    requests again (hits that must equal round A) plus one 128-candidate
    scoring request of user 0 (a ``cached`` dispatch under the phase's
    impl).  Returns (histories, generate configs, rounds)."""
    import numpy as np
    from repro_torch.serving import BeamConfig, TopKConfig
    rng = np.random.default_rng(seed + 11)
    hist = [rng.integers(0, vocab, n_history + 8).astype(np.int32)
            for _ in range(4)]
    gens = [TopKConfig(k=4, steps=GEN_STEPS) if u % 2 == 0
            else BeamConfig(width=4, steps=GEN_STEPS) for u in range(4)]
    score = rng.integers(0, vocab, 128).astype(np.int32)
    rounds = [[(u, gens[u], None) for u in range(4)],
              [(u, gens[u], None) for u in range(4)] + [(0, None, score)]]
    return hist, gens, rounds


def gen_dispatch_times(eng, root, device, what: str):
    """The ``decode`` (bucket 128) and ``append`` executors called outside
    the engine at batch 4 on the root cache of one user: one eager call on
    one thread, and a CUDA-graph replay (the device alone)."""
    import torch
    from repro_torch.tree import leaves
    rows = eng._pad_beam_leaves(leaves(root))
    stacked = [torch.cat([r] * 4) for r in rows]
    lengths = torch.full((4,), eng._s0, dtype=torch.int32, device=device)
    idx = torch.arange(4, dtype=torch.int32, device=device)
    g = torch.Generator(device=device).manual_seed(5)
    cands = torch.randint(0, GEN_VOCAB, (4, 128), generator=g,
                          device=device, dtype=torch.int32)
    toks = cands[:, :1].contiguous()
    dec = eng.dso.executors[("decode", 128)][0].fn
    app = eng.dso.executors[("append", 1)][0].fn
    out = {}
    with torch.inference_mode():
        for name, fn, key in (
                ("decode b128", lambda: dec(*stacked, lengths, idx, cands),
                 ("decode", 128)),
                ("append", lambda: app(*stacked, lengths, toks),
                 ("append", 1))):
            eager = host_ms(fn, reps=5)
            captured = executor_ms(eng, *key, vocab=GEN_VOCAB)
            dev = device_ms(fn, per_graph=1, reps=5)
            out[name] = (eager, captured, dev)
            print(f"[chip_smoke] {what} dispatch {name} (batch 4), alone: "
                  f"one eager call {eager:.2f} ms, captured executor "
                  f"{captured:.2f} ms, device (CUDA graph) {dev:.2f} ms")
    return out


def gen_phase(cfg, device, *, impl: str, n_history: int, buckets,
              seed: int = 0):
    """Drive generation through the port's engine under ``impl`` (full
    width, int8 pool, generate=GEN_STEPS, gen_vocab=GEN_VOCAB); returns the
    kernels' launch counts over the driven rounds."""
    import numpy as np
    import torch
    from repro_torch.core import climber as C
    from repro_torch.core.pda import RemoteFeatureStore
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.fused_ffn import ops as ff
    from repro_torch.kernels.fused_score import ops as fs
    from repro_torch.serving import ServeRequest, create_engine
    from repro_torch.tree import leaves, unflatten

    what = f"gen {impl}"
    t0 = time.perf_counter()
    params = C.climber_init(
        cfg, torch.Generator(device=device).manual_seed(seed), device)
    bundle = C.build_climber(cfg)
    eng = create_engine(
        "flame", bundle, params, n_history=n_history, buckets=buckets,
        max_batch=4, pool_dtype="int8", impl=impl, generate=GEN_STEPS,
        gen_vocab=GEN_VOCAB, device=device,
        store=RemoteFeatureStore(feature_dim=C.N_SIDE_FEATURES, seed=seed))
    hist, gens, rounds = make_gen_traffic(n_history, cfg.vocab_size, seed)
    print(f"[chip_smoke] {what}: FlameEngine(impl={impl!r}, generate="
          f"{GEN_STEPS}, gen_vocab={GEN_VOCAB}), pool int8, S_pad "
          f"{eng._s0 + GEN_STEPS} (set-up {time.perf_counter() - t0:.1f}s)")

    def serve(rnd):
        futs = [eng.submit(ServeRequest(history=hist[u], candidates=c,
                                        generate=gcfg, user_id=u))
                for u, gcfg, c in rnd]
        return [f.result(timeout=600) for f in futs]

    # K4's entry counts the form the path runs (the self-slot form); its
    # single-token form must not run here
    kernels = {"fused_score": fs.fused_score, "flash_attention":
               fa.flash_attention, "fused_ffn": ff.fused_ffn_2d,
               "flash_decode": fd.flash_decode_with_self,
               "flash_decode single-token": fd.flash_decode}
    try:
        before = eng.metrics()
        for k in kernels.values():
            k.launches = 0
        t_run = time.perf_counter()
        outs, lat = [], []
        for rnd in rounds:
            res = serve(rnd)
            outs.append([r.output for r in res])
            lat += [r.latency_s for r in res if r.output.dtype == np.int32]
        wall = time.perf_counter() - t_run
        launches = {n: k.launches for n, k in kernels.items()}
        metrics = eng.metrics()
        fp0 = eng._fingerprint(hist[0])
        root = eng.history_pool.peek(("u", 0), fp0, raw=True)
        if root is None:
            fail(f"{what}: user 0's root entry left the pool")
    finally:
        eng.shutdown()
    check_executors(eng, what, GEN_VOCAB)
    times = gen_dispatch_times(eng, root, device, what)
    d = {k: metrics[f"dso_dispatches_{k}"] - before[f"dso_dispatches_{k}"]
         for k in ("encode", "cached", "decode", "append")}
    n_gen = sum(1 for rnd in rounds for _, gcfg, _ in rnd if gcfg)
    print(f"[chip_smoke] {what}: {n_gen} generation requests resolved in "
          f"{wall:.3f}s, latency p50 {np.percentile(lat, 50) * 1e3:.1f} ms "
          f"p99 {np.percentile(lat, 99) * 1e3:.1f} ms, "
          f"{metrics['gen_tokens_per_s']:.1f} generated tokens/s; "
          f"dispatches {d}; gen_tokens {metrics['gen_tokens']}, "
          f"decode_steps {metrics['decode_steps']}, dedup rows saved "
          f"{metrics['dso_dedup_rows_saved']}")
    print(f"[chip_smoke] {what}: per dispatch in the engine (captured "
          f"executor until its stream finished), mean / longest: "
          + ", ".join(f"{k} {metrics[f'dso_dispatch_ms_{k}']:.2f} / "
                      f"{metrics[f'dso_dispatch_max_ms_{k}']:.2f} ms"
                      for k in ("encode", "cached", "decode", "append")))

    # every output: [width, steps] ids from the universe (-1: finished)
    for rnd, got in zip(rounds, outs):
        for (u, gcfg, c), o in zip(rnd, got):
            if gcfg is None:
                if o.shape != (len(c), cfg.climber.num_tasks) \
                        or not np.isfinite(o).all():
                    fail(f"{what}: user {u} scores {o.shape} not finite")
                continue
            width = getattr(gcfg, "k", None) or gcfg.width
            if o.shape != (width, GEN_STEPS) or o.min() < -1 \
                    or o.max() >= GEN_VOCAB or (o[:, 0] < 0).any():
                fail(f"{what}: user {u} output {o.shape} [{o.min()}, "
                     f"{o.max()}] is not [{width}, {GEN_STEPS}] ids")
    # a user's generation on a hit equals its generation on a miss
    for u in range(4):
        if not np.array_equal(outs[0][u], outs[1][u]):
            fail(f"{what}: user {u}: generation on a hit != on a miss")
    n_layers = cfg.climber.num_blocks * cfg.climber.layers_per_block
    if impl == "pallas":
        want = {"flash_attention": d["encode"] + d["cached"],
                "fused_ffn": d["encode"] + d["cached"] + d["decode"]
                + d["append"],
                "flash_decode": d["decode"] + d["append"], "fused_score": 0,
                "flash_decode single-token": 0}
    else:
        want = {"fused_score": d["cached"] + d["decode"] + d["append"],
                "flash_attention": d["encode"], "fused_ffn": 0,
                "flash_decode": 0, "flash_decode single-token": 0}
    for name, n in launches.items():
        if n != n_layers * want[name] or (want[name] and n <= 0):
            fail(f"{what}: {name}: {n} launches, want {n_layers} x "
                 f"{want[name]} dispatches")
    if min(d.values()) <= 0:
        fail(f"{what}: a family did not run: {d}")
    print(f"[chip_smoke] {what}: hit == miss for 4 users; launches "
          f"{launches} ({n_layers} per dispatch of each kernel's families, "
          f"counted per replay)")

    universe = torch.arange(GEN_VOCAB, dtype=torch.int32, device=device)
    with torch.inference_mode():
        if impl == "fused":
            # decode at the root (lengths == S, no padding) is bitwise the
            # cached scoring of the same stored int8 rows
            cands = universe[None, :128]
            lens = torch.full((1,), eng._s0, dtype=torch.int32,
                              device=device)
            got = bundle.decode_logits(params, root, cands, lens,
                                       impl="fused")
            want_s = bundle.score_candidates(params, root, cands,
                                             impl="fused")
            if not torch.equal(got, want_s):
                fail(f"{what}: root decode != cached scoring "
                     f"(max diff {(got - want_s).abs().max().item():.3g})")
            print(f"[chip_smoke] {what}: root decode == cached scoring "
                  f"bitwise on the stored int8 rows (K1, lengths == S)")
        else:
            # the first decode step vs the port's plain path on the CPU,
            # from the same stored root
            t1 = time.perf_counter()
            padded = unflatten(eng._cached_struct,
                               eng._pad_beam_leaves(leaves(root)))
            lens = torch.full((1,), eng._s0, dtype=torch.int32,
                              device=device)
            probs = bundle.decode_logits(params, padded, universe[None],
                                         lens, impl="pallas")[0]
            cpu = torch.device("cpu")
            ref_params = C.params_to(params, cpu)
            ref = bundle.decode_logits(
                ref_params, unflatten(eng._cached_struct,
                                      [t.to(cpu) for t in leaves(padded)]),
                universe[None].cpu(), lens.cpu(), impl="pallas")[0]
            err = float((probs.float().cpu() - ref.float()).abs().max())
            if not err <= GEN_TOL:
                fail(f"{what}: first decode step vs the CPU plain path: "
                     f"max abs err {err:.3g} > {GEN_TOL}")
            # user 0's top-k seeds its k beams with the step's k best
            # tokens, and every beam keeps its first token
            lp = probs.float().sum(-1).cpu()
            k = outs[0][0].shape[0]
            top = sorted(int(i) for i in torch.topk(lp, k).indices)
            first = sorted(int(t) for t in outs[0][0][:, 0])
            if first != top:
                edge = torch.sort(lp, descending=True).values
                print(f"[chip_smoke] {what}: note: engine's first tokens "
                      f"{first} != the step's top-{k} {top} (k-th vs "
                      f"k+1-th score gap {float(edge[k - 1] - edge[k]):.3g})")
            print(f"[chip_smoke] {what}: first decode step matches the CPU "
                  f"plain path within {GEN_TOL} (max abs err {err:.3g}; "
                  f"{time.perf_counter() - t1:.1f}s)")
    return launches, times


@contextlib.contextmanager
def uncounted():
    """Kernel launches made inside are taken back off the counters: calls
    that compare or diagnose are not the main path's."""
    from repro_torch.kernels import _build
    before = _build.launch_counts()
    try:
        yield
    finally:
        _build.add_launches({k: before[k] - n for k, n in
                             _build.launch_counts().items()})


# ---------------------------------------------------------------------------
# the wide-head Climber: K1's any-dims variant on the served path
# ---------------------------------------------------------------------------

#: head dims of the wide-head Climber (published width, heads widened):
#: one the size of an instantiation, and one of ragged head-dim columns
WIDE_HEAD_DIMS = (256, 192)
#: top-2 gap of a decode step's summed task probabilities under which the
#: repeated-prefill check reports a differing token instead of failing
#: (the engine's executors and the eager loop run other batch shapes, so
#: their bf16 products round otherwise)
WIDE_TIE_GAP = 1e-2


def wide_traffic(n_history: int, vocab: int, seed: int):
    """Users 0-3 with 600-item histories and one 128-candidate slate; their
    stale variants (0, 1: a 4-item tail append, the model window unchanged;
    2, 3: an edit at window position 400, block 1's prefix 144 of 256
    rows); users 4 (top-k, k 4) and 5 (beam, width 4) generating
    GEN_STEPS steps over the GEN_VOCAB universe."""
    import numpy as np
    from repro_torch.serving import BeamConfig, TopKConfig
    rng = np.random.default_rng(seed + 43)
    hist = {u: rng.integers(0, vocab, 600).astype(np.int32)
            for u in range(6)}
    stale = {u: np.concatenate([hist[u], rng.integers(0, vocab, 4).astype(
        np.int32)]) for u in (0, 1)}
    for u in (2, 3):
        stale[u] = hist[u].copy()
        stale[u][400] = (stale[u][400] + 1) % vocab
    slate = rng.integers(0, vocab, 128).astype(np.int32)
    gen = [(4, TopKConfig(k=4, steps=GEN_STEPS)),
           (5, BeamConfig(width=4, steps=GEN_STEPS))]
    return hist, stale, slate, gen


def wide_topk_check(eng, bundle, params, root, out, device, what: str):
    """Top-k generation == repeated prefill: the engine's k beams (``out``
    [k, steps], best first) against a loop that, at every step t, rebuilds
    each beam's cache afresh from the stored root (its first t tokens
    appended one at a time, ``append_token``; the k beams as one batch) and
    scores the universe (``decode_logits``) eagerly; each beam's best token
    must be the engine's (the first step's k best its k first tokens).  A
    token that differs where the top-2 gap is under WIDE_TIE_GAP is
    reported, not failed.  Returns the steps that agreed."""
    import torch
    from repro_torch.tree import leaves, unflatten
    k, steps = out.shape
    s0 = eng._s0
    root = [t.expand(k, *t.shape[1:]).contiguous()
            for t in eng._pad_beam_leaves(leaves(root))]
    root = unflatten(eng._cached_struct, root)
    universe = torch.arange(GEN_VOCAB, dtype=torch.int32,
                            device=device).expand(k, GEN_VOCAB)
    toks = torch.as_tensor(out, dtype=torch.int32, device=device)

    def at(t):
        return torch.full((k,), s0 + t, dtype=torch.int32, device=device)

    gated, near = 0, []
    with uncounted(), torch.inference_mode():
        first = bundle.decode_logits(params, root, universe, at(0),
                                     impl="fused")[0].float().sum(-1)
        top = torch.topk(first, k + 1).values
        want = sorted(int(i) for i in torch.topk(first, k).indices)
        if sorted(int(t) for t in out[:, 0]) == want:
            gated += 1
        elif float(top[k - 1] - top[k]) < WIDE_TIE_GAP:
            near.append(("first", want, out[:, 0].tolist()))
        else:
            fail(f"{what}: top-k first tokens {out[:, 0].tolist()} != the "
                 f"root's {k} best {want}")
        for t in range(1, steps):
            cache = root
            for j in range(t):
                cache = bundle.append_token(params, cache, toks[:, j:j + 1],
                                            at(j), impl="fused")
            sc = bundle.decode_logits(params, cache, universe, at(t),
                                      impl="fused").float().sum(-1)
            top2 = torch.topk(sc, 2, dim=-1).values
            for r in range(k):
                best, gap = int(sc[r].argmax()), float(top2[r, 0] - top2[r, 1])
                if best == int(out[r, t]):
                    gated += 1
                elif gap < WIDE_TIE_GAP:
                    near.append((r, t, best, int(out[r, t])))
                else:
                    fail(f"{what}: top-k beam {r} step {t}: engine token "
                         f"{int(out[r, t])} != repeated prefill {best} "
                         f"(top-2 gap {gap:.3g})")
    if near:
        print(f"[chip_smoke] {what}: tokens that differ at near ties (beam, "
              f"step, repeated prefill, engine), reported: {near}")
    return gated


def wide_head_phase(device, card: str, head_dim: int, *, n_history: int,
                    buckets, seed: int = 0) -> dict:
    """The wide-head Climber served end to end through K1's any-dims
    variant: the published Climber (d_model 256, 4 heads, 2 x 12 layers,
    vocab 2,000,000, bf16 weights from a seeded generator) with only its
    head dim set to ``head_dim`` (q / k / v / o projections 256 ->
    4 x ``head_dim``), one ``FlameEngine(impl="fused",
    history_cache=True)`` with an int8 pool, ``incremental_history``,
    ``generate=GEN_STEPS``: scoring misses then hits (``encode`` on K2,
    ``cached`` on K1), stale hits (``extend``: a tail append at bucket n,
    an edit at 400), top-k and beam generation, miss then hit
    (``decode`` / ``append``).  Checks hit == miss bitwise (scores and
    tokens), the extended entries within EXT_TOL_INT8 of a fresh encode,
    each kernel's launches against the executors' replays x their
    captured launches (K1 one a call: 24 a replay of ``cached``,
    ``decode``, ``append`` and ``extend`` at n and 3n/4; K2 24 a replay of
    ``encode``), that every family ran, replay == eager for every
    executor, and top-k generation == repeated prefill
    (:func:`wide_topk_check`).  Returns the launches, K1's under
    ``fused_score_any``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import climber as C
    from repro_torch.core.pda import RemoteFeatureStore
    from repro_torch.kernels import _build
    from repro_torch.serving import ServeRequest, create_engine
    from repro_torch.serving.kv_cache import quantize_kv_graph

    what = f"wide heads D {head_dim}"
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("climber"), head_dim=head_dim)
    params = C.climber_init(
        cfg, torch.Generator(device=device).manual_seed(seed), device)
    bundle = C.build_climber(cfg)
    eng = create_engine(
        "flame", bundle, params, n_history=n_history, buckets=buckets,
        max_batch=4, pool_dtype="int8", impl="fused", history_cache=True,
        incremental_history=True, generate=GEN_STEPS, gen_vocab=GEN_VOCAB,
        device=device, store=RemoteFeatureStore(
            feature_dim=C.N_SIDE_FEATURES, seed=seed))
    n_layers = cfg.climber.num_blocks * cfg.climber.layers_per_block
    print(f"[chip_smoke] {what}: Climber d_model {cfg.d_model}, "
          f"{cfg.n_heads}x{cfg.head_dim} heads over {cfg.n_kv_heads} KV "
          f"heads, d_ff {cfg.d_ff}, {cfg.climber.num_blocks} blocks x "
          f"{cfg.climber.layers_per_block} layers, vocab {cfg.vocab_size}; "
          f"n_history {n_history}, buckets {tuple(buckets)}, extend buckets "
          f"{eng.dso.families['extend']}, pool int8, impl fused, generate "
          f"{GEN_STEPS}; CUDA-graph capture {eng.dso.graph_capture_s:.2f}s "
          f"(set-up {time.perf_counter() - t0:.1f}s)")
    hist, stale, slate, gen = wide_traffic(n_history, cfg.vocab_size, seed)
    store = RemoteFeatureStore(feature_dim=C.N_SIDE_FEATURES, latency_s=0.0,
                               seed=seed)

    def serve(reqs):
        futs = [eng.submit(ServeRequest(history=h, candidates=c, user_id=u,
                                        generate=g)) for u, h, c, g in reqs]
        return [f.result(timeout=600).output for f in futs]

    def calls():
        return {key: sum(ex.calls for ex in exs)
                for key, exs in eng.dso.executors.items()}

    scoring = [(u, hist[u], slate, None) for u in range(4)]
    generating = [(u, hist[u], None, g) for u, g in gen]
    try:
        # every kernel's count set to 0 just before the phase drives the
        # path
        _build.add_launches({k: -v for k, v in
                             _build.launch_counts().items()})
        c0 = calls()
        t_run = time.perf_counter()
        miss, hit = serve(scoring), serve(scoring)
        ext = serve([(u, stale[u], slate, None) for u in range(4)])
        gmiss, ghit = serve(generating), serve(generating)
        wall = time.perf_counter() - t_run
        launches = _build.launch_counts()
        c1 = calls()
        metrics = eng.metrics()
        root = eng.history_pool.peek(("u", 4), eng._fingerprint(hist[4]),
                                     raw=True)
        if root is None:
            fail(f"{what}: user 4's root entry left the pool")
    finally:
        eng.shutdown()
    for u, (a, b) in enumerate(zip(miss, hit)):
        if a.shape != (len(slate), cfg.climber.num_tasks) \
                or not np.isfinite(a).all():
            fail(f"{what}: user {u} scores {a.shape} not finite")
        if not np.array_equal(a, b):
            fail(f"{what}: user {u}: hit != miss (max diff "
                 f"{np.abs(a - b).max():.3g})")
    for (u, g), a, b in zip(gen, gmiss, ghit):
        width = getattr(g, "k", None) or g.width
        if a.shape != (width, GEN_STEPS) or (a[:, 0] < 0).any() \
                or a.max() >= GEN_VOCAB:
            fail(f"{what}: user {u} generated {a.tolist()}")
        if not np.array_equal(a, b):
            fail(f"{what}: user {u}: generation on a hit != on a miss")

    # the extended entries against a fresh encode of the same history
    drift = 0.0
    with uncounted(), torch.inference_mode():
        for u, o in enumerate(ext):
            h = stale[u]
            side = np.mean(list(store.query([int(i) for i in h]).values()),
                           axis=0, keepdims=True).astype(np.float32)
            kv = bundle.encode_history(params, {
                "history": torch.from_numpy(h[None, :n_history]).to(device),
                "side": torch.from_numpy(side).to(device)}, impl="fused")
            want = bundle.score_candidates(
                params, quantize_kv_graph(kv, "int8"),
                torch.from_numpy(slate[None]).to(device), impl="fused")
            drift = max(drift, float(np.abs(
                o - want[0].float().cpu().numpy()).max()))
    if not drift <= EXT_TOL_INT8:
        fail(f"{what}: extended entries vs a fresh encode: max abs err "
             f"{drift:.3g} > {EXT_TOL_INT8}")

    # every kernel launch is an executor replay's
    want, ran = {}, {}
    for key, n in c1.items():
        ran[key] = n - c0[key]
        for name, per in eng.dso.executors[key][0].launches.items():
            want[name] = want.get(name, 0) + ran[key] * per
    got = {k: n for k, n in launches.items() if n}
    if got != {k: n for k, n in want.items() if n}:
        fail(f"{what}: kernel launches {got} != the executors' replays x "
             f"their captured launches {want}")
    k1 = {"fused_score": n_layers}
    shape = {("encode", n_history): {"flash_attention": n_layers},
             ("extend", n_history): k1, ("extend", 3 * n_history // 4): k1,
             ("append", 1): k1}
    shape.update({(kind, b): k1 for kind in ("cached", "decode")
                  for b in buckets})
    for key, per in shape.items():
        exs = eng.dso.executors.get(key)
        if not exs or exs[0].launches != per:
            fail(f"{what}: executor {key} launches "
                 f"{exs[0].launches if exs else None} a replay, want {per}")
    for kind in ("encode", "cached", "extend", "decode", "append"):
        if sum(n for key, n in ran.items() if key[0] == kind) <= 0:
            fail(f"{what}: no {kind} executor ran")
    if metrics["pool_extensions"] < 4:
        fail(f"{what}: pool_extensions {metrics['pool_extensions']} < 4")
    print(f"[chip_smoke] {what}: 4 scoring users missed then hit (hit == "
          f"miss bitwise), 4 stale hits extended (scores within "
          f"{EXT_TOL_INT8} of a fresh encode: max abs err {drift:.3g}), "
          f"top-k and beam generation missed then hit (tokens equal) in "
          f"{wall:.3f}s; executor replays "
          f"{ {'/'.join(map(str, k)): n for k, n in ran.items() if n} }; "
          f"launches {got} (K1 {n_layers} a replay: one kernel a call)")
    check_executors(eng, what, GEN_VOCAB)
    gated = wide_topk_check(eng, bundle, params, root, gmiss[0], device,
                            what)
    print(f"[chip_smoke] {what}: top-k generation == repeated prefill on "
          f"{gated} of {1 + 4 * (GEN_STEPS - 1)} steps; "
          f"{time.perf_counter() - t0:.1f}s; {card}")
    return {"fused_score_any": launches.get("fused_score", 0),
            "flash_attention": launches.get("flash_attention", 0)}


def extend_pack_traffic(n_history: int, vocab: int, seed: int):
    """Extension users 0-3: a 600-item history each, then three stale
    variants in turn — a 4-item tail append (the window unchanged: bucket
    n), an edit at window position 400 (bucket 3n/4) and one at 300 (bucket
    n/2, whose block 1 has an empty prefix) — with one 128-candidate slate.
    Packing: 12 scoring requests of users 10-15 with candidate counts drawn
    from {3, 5, 9, 15, 40, 77, 130} (the ``dso_nonuniform`` regime of
    ``benchmarks/bench_serving.py``, widened to the three buckets; each
    value at least once).
    Generation: user 20 top-k (k 4) over 40 ids, user 21 beam (width 4)
    over 77 ids, GEN_STEPS steps: ragged universes, so the segments of
    several beams share a packed row (full 256-id universes fill rows
    alone).  Returns (extension stages, slate, packing requests,
    generation requests)."""
    import numpy as np
    from repro_torch.serving import BeamConfig, TopKConfig
    rng = np.random.default_rng(seed + 29)
    h0 = [rng.integers(0, vocab, 600).astype(np.int32) for _ in range(4)]
    stages = [("encode", h0)]
    h = [np.concatenate([x, rng.integers(0, vocab, 4).astype(np.int32)])
         for x in h0]
    stages.append(("tail append", h))
    for name, pos in (("edit at 400", 400), ("edit at 300", 300)):
        h = [x.copy() for x in h]
        for x in h:
            x[pos] = (x[pos] + 1) % vocab
        stages.append((name, h))
    slate = rng.integers(0, vocab, 128).astype(np.int32)
    hist = {u: rng.integers(0, vocab, n_history + 8).astype(np.int32)
            for u in list(range(10, 16)) + [20, 21]}
    counts = [3, 5, 9, 15, 40, 77, 130]          # each once, so every
    counts = rng.permutation(counts + list(       # bucket runs
        rng.choice(counts, 12 - len(counts))))
    pack = [(10 + i % 6, rng.integers(0, vocab, int(m)).astype(np.int32))
            for i, m in enumerate(counts)]
    gen = [(20, TopKConfig(k=4, steps=GEN_STEPS),
            rng.integers(0, vocab, 40).astype(np.int32)),
           (21, BeamConfig(width=4, steps=GEN_STEPS),
            rng.integers(0, vocab, 77).astype(np.int32))]
    return stages, slate, hist, pack, gen


def extend_pack_phase(cfg, device, *, n_history: int, buckets,
                      seed: int = 0):
    """The ``extend`` family and segment packing through the port's
    engines at the published Climber width (the scoring phase's weights:
    the same seed), int8 pool, ``max_batch`` 4:

    A. ``impl="fused", incremental_history=True, pack_tails=True,
       generate=GEN_STEPS`` serves the extension stages (12 stale hits,
       each extended: K1's extend mode, K2 where a block's prefix is
       empty), the 12 ragged scoring requests at once and the two ragged
       generation requests (packed ``cached`` / ``decode``: K1 with a 2-D
       index).  Each extended entry's scores are held within 5e-2 (int8
       drift) of a fresh encode of the same history on the card; a bf16
       pool engine (C) reruns the tail append within 5e-3.
    B. the same engine unpacked, scoring from A's stored rows: A's packed
       scores within PACK_TOL of B's (A packs into 1 row where B has 4, and
       the layers' products round otherwise at another row count: shown by
       B's executor function cut to one row), F's (packed into 4 rows)
       bitwise; the
       generation tokens of A and B compared and printed.
    D, E. ``impl="pallas"`` generation engines, packed into 4 rows and
       unpacked: the generation requests through K4's self-slot form with a
       2-D index give the unpacked tokens.

    Checks the launches of every executor, counted per replay, against
    each kernel's counter (24 a layer chain; 12 + 12 for an extend whose
    block 1 has an empty prefix), that every family ran, and replay ==
    eager for every executor of A and D; prints the packed and unpacked
    rounds' padded fractions and the new executors' times.  Returns the
    kernels' launches over the phase."""
    import numpy as np
    import torch
    from repro_torch.core import climber as C
    from repro_torch.core.pda import RemoteFeatureStore
    from repro_torch.kernels import _build
    from repro_torch.serving import ServeRequest, create_engine
    from repro_torch.serving.kv_cache import quantize_kv_graph
    from repro_torch.tree import leaves

    what = "extend + packing"
    t0 = time.perf_counter()
    params = C.climber_init(
        cfg, torch.Generator(device=device).manual_seed(seed), device)
    bundle = C.build_climber(cfg)

    def engine(**kw):
        base = dict(n_history=n_history, buckets=buckets, max_batch=4,
                    pool_dtype="int8", impl="fused", device=device,
                    generate=GEN_STEPS, gen_vocab=GEN_VOCAB,
                    store=RemoteFeatureStore(
                        feature_dim=C.N_SIDE_FEATURES, seed=seed))
        base.update(kw)
        return create_engine("flame", bundle, params, **base)

    engines = {"A": engine(incremental_history=True, pack_tails=True),
               "B": engine(),
               "C": engine(pool_dtype="bf16", buckets=(128,), generate=0,
                           n_streams=1, incremental_history=True,
                           extend_buckets=(n_history,)),
               # D and F pack into the unpacked engines' row count (rows =
               # max_batch): their products run at E's and B's shapes, so
               # packed == unpacked is bitwise there
               "D": engine(impl="pallas", pack_tails=True, pack_rows=4,
                           n_streams=1),
               "E": engine(impl="pallas", n_streams=1),
               "F": engine(pack_tails=True, pack_rows=4, generate=0,
                           n_streams=1)}
    A = engines["A"]
    print(f"[chip_smoke] {what}: six engines (A fused incremental + "
          f"packed, B fused, C fused bf16 pool incremental, D pallas "
          f"packed, E pallas, F fused packed in 4 rows), extend buckets "
          f"{A.dso.families['extend']}, packed rows {A.dso.policy.rows} "
          f"aligned to {A.dso.policy.pack_align}; CUDA-graph capture "
          + ", ".join(f"{k} {e.dso.graph_capture_s:.2f}s"
                      for k, e in engines.items())
          + f" (set-up {time.perf_counter() - t0:.1f}s)")
    stages, slate, hist, pack, gen = extend_pack_traffic(
        n_history, cfg.vocab_size, seed)
    store = RemoteFeatureStore(feature_dim=C.N_SIDE_FEATURES, latency_s=0.0,
                               seed=seed)

    def serve(eng, reqs):
        futs = [eng.submit(ServeRequest(history=h, candidates=c, user_id=u,
                                        generate=g)) for u, h, c, g in reqs]
        return [f.result(timeout=600) for f in futs]

    def fresh(h, pool):
        """Scores of the slate from a fresh encode of ``h`` on the card (a
        comparison: its launches are taken back off the counters)."""
        side = np.mean(list(store.query([int(i) for i in h]).values()),
                       axis=0, keepdims=True).astype(np.float32)
        with uncounted(), torch.inference_mode():
            kv = bundle.encode_history(params, {
                "history": torch.from_numpy(h[None, :n_history]).to(device),
                "side": torch.from_numpy(side).to(device)}, impl="fused")
            return bundle.score_candidates(
                params, quantize_kv_graph(kv, pool),
                torch.from_numpy(slate[None]).to(device),
                impl="fused")[0].float().cpu().numpy()

    def calls():
        return {(k, key): sum(ex.calls for ex in exs)
                for k, e in engines.items()
                for key, exs in e.dso.executors.items()}

    # every kernel's count set to 0 just before the phase drives the path
    _build.add_launches({k: -v for k, v in _build.launch_counts().items()})
    c0 = calls()
    t_run = time.perf_counter()
    drift = {}
    # extension stages on A (int8) and, for the tail append, C (bf16)
    for i, (name, hs) in enumerate(stages):
        for tag, eng, pool, tol in (("int8", A, "int8", EXT_TOL_INT8),
                                    ("bf16", engines["C"], "bf16",
                                     EXT_TOL_BF16)):
            if tag == "bf16" and i > 1:
                continue
            outs = [r.output for r in serve(eng, [
                (u, h, slate, None) for u, h in enumerate(hs)])]
            if i == 0:
                continue
            err = max(float(np.abs(o - fresh(h, pool)).max())
                      for o, h in zip(outs, hs))
            drift[f"{name} ({tag} pool)"] = err
            if not err <= tol:
                fail(f"{what}: {name} ({tag} pool): extended entries' "
                     f"scores vs a fresh encode max abs err {err:.3g} > "
                     f"{tol}")
    def share(src, dst, users):
        """Put ``src``'s pool entries of ``users`` into ``dst``'s pool, so
        that both engines score from the same stored rows; returns how
        many ``dst`` already held bitwise."""
        same = 0
        for u in users:
            key, fp = ("u", u), src._fingerprint(hist[u])
            raw = src.history_pool.peek(key, fp, raw=True)
            old = dst.history_pool.peek(key, fp, raw=True)
            same += old is not None and all(
                torch.equal(a, b) for a, b in zip(leaves(raw), leaves(old)))
            dst.history_pool.put(key, fp, raw, hist_window=hist[u][
                :n_history], prequantized=True,
                compute_dtype=dst._kv_compute_dtype)
        return same

    # packing: warm both engines' pools, then the 12 requests at once, both
    # from A's stored rows
    slots = {}
    outs = {}
    for k in ("A", "B"):
        serve(engines[k], [(u, hist[u], slate[:16], None)
                           for u in range(10, 16)])
    same = {"packing": share(A, engines["B"], range(10, 16))}
    share(A, engines["F"], range(10, 16))
    for k in ("A", "B", "F"):
        st0 = engines[k].dso.stats()
        outs[k] = [r.output for r in serve(engines[k], [
            (u, hist[u], c, None) for u, c in pack])]
        st1 = engines[k].dso.stats()
        slots[k] = [st1[f"cand_{x}_cached"] - st0[f"cand_{x}_cached"]
                    for x in ("slots", "valid")]
    moved, worst = {"A": 0, "F": 0}, 0.0
    for k in moved:
        for (u, c), a, b in zip(pack, outs[k], outs["B"]):
            if a.shape != (len(c), cfg.climber.num_tasks) \
                    or not np.isfinite(a).all():
                fail(f"{what}: user {u}: packed scores {a.shape} not finite "
                     f"[{len(c)}, {cfg.climber.num_tasks}]")
            moved[k] += int((a != b).any(-1).sum())
            worst = max(worst, float(np.abs(a - b).max()))
    if not worst <= PACK_TOL or moved["F"]:
        fail(f"{what}: packed scores vs unpacked: max abs err {worst:.3g} "
             f"(limit {PACK_TOL}), {moved['F']} candidates not bitwise at "
             f"the unpacked shapes")
    n_cands = sum(len(c) for _, c in pack)
    # does a candidate's score depend on where it sits? (B's cached
    # executor function with its batch rows rolled by one)
    args = [torch.from_numpy(a).to(device) if isinstance(a, np.ndarray)
            else a for a in family_args(engines["B"], "cached", buckets[0],
                                        cfg.vocab_size, seed=41)]
    fnB = engines["B"].dso.executors[("cached", buckets[0])][0].fn
    with uncounted(), torch.inference_mode():
        base = fnB(*args)
        rolled = fnB(*args[:-2], *(torch.roll(a, 1, 0) for a in args[-2:]))
        row_moved = int((base != torch.roll(rolled, -1, 0)).any(-1).sum())
    n_rows = base.shape[0] * base.shape[1]
    # and what packing into fewer rows changes: batch row 0 of that call
    # alone, at batch 1
    with uncounted(), torch.inference_mode():
        r0 = int(args[-2][0])
        alone = fnB(*(a[r0:r0 + 1] for a in args[:-2]),
                    torch.zeros_like(args[-2][:1]), args[-1][:1])
        one_row = int((alone[0] != base[0]).any(-1).sum())

    # generation, packed and unpacked, fused and pallas, each pair from the
    # packed engine's roots
    tokens = {}
    for x, y in (("A", "B"), ("D", "E")):
        tokens[x] = [r.output for r in serve(engines[x], [
            (u, hist[u], c, g) for u, g, c in gen])]
        serve(engines[y], [(u, hist[u], slate[:4], None) for u, _, _ in gen])
        same[f"roots {x}"] = share(engines[x], engines[y], [20, 21])
        tokens[y] = [r.output for r in serve(engines[y], [
            (u, hist[u], c, g) for u, g, c in gen])]
    token_eq = {}
    for x, y in (("A", "B"), ("D", "E")):
        for (u, g, c), a, b in zip(gen, tokens[x], tokens[y]):
            width = getattr(g, "k", None) or g.width
            if a.shape != (width, GEN_STEPS) or not np.isin(
                    a[a >= 0], c).all() or (a[:, 0] < 0).any():
                fail(f"{what}: user {u}: engine {x} generated {a.tolist()}, "
                     f"not [{width}, {GEN_STEPS}] ids of its universe")
            token_eq[f"{x}/{y} user {u}"] = bool(np.array_equal(a, b))
            if x == "D" and not token_eq[f"{x}/{y} user {u}"]:
                fail(f"{what}: user {u}: packed pallas tokens {a.tolist()} "
                     f"!= unpacked {b.tolist()} at the unpacked shapes")
    wall = time.perf_counter() - t_run
    launches = _build.launch_counts()
    c1 = calls()
    metrics = {k: e.metrics() for k, e in engines.items()}
    for e in engines.values():
        e.shutdown()

    # every executor's replays account for the kernels' counters
    want = {name: 0 for name in launches}
    ran = {}
    for (k, key), n in c1.items():
        n -= c0[(k, key)]
        ran[(k,) + key] = n
        per = engines[k].dso.executors[key][0].launches
        for name, per_call in per.items():
            want[name] += n * per_call
    if want != launches:
        fail(f"{what}: kernel launches {launches} != the executors' "
             f"replays x their captured launches {want}")
    n_layers = cfg.climber.num_blocks * cfg.climber.layers_per_block
    per_block = cfg.climber.layers_per_block
    shape = {("A", "extend", n_history): {"fused_score": n_layers},
             ("A", "extend", n_history // 2): {"fused_score": per_block,
                                               "flash_attention": per_block},
             ("A", "cached", buckets[0]): {"fused_score": n_layers},
             ("A", "decode", buckets[0]): {"fused_score": n_layers},
             ("D", "decode", buckets[0]): {"flash_decode_with_self": n_layers,
                                           "fused_ffn_2d": n_layers}}
    for (k, kind, b), per in shape.items():
        got = engines[k].dso.executors[(kind, b)][0].launches
        got = {n: c for n, c in got.items() if n in per}
        if got != per:
            fail(f"{what}: engine {k} ({kind}, {b}) launches {got} per "
                 f"replay, want {per}")
    for key in [("A", "extend", b) for b in A.dso.families["extend"]] \
            + [("A", "cached", b) for b in buckets] \
            + [("A", "decode", b) for b in buckets[1:]] \
            + [("D", "decode", b) for b in buckets[1:]] \
            + [("C", "extend", n_history)]:
        if ran.get(key, 0) <= 0:
            fail(f"{what}: executor {key} never ran")
    mA = metrics["A"]
    if mA["pool_extensions"] < 3 or mA["dso_packed_segments"] <= 0 \
            or metrics["D"]["dso_packed_segments"] <= 0:
        fail(f"{what}: pool_extensions {mA['pool_extensions']}, packed "
             f"segments {mA['dso_packed_segments']} / "
             f"{metrics['D']['dso_packed_segments']}")
    pf = {k: 1.0 - v / s_ if s_ else 0.0 for k, (s_, v) in slots.items()
          if k != "F"}
    print(f"[chip_smoke] {what}: {wall:.1f}s; extensions A "
          f"{mA['pool_extensions']} (C {metrics['C']['pool_extensions']}), "
          f"extend dispatches per bucket "
          + ", ".join(f"{b}: {ran[('A', 'extend', b)]}"
                      for b in A.dso.families["extend"])
          + "; extended scores vs a fresh encode, max abs err: "
          + ", ".join(f"{k} {v:.3g}" for k, v in drift.items())
          + f" (within {EXT_TOL_INT8} int8, {EXT_TOL_BF16} bf16)")
    print(f"[chip_smoke] {what}: pool entries the unpacked engines had "
          f"encoded themselves bitwise the packed engines' (then shared): "
          f"{same}")
    print(f"[chip_smoke] {what}: 12 ragged scoring requests at once: packed "
          f"scores within {PACK_TOL} of unpacked (max abs err {worst:.3g}; "
          f"candidates not bitwise of {n_cands}: {moved['A']} at "
          f"{A.dso.policy.rows} packed row, {moved['F']} at 4 (B's shapes: "
          f"bitwise); a candidate's score moved with its batch row in B's "
          f"cached executor function for {row_moved} of {n_rows}, and with "
          f"the call cut to its batch row 0 for {one_row} of "
          f"{buckets[0]}); generation tokens packed == unpacked: "
          f"{token_eq}; the round's cached padded fraction packed "
          f"{pf['A']:.4f} / unpacked {pf['B']:.4f} (slots {slots['A'][0]} / "
          f"{slots['B'][0]} for {slots['A'][1]} candidates); whole-run "
          f"dso_padded_fraction packed {mA['dso_padded_fraction']:.4f} / "
          f"unpacked {metrics['B']['dso_padded_fraction']:.4f}; packed "
          f"rows {mA['dso_packed_rows']}, segments "
          f"{mA['dso_packed_segments']}")
    print(f"[chip_smoke] {what}: launches {launches} (per replay: extend "
          f"{A.dso.executors[('extend', n_history)][0].launches} at bucket "
          f"{n_history}, {A.dso.executors[('extend', n_history // 2)][0].launches}"
          f" at {n_history // 2}; packed cached "
          f"{A.dso.executors[('cached', buckets[0])][0].launches}, packed "
          f"pallas decode "
          f"{engines['D'].dso.executors[('decode', buckets[0])][0].launches})")
    print(f"[chip_smoke] {what}: per dispatch in the engine (captured "
          f"executor until its stream finished), mean / longest: "
          + ", ".join(f"{k} {kind} {metrics[k][f'dso_dispatch_ms_{kind}']:.2f}"
                      f" / {metrics[k][f'dso_dispatch_max_ms_{kind}']:.2f} ms"
                      for k, kind in (("A", "extend"), ("A", "cached"),
                                      ("B", "cached"), ("A", "decode"),
                                      ("B", "decode"), ("D", "decode"),
                                      ("E", "decode"))))
    for k in ("A", "D"):
        check_executors(engines[k], f"{what} engine {k}", cfg.vocab_size)
    for key in [("extend", b) for b in A.dso.families["extend"]] \
            + [("cached", buckets[0]), ("decode", buckets[0])]:
        ms = executor_ms(A, *key, vocab=cfg.vocab_size)
        ex = A.dso.executors[key][0]
        args = family_args(A, *key, cfg.vocab_size, seed=31)
        ts = [torch.from_numpy(a).to(device) if isinstance(a, np.ndarray)
              else a for a in args]
        with torch.inference_mode():
            dev = device_ms(lambda: ex.fn(*ts), per_graph=1, reps=10)
        print(f"[chip_smoke] {what}: dispatch {key} of engine A (batch 4"
              f"{', packed' if key[0] != 'extend' else ''}), alone: captured "
              f"executor {ms:.2f} ms, device (CUDA graph) {dev:.2f} ms")
    del engines, A
    # by the JSON line's kernel names (K4's entry counts its self-slot form)
    return {"fused_score": launches["fused_score"],
            "flash_attention": launches["flash_attention"],
            "fused_ffn": launches["fused_ffn_2d"],
            "flash_decode": launches["flash_decode_with_self"],
            "rwkv6_scan": launches["rwkv6_scan"]}


# ---------------------------------------------------------------------------
# the pool-off ``full`` family and the implicit-shape engine
# ---------------------------------------------------------------------------

def full_implicit_phase(cfg, device, *, n_history: int, buckets,
                        k2_full_ms: dict, seed: int = 0):
    """The JAX engines' defaults and FLAME's baselines at the published
    Climber width, with the scoring phase's weights (the same seed) and
    traffic (``make_traffic``):

    A. ``FlameEngine(history_cache=False)`` (the ``full`` family) under
       fused, then pallas, then chunked: the warm-up round, then the three
       measured rounds at once, the counts set to 0 just before and read
       just after.  Every future resolves with finite [M, T] scores; the
       counters equal the executors' replays times their captured launches:
       24 K2 a replay and no K1 or K4, under pallas 24 K3 too, under
       chunked nothing; replay == eager for every executor; the first 8
       requests served again one at a time, bitwise the concurrent run;
       round A's scores within SCORE_TOL of the port's plain path on the CPU
       (same weights; fused and pallas), chunked's within CHUNKED_TOL of
       fused's.
    B. the "implicit" engine under fused: 9 requests with M in {40, 77,
       130}, three each, at once (the first of each M captures its graph in
       band while the others wait or replay), then again (replays):
       ``jit_compiles`` == 3, the counters equal 24 K2 per replay and per
       capture warm-up, the second round bitwise the first, scores within
       IMPLICIT_TOL of the fused ``full`` engine's on the same requests.

    Prints each ``full`` executor's times (captured alone, one eager call,
    replay; K2's share from its device time at the bucket's shape, from
    ``k2_phase``), the family's in the engine,
    and the implicit engine's first requests (capture in band) apart from
    its replays, with the graphs' memory.  Returns the kernels' launches
    over A and B."""
    import numpy as np
    import torch
    from repro_torch.core import climber as C
    from repro_torch.core import dso as DSO
    from repro_torch.core.pda import RemoteFeatureStore
    from repro_torch.kernels import _build
    from repro_torch.serving import ServeRequest, create_engine

    what = "full + implicit"
    t0 = time.perf_counter()
    params = C.climber_init(
        cfg, torch.Generator(device=device).manual_seed(seed), device)
    bundle = C.build_climber(cfg)
    hist, warm, rounds = make_traffic(n_history, cfg.vocab_size, seed)
    measured = [r for rnd in rounds for r in rnd]
    n_tasks = cfg.climber.num_tasks
    n_layers = cfg.climber.num_blocks * cfg.climber.layers_per_block
    rng = np.random.default_rng(seed + 43)
    implicit = [(i % 4, rng.integers(0, cfg.vocab_size, m).astype(np.int32))
                for i, m in enumerate(IMPLICIT_COUNTS * 3)]

    def engine(name, **kw):
        base = dict(n_history=n_history, device=device,
                    store=RemoteFeatureStore(feature_dim=C.N_SIDE_FEATURES,
                                             seed=seed))
        if name == "flame":
            base.update(history_cache=False, buckets=buckets, max_batch=4)
        return create_engine(name, bundle, params, **base, **kw)

    def serve(eng, reqs, one_at_a_time=False):
        if one_at_a_time:
            return [eng.submit(ServeRequest(history=hist[u], candidates=c))
                    .result(timeout=600) for u, c in reqs]
        futs = [eng.submit(ServeRequest(history=hist[u], candidates=c))
                for u, c in reqs]
        return [f.result(timeout=600) for f in futs]

    def drive(eng, reqs):
        """Serve ``reqs`` at once with the counts set to 0 just before;
        returns (responses, counts, seconds)."""
        _build.add_launches({k: -v for k, v in
                             _build.launch_counts().items()})
        t = time.perf_counter()
        res = serve(eng, reqs)
        return res, _build.launch_counts(), time.perf_counter() - t

    def finite(outs, reqs, tag):
        for (u, c), o in zip(reqs, outs):
            if o.shape != (len(c), n_tasks) or not np.isfinite(o).all():
                fail(f"{what} {tag}: user {u}: output {o.shape} not finite "
                     f"[{len(c)}, {n_tasks}]")

    def calls(executors):
        return {key: sum(ex.calls for ex in exs)
                for key, exs in executors.items()}

    total = {}
    outs = {}
    ref_implicit = None
    print(f"[chip_smoke] {what}: FlameEngine(history_cache=False) buckets "
          f"{tuple(buckets)} under fused, pallas, chunked; the implicit "
          f"engine over M in {IMPLICIT_COUNTS} (set-up "
          f"{time.perf_counter() - t0:.1f}s)")
    for impl in ("fused", "pallas", "chunked"):
        eng = engine("flame", impl=impl)
        try:
            serve(eng, warm)
            before = eng.metrics()
            c0 = calls(eng.dso.executors)
            res, counts, wall = drive(eng, measured)
            c1 = calls(eng.dso.executors)
            metrics = eng.metrics()
            got = [r.output for r in res]
            finite(got, measured, impl)
            want = {name: 0 for name in counts}
            expect = {} if impl == "chunked" else {
                "flash_attention": n_layers}
            if impl == "pallas":
                expect["fused_ffn_2d"] = n_layers
            for key, exs in eng.dso.executors.items():
                per = exs[0].launches
                if per != expect:
                    fail(f"{what} {impl}: executor {key} launches {per} per "
                         f"replay, want {expect}")
                for name, n in per.items():
                    want[name] += (c1[key] - c0[key]) * n
            if counts != want:
                fail(f"{what} {impl}: kernel launches {counts} != the "
                     f"executors' replays x their captured launches {want}")
            dispatches = metrics["dso_dispatches_full"] \
                - before["dso_dispatches_full"]
            if impl != "chunked":
                if counts["flash_attention"] != n_layers * dispatches \
                        or dispatches <= 0:
                    fail(f"{what} {impl}: {counts['flash_attention']} K2 "
                         f"launches for {dispatches} dispatches")
                for name, n in counts.items():
                    total[name] = total.get(name, 0) + n
            lat = [r.latency_s for r in res]
            print(f"[chip_smoke] {what} {impl}: {len(res)} requests resolved "
                  f"in {wall:.3f}s ({len(res) / wall:.2f} requests/s), "
                  f"latency p50 {np.percentile(lat, 50) * 1e3:.1f} ms p99 "
                  f"{np.percentile(lat, 99) * 1e3:.1f} ms; {dispatches} full "
                  f"dispatches, padded fraction "
                  f"{metrics['padded_fraction']:.4f}; launches "
                  f"{ {k: n for k, n in counts.items() if n} } (per replay "
                  f"{expect})")
            # coalesced == sequential, bitwise: rows are independent at
            # the executors' fixed shapes
            with uncounted():
                seq = [r.output for r in serve(eng, measured[:8],
                                               one_at_a_time=True)]
                if impl == "fused":
                    ref_implicit = [r.output for r in serve(eng, implicit)]
            for (u, c), a, b in zip(measured, seq, got):
                if not np.array_equal(a, b):
                    fail(f"{what} {impl}: user {u}: served alone != served "
                         f"concurrently (max diff "
                         f"{np.abs(a - b).max():.3g})")
            check_executors(eng, f"{what} {impl}", cfg.vocab_size)
            print(f"[chip_smoke] {what} {impl}: full dispatches in the "
                  f"engine, mean / longest "
                  f"{metrics['dso_dispatch_ms_full']:.2f} / "
                  f"{metrics['dso_dispatch_max_ms_full']:.2f} ms")
            for b in buckets:
                key = ("full", b)
                ex = eng.dso.executors[key][0]
                args = [torch.from_numpy(a).to(device) for a in family_args(
                    eng, *key, cfg.vocab_size, seed=31)]
                with uncounted():
                    alone = executor_ms(eng, *key, vocab=cfg.vocab_size)
                    with torch.inference_mode():
                        eager = host_ms(lambda: ex.fn(*args))
                        dev = device_ms(lambda: ex.fn(*args), per_graph=1,
                                        reps=10)
                k2 = "" if impl == "chunked" else (
                    f"; K2 {n_layers} x {k2_full_ms[b]:.4f} = "
                    f"{n_layers * k2_full_ms[b]:.2f} ms, "
                    f"{100 * n_layers * k2_full_ms[b] / dev:.0f}% of the "
                    f"replay")
                print(f"[chip_smoke] {what} {impl}: dispatch {key} (batch "
                      f"4), alone: captured executor {alone:.2f} ms, one "
                      f"eager call {eager:.2f} ms, device (CUDA graph) "
                      f"{dev:.2f} ms{k2}")
            outs[impl] = got
        finally:
            eng.shutdown()
        del eng
    if any(total.get(k, 0) for k in ("fused_score", "flash_decode",
                                     "flash_decode_with_self",
                                     "rwkv6_scan")):
        fail(f"{what}: the full family launched {total}: K2 and K3 only")
    worst = max(float(np.abs(a - b).max())
                for a, b in zip(outs["chunked"], outs["fused"]))
    if not worst <= CHUNKED_TOL:
        fail(f"{what}: chunked vs fused scores: max abs err {worst:.3g} > "
             f"{CHUNKED_TOL}")
    print(f"[chip_smoke] {what}: chunked launched no kernel; its scores "
          f"within {CHUNKED_TOL} of fused's (max abs err {worst:.3g})")

    # the implicit-shape engine: the first request of each M captures
    eng = engine("implicit", impl="fused")
    try:
        first, counts, wall1 = drive(eng, implicit)
        second, counts2, wall2 = drive(eng, implicit)
        for name, n in counts2.items():
            counts[name] += n
        metrics = eng.metrics()
        jit = eng.jit
    finally:
        eng.shutdown()
    want = {name: 0 for name in counts}
    for m, ex in jit.executors.items():
        if ex.graph is None or ex.launches != {"flash_attention": n_layers}:
            fail(f"{what}: implicit M {m}: captured {ex.graph is not None}, "
                 f"launches per replay {ex.launches}")
        for name, n in ex.launches.items():
            want[name] += (ex.calls + DSO._WARMUP) * n
    if counts != want or metrics["jit_compiles"] != len(IMPLICIT_COUNTS):
        fail(f"{what}: implicit engine: jit_compiles "
             f"{metrics['jit_compiles']} (want {len(IMPLICIT_COUNTS)}), "
             f"launches {counts} != replays and warm-ups {want}")
    worst = 0.0
    for (u, c), a, b, ref in zip(implicit, first, second, ref_implicit):
        finite([a.output], [(u, c)], "implicit")
        if not np.array_equal(a.output, b.output):
            fail(f"{what}: implicit M {len(c)}: a replay != the first call")
        worst = max(worst, float(np.abs(a.output - ref).max()))
    if not worst <= IMPLICIT_TOL:
        fail(f"{what}: implicit engine vs the full family: max abs err "
             f"{worst:.3g} > {IMPLICIT_TOL}")
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n
    firsts = {}
    for r, (_, c) in zip(first, implicit):
        firsts.setdefault(len(c), r)
    print(f"[chip_smoke] {what}: implicit engine, jit_compiles "
          f"{metrics['jit_compiles']}, {len(implicit)} requests at once "
          f"twice ({wall1:.3f}s, {wall2:.3f}s); first request of each M "
          f"(captured in band), latency / execute: " + ", ".join(
              f"M {m} {r.latency_s * 1e3:.1f} / "
              f"{r.timings['execute_s'] * 1e3:.1f} ms"
              for m, r in sorted(firsts.items()))
          + f"; replays (second round) latency mean "
          f"{np.mean([r.latency_s for r in second]) * 1e3:.1f} ms, execute "
          f"mean {np.mean([r.timings['execute_s'] for r in second]) * 1e3:.1f}"
          f" ms; captures {jit.capture_s:.2f}s, graphs and buffers "
          f"{jit.graph_bytes / 2**20:.1f} MiB reserved for "
          f"{len(jit.executors)} M; scores within {IMPLICIT_TOL} of the "
          f"full family (max abs err {worst:.3g}); launches "
          f"{ {k: n for k, n in counts.items() if n} }")

    # round A's scores vs the port's plain path on the CPU, same weights
    t1 = time.perf_counter()
    ref_params = C.params_to(params, "cpu")
    del params
    store = RemoteFeatureStore(feature_dim=C.N_SIDE_FEATURES, latency_s=0.0,
                               seed=seed)
    worst = {}
    with torch.inference_mode():
        for i, (u, c) in enumerate(rounds[0]):
            side = np.mean(list(store.query([int(x) for x in hist[u]])
                                .values()), axis=0,
                           keepdims=True).astype(np.float32)
            batch = {"history": torch.from_numpy(hist[u][None, :n_history]),
                     "candidates": torch.from_numpy(c[None]),
                     "side": torch.from_numpy(side)}
            for impl in ("fused", "pallas"):
                want = bundle.prefill(ref_params, batch,
                                      impl=impl).float().numpy()[0]
                worst[impl] = max(worst.get(impl, 0.0), float(
                    np.abs(outs[impl][i] - want).max()))
    if not max(worst.values()) <= SCORE_TOL:
        fail(f"{what}: full scores vs the CPU plain path: max abs err "
             f"{worst} > {SCORE_TOL}")
    print(f"[chip_smoke] {what}: round A's full scores match the CPU plain "
          f"path within {SCORE_TOL} (max abs err "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + f"; {time.perf_counter() - t1:.1f}s)")
    return {"flash_attention": total.get("flash_attention", 0),
            "fused_ffn": total.get("fused_ffn_2d", 0),
            "fused_score": 0, "flash_decode": 0, "rwkv6_scan": 0}


# ---------------------------------------------------------------------------
# overload and faults
# ---------------------------------------------------------------------------

class _SwitchedFaults:
    """The ``faults`` object of an overload-phase engine: every hook goes to
    the current :class:`FaultInjector` (``arm``), so one engine serves a
    fault-free round and then its faulted rounds."""

    def __init__(self):
        from repro_torch.serving import FaultInjector
        self.inj = FaultInjector()

    def arm(self, inj):
        self.inj = inj

    def dispatch(self, kind, bucket):
        self.inj.dispatch(kind, bucket)

    def worker_stall(self):
        self.inj.worker_stall()

    def pool_storm(self, pool):
        return self.inj.pool_storm(pool)

    def stats(self):
        return self.inj.stats()


def overload_traffic(n_history: int, vocab: int, seed: int, n_users: int):
    """``n_users`` users (histories n_history + 8 long) with one
    128-candidate slate each, and a second 96-candidate slate for the
    co-batched dedup round."""
    import numpy as np
    rng = np.random.default_rng(seed + 23)
    hist = [rng.integers(0, vocab, n_history + 8).astype(np.int32)
            for _ in range(n_users)]
    first = [rng.integers(0, vocab, 128).astype(np.int32)
             for _ in range(n_users)]
    second = [rng.integers(0, vocab, 96).astype(np.int32)
              for _ in range(n_users)]
    return hist, first, second


def overload_phase(cfg, device, *, n_history: int, buckets, seed: int = 0):
    """Overload handling and fault tolerance through ``create_engine("flame",
    ...)`` at the published Climber width (int8 pool, ``impl="fused"``,
    ``max_batch`` 4, one set of seeded bf16 weights shared by four
    engines); returns the kernels' launch counts over the phase:

    * engine A (fault-free, default dedup, ``generate=GEN_STEPS``): the
      reference scores of every round below; then top-k 4 generation of 4
      users without and with an ``evict:1.0:0.5`` arm (storms at request
      start and between rounds): tokens equal, ``gen_replays`` > 0;
    * engine B (``kv_dedup=False``, ``dispatch_retries`` 20): one
      co-batched round (2 users x 2 requests, 96 candidates) bitwise A's
      deduped round; then ``dispatch:0.3`` transient faults over 8 cold
      requests: scores bitwise A's, ``dispatch_retries`` > 0, the latency
      beside A's; then ``dispatch_fatal:1.0:2``: two requests sent alone
      (each one encode dispatch, its only rider) fail with FaultInjected,
      the four sent after them are answered, and the two again are
      answered bitwise A's;
    * engine C (``pool_slots`` 4, ``pool_spill_bytes`` 16 entries, watchdog
      grace 50 ms): 16 users cycled twice in rounds of 4: >= 12 spill hits
      in the second cycle, every second-cycle score bitwise the same
      user's first-cycle (miss) score, every spilled entry one pinned
      buffer; a promotion timed (CUDA events, median) beside a plain
      pinned copy of the same bytes and beside the per-leaf form, and a
      promoted user's request beside a resident hit's; then ``stall:1:0.3``
      against a 50 ms deadline: ``watchdog_timeouts`` >= 1, the late
      results dropped, the engine serving after;
    * engine D (``max_pending`` 8, ``shed_policy="tiered"``,
      ``DegradationPolicy(5 ms, recover 0.5 ms, dwell 10 ms)``): a burst
      of 64 requests of mixed tiers: every future resolves, each displaced
      (shed) request had a later-admitted request of a better tier, the
      level reaches 3, where a bulk miss gets DegradedError and a bulk hit
      is served; a quiet trickle brings the level back to 0 and clears
      the window override."""
    import gc

    import numpy as np
    import torch
    from repro_torch.core import climber as C
    from repro_torch.core.pda import RemoteFeatureStore
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.fused_score import ops as fs
    from repro_torch.serving import (DegradationPolicy, DegradedError,
                                     FaultInjected, FaultInjector,
                                     ServeRequest, ShedError, TopKConfig,
                                     WatchdogTimeout, create_engine)
    from repro_torch.serving.api import TIER_RANK
    from repro_torch.serving.kv_cache import quantized_nbytes, raw_kv_view
    from repro_torch.tree import leaves, tree_map
    from repro_torch.types import TensorSpec

    t_phase = time.perf_counter()
    params = C.climber_init(
        cfg, torch.Generator(device=device).manual_seed(seed), device)
    bundle = C.build_climber(cfg)
    hist, first, second = overload_traffic(n_history, cfg.vocab_size, seed,
                                           n_users=41)
    base = dict(n_history=n_history, buckets=buckets, max_batch=4,
                pool_dtype="int8", impl="fused", device=device)

    def engine(**kw):
        faults = _SwitchedFaults()
        eng = create_engine(
            "flame", bundle, params, **base, **kw, faults=faults,
            store=RemoteFeatureStore(feature_dim=C.N_SIDE_FEATURES,
                                     seed=seed))
        return eng, faults

    def req(u, cands, **kw):
        return ServeRequest(history=hist[u], candidates=cands, user_id=u,
                            **kw)

    def serve(eng, reqs):
        futs = [eng.submit(r) for r in reqs]
        return [f.result(timeout=600) for f in futs]

    def same(what, got, want):
        for i, (g, w) in enumerate(zip(got, want)):
            if not np.array_equal(g, w):
                fail(f"overload: {what}, request {i}: not bitwise (max diff "
                     f"{np.abs(g - w).max():.3g})")

    kernels = {"fused_score": fs.fused_score,
               "flash_attention": fa.flash_attention}
    for k in kernels.values():
        k.launches = 0
    # users 0-1 the dedup round, 2-9 retries, 10-15 fatal faults, 16-19
    # generation, 20-35 the spill tier; engine D: 0-7 pooled, 8-39 cold,
    # 40 never seen before its level-3 miss
    retry_users, fatal_users = range(2, 10), range(10, 16)
    gen_users = range(16, 20)

    # ---- A: the fault-free references, and generation under storms ----
    t0 = time.perf_counter()
    eng_a, faults_a = engine(generate=GEN_STEPS, window_s=0.01)
    print(f"[chip_smoke] overload: engine A (fault-free, generate "
          f"{GEN_STEPS}) set up in {time.perf_counter() - t0:.1f}s")
    try:
        cobatch = [req(u, second[u]) for u in (0, 1) for _ in range(2)]
        serve(eng_a, [req(u, first[u]) for u in (0, 1)])          # warm
        saved0 = eng_a.metrics()["dso_dedup_rows_saved"]
        dedup_ref = [r.output for r in serve(eng_a, cobatch)]
        dedup_saved = eng_a.metrics()["dso_dedup_rows_saved"] - saved0
        if dedup_saved <= 0:
            fail("overload: engine A's co-batched round deduped no rows")
        t_ref = time.perf_counter()
        retry_ref = serve(eng_a, [req(u, first[u]) for u in retry_users])
        ref_wall = time.perf_counter() - t_ref
        fatal_ref = [r.output for r in serve(
            eng_a, [req(u, first[u]) for u in fatal_users])]
        topk = TopKConfig(k=4, steps=GEN_STEPS)
        gen = [req(u, None, generate=topk) for u in gen_users]
        calm = [r.output for r in serve(eng_a, gen)]
        replays0 = eng_a.metrics().get("gen_replays", 0)
        faults_a.arm(FaultInjector.parse("evict:1.0:0.5", seed=seed))
        stormed = [r.output for r in serve(
            eng_a, [req(u, None, generate=topk) for u in gen_users])]
        m_a = eng_a.metrics()
    finally:
        eng_a.shutdown()
    same("generation under eviction storms vs storm-free", stormed, calm)
    replays = m_a.get("gen_replays", 0) - replays0
    if replays <= 0:
        fail("overload: the eviction storms forced no beam replay")
    print(f"[chip_smoke] overload: generation (top-k 4 x {GEN_STEPS}, 4 "
          f"users) under evict:1.0:0.5 equals the storm-free tokens; "
          f"gen_replays {replays}, fault_pool_evictions "
          f"{m_a['fault_pool_evictions']}, storms "
          f"{m_a['fault_evict_fired']}")
    del eng_a
    gc.collect()

    # ---- B: no dedup, transient retries, fatal faults ----
    t0 = time.perf_counter()
    eng_b, faults_b = engine(kv_dedup=False, dispatch_retries=20,
                             window_s=0.01)
    print(f"[chip_smoke] overload: engine B (kv_dedup=False) set up in "
          f"{time.perf_counter() - t0:.1f}s")
    try:
        serve(eng_b, [req(u, first[u]) for u in (0, 1)])          # warm
        same("kv_dedup=False vs the deduped round",
             [r.output for r in serve(eng_b, cobatch)], dedup_ref)
        if eng_b.metrics()["dso_dedup_rows_saved"]:
            fail("overload: kv_dedup=False still deduped rows")
        print(f"[chip_smoke] overload: kv_dedup=False == default bitwise "
              f"on a co-batched round of 4 (the default deduped "
              f"{dedup_saved} rows)")
        faults_b.arm(FaultInjector(dispatch_p=0.3, seed=seed + 1))
        r0 = eng_b.metrics()["dso_dispatch_retries"]
        t_f = time.perf_counter()
        faulted = serve(eng_b, [req(u, first[u]) for u in retry_users])
        faulted_wall = time.perf_counter() - t_f
        m_b = eng_b.metrics()
        retries = m_b["dso_dispatch_retries"] - r0
        same("retried scores vs fault-free", [r.output for r in faulted],
             [r.output for r in retry_ref])
        if retries <= 0 or m_b["dso_dispatch_failures"]:
            fail(f"overload: {retries} retries, "
                 f"{m_b['dso_dispatch_failures']} failed dispatches")
        lat = [r.latency_s * 1e3 for r in faulted]
        lat0 = [r.latency_s * 1e3 for r in retry_ref]
        print(f"[chip_smoke] overload: dispatch:0.3 over 8 cold requests: "
              f"{retries} retries ({m_b['fault_dispatch_fired']} faults), "
              f"scores bitwise the fault-free engine's; latency mean "
              f"{np.mean(lat):.1f} ms p50 {np.median(lat):.1f} ms (wall "
              f"{faulted_wall * 1e3:.0f} ms) against the fault-free "
              f"{np.mean(lat0):.1f} / {np.median(lat0):.1f} ms (wall "
              f"{ref_wall * 1e3:.0f} ms)")
        faults_b.arm(FaultInjector(dispatch_p=1.0, dispatch_times=2,
                                   dispatch_transient=False))
        f0 = eng_b.metrics()["dso_dispatch_failures"]
        for u in fatal_users[:2]:       # alone: the encode's only rider
            try:
                eng_b.submit(req(u, first[u])).result(timeout=600)
                fail(f"overload: user {u} survived a fatal dispatch fault")
            except FaultInjected as e:
                if e.transient:
                    fail("overload: the fatal arm raised a transient fault")
        rest = serve(eng_b, [req(u, first[u]) for u in fatal_users[2:]])
        again = serve(eng_b, [req(u, first[u]) for u in fatal_users[:2]])
        same("after the fatal faults", [r.output for r in again + rest],
             fatal_ref[:2] + fatal_ref[2:])
        failures = eng_b.metrics()["dso_dispatch_failures"] - f0
        if failures != 2:
            fail(f"overload: {failures} failed dispatches, want 2")
    finally:
        eng_b.shutdown()
    print("[chip_smoke] overload: dispatch_fatal:1.0:2: the two requests "
          "sent alone failed with FaultInjected, the 4 after them were "
          "answered, and the two again answered bitwise the fault-free "
          "engine's")
    del eng_b
    gc.collect()

    # ---- C: the spill tier, then the watchdog ----
    spec = bundle.history_kv_specs(params, n_history, batch=1)
    entry = quantized_nbytes(tree_map(
        lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), spec,
        is_leaf=lambda x: isinstance(x, TensorSpec)), "int8")
    t0 = time.perf_counter()
    eng_c, faults_c = engine(pool_slots=4, pool_spill_bytes=16 * entry,
                             watchdog_grace_s=0.05)
    pool = eng_c.history_pool
    print(f"[chip_smoke] overload: engine C (pool_slots 4, spill tier "
          f"{16 * entry} B = 16 entries of {entry} B) set up in "
          f"{time.perf_counter() - t0:.1f}s")
    spill_users = range(20, 36)
    try:
        cycles = []
        for _ in range(2):
            hits0 = pool.stats()["spill_hits"]
            outs = {}
            for i in range(0, 16, 4):
                rnd = list(spill_users)[i:i + 4]
                for u, r in zip(rnd, serve(eng_c, [req(u, first[u])
                                                   for u in rnd])):
                    outs[u] = r.output
            cycles.append((outs, pool.stats()["spill_hits"] - hits0))
        if pool.stats()["bytes"] != 4 * entry:
            fail(f"overload: 4 resident entries hold {pool.stats()['bytes']}"
                 f" B, want 4 x {entry}")
        same("second-cycle (promoted) vs first-cycle (miss) scores",
             [cycles[1][0][u] for u in spill_users],
             [cycles[0][0][u] for u in spill_users])
        if cycles[1][1] < 12:
            fail(f"overload: {cycles[1][1]} spill hits in the second cycle")
        spilled = list(pool._spill.values())
        if not spilled or not all(e.spill_buf is not None
                                  and e.spill_buf.is_pinned()
                                  for e in spilled):
            fail("overload: a spilled entry is not one pinned buffer")
        print(f"[chip_smoke] overload: 16 users cycled twice over 4 slots: "
              f"second-cycle spill hits {cycles[1][1]}, scores bitwise the "
              f"first cycle's; {len(spilled)} spilled entries, each one "
              f"pinned buffer of {spilled[0].spill_buf.numel()} B "
              f"(payload {entry} B, "
              f"{len(leaves(raw_kv_view(spilled[0].payload)))} tensors)")
        e = spilled[0]
        one = lambda: pool._from_spill(e.spill_buf, e.payload)  # noqa: E731
        dst = torch.empty_like(e.spill_buf, device=device)
        host_leaves = leaves(raw_kv_view(e.payload))
        # the one-buffer promotion against the per-leaf form, in turns
        # (one, leaf, leaf, one) x 4 in this call, and a plain pinned copy
        forms = {"one": one, "leaf": lambda: [t.to(device, non_blocking=True)
                                              for t in host_leaves]}
        turns = {"one": [], "leaf": []}
        for _ in range(4):
            for k in ("one", "leaf", "leaf", "one"):
                turns[k].append(call_ms(forms[k], reps=20))
        promote_ms = float(np.median(turns["one"]))
        per_leaf_ms = float(np.median(turns["leaf"]))
        plain_ms = call_ms(lambda: dst.copy_(e.spill_buf, non_blocking=True),
                           reps=30)
        for g, w in zip(leaves(raw_kv_view(one())), host_leaves):
            if not torch.equal(g.cpu(), w):
                fail("overload: a promoted leaf is not bitwise the stored")
        # a demotion: a resident entry into a fresh pinned buffer (host
        # clock: the copy ends in a wait for it)
        resident_payload = next(iter(pool._entries.values())).payload
        demote_ms = host_ms(lambda: pool._to_spill(resident_payload),
                            reps=20)
        print(f"[chip_smoke] overload: promotion of one entry "
              f"({e.spill_buf.numel()} B) {promote_ms:.4f} ms (one H2D copy "
              f"into one device buffer, CUDA events, median), a plain pinned "
              f"H2D copy of the same bytes {plain_ms:.4f} ms, the per-leaf "
              f"form ({len(host_leaves)} copies) {per_leaf_ms:.4f} ms "
              f"(medians of 8 in turns; one buffer "
              f"{min(turns['one']):.4f}-{max(turns['one']):.4f}, per leaf "
              f"{min(turns['leaf']):.4f}-{max(turns['leaf']):.4f} ms) "
              f"({e.spill_buf.numel() / promote_ms / 1e6:.1f} GB/s); a "
              f"demotion {demote_ms:.4f} ms (host clock, median)")
        # a promoted user's request beside a resident hit's, served alone
        promoted, resident = [], []
        for u in list(spill_users)[:8]:          # all in the spill tier
            promoted.append(serve(eng_c, [req(u, first[u])])[0])
        for _ in range(8):
            resident.append(serve(eng_c, [req(u, first[u])])[0])
        print(f"[chip_smoke] overload: one request served alone, median of "
              f"8: promoted from the spill tier {np.median([r.latency_s for r in promoted]) * 1e3:.2f} ms "
              f"(execute {np.median([r.timings['execute_s'] for r in promoted]) * 1e3:.2f} ms), "
              f"a resident hit {np.median([r.latency_s for r in resident]) * 1e3:.2f} ms "
              f"(execute {np.median([r.timings['execute_s'] for r in resident]) * 1e3:.2f} ms)")
        # the watchdog: every request stalls 0.3 s against a 50 ms deadline
        faults_c.arm(FaultInjector.parse("stall:1:0.3", seed=seed))
        done0 = eng_c.metrics()["requests"]
        late = [eng_c.submit(req(u, first[u], deadline_s=0.05))
                for u in list(spill_users)[-2:]]
        for f in late:
            try:
                f.result(timeout=60)
                fail("overload: a stalled request beat the watchdog")
            except WatchdogTimeout:
                pass
        t_w = time.perf_counter()
        while eng_c.metrics()["requests"] < done0 + 2:
            if time.perf_counter() - t_w > 60:
                fail("overload: the stalled workers never finished")
            time.sleep(0.01)
        for f in late:
            try:
                f.result(timeout=0)
                fail("overload: a late result replaced the watchdog's")
            except WatchdogTimeout:
                pass
        faults_c.arm(FaultInjector())
        u = list(spill_users)[-1]
        after = serve(eng_c, [req(u, first[u])])[0].output
        same("a request after the watchdog", [after], [cycles[0][0][u]])
        m_c = eng_c.metrics()
        if m_c["watchdog_timeouts"] < 1:
            fail("overload: no watchdog timeout")
        print(f"[chip_smoke] overload: stall:1:0.3 against a 50 ms deadline "
              f"+ 50 ms grace: watchdog_timeouts {m_c['watchdog_timeouts']}, "
              f"the late results dropped, the next request served bitwise")
    finally:
        eng_c.shutdown()
    del eng_c, pool, e, spilled
    gc.collect()

    # ---- D: tiered shedding and the degradation ladder ----
    pol = DegradationPolicy(threshold_s=0.005, recover_s=0.0005,
                            dwell_s=0.01)
    t0 = time.perf_counter()
    eng_d, _ = engine(max_pending=8, shed_policy="tiered", degradation=pol,
                      slo_tier_defaults={"interactive": 1.0,
                                         "standard": 4.0, "bulk": 16.0})
    print(f"[chip_smoke] overload: engine D (max_pending 8, tiered "
          f"shedding, DegradationPolicy(5 ms, recover 0.5 ms, dwell 10 ms))"
          f" set up in {time.perf_counter() - t0:.1f}s")
    tiers = ("interactive", "standard", "bulk")
    pooled, cold = range(0, 8), range(8, 40)
    try:
        serve(eng_d, [req(u, first[u]) for u in pooled])          # warm
        rng = np.random.default_rng(seed + 5)
        burst = []
        for i in range(64):
            tier = tiers[int(rng.choice(3, p=(0.2, 0.5, 0.3)))]
            u = int(rng.choice(list(pooled) if rng.random() < 0.5
                               else list(cold)))
            burst.append((u, tier))
        outcome, futs = [], []
        t_b = time.perf_counter()
        for u, tier in burst:
            try:
                futs.append(eng_d.submit(req(u, first[u], slo_tier=tier)))
                outcome.append("admitted")
            except ShedError:
                futs.append(None)
                outcome.append("shed at admission")
        for i, f in enumerate(futs):
            if f is None:
                continue
            try:
                f.result(timeout=120)
                outcome[i] = "served"
            except ShedError:
                outcome[i] = "displaced"
            except DegradedError:
                outcome[i] = "degraded"
        burst_s = time.perf_counter() - t_b
        level_after = pol.level
        m_d = eng_d.metrics()
        counts = {k: outcome.count(k) for k in sorted(set(outcome))}
        for i, (o, (u, tier)) in enumerate(zip(outcome, burst)):
            if o == "displaced" and not any(
                    outcome[j] in ("served", "degraded")
                    and TIER_RANK[burst[j][1]] < TIER_RANK[tier]
                    for j in range(i + 1, len(burst))):
                fail(f"overload: request {i} ({tier}) was displaced with no "
                     f"later-admitted request of a better tier")
            if o == "degraded" and (tier != "bulk" or u in pooled):
                fail(f"overload: request {i} ({tier}, user {u}) got "
                     f"DegradedError")
        if m_d.get("shed_total", 0) <= 0:
            fail("overload: the burst shed nothing")
        if level_after != 3:
            fail(f"overload: the burst left the degradation level at "
                 f"{level_after}, want 3")
        # at level 3: a bulk miss is refused, a bulk hit is served
        lvl3 = [eng_d.submit(req(40, first[40], slo_tier="bulk")),
                eng_d.submit(req(0, first[0], slo_tier="bulk"))]
        try:
            lvl3[0].result(timeout=120)
            fail("overload: a bulk miss was encoded at level 3")
        except DegradedError:
            pass
        lvl3[1].result(timeout=120)
        # a quiet trickle: one request at a time until the level is 0
        trickle = 0
        while pol.level > 0 or eng_d.dso._window_override is not None:
            if trickle >= 200:
                fail(f"overload: level {pol.level} after {trickle} quiet "
                     f"requests")
            u = trickle % 8
            serve(eng_d, [req(u, first[u])])
            trickle += 1
        m_d = eng_d.metrics()
    finally:
        eng_d.shutdown()
    print(f"[chip_smoke] overload: burst of 64 (tiers 0.2 / 0.5 / 0.3, half "
          f"cold users) in {burst_s * 1e3:.0f} ms: {counts}; shed "
          f"{ {t: m_d.get(f'shed_{t}', 0) for t in tiers} }; level 3 after "
          f"the burst ({m_d['degrade_steps']} steps in all), a bulk miss "
          f"refused and a bulk hit served there; level 0 and the window "
          f"override cleared after {trickle} quiet requests; degrade_shed "
          f"{m_d.get('degrade_shed', 0)}")
    del eng_d, params
    gc.collect()
    torch.cuda.empty_cache()
    launches = {n: k.launches for n, k in kernels.items()}
    if min(launches.values()) <= 0:
        fail(f"overload: launches {launches}")
    print(f"[chip_smoke] overload: phase {time.perf_counter() - t_phase:.1f}s"
          f", launches {launches}")
    return launches


def reference_phase(device, seed: int = 0):
    """``impl="reference"`` on the card, on a small Climber (d_model 64, 2 x
    32 heads, 2 blocks x 2 layers; int8 pool, generate 4): its decode route
    masks over the full padded cache (no host read of the lengths), so every
    family captures; each captured executor equals its eager fn bitwise,
    and a generation request's hit equals its miss."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import climber as C
    from repro_torch.core.pda import RemoteFeatureStore
    from repro_torch.serving import ServeRequest, TopKConfig, create_engine
    from repro_torch.types import ClimberConfig

    cfg = dataclasses.replace(
        get_config("climber"), vocab_size=5000, d_model=64, d_ff=128,
        n_heads=2, n_kv_heads=2, head_dim=32,
        climber=ClimberConfig(num_blocks=2, layers_per_block=2))
    params = C.climber_init(
        cfg, torch.Generator(device=device).manual_seed(seed), device)
    eng = create_engine(
        "flame", C.build_climber(cfg), params, n_history=32, buckets=(16, 8),
        max_batch=4, pool_dtype="int8", impl="reference", generate=4,
        gen_vocab=32, device=device,
        store=RemoteFeatureStore(feature_dim=C.N_SIDE_FEATURES, seed=seed))
    rng = np.random.default_rng(seed + 17)
    hist = rng.integers(0, cfg.vocab_size, 40).astype(np.int32)
    try:
        outs = [eng.submit(ServeRequest(
            history=hist, generate=TopKConfig(k=2, steps=4), user_id=0))
            .result(timeout=600).output for _ in range(2)]
    finally:
        eng.shutdown()
    if not np.array_equal(outs[0], outs[1]) or outs[0].shape != (2, 4):
        fail(f"reference: generation on a hit {outs[1].tolist()} != on a "
             f"miss {outs[0].tolist()}")
    check_executors(eng, "reference (small)", cfg.vocab_size)


# ---------------------------------------------------------------------------
# K5 and the text phase (rwkv6-7b)
# ---------------------------------------------------------------------------

def k5_work(b: int, h: int, s: int, d: int, chunk: int = 64,
            sub: int = 16) -> dict:
    """Operations of the chunked wkv function for these shapes, by type,
    at the card's best unit for each: the bound of both K5 kernels (the
    tiled one and the any-head-size variant, which runs its products in
    f32 outside the tensor cores: its cost, not the function's).  Per
    chunk of n steps, with p pairs s < t of which p_diag lie in the
    diagonal sub-chunk blocks: on the tensor cores
    (TF32) the off-diagonal scores (p - p_diag pairs), r_dec S, scores v
    and k_dec^T v, each product counted once ("tf32"); in f32 outside them
    the cumulative sums, the pairwise diagonal blocks, the bonus, the
    factors and their rescaling, and the state's decay; exponentials for
    the diagonal blocks' pairs, the factors Q and K and ten per-channel
    scalars.  "tf32_issued" is what the design issues for the same
    products with its operands as hi + lo (three products each, two where
    they meet v, exact in TF32): its cost, not the function's, so no bound
    reads it.  A column split's recomputed scores are not counted."""
    tf32 = issued = f32 = exps = 0
    for t0 in range(0, s, chunk):
        n = min(chunk, s - t0)
        pairs = n * (n - 1) // 2
        diag = sum(m * (m - 1) // 2
                   for m in (min(sub, n - j) for j in range(0, n, sub)))
        split3 = 2 * (pairs - diag) * d + 2 * n * d * d  # scores, r_dec S
        with_v = 2 * (pairs + n) * d + 2 * n * d * d     # sc v, k_dec^T v
        tf32 += split3 + with_v
        issued += 3 * split3 + 2 * with_v
        f32 += 2 * n * d + 4 * diag * d + 3 * n * d + 7 * n * d + 2 * d * d
        exps += diag * d + 2 * n * d + 10 * d
    return {"tf32": tf32 * b * h, "tf32_issued": issued * b * h,
            "f32": f32 * b * h, "exp": exps * b * h}


def k5_bound(n_bytes: int, work: dict, what: str):
    """The least time for K5's work: the larger of the bytes over the
    memory rate and the operations, each type at its own unit's peak (TF32
    tensor cores, f32 outside them, exponentials at 16 per SM and clock at
    the published 1.98 GHz boost), the units running side by side.  Prints
    every term; returns (ms, "bytes" or "operations")."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    terms = {"bytes": n_bytes / HBM_BYTES_PER_S,
             "tf32": work["tf32"] / TF32_FLOP_PER_S,
             "f32": work["f32"] / F32_FLOP_PER_S,
             "exp": work["exp"] / (sms * EXP_PER_SM_CLOCK * SM_CLOCK_HZ)}
    ops = max(terms["tf32"], terms["f32"], terms["exp"])
    print(f"[chip_smoke] K5 bound at {what}: {n_bytes} B -> "
          f"{terms['bytes'] * 1e3:.4f} ms at 3.35 TB/s; "
          f"{work['tf32'] / 1e9:.3f} GFLOP TF32 -> {terms['tf32'] * 1e3:.4f}"
          f" ms at 495 TFLOP/s (the tiled kernel issues "
          f"{work['tf32_issued'] / 1e9:.3f} as hi + lo, "
          f"{work['tf32_issued'] / TF32_FLOP_PER_S * 1e3:.4f} ms); "
          f"{work['f32'] / 1e9:.3f} GFLOP f32 -> "
          f"{terms['f32'] * 1e3:.4f} ms at 67 TFLOP/s; {work['exp'] / 1e6:.1f}"
          f" M exponentials -> {terms['exp'] * 1e3:.4f} ms at {sms} SMs x "
          f"16 / clock x 1.98 GHz")
    return (max(terms["bytes"], ops) * 1e3,
            "bytes" if terms["bytes"] >= ops else "operations")


def close_lse(got, want, what: str) -> float:
    """K4's log-sum-exp [B, H] (f32) against the plain version's: -inf
    exactly where a row has no valid position, else within F32_TOL."""
    import torch
    empty = torch.isneginf(want)
    if not torch.equal(torch.isneginf(got), empty):
        fail(f"{what}: log-sum-exp -inf at other rows than the plain "
             f"version's")
    return close(got[~empty], want[~empty], what + " log-sum-exp")


def close_scaled(got, want, tol: float, what: str) -> float:
    """Max abs error of ``got`` vs ``want`` relative to ``want``'s scale;
    fails past ``tol`` or on a non-finite output."""
    import torch
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail(f"{what}: non-finite kernel output")
    rel = float((g - w).abs().max() / w.abs().max().clamp_min(1e-6))
    if not rel <= tol:
        fail(f"{what}: max abs err {rel:.3g} of the scale > {tol:g}")
    return rel


def k5_phase(device):
    """rwkv6_scan (K5) at the path's shapes (r / k / v [4, 500, 64, 64]
    bf16, w_log f32 spread over [-20, -1e-4] with runs of -20, u bf16, a
    non-zero f32 s0: 7 full chunks and a 52-step tail) against the plain
    version in o and the final state; an edge sweep (S in {1, 16, 17, 63,
    64, 65, 130}, B = 1, f32 operands, no s0) against the plain version and
    the token-by-token oracle; two half-sequence calls with the state
    carried against one call; each row of the path-shape call bitwise the
    same row called alone (there B x H = 64 is below the SM count and the
    value columns split over blocks); the ``submit`` shape [1, 300, 64, 64]
    against the plain version; the launch plans; the times and bounds at
    both shapes; then its JSON entry (the path shape)."""
    import math
    import torch
    from repro_torch.kernels.rwkv6_scan import ops as scan
    from repro_torch.kernels.rwkv6_scan import ref as scan_ref

    g = torch.Generator(device=device).manual_seed(6)

    def operands(b, s, h, d, dtype, state=True):
        r, k, v = (torch.randn(b, s, h, d, generator=g, device=device)
                   .to(dtype) for _ in range(3))
        mag = torch.empty(b, s, h, d, device=device).uniform_(
            math.log(1e-4), math.log(20.0), generator=g).exp()
        wl = -mag
        for lo, hi in ((5, 40), (200, 265), (430, 470)):   # runs of -20
            wl[:, lo:hi] = -20.0
        u = (0.5 * torch.randn(h, d, generator=g, device=device)).to(dtype)
        s0 = torch.randn(b, h, d, d, generator=g, device=device) \
            if state else None
        return r, k, v, wl, u, s0

    def tol(dtype):
        return K5_F32_TOL if dtype == torch.float32 else K5_BF16_TOL

    def case(ops, what):
        o, sf = scan.rwkv6_scan(*ops)
        torch.cuda.synchronize()
        po, psf = scan.rwkv6_scan_plain(*ops)
        err = close_scaled(o, po, tol(o.dtype), f"rwkv6_scan o {what}")
        close_scaled(sf, psf, K5_F32_TOL, f"rwkv6_scan state {what}")
        return err, o, sf

    n_cases = 0
    for s in (1, 16, 17, 63, 64, 65, 130):
        ops = operands(1, s, 64, 64, torch.float32, state=False)
        _, o, sf = case(ops, f"edge S={s}")
        bh = [t.transpose(1, 2).reshape(64, s, 64) for t in ops[:4]]
        oo, osf = scan_ref.reference(*bh, ops[4].float())
        oo = oo.reshape(1, 64, s, 64).transpose(1, 2)
        for got, want, nm in ((o, oo, "o"), (sf[0], osf, "state")):
            close_scaled(got, want, K5_ORACLE_TOL, f"rwkv6_scan edge S={s} "
                         f"{nm} vs the token-by-token oracle")
        n_cases += 1
    main = operands(4, 500, 64, 64, torch.bfloat16)
    main_err, o, sf = case(main, "path shape [4, 500, 64, 64] bf16")
    r, k, v, wl, u, s0 = main
    o1, st = scan.rwkv6_scan(r[:, :250], k[:, :250], v[:, :250],
                             wl[:, :250], u, s0)
    o2, s2 = scan.rwkv6_scan(r[:, 250:], k[:, 250:], v[:, 250:],
                             wl[:, 250:], u, st)
    torch.cuda.synchronize()
    close_scaled(torch.cat([o1, o2], 1), o, K5_BF16_TOL,
                 "rwkv6_scan two halves (state carried) vs one call, o")
    close_scaled(s2, sf, K5_F32_TOL,
                 "rwkv6_scan two halves (state carried) vs one call, state")
    for i in range(r.shape[0]):
        oi, sfi = scan.rwkv6_scan(*(t[i:i + 1] for t in (r, k, v, wl)), u,
                                  s0[i:i + 1])
        if not (torch.equal(oi, o[i:i + 1]) and torch.equal(sfi, sf[i:i + 1])):
            fail(f"rwkv6_scan: row {i} called alone differs from the same "
                 f"row of the [4, 500] call (o max diff "
                 f"{(oi.float() - o[i:i + 1].float()).abs().max().item():.3g}"
                 f", state {(sfi - sf[i:i + 1]).abs().max().item():.3g})")
    sub = operands(1, 300, 64, 64, torch.bfloat16)
    sub_err, _, _ = case(sub, "submit shape [1, 300, 64, 64] bf16")
    print(f"[chip_smoke] K5 rwkv6_scan: {n_cases + 3} cases within "
          f"tolerance (edge sweep also vs the token-by-token oracle; state "
          f"carried over two halves == one call); path shape max abs err "
          f"{main_err:.3g} of the scale, submit shape {sub_err:.3g}; each "
          f"of the 4 rows called alone bitwise its row of the batch")
    for what, t in (("[4, 500, 64, 64] bf16", r), ("[1, 300, 64, 64] bf16",
                                                   sub[0])):
        p = scan.plan(t)
        print(f"[chip_smoke] K5 plan at {what}: grid {p['grid']} x "
              f"{p['threads']} threads, {p['smem_bytes']} B dynamic shared "
              f"memory, column split {p['col_split']}, "
              f"{p['blocks_per_sm']} blocks per SM")
    ms, plain_ms, library_ms = timings(
        "K5 rwkv6_scan [4, 500, 64, 64]", lambda: scan.rwkv6_scan(*main),
        lambda: scan.rwkv6_scan_plain(*main), None)
    timings("K5 rwkv6_scan [1, 300, 64, 64]", lambda: scan.rwkv6_scan(*sub),
            lambda: scan.rwkv6_scan_plain(*sub), None)
    b, s, h, d = sub[0].shape
    k5_bound(nbytes(*sub, torch.empty_like(sub[0]),
                    torch.empty(b, h, d, d, device=device)),
             k5_work(b, h, s, d), "[1, 300, 64, 64]")
    b, s, h, d = r.shape
    bound_ms, bound_by = k5_bound(nbytes(r, k, v, wl, u, s0, o, sf),
                                  k5_work(b, h, s, d), "[4, 500, 64, 64]")
    return dict(name="rwkv6_scan", route="cuda",
                source="src/repro_torch/csrc/rwkv6_scan.cu",
                replaces=REPLACES["rwkv6_scan"], max_abs_err=main_err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def text_step_times(eng, bundle, params, prompts, device, card: str,
                    k5_ms: float, n_layers: int, outs):
    """The batched generate split in two, each called alone at batch 4: the
    prefill of the 4 prompts (one eager call, and replayed from a CUDA
    graph: the device alone), and one decode step (one eager call, the
    engine's captured step on one thread, and that graph's replay on the
    device alone), with K5's share of the prefill's device time
    (``n_layers`` launches at the K5 phase's device time ``k5_ms``).  Also
    checks that the engine's captured decode gave the greedy tokens
    ``outs`` of an eager decode loop from the same prefill."""
    import numpy as np
    import torch
    tok = torch.as_tensor(np.stack(prompts), dtype=torch.int64,
                          device=device)
    step = {"tokens": tok[:, :1], "cur_index": tok.shape[1]}
    with torch.inference_mode():
        caches = bundle.cache_init(len(prompts), 1024, device=device)
        logits, filled = bundle.prefill(params, {"tokens": tok},
                                        caches=caches)
        # the eager decode loop from the same prefill: the engine's
        # captured step must give its tokens
        last = torch.argmax(logits[:, -1], dim=-1)
        want, cur = [last], filled
        for i in range(TEXT_TOKENS - 1):
            lg, cur = bundle.decode_step(params, cur, {
                "tokens": last[:, None], "cur_index": tok.shape[1] + i})
            last = torch.argmax(lg[:, -1], dim=-1)
            want.append(last)
        want = torch.stack(want, 1).cpu().numpy()
        if not np.array_equal(np.stack(outs), want):
            fail(f"text: the engine's captured decode tokens {outs} != the "
                 f"eager decode loop's {want.tolist()}")
        pre = host_ms(lambda: bundle.prefill(params, {"tokens": tok},
                                             caches=caches), reps=3, warm=1)
        dec = host_ms(lambda: bundle.decode_step(params, filled, step),
                      reps=5, warm=1)
        g = eng._graphs[len(prompts)]
        g.load(filled, tok[:, 0], tok.shape[1])
        captured = host_ms(g.graph.replay, reps=10)
        # inside inference mode: a decode step writes its caches in place
        pre_dev = device_ms(lambda: bundle.prefill(params, {"tokens": tok},
                                                   caches=caches),
                            per_graph=1, reps=5)
        dec_dev = device_ms(lambda: bundle.decode_step(params, filled, step),
                            per_graph=1, reps=5)
    replay_dev = call_ms(g.graph.replay, reps=20, warm=3)
    k5 = n_layers * k5_ms
    print(f"[chip_smoke] text: captured decode == eager decode loop, "
          f"{len(prompts)} x {TEXT_TOKENS} greedy tokens")
    print(f"[chip_smoke] text: alone at batch 4: prefill of {tok.shape[1]} "
          f"tokens {pre:.1f} ms (one eager call), {pre_dev:.2f} ms (device, "
          f"CUDA graph), K5 {n_layers} x {k5_ms:.4f} = {k5:.2f} ms of it "
          f"({100 * k5 / pre_dev:.1f}% of the device time, "
          f"{100 * k5 / pre:.1f}% of the eager call); decode step "
          f"{dec:.2f} ms (one eager call), {captured:.2f} ms (the engine's "
          f"captured step, host clock), {replay_dev:.2f} ms (its replay, "
          f"CUDA events), {dec_dev:.2f} ms (device, CUDA graph of the "
          f"eager step); {card}")


def text_greedy_check(bundle, params, prompt, device, card: str):
    """Greedy == repeated prefill: for one prompt, the engine's loop (one
    prefill, then recurrent decode steps) against a loop that re-prefills
    the growing sequence (K5's chunked scan) at every step, both on one row.
    A step whose reference top-2 logit gap is under TIE_GAP is reported,
    not gated, and ends the comparison (the sequences part there)."""
    import torch
    steps = 4
    with torch.inference_mode():
        caches = bundle.cache_init(1, 1024, device=device)
        tok = torch.as_tensor(prompt[None], dtype=torch.int64, device=device)
        logits, caches = bundle.prefill(params, {"tokens": tok},
                                        caches=caches)
        got = [int(logits[0, -1].argmax())]
        for i in range(steps - 1):
            logits, caches = bundle.decode_step(params, caches, {
                "tokens": torch.tensor([[got[-1]]], device=device),
                "cur_index": len(prompt) + i})
            got.append(int(logits[0, -1].argmax()))
        seq = [int(t) for t in prompt]
        gated = 0
        for i in range(steps):
            ref = bundle.prefill(params, {"tokens": torch.tensor(
                [seq], device=device)})[0, -1].float()
            top2 = torch.topk(ref, 2).values
            gap = float(top2[0] - top2[1])
            want = int(ref.argmax())
            if gap < TIE_GAP:
                print(f"[chip_smoke] text: greedy step {i}: reference top-2 "
                      f"gap {gap:.3g} < {TIE_GAP}: near tie, reported not "
                      f"gated (engine {got[i]}, repeated prefill {want})")
                if want != got[i]:
                    print("[chip_smoke] text: the sequences part at this "
                          "near tie; the comparison ends here")
                    break
                seq.append(want)
                continue
            if want != got[i]:
                fail(f"text: greedy step {i}: decode loop token {got[i]} != "
                     f"repeated prefill {want} (top-2 gap {gap:.3g})")
            gated += 1
            seq.append(want)
    print(f"[chip_smoke] text: greedy == repeated prefill on "
          f"{gated}/{steps} steps gated ({len(prompt)}-token prompt); "
          f"{card}")
    return got


def text_cut_check(cfg, params, prompt, device, card: str):
    """A 2-layer cut of the full-width model (the first 2 layers' weights
    copied to the CPU): logits on the card (K5) against the port's plain
    path on the CPU for one prompt, with the bf16 weights and upcast to
    f32."""
    import dataclasses
    import torch
    from repro_torch.models.model import build_model
    from repro_torch.tree import params_to, tree_map

    t0 = time.perf_counter()
    bundle2 = build_model(dataclasses.replace(cfg, n_layers=2))
    cut = {"embed": params["embed"],
           "stack": {"layers": tree_map(lambda a: a[:2],
                                        params["stack"]["layers"]),
                     "final_norm": params["stack"]["final_norm"]}}
    tok = torch.as_tensor(prompt[None], dtype=torch.int64)
    res = {}
    for name, cast in (("bf16", lambda t: t), ("f32", lambda t: t.float())):
        on_card = tree_map(cast, cut)
        with torch.inference_mode():
            got = bundle2.prefill(on_card, {"tokens": tok.to(device)})
            got = got.float().cpu()
            del on_card
            want = bundle2.prefill(tree_map(cast, params_to(cut, "cpu")),
                                   {"tokens": tok}).float()
        err = (got - want).abs()
        scale = want.abs()
        res[name] = (float(err.max() / scale.max()),
                     float(err.mean() / scale.mean()),
                     int(err.amax(-1)[0].argmax()),
                     float((got.argmax(-1) == want.argmax(-1)).float().mean()))
    f32_max, _, f32_pos, _ = res["f32"]
    bf_max, bf_mean, bf_pos, bf_agree = res["bf16"]
    if not f32_max <= TEXT_F32_TOL:
        fail(f"text: 2-layer cut in f32, card vs the CPU plain path: max abs "
             f"err {f32_max:.3g} of the logits' scale > {TEXT_F32_TOL} "
             f"(position {f32_pos})")
    if not bf_mean <= TEXT_BF16_MEAN_TOL:
        fail(f"text: 2-layer cut in bf16, card vs the CPU plain path: mean "
             f"abs err {bf_mean:.3g} of the mean |logit| > "
             f"{TEXT_BF16_MEAN_TOL}")
    print(f"[chip_smoke] text: 2-layer cut at full width, {len(prompt)} "
          f"tokens, logits on the card vs the CPU plain path: f32 max abs "
          f"err {f32_max:.3g} of the scale (<= {TEXT_F32_TOL}; position "
          f"{f32_pos}); bf16 mean {bf_mean:.3g} (<= {TEXT_BF16_MEAN_TOL}), "
          f"max {bf_max:.3g} at position {bf_pos}, argmax agrees on "
          f"{bf_agree:.3f} of positions ({time.perf_counter() - t0:.1f}s)")


def text_phase(device, card: str, k5_ms: float, seed: int = 0):
    """Drive the text engine serving rwkv6-7b at full width (32 layers,
    d_model 4096, 64 x 64 heads, d_ff 14336, vocab 65536, bf16 weights from
    a seeded generator on the card): 4 equal-length prompts of TEXT_PROMPT
    tokens through ``generate``, then single prompts of 130 and 300 tokens
    through ``submit``, TEXT_TOKENS tokens each.  Checks the outputs, 32 K5
    launches per prefill call and none in decode, greedy == repeated
    prefill, and a 2-layer cut against the CPU plain path; times the
    prefill and a decode step alone (K5's share from the K5 phase's device
    time ``k5_ms``).  Returns the kernels' launch counts over the driven
    requests."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.fused_ffn import ops as ff
    from repro_torch.kernels.fused_score import ops as fs
    from repro_torch.kernels.rwkv6_scan import ops as scan
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeRequest, create_engine
    from repro_torch.tree import leaves

    cfg = get_config("rwkv6-7b")
    t0 = time.perf_counter()
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator(device=device).manual_seed(seed),
                         device)
    eng = create_engine("text", bundle, params, batch=4, max_len=1024,
                        device=device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    m = eng.metrics()
    print(f"[chip_smoke] text: rwkv6-7b, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.d_model // cfg.rwkv_head_size} x "
          f"{cfg.rwkv_head_size} heads, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {n_params / 1e9:.3f} B parameters bf16 "
          f"(set-up {time.perf_counter() - t0:.1f}s; decode step captured "
          f"for {sorted(eng._graphs)} rows in "
          f"{m['text_graph_capture_s']:.2f}s, which left "
          f"{m['text_graph_bytes'] / 2**20:.1f} MiB reserved)")
    rng = np.random.default_rng(seed + 13)
    prompts = [rng.integers(0, cfg.vocab_size, TEXT_PROMPT).astype(np.int32)
               for _ in range(4)]
    singles = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (130, 300)]
    kernels = {"fused_score": fs.fused_score,
               "flash_attention": fa.flash_attention,
               "fused_ffn": ff.fused_ffn_2d,
               "flash_decode": fd.flash_decode_with_self,
               "flash_decode single-token": fd.flash_decode,
               "rwkv6_scan": scan.rwkv6_scan}
    try:
        for kf in kernels.values():
            kf.launches = 0
        t1 = time.perf_counter()
        outs = eng.generate(prompts, n_tokens=TEXT_TOKENS)
        wall = time.perf_counter() - t1
        after_generate = scan.rwkv6_scan.launches
        futs = [eng.submit(ServeRequest(history=p, n_tokens=TEXT_TOKENS))
                for p in singles]
        res = [f.result(timeout=600) for f in futs]
        launches = {n: kf.launches for n, kf in kernels.items()}
    finally:
        eng.shutdown()
    print(f"[chip_smoke] text: generate, 4 x {TEXT_PROMPT}-token prompts, "
          f"{TEXT_TOKENS} tokens each: {wall * 1e3:.1f} ms "
          f"({4 * TEXT_TOKENS / wall:.1f} generated tokens/s); {card}")
    for p, r in zip(singles, res):
        t = r.timings
        print(f"[chip_smoke] text: submit, {len(p)}-token prompt: prefill "
              f"{t['prefill_s'] * 1e3:.1f} ms, decode "
              f"{t['decode_s'] * 1e3 / (TEXT_TOKENS - 1):.2f} ms per token, "
              f"latency {r.latency_s * 1e3:.1f} ms; {card}")
    for o in outs + [r.output for r in res]:
        if o.shape != (TEXT_TOKENS,) or o.min() < 0 \
                or o.max() >= cfg.vocab_size:
            fail(f"text: output {o.shape} [{o.min()}, {o.max()}] is not "
                 f"{TEXT_TOKENS} token ids")
    n_prefill = 1 + len(singles)
    if after_generate != cfg.n_layers \
            or launches["rwkv6_scan"] != cfg.n_layers * n_prefill:
        fail(f"text: K5 launched {after_generate} times in generate and "
             f"{launches['rwkv6_scan']} in all, want {cfg.n_layers} per "
             f"prefill call ({n_prefill} calls) and none in decode")
    if any(n for name, n in launches.items() if name != "rwkv6_scan"):
        fail(f"text: another kernel launched on the text path: {launches}")
    print(f"[chip_smoke] text: launches {launches} ({cfg.n_layers} K5 per "
          f"prefill call, {n_prefill} prefill calls, none in decode)")
    text_step_times(eng, bundle, params, prompts, device, card, k5_ms,
                    cfg.n_layers, outs)
    got = text_greedy_check(bundle, params, singles[0], device, card)
    if got != res[0].output[:len(got)].tolist():
        fail(f"text: the engine's first tokens {res[0].output[:4]} != the "
             f"same loop called directly {got}")
    text_cut_check(cfg, params, singles[0], device, card)
    return launches


# ---------------------------------------------------------------------------
# the attention text kinds: kernels at their shapes, gemma3-12b and
# h2o-danube-3-4b at full width
# ---------------------------------------------------------------------------

def _visible_pairs(s: int, mode: str, window: int) -> int:
    """(query, key) pairs a causal or sliding mask keeps over s positions."""
    if mode == "sliding" and window < s:
        return window * (window + 1) // 2 + (s - window) * window
    return s * (s + 1) // 2


def text_shape_row(label: str, kernel, plain, library, bnd, card: str,
                   check=close, quick: bool = False) -> dict:
    """Check ``kernel()`` against ``plain()`` on the card, then time the
    kernel, the plain version and the library call (device: 20 calls
    replayed from one CUDA graph, median of 20 replays; eager: one call,
    median of 20; ``quick``, for the largest shapes: 2 calls a graph,
    median of 5, and 5 eager calls) beside the bound ``bnd`` = (ms, "bytes"
    or "operations"); prints one line and returns its numbers."""
    import torch
    dev_kw = dict(per_graph=2, reps=5) if quick else {}
    eager_kw = dict(reps=5, warm=1) if quick else dict(reps=20)
    with uncounted():
        got = kernel()
        torch.cuda.synchronize()
        err = check(got, plain(), label)
        del got
        dev = [device_ms(f, **dev_kw) for f in (kernel, plain, library)
               if f is not None]
        eager = [call_ms(f, **eager_kw) for f in (kernel, plain, library)
                 if f is not None]
    b_ms, by = bnd
    lib = (f"{dev[2]:.4f} / {eager[2]:.4f}" if library is not None
           else "none")
    print(f"[chip_smoke] text shapes: {label}: max abs err {err:.3g}; ms "
          f"device / eager: kernel {dev[0]:.4f} / {eager[0]:.4f}, plain "
          f"{dev[1]:.4f} / {eager[1]:.4f}, library {lib}; bound "
          f"{b_ms:.4f} ms ({by}; {b_ms / dev[0]:.0%} of it reached); {card}")
    return dict(label=label, ms=dev[0], eager_ms=eager[0], plain_ms=dev[1],
                library_ms=dev[2] if library is not None else None,
                bound_ms=b_ms, bound_by=by, max_abs_err=err)


def text_kernel_shapes(device, card: str) -> list:
    """K2, K3, K4 (single-token form) and K5 at the attention text kinds'
    shapes, each against its plain version and timed beside its bound and
    its library call: K2 at gemma3-12b's prefill q [4, 500, 16, 240]
    (``sliding`` window 1024 and ``causal``; head dim 240 padded to 256),
    at h2o-danube-3-4b's [4, 500, 32, 120] (``sliding`` 4096; 120 padded
    to 128) and at gemma3's [4, 1100, 16, 240] with window 1024 (block
    skipping), SDPA with the mask beside; K3 at d 3840 (the wide form) for
    T in {2000, 1100, WIDE_DECODE_T + 1, WIDE_DECODE_T, 4, 1} (both paths),
    gelu d_ff 15360 and swiglu d_ff 10240, the matmul chain beside, its
    launch plan checked against the wrapper's workspace and launches, and
    the prefill path's rows bitwise across T; K4's single-token form at q [4, 16, 240] over 528 keys,
    SDPA with a length mask beside; K5 at a padded head size, 48."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.fused_ffn import ops as ff
    from repro_torch.kernels.padding import padded_dim
    from repro_torch.kernels.rwkv6_scan import ops as scan

    g = torch.Generator(device=device).manual_seed(21)

    def rn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (scale * torch.randn(*shape, generator=g, device=device)
                ).to(dtype)

    rows = []
    for b, s, h, hkv, d, mode, window in (
            (4, 500, 16, 8, 240, "sliding", 1024),
            (4, 500, 16, 8, 240, "causal", 0),
            (4, 500, 32, 8, 120, "sliding", 4096),
            (4, 1100, 16, 8, 240, "sliding", 1024)):
        q, k, v = rn(b, s, h, d), rn(b, s, hkv, d), rn(b, s, hkv, d)
        pos = torch.arange(s, device=device)
        mask = pos[None, :] <= pos[:, None]
        if mode == "sliding":
            mask &= pos[:, None] - pos[None, :] < window
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        rows.append(text_shape_row(
            f"K2 {mode}{f' window {window}' if window else ''} q "
            f"{list(q.shape)} k/v {list(k.shape)} (head dim {d} padded to "
            f"{padded_dim(d, fa.HEAD_DIMS)}; grid {fa.plan(q)['grid']})",
            lambda: fa.flash_attention(q, k, v, mode, window=window),
            lambda: fa.flash_attention_plain(q, k, v, mode, window=window),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True),
            bound(nbytes(q, k, v, q),
                  4 * b * h * d * _visible_pairs(s, mode, window)), card))
    d = 3840
    t_dec = ff.WIDE_DECODE_T
    for act, f in (("gelu", 15360), ("swiglu", 10240)):
        wu, wd = rn(d, f, scale=d ** -0.5), rn(f, d, scale=f ** -0.5)
        wg = rn(d, f, scale=d ** -0.5) if act == "swiglu" else None

        def chain(x, wu=wu, wd=wd, wg=wg, act=act):
            if act == "swiglu":
                return (F.silu(x @ wg) * (x @ wu)) @ wd
            return F.gelu(x @ wu, approximate="tanh") @ wd
        for t in (2000, 1100, t_dec + 1, t_dec, 4, 1):
            x = rn(t, d)
            p = ff.plan(x, wu, activation=act)
            ws = ff.wide_workspace_bytes(t, d, f)
            k3 = ff.kernel_launches(t, d, f=f, dtype=x.dtype)
            if p["workspace_bytes"] != ws or p["kernels"] != k3:
                fail(f"K3 {act} T={t}: the library's plan {p} disagrees "
                     f"with the wrapper's workspace ({ws} B) or kernels a "
                     f"launch ({k3})")
            rows.append(text_shape_row(
                f"K3 {act} x [{t}, {d}] d_ff {f} (wide form, {p['path']} "
                f"path: grids {p['grid']}, tiles {p['tiles']} of "
                f"{' and '.join(f'{r} x {c}' for r, c in p['tile'] if r)}, "
                f"{p['threads']} threads, "
                f"{p['stages']} ring stages, {p['smem_bytes']} B shared, "
                f"workspace {ws / 1e6:.1f} MB, {p['launches']} kernels a "
                f"call)",
                lambda x=x: ff.fused_ffn_2d(x, wu, wd, wg, activation=act),
                lambda x=x: ff.fused_ffn_plain(x, wu, wd, wg,
                                               activation=act),
                lambda x=x: chain(x),
                bound(nbytes(x, wu, wd, wg, x),
                      2 * t * d * f * (3 if act == "swiglu" else 2)), card))
        # the prefill path has no d_ff slices: a row's output does not
        # depend on T (rows of a T 300 call == rows 0-299 of a T 2100 one)
        x = rn(2100, d)
        with uncounted():
            big = ff.fused_ffn_2d(x, wu, wd, wg, activation=act)
            small = ff.fused_ffn_2d(x[:300].contiguous(), wu, wd, wg,
                                    activation=act)
            again = ff.fused_ffn_2d(x, wu, wd, wg, activation=act)
        if not torch.equal(small, big[:300]) or not torch.equal(again, big):
            fail(f"K3 {act} d_ff {f}: the prefill path's rows of a T 300 "
                 f"call differ from a T 2100 call's, or two calls differ")
        print(f"[chip_smoke] text shapes: K3 {act} d_ff {f}: rows of a T 300 "
              f"call bitwise rows 0-299 of a T 2100 call; two calls bitwise")
        del wu, wd, wg, x, big, small, again
    b, h, hkv, d, s = 4, 16, 8, 240, 528
    q, kc, vc = rn(b, h, d), rn(b, s, hkv, d), rn(b, s, hkv, d)
    lens = torch.tensor([528, 517, 300, 130], dtype=torch.int32,
                        device=device)
    lmask = (torch.arange(s, device=device)[None, :]
             < lens[:, None].long())[:, None, None, :]
    qq = q[:, :, None]
    kk, vv = kc.transpose(1, 2), vc.transpose(1, 2)
    valid = int(lens.long().sum())
    p = fd.plan(q, kc, self_slot=False)
    rows.append(text_shape_row(
        f"K4 single-token q {list(q.shape)} over caches {list(kc.shape)} "
        f"(lengths {lens.tolist()}; head dim 240 padded to 256; grid "
        f"{p['grid']}, {p['smem_bytes']} B shared)",
        lambda: fd.flash_decode(q, kc, vc, lens),
        lambda: fd.flash_decode_plain(q, kc, vc, lens),
        lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=lmask,
                                               enable_gqa=True),
        bound(2 * valid * hkv * d * kc.element_size() + nbytes(q, lens, q),
              4 * h * d * valid), card))
    b, s, h, d = 4, 500, 8, 48
    r, k, v = (rn(b, s, h, d, scale=0.5) for _ in range(3))
    wl = -torch.exp(torch.randn(b, s, h, d, generator=g, device=device))
    u = rn(h, d, scale=0.5, dtype=torch.float32)
    s0 = 0.1 * torch.randn(b, h, d, d, generator=g, device=device)
    label = f"K5 rwkv6_scan [{b}, {s}, {h}, {d}] (head size 48 padded to 64)"
    bnd = k5_bound(nbytes(r, k, v, wl, u, s0, r, s0), k5_work(b, h, s, d),
                   label)
    rows.append(text_shape_row(
        label, lambda: scan.rwkv6_scan(r, k, v, wl, u, s0)[0],
        lambda: scan.rwkv6_scan_plain(r, k, v, wl, u, s0)[0], None, bnd,
        card, check=lambda got, want, what: close_scaled(
            got, want, K5_BF16_TOL, what)))
    return rows


# ---------------------------------------------------------------------------
# K1's any-dims variant (score_any.cu) and the B * H grid limit
# ---------------------------------------------------------------------------

#: head dims K1's any-dims variant is held to its twin at: ragged head-dim
#: columns (160, 192, 320), one slot pass (256) and several V slices (512)
K1_ANY_DIMS = (160, 192, 256, 320, 512)


def k1_operands(rnd, b, m, u, s, h, hkv, d, *, qdt, hist):
    """One K1 call's operands: q and the candidates in ``qdt``; the history
    drawn in f32 and stored as the pool stores it (int8 codes with
    per-(row, kv head) absmax scales, folded with the /127 as the wrapper
    takes them, or bf16 / f32 values).  Returns (q, k_hist, v_hist, k_cand,
    v_cand, k_scale, v_scale)."""
    import torch
    from repro_torch.kernels.fused_score import ops as fs
    from repro_torch.serving.kv_cache import _int8
    q, kc, vc = (rnd(b, m, n, d, dtype=qdt) for n in (h, hkv, hkv))
    kf, vf = (rnd(u, s, hkv, d, dtype=torch.float32) for _ in range(2))
    if hist != "int8":
        return q, kf.to(hist), vf.to(hist), kc, vc, None, None
    (kh, ks), (vh, vs) = _int8(kf[:, None]), _int8(vf[:, None])
    return (q, kh[:, 0], vh[:, 0], kc, vc, fs._norm_scale(ks[:, 0], u, hkv),
            fs._norm_scale(vs[:, 0], u, hkv))


def k1_any_checks(device, rnd) -> str:
    """K1's any-dims variant against its twin (``fused_score_any_plain``)
    at every head dim of K1_ANY_DIMS, in both modes, for bf16 and f32 q
    over int8, bf16 and f32 history, with the dedup index and lengths (a
    0 among them) and without either; a packed index at alignments 1, 8
    and 16 (with and without lengths), each live slot bitwise the unpacked
    call of its pool row; the bitwise rules (rows of M = 5 == those of M
    = 128 / 129, lengths == S == none, padded past lengths == tight, two
    calls) at D 192, 256 and 512 for every q and history dtype.  Returns
    a summary; any failure fails the run."""
    import torch
    from repro_torch.kernels.fused_score import ops as fs
    from repro_torch.serving.kv_cache import _int8
    hists = ("int8", torch.bfloat16, torch.float32)
    qdts = (torch.bfloat16, torch.float32)
    n_twin = n_packed = n_bitwise = 0
    with uncounted():
        for d in K1_ANY_DIMS:
            if fs.route(d) != "any":
                fail(f"K1 at head dim {d} did not pick the any-dims variant")
            for qdt in qdts:
                for hist in hists:
                    for mode in ("cached", "extend"):
                        for dedup in (True, False):
                            b, m, u, s, h, hkv = ((3, 37, 2, 70, 4, 2)
                                                  if dedup else
                                                  (3, 17, 3, 130, 4, 4))
                            q, kh, vh, kc, vc, ks, vs = k1_operands(
                                rnd, b, m, u, s, h, hkv, d, qdt=qdt,
                                hist=hist)
                            kw = dict(mode=mode, k_scale=ks, v_scale=vs)
                            if dedup:
                                kw.update(row_index=(torch.arange(
                                    b, device=device) % u).to(torch.int32),
                                    lengths=torch.tensor(
                                        [0, s - 5], dtype=torch.int32,
                                        device=device))
                            out = fs.fused_score(q, kh, vh, kc, vc, **kw)
                            torch.cuda.synchronize()
                            close(out, fs.fused_score_any_plain(
                                q, kh, vh, kc, vc, **kw),
                                f"K1 any-dims {mode} D {d} q={qdt} "
                                f"hist={hist} dedup+lengths={dedup} "
                                f"{(b, m, u, s, h, hkv)}")
                            n_twin += 1
            for qdt, hist in ((torch.bfloat16, "int8"),
                              (torch.float32, torch.float32)):
                b, m, u, s, h, hkv = 3, 37, 3, 70, 4, 2
                q, kh, vh, kc, vc, ks, vs = k1_operands(
                    rnd, b, m, u, s, h, hkv, d, qdt=qdt, hist=hist)
                lens = torch.tensor([s, 1, 0], dtype=torch.int32,
                                    device=device)
                for align in (1, 8, 16):
                    seg, live = packed_seg(b, m, u, align, device,
                                           seed=n_packed)
                    for lengths in (None, lens):
                        kw = dict(mode="cached", k_scale=ks, v_scale=vs,
                                  lengths=lengths)
                        what = (f"K1 any-dims packed D {d} q={qdt} "
                                f"hist={hist} align {align} lengths "
                                f"{lengths is not None}")
                        out = fs.fused_score(q, kh, vh, kc, vc,
                                             row_index=seg, **kw)
                        torch.cuda.synchronize()
                        close(out, fs.fused_score_any_plain(
                            q, kh, vh, kc, vc, row_index=seg, **kw), what)
                        for row in range(u):
                            one = fs.fused_score(
                                q, kh, vh, kc, vc, row_index=torch.full(
                                    (b,), row, dtype=torch.int32,
                                    device=device), **kw)
                            pick = live & (seg == row)
                            torch.cuda.synchronize()
                            if not torch.equal(out[pick], one[pick]):
                                fail(f"{what}: packed != unpacked for pool "
                                     f"row {row}")
                        n_packed += 1
        for d in (192, 256, 512):
            for mode, m, lens_of in (
                    ("cached", 128, lambda s: [s, s - 1, s // 2 + 3, 1]),
                    ("extend", 129, lambda s: [s, 0, s // 2 + 3, 1])):
                for hist in hists:
                    for qdt in qdts:
                        n_bitwise += k1_bitwise_case(
                            device, rnd, fs, _int8, mode, hist,
                            (4, m, 4, 257, 4, 4, d), lens_of(257), qdt=qdt)
    return (f"{n_twin} cases within tolerance of the twin (D "
            f"{K1_ANY_DIMS}, both modes, every q / history dtype, with and "
            f"without dedup and lengths), {n_packed} packed (align 1, 8, "
            f"16) each live slot bitwise its unpacked call, {n_bitwise} "
            f"bitwise checks held (rows of M = 5 == M = 128 / 129, lengths "
            f"== S == none, padded == tight, two calls)")


def k1_any_plan_line(label: str, p: dict) -> None:
    """Prints the launch of K1's any-dims variant at a shape: CTAs a
    cluster, CTAs in all, dynamic shared bytes, CTAs resident an SM,
    clusters resident at once and the waves the grid takes (the library's
    occupancy calls on this card)."""
    print(f"[chip_smoke] plan: {label.split(' (plan')[0]}: cluster "
          f"{p['cluster']} CTAs, {p['ctas']} CTAs, {p['smem_bytes']} shared "
          f"bytes a CTA, {p['slots']} ring slots, {p['blocks_per_sm']} CTAs "
          f"resident an SM, {p['resident_clusters']} clusters resident at "
          f"once, {p['waves']} wave(s); {p['launches']} launch a call")


def k1_any_phase(device, card: str):
    """K1's any-dims variant (``csrc/score_any.cu``) on the card: the
    wrapper picks it past head dim 128 and counts a call's launches as its
    ``plan()`` says (1: one kernel, a cluster of CTAs a row group, no
    workspace) under ``fused_score``; the checks of :func:`k1_any_checks`;
    each timed shape's plan (cluster, CTAs, shared bytes, CTAs resident an
    SM, resident clusters, waves) printed; then timed beside
    its twin, its bound and SDPA at the wide-head Climber's shapes (D 256):
    ``cached`` q [4, 128, 4, 256] bf16 over an int8 history [4, 257, 4,
    256] with the dedup index (SDPA on the dequantized, gathered history
    with the SUMI mask), ``extend`` [4, 1, 4, 256] over 256 and [4, 129, 4,
    256] over 128 bf16 prefix rows (SDPA with the offset causal mask), and
    a packed index [1, 128, 4, 256] over 4 int8 rows (align 8; SDPA over
    all rows with a mask of each candidate's own row and itself).  Returns
    (timing rows, the JSON entry of the cached shape)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.fused_score import ops as fs

    t0 = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(33)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=device).to(dtype)

    summary = k1_any_checks(device, rnd)
    rows = []
    b, m, u, s, h, hkv, d = 4, 128, 4, 257, 4, 4, 256
    q, kh, vh, kc, vc, ks, vs = k1_operands(rnd, b, m, u, s, h, hkv, d,
                                            qdt=torch.bfloat16, hist="int8")
    idx = (torch.arange(b, device=device) % u).to(torch.int32)
    kw = dict(mode="cached", k_scale=ks, v_scale=vs, row_index=idx)
    p = fs.plan(q, kh)
    label = (f"K1 any-dims cached q {list(q.shape)} over int8 "
             f"{list(kh.shape)} (plan {p})")
    if not p["bf16"] or p["launches"] != 1:
        fail(f"{label}: not the any-dims variant's bf16 plan")
    k1_any_plan_line(label, p)
    f2_launch_check(label, "fused_score", p["launches"],
                    lambda: fs.fused_score(q, kh, vh, kc, vc, **kw))
    f2_bitwise(label, lambda: fs.fused_score(q, kh, vh, kc, vc, **kw))
    kd = (kh.float() * ks[:, None, :, None])[idx.long()].to(q.dtype)
    vd = (vh.float() * vs[:, None, :, None])[idx.long()].to(q.dtype)
    kk = torch.cat([kd, kc], 1).transpose(1, 2).contiguous()
    vv = torch.cat([vd, vc], 1).transpose(1, 2).contiguous()
    qq = q.transpose(1, 2).contiguous()
    mask = torch.cat([torch.ones(m, s, dtype=torch.bool, device=device),
                      torch.eye(m, dtype=torch.bool, device=device)], 1)
    uniq = int(idx.unique().numel())
    cached = text_shape_row(
        label, lambda: fs.fused_score(q, kh, vh, kc, vc, **kw),
        lambda: fs.fused_score_any_plain(q, kh, vh, kc, vc, **kw),
        lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask),
        bound(nbytes(q, kc, vc, idx, q) + uniq * (kh[0].numel() * 2
                                                  + 2 * hkv * 4),
              4 * b * h * m * (s + 1) * d), card)
    rows.append(cached)
    del kk, vv, qq, kd, vd
    for s_suf, pre in ((1, 256), (129, 128)):
        q, kh, vh, kc, vc, _, _ = k1_operands(
            rnd, 4, s_suf, 4, pre, 4, 4, d, qdt=torch.bfloat16,
            hist=torch.bfloat16)
        kk = torch.cat([kh, kc], 1).transpose(1, 2).contiguous()
        vv = torch.cat([vh, vc], 1).transpose(1, 2).contiguous()
        qq = q.transpose(1, 2).contiguous()
        emask = (torch.arange(pre + s_suf, device=device)[None, :]
                 <= pre + torch.arange(s_suf, device=device)[:, None])
        p = fs.plan(q, kh, mode="extend")
        label = (f"K1 any-dims extend q {list(q.shape)} over {pre} bf16 "
                 f"prefix rows (plan {p})")
        k1_any_plan_line(label, p)
        f2_launch_check(label, "fused_score", p["launches"],
                        lambda: fs.fused_score(q, kh, vh, kc, vc,
                                               mode="extend"))
        keys = 4 * 4 * sum(pre + i + 1 for i in range(s_suf))
        rows.append(text_shape_row(
            label, lambda: fs.fused_score(q, kh, vh, kc, vc, mode="extend"),
            lambda: fs.fused_score_any_plain(q, kh, vh, kc, vc,
                                             mode="extend"),
            lambda: F.scaled_dot_product_attention(qq, kk, vv,
                                                   attn_mask=emask),
            bound(nbytes(q, kh, vh, kc, vc, q), 4 * d * keys), card))
    b, m, u, s = 1, 128, 4, 257
    q, kh, vh, kc, vc, ks, vs = k1_operands(rnd, b, m, u, s, h, hkv, d,
                                            qdt=torch.bfloat16, hist="int8")
    seg, _ = packed_seg(b, m, u, 8, device, seed=5)
    kw = dict(mode="cached", k_scale=ks, v_scale=vs, row_index=seg)
    kd = (kh.float() * ks[:, None, :, None]).to(q.dtype)
    vd = (vh.float() * vs[:, None, :, None]).to(q.dtype)
    kk = torch.cat([kd.reshape(1, u * s, h, d), kc], 1).transpose(1, 2) \
        .contiguous()
    vv = torch.cat([vd.reshape(1, u * s, h, d), vc], 1).transpose(1, 2) \
        .contiguous()
    qq = q.transpose(1, 2).contiguous()
    own = (torch.arange(u * s, device=device)[None, :] // s
           == seg[0].long()[:, None])
    pmask = torch.cat([own, torch.eye(m, dtype=torch.bool, device=device)],
                      1)
    p = fs.plan(q, kh)
    label = (f"K1 any-dims packed q {list(q.shape)} over {u} int8 rows of "
             f"{s} (align 8; plan {p})")
    k1_any_plan_line(label, p)
    f2_launch_check(label, "fused_score", p["launches"],
                    lambda: fs.fused_score(q, kh, vh, kc, vc, **kw))
    rows.append(text_shape_row(
        label,
        lambda: fs.fused_score(q, kh, vh, kc, vc, **kw),
        lambda: fs.fused_score_any_plain(q, kh, vh, kc, vc, **kw),
        lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=pmask),
        bound(nbytes(q, kc, vc, seg, q, kh, vh) + 2 * u * h * 4,
              4 * h * m * (s + 1) * d), card))
    print(f"[chip_smoke] K1 any-dims variant: {summary}; "
          f"{time.perf_counter() - t0:.1f}s")
    entry = dict(name="fused_score_any", route="cuda",
                 source="src/repro_torch/csrc/score_any.cu",
                 replaces=REPLACES["fused_score"],
                 max_abs_err=cached["max_abs_err"], ms=cached["ms"],
                 plain_ms=cached["plain_ms"], bound_ms=cached["bound_ms"],
                 bound_by=cached["bound_by"],
                 library_ms=cached["library_ms"])
    return rows, entry


def grid_limit_checks(device) -> None:
    """One call per kernel whose grid's y dimension is B * H, at B * H just
    past 65535 (B 16385, H 4): K1's tiled kernel at [16385, 1, 4, 64] over
    a 16-position int8 history, with the dedup index (4 pool rows) and
    without (a pool row per batch row); K1's any-dims variant at [16385, 1,
    4, 192] (its row groups on grid x); K2's tiled kernel at [16385, 16, 4,
    64] causal; K4's self-slot form at [16385, 1, 4, 64] over 16-position
    caches, unpacked and with a [B, 1] row index into 4 cache rows.  Each
    against its plain version; the tiled wrappers launch in batch chunks
    of at most 65535 // H rows, and their ``plan()`` counts the chunks."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.fused_score import ops as fs

    g = torch.Generator(device=device).manual_seed(34)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=device).to(dtype)

    b, h, s = 16385, 4, 16
    done = []
    with uncounted():
        for d, u, dedup in ((64, 4, True), (64, b, False), (192, 4, True)):
            q, kh, vh, kc, vc, ks, vs = k1_operands(
                rnd, b, 1, u, s, h, h, d, qdt=torch.bfloat16, hist="int8")
            kw = dict(mode="cached", k_scale=ks, v_scale=vs, row_index=(
                torch.arange(b, device=device) % u).to(torch.int32)
                if dedup else None)
            label = (f"K1 {fs.route(d)} at B * H {b * h}: q "
                     f"{list(q.shape)} over {list(kh.shape)}")
            f2_launch_check(label, "fused_score", fs.plan(q, kh)["launches"],
                            lambda: fs.fused_score(q, kh, vh, kc, vc, **kw))
            plain = (fs.fused_score_plain if fs.route(d) == "tiled"
                     else fs.fused_score_any_plain)
            done.append((label, close(fs.fused_score(q, kh, vh, kc, vc, **kw),
                                      plain(q, kh, vh, kc, vc, **kw),
                                      label)))
        q, k, v = rnd(b, s, h, 64), rnd(b, s, h, 64), rnd(b, s, h, 64)
        label = f"K2 tiled at B * H {b * h}: q {list(q.shape)} causal"
        f2_launch_check(label, "flash_attention", fa.plan(q)["launches"],
                        lambda: fa.flash_attention(q, k, v, "causal"))
        done.append((label, close(fa.flash_attention(q, k, v, "causal"),
                                  fa.flash_attention_plain(q, k, v, "causal"),
                                  label)))
        for rows in (b, 4):
            q, ks_, vs_ = rnd(b, 1, h, 64), rnd(b, 1, h, 64), rnd(b, 1, h, 64)
            kcache, vcache = rnd(rows, s, h, 64), rnd(rows, s, h, 64)
            lens = torch.randint(0, s + 1, (rows,), generator=g,
                                 device=device).to(torch.int32)
            ri = None if rows == b else (torch.arange(b, device=device)
                                         % rows).to(torch.int32)[:, None]
            label = (f"K4 self-slot at B * H {b * h}: q {list(q.shape)} over "
                     f"{rows} cache rows of {s}")
            f2_launch_check(label, "flash_decode_with_self",
                            fd.plan(q, kcache)["launches"],
                            lambda: fd.flash_decode_with_self(
                                q, kcache, vcache, lens, ks_, vs_,
                                row_index=ri))
            done.append((label, close(fd.flash_decode_with_self(
                q, kcache, vcache, lens, ks_, vs_, row_index=ri),
                fd.flash_decode_with_self_plain(q, kcache, vcache, lens, ks_,
                                                vs_, ri), label)))
    print("[chip_smoke] B * H past the grid's 65535: " + "; ".join(
        f"{label} max abs err {err:.3g}" for label, err in done))


def f2_launch_check(label: str, counter: str, want: int, call) -> None:
    """One counted call of ``call`` must add ``want`` launches to the
    ``counter`` wrapper's count (the variant counts under its TPU kernel),
    and nothing to any other; the call is then taken back off the
    counters (it is no main path's)."""
    import torch
    from repro_torch.kernels import _build
    with uncounted():
        before = _build.launch_counts()
        call()
        torch.cuda.synchronize()
        after = _build.launch_counts()
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    if moved != {counter: want}:
        fail(f"{label}: one call moved the launch counts by {moved}, want "
             f"{{{counter!r}: {want}}}")


def f2_bitwise(label: str, call, padded=None) -> None:
    """A second call of ``call`` must give its first output bitwise, and
    so must ``padded`` (the same function on a cache padded past
    ``lengths``) where given; no call counts (none is a main path's)."""
    import torch
    with uncounted():
        want = call()
        for what, f in (("a second call", call), ("the padded cache",
                                                  padded)):
            if f is None:
                continue
            got = f()
            if not torch.equal(got, want):
                err = (got.float() - want.float()).abs().max().item()
                fail(f"{label}: {what} differs from the first call (max "
                     f"abs {err:.3g})")


def f2_phase(device, card: str, entries=None) -> list:
    """Each any-dims variant (F2's remainder: the dims past the tiled
    kernels' instantiations, which the JAX wrappers take) against its plain
    twin on the card, timed beside its bound and its library call, after a
    check that the wrapper picks it from the dims and counts one call's
    launches (its ``plan()``'s) under the TPU kernel: K2
    (``attention_any.cu``) at [4, 500, 8, D] with 2 KV heads, D 320 and 512
    in bf16 and 256 in f32, ``causal`` and ``sliding`` (window 128), SDPA
    beside; K4's split decode (``decode_any.cu``), the single-token form
    over 528 keys at D 512 (G 4) and at G 8 x D 256 (bf16) and over a long
    cache of 4096 keys at [1, 16, 256], SDPA with a length mask beside, and
    its self-slot form (K1's variant, ``score_any.cu``, in ``cached``
    mode, one launch a call) at D 256 (4 rows x 128 candidates over 264
    keys), SDPA on the materialized operands beside, each form also
    bitwise across two calls and on a cache padded past ``lengths`` with
    NaN, the single-token form refused by the library, with no launch,
    given a workspace one float short; K3
    (``ffn_any.cu``) in f32 at d 1024, d_ff 4096, T 4 and 512, and in bf16
    at the odd widths d 1020, d_ff 4100, T 64, the matmul chain beside,
    bitwise across two calls; K3 and K4 at ragged dims, checked only (the
    element and 4-byte copies, windows, lengths S / 1 / 0, packed rows,
    G 130 over three head tiles, three head-dim passes at D 600, K3
    slices of three chunks);
    K5 (``rwkv6_scan_any.cu``) at [4, 500, 32, 128], no library call,
    against its twin ``rwkv6_scan_subchunk`` (la in step order), bitwise
    across two calls and row 2 alone (another column split) bitwise row 2
    of the batch.  Also checked only (against the twins, launches as
    ``plan()`` says): K2 under ``full`` with Sq != Sk, sumi with
    ``q_offset``, ragged head dims (bf16 260 and 264, f32 200) and 17
    head-dim passes (bf16 D 4100), each bitwise across two calls; K5 at
    head sizes 100 (f32, bf16) and 256 (the work area in the library's
    workspace) and at [1, 200, 8, 128] f32, runs of w_log = -20, each
    split at step 100 with the state carried against the whole."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _any, _build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.fused_ffn import ops as ff
    from repro_torch.kernels.rwkv6_scan import ops as scan

    t0 = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(26)

    def rn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (scale * torch.randn(*shape, generator=g, device=device)
                ).to(dtype)

    def peak(dtype):
        """The card's best rate for products of ``dtype`` operands: bf16
        or TF32 on the tensor cores (the function's work, whatever units
        the variant runs it on)."""
        return (BF16_FLOP_PER_S if dtype == torch.bfloat16
                else TF32_FLOP_PER_S)

    # K1's any-dims variant first (its JSON entry, where ``entries`` is
    # given), then the B * H grid limit of the tiled kernels
    rows, k1_entry = k1_any_phase(device, card)
    if entries is not None:
        entries["fused_score_any"] = k1_entry
    grid_limit_checks(device)
    b, s, h, hkv = 4, 500, 8, 2
    for dtype, d in ((torch.bfloat16, 320), (torch.bfloat16, 512),
                     (torch.float32, 256)):
        q, k, v = (rn(b, s, h, d, dtype=dtype), rn(b, s, hkv, d, dtype=dtype),
                   rn(b, s, hkv, d, dtype=dtype))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if fa.route(d, dtype) != "any":
            fail(f"K2 at head dim {d} {dtype} did not pick the any-dims "
                 f"variant")
        for mode, window in (("causal", 0), ("sliding", 128)):
            pos = torch.arange(s, device=device)
            mask = pos[None, :] <= pos[:, None]
            if mode == "sliding":
                mask &= pos[:, None] - pos[None, :] < window
            p = fa.plan(q)
            label = (f"F2 K2 any-dims {mode} q {list(q.shape)} k/v "
                     f"{list(k.shape)} {str(dtype)[6:]} (plan {p})")
            f2_launch_check(label, "flash_attention", p["launches"],
                            lambda: (fa.flash_attention(q, k, v, mode,
                                                        window=window)))
            f2_bitwise(label, lambda: fa.flash_attention(q, k, v, mode,
                                                         window=window))
            rows.append(dict(text_shape_row(
                label,
                lambda: fa.flash_attention(q, k, v, mode, window=window),
                lambda: fa.flash_attention_any_plain(q, k, v, mode,
                                                     window=window),
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True),
                bound(nbytes(q, k, v, q), 4 * b * h * d * _visible_pairs(
                    s, mode, window), peak(dtype)), card, quick=True),
                kernel="flash_attention"))
        del q, k, v, qt, kt, vt
    # K2 checked only: ``full`` with Sq != Sk, sumi with q_offset, ragged
    # head dims (bf16 260: rows on 8-byte boundaries; 264; f32 200) and the
    # deepest pass count, each against its twin, its launches as its plan
    # says, bitwise across two calls
    for dtype, d, sq, sk, mode, kw in (
            (torch.bfloat16, 320, 200, 300, "full", {}),
            (torch.float32, 256, 130, 70, "full", {}),
            (torch.bfloat16, 512, 200, 264, "sumi",
             dict(n_history=150, q_offset=64)),
            (torch.bfloat16, 260, 150, 159, "sumi",
             dict(n_history=100, q_offset=9)),
            (torch.bfloat16, 264, 150, 150, "causal", {}),
            (torch.float32, 200, 150, 156, "sumi",
             dict(n_history=90, q_offset=6)),
            (torch.bfloat16, 4100, 70, 70, "causal", {})):
        q = rn(2, sq, 4, d, dtype=dtype)
        k, v = rn(2, sk, 2, d, dtype=dtype), rn(2, sk, 2, d, dtype=dtype)
        p = fa.plan(q)
        label = (f"F2 K2 any-dims {mode} {kw or ''} q {list(q.shape)} k/v "
                 f"{list(k.shape)} {str(dtype)[6:]} (plan {p})")
        if fa.route(d, dtype) != "any":
            fail(f"{label}: did not pick the any-dims variant")
        f2_launch_check(label, "flash_attention", p["launches"],
                        lambda: fa.flash_attention(q, k, v, mode, **kw))
        f2_bitwise(label, lambda: fa.flash_attention(q, k, v, mode, **kw))
        with uncounted():
            err = close(fa.flash_attention(q, k, v, mode, **kw),
                        fa.flash_attention_any_plain(q, k, v, mode, **kw),
                        label)
        print(f"[chip_smoke] {label}: max abs err {err:.3g}; two calls "
              f"bitwise")
    del q, k, v

    def nan_padded(c, pad):
        return torch.cat([c, torch.full((c.shape[0], pad) + c.shape[2:],
                                        float("nan"), dtype=c.dtype,
                                        device=c.device)], 1)

    def k4_plan(q, kc, self_slot, call):
        """The wrapper's plan; the single-token form's ``call`` given a
        workspace one float short of it must be refused by the library
        (CUDA error 1) before any launch.  The self-slot form (K1's
        variant) takes no workspace: one launch a call, its plan
        printed."""
        p = fd.plan(q, kc, self_slot=self_slot)
        if self_slot:
            if p["launches"] != 1:
                fail(f"K4 self-slot at q {list(q.shape)}: plan {p}, want "
                     f"one launch a call")
            k1_any_plan_line(f"K4 self-slot q {list(q.shape)} over "
                             f"{list(kc.shape)}", p)
            return p
        name = "decode_plan"
        real = getattr(_any, name)

        def short(*args):
            plan = real(*args)
            return dict(plan, workspace_floats=plan["workspace_floats"] - 1)
        setattr(_any, name, short)
        try:
            with uncounted():
                before = _build.launch_counts()
                try:
                    call()
                    why = "ran"
                except RuntimeError as e:
                    why = None if "CUDA error 1 " in str(e) else str(e)
                moved = _build.launch_counts() != before
        finally:
            setattr(_any, name, real)
        if why or moved:
            fail(f"K4 split decode at q {list(q.shape)} over "
                 f"{list(kc.shape)} with a workspace one float short: "
                 f"{why or 'refused'}, launches moved: {moved}")
        return p

    for b, s, lens, h, hkv, d in (
            (4, 528, [528, 517, 300, 130], 8, 2, 512),
            (4, 528, [528, 517, 300, 130], 16, 2, 256),
            (1, 4096, [4096], 16, 2, 256)):
        lens = torch.tensor(lens, dtype=torch.int32, device=device)
        valid = int(lens.long().sum())
        lmask = (torch.arange(s, device=device)[None, :]
                 < lens[:, None].long())[:, None, None, :]
        q, kc, vc = rn(b, h, d), rn(b, s, hkv, d), rn(b, s, hkv, d)
        if fd.route(d, h // hkv, q.dtype) != "any":
            fail(f"K4 at G {h // hkv} x D {d} did not pick the any-dims "
                 f"variant")
        qq, kk, vv = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
        p = k4_plan(q, kc, False, lambda: fd.flash_decode(q, kc, vc, lens))
        label = (f"F2 K4 any-dims single-token q {list(q.shape)} over "
                 f"{list(kc.shape)} (G {h // hkv}, lengths {lens.tolist()}; "
                 f"plan {p})")
        f2_launch_check(label, "flash_decode", p["launches"],
                        lambda: fd.flash_decode(q, kc, vc, lens))
        kp, vp = nan_padded(kc, 100), nan_padded(vc, 100)
        f2_bitwise(label, lambda: fd.flash_decode(q, kc, vc, lens),
                   lambda: fd.flash_decode(q, kp, vp, lens))
        del kp, vp
        rows.append(dict(text_shape_row(
            label, lambda: fd.flash_decode(q, kc, vc, lens),
            lambda: fd.flash_decode_any_plain(q, kc, vc, lens),
            lambda: F.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=lmask, enable_gqa=True),
            bound(2 * valid * hkv * d * 2 + nbytes(q, lens, q),
                  4 * h * d * valid), card, quick=True),
            kernel="flash_decode"))
        del q, kc, vc, qq, kk, vv
    b, m, h, hkv, d, s = 4, 128, 4, 4, 256, 264
    q = rn(b, m, h, d)
    ks, vs = rn(b, m, hkv, d), rn(b, m, hkv, d)
    kc, vc = rn(b, s, hkv, d), rn(b, s, hkv, d)
    lens = torch.tensor([257, 260, 263, 258], dtype=torch.int32,
                        device=device)
    if fd.route_self(d) != "any":
        fail(f"K4's self-slot form at D {d} did not pick the any-dims "
             f"variant")
    # SDPA on materialized operands: each candidate's prefix + own key
    km = torch.cat([kc[:, None].expand(b, m, s, hkv, d),
                    ks[:, :, None]], 2).reshape(b * m, s + 1, hkv, d)
    vm = torch.cat([vc[:, None].expand(b, m, s, hkv, d),
                    vs[:, :, None]], 2).reshape(b * m, s + 1, hkv, d)
    pos = torch.arange(s + 1, device=device)
    smask = ((pos[None, :] < lens[:, None].long()) | (pos[None, :] == s))
    smask = smask[:, None].expand(b, m, s + 1).reshape(b * m, 1, 1, s + 1)
    qm = q.reshape(b * m, 1, h, d).transpose(1, 2)
    km, vm = km.transpose(1, 2), vm.transpose(1, 2)
    valid = int(lens.long().sum()) * 1
    p = k4_plan(q, kc, True, lambda: fd.flash_decode_with_self(
        q, kc, vc, lens, ks, vs))
    label = (f"F2 K4 any-dims self-slot q {list(q.shape)} over "
             f"{list(kc.shape)} (lengths {lens.tolist()}; plan {p})")
    f2_launch_check(label, "flash_decode_with_self", p["launches"], lambda: (
        fd.flash_decode_with_self(q, kc, vc, lens, ks, vs)))
    kp, vp = nan_padded(kc, 100), nan_padded(vc, 100)
    f2_bitwise(label,
               lambda: fd.flash_decode_with_self(q, kc, vc, lens, ks, vs),
               lambda: fd.flash_decode_with_self(q, kp, vp, lens, ks, vs))
    del kp, vp
    rows.append(dict(text_shape_row(
        label, lambda: fd.flash_decode_with_self(q, kc, vc, lens, ks, vs),
        lambda: fd.flash_decode_with_self_any_plain(q, kc, vc, lens, ks, vs),
        lambda: F.scaled_dot_product_attention(qm, km, vm, attn_mask=smask),
        bound(2 * valid * hkv * d * 2 + nbytes(q, ks, vs, lens, q),
              4 * m * h * d * (valid + b)), card, quick=True),
        kernel="flash_decode"))
    del km, vm, qm
    for dtype, d, f, act, ts in ((torch.float32, 1024, 4096, "gelu",
                                  (4, 512)),
                                 (torch.bfloat16, 1020, 4100, "swiglu",
                                  (64,))):
        wu, wd = (rn(d, f, scale=d ** -0.5, dtype=dtype),
                  rn(f, d, scale=f ** -0.5, dtype=dtype))
        wg = rn(d, f, scale=d ** -0.5, dtype=dtype) if act == "swiglu" \
            else None
        if ff.route(d, f, dtype) != "any":
            fail(f"K3 at d {d}, d_ff {f} {dtype} did not pick the any-dims "
                 f"variant")

        def chain(x, wu=wu, wd=wd, wg=wg, act=act):
            if act == "swiglu":
                return (F.silu(x @ wg) * (x @ wu)) @ wd
            return F.gelu(x @ wu, approximate="tanh") @ wd
        for t in ts:
            x = rn(t, d, dtype=dtype)
            p = ff.plan(x, wu, activation=act)
            label = (f"F2 K3 any-dims {act} x [{t}, {d}] d_ff {f} "
                     f"{str(dtype)[6:]} (plan {p})")
            f2_launch_check(label, "fused_ffn_2d", p["launches"], lambda: (
                ff.fused_ffn_2d(x, wu, wd, wg, activation=act)))
            f2_bitwise(label, lambda: ff.fused_ffn_2d(x, wu, wd, wg,
                                                      activation=act))
            rows.append(dict(text_shape_row(
                label,
                lambda x=x: ff.fused_ffn_2d(x, wu, wd, wg, activation=act),
                lambda x=x: ff.fused_ffn_any_plain(x, wu, wd, wg,
                                                   activation=act),
                lambda x=x: chain(x),
                bound(nbytes(x, wu, wd, wg, x),
                      2 * t * d * f * (3 if act == "swiglu" else 2),
                      peak(dtype)), card, quick=True),
                kernel="fused_ffn"))
        del wu, wd, wg
    # ragged dims, checked only: K3's element (odd pitch) and 4-byte
    # copies with the norm, K4's element loads past a 16-byte head-dim
    # chunk, a window, lengths S / 1 / 0 and packed rows
    checks = 0
    with uncounted():
        for dtype, d, f, act, t in ((torch.bfloat16, 1023, 257, "swiglu", 9),
                                    (torch.float32, 100, 520, "gelu", 70),
                                    (torch.float32, 100, 3000, "gelu", 2000)):
            wu, wd = (rn(d, f, scale=d ** -0.5, dtype=dtype),
                      rn(f, d, scale=f ** -0.5, dtype=dtype))
            wg = rn(d, f, scale=d ** -0.5, dtype=dtype) \
                if act == "swiglu" else None
            ns, x = rn(d, scale=0.1, dtype=dtype), rn(t, d, dtype=dtype)
            close(ff.fused_ffn_2d(x, wu, wd, wg, ns, activation=act),
                  ff.fused_ffn_any_plain(x, wu, wd, wg, ns, activation=act),
                  f"F2 K3 any-dims {d} x {f} T {t} {str(dtype)[6:]}")
            checks += 1
        for dtype, b, h, hkv, d, s, window in (
                (torch.bfloat16, 3, 40, 2, 300, 200, 0),
                (torch.float32, 3, 8, 2, 260, 300, 100),
                (torch.bfloat16, 3, 130, 1, 264, 100, 0)):
            q, kc, vc = (rn(b, h, d, dtype=dtype),
                         rn(b, s, hkv, d, dtype=dtype),
                         rn(b, s, hkv, d, dtype=dtype))
            lens = torch.tensor([s, 1, 0], dtype=torch.int32, device=device)
            if fd.route(d, h // hkv, dtype) != "any":
                fail(f"K4 at G {h // hkv} x D {d} did not pick the any-dims "
                     f"variant")
            what = f"F2 K4 any-dims [{b}, {h}, {d}] over {s} window {window}"
            got = fd.flash_decode(q, kc, vc, lens, window=window)
            close(got, fd.flash_decode_any_plain(q, kc, vc, lens,
                                                 window=window), what)
            o2, lse = fd.flash_decode(q, kc, vc, lens, window=window,
                                      return_lse=True)
            if not torch.equal(o2, got):
                fail(f"{what}: the output differs with the log-sum-exp")
            close_lse(lse, fd.flash_decode_any_plain(
                q, kc, vc, lens, window=window, return_lse=True)[1], what)
            checks += 1
        b, m, h, hkv, d, s = 2, 6, 4, 2, 200, 150
        q = rn(b, m, h, d, dtype=torch.float32)
        ks, vs = (rn(b, m, hkv, d, dtype=torch.float32) for _ in range(2))
        kc, vc = (rn(3, s, hkv, d, dtype=torch.float32) for _ in range(2))
        lens = torch.tensor([s, 0, 1], dtype=torch.int32, device=device)
        ri = torch.tensor([[0, 1, 2, 1, 0, 2], [2, 2, 1, 0, 1, 0]],
                          dtype=torch.int32, device=device)
        close(fd.flash_decode_with_self(q, kc, vc, lens, ks, vs, row_index=ri),
              fd.flash_decode_with_self_any_plain(q, kc, vc, lens, ks, vs,
                                                  ri),
              f"F2 K4 any-dims self-slot packed [{b}, {m}, {h}, {d}] over "
              f"three rows")
        checks += 1
        # 64 candidates a block at D 600: three head-dim passes
        b, m, h, hkv, d, s = 2, 64, 2, 2, 600, 90
        q = rn(b, m, h, d, dtype=torch.float32)
        ks, vs = (rn(b, m, hkv, d, dtype=torch.float32) for _ in range(2))
        kc, vc = (rn(b, s, hkv, d, dtype=torch.float32) for _ in range(2))
        lens = torch.tensor([90, 37], dtype=torch.int32, device=device)
        close(fd.flash_decode_with_self(q, kc, vc, lens, ks, vs),
              fd.flash_decode_with_self_any_plain(q, kc, vc, lens, ks, vs),
              f"F2 K4 any-dims self-slot [{b}, {m}, {h}, {d}] (plan "
              f"{fd.plan(q, kc)})")
        checks += 1
    print(f"[chip_smoke] F2 ragged dims: {checks} checks held")
    b, s, h, d = 4, 500, 32, 128
    r, k, v = (rn(b, s, h, d, scale=0.5) for _ in range(3))
    wl = -torch.exp(torch.randn(b, s, h, d, generator=g, device=device))
    u = rn(h, d, scale=0.5, dtype=torch.float32)
    s0 = 0.1 * torch.randn(b, h, d, d, generator=g, device=device)
    if scan.route(d) != "any":
        fail(f"K5 at head size {d} did not pick the any-head-size variant")
    p = scan.plan(r)
    label = (f"F2 K5 any-head-size rwkv6_scan [{b}, {s}, {h}, {d}] (plan "
             f"{p})")
    f2_launch_check(label, "rwkv6_scan", p["launches"],
                    lambda: scan.rwkv6_scan(r, k, v, wl, u, s0))
    with uncounted():
        o, sf = scan.rwkv6_scan(r, k, v, wl, u, s0)
        again = scan.rwkv6_scan(r, k, v, wl, u, s0)
        # row 2 alone: 32 blocks, where the library splits the state's
        # columns over two blocks each; in the batch, one
        oa, sfa = scan.rwkv6_scan(r[2:3], k[2:3], v[2:3], wl[2:3], u,
                                  s0[2:3])
        po, psf = scan.rwkv6_scan_subchunk(r, k, v, wl, u, s0, steps=True)
        close_scaled(sf, psf, K5_F32_TOL, f"{label}: final state")
    if not (torch.equal(again[0], o) and torch.equal(again[1], sf)):
        fail(f"{label}: two calls differ")
    if not (torch.equal(oa, o[2:3]) and torch.equal(sfa, sf[2:3])):
        fail(f"{label}: row 2 alone (plan {scan.plan(r[2:3])}) differs "
             f"from row 2 of the batch")
    print(f"[chip_smoke] {label}: two calls bitwise; row 2 alone (column "
          f"split {scan.plan(r[2:3])['col_split']}) bitwise row 2 of the "
          f"batch (split {p['col_split']})")
    del o, sf, again, oa, sfa, po, psf
    bnd = k5_bound(nbytes(r, k, v, wl, u, s0, r, s0), k5_work(b, h, s, d),
                   label)
    rows.append(dict(text_shape_row(
        label, lambda: scan.rwkv6_scan(r, k, v, wl, u, s0)[0],
        lambda: scan.rwkv6_scan_subchunk(r, k, v, wl, u, s0,
                                         steps=True)[0], None, bnd,
        card, check=lambda got, want, what: close_scaled(
            got, want, K5_BF16_TOL, what), quick=True), kernel="rwkv6_scan"))
    del r, k, v, wl, u, s0
    # K5 checked only: head sizes 100 (rows off 16-byte boundaries in bf16)
    # and 256 (the work area in the library's workspace), runs of w_log =
    # -20, against the twin; split in the middle of a chunk with the state
    # carried == the whole sequence
    for dtype, b, s, h, d in ((torch.float32, 2, 150, 4, 100),
                              (torch.bfloat16, 2, 150, 4, 100),
                              (torch.bfloat16, 2, 150, 4, 256),
                              (torch.float32, 1, 200, 8, 128)):
        r, k, v = (rn(b, s, h, d, scale=0.5, dtype=dtype) for _ in range(3))
        wl = -torch.exp(torch.randn(b, s, h, d, generator=g, device=device))
        wl[:, 20:60] = -20.0
        u = rn(h, d, scale=0.5, dtype=torch.float32)
        s0 = 0.1 * torch.randn(b, h, d, d, generator=g, device=device)
        p = scan.plan(r)
        label = (f"F2 K5 any-head-size [{b}, {s}, {h}, {d}] "
                 f"{str(dtype)[6:]} (plan {p})")
        f2_launch_check(label, "rwkv6_scan", p["launches"],
                        lambda: scan.rwkv6_scan(r, k, v, wl, u, s0))
        tol = K5_F32_TOL if dtype == torch.float32 else K5_BF16_TOL
        with uncounted():
            o, sf = scan.rwkv6_scan(r, k, v, wl, u, s0)
            po, psf = scan.rwkv6_scan_subchunk(r, k, v, wl, u, s0,
                                               steps=True)
            err = close_scaled(o, po, tol, label)
            close_scaled(sf, psf, K5_F32_TOL, f"{label}: final state")
            cut = 100                   # inside the second 64-step chunk
            o1, s1 = scan.rwkv6_scan(r[:, :cut], k[:, :cut], v[:, :cut],
                                     wl[:, :cut], u, s0)
            o2, s2 = scan.rwkv6_scan(r[:, cut:], k[:, cut:], v[:, cut:],
                                     wl[:, cut:], u, s1)
            split = close_scaled(torch.cat([o1, o2], 1), o, tol,
                                 f"{label}: split at step {cut}")
            close_scaled(s2, sf, K5_F32_TOL, f"{label}: split's state")
        print(f"[chip_smoke] {label}: max err {err:.3g} of the scale; "
              f"steps 0-{cut - 1} then {cut}-{s - 1}, state carried, "
              f"{split:.3g} of the whole's scale")
    del r, k, v, wl, u, s0, o, sf, po, psf, o1, o2, s1, s2
    print(f"[chip_smoke] F2 any-dims variants: {len(rows)} rows in "
          f"{time.perf_counter() - t0:.1f}s (K2's head-dim passes of "
          f"{fa.plan(rn(1, 1, 1, 4100))['width']} columns at D 4100; K5's "
          f"chunks of {scan.CHUNK} steps; K4's splits of {_any.SPLIT} "
          f"positions)")
    return rows


def _rel_errs(got, want, what: str):
    """(mean, max) abs error of ``got`` over the mean / max |want| (f32);
    fails on a non-finite ``got``."""
    import torch
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        fail(f"{what}: non-finite logits")
    err = (g - w).abs()
    return (float(err.mean() / w.abs().mean()),
            float(err.max() / w.abs().max()))


@contextlib.contextmanager
def moe_routing(replay=None, gaps=None):
    """Inside the block every MoE layer's expert choice (``torch.topk`` of
    its router probabilities) is recorded, in call order, into the list
    yielded; with ``replay`` (such a list from another run) each layer
    takes the recorded choice instead, and its gates are its own
    probabilities at those experts.  The routing is a discrete choice: a
    bf16 rounding that swaps two near-equal probabilities sends a token to
    another expert, and with random weights one such flip spreads through
    the later layers and positions, so two routes are compared on one
    routing.  With ``gaps`` (a list) a replaying layer also appends, per
    token, how far the replayed choice lies below the layer's own: the
    largest router-logit gap (log-probability) between its own k-th
    choice and a replayed expert it would not have chosen, 0 where the
    two choose the same experts."""
    import torch
    from repro_torch.models import moe as MOE
    real_apply, real_topk = MOE.moe_apply, torch.topk
    record = []
    it = iter(replay) if replay is not None else None

    def topk(probs, k, dim=-1):
        if it is None:
            vals, idx = real_topk(probs, k, dim=dim)
            record.append(idx.clone())
            return vals, idx
        idx = next(it)
        record.append(idx)
        picked = torch.gather(probs, dim, idx)
        if gaps is not None:
            kth = real_topk(probs, k, dim=dim)[0][..., -1:]
            gaps.append((kth.float().log() - picked.float().log()
                         ).clamp_min(0).amax(-1).cpu())
        return picked, idx

    def through(real):
        def routed(*a, **kw):
            torch.topk = topk
            try:
                return real(*a, **kw)
            finally:
                torch.topk = real_topk
        return routed
    MOE.moe_apply = through(real_apply)   # moe_apply_ep's dispatch too
    try:
        yield record
    finally:
        MOE.moe_apply = real_apply


def _flips(a, b) -> tuple:
    """(token-layer choices whose expert sets differ, all choices) of two
    routings."""
    import torch
    n = sum(int((torch.sort(x, -1).values != torch.sort(y, -1).values)
                .any(-1).sum()) for x, y in zip(a, b))
    return n, sum(x.shape[0] for x in a)


def _logits_check(got, want, what: str, name: str) -> str:
    """Gate ``got`` within a mean TEXT_BF16_MEAN_TOL of ``want`` relative
    to the mean |logit|; the max reported."""
    mean, mx = _rel_errs(got, want, what)
    if not mean <= TEXT_BF16_MEAN_TOL:
        fail(f"{what}: pallas {name} logits: mean abs err {mean:.3g} of the "
             f"mean |logit| > {TEXT_BF16_MEAN_TOL}")
    return f"{name} mean {mean:.3g}, max {mx:.3g} of the scale"


@contextlib.contextmanager
def f32_route():
    """Inside the block a text bundle's layer stack runs in f32: each
    layer's weights upcast as the layer runs (one layer's f32 copy at a
    time: the whole model's would not fit beside its bf16 weights), the
    residual stream f32 from the first layer on, and the unembedding in
    f32; the same function as the bundle on an f32 copy of its weights."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    real_layer, real_unembed = T.layer_apply, L.unembed

    def f32(tree):
        return tree_map(lambda t: t.float() if t.is_floating_point() else t,
                        tree)

    def layer(p, x, *a, **kw):
        return real_layer(f32(p), x.float(), *a, **kw)

    def unembed(p, x, cfg, **kw):
        return real_unembed(f32(p), x.float(), cfg, **kw)
    T.layer_apply, L.unembed = layer, unembed
    try:
        yield
    finally:
        T.layer_apply, L.unembed = real_layer, real_unembed


def text_attn_gates(bundle, params, prompt, device, what: str) -> str:
    """The ``pallas`` logits (K2 / K3 / K4 on the card) against the same
    bundle's kernel-free routes on the card: the prefill of ``prompt``
    against ``impl="chunked"``, then one decode step from that prefill's
    caches (cloned for each route: a decode step writes its caches in
    place) against ``impl="reference"``; each gated on its mean error
    relative to the mean |logit| (TEXT_BF16_MEAN_TOL), the max reported.
    With MoE layers the kernel-free routes replay the pallas route's
    expert choices (:func:`moe_routing`), and the error with each route
    choosing for itself is reported beside, with the choices that
    differ.  With Mamba layers the prefill is held instead against the
    chunked route in f32 (:func:`f32_route`, routing replayed): the
    pallas logits' mean error there may exceed the bf16 chunked route's
    own by at most TEXT_F32_MARGIN.  A Mamba state carries each rounding
    to every later position, and two bf16 routes of jamba's random-weight
    stack part by more than half of TEXT_BF16_MEAN_TOL without any kernel
    (``reference`` against ``chunked``, reported beside with the
    pallas-chunked gap): the question is then which route is further from
    the exact function."""
    import torch
    from repro_torch.tree import tree_map
    moe = bundle.cfg.moe is not None
    mamba = "mamba" in bundle.cfg.layer_pattern
    tok = torch.as_tensor(prompt[None], dtype=torch.int64, device=device)
    out = []
    with torch.inference_mode(), uncounted():
        caches = bundle.cache_init(1, len(prompt) + 8, device=device)
        with moe_routing() as routes:
            pal, filled = bundle.prefill(params, {"tokens": tok},
                                         impl="pallas", caches=caches)
        with moe_routing(routes if moe else None):
            ref = bundle.prefill(params, {"tokens": tok}, impl="chunked")
        if mamba:
            with moe_routing(routes if moe else None), f32_route():
                exact = bundle.prefill(params, {"tokens": tok},
                                       impl="chunked")
            with moe_routing(routes if moe else None):
                other = bundle.prefill(params, {"tokens": tok},
                                       impl="reference")
            e_pal, m_pal = _rel_errs(pal, exact, what)
            e_ref, m_ref = _rel_errs(ref, exact, what)
            e_gap, m_gap = _rel_errs(pal, ref, what)
            e_oth = _rel_errs(other, exact, what)[0]
            e_two = _rel_errs(other, ref, what)[0]
            del exact, other
            if not e_pal <= e_ref + TEXT_F32_MARGIN:
                fail(f"{what}: pallas prefill logits: mean abs err "
                     f"{e_pal:.4g} of the mean |logit| against the f32 "
                     f"chunked route > the bf16 chunked route's {e_ref:.4g}"
                     f" + {TEXT_F32_MARGIN}")
            prefill = (f"prefill against the f32 chunked route: pallas mean"
                       f" {e_pal:.4g} (max {m_pal:.3g}), bf16 chunked mean "
                       f"{e_ref:.4g} (max {m_ref:.3g}) (gate: pallas <= "
                       f"chunked + {TEXT_F32_MARGIN}); pallas against bf16 "
                       f"chunked mean {e_gap:.4g}, max {m_gap:.3g}, and "
                       f"bf16 reference (no kernel either) against the f32"
                       f" route {e_oth:.4g}, against bf16 chunked "
                       f"{e_two:.4g}, reported")
        else:
            prefill = _logits_check(pal, ref, what, "prefill (chunked)")
        if moe:
            with moe_routing() as own:
                free = bundle.prefill(params, {"tokens": tok},
                                      impl="chunked")
            mean, mx = _rel_errs(pal, free, what)
            n, total = _flips(routes, own)
            out.append(f"prefill (chunked, routing its own: mean {mean:.3g},"
                       f" max {mx:.3g}; {n} of {total} token-layer expert "
                       f"choices differ; gated with the pallas routing "
                       f"replayed)")
            del free
        out.append(prefill)
        del pal, ref
        step = {"tokens": tok[:, -1:], "cur_index": torch.tensor(
            len(prompt), device=device)}
        with moe_routing() as routes:
            lp, _ = bundle.decode_step(params, tree_map(torch.clone, filled),
                                       step, impl="pallas")
        with moe_routing(routes if moe else None):
            lr, _ = bundle.decode_step(params, tree_map(torch.clone, filled),
                                       step, impl="reference")
        out.append(_logits_check(lp, lr, what, "decode step (reference)"))
    return "; ".join(out) + f" (gate: mean <= {TEXT_BF16_MEAN_TOL}" + (
        ", the decode step" if mamba else "") + ")"


@contextlib.contextmanager
def moe_drops():
    """Every MoE layer's ``dropped_fraction`` (0-d device tensors) of the
    calls made inside the block, in a list."""
    from repro_torch.models import moe as MOE
    real = MOE.moe_apply
    drops = []

    def recorded(*a, **kw):
        out, aux = real(*a, **kw)
        drops.append(aux["dropped_fraction"])
        return out, aux
    MOE.moe_apply = recorded
    try:
        yield drops
    finally:
        MOE.moe_apply = real


@contextlib.contextmanager
def span_times(targets):
    """CUDA events around every outermost call of each ``(owner, attr)``
    callable of ``targets`` ({label: (owner, attr)}) made inside the block;
    yields {label: [(start, end), ...]} (read after a synchronize)."""
    import torch
    spans = {label: [] for label in targets}
    saved = []
    for label, (owner, attr) in targets.items():
        fn = getattr(owner, attr)
        depth = [0]

        def wrapped(*a, _fn=fn, _label=label, _depth=depth, **kw):
            if _depth[0]:
                return _fn(*a, **kw)
            _depth[0] += 1
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            try:
                return _fn(*a, **kw)
            finally:
                ev[1].record()
                _depth[0] -= 1
                spans[_label].append(ev)
        saved.append((owner, attr, fn))
        setattr(owner, attr, wrapped)
    try:
        yield spans
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def text_attn_greedy(bundle, params, eng_out, prompt, device, what: str,
                     steps: int = 4, extra=None) -> int:
    """Greedy == repeated prefill: the engine's first ``steps`` tokens for
    ``prompt`` (one prefill, then decode steps) against prefilling the
    growing sequence under the same impl (``extra``: more entries of the
    prefill's batch, the vision model's patch embeddings or the audio
    model's frames); a step whose reference top-2 gap is under TIE_GAP is
    reported, not gated, and where the two part there the comparison ends.
    Returns the steps gated."""
    import torch
    seq = [int(t) for t in prompt]
    extra = extra or {}
    gated = 0
    with torch.inference_mode(), uncounted():
        for i in range(steps):
            batch = {"tokens": torch.tensor([seq], device=device), **extra}
            ref = bundle.prefill(params, batch, impl="pallas")[0, -1].float()
            top2 = torch.topk(ref, 2).values
            gap = float(top2[0] - top2[1])
            want, got = int(ref.argmax()), int(eng_out[i])
            if gap < TIE_GAP:
                print(f"[chip_smoke] {what}: greedy step {i}: reference "
                      f"top-2 gap {gap:.3g} < {TIE_GAP}: near tie, reported "
                      f"not gated (engine {got}, repeated prefill {want})")
                if want != got:
                    print(f"[chip_smoke] {what}: the sequences part at this "
                          f"near tie; the comparison ends here")
                    break
            elif want != got:
                fail(f"{what}: greedy step {i}: engine token {got} != "
                     f"repeated prefill {want} (top-2 gap {gap:.3g})")
            else:
                gated += 1
            seq.append(want)
    return gated


def moe_greedy(cfg, params, prompt, device, what: str,
               steps: int = 4) -> str:
    """Greedy == repeated prefill for a MoE model.  The capacity comes from
    the tokens of a call, so at the published capacity factor a prefill
    drops assignments (random routers crowd a few experts) that a one-token
    step keeps.  A bundle of the same weights with capacity factor
    ``num_experts / top_k`` (every expert can take every token of a call,
    so nothing can drop; every MoE call's drop fraction is checked to be 0)
    serves ``prompt`` through a text engine of its own (batch 1, the decode
    step captured); its first ``steps`` tokens must equal an eager decode
    loop's, which records each step's expert choices, and are held against
    repeated prefills as :func:`text_attn_greedy` holds them.  A step whose
    token differs where the decode step and the prefill sent that token to
    different experts (a near tie of the router flipped by the two paths'
    roundings) is reported, not gated, and the comparison ends there; with
    the same experts it fails.  The drop fractions of one prefill of
    ``prompt`` at the published capacity are reported beside."""
    import torch
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeRequest, create_engine
    m = cfg.moe
    wide = build_model(dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k)))
    tok = torch.as_tensor(prompt[None], dtype=torch.int64, device=device)
    with torch.inference_mode(), uncounted(), moe_drops() as published:
        build_model(cfg).prefill(params, {"tokens": tok}, impl="pallas")
    with uncounted():
        eng = create_engine("text", wide, params, batch=1,
                            max_len=len(prompt) + steps + 8, device=device)
        try:
            out = eng.submit(ServeRequest(history=prompt, n_tokens=steps)
                             ).result(timeout=600).output
        finally:
            eng.shutdown()
        del eng
    seq = [int(t) for t in prompt]
    n = len(seq)
    rows, gated = [], 0
    with torch.inference_mode(), uncounted(), moe_drops() as drops:
        caches = wide.cache_init(1, n + steps + 8, device=device)
        lg, caches = wide.prefill(params, {"tokens": tok}, impl="pallas",
                                  caches=caches)
        eager, dec_routes = [int(lg[0, -1].argmax())], [None]
        for i in range(steps - 1):
            with moe_routing() as r:
                lg, caches = wide.decode_step(params, caches, {
                    "tokens": torch.tensor([[eager[-1]]], device=device),
                    "cur_index": torch.tensor(n + i, device=device)},
                    impl="pallas")
            eager.append(int(lg[0, -1].argmax()))
            dec_routes.append(r)
        del caches, lg
        if eager != [int(t) for t in out[:steps]]:
            fail(f"{what}: the engine's tokens {list(out[:steps])} != the "
                 f"eager decode loop's {eager}")
        for i in range(steps):
            with moe_routing() as r:
                ref = wide.prefill(params, {"tokens": torch.tensor(
                    [seq], device=device)}, impl="pallas")[0, -1].float()
            top2 = torch.topk(ref, 2).values
            gap = float(top2[0] - top2[1])
            want, got = int(ref.argmax()), eager[i]
            # the experts of the last token fed: step i's decode input
            flips = [] if i == 0 else [
                j for j, (d, p) in enumerate(zip(dec_routes[i], r))
                if not torch.equal(torch.sort(d[0]).values,
                                   torch.sort(p[-1]).values)]
            rows.append((gap, want, got, flips))
            why = ([f"top-2 gap {gap:.3g} < {TIE_GAP}"] if gap < TIE_GAP
                   else []) + ([f"the token fed went to other experts in "
                                f"the decode step than in the prefill in "
                                f"MoE layers {flips}"] if flips else [])
            if why:
                print(f"[chip_smoke] {what}: greedy step {i}: engine {got}, "
                      f"repeated prefill {want}; {'; '.join(why)}: "
                      f"reported, not gated")
                if want != got:
                    print(f"[chip_smoke] {what}: the sequences part here; "
                          f"the comparison ends")
                    break
            elif want != got:
                fail(f"{what}: greedy step {i}: engine token {got} != "
                     f"repeated prefill {want} (top-2 gap {gap:.3g}, the "
                     f"same experts)")
            else:
                gated += 1
            seq.append(want)
    dropped = [float(d) for d in drops]
    if not dropped or any(dropped):
        fail(f"{what}: greedy == repeated prefill: MoE drop fractions "
             f"{dropped} at capacity factor {m.num_experts / m.top_k:g}")
    return (f"{gated}/{steps} steps gated on the {len(prompt)}-token prompt "
            f"at capacity factor {m.num_experts / m.top_k:g} ({len(dropped)}"
            f" MoE calls, none dropped an assignment; steps as (top-2 gap, "
            f"repeated prefill, engine, MoE layers whose experts differ): "
            f"{[(round(g, 4), w, e, f) for g, w, e, f in rows]}); at the "
            f"published {m.capacity_factor:g} its prefill drops "
            f"{[round(float(d), 4) for d in published]} (reported)")


def family_desc(cfg) -> str:
    """The MoE and Mamba settings of ``cfg``, for a phase's first line."""
    from repro_torch.models.transformer import _is_moe_layer
    out = ""
    if cfg.moe is not None:
        m = cfg.moe
        n_moe = cfg.n_groups * sum(_is_moe_layer(cfg, j) for j in range(
            len(cfg.layer_pattern)))
        out += (f"; {n_moe} MoE layers: {m.num_experts} experts top-"
                f"{m.top_k}, d_ff_expert {m.d_ff_expert}, "
                f"{m.num_shared_experts} shared, capacity factor "
                f"{m.capacity_factor}")
    if "mamba" in cfg.layer_pattern:
        out += (f"; {cfg.n_groups * cfg.layer_pattern.count('mamba')} Mamba "
                f"layers: d_inner {cfg.mamba_expand * cfg.d_model}, state "
                f"{cfg.mamba_d_state}, conv {cfg.mamba_d_conv}")
    return out


def prefill_shares(bundle, params, batch) -> str:
    """One pallas prefill of ``batch`` timed with CUDA events, and the
    device time between events around the Mamba blocks, their scan
    (``associative_scan``, plain PyTorch), the MoE layers and their expert
    GEMMs (``torch.bmm``, plain PyTorch), each summed over the layers and
    given as a share of the prefill; empty for a model with neither."""
    import torch
    from repro_torch.models import mamba as MB
    from repro_torch.models import moe as MOE
    cfg = bundle.cfg
    if cfg.moe is None and "mamba" not in cfg.layer_pattern:
        return ""
    targets = {"Mamba blocks": (MB, "mamba_apply"),
               "their scan": (MB, "associative_scan"),
               "MoE layers": (MOE, "moe_apply"),
               "their expert GEMMs": (torch, "bmm")}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with torch.inference_mode(), uncounted(), span_times(targets) as spans:
        torch.cuda.synchronize()
        ev[0].record()
        bundle.prefill(params, batch, impl="pallas")
        ev[1].record()
    torch.cuda.synchronize()
    total = ev[0].elapsed_time(ev[1])
    parts = []
    for label, evs in spans.items():
        if evs:
            ms = sum(a.elapsed_time(b) for a, b in evs)
            parts.append(f"{label} {ms:.1f} ms ({ms / total:.0%}, "
                         f"{len(evs)} calls)")
    return (f"; one prefill timed by CUDA events {total:.1f} ms: "
            + ", ".join(parts))


def text_attn_phase(device, card: str, arch: str, paths: dict, *,
                    max_len: int, wrap: bool, seed: int = 0,
                    n_layers: int = 0, also=None):
    """Drive the text engine serving ``arch`` (gemma3-12b, h2o-danube-3-4b,
    and the other decoder families: jamba-v0.1-52b, kimi-k2-1t-a32b,
    llava-next-mistral-7b on tokens) at full width with seeded bf16
    weights on the card, its depth cut to ``n_layers`` where given (80 GB
    forces it; printed), under ``impl="pallas"``: 4 prompts of TEXT_PROMPT
    tokens through
    ``generate``, then prompts of 130 and 300 tokens through ``submit``,
    TEXT_TOKENS greedy tokens each, with caches of ``max_len`` positions;
    with ``wrap`` also a 1100-token prompt through an engine of max_len
    1152, whose 1024-slot ``swa`` rings wrap.  Checks the outputs, the
    kernels' launches per prefill (K2 once an ``attn`` / ``swa`` layer, K3
    once a layer with a dense FFN or a shared expert) and per decode step
    (K3 as often, K4's single-token form once a non-ring attention layer;
    a ``swa`` ring decodes in plain PyTorch; the routed experts and the
    Mamba scan launch no kernel), the captured decode steps against an
    eager decode loop token for token at batch 4, greedy == repeated
    prefill (near ties reported; with MoE on a bundle of the same weights
    that drops no assignment, :func:`moe_greedy`), and the
    pallas logits against the kernel-free routes on the card; times the
    prefill (with the shares of the Mamba blocks, their scan, the MoE
    layers and their expert GEMMs where there are any) and a decode step
    at batch 4 and 1 beside the weight bound.  Records the kernels' launch
    counts over the driven requests in ``paths`` under ``text {arch}``;
    ``also`` ({path: fn}) drives more paths on the same weights before they
    are freed, each recorded in ``paths`` as ``fn(bundle, params)``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.fused_ffn import ops as ff
    from repro_torch.models import transformer as T
    from repro_torch.models.model import build_model
    from repro_torch.serving import ServeRequest, create_engine
    from repro_torch.tree import leaves

    what = f"text {arch}"
    t_phase = time.perf_counter()
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=n_layers) if n_layers else full
    if n_layers:
        print(f"[chip_smoke] {what}: depth cut from {full.n_layers} to "
              f"{n_layers} layers ({cfg.n_groups} of {full.n_groups} "
              f"periods of {len(cfg.layer_pattern)}) to fit 80 GB; widths "
              f"as published")
    # the earlier phases' models go first, so that the graph bytes count
    # this engine's capture alone
    gc.collect()
    torch.cuda.synchronize(device)     # initializes CUDA when first
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    free0, total = torch.cuda.mem_get_info(device)

    def ring(kind):     # a ring decodes in plain PyTorch, without K4
        w = cfg.sliding_window if kind == "swa" else 0
        return bool(w) and T.cache_len(cfg, kind, max_len) <= w
    attn_kinds = [k for k in cfg.layer_pattern if k in ("attn", "swa")]
    n_k2 = cfg.n_groups * len(attn_kinds)
    n_attn = cfg.n_groups * sum(not ring(k) for k in attn_kinds)
    n_ffn = cfg.n_groups * len(T.dense_ffn_layers(cfg))
    t0 = time.perf_counter()
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator(device=device).manual_seed(seed),
                         device)
    eng = create_engine("text", bundle, params, batch=4, max_len=max_len,
                        device=device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    w_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    w_bound = w_bytes / HBM_BYTES_PER_S * 1e3
    m = eng.metrics()
    print(f"[chip_smoke] {what}: {cfg.n_layers} layers "
          f"{'/'.join(cfg.layer_pattern)}, d_model {cfg.d_model}, "
          f"{cfg.n_heads} x {cfg.head_dim} heads over {cfg.n_kv_heads} KV "
          f"heads, d_ff {cfg.d_ff} {cfg.activation}, window "
          f"{cfg.sliding_window}, vocab {cfg.vocab_size}, "
          f"{n_params / 1e9:.3f} B parameters bf16 ({w_bytes / 1e9:.2f} GB; "
          f"set-up {time.perf_counter() - t0:.1f}s; decode step captured "
          f"for {sorted(eng._graphs)} rows in "
          f"{m['text_graph_capture_s']:.2f}s, which left "
          f"{m['text_graph_bytes'] / 2**20:.1f} MiB reserved); {n_attn} "
          f"non-ring layers at max_len {max_len}{family_desc(cfg)}")
    rng = np.random.default_rng(seed + 17)
    prompts = [rng.integers(0, cfg.vocab_size, TEXT_PROMPT).astype(np.int32)
               for _ in range(4)]
    singles = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (130, 300)]
    kernels = counted_kernels()
    wrap_prompt = rng.integers(0, cfg.vocab_size, 1100).astype(np.int32)
    try:
        for kf in kernels.values():
            kf.launches = 0
        t1 = time.perf_counter()
        outs = eng.generate(prompts, n_tokens=TEXT_TOKENS)
        wall = time.perf_counter() - t1
        after_generate = {n: kf.launches for n, kf in kernels.items()}
        futs = [eng.submit(ServeRequest(history=p, n_tokens=TEXT_TOKENS))
                for p in singles]
        res = [f.result(timeout=600) for f in futs]
        wrap_res = None
        if wrap:
            with uncounted():      # its capture's warm-up calls
                eng2 = create_engine("text", bundle, params, batch=1,
                                     max_len=1152, device=device)
            try:
                wrap_res = eng2.submit(ServeRequest(
                    history=wrap_prompt, n_tokens=TEXT_TOKENS)).result(
                        timeout=600)
            finally:
                eng2.shutdown()
        launches = {n: kf.launches for n, kf in kernels.items()}
    finally:
        eng.shutdown()
    print(f"[chip_smoke] {what}: generate, 4 x {TEXT_PROMPT}-token prompts, "
          f"{TEXT_TOKENS} tokens each: {wall * 1e3:.1f} ms "
          f"({4 * TEXT_TOKENS / wall:.1f} generated tokens/s); {card}")
    done = list(zip(singles, res)) + (
        [(wrap_prompt, wrap_res)] if wrap else [])
    for p, r in done:
        t = r.timings
        print(f"[chip_smoke] {what}: submit, {len(p)}-token prompt"
              f"{' (max_len 1152: the swa rings wrap)' if len(p) > 1000 else ''}"
              f": prefill {t['prefill_s'] * 1e3:.1f} ms, decode "
              f"{t['decode_s'] * 1e3 / (TEXT_TOKENS - 1):.2f} ms per token, "
              f"latency {r.latency_s * 1e3:.1f} ms; {card}")
    for o in outs + [r.output for _, r in done]:
        if o.shape != (TEXT_TOKENS,) or o.min() < 0 \
                or o.max() >= cfg.vocab_size:
            fail(f"{what}: output {o.shape} [{o.min()}, {o.max()}] is not "
                 f"{TEXT_TOKENS} token ids")
    # launches: K2 once a layer per prefill and K3's kernels once a layer
    # per call (the wide form: two kernels a launch, ff.kernel_launches);
    # per decode step K3 once a layer and K4's single-token form once a
    # non-ring layer
    def k3(rows):
        return ff.kernel_launches(rows, cfg.d_model, f=cfg.d_ff,
                                  dtype=torch.bfloat16)
    n_pre, n_dec = len(done) + 1, (len(done) + 1) * (TEXT_TOKENS - 1)
    k3_gen = k3(4 * TEXT_PROMPT) + (TEXT_TOKENS - 1) * k3(4)
    want = {"flash_attention": n_k2 * n_pre,
            "fused_ffn": n_ffn * (k3_gen + sum(
                k3(len(p)) + (TEXT_TOKENS - 1) * k3(1) for p, _ in done)),
            "flash_decode single-token": n_attn * n_dec,
            "fused_score": 0, "flash_decode": 0, "rwkv6_scan": 0}
    want_gen = {"flash_attention": n_k2,
                "fused_ffn": n_ffn * k3_gen,
                "flash_decode single-token": n_attn * (TEXT_TOKENS - 1)}
    if launches != want or any(after_generate[n] != c
                               for n, c in want_gen.items()):
        fail(f"{what}: launches {launches} (generate alone "
             f"{after_generate}), want {want} (generate {want_gen})")
    print(f"[chip_smoke] {what}: launches {launches}: per prefill "
          f"{n_k2} K2 + {n_ffn} x {k3(4 * TEXT_PROMPT)} K3 "
          f"kernels, per decode step {n_ffn} x {k3(4)} K3 kernels + "
          f"{n_attn} K4 single-token ({n_pre} prefills, {n_dec} decode "
          f"steps; a wide-form K3 call is two kernels: stream and reduce, "
          f"or up and down GEMM)")
    text_attn_step_times(eng, bundle, params, prompts, outs, device, card,
                         what, max_len, w_bound,
                         roofline_cfg=cfg if arch in ROOFLINE_TEXT else None)
    # the engine's graphs go first: the f32 route and the MoE greedy check
    # need the room
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    if cfg.moe is None:
        gated = text_attn_greedy(bundle, params, res[0].output, singles[0],
                                 device, what)
        msg = f"{gated}/4 steps gated on the {len(singles[0])}-token prompt"
    else:
        msg = moe_greedy(cfg, params, singles[0], device, what)
    if wrap:
        gw = text_attn_greedy(bundle, params, wrap_res.output, wrap_prompt,
                              device, what)
        msg += f", {gw}/4 on the 1100-token prompt (the rings wrapped)"
    print(f"[chip_smoke] {what}: greedy == repeated prefill: {msg}; {card}")
    gates = text_attn_gates(bundle, params, singles[1], device, what)
    print(f"[chip_smoke] {what}: pallas logits vs the kernel-free routes on "
          f"the card ({len(singles[1])}-token prompt): {gates}")
    paths[what] = launches
    for name, fn in (also or {}).items():
        paths[name] = fn(bundle, params)
    del params, bundle
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[chip_smoke] {what}: phase {time.perf_counter() - t_phase:.1f}s"
          f", peak {torch.cuda.max_memory_allocated(device) / 1e9:.1f} GB "
          f"allocated of {free0 / 1e9:.1f} GB free at its start "
          f"({total / 1e9:.1f} GB on the card)")


def text_attn_step_times(eng, bundle, params, prompts, outs, device,
                         card: str, what: str, max_len: int,
                         w_bound: float, roofline_cfg=None):
    """The batched generate split in two, each alone: the prefill of the 4
    prompts under pallas (one eager call, host clock), and a decode step
    at batch 4 and at batch 1 (the engine's captured step replayed, CUDA
    events) beside the weight bound (every weight read once); also checks
    that the captured steps gave the greedy tokens ``outs`` of an eager
    decode loop (pallas) from the same prefill.  With ``roofline_cfg`` the
    batch-4 step is counted for :func:`roofline_phase` (the step's
    ``reference`` route on its own caches, fake tensors)."""
    import numpy as np
    import torch
    tok = torch.as_tensor(np.stack(prompts), dtype=torch.int64,
                          device=device)
    with torch.inference_mode(), uncounted():
        caches = bundle.cache_init(len(prompts), max_len, device=device)
        logits, filled = bundle.prefill(params, {"tokens": tok},
                                        impl="pallas", caches=caches)
        last = torch.argmax(logits[:, -1], dim=-1)
        del logits
        want, cur = [last], filled
        for i in range(TEXT_TOKENS - 1):
            lg, cur = bundle.decode_step(params, cur, {
                "tokens": last[:, None], "cur_index": torch.tensor(
                    tok.shape[1] + i, device=device)}, impl="pallas")
            last = torch.argmax(lg[:, -1], dim=-1)
            want.append(last)
        want = torch.stack(want, 1).cpu().numpy()
        if not np.array_equal(np.stack(outs), want):
            fail(f"{what}: the engine's captured decode tokens {outs} != the "
                 f"eager decode loop's {want.tolist()}")
        del cur, filled
        pre = host_ms(lambda: bundle.prefill(params, {"tokens": tok},
                                             impl="pallas"), reps=3, warm=1)
        shares = prefill_shares(bundle, params, {"tokens": tok})
        steps = {}
        for rows in (4, 1):
            g = eng._graphs[rows]
            g.load(g.caches, tok[:rows, 0], tok.shape[1])
            steps[rows] = call_ms(g.graph.replay, reps=20, warm=3)
    if roofline_cfg is not None:
        from repro_torch.types import ShapeConfig
        g = eng._graphs[4]
        roofline_note(
            f"{roofline_cfg.name} decode step (batch 4, caches of {max_len})",
            roofline_cfg, ShapeConfig(name=f"decode b4 @ {max_len}",
                                      seq_len=max_len, global_batch=4,
                                      kind="decode"),
            lambda c, t, cur: bundle.decode_step(
                params, c, {"tokens": t, "cur_index": cur},
                impl="reference"), (g.caches, g.tokens, g.cur), steps[4])
    print(f"[chip_smoke] {what}: captured decode == eager decode loop, "
          f"{len(prompts)} x {TEXT_TOKENS} greedy tokens")
    print(f"[chip_smoke] {what}: alone: prefill of 4 x {tok.shape[1]} "
          f"tokens {pre:.1f} ms (one eager call, host clock){shares}; "
          f"decode step "
          f"(captured, replayed) {steps[4]:.2f} ms at batch 4, "
          f"{steps[1]:.2f} ms at batch 1, against a weight bound of "
          f"{w_bound:.2f} ms ({w_bound / steps[4]:.0%} / "
          f"{w_bound / steps[1]:.0%} of it reached); {card}")


def counted_kernels():
    """The wrappers that count their kernels' launches, by the names of the
    ``kernels`` line (K4's two forms apart)."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.fused_ffn import ops as ff
    from repro_torch.kernels.fused_score import ops as fs
    from repro_torch.kernels.rwkv6_scan import ops as scan
    return {"fused_score": fs.fused_score,
            "flash_attention": fa.flash_attention,
            "fused_ffn": ff.fused_ffn_2d,
            "flash_decode": fd.flash_decode_with_self,
            "flash_decode single-token": fd.flash_decode,
            "rwkv6_scan": scan.rwkv6_scan}


def family_kernel_shapes(device, card: str) -> list:
    """K2, K3 and K4 at the shapes the other text families give them on
    the card, each against its plain version and timed beside its bound
    and its library call (the rows with the largest plain versions on
    fewer repeats).  K2: ``full`` with Sq != Sk (seamless's
    cross-attention, 32 queries over 1024 frames, the transpose, and an
    unaligned 37 x 1001), seamless's encoder (``full`` [4, 1024, 16, 64])
    and decoder (``causal`` [4, 32, 16, 64]), the ``causal`` prefills of
    jamba [4, 500, 32, 128], kimi [4, 500, 64, 112] (head dim 112 padded
    to 128), llama4 [4, 500, 40, 128], qwen2-72b [4, 500, 64, 128] and
    llava [4, 3380, 32, 128] over 8 KV heads and qwen1.5-32b [4, 500, 40,
    128] over 40; the cross-attention's two calls bitwise.  K3's wide form
    at each family's (d, d_ff, activation) at T 4 and its prefill T (2000;
    llava's 13,520, seamless's encoder 4096), qwen2-72b's (8192, 29568)
    and qwen1.5-32b's (5120, 27392) among them, its plan checked against
    the wrapper's workspace and launches.  K4's single-token form over 528
    keys at kimi's [4, 64, 112] over 8 KV heads (G * D = 1024, the
    wrapper's limit), llama4's [4, 40, 128] (G 5), qwen2-72b's [4, 64, 128]
    (G 8) and qwen1.5-32b's [4, 40, 128] over 40 KV heads (G 1)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.fused_ffn import ops as ff
    from repro_torch.kernels.padding import padded_dim

    g = torch.Generator(device=device).manual_seed(23)

    def rn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, device=device)
                ).to(torch.bfloat16)

    rows = []
    for b, sq, sk, h, hkv, d, mode, who in (
            (4, 32, 1024, 16, 16, 64, "full", "seamless cross-attention"),
            (4, 1024, 32, 16, 16, 64, "full", "Sq > Sk"),
            (2, 37, 1001, 16, 16, 64, "full", "unaligned"),
            (4, 1024, 1024, 16, 16, 64, "full", "seamless encoder"),
            (4, 32, 32, 16, 16, 64, "causal", "seamless decoder"),
            (4, 500, 500, 32, 8, 128, "causal", "jamba"),
            (4, 500, 500, 64, 8, 112, "causal", "kimi"),
            (4, 500, 500, 40, 8, 128, "causal", "llama4"),
            (4, 500, 500, 64, 8, 128, "causal", "qwen2-72b"),
            (4, 500, 500, 40, 40, 128, "causal", "qwen1.5-32b"),
            (4, 3380, 3380, 32, 8, 128, "causal", "llava, 2880 patches")):
        q, k, v = rn(b, sq, h, d), rn(b, sk, hkv, d), rn(b, sk, hkv, d)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        pairs = sq * sk if mode == "full" else sq * (sq + 1) // 2
        big = sq * sk * h >= 100_000_000
        if mode == "full" and sq != sk:
            with uncounted():
                if not torch.equal(fa.flash_attention(q, k, v, mode),
                                   fa.flash_attention(q, k, v, mode)):
                    fail(f"K2 full {sq} x {sk}: two calls differ")
        rows.append(text_shape_row(
            f"K2 {mode} {who} q {list(q.shape)} k/v {list(k.shape)} (head "
            f"dim {d}{'' if padded_dim(d, fa.HEAD_DIMS) == d else f' padded to {padded_dim(d, fa.HEAD_DIMS)}'}"
            f"; grid {fa.plan(q)['grid']})",
            lambda: fa.flash_attention(q, k, v, mode),
            lambda: fa.flash_attention_plain(q, k, v, mode),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=mode == "causal", enable_gqa=True),
            bound(nbytes(q, k, v, q), 4 * b * h * d * pairs), card,
            quick=big))
        del q, k, v, qt, kt, vt
    print("[chip_smoke] family shapes: K2 full Sq != Sk: two calls bitwise "
          "at 32 x 1024, 1024 x 32 and 37 x 1001")
    for d, f, act, ts in ((4096, 14336, "swiglu", (4, 2000, 13520)),
                          (7168, 2048, "swiglu", (4, 2000)),
                          (5120, 8192, "swiglu", (4, 2000)),
                          (8192, 29568, "swiglu", (4, 2000)),
                          (5120, 27392, "swiglu", (4, 2000)),
                          (1024, 8192, "gelu", (4, 128, 4096))):
        wu, wd = rn(d, f, scale=d ** -0.5), rn(f, d, scale=f ** -0.5)
        wg = rn(d, f, scale=d ** -0.5) if act == "swiglu" else None

        def chain(x, wu=wu, wd=wd, wg=wg, act=act):
            if act == "swiglu":
                return (F.silu(x @ wg) * (x @ wu)) @ wd
            return F.gelu(x @ wu, approximate="tanh") @ wd
        for t in ts:
            x = rn(t, d)
            p = ff.plan(x, wu, activation=act)
            ws = ff.wide_workspace_bytes(t, d, f)
            k3 = ff.kernel_launches(t, d, f=f, dtype=x.dtype)
            if p["workspace_bytes"] != ws or p["kernels"] != \
                    ff.kernel_launches(min(t, ff.WIDE_ROWS), d, f=f,
                                       dtype=x.dtype) or \
                    p["launches"] != k3:
                fail(f"K3 {act} d {d} T={t}: the library's plan {p} "
                     f"disagrees with the wrapper's workspace ({ws} B) or "
                     f"kernels ({k3})")
            rows.append(text_shape_row(
                f"K3 {act} x [{t}, {d}] d_ff {f} (wide form, {p['path']} "
                f"path: grids {p['grid']}, {p['stages']} ring stages, "
                f"workspace {ws / 1e6:.1f} MB, {p['launches']} kernels a "
                f"call)",
                lambda x=x: ff.fused_ffn_2d(x, wu, wd, wg, activation=act),
                lambda x=x: ff.fused_ffn_plain(x, wu, wd, wg,
                                               activation=act),
                lambda x=x: chain(x),
                bound(nbytes(x, wu, wd, wg, x),
                      2 * t * d * f * (3 if act == "swiglu" else 2)), card,
                quick=t * d * f > 10 ** 11))
            del x
        del wu, wd, wg
    for h, hkv, d in ((64, 8, 112), (40, 8, 128), (64, 8, 128),
                      (40, 40, 128)):
        b, s = 4, 528
        q, kc, vc = rn(b, h, d), rn(b, s, hkv, d), rn(b, s, hkv, d)
        lens = torch.tensor([528, 517, 300, 130], dtype=torch.int32,
                            device=device)
        lmask = (torch.arange(s, device=device)[None, :]
                 < lens[:, None].long())[:, None, None, :]
        qq, kk, vv = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
        valid = int(lens.long().sum())
        p = fd.plan(q, kc, self_slot=False)
        rows.append(text_shape_row(
            f"K4 single-token q {list(q.shape)} over caches "
            f"{list(kc.shape)} (G {h // hkv}; head dim {d} padded to "
            f"{padded_dim(d, fd.HEAD_DIMS)}, G*D "
            f"{h // hkv * padded_dim(d, fd.HEAD_DIMS)}; lengths "
            f"{lens.tolist()}; grid {p['grid']}, {p['smem_bytes']} B "
            f"shared)",
            lambda: fd.flash_decode(q, kc, vc, lens),
            lambda: fd.flash_decode_plain(q, kc, vc, lens),
            lambda: F.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=lmask, enable_gqa=True),
            bound(2 * valid * hkv * d * kc.element_size()
                  + nbytes(q, lens, q), 4 * h * d * valid), card))
    return rows




def bundle_decode_path(bundle, params, batch, device, card: str, what: str,
                       *, max_len: int, want: dict, cache_kw=None,
                       lead: int = 0) -> dict:
    """Drive a bundle outside the engine on the card under pallas: one
    batch-4 prefill of ``batch`` into caches of ``max_len``, then
    TEXT_TOKENS eager greedy decode steps; checks the launches against
    ``want`` ({kernel: count}), the tokens, the pallas logits against the
    kernel-free routes (the prefill's row 0 against ``chunked``, the first
    step against ``reference`` from cloned caches; mean gated) and greedy
    == repeated prefill on row 0; times the prefill (host clock, a second
    call) and an eager decode step.  Returns the launch counts."""
    import torch
    from repro_torch.tree import tree_map
    cache_kw = cache_kw or {}
    kernels = counted_kernels()
    b, s = batch["tokens"].shape
    with torch.inference_mode():
        for kf in kernels.values():
            kf.launches = 0
        t0 = time.perf_counter()
        caches = bundle.cache_init(b, max_len, device=device, **cache_kw)
        logits, caches = bundle.prefill(params, batch, impl="pallas",
                                        caches=caches)
        last = torch.argmax(logits[:, -1], dim=-1)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        filled = tree_map(torch.clone, caches)
        del logits
        toks = [last]
        t1 = time.perf_counter()
        for i in range(TEXT_TOKENS):
            lg, caches = bundle.decode_step(params, caches, {
                "tokens": last[:, None], "cur_index": torch.tensor(
                    lead + s + i, device=device)}, impl="pallas")
            last = torch.argmax(lg[:, -1], dim=-1)
            toks.append(last)
        torch.cuda.synchronize()
        t_dec = (time.perf_counter() - t1) / TEXT_TOKENS
        launches = {n: kf.launches for n, kf in kernels.items()}
        out = torch.stack(toks, 1).cpu().numpy()
    full = {n: want.get(n, 0) for n in kernels}
    if launches != full:
        fail(f"{what}: launches {launches}, want {full}")
    vocab = bundle.cfg.vocab_size
    if out.shape != (b, TEXT_TOKENS + 1) or out.min() < 0 \
            or out.max() >= vocab:
        fail(f"{what}: tokens {out.shape} [{out.min()}, {out.max()}] are "
             f"not {TEXT_TOKENS + 1} token ids a row")
    print(f"[chip_smoke] {what}: launches {launches} (one prefill, "
          f"{TEXT_TOKENS} decode steps); first prefill {t_first * 1e3:.1f} ms, "
          f"eager decode {t_dec * 1e3:.2f} ms a step (host clock); {card}")
    one = {n: t[:1] for n, t in batch.items()}
    with torch.inference_mode(), uncounted():
        pre = host_ms(lambda: bundle.prefill(params, batch, impl="pallas"),
                      reps=2, warm=0)
        step = {"tokens": torch.as_tensor(out[:, :1], device=device),
                "cur_index": torch.tensor(lead + s, device=device)}
        work = tree_map(torch.clone, filled)
        dec = call_ms(lambda: bundle.decode_step(params, work, step,
                                                 impl="pallas"),
                      reps=10, warm=2)
        del work
        gates = [_logits_check(
            bundle.prefill(params, one, impl="pallas"),
            bundle.prefill(params, one, impl="chunked"), what,
            "prefill row 0 (chunked)")]
        lp, _ = bundle.decode_step(params, tree_map(torch.clone, filled),
                                   step, impl="pallas")
        lr, _ = bundle.decode_step(params, tree_map(torch.clone, filled),
                                   step, impl="reference")
        gates.append(_logits_check(lp, lr, what, "decode step (reference)"))
        del filled, lp, lr
    extra = {n: t for n, t in one.items() if n != "tokens"}
    gated = text_attn_greedy(bundle, params, out[0],
                             one["tokens"][0].tolist(), device, what,
                             extra=extra)
    print(f"[chip_smoke] {what}: alone: prefill of {b} x {lead + s} "
          f"positions {pre:.1f} ms (host clock); a decode step (eager, "
          f"batch {b}) {dec:.2f} ms; pallas vs the kernel-free routes: "
          f"{'; '.join(gates)} (gate: mean <= {TEXT_BF16_MEAN_TOL}); greedy "
          f"== repeated prefill on row 0: {gated}/4 steps gated; {card}")
    return launches


def vlm_patch_path(device, card: str):
    """The vision branch on the card (``also`` of llava's text phase): 4
    rows of FRONTEND stub patch embeddings (anyres, 5 x 576; seeded) and
    TEXT_PROMPT tokens through the bundle's prefill under pallas (K2 at S
    3380 once a layer, K3 at T 13,520), then TEXT_TOKENS eager decode
    steps over 3396 keys (K3 and K4 once a layer each)."""
    def run(bundle, params):
        import torch
        from repro_torch.kernels.fused_ffn import ops as ff
        cfg = bundle.cfg
        p, s, b = cfg.frontend_tokens, TEXT_PROMPT, 4
        g = torch.Generator(device=device).manual_seed(31)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                         generator=g, device=device),
                 "patch_embeds": torch.randn(
                     b, p, cfg.d_model, generator=g,
                     device=device).to(torch.bfloat16)}
        n = cfg.n_layers
        k3 = sum(n_k3 * ff.kernel_launches(rows, cfg.d_model, f=cfg.d_ff,
                                           dtype=torch.bfloat16)
                 for n_k3, rows in ((1, b * (p + s)), (TEXT_TOKENS, b)))
        return bundle_decode_path(
            bundle, params, batch, device, card,
            f"vlm {cfg.name} with {p} patches", lead=p,
            max_len=p + s + TEXT_TOKENS,
            want={"flash_attention": n, "fused_ffn": n * k3,
                  "flash_decode single-token": n * TEXT_TOKENS})
    return run


def audio_phase(device, card: str, seed: int = 0):
    """seamless-m4t-large-v2 at full width (12 encoder + 12 decoder
    layers, d_model 1024, 16 x 64 heads, d_ff 8192 gelu, vocab 256206;
    seeded bf16 weights) through its bundle on the card under pallas: 4
    rows of ``_frames_for(cfg, 4096)`` = 1024 stub frame embeddings
    (seeded) and a 32-token target prefix, then TEXT_TOKENS eager greedy
    decode steps.  Per prefill K2 36 times (12 encoder ``full``, 12 decoder
    ``causal``, 12 cross-attention ``full`` with Sq 32 != Sk 1024) and K3
    24 times; per decode step K3 12 times and no K4 (a decode step's
    attention is ``decode_attention`` under every impl, as in the JAX
    package).  Returns the launch counts."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.fused_ffn import ops as ff
    from repro_torch.models.model import _frames_for, build_model
    from repro_torch.tree import leaves
    arch = "seamless-m4t-large-v2"
    what = f"audio {arch}"
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator(device=device).manual_seed(seed),
                         device)
    torch.cuda.synchronize()
    n_frames, s, b = _frames_for(cfg, 4096), 32, 4
    w_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    print(f"[chip_smoke] {what}: {cfg.n_enc_layers} encoder + "
          f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} x {cfg.head_dim} heads, d_ff {cfg.d_ff} "
          f"{cfg.activation}, {cfg.norm}, vocab {cfg.vocab_size}, "
          f"{sum(t.numel() for t in leaves(params)) / 1e9:.3f} B parameters "
          f"bf16 ({w_bytes / 1e9:.2f} GB; set-up "
          f"{time.perf_counter() - t_phase:.1f}s); nothing cut; {n_frames} "
          f"stub frames and a {s}-token target prefix a row")
    g = torch.Generator(device=device).manual_seed(seed + 41)
    batch = {"frames": torch.randn(b, n_frames, cfg.d_model, generator=g,
                                   device=device).to(torch.bfloat16),
             "tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                                     device=device)}
    n_e, n_d = cfg.n_enc_layers, cfg.n_layers

    def k3(rows):
        return ff.kernel_launches(rows, cfg.d_model, f=cfg.d_ff,
                                  dtype=torch.bfloat16)
    launches = bundle_decode_path(
        bundle, params, batch, device, card, what,
        max_len=s + TEXT_TOKENS, cache_kw={"n_frames": n_frames},
        want={"flash_attention": n_e + 2 * n_d,
              "fused_ffn": n_e * k3(b * n_frames) + n_d * (
                  k3(b * s) + TEXT_TOKENS * k3(b))})
    del bundle, params, batch
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[chip_smoke] {what}: phase {time.perf_counter() - t_phase:.1f}s")
    return launches


# ---------------------------------------------------------------------------
# training: Climber and h2o-danube-3-4b at full width, then Climber served
# from its checkpoint
# ---------------------------------------------------------------------------

TRAIN_LOSS_TOL = 5e-3       # step 0's loss, card vs the CPU plain path
TRAIN_NORM_RTOL = 2e-2      # step 0's global grad norm, relative
# h2o's peak learning rate: AdamWConfig's default.  At the launcher's 1e-3
# (warm-up 5) the loss of the full-width model rises after the warm-up
# (10.98 -> 11.20 in 10 steps on an H100), and the JAX package's rises the
# same way at full width (cut to one layer, on the CPU, step for step with
# the port), so that rate would gate the reference's own dynamics
H2O_LR = "3e-4"


def climber_flops(cfg, params, batch: int, n_history: int,
                  n_cand: int) -> float:
    """6 * N * tokens of one Climber train step, N counting only the
    weights the step multiplies (not the embedding table or the positional
    table, which are gathered): each block's weights over its sequence
    (history window + side token + candidates), the side projection once
    per user, the fusion and multi-task head once per candidate."""
    from repro_torch.tree import leaves
    c = cfg.climber
    seq = n_history // c.num_blocks + 1 + n_cand
    total = 0.0
    for name, sub in params.items():
        n = sum(t.numel() for t in leaves(sub))
        if name in ("embed", "pos_embed"):
            continue
        if name == "blocks":
            total += 6 * n * batch * seq
        elif name == "side_proj":
            total += 6 * n * batch
        else:
            total += 6 * n * batch * n_cand
    return total


def train_numbers(out, what: str, card: str, flops: float,
                  work: float, unit: str) -> dict:
    """Print the step's numbers from ``launch.train.main``'s result: the
    medians of steps 3 onward (CUDA events), the rate, the FLOPs share of
    the bf16 peak, the peak memory."""
    import numpy as np
    steady = out["step_times"][3:]
    step = float(np.median([t["step_ms"] for t in steady]))
    fb = float(np.median([t["fwd_bwd_ms"] for t in steady]))
    opt = float(np.median([t["opt_ms"] for t in steady]))
    share = flops / (step * 1e-3) / BF16_FLOP_PER_S
    print(f"[chip_smoke] {what}: step {step:.2f} ms (median of steps "
          f"3-{len(out['step_times']) - 1}; forward + backward {fb:.2f} ms, "
          f"AdamW {opt:.2f} ms, CUDA events), {work / (step * 1e-3):.1f} "
          f"{unit}/s, 6*N*tokens {flops / 1e12:.2f} TFLOP a step = "
          f"{share * 100:.1f}% of 989 TFLOP/s bf16, peak memory "
          f"{out['peak_bytes'] / 1e9:.2f} GB ({card})")
    return {"step_ms": step, "fwd_bwd_ms": fb, "opt_ms": opt, "share": share}


def train_losses(hist, what: str, *, tail: int):
    """Gate the logged losses: all finite, and the mean of the last
    ``tail`` below that of the first ``tail``."""
    import numpy as np
    losses = np.array([h["loss"] for h in hist])
    if not np.isfinite(losses).all():
        fail(f"{what}: a loss is not finite: {losses.tolist()}")
    first, last = losses[:tail].mean(), losses[-tail:].mean()
    if not last < first:
        fail(f"{what}: the loss did not fall (first {tail} {first:.4f}, "
             f"last {tail} {last:.4f})")
    print(f"[chip_smoke] {what}: losses " + " ".join(
        f"{x:.4f}" for x in losses) + f" (mean of the first {tail} "
        f"{first:.4f} > of the last {tail} {last:.4f})")


def loss_and_norm(bundle, params, batch, impl: str, grads: bool):
    """(loss, global grad norm or None) of ``bundle.loss_fn`` at
    ``params`` (the leaves made to require grad when ``grads``)."""
    import torch
    from repro_torch.training.loop import grads_of
    from repro_torch.training.optimizer import global_norm
    from repro_torch.tree import leaves
    if not grads:
        with torch.no_grad():
            return float(bundle.loss_fn(params, batch, impl=impl)[0]), None
    for p in leaves(params):
        p.requires_grad_(True)
    loss, _ = bundle.loss_fn(params, batch, impl=impl)
    norm = float(global_norm(grads_of(loss, params)))
    for p in leaves(params):
        p.requires_grad_(False)
    return float(loss.detach()), norm


def step0_check(what: str, bundle, params, batch_np, impl: str, device,
                *, grads: bool, cut: str):
    """Step 0's loss (and grad norm) on the card against the port's plain
    path on the CPU, from the same weights and batch."""
    import torch
    from repro_torch.training.loop import to_device
    from repro_torch.tree import params_to
    t0 = time.perf_counter()
    card_loss, card_norm = loss_and_norm(
        bundle, params, to_device(batch_np, device), impl, grads)
    cpu_loss, cpu_norm = loss_and_norm(
        bundle, params_to(params, "cpu"), to_device(batch_np, "cpu"), impl,
        grads)
    err = abs(card_loss - cpu_loss)
    if not err <= TRAIN_LOSS_TOL:
        fail(f"{what}: step 0's loss {card_loss:.6f} on the card vs "
             f"{cpu_loss:.6f} on the CPU ({cut}): {err:.3g} > "
             f"{TRAIN_LOSS_TOL}")
    line = (f"[chip_smoke] {what}: step 0 on {cut}: loss {card_loss:.6f} on "
            f"the card, {cpu_loss:.6f} on the CPU plain path (|diff| "
            f"{err:.3g} <= {TRAIN_LOSS_TOL})")
    if grads:
        rel = abs(card_norm - cpu_norm) / cpu_norm
        if not rel <= TRAIN_NORM_RTOL:
            fail(f"{what}: step 0's grad norm {card_norm:.6f} on the card "
                 f"vs {cpu_norm:.6f} on the CPU: relative {rel:.3g} > "
                 f"{TRAIN_NORM_RTOL}")
        line += (f"; global grad norm {card_norm:.6f} / {cpu_norm:.6f} "
                 f"(relative {rel:.3g} <= {TRAIN_NORM_RTOL})")
    print(line + f" ({time.perf_counter() - t0:.1f}s)")


def train_roofline(what: str, cfg, bundle, params, dataset, batch_kw,
                   batch: int, seq: int, n_cand: int, step_ms: float,
                   device):
    """Count one training step's forward + backward (``loss_fn`` under
    ``reference``, gradients of every leaf; fake tensors) on the
    launcher's first batch, for :func:`roofline_phase` beside the step's
    measured median.  AdamW runs no matrix product: its traffic is in the
    estimate's optimizer term.  Climber is analysed as a scorer
    (:func:`climber_analysis_cfg`) with its real weight bytes, all of which
    AdamW reads and writes."""
    import torch
    from repro_torch.data import make_batch_iterator
    from repro_torch.training.loop import to_device
    from repro_torch.tree import leaves
    from repro_torch.types import ShapeConfig
    first = to_device(next(make_batch_iterator(dataset, batch, **batch_kw)),
                      device)

    def fwd_bwd(p, b):
        ps = leaves(p)
        for t in ps:
            t.requires_grad_(True)
        loss, _ = bundle.loss_fn(p, b, impl="reference")
        return torch.autograd.grad(loss, ps)
    climber = cfg.family == "climber"
    roofline_note(
        f"{what} (batch {batch} x {seq}"
        + (f" + {n_cand} candidates)" if climber else " tokens)"),
        climber_analysis_cfg(cfg) if climber else cfg,
        ShapeConfig(name=f"train b{batch} x {seq}", seq_len=seq,
                    global_batch=batch, kind="train", n_candidates=n_cand),
        fwd_bwd, (params, first), step_ms,
        params_bytes=weight_bytes(params, skip=()) if climber else None,
        train=True)


def train_climber(device, card: str, buckets, tmp: str) -> dict:
    """(a): Climber at its published width trained through
    ``launch.train.main`` (batch 16, 512 history items and 64 candidates
    a user, 30 steps, ``impl="reference"``) into a checkpoint; the loss
    gates and step 0 against the CPU; the checkpoint restored bitwise and
    served through the flame engine (``engine_phase``: int8 pool, fused,
    its traffic and checks).  Returns the serving path's launch counts."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import GRInteractionDataset, make_batch_iterator
    from repro_torch.launch import train as train_launcher
    from repro_torch.training import checkpoint
    from repro_torch.tree import leaves
    what = "train climber"
    batch, seq, steps = 16, 512, 30
    n_cand = max(4, seq // 8)
    path = os.path.join(tmp, "climber.msgpack")
    t0 = time.perf_counter()
    out = train_launcher.main(["--arch", "climber", "--batch", str(batch),
                               "--seq", str(seq), "--steps", str(steps),
                               "--ckpt", path])
    cfg, bundle, params = out["cfg"], out["bundle"], out["params"]
    print(f"[chip_smoke] {what}: {steps} steps through launch.train in "
          f"{time.perf_counter() - t0:.1f}s ({out['impl']}, batch {batch}, "
          f"{seq} history items + {n_cand} candidates a user; checkpoint "
          f"{os.path.getsize(path) / 1e9:.2f} GB)")
    train_losses(out["history"], what, tail=5)
    nums = train_numbers(out, what, card,
                         climber_flops(cfg, params, batch, seq, n_cand),
                         batch * n_cand, "user-item pairs")
    train_roofline(what, cfg, bundle, params, GRInteractionDataset(
        n_items=cfg.vocab_size), dict(n_history=seq, n_candidates=n_cand),
        batch, seq, n_cand, nums["step_ms"], device)
    restored, step = checkpoint.restore(path, params)
    if step != steps or not all(
            torch.equal(a, b) for a, b in zip(leaves(restored),
                                              leaves(params))):
        fail(f"{what}: the checkpoint (step {step}) does not restore the "
             f"trained params bitwise")
    print(f"[chip_smoke] {what}: checkpoint.restore gives the trained "
          f"params bitwise (step {step})")
    del out, params
    # step 0 again from the same seeds (launch.train's), 2 users cut
    init = bundle.init(torch.Generator(device=device).manual_seed(0),
                       device)
    first = next(make_batch_iterator(GRInteractionDataset(
        n_items=cfg.vocab_size), batch, n_history=seq, n_candidates=n_cand))
    step0_check(what, bundle, init, {k: v[:2] for k, v in first.items()},
                "reference", device, grads=True, cut="2 of the 16 users")
    del init
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[chip_smoke] {what}: serving the restored checkpoint")
    return engine_phase(get_config("climber"), device, n_history=seq,
                        buckets=buckets, params=restored)


def train_h2o(device, card: str):
    """(b): h2o-danube-3-4b at full width and depth through
    ``launch.train.main`` (batch 8, 512 tokens, peak lr ``H2O_LR``,
    warm-up 5, 10 steps, ``impl="chunked"``, the layer groups
    recomputed); the loss gates; step 0's loss on 2 layers of the same
    weights, a [1, 128] batch, against the CPU."""
    import torch
    from repro_torch.data import TokenDataset, make_batch_iterator
    from repro_torch.launch import train as train_launcher
    from repro_torch.models.model import build_model
    from repro_torch.tree import leaves, tree_map
    what = "train h2o-danube-3-4b"
    batch, seq, steps = 8, 512, 10
    t0 = time.perf_counter()
    out = train_launcher.main([
        "--arch", "h2o-danube-3-4b", "--batch", str(batch), "--seq",
        str(seq), "--steps", str(steps), "--lr", H2O_LR])
    cfg, bundle, params = out["cfg"], out["bundle"], out["params"]
    n_params = sum(t.numel() for t in leaves(params))
    print(f"[chip_smoke] {what}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {n_params / 1e9:.3f} B parameters (tied "
          f"embeddings), {steps} steps at batch {batch} x {seq} tokens in "
          f"{time.perf_counter() - t0:.1f}s ({out['impl']}, remat, peak lr "
          f"{H2O_LR}, warm-up 5)")
    train_losses(out["history"], what, tail=1)
    nums = train_numbers(out, what, card, 6.0 * n_params * batch * seq,
                         batch * seq, "tokens")
    train_roofline(what, cfg, bundle, params, TokenDataset(
        vocab_size=cfg.vocab_size, branching=8), dict(seq_len=seq), batch,
        seq, 0, nums["step_ms"], device)
    del out, params
    gc.collect()
    torch.cuda.empty_cache()
    # step 0's weights again (launch.train's seed), cut to 2 layers
    init = bundle.init(torch.Generator(device=device).manual_seed(0),
                       device)
    cut = dataclasses.replace(cfg, n_layers=2)
    init["stack"]["layers"] = tree_map(lambda a: a[:2].clone(),
                                       init["stack"]["layers"])
    gc.collect()
    torch.cuda.empty_cache()
    first = next(make_batch_iterator(TokenDataset(
        vocab_size=cfg.vocab_size, branching=8), 1, seq_len=128))
    step0_check(what, build_model(cut), init, first, "chunked", device,
                grads=False, cut="2 of 24 layers, a [1, 128] batch")
    del init
    gc.collect()
    torch.cuda.empty_cache()


def train_pallas_raises(device):
    """(c): a loss under ``impl="pallas"`` raises on the card when the
    weights require grad (the kernels have no backward)."""
    import torch
    from repro_torch.configs import reduced_config
    from repro_torch.models.model import build_model
    from repro_torch.tree import leaves
    bundle = build_model(reduced_config("h2o-danube-3-4b"))
    params = bundle.init(torch.Generator(device=device).manual_seed(0),
                         device)
    for p in leaves(params):
        p.requires_grad_(True)
    batch = {"tokens": torch.randint(0, 512, (2, 64), device=device)}
    try:
        bundle.loss_fn(params, batch, impl="pallas")
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
        print(f"[chip_smoke] train: a loss under impl='pallas' with "
              f"weights requiring grad raises: {e}")
    else:
        fail("a loss under impl='pallas' with weights requiring grad did "
             "not raise")


def train_phase(device, card: str, buckets) -> dict:
    """Training, then Climber served from its checkpoint: (a), (b), (c).
    Returns the serving path's launch counts."""
    import tempfile
    import torch
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        launches = train_climber(device, card, buckets, tmp)
    train_h2o(device, card)
    train_pallas_raises(device)
    print(f"[chip_smoke] train: phase {time.perf_counter() - t0:.1f}s")
    return launches


# ---------------------------------------------------------------------------
# the fixed executor pool (paper Fig 10) at Climber's width
# ---------------------------------------------------------------------------

DSO_POOL_TOL = 5e-3         # pooled fused chunks vs one eager reference call
DSO_COUNTS = (128, 256, 512, 1024)        # bench_dso.py's mixed traffic
DSO_JITTER = (40, 77, 130, 300, 1000)     # its non-bucket-aligned counts
DSO_REQUESTS = 16


def dso_pool_phase(cfg, device, card: str, *, n_history: int, buckets,
                   seed: int = 0) -> dict:
    """The paper's own DSO design at the published Climber width: the
    pool-off ``full`` family under ``impl="fused"`` (K2) as an
    ``ExecutorPool`` over ``buckets`` with 2 executors a bucket (each its
    own CUDA-graph capture on its own stream), behind a
    ``DynamicStreamOrchestrator`` with 8 workers.  Traffic: bench_dso's mix
    at full width, M uniform over DSO_COUNTS and DSO_JITTER (each once, the
    rest drawn), 16 requests submitted at once, the counts set to 0 just
    before and read just after.  Gates: every request's scores within
    DSO_POOL_TOL of one eager call of its whole M under ``reference`` (no
    kernel); no executor checked out by two threads at once (eids tracked
    at acquire and release); K2 launched n_layers times a chunk and no
    other kernel.  Prints each M's time through the pool (host clock, the
    request alone) beside the implicit engine's (its capture in band, then
    a replay) and the padded fraction.  Returns the launch counts."""
    import threading

    import numpy as np
    import torch
    from repro_torch.core import climber as C
    from repro_torch.core import dso as DSO
    from repro_torch.kernels import _build
    from repro_torch.types import TensorSpec

    what = "dso pool"
    t0 = time.perf_counter()
    params = C.climber_init(
        cfg, torch.Generator(device=device).manual_seed(seed), device)
    bundle = C.build_climber(cfg)
    n_layers = cfg.climber.num_blocks * cfg.climber.layers_per_block

    def fn(history, candidates, side):
        return bundle.prefill(params, {"history": history,
                                       "candidates": candidates,
                                       "side": side}, impl="fused")

    def build_fn(bucket):
        return fn, (TensorSpec((1, n_history), torch.int32),
                    TensorSpec((1, bucket), torch.int32),
                    TensorSpec((1, C.N_SIDE_FEATURES), torch.float32))

    def pad_slice(request, chunk):
        hist, cands, side = request
        sl = cands[:, chunk.start:chunk.start + chunk.valid]
        if chunk.valid < chunk.bucket:    # padding rows: item 0, ignored
            sl = np.pad(sl, ((0, 0), (0, chunk.bucket - chunk.valid)))
        return hist, sl, side

    def gather(results, chunks, m):
        return np.concatenate([r[:, :c.valid]
                               for r, c in zip(results, chunks)], axis=1)

    pool = DSO.ExecutorPool(build_fn, buckets, n_streams=2, device=device)
    held, clash, lock = set(), [], threading.Lock()
    acquire, release = pool.acquire, pool.release

    def tracked_acquire(bucket):
        ex = acquire(bucket)
        with lock:
            if ex.eid in held:
                clash.append(ex.eid)
            held.add(ex.eid)
        return ex

    def tracked_release(ex):
        with lock:
            held.discard(ex.eid)
        release(ex)
    pool.acquire, pool.release = tracked_acquire, tracked_release
    orch = DSO.DynamicStreamOrchestrator(pool, pad_slice, gather,
                                         max_workers=8)
    rng = np.random.default_rng(seed + 26)
    choices = DSO_COUNTS + DSO_JITTER
    ms = list(choices) + [int(m) for m in rng.choice(
        choices, DSO_REQUESTS - len(choices))]
    rng.shuffle(ms)
    reqs = [(rng.integers(0, cfg.vocab_size, (1, n_history)).astype(np.int32),
             rng.integers(0, cfg.vocab_size, (1, m)).astype(np.int32),
             rng.normal(size=(1, C.N_SIDE_FEATURES)).astype(np.float32))
            for m in ms]
    for ex in pool.executors:
        if ex.graph is None or ex.launches != {"flash_attention": n_layers}:
            fail(f"{what}: executor {ex.eid} (bucket {ex.bucket}) captured "
                 f"{ex.graph is not None}, launches a replay {ex.launches}, "
                 f"want a graph of {n_layers} K2")
    if len({id(ex.stream) for ex in pool.executors}) != len(pool.executors):
        fail(f"{what}: two executors share a stream")
    print(f"[chip_smoke] {what}: ExecutorPool buckets {tuple(pool.buckets)} "
          f"x 2 executors (own capture, own stream), built in "
          f"{pool.build_time_s:.2f}s; DynamicStreamOrchestrator, 8 workers; "
          f"M {ms}")
    orch.score(reqs[0], ms[0])                      # warm the path once
    chunks0 = orch.chunk_count
    _build.add_launches({k: -v for k, v in _build.launch_counts().items()})
    t1 = time.perf_counter()
    futs = [orch.submit(r, m) for r, m in zip(reqs, ms)]
    outs = [f.result() for f in futs]
    wall = time.perf_counter() - t1
    counts = _build.launch_counts()
    chunks = orch.chunk_count - chunks0
    want = {k: 0 for k in counts}
    want["flash_attention"] = n_layers * chunks
    if counts != want:
        fail(f"{what}: launches {counts} over {chunks} chunks, want {want}")
    if clash or held:
        fail(f"{what}: executors {sorted(set(clash))} were checked out by "
             f"two threads at once, or {sorted(held)} never came back")
    worst = 0.0
    with torch.inference_mode(), uncounted():
        for (h, c, sd), m, out in zip(reqs, ms, outs):
            n_tasks = cfg.climber.num_tasks
            if out.shape != (1, m, n_tasks) or not np.isfinite(out).all():
                fail(f"{what}: M {m}: output {out.shape} not finite "
                     f"[1, {m}, {n_tasks}]")
            ref = bundle.prefill(params, {
                "history": torch.from_numpy(h).to(device),
                "candidates": torch.from_numpy(c).to(device),
                "side": torch.from_numpy(sd).to(device)},
                impl="reference").float().cpu().numpy()
            err = float(np.abs(out.astype(np.float32) - ref).max())
            worst = max(worst, err)
            if not err <= DSO_POOL_TOL:
                fail(f"{what}: M {m}: pooled scores {err:.3g} from one eager "
                     f"reference call of the whole M (> {DSO_POOL_TOL})")
    print(f"[chip_smoke] {what}: {DSO_REQUESTS} requests at once in "
          f"{wall * 1e3:.1f} ms (host clock), {chunks} chunks, {counts} "
          f"launches; scores within {worst:.3g} of one eager reference call "
          f"of each whole M (<= {DSO_POOL_TOL}); no executor held twice")
    implicit = DSO.ImplicitShapeEngine(fn, device)
    for m in sorted(set(ms)):
        req = reqs[ms.index(m)]
        with uncounted():
            pooled = host_ms(lambda: orch.score(req, m), reps=5, warm=1)
            t2 = time.perf_counter()
            implicit.score(req, m)
            torch.cuda.synchronize()
            first = (time.perf_counter() - t2) * 1e3
            again = host_ms(lambda: implicit.score(req, m), reps=5, warm=1)
        print(f"[chip_smoke] {what}: M {m}: through the pool {pooled:.2f} ms "
              f"({len(DSO.split_request(m, buckets))} chunks, padded "
              f"fraction {DSO.padded_fraction(m, buckets):.3f}); implicit "
              f"engine first call {first:.1f} ms (capture in band), then "
              f"{again:.2f} ms (host clock, median of 5; {card})")
    orch.shutdown()
    print(f"[chip_smoke] {what}: implicit engine {implicit.compiles} "
          f"captures, {implicit.capture_s:.2f}s, "
          f"{implicit.graph_bytes / 2**20:.1f} MiB; phase "
          f"{time.perf_counter() - t0:.1f}s")
    del pool, orch, implicit, params
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# sharded serving: FlameEngine(mesh=...) on this card
# ---------------------------------------------------------------------------

MESH_TOL = 5e-3     # a model-parallel mesh vs one rank (the JAX (2, 2) tol)
MESH_CP_TOL = 1e-4  # context-parallel attention vs one rank, f32 operands
#: h2o-danube-3-4b's attention at a 512-token prefill; its window (4096)
#: exceeds each rank's 256 rows (the gather path), so 128 runs the halo
MESH_CP_SHAPE = ((4, 512, 32, 120), (4, 512, 8, 120))
MESH_CP_MODES = (("sliding", 4096), ("sliding", 128), ("causal", 0))
#: (run, mesh, engine options) of the two gloo ranks sharing the card
MESH_RUNS = (("fused 1x2", "1,2", dict(impl="fused", history_cache=True)),
             ("fused 1x2 native", "1,2", dict(impl="fused",
                                              history_cache=True,
                                              pool_dtype="native")),
             ("pallas full 1x2", "1,2", dict(impl="pallas",
                                             history_cache=False,
                                             buckets=(128,))),
             ("fused 2x1", "2,1", dict(impl="fused", history_cache=True)))


def mesh_traffic(n_history: int, vocab: int, seed: int):
    """Four users' first requests (128 and 96 candidates: misses,
    encodes), then users 0 and 1 again with new slates (pool hits)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    hist = [rng.integers(0, vocab, n_history).astype(np.int32)
            for _ in range(4)]
    return [(u, hist[u], rng.integers(0, vocab, m).astype(np.int32))
            for u, m in ((0, 128), (1, 96), (2, 128), (3, 96), (0, 96),
                         (1, 128))]


def mesh_engine_kw(n_history: int, seed: int, **kw):
    from repro_torch.core.pda import RemoteFeatureStore
    base = dict(n_history=n_history, buckets=(128, 64, 32), max_batch=4,
                pool_dtype="int8", n_streams=1,
                store=RemoteFeatureStore(feature_dim=12, latency_s=0.0,
                                         seed=seed))
    base.update(kw)
    return base


def mesh_serve(eng, traffic):
    """Every request served alone, in order; the scores, concatenated."""
    import numpy as np
    return np.concatenate([eng.serve(h, c, user_id=u).ravel()
                           for u, h, c in traffic])


def mesh_counts(reset: bool = False) -> dict:
    counted = counted_kernels()
    if reset:
        for w in counted.values():
            w.launches = 0
    return {k: w.launches for k, w in counted.items() if w.launches}


def mesh_rank(rank: int, job_dir: str):
    """One of the gloo ranks sharing the card (spawned by
    ``launch.mesh.run_ranks``): each run of MESH_RUNS, then
    context-parallel attention; saves what it found as ``rank<r>.pt``."""
    import torch
    from repro_torch import sharding as shd
    from repro_torch.core import climber as C
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import attention as A
    from repro_torch.serving.engine import FlameEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    job = torch.load(os.path.join(job_dir, "job.pt"), weights_only=False)
    device, cfg = job["device"], job["cfg"]
    params = C.climber_init(cfg, torch.Generator(device=device).manual_seed(
        job["seed"]), device)
    bundle = C.build_climber(cfg)
    res = {}
    for name, shape, kw in MESH_RUNS:
        mesh = make_serving_mesh(shape, device=device)
        ekw = mesh_engine_kw(job["n_history"], job["seed"], device=device,
                             **kw)
        t0 = time.perf_counter()
        eng = FlameEngine(bundle, params, mesh=mesh, **ekw)
        mesh_counts(reset=True)
        try:
            if mesh.leader:
                out, metrics = mesh_serve(eng, job["traffic"]), eng.metrics()
            else:
                eng.follow()
                out = metrics = None
        finally:
            eng.shutdown()
        res[name] = dict(out=out, metrics=metrics, launches=mesh_counts(),
                         wall_s=time.perf_counter() - t0)
    del params
    mesh = make_serving_mesh("1,2", device=device)
    with shd.mesh_rules(mesh):
        q, k, v = (shd.local_shard(job[n], (None, "model"), mesh,
                                   mesh.coords).to(device) for n in "qkv")
        for mode, window in MESH_CP_MODES:
            res[("cp", mode, window)] = A.context_parallel_attention(
                q, k, v, mode, window=window).cpu()
    torch.save(res, os.path.join(job_dir, f"rank{rank}.pt"))


def mesh_phase(cfg, device, card: str, *, n_history: int, seed: int = 0,
               tmp: str, backend: str = "nccl") -> dict:
    """Sharded serving on this card at Climber's published width (bf16,
    int8 pool, buckets (128, 64, 32), max_batch 4).

    (a) one rank in process, an NCCL group of one, mesh (1, 1), fused:
        scores bitwise the mesh-less engine's, K1 / K2 launches per
        dispatch equal, every executor captured;
    (b) two gloo ranks sharing the card: (1, 2) fused within MESH_TOL of
        (a) with the pool bytes per shard halved, K1 / K2 launched at 2
        local heads on each rank, over the int8 pool and over a bf16
        (native) one; the pallas pool-off ``full`` family at b128 within
        MESH_TOL of one rank, K3 at local d_ff 512; (2, 1) fused bitwise
        (a); ``context_parallel_attention`` over (1, 2) at
        h2o-danube-3-4b's prefill shapes against one rank.
    The kernel phases hold K1-K3 against their plain versions at these
    local dims (MESH_LOCAL_HEADS, MESH_LOCAL_FFN).  Printed beside the
    mesh's errors: how far two routes of one rank (fused with the int8
    pool, pallas pool-off) part, the size of a bf16 reassociation at this
    depth.
    Returns the kernels' launches over (a)'s mesh engine and (b)'s runs
    (both ranks)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import climber as C
    from repro_torch.launch.mesh import make_serving_mesh, run_ranks
    from repro_torch.models import attention as A
    from repro_torch.serving import create_engine

    t_phase = time.perf_counter()
    traffic = mesh_traffic(n_history, cfg.vocab_size, seed)
    params = C.climber_init(
        cfg, torch.Generator(device=device).manual_seed(seed), device)
    bundle = C.build_climber(cfg)
    n_layers = cfg.climber.num_blocks * cfg.climber.layers_per_block

    def run(name, mesh=None, **kw):
        eng = create_engine("flame", bundle, params, mesh=mesh, device=device,
                            **mesh_engine_kw(n_history, seed, **kw))
        mesh_counts(reset=True)     # the captures' warm-ups launched too
        try:
            out = mesh_serve(eng, traffic)
            m = eng.metrics()
        finally:
            eng.shutdown()
        launches = mesh_counts()
        for kind, kernel in (("encode", "flash_attention"),
                             ("cached", "fused_score"),
                             ("full", "flash_attention")):
            n = m.get(f"dso_dispatches_{kind}", 0)
            if n and launches.get(kernel, 0) != n_layers * n:
                fail(f"mesh {name}: {launches.get(kernel, 0)} {kernel} "
                     f"launches over {n} {kind} dispatches, want "
                     f"{n_layers} a dispatch")
        if not np.isfinite(out).all():
            fail(f"mesh {name}: scores not finite")
        return out, m, launches

    # (a) an NCCL group of one rank, mesh (1, 1)
    dist.init_process_group(backend, init_method="file://" + os.path.join(
        tmp, "mesh-nccl-1"), rank=0, world_size=1)
    try:
        base, bm, bl = run("none", impl="fused", history_cache=True)
        native, nm, _ = run("none native", impl="fused",
                            history_cache=True, pool_dtype="native")
        full, _, _ = run("none full", impl="pallas", history_cache=False,
                         buckets=(128,))
        mesh = make_serving_mesh("1,1")
        one, om, ol = run("(1, 1)", mesh=mesh, impl="fused",
                          history_cache=True)
    finally:
        dist.destroy_process_group()
    if not np.array_equal(one, base):
        fail(f"mesh (1, 1): scores differ from the mesh-less engine "
             f"(max {np.abs(one - base).max():.3g})")
    if om["dso_captured"] != 1 or ol != bl:
        fail(f"mesh (1, 1): captured {om['dso_captured']}, launches {ol} "
             f"vs mesh-less {bl}")
    print(f"[chip_smoke] mesh (a): NCCL group of 1, mesh (1, 1), fused: "
          f"{len(traffic)} requests bitwise the mesh-less engine, launches "
          f"{ol} ({n_layers} a dispatch), executors captured; pool bytes "
          f"shard0 {om['pool_bytes_shard0']}; one rank's routes part by "
          f"{float(np.abs(full - base).max()):.3g} (fused int8 pool vs "
          f"pallas pool-off), its pools by "
          f"{float(np.abs(native - base).max()):.3g} (bf16 vs int8)")
    del params
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # (b) two gloo ranks sharing this card
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in (MESH_CP_SHAPE[0],) + (MESH_CP_SHAPE[1],) * 2)
    job_dir = os.path.join(tmp, "mesh")
    os.makedirs(job_dir, exist_ok=True)
    torch.save(dict(seed=seed, n_history=n_history, traffic=traffic, q=q,
                    k=k, v=v, device=device, cfg=cfg),
               os.path.join(job_dir, "job.pt"))
    t0 = time.perf_counter()
    run_ranks(mesh_rank, 2, backend="gloo", args=(job_dir,), timeout_s=300,
              init_dir=job_dir)
    ranks = [torch.load(os.path.join(job_dir, f"rank{r}.pt"),
                        weights_only=False) for r in range(2)]
    spawn_s = time.perf_counter() - t0
    want = {"fused 1x2": (base, MESH_TOL),
            "fused 1x2 native": (native, MESH_TOL),
            "pallas full 1x2": (full, MESH_TOL),
            "fused 2x1": (base, 0.0)}
    counts = {}
    for name, shape, kw in MESH_RUNS:
        r0 = ranks[0][name]
        m, out = r0["metrics"], r0["out"]
        ref, tol = want[name]
        err = float(np.abs(out - ref).max())
        if not err <= tol:
            fail(f"mesh {name}: max abs err {err:.3g} vs one rank > {tol}")
        kinds = [k for k in ("encode", "cached", "full")
                 if m.get(f"dso_dispatches_{k}", 0)]
        per = {}
        for r in range(2):
            got = ranks[r][name]["launches"]
            for kind in kinds:
                kernel = {"cached": "fused_score"}.get(kind,
                                                      "flash_attention")
                n = m[f"dso_dispatches_{kind}"]
                if got.get(kernel, 0) != n_layers * n:
                    fail(f"mesh {name}: rank {r} launched "
                         f"{got.get(kernel, 0)} {kernel} over {n} {kind} "
                         f"dispatches, want {n_layers} a dispatch")
            if kw["impl"] == "pallas" and got.get("fused_ffn", 0) != \
                    n_layers * m["dso_dispatches_full"]:
                fail(f"mesh {name}: rank {r} launched "
                     f"{got.get('fused_ffn', 0)} fused_ffn")
            for kname, n in got.items():
                counts[kname] = counts.get(kname, 0) + n
                per[f"{kname} rank{r}"] = n
        one = nm if kw.get("pool_dtype") == "native" else bm
        if kw["history_cache"] and shape == "1,2" and \
                2 * m["pool_bytes_shard0"] != one["pool_bytes"]:
            fail(f"mesh {name}: pool bytes per shard "
                 f"{m['pool_bytes_shard0']}, one rank {one['pool_bytes']}")
        if m["dso_captured"] != 0:
            fail(f"mesh {name}: gloo executors reported captured")
        coll = {k[5:]: v for k, v in m.items() if k.startswith("mesh_")
                and not k.endswith("ways") and k != "mesh_header_bytes"}
        times = ", ".join(f"{k} {m[f'dso_dispatch_ms_{k}']:.2f} ms"
                          for k in kinds)
        print(f"[chip_smoke] mesh (b) {name}: max abs err {err:.3g} vs one "
              f"rank (tol {tol}); launches {per}; collectives {coll}; "
              f"pool bytes per shard {m.get('pool_bytes_shard0', '-')}; per "
              f"dispatch ({times}; 2 ranks sharing one card, gloo, eager — "
              f"no multi-card number; {card}); rank 0 wall "
              f"{r0['wall_s']:.1f}s")
    # context parallelism against one rank
    worst = {}
    with torch.inference_mode():
        qd, kd, vd = (t.to(device) for t in (q, k, v))
        for mode, window in MESH_CP_MODES:
            ref = A.reference_attention(qd, kd, vd, mode,
                                        window=window).cpu()
            out = torch.cat([ranks[r][("cp", mode, window)]
                             for r in range(2)], dim=1)
            err = float((out - ref).abs().max())
            if not err <= MESH_CP_TOL:
                fail(f"mesh cp {mode} {window}: max abs err {err:.3g} > "
                     f"{MESH_CP_TOL}")
            worst[f"{mode} {window}"] = err
    print(f"[chip_smoke] mesh (b) context_parallel_attention (1, 2) at "
          f"q {MESH_CP_SHAPE[0]} k/v {MESH_CP_SHAPE[1]} f32 vs one rank: "
          f"max abs err {worst} (tol {MESH_CP_TOL}); 2 ranks spawned and "
          f"done in {spawn_s:.1f}s")
    print(f"[chip_smoke] mesh phase {time.perf_counter() - t_phase:.1f}s")
    for kname, n in ol.items():
        counts[kname] = counts.get(kname, 0) + n
    return counts


# ---------------------------------------------------------------------------
# the text families sharded: bundle.prefill / decode_step on a rank's blocks
# ---------------------------------------------------------------------------

#: (arch, layers kept: one period; rwkv two layers) at full width
TEXT_MESH_MODELS = (("gemma3-12b", 6), ("rwkv6-7b", 2),
                    ("jamba-v0.1-52b", 8))
TEXT_MESH_MESHES = ("1,2", "2,1")
TEXT_MESH_PROMPT = 128
TEXT_MESH_STEPS = 4
TEXT_MESH_BATCH = 2
#: at batch 1 under the long-context rules (the caches' positions split
#: over data and model): K4 on each rank's slice, the softmaxes merged
TEXT_MESH_LONG = ("gemma3-12b", 6)
#: the runs whose MoE layers route on their own (the others replay the
#: baseline's expert choices): the flipped routes are counted
TEXT_MESH_OWN_ROUTES = (("jamba-v0.1-52b", "2,1"),)


def text_mesh_cases():
    """(arch, layers, batch, mesh) of every sharded run."""
    cases = [(arch, n, TEXT_MESH_BATCH, spec) for arch, n in TEXT_MESH_MODELS
             for spec in TEXT_MESH_MESHES]
    return cases + [TEXT_MESH_LONG + (1, spec) for spec in TEXT_MESH_MESHES]


def text_mesh_cfg(arch: str, n_layers: int):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), n_layers=n_layers)


def text_mesh_counts(cfg, data: int, model: int, batch: int,
                     decode: bool) -> dict:
    """The collectives of one sharded forward (FSDP off, weights resident
    in their tensor-parallel blocks): ``transformer.forward_collectives``,
    the caches' positions split over data and model at batch 1."""
    from repro_torch.models.transformer import forward_collectives
    seq = ("data", "model") if batch == 1 else ()
    return forward_collectives(cfg, data, model, fsdp=False, decode=decode,
                               seq=seq)


def text_mesh_want(cfg, data: int, model: int, batch: int) -> dict:
    """K2 / K3 / K4 / K5 launches of one prefill and one decode step of a
    rank under pallas: K3's kernels a call as its plan gives them at the
    rank's rows and d_ff block; caches of TEXT_MESH_PROMPT +
    TEXT_MESH_STEPS positions (a ``swa`` layer's ring of min(window,
    max_len) slots decodes in plain PyTorch).  At batch 1 the rows are
    whole on every rank."""
    import torch
    from repro_torch.kernels.fused_ffn import ops as ff
    from repro_torch.models import transformer as T
    max_len = TEXT_MESH_PROMPT + TEXT_MESH_STEPS
    n = cfg.n_groups
    rows = batch // data if batch > 1 else 1
    f = cfg.d_ff // model if cfg.d_ff % model == 0 else cfg.d_ff

    def k3(t):
        return ff.kernel_launches(t, cfg.d_model, f=f, dtype=torch.bfloat16)
    attn = [k for k in cfg.layer_pattern if k in ("attn", "swa")]
    ring = sum(k == "swa" and cfg.sliding_window
               and T.cache_len(cfg, k, max_len) <= cfg.sliding_window
               for k in attn)
    ffn = n * len(T.dense_ffn_layers(cfg))
    rwkv = n * sum(k == "rwkv" for k in cfg.layer_pattern)
    pre = {"flash_attention": n * len(attn),
           "fused_ffn": ffn * k3(rows * TEXT_MESH_PROMPT),
           "rwkv6_scan": rwkv}
    step = {"fused_ffn": ffn * k3(rows),
            "flash_decode single-token": n * (len(attn) - ring)}
    return ({k: v for k, v in pre.items() if v},
            {k: v for k, v in step.items() if v})


@contextlib.contextmanager
def kernel_dims():
    """Inside the block each kernel wrapper a text forward reaches records
    the dims it was handed (local heads, local d_ff) in the yielded dict."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.fused_ffn import ops as ff
    from repro_torch.models import rwkv6 as R
    seen = {}

    def shim(mod, name, key, dims):
        orig = getattr(mod, name)

        def call(*a, **kw):
            seen.setdefault(key, set()).add(dims(*a))
            return orig(*a, **kw)
        # a wrapper counts its launches on its module's name for it: the
        # shim carries the count while it stands there
        call.launches = getattr(orig, "launches", 0)
        return mod, name, orig, call
    patches = [
        shim(fa, "flash_attention", "flash_attention",
             lambda q, k, *_: (q.shape[2], k.shape[2], q.shape[3])),
        shim(fd, "flash_decode", "flash_decode single-token",
             lambda q, k, *_: (q.shape[1], k.shape[2], q.shape[2])),
        shim(ff, "fused_ffn", "fused_ffn",
             lambda x, p, *_: (x.shape[-1], p["w_up"].shape[-1])),
        shim(R, "rwkv6_scan", "rwkv6_scan",
             lambda r, *_: (r.shape[2], r.shape[3]))]
    for mod, name, _, call in patches:
        setattr(mod, name, call)
    try:
        yield seen
    finally:
        for mod, name, orig, call in patches:
            setattr(mod, name, orig)
            if hasattr(orig, "launches"):
                orig.launches = call.launches


def text_mesh_baseline(cfg, device, seed: int, batch: int, replay=None,
                       feed=None):
    """The mesh-less pallas route on the card: prefill into caches and
    TEXT_MESH_STEPS greedy steps (or the tokens of ``feed``); a dict of
    the prompt, the logits per phase on the host, the tokens fed, the MoE
    layers' expert choices in call order (``replay``'s where given) and,
    replaying, each choice's gap below the route's own
    (:func:`moe_routing`)."""
    import numpy as np
    import torch
    from repro_torch.models.model import build_model
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator(device=device).manual_seed(seed),
                         device)
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, TEXT_MESH_PROMPT))).to(device)
    caches = bundle.cache_init(batch, TEXT_MESH_PROMPT + TEXT_MESH_STEPS,
                               device=device)
    outs, fed, gaps = [], [], []
    with torch.inference_mode(), moe_routing(replay, gaps) as routes:
        logits, caches = bundle.prefill(params, {"tokens": toks},
                                        impl="pallas", caches=caches)
        for i in range(TEXT_MESH_STEPS + 1):
            outs.append(logits.float().cpu())
            if i == TEXT_MESH_STEPS:
                break
            tok = (logits[:, -1:].float().argmax(-1) if feed is None
                   else feed[i].to(device))
            fed.append(tok.cpu())
            logits, caches = bundle.decode_step(
                params, caches, {"tokens": tok,
                                 "cur_index": TEXT_MESH_PROMPT + i},
                impl="pallas")
    del params, caches
    gc.collect()
    torch.cuda.empty_cache()
    return dict(tokens=toks.cpu(), logits=outs, fed=fed,
                routes=[r.cpu() for r in routes], gaps=gaps)


def text_mesh_rank(rank: int, job_dir: str):
    """One of two gloo ranks sharing the card: for each case of
    :func:`text_mesh_cases`, the full weights made from the seed on the
    card one rank at a time, the rank's tensor-parallel blocks kept
    (``shard_params`` under ``rules_for_shape(fsdp=False)``), then
    ``bundle.prefill`` into its caches and the decode steps (the
    baseline's greedy tokens fed) under pallas inside ``mesh_rules``;
    saves logits, collectives, launches, the kernels' dims and the MoE
    layers' expert choices as ``rank<r>.pt``."""
    import torch
    import torch.distributed as dist
    from repro_torch import sharding as shd
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models.model import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    job = torch.load(os.path.join(job_dir, "job.pt"), weights_only=False)
    device = job["device"]
    res = {}
    for arch, n_layers, batch, spec in text_mesh_cases():
        cfg = text_mesh_cfg(arch, n_layers)
        bundle = build_model(cfg)
        logical = shd.param_logical(bundle)
        base = job["base"][(arch, batch)]
        mesh = make_serving_mesh(spec, device=device)
        rules = shd.rules_for_shape(mesh, batch, fsdp=False)
        local = None
        for turn in range(2):           # one full copy at a time
            if turn == rank:
                full = bundle.init(torch.Generator(
                    device=device).manual_seed(job["seed"]), device)
                local = shd.shard_params(full, logical, mesh, mesh.coords,
                                         rules)
                del full
                gc.collect()
                torch.cuda.empty_cache()
            dist.barrier()
        rows = shd.logical_to_spec(("batch",), (batch,), mesh, rules)

        def mine(t):
            return shd.local_shard(t, rows, mesh, mesh.coords).to(device)

        def block(t, lg):
            return shd.local_shard(t, shd.logical_to_spec(
                lg, t.shape, mesh, rules), mesh, mesh.coords
            ).contiguous().to(device)
        whole = bundle.cache_init(batch, TEXT_MESH_PROMPT + TEXT_MESH_STEPS,
                                  device="cpu")
        lgs = bundle.cache_logical()
        caches = {k: {n: block(t, lgs[k][n]) for n, t in v.items()}
                  for k, v in whole.items()}
        out = {"logits": [], "counts": [], "launches": [], "ms": []}
        toks = mine(base["tokens"])
        # every rank routes every token (the experts whole, or the tokens
        # gathered for the rank's block of them): the baseline's choices
        own = (arch, spec) in TEXT_MESH_OWN_ROUTES
        replay = None if own else [r.to(device) for r in base["routes"]]
        with torch.inference_mode(), shd.mesh_rules(mesh, rules), \
                kernel_dims() as dims, moe_routing(replay) as routes:
            counted = counted_kernels()     # the shims where patched
            for i in range(TEXT_MESH_STEPS + 1):
                c0 = shd.counts()
                for w in counted.values():
                    w.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if i == 0:
                    logits, caches = bundle.prefill(
                        local, {"tokens": toks}, impl="pallas",
                        caches=caches)
                else:
                    logits, caches = bundle.decode_step(
                        local, caches, {
                            "tokens": mine(base["fed"][i - 1]),
                            "cur_index": TEXT_MESH_PROMPT + i - 1},
                        impl="pallas")
                torch.cuda.synchronize()
                out["ms"].append((time.perf_counter() - t0) * 1e3)
                out["launches"].append({k: w.launches for k, w in
                                        counted.items() if w.launches})
                out["counts"].append({k: v - c0.get(k, 0) for k, v in
                                      shd.counts().items()
                                      if v != c0.get(k, 0)})
                out["logits"].append(logits.float().cpu())
        out["dims"] = dims
        out["routes"] = [r.cpu() for r in routes] if own else []
        res[(arch, batch, spec)] = out
        del local, caches
        gc.collect()
        torch.cuda.empty_cache()
    torch.save(res, os.path.join(job_dir, f"rank{rank}.pt"))


def text_mesh_phase(device, card: str, *, tmp: str, seed: int = 0) -> dict:
    """The text families' sharded forwards on this card, as JAX's dry run
    calls them: two gloo ranks sharing the card run ``bundle.prefill``
    into caches and TEXT_MESH_STEPS decode steps inside
    ``sharding.mesh_rules`` on their blocks under ``impl="pallas"``, on
    the (1, 2) and (2, 1) meshes, at full width (bf16, seeded weights):
    gemma3-12b one period (5 ``swa`` + 1 ``attn``: K2 at 8 local heads, K3
    at local d_ff 7680, K4 single-token), rwkv6-7b two layers (K5 at 32
    local heads), jamba-v0.1-52b one period of 8 (Mamba, MoE, ``attn``),
    at batch 2 (FSDP off); and gemma3 at batch 1 under the long-context
    rules, its ``attn`` cache's positions split over both ranks (K4 on
    each rank's slice with its log-sum-exp, the softmaxes merged).
    Checks against the mesh-less pallas route on the card: the
    rank-gathered logits within a mean TEXT_BF16_MEAN_TOL of the mean
    |logit|; the greedy tokens equal (the baseline's fed to both), a flip
    passing only where the baseline's top-2 gap is under TIE_GAP (reported
    as a tie); each kernel's launches per prefill and per step and the
    dims it was handed (the local heads / d_ff); the collectives per
    prefill and per step against :func:`text_mesh_counts`.  The MoE runs
    replay the baseline's expert choices (:func:`moe_routing`: a flip of
    a near tie spreads through Mamba's recurrence to every later
    position), except those of TEXT_MESH_OWN_ROUTES: they route on their
    own, and are compared with a mesh-less run that replays their choices,
    every choice that run would not have made itself gated within TIE_GAP
    of its own in router logits, the count reported.  Returns both ranks'
    launches."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import run_ranks

    t_phase = time.perf_counter()
    base = {}
    for arch, n_layers, batch, _ in text_mesh_cases():
        if (arch, batch) not in base:
            base[(arch, batch)] = text_mesh_baseline(
                text_mesh_cfg(arch, n_layers), device, seed, batch)
    t_base = time.perf_counter() - t_phase
    job_dir = os.path.join(tmp, "text_mesh")
    os.makedirs(job_dir, exist_ok=True)
    torch.save(dict(seed=seed, device=device,
                    base={k: {n: v for n, v in b.items()
                              if n not in ("logits", "gaps")}
                          for k, b in base.items()}),
               os.path.join(job_dir, "job.pt"))
    t0 = time.perf_counter()
    run_ranks(text_mesh_rank, 2, backend="gloo", args=(job_dir,),
              timeout_s=400, init_dir=job_dir)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(job_dir, f"rank{r}.pt"),
                        weights_only=False) for r in range(2)]
    launches = {}
    for arch, n_layers, batch, spec in text_mesh_cases():
        cfg = text_mesh_cfg(arch, n_layers)
        data, model = (int(x) for x in spec.split(","))
        want_pre, want_step = text_mesh_want(cfg, data, model, batch)
        what = f"text mesh {arch} batch {batch} ({spec})"
        outs = [ranks[r][(arch, batch, spec)] for r in range(2)]
        ref_logits = base[(arch, batch)]["logits"]
        routing = ("routes replayed" if cfg.moe is not None
                   and (arch, spec) not in TEXT_MESH_OWN_ROUTES else "")
        if (arch, spec) in TEXT_MESH_OWN_ROUTES:
            # the mesh-less route replays the sharded run's own choices:
            # each choice it would not have made itself must be a near tie
            # (within TIE_GAP of its own k-th choice in router logits)
            own = text_mesh_baseline(cfg, device, seed, batch,
                                     replay=[r.to(device)
                                             for r in outs[0]["routes"]],
                                     feed=base[(arch, batch)]["fed"])
            ref_logits = own["logits"]
            gap = torch.cat([g.reshape(-1) for g in own["gaps"]])
            if not float(gap.max()) < TIE_GAP:
                fail(f"{what}: the sharded router chose an expert "
                     f"{float(gap.max()):.3g} below the mesh-less one's "
                     f"k-th choice (>= {TIE_GAP}) in router logits")
            routing = (f"own routes: {int((gap > 0).sum())} of "
                       f"{gap.numel()} token routings differ from the "
                       f"mesh-less router's, the widest "
                       f"{float(gap.max()):.3g} below its k-th choice")
        notes, ties = [], []
        for i in range(TEXT_MESH_STEPS + 1):
            parts = [o["logits"][i] for o in outs]
            if batch > 1 and data > 1:      # each rank its rows
                got = torch.cat(parts)
            else:
                if not torch.equal(parts[0], parts[1]):
                    fail(f"{what}: the ranks' logits of the same rows "
                         f"differ")
                got = parts[0]
            ref = ref_logits[i]
            note = _logits_check(got, ref, what + f" phase {i}",
                                 "sharded vs mesh-less")
            if i in (0, TEXT_MESH_STEPS):
                notes.append(f"phase {i}: {note}")
            # greedy: the next token of every row
            top2 = ref[:, -1].topk(2, dim=-1).values
            for row in range(got.shape[0]):
                gap = float(top2[row, 0] - top2[row, 1])
                if int(got[row, -1].argmax()) == int(ref[row, -1].argmax()):
                    continue
                if not gap < TIE_GAP:
                    fail(f"{what}: phase {i} row {row}: greedy token "
                         f"{int(got[row, -1].argmax())} vs "
                         f"{int(ref[row, -1].argmax())} at a top-2 gap "
                         f"{gap:.3g} >= {TIE_GAP}")
                ties.append(f"phase {i} row {row} gap {gap:.3g}")
        for r, o in enumerate(outs):
            for i, (l_, c) in enumerate(zip(o["launches"], o["counts"])):
                want = want_pre if i == 0 else want_step
                if l_ != want:
                    fail(f"{what}: rank {r} phase {i} launches {l_}, "
                         f"want {want}")
                wc = text_mesh_counts(cfg, data, model, batch, i > 0)
                if c != wc:
                    fail(f"{what}: rank {r} phase {i} collectives {c}, "
                         f"want {wc}")
                for k, n in l_.items():
                    launches[k] = launches.get(k, 0) + n
        dims = outs[0]["dims"]
        h_loc = cfg.n_heads // model if cfg.n_heads % model == 0 \
            else cfg.n_heads
        g = cfg.n_heads // cfg.n_kv_heads
        kv_loc = (cfg.n_kv_heads // model if cfg.n_kv_heads % model == 0
                  else h_loc // g if h_loc % g == 0 else 1)
        # at batch 1 a decode attends the rank's positions with every head
        dec = ((cfg.n_heads, cfg.n_kv_heads) if batch == 1
               else (h_loc, kv_loc))
        want_dims = {
            "flash_attention": {(h_loc, kv_loc, cfg.head_dim)},
            "flash_decode single-token": {dec + (cfg.head_dim,)},
            "fused_ffn": {(cfg.d_model, cfg.d_ff // model)},
            "rwkv6_scan": {(cfg.d_model // cfg.rwkv_head_size // model,
                            cfg.rwkv_head_size)}}
        for k, got_dims in dims.items():
            if got_dims != want_dims[k]:
                fail(f"{what}: {k} handed dims {sorted(got_dims)}, want "
                     f"{sorted(want_dims[k])}")
        for k in set(want_pre) | set(want_step):
            if k not in dims:
                fail(f"{what}: {k} was never handed its dims")
        ms = outs[0]["ms"]
        print(f"[chip_smoke] {what}: {cfg.n_layers} layers at full width, "
              f"pallas; {'; '.join(notes)}; greedy flips at ties "
              f"{ties or 'none'}" + (f"; {routing}" if routing else "")
              + f"; launches per prefill {outs[0]['launches'][0]}, per "
              f"step {outs[0]['launches'][1]}; dims {dict(dims)}; "
              f"collectives per prefill {outs[0]['counts'][0]}, per step "
              f"{outs[0]['counts'][1]}; rank 0 prefill {ms[0]:.1f} ms, "
              f"step {np.median(ms[2:]):.1f} ms (2 ranks sharing one card, "
              f"gloo, eager; {card})")
    print(f"[chip_smoke] text mesh phase {time.perf_counter() - t_phase:.1f}s"
          f" (baselines {t_base:.1f}s, 2 ranks spawned and done in "
          f"{spawn_s:.1f}s)")
    return launches


# ---------------------------------------------------------------------------
# the sharded train step on this card
# ---------------------------------------------------------------------------

#: (arch, layers, weights' dtype): full width, the depth cut to 2 layers
#: (two gloo ranks and the mesh-less baseline share one card); the MoE
#: families train on the CPU alone (tests/test_torch_train_tp.py): their
#: full-width layer does not fit twice on one card.  rwkv6-7b trains in
#: f32: its bf16 step-0 gradient at full width is set by rounding
#: (measured with scripts/train_grad_probe.py: 72-80% from the f32 one in
#: several leaves, its norm 3.8-4.0% apart between two summation orders;
#: JAX's bf16 gradient is as far from its f32 one at d_model 4096), so a
#: 1e-2 gate on it would gate the rounding
TRAIN_MESH_MODELS = (("h2o-danube-3-4b", 2, "bfloat16"),
                     ("rwkv6-7b", 2, "float32"))
TRAIN_MESH_MESHES = ("1,2", "2,1")
TRAIN_MESH_BATCH, TRAIN_MESH_SEQ, TRAIN_MESH_STEPS = 2, 256, 5
#: step 0's loss and grad norm (``make_train_step``'s), sharded vs
#: mesh-less on the card
TRAIN_MESH_TOL = 1e-2


def train_mesh_setup(arch: str, n_layers: int, seed: int):
    """(cfg, bundle, AdamW config, the batch on the host) of a case: the
    default rate (3e-4) from the first step (warm-up 1)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import AdamWConfig
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_MESH_BATCH, TRAIN_MESH_SEQ)))
    return cfg, build_model(cfg), AdamWConfig(warmup_steps=1), tokens


def train_mesh_init(bundle, dtype: str, device, seed: int):
    """The case's seeded weights on ``device`` in ``dtype``."""
    import torch
    from repro_torch.tree import tree_map
    params = bundle.init(torch.Generator(device=device).manual_seed(seed),
                         device)
    return tree_map(lambda t: t.to(getattr(torch, dtype)), params)


def train_mesh_steps(step, params, opt, batch, device) -> dict:
    """TRAIN_MESH_STEPS steps of ``step`` on one batch: each step's loss,
    grad norm, ms (host clock around a synchronized step), collectives,
    and the peak of the memory allocated."""
    import torch
    from repro_torch import sharding as shd
    out = {"loss": [], "grad_norm": [], "ms": [], "counts": []}
    torch.cuda.reset_peak_memory_stats(device)
    for _ in range(TRAIN_MESH_STEPS):
        c0 = shd.counts()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize(device)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["counts"].append({k: v - c0.get(k, 0) for k, v in
                              shd.counts().items() if v != c0.get(k, 0)})
    out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    return out


def train_mesh_baseline(arch: str, n_layers: int, dtype: str, device,
                        seed: int):
    """The mesh-less train step on the card from the same weights and
    batch: TRAIN_MESH_STEPS steps (:func:`train_mesh_steps`)."""
    import torch
    from repro_torch.training.loop import make_train_step
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.tree import leaves
    cfg, bundle, opt_cfg, tokens = train_mesh_setup(arch, n_layers, seed)
    params = train_mesh_init(bundle, dtype, device, seed)
    for p in leaves(params):
        p.requires_grad_(True)
    out = train_mesh_steps(make_train_step(bundle, opt_cfg), params,
                           adamw_init(params), {"tokens": tokens.to(device)},
                           device)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_mesh_rank(rank: int, job_dir: str):
    """One of two gloo ranks sharing the card: for each model and mesh,
    the full weights made from the seed on the card one rank at a time,
    the rank's blocks kept (``shard_params`` under ``rules_for_shape``,
    FSDP on) and its rows of the batch, then TRAIN_MESH_STEPS steps of
    ``make_train_step`` inside ``mesh_rules``; saves each case's steps
    (:func:`train_mesh_steps`) as ``rank<r>.pt``."""
    import torch
    import torch.distributed as dist
    from repro_torch import sharding as shd
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.training.loop import make_train_step
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.tree import leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    job = torch.load(os.path.join(job_dir, "job.pt"), weights_only=False)
    device, seed = job["device"], job["seed"]
    res = {}
    for arch, n_layers, dtype in TRAIN_MESH_MODELS:
        cfg, bundle, opt_cfg, tokens = train_mesh_setup(arch, n_layers, seed)
        logical = shd.param_logical(bundle)
        for spec in TRAIN_MESH_MESHES:
            mesh = make_serving_mesh(spec, device=device)
            rules = shd.rules_for_shape(mesh, TRAIN_MESH_BATCH, fsdp=True)
            local = None
            for turn in range(2):           # one full copy at a time
                if turn == rank:
                    full = train_mesh_init(bundle, dtype, device, seed)
                    local = shd.shard_params(full, logical, mesh,
                                             mesh.coords, rules)
                    del full
                    gc.collect()
                    torch.cuda.empty_cache()
                dist.barrier()
            for p in leaves(local):
                p.requires_grad_(True)
            rows = shd.logical_to_spec(("batch", None), tokens.shape, mesh,
                                       rules)
            batch = {"tokens": shd.local_shard(tokens, rows, mesh,
                                               mesh.coords).to(device)}
            with shd.mesh_rules(mesh, rules):
                res[(arch, spec)] = train_mesh_steps(
                    make_train_step(bundle, opt_cfg), local,
                    adamw_init(local), batch, device)
            del local
            gc.collect()
            torch.cuda.empty_cache()
    torch.save(res, os.path.join(job_dir, f"rank{rank}.pt"))


def train_mesh_phase(device, card: str, *, tmp: str, seed: int = 0):
    """The sharded train step on this card: two gloo ranks sharing it run
    ``make_train_step`` inside ``sharding.mesh_rules`` on their blocks
    (FSDP on over ``data``, heads / FFN / vocabulary over ``model``, a
    vocab-parallel loss, the backward's transposed collectives, AdamW on
    the blocks with the global grad norm), on the (1, 2) and (2, 1)
    meshes, for h2o-danube-3-4b (bf16) and rwkv6-7b (f32) at full width
    cut to 2 layers (seeded weights, one batch of TRAIN_MESH_BATCH x
    TRAIN_MESH_SEQ tokens, TRAIN_MESH_STEPS steps at AdamW's default
    rate, ``chunked``: training launches no kernel).  Gates: step 0's
    loss and grad norm, as ``make_train_step`` returns them, within
    TRAIN_MESH_TOL relative of the mesh-less step on the card; the losses
    finite and falling; each step's collectives by kind equal to
    ``transformer.train_collectives``.  Prints ms per step by rank and
    mesh and each rank's peak memory."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.transformer import train_collectives
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    base = {arch: train_mesh_baseline(arch, n, dtype, device, seed)
            for arch, n, dtype in TRAIN_MESH_MODELS}
    job_dir = os.path.join(tmp, "train_mesh")
    os.makedirs(job_dir, exist_ok=True)
    torch.save(dict(seed=seed, device=device),
               os.path.join(job_dir, "job.pt"))
    t0 = time.perf_counter()
    run_ranks(train_mesh_rank, 2, backend="gloo", args=(job_dir,),
              timeout_s=600, init_dir=job_dir)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(job_dir, f"rank{r}.pt"),
                        weights_only=False) for r in range(2)]

    def rel(a, b):
        return abs(a - b) / abs(b)
    for arch, n_layers, dtype in TRAIN_MESH_MODELS:
        cfg = train_mesh_setup(arch, n_layers, seed)[0]
        ref = base[arch]
        print(f"[chip_smoke] train mesh {arch}: mesh-less on the card, "
              f"{n_layers} layers at full width, {dtype}, batch "
              f"{TRAIN_MESH_BATCH} x {TRAIN_MESH_SEQ}: losses "
              + " ".join(f"{x:.4f}" for x in ref["loss"])
              + f"; step 0 grad norm {ref['grad_norm'][0]:.6f}; step "
              f"{np.median(ref['ms'][1:]):.1f} ms (median of steps "
              f"1-{TRAIN_MESH_STEPS - 1}), peak memory "
              f"{ref['peak_bytes'] / 1e9:.2f} GB ({card})")
        for spec in TRAIN_MESH_MESHES:
            data, model = (int(x) for x in spec.split(","))
            what = f"train mesh {arch} ({spec})"
            want = train_collectives(cfg, data, model, fsdp=True,
                                     global_batch=TRAIN_MESH_BATCH)
            outs = [ranks[r][(arch, spec)] for r in range(2)]
            for r, o in enumerate(outs):
                for key in ("loss", "grad_norm"):
                    got, exp = o[key][0], ref[key][0]
                    if not rel(got, exp) <= TRAIN_MESH_TOL:
                        fail(f"{what}: rank {r} step 0 {key} {got:.6f} vs "
                             f"{exp:.6f} mesh-less: relative "
                             f"{rel(got, exp):.3g} > {TRAIN_MESH_TOL}")
                if not np.isfinite(o["loss"]).all() or \
                        not o["loss"][-1] < o["loss"][0]:
                    fail(f"{what}: rank {r} losses did not fall: "
                         f"{o['loss']}")
                for i, c in enumerate(o["counts"]):
                    if c != want:
                        fail(f"{what}: rank {r} step {i} collectives {c}, "
                             f"want {want}")
            o0 = outs[0]
            print(f"[chip_smoke] {what}: step 0 loss {o0['loss'][0]:.6f} / "
                  f"mesh-less {ref['loss'][0]:.6f} (relative "
                  f"{rel(o0['loss'][0], ref['loss'][0]):.3g}), grad norm "
                  f"{o0['grad_norm'][0]:.6f} / {ref['grad_norm'][0]:.6f} "
                  f"(relative "
                  f"{rel(o0['grad_norm'][0], ref['grad_norm'][0]):.3g}; "
                  f"each <= {TRAIN_MESH_TOL}); losses "
                  + " ".join(f"{x:.4f}" for x in o0["loss"])
                  + f"; collectives a step {o0['counts'][0]}; "
                  + "; ".join(
                      f"rank {r} step {np.median(o['ms'][1:]):.1f} ms "
                      f"(steps 1-{TRAIN_MESH_STEPS - 1}: " + " ".join(
                          f"{x:.1f}" for x in o["ms"][1:]) + "), peak "
                      f"memory {o['peak_bytes'] / 1e9:.2f} GB"
                      for r, o in enumerate(outs))
                  + f" (2 ranks sharing one card, gloo, eager; {card})")
    print(f"[chip_smoke] train mesh phase {time.perf_counter() - t_phase:.1f}"
          f"s (2 ranks spawned and done in {spawn_s:.1f}s)")


def dryrun_phase(card: str) -> None:
    """``launch/dryrun.py`` under this machine's torch: one job
    (h2o-danube-3-4b ``decode_32k`` on the 256-rank fake mesh) in a
    process of its own; prints its per-chip bytes, FLOPs, collective bytes
    by kind and the bound's term (``types.H100`` constants: no time here
    is measured on the card)."""
    import subprocess
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "h2o-danube-3-4b", "--shape", "decode_32k"], capture_output=True,
        text=True, timeout=300, env=env, cwd=ROOT)
    if out.returncode != 0:
        fail(f"dry run: exit {out.returncode}: {out.stderr[-2000:]}")
    line = [ln for ln in out.stdout.splitlines() if "] OK " in ln]
    if not line:
        fail(f"dry run: no OK line in {out.stdout[-2000:]}")
    import torch
    print(f"{line[0]} (torch {torch.__version__}; "
          f"{time.perf_counter() - t0:.1f}s with the process start)")


# ---------------------------------------------------------------------------
# the roofline of each path on this card
# ---------------------------------------------------------------------------

ROOFLINE_SLACK = 1.05   # a bound past measured x this is a counting error
ROOFLINE_TEXT = ("gemma3-12b", "h2o-danube-3-4b")   # their decode steps
ROOFLINE_PATHS = ("climber encode", "climber cached", "climber extend",
                  "climber decode", "climber append", "climber full",
                  "gemma3-12b decode step", "h2o-danube-3-4b decode step",
                  "train climber", "train h2o-danube-3-4b")
#: the paths that time themselves elsewhere (text decode steps, training
#: steps) record their counts here while their model is alive
ROOFLINE_ROWS = []


def roofline_note(label: str, cfg, shape, fn, args, measured_ms: float, *,
                  params_bytes=None, train: bool = False):
    """Count ``fn(*args)`` (the ``reference`` route, on fake tensors: no
    memory, nothing runs) with ``roofline.cost_analysis`` and record it
    beside the path's measured time for :func:`roofline_phase`."""
    from repro_torch import roofline as R
    t0 = time.perf_counter()
    cost = R.cost_analysis(fn, *args)
    ROOFLINE_ROWS.append(dict(label=label, cfg=cfg, shape=shape, cost=cost,
                              ms=measured_ms, params_bytes=params_bytes,
                              train=train,
                              count_s=time.perf_counter() - t0))


def climber_analysis_cfg(cfg):
    """Climber analysed as the scorer it is: its head scores num_tasks
    tasks and its item table is gathered, not multiplied, so the JAX
    formulas' vocabulary terms (logits over 2,000,000 items, the table in
    N) take vocab_size = num_tasks."""
    return dataclasses.replace(cfg, vocab_size=cfg.climber.num_tasks)


def weight_bytes(params, skip=("embed",)) -> float:
    from repro_torch.tree import leaves
    return float(sum(t.numel() * t.element_size()
                     for name, sub in params.items() if name not in skip
                     for t in leaves(sub)))


def roofline_phase(cfg, device, card: str, *, n_history: int, buckets,
                   seed: int = 0, every_path: bool = True) -> list:
    """``roofline.analyse`` with ``types.H100`` for each path: the Climber
    families at batch 4 (bucket 128 where a family has candidates:
    ``encode``, ``cached``, ``extend``, ``decode``, ``append``, ``full``),
    each counted on its ``reference`` route (fake tensors) and timed as its
    ``fused`` executor's CUDA-graph replay (CUDA events, the device alone);
    and the rows the text and training phases recorded (the captured decode
    step of gemma3-12b and h2o-danube-3-4b at batch 4; one training step of
    Climber and h2o-danube-3-4b, forward + backward counted, the step's
    median timed).  Prints the counted FLOPs and bytes, ``memory_s_est``,
    the bound (the larger of ``compute_s`` and ``memory_s_est``) and its
    term, the measured time and bound / measured, with the unfused
    ``memory_s`` as a ceiling; a training step also its model FLOPs over
    its time against ``peak_flops``.  Gate: no bound past ROOFLINE_SLACK x
    the measured time, and (``every_path``) a row for every path listed.
    Returns the rows."""
    import numpy as np
    import torch
    from repro_torch import roofline as R
    from repro_torch.core import climber as C
    from repro_torch.core.pda import RemoteFeatureStore
    from repro_torch.serving import create_engine
    from repro_torch.types import ShapeConfig

    what = "roofline"
    t0 = time.perf_counter()
    params = C.climber_init(
        cfg, torch.Generator(device=device).manual_seed(seed), device)
    bundle = C.build_climber(cfg)
    base = dict(n_history=n_history, buckets=buckets, max_batch=4,
                pool_dtype="int8", impl="fused", device=device,
                store=RemoteFeatureStore(feature_dim=C.N_SIDE_FEATURES,
                                         seed=seed))
    engines = [(create_engine("flame", bundle, params, generate=GEN_STEPS,
                              gen_vocab=GEN_VOCAB, incremental_history=True,
                              **base),
                ("encode", "cached", "extend", "decode", "append")),
               (create_engine("flame", bundle, params, history_cache=False,
                              **base), ("full",))]
    acfg = climber_analysis_cfg(cfg)
    wbytes = weight_bytes(params)
    rows = []
    for eng, kinds in engines:
        for kind in kinds:
            have = sorted(b for k, b in eng.dso.executors if k == kind)
            bucket = 128 if 128 in have else max(have)
            ex = eng.dso.executors[(kind, bucket)][0]
            args = family_args(eng, kind, bucket, cfg.vocab_size, seed=31)
            with uncounted():
                ex(*args)                      # stage this call's inputs
                ms = call_ms(lambda: ex.graph.replay(), reps=20, warm=3)
            ts = [torch.from_numpy(a).to(device) if isinstance(a, np.ndarray)
                  else a for a in args]
            eng.impl = "reference"   # the family's fn reads it per call
            try:
                t1 = time.perf_counter()
                cost = R.cost_analysis(ex.fn, *ts)
                count_s = time.perf_counter() - t1
            finally:
                eng.impl = "fused"
            cands = 0 if kind in ("encode", "extend") else bucket
            shape = ShapeConfig(name=f"{kind} b{bucket}", seq_len=n_history,
                                global_batch=4, kind="prefill",
                                n_candidates=cands)
            rows.append(dict(label=f"climber {kind} b{bucket} (batch 4)",
                             cfg=acfg, shape=shape, cost=cost, ms=ms,
                             params_bytes=wbytes, train=False,
                             count_s=count_s))
        eng.shutdown()
    del engines, params
    gc.collect()
    torch.cuda.empty_cache()
    rows += ROOFLINE_ROWS
    out = []
    for r in rows:
        rep = R.analyse(r["label"], r["shape"].name, "1", 1, r["cost"], None,
                        r["cfg"], r["shape"], H100,
                        params_bytes_chip=r["params_bytes"])
        bnd = max(rep.compute_s, rep.memory_s_est)
        term = "compute" if rep.compute_s >= rep.memory_s_est else "memory"
        meas = r["ms"] * 1e-3
        ratio = bnd / meas
        line = (f"[chip_smoke] {what}: {r['label']}: counted "
                f"{rep.hlo_flops / 1e9:.3f} GFLOP, {rep.hlo_bytes / 1e9:.3f} "
                f"GB unfused ({r['cost']['ops']} ops, counted in "
                f"{r['count_s']:.1f}s); compute_s {rep.compute_s * 1e3:.4f} "
                f"ms, memory_s_est {rep.memory_s_est * 1e3:.4f} ms -> bound "
                f"{bnd * 1e3:.4f} ms ({term}); measured {r['ms']:.4f} ms; "
                f"bound / measured {ratio:.3f}; unfused memory_s "
                f"{rep.memory_s * 1e3:.4f} ms (ceiling, not gated)")
        if r["train"]:
            line += (f"; model FLOPs {rep.model_flops / 1e12:.2f} TFLOP / "
                     f"step = {rep.model_flops / meas / H100.peak_flops:.1%}"
                     f" of {H100.peak_flops / 1e12:.0f} TFLOP/s")
        print(line + f"; {card}")
        if not ratio <= ROOFLINE_SLACK:
            fail(f"{what}: {r['label']}: bound {bnd * 1e3:.4f} ms exceeds "
                 f"{ROOFLINE_SLACK} x the measured {r['ms']:.4f} ms: a "
                 f"counting error")
        out.append(dict(label=r["label"], flops=rep.hlo_flops,
                        bytes=rep.hlo_bytes, ms=r["ms"], bound_ms=bnd * 1e3,
                        term=term, ratio=ratio,
                        memory_s_ms=rep.memory_s * 1e3))
    names = {r["label"].split(" (")[0] for r in rows}
    for want in ROOFLINE_PATHS if every_path else ():
        if not any(n.startswith(want) for n in names):
            fail(f"{what}: no row for {want} (rows: {sorted(names)})")
    print(f"[chip_smoke] {what}: {len(out)} paths, every bound <= "
          f"{ROOFLINE_SLACK} x measured; phase "
          f"{time.perf_counter() - t0:.1f}s")
    return out


# the port's examples as the card runs them: (script, arguments, the kernels
# that must launch in its run, by the kernels line's names)
EXAMPLES = (
    ("torch_quickstart", ["--impl", "pallas"], ("flash_attention",)),
    ("torch_serve_e2e", [], ("fused_score", "flash_attention")),
    ("torch_mixed_traffic_dso", [], ("flash_attention",)),
    ("torch_text_serving", [], ("flash_attention", "fused_ffn",
                                "flash_decode single-token")),
    ("torch_text_serving", ["--arch", "rwkv6-7b"], ("rwkv6_scan",)),
    ("torch_train_climber", ["--steps", "30"], ()),
)


#: examples run at once (each a process of its own; together they hold a
#: few GB of the card and at most 3 of the host's 8 cores busy importing)
EXAMPLE_WORKERS = 3


def examples_phase(card: str, tmp: str) -> dict:
    """The port's five examples (``examples/torch_*.py``) on the card, each
    a process of its own at its JAX twin's sizes (the train example cut to
    30 steps; the text example on gemma3-12b and on rwkv6-7b, reduced as
    its twin), through the entry points a user calls, EXAMPLE_WORKERS at a
    time.  Each must exit 0 and print its own checks OK; the launch counts
    it prints before it exits are parsed, the kernels its path runs must
    have launched, and the sum is returned under the kernels line's names.
    Prints each example's seconds and launch counts."""
    import ast
    from concurrent.futures import ThreadPoolExecutor
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=SRC)
    # ``_build.launch_counts()`` names a wrapper by its function's name
    names = {w.__name__: k for k, w in counted_kernels().items()}
    total: dict = {}
    t_phase = time.perf_counter()

    def run(example):
        name, args, _ = example
        extra = ["--ckpt", os.path.join(tmp, "climber.msgpack")] \
            if name == "torch_train_climber" else []
        cmd = [sys.executable, os.path.join(ROOT, "examples", f"{name}.py"),
               *args, *extra]
        t0 = time.perf_counter()
        try:
            out = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                                 text=True, timeout=300)
        except subprocess.TimeoutExpired:
            out = None
        return out, time.perf_counter() - t0

    with ThreadPoolExecutor(EXAMPLE_WORKERS) as pool:
        results = list(pool.map(run, EXAMPLES))
    for (name, args, want), (out, dt) in zip(EXAMPLES, results):
        what = " ".join([f"{name}.py", *args])
        if out is None:
            fail(f"examples: {what} ran past 300 s")
        lines = out.stdout.splitlines()
        checks = [ln for ln in lines if " checks" in ln and ln.endswith(
            (": OK", ": FAIL"))]
        counts = [ln for ln in lines if ln.startswith("launch counts: ")]
        if out.returncode or len(checks) != 1 or \
                not checks[0].endswith(": OK") or len(counts) != 1:
            fail(f"examples: {what} exited {out.returncode}; stdout tail:\n"
                 f"{out.stdout[-2000:]}\nstderr tail:\n"
                 f"{out.stderr[-2000:]}")
        got = {names[k]: v for k, v in ast.literal_eval(
            counts[0][len("launch counts: "):]).items()}
        missing = [k for k in want if got.get(k, 0) <= 0]
        if missing:
            fail(f"examples: {what} launched no {missing}: {got}")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        print(f"[chip_smoke] examples: {what}: {dt:.1f}s (a process of its "
              f"own: start, kernels already built, run; {EXAMPLE_WORKERS} "
              f"at a time); {checks[0]}; launches {got}; {card}")
    print(f"[chip_smoke] examples: phase {time.perf_counter() - t_phase:.1f}s"
          f", launches {total}")
    return total


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("[chip_smoke] torch.cuda.is_available() is False: this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"[chip_smoke] no src/repro_torch beside {__file__}: run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 GEMMs in full f32
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import CLIMBER_BASE, get_config
    from repro_torch.kernels import _build

    t_all = time.perf_counter()
    card = card_line()
    print(f"[chip_smoke] card: {card}")
    build_s = _build.build()
    print(f"[chip_smoke] kernels built in {build_s:.1f}s "
          f"({', '.join(_build.SOURCES)})")
    for name, lines in _build.ptxas_log.items():
        for ln in lines:
            print(f"[chip_smoke]   ptxas {name}: {ln.strip()}")
    device = torch.device("cuda", 0)

    cfg = get_config("climber")
    buckets = (128, 64, 32)
    entries = {"fused_score": k1_phase(device),
               "flash_attention": k2_phase(device),
               "fused_ffn": k3_phase(device, d_model=cfg.d_model,
                                     d_ff=cfg.d_ff),
               "flash_decode": k4_phase(device, rows=4, cands=buckets[0],
                                        s_pad=CLIMBER_BASE.seq_len
                                        // cfg.climber.num_blocks + 1
                                        + GEN_STEPS),
               "rwkv6_scan": k5_phase(device)}
    # F2's remainder: each kernel's any-dims variant at dims the tiled
    # kernels are not instantiated for (checks, bounds, times)
    f2_phase(device, card, entries)
    # the main paths, each driven with the counts set to 0 just before it
    # and read just after: scoring (fused), generation (pallas, fused),
    # extend + packing, the pool-off full family and the implicit engine,
    # the text engine on rwkv6-7b
    paths = {"score fused": engine_phase(cfg, device,
                                         n_history=CLIMBER_BASE.seq_len,
                                         buckets=buckets)}
    for impl in ("pallas", "fused"):
        paths[f"gen {impl}"], _ = gen_phase(
            cfg, device, impl=impl, n_history=CLIMBER_BASE.seq_len,
            buckets=buckets)
    paths["extend + packing"] = extend_pack_phase(
        cfg, device, n_history=CLIMBER_BASE.seq_len, buckets=buckets)
    paths["full + implicit"] = full_implicit_phase(
        cfg, device, n_history=CLIMBER_BASE.seq_len, buckets=buckets,
        k2_full_ms=entries["flash_attention"]["full_ms"])
    paths["dso pool"] = dso_pool_phase(cfg, device, card,
                                       n_history=CLIMBER_BASE.seq_len,
                                       buckets=buckets)
    # the wide-head Climber: K1's any-dims variant on the served path
    for d in WIDE_HEAD_DIMS:
        paths[f"wide heads D {d}"] = wide_head_phase(
            device, card, d, n_history=CLIMBER_BASE.seq_len,
            buckets=buckets)
    paths["overload"] = overload_phase(
        cfg, device, n_history=CLIMBER_BASE.seq_len, buckets=buckets)
    with tempfile.TemporaryDirectory() as tmp:
        paths["mesh"] = mesh_phase(cfg, device, card,
                                   n_history=CLIMBER_BASE.seq_len, tmp=tmp)
    # the text families sharded over (1, 2) and (2, 1), then the dry run
    with tempfile.TemporaryDirectory() as tmp:
        paths["text mesh"] = text_mesh_phase(device, card, tmp=tmp)
    # the sharded train step (no kernel: chunked), then the dry run
    with tempfile.TemporaryDirectory() as tmp:
        train_mesh_phase(device, card, tmp=tmp)
    dryrun_phase(card)
    reference_phase(device)
    paths["text rwkv6-7b"] = text_phase(device, card,
                                        entries["rwkv6_scan"]["ms"])
    text_kernel_shapes(device, card)
    for arch, wrap in (("gemma3-12b", True), ("h2o-danube-3-4b", False)):
        text_attn_phase(device, card, arch, paths, max_len=TEXT_PROMPT + 28,
                        wrap=wrap)
    # the other text families: their kernel shapes, then seven phases, each
    # model freed before the next; depth cut only where 80 GB forces it
    family_kernel_shapes(device, card)
    for arch, n_layers in FAMILY_CUTS:
        text_attn_phase(device, card, arch, paths, max_len=TEXT_PROMPT + 28,
                        wrap=False, n_layers=n_layers)
    arch = "llava-next-mistral-7b"
    text_attn_phase(device, card, arch, paths, max_len=TEXT_PROMPT + 28,
                    wrap=False, also={f"vlm {arch} (patches)":
                                      vlm_patch_path(device, card)})
    paths["audio seamless-m4t-large-v2"] = audio_phase(device, card)
    # training (no kernel: reference / chunked), then Climber served from
    # its checkpoint (K1, K2)
    paths["train + serve climber"] = train_phase(device, card, buckets)
    # the port's five examples, each a process of its own
    with tempfile.TemporaryDirectory() as tmp:
        paths["examples"] = examples_phase(card, tmp)
    # each path's bound on this card beside its measured time (the text
    # decode steps and training steps were counted by their phases)
    roofline_phase(cfg, device, card, n_history=CLIMBER_BASE.seq_len,
                   buckets=buckets)
    # K4's two forms are one TPU kernel's port
    launches = {name: sum(p.get(name, 0) + (
        p.get("flash_decode single-token", 0) if name == "flash_decode"
        else 0) for p in paths.values()) for name in entries}
    print("[chip_smoke] launches per main path: " + "; ".join(
        f"{path} {counts}" for path, counts in paths.items()))
    kernels = []
    for name, e in entries.items():
        e = dict(e)
        e["launches"] = launches[name]
        if e["launches"] <= 0:
            fail(f"{name} was never launched on a main path")
        kernels.append({k: e[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    print(f"[chip_smoke] total {time.perf_counter() - t_all:.1f}s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
