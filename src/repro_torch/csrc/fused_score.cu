// Fused candidate-scoring attention for Hopper (sm_90a) — kernel K1 of the
// port.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_score/kernel.py::
// fused_score_kernel (body _fused_kernel).  It computes the same function: a
// two-segment online softmax per (batch row, head, query).
//   segment 1: the pooled history K/V of the batch row's pool row
//              (row_index[b], the DSO's KV-row dedup) in the pool's stored
//              precision — int8, bf16 or f32 — with the per-(row, kv head)
//              scale (int8's absmax / 127) folded in, bounded per pool row by
//              lengths[row] (generative decode; the full history otherwise);
//   segment 2: "cached" — the query's own candidate key only (SUMI);
//              "extend" — the suffix keys at or before the query (causal).
// The dequantized history, the gathered rows and the concatenation of the
// two segments never reach device memory.
//
// Bound: at the Climber scoring shape (q [4, 128, 4, 64] bf16, an int8
// history of 257 positions for 4 pool rows) the function moves ~1.6 MB and
// does ~0.14 GFLOP — half a microsecond of memory time on an H100.  What
// sets the time is latency: the chain of dependent work in one block and
// the launch.  The first version (one thread per query row, scalar f32 FMAs
// over history tiles dequantized into f32 shared memory, 64 one-warp
// blocks) ran ~200x its bound.
//
// A packed index (DSO v2 segment packing: a pool row per candidate) runs
// segment 1 once per distinct pool row of a block's candidates, so packed ==
// unpacked bitwise at any alignment (cached_score.cuh).
//
// Design (cached_score.cuh): bf16 q in cached mode — the serving path, over
// an int8 or bf16 history — runs cs::cached_mma_kernel: both products on
// the tensor cores (mma.sync), a block of four warps per 16 candidates
// whose warps split the history's key tiles, each through its own ring of
// tiles staged as bf16 codes, and combine their softmax states in warp
// order; the scales applied in f32 after each product, P as bf16 hi + lo,
// the self key folded in f32 after the history.  bf16 q in extend mode
// (every fused `extend` dispatch: bf16 q and suffix over the dequantized
// bf16 prefix) runs cs::extend_mma_kernel (extend_score.cuh): the same
// block, rings and combine, the causal suffix's key tiles continuing the
// prefix's rotation over the warps, masked keys selected to P = 0.  At the
// path's extend shapes — [4, 1, 4, 64] over 256 prefix rows, [4, 129, 4,
// 64] over 128 — the function moves ~1.1-1.6 MB (0.3-0.5 us at 3.35 TB/s):
// latency bound too, 16 and 144 blocks of at most 3 tiles a warp.  f32 q
// (no tensor-core type holds it within the f32 tolerance) and an f32
// history keep the scalar kernel, one thread per query row.
#include "extend_score.cuh"

namespace flame {

template <typename TH, int D>
cudaError_t launch_tc(const ScoreArgs& a, cudaStream_t s) {
  return a.mode == kCached ? launch_mma<TH, D>(a, s)
                           : launch_extend<TH, D>(a, s);
}

template <typename TQ, typename TH>
cudaError_t dispatch_d(int D, const ScoreArgs& a, cudaStream_t s) {
  constexpr bool kMma = std::is_same<TQ, __nv_bfloat16>::value &&
                        !std::is_same<TH, float>::value;
  if constexpr (kMma) {
    switch (D) {
      case 16:
        return launch_tc<TH, 16>(a, s);
      case 32:
        return launch_tc<TH, 32>(a, s);
      case 64:
        return launch_tc<TH, 64>(a, s);
      case 128:
        return launch_tc<TH, 128>(a, s);
      default:
        return cudaErrorInvalidValue;
    }
  } else {
    switch (D) {
      case 16:
        return launch_scalar<TQ, TH, 16>(a, s);
      case 32:
        return launch_scalar<TQ, TH, 32>(a, s);
      case 64:
        return launch_scalar<TQ, TH, 64>(a, s);
      case 128:
        return launch_scalar<TQ, TH, 128>(a, s);
      default:
        return cudaErrorInvalidValue;
    }
  }
}

template <typename TQ>
cudaError_t dispatch_hist(int hist_dtype, int D, const ScoreArgs& a,
                          cudaStream_t s) {
  switch (hist_dtype) {
    case 0:
      return dispatch_d<TQ, float>(D, a, s);
    case 1:
      return dispatch_d<TQ, __nv_bfloat16>(D, a, s);
    case 2:
      return dispatch_d<TQ, int8_t>(D, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace flame

// q_dtype (q, k_cand, v_cand, o): 0 = float32, 1 = bfloat16.
// hist_dtype (k_hist, v_hist): 0 = float32, 1 = bfloat16, 2 = int8.
// k_scale / v_scale: [U, Hkv] f32 multipliers or NULL (= 1).
// row_index: [B] int32 pool row per batch row, [B, M] (packed != 0: a pool
// row per candidate, cached mode only) or NULL (= b).
// lengths: [U] int32 valid history prefix per pool row or NULL (= S).
// strides: 18 int64 — (outer, seq, head) element strides of q, k_hist,
// v_hist, k_cand, v_cand, o.
extern "C" int fused_score_fwd(const void* q, const void* k_hist,
                               const void* v_hist, const float* k_scale,
                               const float* v_scale, const void* k_cand,
                               const void* v_cand, const int* row_index,
                               const int* lengths, void* o, int q_dtype,
                               int hist_dtype, int packed, int B, int M,
                               int H, int Hkv, int U, int S, int D,
                               const long long* strides, int mode,
                               float scale, void* stream) {
  using namespace flame;
  if (B <= 0 || M <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || U <= 0 || S <= 0 ||
      (mode != kCached && mode != kExtend) ||
      (packed && (mode != kCached || !row_index)))
    return cudaErrorInvalidValue;
  ScoreArgs a{q,         k_hist,  v_hist, k_scale, v_scale, k_cand, v_cand,
              row_index, lengths, o,      B,       M,       H,      Hkv,
              U,         S,       {},     mode,    scale,   packed};
  for (int i = 0; i < 6; ++i)
    a.st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0) return dispatch_hist<float>(hist_dtype, D, a, s);
  if (q_dtype == 1) return dispatch_hist<__nv_bfloat16>(hist_dtype, D, a, s);
  return cudaErrorInvalidValue;
}

// Launch plan for these shapes: out[0..4] = grid x, grid y, threads per
// block, static shared-memory bytes, 1 if the tensor-core kernel runs.
extern "C" int fused_score_plan(int q_dtype, int hist_dtype, int mode, int B,
                                int M, int H, int D, int* out) {
  using namespace flame;
  if (B <= 0 || M <= 0 || H <= 0) return cudaErrorInvalidValue;
  const int mma_kernel = q_dtype == 1 && hist_dtype != 0;
  score_plan(mma_kernel, B, M, H, D, out);
  out[4] = mma_kernel;
  return cudaSuccess;
}
