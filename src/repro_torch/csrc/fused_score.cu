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
// Design (see attention_common.cuh): one block of kRows threads per
// (batch * head, q tile), one thread per query.  The block loads its pool row
// from row_index itself (the TPU kernel's scalar prefetch), dequantizes each
// history tile into f32 shared memory while loading it, and folds it into the
// per-thread online softmax; the candidate's self key is read straight from
// device memory.  Nothing carries over between blocks.  No padding of D to
// 128 lanes, no square blocks.
//
// Bound: at the Climber scoring shapes (q [4, 128, 4, 64] bf16, an int8
// history of 257 positions for up to 4 pool rows) the function moves ~1.6 MB
// and does ~0.14 GFLOP — half a microsecond of memory time on an H100, so it
// is bytes-bound; int8 storage is what keeps those bytes low.  This first
// version runs scalar f32 FMAs on few blocks and is limited by latency and
// launch overhead; wgmma tiles and fewer, larger launches are later work.
#include "attention_common.cuh"

namespace flame {

enum Mode { kCached = 0, kExtend = 1 };

template <typename TQ, typename TH, int D>
__global__ void __launch_bounds__(kRows) fused_score_kernel(
    const TQ* __restrict__ q, const TH* __restrict__ k_hist,
    const TH* __restrict__ v_hist, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const TQ* __restrict__ k_cand,
    const TQ* __restrict__ v_cand, const int* __restrict__ row_index,
    const int* __restrict__ lengths, TQ* __restrict__ o, int H, int Hkv,
    int M, int U, int S, Strides qs, Strides khs, Strides vhs, Strides kcs,
    Strides vcs, Strides os, int mode, float scale) {
  constexpr int BK = Tile<D>::keys;
  __shared__ __align__(16) float k_tile[BK * D];
  __shared__ __align__(16) float v_tile[BK * D];

  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int kvh = h / (H / Hkv);
  const int r0 = blockIdx.x * kRows;
  const int r1 = min(r0 + kRows, M);
  const int r = r0 + threadIdx.x;
  const bool live = r < M;

  int row = row_index ? row_index[b] : b;
  row = min(max(row, 0), U - 1);
  const int len = lengths ? min(max(lengths[row], 0), S) : S;
  const float ksc = k_scale ? k_scale[row * Hkv + kvh] : 1.f;
  const float vsc = v_scale ? v_scale[row * Hkv + kvh] : 1.f;

  Row<D> st;
  st.reset();
  st.load_q(q + b * qs.n + h * qs.h + (long long)(live ? r : r0) * qs.s, live,
            scale);

  // segment 1: pooled history, dequantized while staged
  const TH* kh = k_hist + row * khs.n + kvh * khs.h;
  const TH* vh = v_hist + row * vhs.n + kvh * vhs.h;
  for (int t0 = 0; t0 < len; t0 += BK) {
    const int n = min(BK, len - t0);
    __syncthreads();
    load_tile<TH, D>(k_tile, kh + t0 * khs.s, khs.s, n, ksc);
    load_tile<TH, D>(v_tile, vh + t0 * vhs.s, vhs.s, n, vsc);
    __syncthreads();
    st.fold(k_tile, v_tile, n, [&](int) { return live; });
  }

  // segment 2: the fresh candidate / suffix keys, full precision
  const TQ* kc = k_cand + b * kcs.n + kvh * kcs.h;
  const TQ* vc = v_cand + b * vcs.n + kvh * vcs.h;
  if (mode == kCached) {
    if (live) st.fold_one(kc + (long long)r * kcs.s, vc + (long long)r * vcs.s);
  } else {
    for (int t0 = 0; t0 < r1; t0 += BK) {
      const int n = min(BK, r1 - t0);
      __syncthreads();
      load_tile<TQ, D>(k_tile, kc + t0 * kcs.s, kcs.s, n, 1.f);
      load_tile<TQ, D>(v_tile, vc + t0 * vcs.s, vcs.s, n, 1.f);
      __syncthreads();
      st.fold(k_tile, v_tile, n,
              [&](int t) { return live && t0 + t <= r; });
    }
  }
  if (live) st.store(o + b * os.n + h * os.h + (long long)r * os.s);
}

struct Args {
  const void *q, *k_hist, *v_hist;
  const float *k_scale, *v_scale;
  const void *k_cand, *v_cand;
  const int *row_index, *lengths;
  void* o;
  int B, M, H, Hkv, U, S;
  Strides st[6];
  int mode;
  float scale;
};

template <typename TQ, typename TH, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.M + kRows - 1) / kRows, a.B * a.H);
  fused_score_kernel<TQ, TH, D><<<grid, kRows, 0, stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TH*>(a.k_hist),
      static_cast<const TH*>(a.v_hist), a.k_scale, a.v_scale,
      static_cast<const TQ*>(a.k_cand), static_cast<const TQ*>(a.v_cand),
      a.row_index, a.lengths, static_cast<TQ*>(a.o), a.H, a.Hkv, a.M, a.U,
      a.S, a.st[0], a.st[1], a.st[2], a.st[3], a.st[4], a.st[5], a.mode,
      a.scale);
  return cudaGetLastError();
}

template <typename TQ, typename TH>
cudaError_t dispatch_d(int D, const Args& a, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<TQ, TH, 16>(a, s);
    case 32:
      return launch<TQ, TH, 32>(a, s);
    case 64:
      return launch<TQ, TH, 64>(a, s);
    case 128:
      return launch<TQ, TH, 128>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TQ>
cudaError_t dispatch_hist(int hist_dtype, int D, const Args& a,
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
// row_index: [B] int32 pool row per batch row or NULL (= b).
// lengths: [U] int32 valid history prefix per pool row or NULL (= S).
// strides: 18 int64 — (outer, seq, head) element strides of q, k_hist,
// v_hist, k_cand, v_cand, o.
extern "C" int fused_score_fwd(const void* q, const void* k_hist,
                               const void* v_hist, const float* k_scale,
                               const float* v_scale, const void* k_cand,
                               const void* v_cand, const int* row_index,
                               const int* lengths, void* o, int q_dtype,
                               int hist_dtype, int B, int M, int H, int Hkv,
                               int U, int S, int D, const long long* strides,
                               int mode, float scale, void* stream) {
  using namespace flame;
  if (B <= 0 || M <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || U <= 0 || S <= 0 ||
      (mode != kCached && mode != kExtend))
    return cudaErrorInvalidValue;
  Args a{q,       k_hist,    v_hist,  k_scale, v_scale, k_cand, v_cand,
         row_index, lengths, o,       B,       M,       H,      Hkv,
         U,       S,         {},      mode,    scale};
  for (int i = 0; i < 6; ++i)
    a.st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0) return dispatch_hist<float>(hist_dtype, D, a, s);
  if (q_dtype == 1) return dispatch_hist<__nv_bfloat16>(hist_dtype, D, a, s);
  return cudaErrorInvalidValue;
}
