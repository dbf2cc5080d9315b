// Any-head-size chunked RWKV-6 wkv scan for Hopper (sm_90a): the variant of
// kernel K5 (rwkv6_scan) that takes every head size its JAX wrapper takes.
//
// Replaces, past the tiled kernel's head sizes (32, 64; smaller ones run
// padded), the Pallas TPU kernel repro/kernels/rwkv6_scan/kernel.py::
// rwkv6_scan_kernel, which takes any head size.  The wrapper
// (kernels/rwkv6_scan/ops.py) sends here from the head size alone, before
// the launch; its launches count under rwkv6_scan.
//
// Per (row, head) it computes, chunk by chunk (kChunk steps), the function of
// the JAX model's wkv_chunked:
//   la = cumsum of w_log over the chunk, la_prev = la - w_log;
//   o_t = (r_t e^{la_prev_t}) S + sum_{s<t} [sum_d r_td k_sd
//         e^{la_prev_td - la_sd}] v_s + (r_t . (u * k_t)) v_t;
//   S <- e^{la_c} S + sum_s (k_s e^{la_c - la_s}) v_s^T  (la_c: the chunk's
//   last step).
// Every exponent is <= 0 (la falls over the chunk), so nothing overflows
// where w_log reaches -20 a step.  The columns of the [D, D] state evolve
// apart, so a block owns kCols of them (grid: column tiles x rows * heads)
// and recomputes the chunk's scores, which all its columns share.  Its work
// area — the state's columns [D, kCols] and the chunk's la, r and k
// [kChunk, D] as f32 — lives in shared memory up to head size kSmemMaxD and
// past it in a device-memory workspace of one area a block, so no head size
// is refused.  f32 throughout, steps in a fixed order: two calls agree
// bitwise.
//
// Bound on an H100: the bytes (r, k, v, w_log read once, o and the state
// written once) at the shapes a model runs; this scalar f32 kernel spends
// kChunk / 2 exponentials a score element and recomputes the scores in
// every column tile, so it sits well above that bound.  It exists for head
// sizes no registry config uses; correctness first, as a first port.
#include "attention_common.cuh"

namespace flame {
namespace any_wkv {

constexpr int kChunk = 32;
constexpr int kCols = 64;
constexpr int kThreads = 256;
constexpr int kSmemMaxD = 128;

// floats of a block's work area: S [D][kCols], la / r / k [kChunk][D + 1]
// (a padded row: the scores' lanes read keys D + 1 floats apart, no bank
// conflicts)
__host__ __device__ inline long long area_floats(int D) {
  return (long long)D * kCols + 3LL * kChunk * (D + 1);
}

__host__ __device__ inline size_t smem_bytes(int D) {
  const size_t fixed = kChunk * kCols + kChunk * (kChunk + 1);
  return (fixed + (D <= kSmemMaxD ? area_floats(D) : 0)) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    wkv_any_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ w,
                   const float* __restrict__ u, const float* __restrict__ s0,
                   T* __restrict__ o, float* __restrict__ sf,
                   float* __restrict__ ws, int H, int S, int D, Strides rs,
                   Strides ks, Strides vs, Strides wst, Strides os) {
  extern __shared__ __align__(16) float sm[];
  float* vt = sm;                         // [kChunk][kCols]
  float* sc = vt + kChunk * kCols;        // [kChunk][kChunk + 1]
  float* area = ws ? ws + ((long long)blockIdx.y * gridDim.x + blockIdx.x) *
                              area_floats(D)
                   : sc + kChunk * (kChunk + 1);
  const int LD = D + 1;
  float* St = area;                       // [D][kCols]
  float* la = St + (long long)D * kCols;  // [kChunk][LD]
  float* rr = la + (long long)kChunk * LD;
  float* kk = rr + (long long)kChunk * LD;

  const int tid = threadIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int e0 = blockIdx.x * kCols;
  const float* uh = u + (long long)h * D;
  const long long st0 = ((long long)b * H + h) * D * D;  // state [b, h]

  for (int i = tid; i < D * kCols; i += kThreads) {
    const int d = i / kCols, e = i % kCols;
    St[i] = (s0 && e0 + e < D) ? s0[st0 + (long long)d * D + e0 + e] : 0.f;
  }
  for (int c0 = 0; c0 < S; c0 += kChunk) {
    const int n = min(kChunk, S - c0);
    __syncthreads();
    // ---- the chunk's r, k, v and cumulative log decay ----
    for (int i = tid; i < kChunk * D; i += kThreads) {
      const int t = i / D, d = i % D;
      const bool in = t < n;
      const long long at = (long long)(c0 + t);
      rr[t * LD + d] =
          in ? to_f32(r[b * rs.n + at * rs.s + h * rs.h + d]) : 0.f;
      kk[t * LD + d] =
          in ? to_f32(k[b * ks.n + at * ks.s + h * ks.h + d]) : 0.f;
    }
    for (int i = tid; i < kChunk * kCols; i += kThreads) {
      const int t = i / kCols, e = i % kCols;
      vt[i] = (t < n && e0 + e < D)
                  ? to_f32(v[b * vs.n + (long long)(c0 + t) * vs.s +
                             h * vs.h + e0 + e])
                  : 0.f;
    }
    for (int d = tid; d < D; d += kThreads) {
      float run = 0.f;  // padded steps: log decay 0
      for (int t = 0; t < kChunk; ++t) {
        if (t < n)
          run += w[b * wst.n + (long long)(c0 + t) * wst.s + h * wst.h + d];
        la[t * LD + d] = run;
      }
    }
    __syncthreads();
    // ---- scores [t][s]: pairwise decays below the diagonal, the u bonus
    // on it ----
    for (int i = tid; i < kChunk * kChunk; i += kThreads) {
      const int t = i / kChunk, s = i % kChunk;
      float acc = 0.f;
      const float* rt = rr + t * LD;
      const float* ks_ = kk + s * LD;
      if (s < t) {
        const float* lp = la + (t - 1) * LD;  // la_prev of step t
        const float* ls = la + s * LD;
        for (int d = 0; d < D; ++d)
          acc = fmaf(rt[d] * ks_[d], expf(lp[d] - ls[d]), acc);
      } else if (s == t) {
        for (int d = 0; d < D; ++d) acc = fmaf(rt[d] * uh[d], ks_[d], acc);
      }
      sc[t * (kChunk + 1) + s] = acc;
    }
    __syncthreads();
    // r e^{la_prev} in place (the scores no longer need r)
    for (int i = tid; i < kChunk * D; i += kThreads) {
      const int t = i / D, d = i % D;
      if (t > 0) rr[t * LD + d] *= expf(la[(t - 1) * LD + d]);
    }
    __syncthreads();
    // ---- o [t][e] = (r e^{la_prev}) S + scores v ----
    for (int i = tid; i < kChunk * kCols; i += kThreads) {
      const int t = i / kCols, e = i % kCols;
      float acc = 0.f;
      for (int d = 0; d < D; ++d)
        acc = fmaf(rr[t * LD + d], St[d * kCols + e], acc);
      for (int s = 0; s <= t; ++s)
        acc = fmaf(sc[t * (kChunk + 1) + s], vt[s * kCols + e], acc);
      if (t < n && e0 + e < D)
        o[b * os.n + (long long)(c0 + t) * os.s + h * os.h + e0 + e] =
            from_f32<T>(acc);
    }
    __syncthreads();
    // k e^{la_c - la} in place
    const float* lc = la + (kChunk - 1) * LD;
    for (int i = tid; i < kChunk * D; i += kThreads) {
      const int t = i / D, d = i % D;
      kk[t * LD + d] *= expf(lc[d] - la[t * LD + d]);
    }
    __syncthreads();
    // ---- S <- e^{la_c} S + (k e^{la_c - la})^T v ----
    for (int i = tid; i < D * kCols; i += kThreads) {
      const int d = i / kCols, e = i % kCols;
      float acc = expf(lc[d]) * St[i];
      for (int s = 0; s < kChunk; ++s)
        acc = fmaf(kk[s * LD + d], vt[s * kCols + e], acc);
      St[i] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < D * kCols; i += kThreads) {
    const int d = i / kCols, e = i % kCols;
    if (e0 + e < D) sf[st0 + (long long)d * D + e0 + e] = St[i];
  }
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* w, const float* u, const float* s0, void* o,
                   float* sf, float* ws, int B, int S, int H, int D,
                   const Strides* st, cudaStream_t stream) {
  const size_t bytes = smem_bytes(D);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv_any_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
  }
  wkv_any_kernel<T><<<dim3((D + kCols - 1) / kCols, B * H), kThreads, bytes,
                       stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, static_cast<T*>(o), sf, ws, H, S, D,
      st[0], st[1], st[2], st[3], st[4]);
  return cudaGetLastError();
}

}  // namespace any_wkv
}  // namespace flame

// dtype: 0 = float32, 1 = bfloat16 (r, k, v and o); w_log, u, the states
// f32.  r, k, v, w_log, o [B, S, H, D] with strides: 15 int64, (batch, seq,
// head) of r, k, v, w_log, o; u [H, D]; state / state_out [B, H, D, D]
// contiguous (state null: zeros).  ws: ceil(D / 64) * B * H work areas of
// D * 64 + 96 * (D + 1) floats past head size 128, else null.
extern "C" int rwkv6_scan_any_fwd(const void* r, const void* k, const void* v,
                                  const void* w_log, const void* u,
                                  const void* state, void* o, void* state_out,
                                  void* ws, int dtype, int B, int S, int H,
                                  int D, const long long* strides,
                                  void* stream) {
  using namespace flame::any_wkv;
  using flame::Strides;
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || (long long)B * H > 65535 ||
      (D > kSmemMaxD) != (ws != nullptr))
    return cudaErrorInvalidValue;
  Strides st[5];
  for (int i = 0; i < 5; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w_log);
  const float* uf = static_cast<const float*>(u);
  const float* s0 = static_cast<const float*>(state);
  float* sf = static_cast<float*>(state_out);
  float* w = static_cast<float*>(ws);
  if (dtype == 0)
    return launch<float>(r, k, v, wf, uf, s0, o, sf, w, B, S, H, D, st, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, wf, uf, s0, o, sf, w, B, S, H, D,
                                 st, s);
  return cudaErrorInvalidValue;
}

// Launch plan: out = grid x, grid y, threads, dynamic shared bytes, the
// workspace's floats (0: the work area in shared memory).
extern "C" int rwkv6_scan_any_plan(int B, int H, int D, long long* out) {
  using namespace flame::any_wkv;
  if (B <= 0 || H <= 0 || D <= 0) return cudaErrorInvalidValue;
  out[0] = (D + kCols - 1) / kCols;
  out[1] = (long long)B * H;
  out[2] = kThreads;
  out[3] = (long long)smem_bytes(D);
  out[4] = D > kSmemMaxD ? out[0] * out[1] * area_floats(D) : 0;
  return cudaSuccess;
}
