// Single-token GQA decode attention for Hopper (sm_90a) — kernel K4 of the
// port.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_decode/kernel.py::
// flash_decode_kernel (body _fd_kernel).  It computes the same function: for
// every row b and query head h, softmax(q . k^T) v over the cache positions
// [max(0, len - window), len) of its KV head (window 0: [0, len)), where
// len = lengths[b].  The softmax scale is folded into q by the wrapper, at
// the unpadded head dim, as the TPU wrapper does.  A row with len == 0 gives
// zeros (acc / max(l, 1e-30)).
//
// Design.  The TPU kernel carries m / l / acc in VMEM scratch across the
// sequential cache axis of its grid.  Here one block of kThreads threads
// owns one (row, KV head) pair and walks the valid range itself in tiles of
// Tile<D>::keys positions, keeping the online-softmax state in registers
// (acc, one slice per thread) and shared memory (m, l per query head).  All
// G = H / Hkv query heads of the KV head go together, as on the TPU, so
// every K/V element is read from device memory once per block.  No tile past
// len is read: traffic follows the valid prefix, and a padded cache (any
// fill) decodes bitwise like the tight one, since the tile boundaries start
// at the range's first position and never depend on the cache length.
//
// Bound: decode attention is bytes-bound; the least time is the valid K/V
// bytes over the memory rate.  This first version stages f32 tiles in shared
// memory with 16-byte loads (attention_common.cuh::load_tile) and computes
// with scalar f32 FMAs; tensor cores and a deeper load pipeline come later.
#include "attention_common.cuh"

namespace flame {

constexpr int kDecThreads = 128;
constexpr int kMaxG = 16;       // query heads per KV head
constexpr int kMaxGD = 1024;    // G * D elements of one block's queries
constexpr int kAccPer = kMaxGD / kDecThreads;

// (row, head) element strides of q / o, whose last axis is contiguous.
struct Strides2 {
  long long n, h;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kDecThreads)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, T* __restrict__ o,
                        int Hkv, int G, Strides2 qs, Strides ks, Strides vs,
                        Strides2 os, int window) {
  constexpr int BK = Tile<D>::keys;
  constexpr int kWarps = kDecThreads / 32;
  __shared__ __align__(16) float k_tile[BK * D];
  __shared__ __align__(16) float v_tile[BK * D];
  __shared__ __align__(16) float q_s[kMaxGD];
  __shared__ float p_s[kMaxG * BK];  // scores, then probabilities
  __shared__ float m_s[kMaxG], l_s[kMaxG], corr_s[kMaxG];

  const int b = blockIdx.x / Hkv;
  const int kvh = blockIdx.x - b * Hkv;
  const int len = lengths[b];
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gd = G * D;

  const T* qb = q + b * qs.n + (long long)kvh * G * qs.h;
  for (int i = tid; i < gd; i += kDecThreads) {
    const int g = i / D;
    q_s[i] = to_f32(qb[g * qs.h + (i - g * D)]);
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kAccPer];
#pragma unroll
  for (int j = 0; j < kAccPer; ++j) acc[j] = 0.f;

  const T* kb = k + b * ks.n + kvh * ks.h;
  const T* vb = v + b * vs.n + kvh * vs.h;
  for (int t0 = lo; t0 < len; t0 += BK) {
    const int n = min(BK, len - t0);
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(k_tile, kb + t0 * ks.s, ks.s, n, 1.f);
    load_tile<T, D>(v_tile, vb + t0 * vs.s, vs.s, n, 1.f);
    __syncthreads();
    // scores: one (head, key) pair per thread and step; the start of each
    // dot product rotates with the key so that the threads of a quarter
    // warp read different shared-memory banks
    for (int i = tid; i < G * BK; i += kDecThreads) {
      const int g = i / BK;
      const int t = i - g * BK;
      float s = kNegInf;
      if (t < n) {
        const float4* q4 = reinterpret_cast<const float4*>(q_s + g * D);
        const float4* k4 = reinterpret_cast<const float4*>(k_tile + t * D);
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
        for (int c = 0; c < D / 4; ++c) {
          const int e = (c + t) & (D / 4 - 1);
          const float4 a = q4[e], x = k4[e];
          s0 = fmaf(a.x, x.x, s0);
          s1 = fmaf(a.y, x.y, s1);
          s2 = fmaf(a.z, x.z, s2);
          s3 = fmaf(a.w, x.w, s3);
        }
        s = (s0 + s1) + (s2 + s3);
      }
      p_s[i] = s;
    }
    __syncthreads();
    // online-softmax update, one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, p_s[g * BK + t]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < BK; t += 32) {
        const float p = t < n ? expf(p_s[g * BK + t] - m_new) : 0.f;
        p_s[g * BK + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        corr_s[g] = c;
        l_s[g] = l_s[g] * c + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // acc[g, d] = acc[g, d] * corr[g] + sum_t p[g, t] v[t, d]
#pragma unroll
    for (int j = 0; j < kAccPer; ++j) {
      const int i = tid + j * kDecThreads;
      if (i < gd) {
        const int g = i / D;
        const int d = i - g * D;
        const float* pg = p_s + g * BK;
        float a = acc[j] * corr_s[g];
        for (int t = 0; t < n; ++t) a = fmaf(pg[t], v_tile[t * D + d], a);
        acc[j] = a;
      }
    }
  }
  __syncthreads();
  T* ob = o + b * os.n + (long long)kvh * G * os.h;
#pragma unroll
  for (int j = 0; j < kAccPer; ++j) {
    const int i = tid + j * kDecThreads;
    if (i < gd) {
      const int g = i / D;
      ob[g * os.h + (i - g * D)] = from_f32<T>(acc[j] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* o, int B, int Hkv, int G,
                   const long long* st, int window, cudaStream_t stream) {
  if (G > kMaxG || G * D > kMaxGD) return cudaErrorInvalidValue;
  const Strides2 qs{st[0], st[1]}, os{st[8], st[9]};
  const Strides ks{st[2], st[3], st[4]}, vs{st[5], st[6], st[7]};
  flash_decode_kernel<T, D><<<B * Hkv, kDecThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(o), Hkv, G, qs, ks,
      vs, os, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const int* lengths, void* o, int B, int Hkv, int G,
                       const long long* st, int window, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, lengths, o, B, Hkv, G, st, window, stream);
    case 64:
      return launch<T, 64>(q, k, v, lengths, o, B, Hkv, G, st, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, lengths, o, B, Hkv, G, st, window,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace flame

// dtype: 0 = float32, 1 = bfloat16 (q, caches and o share it).
// strides: 10 int64 — q (row, head); k (row, seq, head); v (row, seq, head);
// o (row, head); every last axis is contiguous.  lengths: B int32 on the
// device.  q is pre-scaled by the softmax scale.
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v,
                                const int* lengths, void* o, int dtype, int B,
                                int H, int Hkv, int D,
                                const long long* strides, int window,
                                void* stream) {
  using namespace flame;
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || window < 0 ||
      (long long)B * Hkv > 2147483647LL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, lengths, o, B, Hkv, G, strides,
                             window, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, lengths, o, B, Hkv, G,
                                     strides, window, s);
  return cudaErrorInvalidValue;
}
