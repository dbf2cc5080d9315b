// Shared pieces of the port's attention kernels (flash_attention.cu,
// cached_score.cuh for fused_score.cu and flash_decode.cu): element
// conversion, the shared-memory tile loader and the per-thread online-softmax
// state of one query row of the scalar kernels.
//
// Layout of work: one thread owns one query row.  It keeps the (pre-scaled)
// query and the f32 output accumulator in registers, and streams keys from
// f32 tiles in shared memory that the whole block loads together.  Every
// thread of a warp reads the same key at the same time, so each shared-memory
// read is a broadcast (no bank conflicts).  Softmax runs online in f32: the
// running max is refreshed once per chunk of kChunk keys, and a masked key
// adds an exact zero (it is skipped after its score is set to -1e30), which is
// what keeps fully masked rows and zero-length histories exact.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flame {

constexpr float kNegInf = -1e30f;
constexpr int kRows = 32;   // query rows (= threads) per block
constexpr int kChunk = 16;  // keys folded per online-softmax rescale

// Keys per shared-memory tile: the f32 K and V tiles take 2 * kTile * D * 4
// bytes, 32 KiB for D = 64 (static shared memory stays under 48 KiB).
template <int D>
struct Tile {
  static constexpr int keys = D <= 64 ? 64 : 32;
};

// Strides (in elements) of a rank-4 tensor whose last axis is contiguous:
// outer (batch or pool row), sequence, head.
struct Strides {
  long long n, s, h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// 16-byte packs of T: how many elements one uint4 load carries, and their
// conversion to f32 (bf16 is the high half of an f32; int8 sign-extends).
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float* o) {
    o[0] = __uint_as_float(v.x);
    o[1] = __uint_as_float(v.y);
    o[2] = __uint_as_float(v.z);
    o[3] = __uint_as_float(v.w);
  }
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void unpack(const uint4& v, float* o) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <>
struct Pack<int8_t> {
  static constexpr int n = 16;
  __device__ __forceinline__ static void unpack(const uint4& v, float* o) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[4 * i + j] = static_cast<float>(static_cast<int8_t>(w[i] >> (8 * j)));
  }
};

// Copy `n` rows of D elements (row stride `stride`) into a dense f32 tile,
// each element multiplied by `mul` (a dequantization scale, or 1).  Rows on
// 16-byte boundaries (every layout the serving path produces) move as
// 16-byte loads, kLoads of them in flight per thread before any is used —
// the loads, not the arithmetic, are what a block of one warp waits on.
// Other layouts take the element-wise loop.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src,
                                          long long stride, int n, float mul) {
  constexpr int V = Pack<T>::n;
  constexpr int kLoads = 8;
  if constexpr (D % V == 0) {
    if (reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
        (stride * static_cast<long long>(sizeof(T))) % 16 == 0) {
      constexpr int per_row = D / V;
      const int total = n * per_row;
      for (int e0 = threadIdx.x; e0 < total; e0 += kLoads * blockDim.x) {
        uint4 buf[kLoads];
#pragma unroll
        for (int g = 0; g < kLoads; ++g) {
          const int e = e0 + g * blockDim.x;
          if (e < total) {
            const int r = e / per_row;
            buf[g] = __ldg(reinterpret_cast<const uint4*>(
                src + r * stride + (e - r * per_row) * V));
          }
        }
#pragma unroll
        for (int g = 0; g < kLoads; ++g) {
          const int e = e0 + g * blockDim.x;
          if (e < total) {
            float f[V];
            Pack<T>::unpack(buf[g], f);
            float4* d4 = reinterpret_cast<float4*>(dst + e * V);
#pragma unroll
            for (int j = 0; j < V / 4; ++j)
              d4[j] = make_float4(f[4 * j] * mul, f[4 * j + 1] * mul,
                                  f[4 * j + 2] * mul, f[4 * j + 3] * mul);
          }
        }
      }
      return;
    }
  }
  for (int e = threadIdx.x; e < n * D; e += blockDim.x) {
    const int r = e / D;
    const int c = e - r * D;
    dst[e] = to_f32(src[r * stride + c]) * mul;
  }
}

template <int D>
struct Row {
  float q[D];
  float acc[D];
  float m;
  float l;

  __device__ __forceinline__ void reset() {
    m = kNegInf;
    l = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.f;
  }

  template <typename T>
  __device__ __forceinline__ void load_q(const T* __restrict__ src, bool live,
                                         float scale) {
#pragma unroll
    for (int d = 0; d < D; ++d) q[d] = live ? to_f32(src[d]) * scale : 0.f;
  }

  // q . k for one key row of a shared-memory tile (16-byte aligned); four
  // partial sums keep the FMA chain short.
  __device__ __forceinline__ float dot_tile(const float* __restrict__ k) const {
    const float4* k4 = reinterpret_cast<const float4*>(k);
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      const float4 x = k4[i];
      s0 = fmaf(q[4 * i], x.x, s0);
      s1 = fmaf(q[4 * i + 1], x.y, s1);
      s2 = fmaf(q[4 * i + 2], x.z, s2);
      s3 = fmaf(q[4 * i + 3], x.w, s3);
    }
    return (s0 + s1) + (s2 + s3);
  }

  // Fold keys [0, n) of a K/V tile pair; valid(t) masks key t.
  template <typename Valid>
  __device__ __forceinline__ void fold(const float* __restrict__ ks,
                                       const float* __restrict__ vs, int n,
                                       Valid valid) {
    for (int c0 = 0; c0 < n; c0 += kChunk) {
      float s[kChunk];
      unsigned ok = 0u;
      float mx = m;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int t = c0 + j;
        float x = kNegInf;
        if (t < n && valid(t)) {
          ok |= 1u << j;
          x = dot_tile(ks + t * D);
        }
        s[j] = x;
        mx = fmaxf(mx, x);
      }
      if (!ok) continue;  // nothing visible: the state is unchanged
      const float corr = expf(m - mx);
      l *= corr;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (ok & (1u << j)) {
          const float p = expf(s[j] - mx);
          l += p;
          const float4* v4 = reinterpret_cast<const float4*>(vs + (c0 + j) * D);
#pragma unroll
          for (int i = 0; i < D / 4; ++i) {
            const float4 x = v4[i];
            acc[4 * i] = fmaf(p, x.x, acc[4 * i]);
            acc[4 * i + 1] = fmaf(p, x.y, acc[4 * i + 1]);
            acc[4 * i + 2] = fmaf(p, x.z, acc[4 * i + 2]);
            acc[4 * i + 3] = fmaf(p, x.w, acc[4 * i + 3]);
          }
        }
      }
      m = mx;
    }
  }

  // Fold one key held in device memory (the SUMI self key of a candidate).
  template <typename T>
  __device__ __forceinline__ void fold_one(const T* __restrict__ k,
                                           const T* __restrict__ v) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) s = fmaf(q[d], to_f32(k[d]), s);
    const float mx = fmaxf(m, s);
    const float corr = expf(m - mx);
    const float p = expf(s - mx);
    l = l * corr + p;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = fmaf(p, to_f32(v[d]), acc[d] * corr);
    m = mx;
  }

  template <typename T>
  __device__ __forceinline__ void store(T* __restrict__ dst) const {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < D; ++d) dst[d] = from_f32<T>(acc[d] / den);
  }
};

}  // namespace flame
