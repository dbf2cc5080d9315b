// Pieces shared by the two RWKV-6 wkv scan kernels of K5 (rwkv6_scan.cu,
// the tiled kernel at head sizes 32 and 64, and rwkv6_scan_any.cu at any
// head size): m16n8k8 TF32 fragments as hi + lo (any_mma.cuh's split) and
// their products, v's fragment (bf16 exact in TF32), the score blocks'
// index, four-element loads and the lane reduction of a pairwise tile.
#pragma once

#include "any_mma.cuh"

namespace flame {
namespace wkv {

using bf16 = __nv_bfloat16;

// Score block (i, j), j <= i, of the blocks on or below the diagonal, in
// row order.
__device__ __forceinline__ int blk(int i, int j) { return i * (i + 1) / 2 + j; }

// m16n8k8 TF32 fragments as hi + lo, g = lane / 4, q = lane % 4:
//   A (16 x 8): a0 = (g, q), a1 = (g + 8, q), a2 = (g, q + 4), a3 = (g + 8, q + 4)
//   B (8 x 8):  b0 = (q, g), b1 = (q + 4, g)
struct FragA {
  unsigned hi[4], lo[4];
  template <typename F>
  __device__ __forceinline__ void load(F f, int g, int q) {
    anymma::split(f(g, q), hi[0], lo[0]);
    anymma::split(f(g + 8, q), hi[1], lo[1]);
    anymma::split(f(g, q + 4), hi[2], lo[2]);
    anymma::split(f(g + 8, q + 4), hi[3], lo[3]);
  }
};
struct FragB {
  unsigned hi[2], lo[2];
  template <typename F>
  __device__ __forceinline__ void load(F f, int g, int q) {
    anymma::split(f(q, g), hi[0], lo[0]);
    anymma::split(f(q + 4, g), hi[1], lo[1]);
  }
};
// c += a b, both as hi + lo: three products, smallest first
__device__ __forceinline__ void mma3(float* c, const FragA& a,
                                     const FragB& b) {
  anymma::mma_tf32(c, a.lo, b.hi[0], b.hi[1]);
  anymma::mma_tf32(c, a.hi, b.lo[0], b.lo[1]);
  anymma::mma_tf32(c, a.hi, b.hi[0], b.hi[1]);
}

// B fragment of v (rows = steps, columns = value columns): bf16 is exact in
// TF32 (two products), f32 splits (three)
template <typename T>
struct VFrag;
template <>
struct VFrag<bf16> {
  unsigned b[2];
  __device__ __forceinline__ void load(const bf16* v, int pitch, int s0,
                                       int n0, int g, int q) {
    b[0] = __float_as_uint(__bfloat162float(v[(s0 + q) * pitch + n0 + g]));
    b[1] =
        __float_as_uint(__bfloat162float(v[(s0 + q + 4) * pitch + n0 + g]));
  }
  __device__ __forceinline__ void mma(float* c, const FragA& a) const {
    anymma::mma_tf32(c, a.lo, b[0], b[1]);
    anymma::mma_tf32(c, a.hi, b[0], b[1]);
  }
};
template <>
struct VFrag<float> {
  FragB f;
  __device__ __forceinline__ void load(const float* v, int pitch, int s0,
                                       int n0, int g, int q) {
    f.load([&](int kk, int nn) { return v[(s0 + kk) * pitch + n0 + nn]; }, g,
           q);
  }
  __device__ __forceinline__ void mma(float* c, const FragA& a) const {
    mma3(c, a, f);
  }
};

// Four consecutive elements as f32 (bf16: 8 bytes, f32: 16 bytes aligned)
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void load4(const bf16* p, float* o) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  o[0] = __uint_as_float(v.x << 16);
  o[1] = __uint_as_float(v.x & 0xffff0000u);
  o[2] = __uint_as_float(v.y << 16);
  o[3] = __uint_as_float(v.y & 0xffff0000u);
}

// Sums a tile's partial scores over the KP adjacent lanes that share it.
template <int KP>
__device__ __forceinline__ void reduce_tile(float (&acc)[4][4], float* bon) {
#pragma unroll
  for (int m = 1; m < KP; m <<= 1) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      bon[a] += __shfl_xor_sync(0xffffffffu, bon[a], m);
#pragma unroll
      for (int z = 0; z < 4; ++z)
        acc[a][z] += __shfl_xor_sync(0xffffffffu, acc[a][z], m);
    }
  }
}

}  // namespace wkv
}  // namespace flame
