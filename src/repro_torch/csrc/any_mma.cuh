// Pieces shared by the any-dims variants on the tensor cores (attention_any.cu,
// decode_any.cu, ffn_any.cu, rwkv6_scan_any.cu) and K5's kernels through
// wkv_mma.cuh: f32 operands as split TF32, 4- and 8-byte cp.async for rows
// whose pitch rules out 16-byte copies, and transposed ldmatrix fragments
// of row-major tiles.
//
// Split TF32: an f32 operand x enters
// mma.sync.m16n8k8 TF32 as hi = cvt.rna.tf32(x) and lo = x - hi, whose low
// 13 bits the tensor core ignores; a product takes lo*hi + hi*lo + hi*hi
// with f32 accumulation (lo*lo dropped): ~2^-21 of each operand is lost,
// where one TF32 rounding loses 2^-11.
//
// mma.sync.m16n8k8 TF32 fragment layout, with g = lane / 4, t = lane % 4:
//   A (16 x 8, row-major): a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4),
//                          a3 = (g + 8, t + 4)
//   B (8 x 8):             b0 = (t, g), b1 = (t + 4, g)
//   C (16 x 8, f32):       c0, c1 = (g, 2t..2t+1), c2, c3 = (g + 8, 2t..2t+1)
#pragma once

#include "mma_bf16.cuh"

namespace flame {
namespace anymma {

__device__ __forceinline__ float tf32(float x) {
  unsigned y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return __uint_as_float(y);
}

// x as TF32 hi + lo; the remainder by __fsub_rn, so that no instantiation
// contracts it with a product of x
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  const float h = tf32(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(x, h));
}

__device__ __forceinline__ void mma_tf32(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b for f32 fragments as three TF32 products (lo*hi, hi*lo, hi*hi,
// in that order), the A fragment already split (it is reused across n
// tiles), the B fragment b[2] split here.
__device__ __forceinline__ void mma_split_b(float* c, const unsigned* ah,
                                            const unsigned* al,
                                            const float* b) {
  unsigned bh[2], bl[2];
  split(b[0], bh[0], bl[0]);
  split(b[1], bh[1], bl[1]);
  mma_tf32(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

// N (4 or 8) bytes at dst: the first n from src, the rest zeros (src is
// not read when n is 0).
template <int N>
__device__ __forceinline__ void cp_async_zfill_n(void* dst, const void* src,
                                                 int n) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(addr),
               "l"(src), "n"(N), "r"(n));
}

// The barrier at bar counts one arrival of this thread once all of its
// earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   mma::smem_addr(bar))
               : "memory");
}

// The A fragment (16 x 16) of the transpose of a row-major bf16 tile m
// (A[i][k] = m[k][i]): k rows k0 .. k0 + 15, columns i0 .. i0 + 15, as
// four transposed 8 x 8 matrices in the order a0 .. a3 (rows 16-byte
// aligned).
__device__ __forceinline__ void load_a_trans_x4(unsigned* a,
                                                const __nv_bfloat16* m,
                                                int ld, int k0, int i0,
                                                int lane) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(
      m + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld + i0 +
      (((lane >> 3) & 1) << 3)));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// One B fragment (16 x 8) of a row-major bf16 k x n tile: rows k0 .. k0 +
// 15, columns n0 .. n0 + 7 (ldmatrix transposes the two 8 x 8 halves).
__device__ __forceinline__ void load_b_trans_x2(unsigned* b,
                                                const __nv_bfloat16* m,
                                                int ld, int k0, int n0,
                                                int lane) {
  const unsigned addr = static_cast<unsigned>(
      __cvta_generic_to_shared(m + (k0 + (lane & 15)) * ld + n0));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(addr));
}

}  // namespace anymma
}  // namespace flame
