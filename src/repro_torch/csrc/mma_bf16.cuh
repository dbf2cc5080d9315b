// Tensor-core and copy primitives shared by the port's bf16 kernels on the
// tensor cores (flash_attention.cu, fused_ffn.cu and ffn_wide.cuh, and
// cached_score.cuh for fused_score.cu and flash_decode.cu).
//
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) fragment layout, with
// g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major): a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..2t+1),
//                           a2 = (g, 2t+8..2t+9), a3 = (g + 8, 2t+8..2t+9)
//   B (16 x 8):             b0 = (2t..2t+1, g), b1 = (2t+8..2t+9, g)
//   C (16 x 8, f32):        c0, c1 = (g, 2t..2t+1), c2, c3 = (g + 8, 2t..2t+1)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flame {
namespace mma {

using bf16 = __nv_bfloat16;

// Registers only (not volatile), so the compiler may interleave
// independent products.
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         const unsigned* b) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned ld32(const bf16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ unsigned pack2(bf16 a, bf16 b) {
  return static_cast<unsigned>(__bfloat16_as_ushort(a)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(b)) << 16);
}

// f32 pair -> bf16 hi pair and the bf16 pair of what hi leaves out: hi + lo
// keeps ~16 significant bits of each value (each rounded to nearest even).
__device__ __forceinline__ unsigned cvt2(float x0, float x1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);  // x0 low
  return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ void split2(float x0, float x1, unsigned& hi,
                                       unsigned& lo) {
  hi = cvt2(x0, x1);
  lo = cvt2(x0 - __uint_as_float(hi << 16),
            x1 - __uint_as_float(hi & 0xffff0000u));
}

// The A fragment (16 x 16) of a row-major tile in shared memory: rows r0 ..
// r0 + 15, columns k0 .. k0 + 15 (ldmatrix of four 8 x 8 matrices in the
// order a0 .. a3 of the fragment).
__device__ __forceinline__ void load_a_x4(unsigned* a, const bf16* m, int ld,
                                          int r0, int k0, int lane) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(
      m + (r0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + k0 +
      ((lane >> 4) << 3)));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// Two B fragments (16 x 8) of the transpose of a row-major n x k tile
// (B[k][n] = m[n][k], as K for the scores q k^T): rows n0 .. n0 + 15, as
// n tiles n0 and n0 + 8 into b[0..1] and b[2..3], columns k0 .. k0 + 15;
// read as four untransposed 8 x 8 matrices.
__device__ __forceinline__ void load_b_rows_x4(unsigned* b, const bf16* m,
                                               int ld, int n0, int k0,
                                               int lane) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(
      m + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
      (((lane >> 3) & 1) << 3)));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(addr));
}

// Two B fragments (16 x 8) of a row-major k x n tile, rows k0 .. k0 + 15,
// columns n0 .. n0 + 7 into b[0..1] and n0 + 8 .. n0 + 15 into b[2..3]:
// ldmatrix transposes the 8 x 8 quarters so each thread holds its k pairs.
__device__ __forceinline__ void load_b_trans_x4(unsigned* b, const bf16* m,
                                                int ld, int k0, int n0,
                                                int lane) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(
      m + (k0 + (lane & 15)) * ld + n0 + ((lane >> 4) << 3)));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(addr));
}

// 2^x on the special-function unit (flushes denormal results to zero).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
               "l"(src));
}
// 16 bytes from src, or 16 zero bytes when !valid (src is not read then,
// but must still be a global address).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// wgmma (sm_90a): a warpgroup of 4 warps multiplies a 64-row A by B, both
// read from shared memory through descriptors, accumulating in registers
// laid out per warp as the mma.sync C fragment (warp w of the group holds
// rows 16 w .. 16 w + 15; d[4 i + e] is column 8 i + 2 t + (e & 1) of row
// g + 8 (e >> 1)).
//
// Operands use the 128-byte swizzle: a tile of ROWS rows is stored as
// blocks of 64 columns, each ROWS x 128 bytes, in which the 16-byte chunk q
// of row r sits at chunk q ^ (r % 8) (sw128 gives the byte offset of an
// element).  That is the layout a TMA box of 64 columns with
// CU_TENSOR_MAP_SWIZZLE_128B writes, and the one wgmma reads with layout
// type B128 (tiles 1024-byte aligned).  A K-major operand (rows along M)
// advances 32 bytes per k step of 16 inside a block, SBO = 1024 (8 rows);
// an MN-major one (rows along K) advances 2048 bytes per k step, SBO = 1024
// (8 k rows) and LBO = ROWS x 128 (the next 64 columns).
// ---------------------------------------------------------------------------

template <int ROWS>
__device__ __forceinline__ int sw128(int r, int c) {
  return (c >> 6) * (ROWS * 128) + r * 128 +
         ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, LBO and
// SBO in bytes (each stored divided by 16), layout type B128.
__device__ __forceinline__ uint64_t smem_desc(const void* p, unsigned lbo,
                                              unsigned sbo) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Orders this thread's shared-memory accesses through the generic proxy
// (plain stores and loads, cp.async, ldmatrix) with those of the async
// proxy (wgmma reads, TMA writes): writes made visible to wgmma, or reads
// done before TMA refills the slot; a barrier or an mbarrier arrival
// follows.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of wgmma accumulators across the
// wait that completes them.
template <int N>
__device__ __forceinline__ void reg_fence(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 32] += A[64 x 16] B[16 x 32] on the tensor cores, both operands
// read from shared memory by descriptor: A K-major, B MN-major (tnspB).
__device__ __forceinline__ void wgmma_n32(float* d, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128] on the tensor cores, both operands
// read from shared memory by descriptor: A K-major, B MN-major (tnspB).
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 16] B[16 x 256] on the tensor cores, both operands
// read from shared memory by descriptor: A K-major, B MN-major (tnspB).
__device__ __forceinline__ void wgmma_n256(float* d, uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// Waits until at most N of this thread's committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Warp-specialized kernels: a producer warpgroup gives registers back, the
// consumer warpgroups take them (every warp of the warpgroup runs it).
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Named barrier `id` over `threads` threads (barrier 0 is __syncthreads).
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ldmatrix on a tile of 128-byte rows (64 bf16) with the 128-byte swizzle
// that a TMA box writes (mma::sw128): the A fragment of rows r0 .. r0 + 15,
// columns k0 .. k0 + 15 (as load_a_x4), and two B fragments of the
// row-major k x n tile at rows k0 .. k0 + 15, columns n0 .. n0 + 15 (as
// load_b_trans_x4); k0 and n0 multiples of 8.
__device__ __forceinline__ unsigned sw128_addr(const void* tile, int r,
                                               int chunk) {
  return static_cast<unsigned>(__cvta_generic_to_shared(tile)) + r * 128 +
         ((chunk ^ (r & 7)) << 4);
}
__device__ __forceinline__ void load_a_x4_sw(unsigned* a, const void* tile,
                                             int r0, int k0, int lane) {
  const int r = r0 + (lane & 7) + (((lane >> 3) & 1) << 3);
  const unsigned addr = sw128_addr(tile, r, (k0 >> 3) + (lane >> 4));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}
__device__ __forceinline__ void load_b_trans_x4_sw(unsigned* b,
                                                   const void* tile, int k0,
                                                   int n0, int lane) {
  const int r = k0 + (lane & 15);
  const unsigned addr = sw128_addr(tile, r, (n0 >> 3) + (lane >> 4));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(addr));
}

// ---------------------------------------------------------------------------
// mbarrier and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// The barrier operations and copies below take a predicate `lead` and act
// only where it is set; every thread runs them, so no branch on the thread
// index sits between wgmma instructions (which would serialize them).
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count,
                                          int lead) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p mbarrier.init.shared::cta.b64 [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(count), "r"(lead)
      : "memory");
}
// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// The producer's arrival, announcing `bytes` of TMA copies to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes,
                                               int lead) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes), "r"(lead)
      : "memory");
}
// A consumer's arrival (where `lead` is set): it is done with the slot.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar, int lead) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(lead)
      : "memory");
}
// Waits until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// One 2-D TMA box (coordinates c0 along the columns, c1 along the rows) of
// the tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* tmap,
                                            uint64_t* bar, int c0, int c1,
                                            int lead) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"
      "@p cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n}\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar)), "r"(lead)
      : "memory");
}

// One 3-D TMA box (coordinates c0, c1, c2) of the tensor map into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const void* tmap,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int lead) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "@p cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n}\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar)), "r"(lead)
      : "memory");
}

// An attribute of the current device, read once per attribute.
template <cudaDeviceAttr A>
inline int device_attr(int fallback) {
  static const int n = [fallback] {
    int dev = 0, value = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&value, A, dev) != cudaSuccess)
      return fallback;
    return value;
  }();
  return n;
}
// Shared memory one block may opt in to (an H100's if the query fails).
inline int max_smem_optin() {
  return device_attr<cudaDevAttrMaxSharedMemoryPerBlockOptin>(232448);
}

}  // namespace mma
}  // namespace flame
