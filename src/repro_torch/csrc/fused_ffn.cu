// Fused (RMSNorm +) FFN for Hopper (sm_90a) — kernel K3 of the port.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_ffn/kernel.py::
// fused_ffn_kernel (body _ffn_kernel).  It computes the same function:
//   out = act(n(x) @ W_up [* silu(n(x) @ W_gate)]) @ W_down
// for x [T, d], W_up / W_gate [d, f], W_down [f, d], where n is RMSNorm with
// a (1 + scale) gain and eps 1e-6 when has_norm is set (else the identity),
// act is gelu (tanh form), relu, or for swiglu silu(gate) * up.  Every
// product accumulates in f32 and the output rounds once to x's dtype.
//
// Design.  The TPU kernel walks d_ff blocks along a sequential grid axis,
// accumulating the [bt, d] down-projection in f32 VMEM scratch.  Here one
// block owns kRowsT = 16 rows of x and walks d_ff itself in tiles: it keeps
// the (normalized) rows in shared memory, stages one tile of W_up (W_gate)
// and W_down at a time in shared memory, computes the [16, tile] hidden tile
// (activation applied) into shared memory, and folds it into the f32
// accumulator of the down product, which lives in registers.  The [T, d_ff]
// hidden never reaches device memory — the point of the kernel.
//
// bf16 operands (the serving path) run both products on the tensor cores
// with mma.sync m16n8k16 (bf16 in, f32 accumulate), one 16-row m tile per
// block and 8 warps splitting the n tiles.  Weight tiles stream in with
// cp.async, each overlapped with the other product (W_up of the next tile
// during the down product, W_down during the next up product), and B
// fragments come from the row-major tiles through ldmatrix.trans.  The hidden is f32; it enters the
// down product as two bf16 terms, hi = bf16(h) and lo = bf16(h - hi), so the
// product keeps ~16 bits of it (the normalized x, when has_norm, the same
// way); bf16 x and weights are exact.  f32 operands run a scalar-FMA kernel
// of the same structure (no tensor-core type holds them exactly).
//
// Bound: at the Climber shapes (d 256, d_ff 1024) the function does
// 4 T d d_ff FLOPs on ~1 MB of weights, so it is bound by operations.  Every
// block re-reads the weights from L2, and mma.sync reaches a fraction of the
// wgmma rate; wgmma tiles and TMA-fed weight stages come later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace flame {
namespace ffn {

constexpr int kThreads = 256;
constexpr int kRowsT = 16;  // rows of x per block
constexpr int kTileF = 32;  // d_ff columns per tile
constexpr float kEps = 1e-6f;

enum Act { kGelu = 0, kRelu = 1, kSwiglu = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu(approximate=True)
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float silu(float x) {
  return x / (1.f + expf(-x));
}

// Shared-memory layout (floats): normalized rows [kRowsT][D + 1] (padded
// against bank conflicts), W_up tile [D][kTileF], W_gate tile (swiglu
// only), W_down tile [kTileF][D], hidden tile [kRowsT][kTileF].
template <int D>
__host__ __device__ constexpr int smem_floats(bool gated) {
  return kRowsT * (D + 1) + (gated ? 2 : 1) * D * kTileF + kTileF * D +
         kRowsT * kTileF;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fused_ffn_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                     const T* __restrict__ w_up, const T* __restrict__ w_gate,
                     const T* __restrict__ w_down, T* __restrict__ out, int T_,
                     int F, int act, int has_norm) {
  constexpr int XS = D + 1;
  constexpr int kAcc = kRowsT * D / kThreads;  // accumulator rows per thread
  constexpr int kColsPer = kRowsT * kTileF / kThreads;  // hidden per thread
  static_assert(kThreads % D == 0 || D % kThreads == 0, "column mapping");
  static_assert(kRowsT * D % kThreads == 0, "accumulator mapping");
  extern __shared__ __align__(16) float smem[];
  const bool gated = act == kSwiglu;
  float* xn = smem;                              // [kRowsT][XS]
  float* wu = xn + kRowsT * XS;                  // [D][kTileF]
  float* wg = wu + D * kTileF;                   // [D][kTileF] (swiglu)
  float* wd = wg + (gated ? D * kTileF : 0);     // [kTileF][D]
  float* hs = wd + kTileF * D;                   // [kRowsT][kTileF]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * kRowsT;

  // ---- stage x (normalized) ----
  for (int i = tid; i < kRowsT * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    xn[r * XS + c] = r0 + r < T_ ? to_f32(x[(long long)(r0 + r) * D + c]) : 0.f;
  }
  __syncthreads();
  if (has_norm) {
    for (int r = warp; r < kRowsT; r += kThreads / 32) {
      float ss = 0.f;
      for (int c = lane; c < D; c += 32) ss += xn[r * XS + c] * xn[r * XS + c];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      const float inv = rsqrtf(ss / D + kEps);
      for (int c = lane; c < D; c += 32)
        xn[r * XS + c] = xn[r * XS + c] * inv * (1.f + to_f32(scale[c]));
    }
  }

  // ---- thread roles ----
  // hidden tile: row hr, columns hc .. hc + kColsPer - 1
  const int hr = tid / (kTileF / kColsPer);
  const int hc = (tid - hr * (kTileF / kColsPer)) * kColsPer;
  // accumulator: column ac, rows ar0 + j * kRowStep
  constexpr int kRowStep = kThreads / D > 0 ? kThreads / D : 1;
  const int ac = tid % D;
  const int ar0 = tid / D;
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;

  for (int f0 = 0; f0 < F; f0 += kTileF) {
    const int nf = min(kTileF, F - f0);
    __syncthreads();  // the previous tile's readers are done (and xn ready)
    for (int i = tid; i < D * kTileF; i += kThreads) {
      const int kk = i / kTileF, c = i - kk * kTileF;
      const bool ok = c < nf;
      wu[i] = ok ? to_f32(w_up[(long long)kk * F + f0 + c]) : 0.f;
      if (gated) wg[i] = ok ? to_f32(w_gate[(long long)kk * F + f0 + c]) : 0.f;
    }
    for (int i = tid; i < kTileF * D; i += kThreads) {
      const int kk = i / D;
      wd[i] = kk < nf ? to_f32(w_down[(long long)(f0 + kk) * D + (i - kk * D)])
                      : 0.f;
    }
    __syncthreads();
    // hidden = act(xn @ W_up[:, tile] (, xn @ W_gate[:, tile]))
    {
      float up[kColsPer], gt[kColsPer];
#pragma unroll
      for (int j = 0; j < kColsPer; ++j) up[j] = gt[j] = 0.f;
      const float* xr = xn + hr * XS;
      for (int kk = 0; kk < D; ++kk) {
        const float a = xr[kk];
#pragma unroll
        for (int j = 0; j < kColsPer; ++j)
          up[j] = fmaf(a, wu[kk * kTileF + hc + j], up[j]);
        if (gated) {
#pragma unroll
          for (int j = 0; j < kColsPer; ++j)
            gt[j] = fmaf(a, wg[kk * kTileF + hc + j], gt[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kColsPer; ++j) {
        float h;
        if (act == kGelu)
          h = gelu_tanh(up[j]);
        else if (act == kRelu)
          h = fmaxf(up[j], 0.f);
        else
          h = silu(gt[j]) * up[j];
        hs[hr * kTileF + hc + j] = hc + j < nf ? h : 0.f;
      }
    }
    __syncthreads();
    // acc[r, c] += hidden[r, :] @ W_down[tile, c]
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int r = ar0 + j * kRowStep;
      const float* hrow = hs + r * kTileF;
      float a = acc[j];
      for (int kk = 0; kk < nf; ++kk) a = fmaf(hrow[kk], wd[kk * D + ac], a);
      acc[j] = a;
    }
  }
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int r = r0 + ar0 + j * kRowStep;
    if (r < T_) out[(long long)r * D + ac] = from_f32<T>(acc[j]);
  }
}

// ---------------------------------------------------------------------------
// bf16 operands: tensor-core tiles
// ---------------------------------------------------------------------------

constexpr int kTileFM = 64;        // d_ff columns per tile (8 warps x n 8)
constexpr int kWS = kTileFM + 8;   // row stride of hidden / W_up tiles

// Shared-memory layout (bf16), row strides padded by 16 bytes so the 8 rows
// of a fragment or ldmatrix read hit 8 different bank groups: x hi / lo
// [16][D + 8]; W_up and W_gate tiles [D][kWS] (row-major k x n, as in
// device memory); W_down tile [kTileFM][D + 8]; hidden hi / lo [16][kWS].
template <int D>
__host__ __device__ constexpr int mma_smem_elems(bool gated) {
  return 2 * kRowsT * (D + 8) + (gated ? 2 : 1) * D * kWS +
         kTileFM * (D + 8) + 2 * kRowsT * kWS;
}

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ unsigned pack2(__nv_bfloat16 a, __nv_bfloat16 b) {
  return static_cast<unsigned>(__bfloat16_as_ushort(a)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(b)) << 16);
}

// A fragment of the 16 x 16 row-major tile at column k0 of `m` (row stride
// ld): rows g / g + 8, column pairs 2t and 2t + 8.
__device__ __forceinline__ void load_a(unsigned* a, const __nv_bfloat16* m,
                                       int ld, int k0, int g, int t) {
  a[0] = ld32(m + g * ld + k0 + 2 * t);
  a[1] = ld32(m + (g + 8) * ld + k0 + 2 * t);
  a[2] = ld32(m + g * ld + k0 + 2 * t + 8);
  a[3] = ld32(m + (g + 8) * ld + k0 + 2 * t + 8);
}

// B fragment (16 x 8) of a row-major k x n tile, rows k0 .. k0 + 15 and
// columns n0 .. n0 + 7: ldmatrix transposes the two 8 x 8 halves so each
// thread holds its k pairs at column n0 + g.
__device__ __forceinline__ void load_b(unsigned* b, const __nv_bfloat16* m,
                                       int ld, int k0, int n0, int lane) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(
      m + (k0 + (lane & 15)) * ld + n0));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(addr));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage rows [0, nrows) x columns [c0, c0 + ncols_tile) of a row-major
// bf16 matrix (row stride ld) into a row-major tile (row stride dld):
// 16-byte asynchronous copies where the whole 8-column chunk lies inside
// [0, ncols) and 16-byte aligned; element copies otherwise; zeros past
// ncols.  Rows past nrows_valid are zero.
__device__ __forceinline__ void stage_tile(
    __nv_bfloat16* __restrict__ dst, int dld, const __nv_bfloat16* src,
    long long ld, int nrows, int nrows_valid, int c0, int ncols_tile,
    int ncols, bool vec_ok) {
  const int nvec = ncols_tile / 8;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < nrows * nvec; i += kThreads) {
    const int r = i / nvec, cv = (i - r * nvec) * 8;
    __nv_bfloat16* d = dst + r * dld + cv;
    const __nv_bfloat16* row = src + r * ld + c0 + cv;
    if (r < nrows_valid && vec_ok && cv + 8 <= ncols) {
      cp_async16(d, row);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        d[j] = r < nrows_valid && cv + j < ncols ? row[j] : zero;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    fused_ffn_mma_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ scale,
                         const __nv_bfloat16* __restrict__ w_up,
                         const __nv_bfloat16* __restrict__ w_gate,
                         const __nv_bfloat16* __restrict__ w_down,
                         __nv_bfloat16* __restrict__ out, int T_, int F,
                         int act, int has_norm) {
  constexpr int XS = D + 8;
  constexpr int kNT = D / 8 / (kThreads / 32);  // down n tiles per warp
  static_assert(D % 64 == 0, "8 warps split D / 8 n tiles");
  extern __shared__ __align__(16) __nv_bfloat16 sm[];
  const bool gated = act == kSwiglu;
  __nv_bfloat16* xh = sm;                          // [16][XS]
  __nv_bfloat16* xl = xh + kRowsT * XS;            // [16][XS] (has_norm)
  __nv_bfloat16* wu = xl + kRowsT * XS;            // [D][kWS]
  __nv_bfloat16* wg = wu + D * kWS;                // [D][kWS] (swiglu)
  __nv_bfloat16* wd = wg + (gated ? D * kWS : 0);  // [kTileFM][XS]
  __nv_bfloat16* hh = wd + kTileFM * XS;           // [16][kWS]
  __nv_bfloat16* hl = hh + kRowsT * kWS;           // [16][kWS]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kRowsT;
  // 16-byte copies need 8-element rows and 16-byte aligned bases
  const bool vec_ok =
      F % 8 == 0 &&
      (reinterpret_cast<uintptr_t>(w_up) | reinterpret_cast<uintptr_t>(
           w_down) | (gated ? reinterpret_cast<uintptr_t>(w_gate) : 0)) %
              16 == 0;
  auto stage_up = [&](int f0) {  // W_up (W_gate) columns f0 .. f0 + 63
    const int nf = min(kTileFM, F - f0);
    stage_tile(wu, kWS, w_up, F, D, D, f0, kTileFM, nf, vec_ok);
    if (gated) stage_tile(wg, kWS, w_gate, F, D, D, f0, kTileFM, nf, vec_ok);
    cp_async_commit();
  };
  auto stage_down = [&](int f0) {  // W_down rows f0 .. f0 + 63
    const int nf = min(kTileFM, F - f0);
    stage_tile(wd, XS, w_down + (long long)f0 * D, D, kTileFM, nf, 0, D, D,
               vec_ok);
    cp_async_commit();
  };

  stage_up(0);
  stage_down(0);
  // ---- stage x: bf16 as is, or RMSNorm in f32 split into hi + lo ----
  if (!has_norm) {
    for (int i = tid; i < kRowsT * D; i += kThreads) {
      const int r = i / D, c = i - r * D;
      xh[r * XS + c] = r0 + r < T_ ? x[(long long)(r0 + r) * D + c]
                                   : __float2bfloat16(0.f);
    }
  } else {
    for (int r = warp; r < kRowsT; r += kThreads / 32) {
      const bool live = r0 + r < T_;
      const __nv_bfloat16* xr = x + (long long)(r0 + r) * D;
      float ss = 0.f;
      for (int c = lane; c < D; c += 32) {
        const float v = live ? __bfloat162float(xr[c]) : 0.f;
        ss += v * v;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      const float inv = rsqrtf(ss / D + kEps);
      for (int c = lane; c < D; c += 32) {
        const float v = live ? __bfloat162float(xr[c]) * inv *
                                   (1.f + __bfloat162float(scale[c]))
                             : 0.f;
        const __nv_bfloat16 h = __float2bfloat16(v);
        xh[r * XS + c] = h;
        xl[r * XS + c] = __float2bfloat16(v - __bfloat162float(h));
      }
    }
  }
  cp_async_wait<1>();  // W_up (W_gate) of tile 0 has landed
  __syncthreads();

  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int f0 = 0; f0 < F; f0 += kTileFM) {
    const int nf = min(kTileFM, F - f0);
    // up (and gate) product: warp w owns hidden columns w * 8 .. w * 8 + 7
    {
      float cu[4] = {0.f, 0.f, 0.f, 0.f}, cg[4] = {0.f, 0.f, 0.f, 0.f};
      const int n0 = warp * 8;
#pragma unroll 4
      for (int k0 = 0; k0 < D; k0 += 16) {
        unsigned a[4], b[2], bg[2];
        load_a(a, xh, XS, k0, g, t);
        load_b(b, wu, kWS, k0, n0, lane);
        mma_bf16(cu, a, b);
        if (gated) {
          load_b(bg, wg, kWS, k0, n0, lane);
          mma_bf16(cg, a, bg);
        }
        if (has_norm) {
          load_a(a, xl, XS, k0, g, t);
          mma_bf16(cu, a, b);
          if (gated) mma_bf16(cg, a, bg);
        }
      }
      // activation in f32; columns past nf are zero
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        __nv_bfloat16 hi[2], lo[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 2 * half + j;
          float h;
          if (act == kGelu)
            h = gelu_tanh(cu[e]);
          else if (act == kRelu)
            h = fmaxf(cu[e], 0.f);
          else
            h = silu(cg[e]) * cu[e];
          if (n0 + 2 * t + j >= nf) h = 0.f;
          hi[j] = __float2bfloat16(h);
          lo[j] = __float2bfloat16(h - __bfloat162float(hi[j]));
        }
        const int r = g + 8 * half;
        *reinterpret_cast<unsigned*>(hh + r * kWS + n0 + 2 * t) =
            pack2(hi[0], hi[1]);
        *reinterpret_cast<unsigned*>(hl + r * kWS + n0 + 2 * t) =
            pack2(lo[0], lo[1]);
      }
    }
    cp_async_wait<0>();  // W_down of this tile has landed
    __syncthreads();     // hidden written; every warp is done with W_up
    const bool more = f0 + kTileFM < F;
    if (more) stage_up(f0 + kTileFM);  // in flight during the down product
    // down product: acc[16, D] += (hidden hi + lo) @ W_down tile
#pragma unroll
    for (int k0 = 0; k0 < kTileFM; k0 += 16) {
      unsigned ah[4], al[4];
      load_a(ah, hh, kWS, k0, g, t);
      load_a(al, hl, kWS, k0, g, t);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        unsigned b[2];
        load_b(b, wd, XS, k0, (warp * kNT + j) * 8, lane);
        mma_bf16(acc[j], ah, b);
        mma_bf16(acc[j], al, b);
      }
    }
    if (more) {
      __syncthreads();             // every warp is done with W_down
      stage_down(f0 + kTileFM);    // in flight during the next up product
      cp_async_wait<1>();          // the next W_up (W_gate) has landed
      __syncthreads();
    }
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int c = (warp * kNT + j) * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + g + 8 * half;
      if (r < T_)
        *reinterpret_cast<unsigned*>(out + (long long)r * D + c) =
            pack2(__float2bfloat16(acc[j][2 * half]),
                  __float2bfloat16(acc[j][2 * half + 1]));
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* x, const void* scale, const void* w_up,
                   const void* w_gate, const void* w_down, void* out, int T_,
                   int F, int act, int has_norm, cudaStream_t stream) {
  const int blocks = (T_ + kRowsT - 1) / kRowsT;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int bytes = mma_smem_elems<D>(act == kSwiglu) * 2;
    cudaError_t err = cudaFuncSetAttribute(
        fused_ffn_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        mma_smem_elems<D>(true) * 2);
    if (err != cudaSuccess) return err;
    fused_ffn_mma_kernel<D><<<blocks, kThreads, bytes, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(scale),
        static_cast<const T*>(w_up), static_cast<const T*>(w_gate),
        static_cast<const T*>(w_down), static_cast<T*>(out), T_, F, act,
        has_norm);
  } else {
    const int bytes = smem_floats<D>(act == kSwiglu) * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        fused_ffn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_floats<D>(true) * (int)sizeof(float));
    if (err != cudaSuccess) return err;
    fused_ffn_kernel<T, D><<<blocks, kThreads, bytes, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(scale),
        static_cast<const T*>(w_up), static_cast<const T*>(w_gate),
        static_cast<const T*>(w_down), static_cast<T*>(out), T_, F, act,
        has_norm);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* x, const void* scale,
                       const void* w_up, const void* w_gate,
                       const void* w_down, void* out, int T_, int F, int act,
                       int has_norm, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(x, scale, w_up, w_gate, w_down, out, T_, F, act,
                           has_norm, stream);
    case 256:
      return launch<T, 256>(x, scale, w_up, w_gate, w_down, out, T_, F, act,
                            has_norm, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace ffn
}  // namespace flame

// dtype: 0 = float32, 1 = bfloat16 (x, scale, weights and out share it; all
// contiguous, row-major).  act: 0 gelu, 1 relu, 2 swiglu (w_gate used).
// scale: the RMSNorm gain [d], read only when has_norm.
extern "C" int fused_ffn_fwd(const void* x, const void* scale,
                             const void* w_up, const void* w_gate,
                             const void* w_down, void* out, int dtype, int T,
                             int d, int F, int act, int has_norm,
                             void* stream) {
  using namespace flame::ffn;
  if (T <= 0 || F <= 0 || act < kGelu || act > kSwiglu ||
      (act == kSwiglu && w_gate == nullptr) || (has_norm && scale == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(d, x, scale, w_up, w_gate, w_down, out, T, F,
                             act, has_norm, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, x, scale, w_up, w_gate, w_down, out, T,
                                     F, act, has_norm, s);
  return cudaErrorInvalidValue;
}
