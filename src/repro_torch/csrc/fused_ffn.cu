// Fused (RMSNorm +) FFN for Hopper (sm_90a) — kernel K3 of the port.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_ffn/kernel.py::
// fused_ffn_kernel (body _ffn_kernel).  It computes the same function:
//   out = act(n(x) @ W_up [* silu(n(x) @ W_gate)]) @ W_down
// for x [T, d], W_up / W_gate [d, f], W_down [f, d], where n is RMSNorm with
// a (1 + scale) gain and eps 1e-6 when has_norm is set (else the identity),
// act is gelu (tanh form), relu, or for swiglu silu(gate) * up.  Every
// product accumulates in f32 and the output rounds once to x's dtype.  The
// [T, d_ff] hidden never reaches device memory — the point of the kernel.
//
// Bound: at the Climber shapes (d 256, d_ff 1024) the function does
// 4 T d d_ff FLOPs on ~1 MB of weights, so it is bound by operations
// (1.1 us at T = 1028 on an H100).  What held the earlier version back was
// not the math: one block of 16 rows walked all of d_ff with mma.sync,
// streaming the whole 1 MB of weights through its shared memory (65 blocks
// at T = 1028, one at T = 4).
//
// Design of the bf16 kernel (the serving path):
// - d_ff split over the CTAs of a thread-block cluster: C = min(4, d_ff /
//   64) CTAs, each owning a contiguous range of 64-column d_ff tiles (256
//   columns at d_ff 1024) for an m tile of 64 rows, so each weight element
//   is read once per m tile and T = 4 runs on 4 SMs, T = 512 on 32, T = 1028
//   on 68;
// - both products with wgmma (two warpgroups, 64 rows each): the up product
//   [64 x 64] of a tile splits its columns between the warpgroups, the
//   down product its output columns; A and B come from shared memory;
// - weight tiles (and x) arrive by TMA in 64-column boxes with the 128-byte
//   swizzle that wgmma reads, two slots deep, counted on mbarriers; the next
//   tile's copies go out while the up product runs.  Weights whose rows are
//   not 16-byte aligned (d_ff not a multiple of 8) take cp.async or element
//   copies into the same layout;
// - the f32 hidden enters the down product as two bf16 terms, hi = bf16(h)
//   and lo = bf16(h - hi), keeping ~16 bits of it (the normalized x, when
//   has_norm, the same way); bf16 x and weights are exact.  Rounding the
//   hidden once to bf16 would break the bf16 gate near small outputs;
// - the C partial [64, d] f32 products are summed through distributed
//   shared memory in rank order 0 .. C-1, each CTA summing and storing its
//   share of the output.  No atomics.  The split and the order depend on
//   d_ff alone and tensor-core rows are independent, so a row's output does
//   not depend on T or on which rows share its tile: bitwise.
// What bounds it now is latency inside a CTA, not either roofline: per
// tile the up product, the activation and the down product run one after
// the other, and the cluster's reduction of the f32 partials (reads of
// distributed shared memory) is a large fixed part at 64 rows.
// f32 operands run a scalar-FMA kernel (one block of 16 rows walking d_ff;
// no tensor-core type holds f32 exactly).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <cudaTypedefs.h>  // CUtensorMap, PFN_cuTensorMapEncodeTiled
#include <string.h>

#include <type_traits>

#include "mma_bf16.cuh"

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

// The same two activations on the special-function unit, for the bf16
// kernel: gelu_tanh(x) = x sigmoid(2 u) with u = sqrt(2 / pi) (x + 0.044715
// x^3) is the tanh form rewritten, and silu(x) = x sigmoid(x); 2^y and the
// division are approximate to ~1e-6 relative, far inside a bf16 output's
// rounding.
__device__ __forceinline__ float sigmoid_fast(float z) {
  return __fdividef(1.f, 1.f + mma::ex2(-1.4426950408889634f * z));
}
__device__ __forceinline__ float gelu_fast(float x) {
  const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return x * sigmoid_fast(2.f * u);
}
__device__ __forceinline__ float silu_fast(float x) {
  return x * sigmoid_fast(x);
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
      for (int o = 16; o > 0; o >>= 1)
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
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
// bf16 operands: tensor-core tiles, d_ff split over a cluster
// ---------------------------------------------------------------------------

using mma::bf16;
namespace cg = cooperative_groups;

constexpr int kTileFM = 64;        // d_ff columns per tile
constexpr int kMaxCluster = 4;     // CTAs sharing an m tile's d_ff
constexpr int kRowsW = 64;         // rows of x per CTA (one wgmma m tile)

// CTAs per cluster: fixed by d_ff alone, so the order in which a row's
// partial sums meet never depends on T.
__host__ __device__ inline int cluster_for(int F) {
  const int tiles = (F + kTileFM - 1) / kTileFM;
  return tiles < kMaxCluster ? tiles : kMaxCluster;
}

// Stage rows [0, ROWS) x columns [0, 8 NCH) of a row-major bf16 matrix
// (row stride ld) as 16-byte chunks at mma::sw128<ROWS>: asynchronous
// copies where the chunk lies inside [0, ncols) and `vec` (16-byte aligned
// rows), element copies otherwise; zeros past ncols and past nrows_valid.
template <int NCH, int ROWS>
__device__ __forceinline__ void stage_chunks(bf16* __restrict__ dst,
                                             const bf16* src, long long ld,
                                             int nrows_valid, int ncols,
                                             bool vec) {
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < ROWS * NCH; i += kThreads) {
    const int r = i / NCH, q = i - r * NCH;
    bf16* d = dst + mma::sw128<ROWS>(r, 8 * q) / 2;
    const bf16* row = src + r * ld + q * 8;
    if (r >= nrows_valid) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    } else if (vec && q * 8 + 8 <= ncols) {
      mma::cp_async16(d, row);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) d[j] = q * 8 + j < ncols ? row[j] : zero;
    }
  }
}

// Dynamic shared bytes of the bf16 kernel with `ns` weight slots.
__host__ __device__ inline int wgmma_smem_bytes(int D, int ns, bool gated,
                                                bool norm) {
  const int slots = ns * (gated ? 3 : 2) * D * kTileFM * 2;
  const int partial = kRowsW * D * 4;
  return (norm ? 2 : 1) * kRowsW * D * 2 +
         (slots > partial ? slots : partial) + 2 * kRowsW * kTileFM * 2 +
         16;  // the slots' barriers
}

// Index of (row r, column c) in the f32 partial [kRowsW][D]: columns XOR-ed
// with 4 (r % 8) so that the 8 rows a warp writes at once fall in different
// banks; groups of 4 columns stay contiguous.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + (c ^ ((r & 7) << 2));
}

// The TMA tensor maps of one call (bf16, 64-column boxes, 128-byte
// swizzle): W_up / W_gate [D, F] in boxes of D rows; x [T, D] and W_down
// [F, D] in boxes of kRowsW / kTileFM rows and all D / 64 column blocks at
// once (a third dimension over the blocks).
struct Maps {
  CUtensorMap x, up, gate, down;
};

// GATED (swiglu) and NORM (has_norm) are template arguments so that no
// branch sits between the wgmma instructions of a product, which would make
// the compiler serialize them.
template <int D, bool GATED, bool NORM>
__global__ void __launch_bounds__(kThreads, 1)
    fused_ffn_wgmma_kernel(const __grid_constant__ Maps maps,
                           const bf16* __restrict__ x,
                           const bf16* __restrict__ scale,
                           const bf16* __restrict__ w_up,
                           const bf16* __restrict__ w_gate,
                           const bf16* __restrict__ w_down,
                           bf16* __restrict__ out, int T_, int F, int act,
                           int ns, int tma) {
  constexpr int XC = D / 8;        // 16-byte chunks of an x / W_down row
  constexpr int UC = kTileFM / 8;  // chunks of a W_up / hidden row
  constexpr int ND = D / 2;        // output columns per warpgroup
  static_assert(D == 64 || D == 256, "model widths of the kernel");
  extern __shared__ __align__(1024) bf16 sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = cluster_for(F);  // the launch's cluster size
  const int rank = static_cast<int>(cluster.block_rank());
  // x hi (and lo) [kRowsW][D]; `ns` slots of W_up [D][64], W_gate (swiglu)
  // and W_down [64][D]; hidden hi / lo [kRowsW][64] — all 128-byte
  // swizzled (mma::sw128); the f32 partial [kRowsW][D] (swz) reuses the
  // slots
  bf16* xh = sm;
  bf16* xl = xh + kRowsW * D;
  bf16* slots = sm + (NORM ? 2 : 1) * kRowsW * D;
  constexpr int slot = (GATED ? 3 : 2) * D * kTileFM;
  bf16* hh = slots + ns * slot;
  bf16* hl = hh + kRowsW * kTileFM;
  float* part = reinterpret_cast<float*>(slots);
  auto at = [](bf16* base, int offset) {
    return reinterpret_cast<bf16*>(reinterpret_cast<char*>(base) + offset);
  };
  // one barrier per weight slot, after everything else
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      at(sm, wgmma_smem_bytes(D, ns, GATED, NORM) - 16));

  const int tid = threadIdx.x;
  const int wg = tid >> 7;                 // warpgroup 0 / 1
  const int wr = ((tid >> 5) & 3) * 16;    // this warp's first row
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (blockIdx.x / C) * kRowsW;
  // this CTA's d_ff tiles: a balanced split fixed by d_ff
  const int n_tiles = (F + kTileFM - 1) / kTileFM;
  const int tb = rank * n_tiles / C;
  const int nt = (rank + 1) * n_tiles / C - tb;
  const int lead = tid == 0;  // the thread that issues the TMA copies
  if (tma) {
    for (int s = 0; s < ns; ++s) mma::mbar_init(&bars[s], 1, lead);
    mma::fence_mbar_init();
  }
  __syncthreads();
  // stage this CTA's tile i (W_up, W_gate columns and W_down rows f0 ..
  // f0 + 63; with the first tile also x) into ring slot i % ns: TMA boxes
  // issued by one thread and counted on the slot's barrier, or (weights
  // whose rows are not 16-byte aligned) cp.async copies by every thread as
  // one group.  Rows and columns past the matrices are zeros either way.
  auto issue = [&](int i) {
    const int f0 = (tb + i) * kTileFM;
    bf16* wu = slots + (i % ns) * slot;
    bf16* wgt = wu + D * kTileFM;
    bf16* wd = wu + (GATED ? 2 : 1) * D * kTileFM;
    const bool with_x = i == 0 && !NORM;
    if (tma) {
      uint64_t* bar = &bars[i % ns];
      mma::mbar_expect_tx(bar, 2 * (slot + (with_x ? kRowsW * D : 0)), lead);
      if (with_x) mma::tma_load_3d(xh, &maps.x, bar, 0, r0, 0, lead);
      mma::tma_load_2d(wu, &maps.up, bar, f0, 0, lead);
      if constexpr (GATED) mma::tma_load_2d(wgt, &maps.gate, bar, f0, 0, lead);
      mma::tma_load_3d(wd, &maps.down, bar, 0, f0, 0, lead);
    } else {
      const int nf = min(kTileFM, F - f0);
      if (with_x)
        stage_chunks<XC, kRowsW>(xh, x + (long long)r0 * D, D,
                                 max(0, min(kRowsW, T_ - r0)), D,
                                 reinterpret_cast<uintptr_t>(x) % 16 == 0);
      stage_chunks<UC, D>(wu, w_up + f0, F, D, nf, false);
      if constexpr (GATED)
        stage_chunks<UC, D>(wgt, w_gate + f0, F, D, nf, false);
      stage_chunks<XC, kTileFM>(wd, w_down + (long long)f0 * D, D, nf, D,
                                false);
      mma::cp_async_commit();
    }
  };
  auto wait_tile = [&](int i, bool next_issued) {
    if (tma)
      mma::mbar_wait(&bars[i % ns], (i / ns) & 1);
    else if (next_issued)
      mma::cp_async_wait<1>();
    else
      mma::cp_async_wait<0>();
  };

  // ---- x: bf16 as is (with the first tile), or RMSNorm in f32 split into
  // hi + lo; rows past T are zero ----
  issue(0);
  if constexpr (NORM) {
    const int warp = tid >> 5;
    for (int r = warp; r < kRowsW; r += kThreads / 32) {
      const bool live = r0 + r < T_;
      const bf16* xr = x + (long long)(r0 + r) * D;
      float ss = 0.f;
      for (int c = lane; c < D; c += 32) {
        const float v = live ? __bfloat162float(xr[c]) : 0.f;
        ss += v * v;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
      const float inv = rsqrtf(ss / D + kEps);
      for (int c = lane; c < D; c += 32) {
        const float v = live ? __bfloat162float(xr[c]) * inv *
                                   (1.f + __bfloat162float(scale[c]))
                             : 0.f;
        const bf16 h = __float2bfloat16(v);
        const int off = mma::sw128<kRowsW>(r, c);
        *at(xh, off) = h;
        *at(xl, off) = __float2bfloat16(v - __bfloat162float(h));
      }
    }
  }

  // this warpgroup's [64, ND] of the partial product: the hidden's hi
  // terms in acc[0], its lo terms in acc[1]
  float acc[2][ND / 2];
#pragma unroll
  for (int e = 0; e < ND / 2; ++e) acc[0][e] = acc[1][e] = 0.f;

  for (int i = 0; i < nt; ++i) {
    const bool next = ns > 1 && i + 1 < nt;
    // cp.async copies of the next tile go out here, TMA ones during the up
    // product below
    if (!tma && next) issue(i + 1);
    wait_tile(i, !tma && next);
    mma::fence_async_smem();      // this thread's plain stores, for wgmma
    __syncthreads();              // tile i (and x) landed for every warp
    const int nf = min(kTileFM, F - (tb + i) * kTileFM);
    bf16* wu = slots + (i % ns) * slot;
    bf16* wgt = wu + D * kTileFM;
    bf16* wd = wu + (GATED ? 2 : 1) * D * kTileFM;
    // up (and gate) product: warpgroup wg computes hidden columns 32 wg ..
    // 32 wg + 31 of the tile for all 64 rows, with two accumulators per
    // product (the k range in halves) issued in turn so that neighbouring
    // wgmmas do not wait on each other; added once, in the same order for
    // every T
    float cu[2][16], cgt[2][16];
#pragma unroll
    for (int e = 0; e < 16; ++e)
      cu[0][e] = cu[1][e] = cgt[0][e] = cgt[1][e] = 0.f;
    mma::wgmma_fence();
#pragma unroll
    for (int k2 = 0; k2 < D / 32; ++k2) {
#pragma unroll
      for (int hk = 0; hk < 2; ++hk) {
        const int kk = k2 + hk * (D / 32);
        const int xo = (kk >> 2) * kRowsW * 128 + (kk & 3) * 32;
        const int ub = 64 * wg + 2048 * kk;  // columns 32 wg.., rows 16 kk..
        const uint64_t da = mma::smem_desc(at(xh, xo), 16, 1024);
        mma::wgmma_n32(cu[hk], da, mma::smem_desc(at(wu, ub), D * 128, 1024));
        if constexpr (GATED)
          mma::wgmma_n32(cgt[hk], da,
                         mma::smem_desc(at(wgt, ub), D * 128, 1024));
        if constexpr (NORM) {
          const uint64_t dl = mma::smem_desc(at(xl, xo), 16, 1024);
          mma::wgmma_n32(cu[hk], dl,
                         mma::smem_desc(at(wu, ub), D * 128, 1024));
          if constexpr (GATED)
            mma::wgmma_n32(cgt[hk], dl,
                           mma::smem_desc(at(wgt, ub), D * 128, 1024));
        }
      }
    }
    mma::wgmma_commit();
    // the next tile's TMA copies go out while the up product runs; its
    // slot's last readers finished with the previous tile
    if (tma && next) issue(i + 1);
    mma::wgmma_wait_all();
    mma::reg_fence<16>(cu[0]);
    mma::reg_fence<16>(cu[1]);
    if constexpr (GATED) {
      mma::reg_fence<16>(cgt[0]);
      mma::reg_fence<16>(cgt[1]);
    }
    // activation in f32 (columns past nf are zero), hidden as bf16 hi + lo
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = 32 * wg + 8 * j + 2 * t;
        float h[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int e = 4 * j + 2 * half + q;
          const float up = cu[0][e] + cu[1][e];
          if (act == kGelu)
            h[q] = gelu_fast(up);
          else if (act == kRelu)
            h[q] = fmaxf(up, 0.f);
          else
            h[q] = silu_fast(cgt[0][e] + cgt[1][e]) * up;
          if (c + q >= nf) h[q] = 0.f;
        }
        unsigned hi, lo;
        mma::split2(h[0], h[1], hi, lo);
        const int off = mma::sw128<kRowsW>(wr + g + 8 * half, c);
        *reinterpret_cast<unsigned*>(at(hh, off)) = hi;
        *reinterpret_cast<unsigned*>(at(hl, off)) = lo;
      }
    }
    mma::fence_async_smem();
    __syncthreads();  // the hidden tile is written
    // down product: warpgroup wg adds (hidden hi + lo) @ W_down tile to its
    // output columns ND wg .. ND wg + ND - 1, the hi terms into acc[0] and
    // the lo terms into acc[1], in turn
    mma::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileFM / 16; ++kk) {
      const uint64_t db = mma::smem_desc(
          at(wd, (ND * wg / 64) * kTileFM * 128 + (ND * wg % 64) * 2 +
                     2048 * kk),
          kTileFM * 128, 1024);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const uint64_t da = mma::smem_desc(at(p ? hl : hh, 32 * kk), 16, 1024);
        if constexpr (ND == 128)
          mma::wgmma_n128(acc[p], da, db);
        else
          mma::wgmma_n32(acc[p], da, db);
      }
    }
    mma::wgmma_commit();
    mma::wgmma_wait_all();
    mma::reg_fence<ND / 2>(acc[0]);
    mma::reg_fence<ND / 2>(acc[1]);
    __syncthreads();  // every warp is done with this slot and the hidden
    if (ns == 1 && i + 1 < nt) issue(i + 1);
  }

  // ---- partial [64, D] in f32 to shared memory; the cluster sums it ----
#pragma unroll
  for (int j = 0; j < ND / 8; ++j) {
    const int c = ND * wg + 8 * j + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wr + g + 8 * half;
      *reinterpret_cast<float2*>(part + swz<D>(r, c)) =
          make_float2(acc[0][4 * j + 2 * half] + acc[1][4 * j + 2 * half],
                      acc[0][4 * j + 2 * half + 1] +
                          acc[1][4 * j + 2 * half + 1]);
    }
  }
  cluster.sync();  // every CTA's partial is written
  // this CTA's share of the outputs, in groups of 4 columns: each thread
  // first loads kBatch groups from every rank (the loads in flight
  // together), then sums them in rank order 0 .. C-1 and stores bf16
  constexpr int kG = D / 4;  // column groups per row
  constexpr int kBatch = 4;
  const int rows = min(kRowsW, T_ - r0);
  const int gb = rank * (rows * kG) / C, ge = (rank + 1) * (rows * kG) / C;
  for (int g0 = gb + tid; g0 < ge; g0 += kBatch * kThreads) {
    float4 v[kBatch][kMaxCluster];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int gi = g0 + u * kThreads;
      const int r = gi / kG, c = (gi - r * kG) * 4;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (gi < ge && q < C)
          v[u][q] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(part + swz<D>(r, c), q));
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int gi = g0 + u * kThreads;
      if (gi < ge) {
        const int r = gi / kG, c = (gi - r * kG) * 4;
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int q = 0; q < kMaxCluster; ++q)
          if (q < C) {
            sum.x += v[u][q].x;
            sum.y += v[u][q].y;
            sum.z += v[u][q].z;
            sum.w += v[u][q].w;
          }
        *reinterpret_cast<uint2*>(out + (long long)(r0 + r) * D + c) =
            make_uint2(mma::cvt2(sum.x, sum.y), mma::cvt2(sum.z, sum.w));
      }
    }
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

// Weight slots of the ring: two if they fit, else one.
inline int slots_for(int D, bool gated, bool norm) {
  return wgmma_smem_bytes(D, 2, gated, norm) <= mma::max_smem_optin() ? 2 : 1;
}

// cuTensorMapEncodeTiled of the driver, found through the runtime (no link
// against the driver library); null if the driver lacks it.
inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// A 2-D map of a row-major bf16 matrix [rows, cols] (row stride ld
// elements) read in boxes of 64 columns x box_rows rows with the 128-byte
// swizzle; out-of-range elements read as zeros.
inline bool encode_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                       long long ld, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The same matrix (cols a multiple of 64) as a 3-D map over (64 columns,
// rows, column blocks), so that one box of box_rows rows brings every
// block.
inline bool encode_map_wide(CUtensorMap* map, const void* ptr, int rows,
                            int cols, long long ld, int box_rows) {
  const cuuint64_t dims[3] = {64, static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(cols / 64)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * 2, 128};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows),
                             static_cast<cuuint32_t>(cols / 64)};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool GATED, bool NORM>
cudaError_t launch_wgmma(const void* x, const void* scale, const void* w_up,
                         const void* w_gate, const void* w_down, void* out,
                         int T_, int F, int act, cudaStream_t stream) {
  const int C = cluster_for(F);
  const int ns = slots_for(D, GATED, NORM);
  const int bytes = wgmma_smem_bytes(D, ns, GATED, NORM);
  // TMA needs 16-byte aligned bases and row strides
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  const bool aligned =
      F % 8 == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w_up) |
        reinterpret_cast<uintptr_t>(w_down) |
        (GATED ? reinterpret_cast<uintptr_t>(w_gate) : 0)) %
       16) == 0;
  const int tma = aligned && encode_tiled() != nullptr &&
                  encode_map(&maps.up, w_up, D, F, F, D) &&
                  (!GATED || encode_map(&maps.gate, w_gate, D, F, F, D)) &&
                  encode_map_wide(&maps.x, x, T_, D, D, kRowsW) &&
                  encode_map_wide(&maps.down, w_down, F, D, D, kTileFM);
  auto kernel = fused_ffn_wgmma_kernel<D, GATED, NORM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((T_ + kRowsW - 1) / kRowsW) * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, kernel, maps, static_cast<const bf16*>(x),
      static_cast<const bf16*>(scale), static_cast<const bf16*>(w_up),
      static_cast<const bf16*>(w_gate), static_cast<const bf16*>(w_down),
      static_cast<bf16*>(out), T_, F, act, ns, tma);
}

template <int D>
cudaError_t launch_wgmma(const void* x, const void* scale, const void* w_up,
                         const void* w_gate, const void* w_down, void* out,
                         int T_, int F, int act, int has_norm,
                         cudaStream_t stream) {
  const bool gated = act == kSwiglu;
  if (gated && has_norm)
    return launch_wgmma<D, true, true>(x, scale, w_up, w_gate, w_down, out,
                                       T_, F, act, stream);
  if (gated)
    return launch_wgmma<D, true, false>(x, scale, w_up, w_gate, w_down, out,
                                        T_, F, act, stream);
  if (has_norm)
    return launch_wgmma<D, false, true>(x, scale, w_up, w_gate, w_down, out,
                                        T_, F, act, stream);
  return launch_wgmma<D, false, false>(x, scale, w_up, w_gate, w_down, out,
                                       T_, F, act, stream);
}

template <typename T, int D>
cudaError_t launch(const void* x, const void* scale, const void* w_up,
                   const void* w_gate, const void* w_down, void* out, int T_,
                   int F, int act, int has_norm, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_wgmma<D>(x, scale, w_up, w_gate, w_down, out, T_, F, act,
                           has_norm, stream);
  } else {
    const int blocks = (T_ + kRowsT - 1) / kRowsT;
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
    return cudaGetLastError();
  }
}

}  // namespace ffn
}  // namespace flame

#include "ffn_wide.cuh"

namespace flame {
namespace ffn {

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

// The wide form (ffn_wide.cuh), for bf16 x [T, d] and weights [d, F] /
// [F, d] with d and F multiples of 8 and 16-byte aligned bases.  path 0
// (decode sizes: the wrapper takes it up to WIDE_DECODE_T = 32 rows):
// stream_kernel, 240 CTAs of 16 rows x 64 d_ff columns at gemma3-12b's
// d_ff 15360, streams the weights through a TMA ring, bound by their bytes
// (236 MB a layer: 0.070 ms at an H100 80GB HBM3's 3.35 TB/s, 700 W), then
// reduce_kernel sums the slices' f32 partials.  path 1 (prefill sizes):
// up_kernel and down_kernel, persistent wgmma GEMMs fed by TMA, the hidden
// in device memory as bf16 hi + lo planes; bound by the products (0.477 ms
// of bf16 FLOPs at gemma3-12b's T 2000 at the same card's 989 TFLOP/s,
// 0.716 ms of tensor-core work with the lo term).  ws: the workspace
// fused_ffn_wide_plan reports (out[10]).  Returns the first CUDA error of
// the launches.
extern "C" int fused_ffn_wide_fwd(const void* x, const void* scale,
                                  const void* w_up, const void* w_gate,
                                  const void* w_down, void* out, void* ws,
                                  int T, int d, int F, int act, int has_norm,
                                  int path, void* stream) {
  using namespace flame::ffn;
  if (T <= 0 || d <= 0 || F <= 0 || d % 8 || F % 8 || act < kGelu ||
      act > kSwiglu || (act == kSwiglu && w_gate == nullptr) ||
      (has_norm && scale == nullptr) ||
      (path != wide::kDecode && path != wide::kPrefill) ||
      (F + wide::kSlice - 1) / wide::kSlice > 65535)
    return cudaErrorInvalidValue;
  return wide::launch(path, x, scale, w_up, w_gate, w_down, out, ws, T, d, F,
                      act, has_norm, static_cast<cudaStream_t>(stream));
}

// The wide form's launch for T rows on `path`: out[0] path, out[1] kernels,
// out[2..5] and out[6..9] grid, threads, dynamic shared bytes and ring
// stages of the two main kernels (stream + reduce, or up + down),
// out[10] workspace bytes, out[11..12] rows and columns of the first
// kernel's tiles, out[13..14] each kernel's tiles, out[15..16] rows and
// columns of the second kernel's tiles (0 for the reduction).
extern "C" int fused_ffn_wide_plan(int T, int d, int F, int act,
                                   int has_norm, int path, long long* out) {
  using namespace flame::ffn;
  if (T <= 0 || d <= 0 || F <= 0 ||
      (path != wide::kDecode && path != wide::kPrefill))
    return cudaErrorInvalidValue;
  wide::plan(path, T, d, F, act == kSwiglu, has_norm != 0, out);
  return cudaSuccess;
}

// Launch plan of the kernel for these shapes: out[0..5] = grid, CTAs per
// cluster, threads per block, rows of x per CTA, dynamic shared-memory
// bytes, weight slots.
extern "C" int fused_ffn_plan(int dtype, int T, int d, int F, int act,
                              int has_norm, int* out) {
  using namespace flame::ffn;
  if (T <= 0 || F <= 0 || (d != 64 && d != 256)) return cudaErrorInvalidValue;
  if (dtype == 1) {
    const int C = cluster_for(F);
    const bool gated = act == kSwiglu;
    const int ns = slots_for(d, gated, has_norm != 0);
    out[0] = (T + kRowsW - 1) / kRowsW * C;
    out[1] = C;
    out[2] = kThreads;
    out[3] = kRowsW;
    out[4] = wgmma_smem_bytes(d, ns, gated, has_norm != 0);
    out[5] = ns;
  } else {
    out[0] = (T + kRowsT - 1) / kRowsT;
    out[1] = 1;
    out[2] = kThreads;
    out[3] = kRowsT;
    out[4] = (d == 64 ? smem_floats<64>(act == kSwiglu)
                      : smem_floats<256>(act == kSwiglu)) * (int)sizeof(float);
    out[5] = 1;
  }
  return cudaSuccess;
}
