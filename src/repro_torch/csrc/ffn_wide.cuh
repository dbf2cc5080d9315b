// K3 at model widths past one shared-memory tile (the text models' d 3840:
// gemma3-12b, h2o-danube-3-4b) — included by fused_ffn.cu alone.
//
// Replaces, for those widths, the Pallas TPU kernel
// repro/kernels/fused_ffn/kernel.py::fused_ffn_kernel and computes its
// function,
//   out = act(n(x) @ W_up [* silu(n(x) @ W_gate)]) @ W_down,
// for bf16 x [T, d], W_up / W_gate [d, F], W_down [F, d], any d and F that
// are multiples of 8: f32 accumulation, the f32 hidden entering the down
// product as bf16 hi + lo (hi = bf16(h), lo = bf16(h - hi): ~16 bits, as
// in the d 64 / 256 kernel), the output rounded once.  The d 256 kernel
// keeps a [64, d] x tile and an f32 partial in shared memory, 491 KB and
// 983 KB at d 3840, so the wide form takes one of two paths, chosen by the
// wrapper from T alone (kernels/fused_ffn/ops.py, wide_plan).  Numbers
// below: an H100 80GB HBM3 at 700 W, its published 3.35 TB/s and 989
// TFLOP/s bf16; times from scripts/k3_wide_sweep.py (PERF.md, K3).
//
// Prefill sizes (more rows than the threshold, 32): two GEMM kernels, the
// hidden in device memory.
// - up_kernel: h = act(n(x) W_up [, n(x) W_gate]) over tiles of 128 rows
//   x 256 hidden columns (128 up + 128 gate columns for swiglu), written as
//   two bf16 planes h_hi, h_lo [T, F] (4 bytes an element: 123 MB at
//   gemma3-12b's T 2000, F 15360);
// - down_kernel: out = h_hi W_down + h_lo W_down over tiles of 128 (or, at
//   T where those leave SMs idle, 64) rows x 256 output columns, each
//   output tile's k-loop running over the whole of d_ff in one CTA, hi then
//   lo at every k step into one f32 accumulator: no d_ff slices, no f32
//   partials, no reduction kernel.  Both tilings issue m64n128k16 in one
//   order, so a row's output never depends on T or on the rows that share
//   its tile (bitwise);
// - both are warp-specialized and persistent (one CTA an SM walking the
//   tiles with the m tile fastest, so that the CTAs in flight share the
//   weight columns they stream, from L2): a producer warp keeps TMA copies
//   of 64-wide k tiles (128-byte swizzle; zero fill past T, d and F) in a
//   ring of stages counted on mbarriers (4 stages of 48 KB in up_kernel;
//   down_kernel's stage holds the hi and the lo tile beside one W_down
//   tile: 3 of 64 KB, or 4 of 48 KB on 64-row tiles), and two consumer
//   warpgroups run wgmma with A and B from shared memory;
// - with has_norm a pre-pass writes n(x) as bf16 hi + lo planes, which
//   up_kernel reads as two A tiles (three kernels a launch then).
// Bound at gemma3-12b's T 2000: the function's products, 2 x 2 x 2000 x
// 3840 x 15360 FLOPs (0.477 ms); the lo term makes the down product twice
// the work, 1.5x that on the tensor cores (0.716 ms; h2o-danube-3-4b's
// swiglu at d_ff 10240: 1.33x, 0.636 ms).  The hidden's round trip, 2 x
// 123 MB, is 0.07 ms of HBM.  Measured at T 2000: 1.1777 ms gelu, 1.0096
// swiglu (up_kernel about 0.47 / 0.54 of it: it has a quarter of the down
// product's k steps a tile, so its epilogue and pipeline refills weigh
// more; 2-CTA clusters multicasting the weight tiles were no faster).
//
// Decode sizes (T up to the threshold): a weight stream.  The bytes of the
// weights bound it (236 MB a gemma3-12b layer, 0.070 ms), so the design
// keeps every SM streaming with enough bytes in flight:
// - stream_kernel: one CTA for each 16-row m tile and each slice of 64 d_ff
//   columns (240 CTAs at d_ff 15360, 160 at 10240; about 101 KB of shared
//   memory, so two fit an SM).  A producer warp feeds a TMA ring of 6 (5
//   gated) stages on mbarriers: first x and the slice's W_up (W_gate)
//   columns, 64 k rows a stage, then W_down's slice rows, 128 output
//   columns a stage; the W_down stages go out while the hidden is still
//   being computed.  Four consumer warps run mma.sync (ldmatrix through
//   the swizzle), and fence the async proxy before releasing a stage, so
//   that their reads are done before TMA refills it: the hidden [16, 64]
//   (activation in f32) stays in shared memory as bf16 hi + lo, and each
//   slice's f32 partial [T, d] goes to a workspace;
// - reduce_kernel sums the slices' partials in a fixed order and rounds
//   once to bf16.  At T 4 the partials are 240 x 4 x 3840 floats (15 MB):
//   0.0853 ms of stream and 0.0062 ms of reduction, gelu (the matmul chain
//   0.0862 ms in all).
// No atomics on either path: a given shape is bitwise reproducible.
#pragma once

namespace flame {
namespace ffn {
namespace wide {

constexpr int kBK = 64;                    // k columns a stage (128 bytes)
constexpr int kBox = 64 * 64 * 2;          // a 64 x 64 bf16 TMA box, bytes

// ---------------------------------------------------------------------------
// prefill sizes: up_kernel, down_kernel (and norm_kernel with has_norm)
// ---------------------------------------------------------------------------

constexpr int kGemmThreads = 384;          // producer + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kBM = 128;                   // rows a tile (64 a warpgroup)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

template <bool GATED, bool NORM>
struct Up {
  static constexpr int BN = GATED ? 128 : 256;       // hidden columns a tile
  static constexpr int A = kBM * kBK * 2 * (NORM ? 2 : 1);
  static constexpr int B = kBK * BN * 2 * (GATED ? 2 : 1);
  static constexpr int STAGE = A + B;
  static constexpr int STAGES = STAGE <= 48 * 1024 ? 4 : 3;
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8;
};

// The down product's tiles: 128 rows x 256 columns (each warpgroup 64 rows
// x two 128-column chunks), or, where that leaves the SMs idle (wrapper:
// down_small), 64 rows x 256 columns (each warpgroup one chunk of the same
// 64 rows).  Both issue m64n128k16 in the same order, hi then lo at every
// k step, so a row's output is the same bits on either.
template <bool SMALL>
struct Down {
  static constexpr int BM = SMALL ? 64 : 128;
  static constexpr int BN = 256;
  static constexpr int CH = SMALL ? 1 : 2;     // chunks a warpgroup
  static constexpr int A = 2 * BM * kBK * 2;   // the hi and lo tiles
  static constexpr int B = kBK * BN * 2;
  static constexpr int STAGE = A + B;
  static constexpr int STAGES = SMALL ? 4 : 3;
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8;
};

struct UpMaps {
  CUtensorMap x, xl, up, gate;   // x (or n(x) hi), n(x) lo, W_up, W_gate
};
struct DownMaps {
  CUtensorMap hh, hl, down;
};

__device__ __forceinline__ float activate(float up, float gate, int act) {
  if (act == kGelu) return gelu_fast(up);
  if (act == kRelu) return fmaxf(up, 0.f);
  return silu_fast(gate) * up;
}

// n(x) = x / rms(x) (1 + scale) in f32, as bf16 planes hi and lo; a warp a
// row.
__global__ void __launch_bounds__(256)
    norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ scale,
                bf16* __restrict__ xh, bf16* __restrict__ xl, int T_,
                int d) {
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (r >= T_) return;
  const bf16* xr = x + (long long)r * d;
  float ss = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float v = __bfloat162float(xr[c]);
    ss += v * v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float inv = rsqrtf(ss / d + kEps);
  for (int c = lane; c < d; c += 32) {
    const float v =
        __bfloat162float(xr[c]) * inv * (1.f + __bfloat162float(scale[c]));
    const bf16 h = __float2bfloat16(v);
    xh[(long long)r * d + c] = h;
    xl[(long long)r * d + c] = __float2bfloat16(v - __bfloat162float(h));
  }
}

// The barriers of a ring of S stages after its slots: full[s] (one arrival,
// the producer's, plus the TMA bytes) and empty[s] (one arrival a consumer
// warp).
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          int stages, int consumers) {
  for (int s = 0; s < stages; ++s) {
    mma::mbar_init(&full[s], 1, threadIdx.x == 0);
    mma::mbar_init(&empty[s], consumers, threadIdx.x == 0);
  }
  mma::fence_mbar_init();
  __syncthreads();
}

// h = act(n(x) W_up [, n(x) W_gate]) as bf16 hi + lo planes [T, F].
template <bool GATED, bool NORM>
__global__ void __launch_bounds__(kGemmThreads, 1)
    up_kernel(const __grid_constant__ UpMaps maps, bf16* __restrict__ hh,
              bf16* __restrict__ hl, int T_, int d, int F, int act) {
  using C = Up<GATED, NORM>;
  constexpr int BN = C::BN;
  extern __shared__ __align__(1024) unsigned char wide_smem[];
  unsigned char* smem = wide_smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::STAGES * C::STAGE);
  uint64_t* empty = full + C::STAGES;
  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5;
  const int lane = tid & 31;
  const int tiles_m = (T_ + kBM - 1) / kBM;
  const int tiles = tiles_m * ((F + BN - 1) / BN);
  const int kt = (d + kBK - 1) / kBK;
  init_ring(full, empty, C::STAGES, kConsumerWarps);

  if (wg == 0) {  // producer: one warp issues the copies
    mma::setmaxnreg_dec<kProducerRegs>();
    if (warp != 0) return;
    const int lead = lane == 0;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % tiles_m) * kBM, n0 = (tile / tiles_m) * BN;
      for (int k = 0; k < kt; ++k, ++it) {
        const int s = it % C::STAGES;
        mma::mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
        unsigned char* st = smem + s * C::STAGE;
        mma::mbar_expect_tx(&full[s], C::STAGE, lead);
        mma::tma_load_2d(st, &maps.x, &full[s], k * kBK, m0, lead);
        if constexpr (NORM)
          mma::tma_load_2d(st + kBM * kBK * 2, &maps.xl, &full[s], k * kBK,
                           m0, lead);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j) {
          mma::tma_load_2d(st + C::A + j * kBox, &maps.up, &full[s],
                           n0 + 64 * j, k * kBK, lead);
          if constexpr (GATED)
            mma::tma_load_2d(st + C::A + (BN / 64 + j) * kBox, &maps.gate,
                             &full[s], n0 + 64 * j, k * kBK, lead);
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw computes rows 64 cw .. 64 cw + 63 of a tile
  mma::setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1;
  const int wr = (warp & 3) * 16;  // this warp's rows within them
  const int g = lane >> 2, t = lane & 3;
  const int lead = lane == 0;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile % tiles_m) * kBM, n0 = (tile / tiles_m) * BN;
    float acc[BN / 2], acg[GATED ? BN / 2 : 1];
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      acc[e] = 0.f;
      if constexpr (GATED) acg[e] = 0.f;
    }
    for (int k = 0; k < kt; ++k, ++it) {
      const int s = it % C::STAGES;
      mma::mbar_wait(&full[s], (it / C::STAGES) & 1);
      const unsigned char* st = smem + s * C::STAGE;
      const unsigned char* a = st + cw * 64 * 128;
      const unsigned char* b = st + C::A;
      mma::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t da = mma::smem_desc(a + 32 * kk, 16, 1024);
        const uint64_t db = mma::smem_desc(b + 2048 * kk, 64 * 128, 1024);
        if constexpr (GATED) {
          const uint64_t dg = mma::smem_desc(
              b + (BN / 64) * kBox + 2048 * kk, 64 * 128, 1024);
          mma::wgmma_n128(acc, da, db);
          mma::wgmma_n128(acg, da, dg);
          if constexpr (NORM) {
            const uint64_t dl =
                mma::smem_desc(a + kBM * kBK * 2 + 32 * kk, 16, 1024);
            mma::wgmma_n128(acc, dl, db);
            mma::wgmma_n128(acg, dl, dg);
          }
        } else {
          mma::wgmma_n256(acc, da, db);
          if constexpr (NORM) {
            const uint64_t dl =
                mma::smem_desc(a + kBM * kBK * 2 + 32 * kk, 16, 1024);
            mma::wgmma_n256(acc, dl, db);
          }
        }
      }
      mma::wgmma_commit();
      mma::wgmma_wait<1>();  // the previous k step's products are done
      if (k > 0) mma::mbar_arrive(&empty[(it - 1) % C::STAGES], lead);
    }
    mma::wgmma_wait<0>();
    mma::mbar_arrive(&empty[(it - 1) % C::STAGES], lead);
    mma::reg_fence<BN / 2>(acc);
    if constexpr (GATED) mma::reg_fence<BN / 2>(acg);
    // activation in f32; the hidden as bf16 hi + lo, rows past T and
    // columns past F left out
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + cw * 64 + wr + g + 8 * half;
        const int c = n0 + 8 * i + 2 * t;
        const int e = 4 * i + 2 * half;
        float h0, h1;
        if constexpr (GATED) {
          h0 = silu_fast(acg[e]) * acc[e];
          h1 = silu_fast(acg[e + 1]) * acc[e + 1];
        } else {
          h0 = activate(acc[e], 0.f, act);
          h1 = activate(acc[e + 1], 0.f, act);
        }
        unsigned hi, lo;
        mma::split2(h0, h1, hi, lo);
        if (r < T_ && c < F) {
          *reinterpret_cast<unsigned*>(hh + (long long)r * F + c) = hi;
          *reinterpret_cast<unsigned*>(hl + (long long)r * F + c) = lo;
        }
      }
    }
  }
}

// out = bf16(h_hi W_down + h_lo W_down), the whole of d_ff in one k-loop.
template <bool SMALL>
__global__ void __launch_bounds__(kGemmThreads, 1)
    down_kernel(const __grid_constant__ DownMaps maps, bf16* __restrict__ out,
                int T_, int d, int F) {
  using C = Down<SMALL>;
  constexpr int BM = C::BM, BN = C::BN, CH = C::CH;
  extern __shared__ __align__(1024) unsigned char wide_smem[];
  unsigned char* smem = wide_smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::STAGES * C::STAGE);
  uint64_t* empty = full + C::STAGES;
  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5;
  const int lane = tid & 31;
  const int tiles_m = (T_ + BM - 1) / BM;
  const int tiles = tiles_m * ((d + BN - 1) / BN);
  const int kt = (F + kBK - 1) / kBK;
  init_ring(full, empty, C::STAGES, kConsumerWarps);

  if (wg == 0) {
    mma::setmaxnreg_dec<kProducerRegs>();
    if (warp != 0) return;
    const int lead = lane == 0;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % tiles_m) * BM, n0 = (tile / tiles_m) * BN;
      for (int k = 0; k < kt; ++k, ++it) {
        const int s = it % C::STAGES;
        mma::mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
        unsigned char* st = smem + s * C::STAGE;
        mma::mbar_expect_tx(&full[s], C::STAGE, lead);
        mma::tma_load_2d(st, &maps.hh, &full[s], k * kBK, m0, lead);
        mma::tma_load_2d(st + BM * kBK * 2, &maps.hl, &full[s], k * kBK, m0,
                         lead);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          mma::tma_load_2d(st + C::A + j * kBox, &maps.down, &full[s],
                           n0 + 64 * j, k * kBK, lead);
      }
    }
    return;
  }

  // consumers: warpgroup cw takes rows 64 cw .. (128-row tiles) or all 64
  // rows (64-row tiles), and its chunks of 128 output columns
  mma::setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1;
  const int r_base = SMALL ? 0 : 64 * cw;
  const int c_base = SMALL ? cw : 0;  // first chunk
  const int wr = (warp & 3) * 16;
  const int g = lane >> 2, t = lane & 3;
  const int lead = lane == 0;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile % tiles_m) * BM, n0 = (tile / tiles_m) * BN;
    float acc[CH][64];
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[c][e] = 0.f;
    for (int k = 0; k < kt; ++k, ++it) {
      const int s = it % C::STAGES;
      mma::mbar_wait(&full[s], (it / C::STAGES) & 1);
      const unsigned char* st = smem + s * C::STAGE;
      const unsigned char* a = st + r_base * 128;
      const unsigned char* b = st + C::A;
      mma::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t dh = mma::smem_desc(a + 32 * kk, 16, 1024);
        const uint64_t dl =
            mma::smem_desc(a + BM * kBK * 2 + 32 * kk, 16, 1024);
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const uint64_t db = mma::smem_desc(
              b + (c_base + c) * 2 * kBox + 2048 * kk, 64 * 128, 1024);
          mma::wgmma_n128(acc[c], dh, db);
          mma::wgmma_n128(acc[c], dl, db);
        }
      }
      mma::wgmma_commit();
      mma::wgmma_wait<1>();
      if (k > 0) mma::mbar_arrive(&empty[(it - 1) % C::STAGES], lead);
    }
    mma::wgmma_wait<0>();
    mma::mbar_arrive(&empty[(it - 1) % C::STAGES], lead);
#pragma unroll
    for (int c = 0; c < CH; ++c) mma::reg_fence<64>(acc[c]);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = m0 + r_base + wr + g + 8 * half;
          const int col = n0 + 128 * (c_base + c) + 8 * i + 2 * t;
          const int e = 4 * i + 2 * half;
          if (r < T_ && col < d)
            *reinterpret_cast<unsigned*>(out + (long long)r * d + col) =
                mma::cvt2(acc[c][e], acc[c][e + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// decode sizes: stream_kernel and reduce_kernel
// ---------------------------------------------------------------------------

constexpr int kSRows = 16;        // rows a CTA
constexpr int kSlice = 64;        // d_ff columns a CTA
constexpr int kOutTile = 128;     // output columns a phase-2 stage
constexpr int kStreamWarps = 4;   // consumer warps; one producer warp more
constexpr int kStreamThreads = (kStreamWarps + 1) * 32;
constexpr int kHP = kSlice + 8;   // hidden pitch (elements): 16 bytes past a
                                  // multiple of 128, ldmatrix conflict-free

template <bool GATED>
struct Stream {
  static constexpr int X = kSRows * 128;                  // x [16, 64]
  static constexpr int P1 = X + (GATED ? 2 : 1) * kBox;   // + W_up (W_gate)
  static constexpr int P2 = 2 * kBox;                     // W_down [64, 128]
  static constexpr int STAGE = P1 > P2 ? P1 : P2;
  static constexpr int STAGES = 96 * 1024 / STAGE;        // 6, gated 5
  static constexpr int SMEM =
      STAGES * STAGE + 2 * kSRows * kHP * 2 + kSRows * 4 + 2 * STAGES * 8;
};

struct StreamMaps {
  CUtensorMap x, up, gate, down;
};

// The slice's partial [T, d] = act(n(x) W_up[:, slice] [, gate]) @
// W_down[slice, :], to ws[slice] (f32).
template <bool GATED, bool NORM>
__global__ void __launch_bounds__(kStreamThreads)
    stream_kernel(const __grid_constant__ StreamMaps maps,
                  const bf16* __restrict__ x, const bf16* __restrict__ scale,
                  float* __restrict__ ws, int T_, int d, int F, int act) {
  using C = Stream<GATED>;
  extern __shared__ __align__(1024) unsigned char wide_smem[];
  unsigned char* smem = wide_smem;
  bf16* hh = reinterpret_cast<bf16*>(smem + C::STAGES * C::STAGE);
  bf16* hl = hh + kSRows * kHP;
  float* inv = reinterpret_cast<float*>(hl + kSRows * kHP);
  uint64_t* full = reinterpret_cast<uint64_t*>(inv + kSRows);
  uint64_t* empty = full + C::STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * kSRows;
  const int f_lo = blockIdx.y * kSlice;
  const int kch = (d + kBK - 1) / kBK;             // phase-1 stages
  const int nto = (d + kOutTile - 1) / kOutTile;   // phase-2 stages
  init_ring(full, empty, C::STAGES, kStreamWarps);

  if (warp == kStreamWarps) {  // producer
    const int lead = lane == 0;
    for (int i = 0; i < kch + nto; ++i) {
      const int s = i % C::STAGES;
      mma::mbar_wait(&empty[s], ((i / C::STAGES) & 1) ^ 1);
      unsigned char* st = smem + s * C::STAGE;
      if (i < kch) {
        mma::mbar_expect_tx(&full[s], C::P1, lead);
        mma::tma_load_2d(st, &maps.x, &full[s], i * kBK, r0, lead);
        mma::tma_load_2d(st + C::X, &maps.up, &full[s], f_lo, i * kBK, lead);
        if constexpr (GATED)
          mma::tma_load_2d(st + C::X + kBox, &maps.gate, &full[s], f_lo,
                           i * kBK, lead);
      } else {
        const int n0 = (i - kch) * kOutTile;
        mma::mbar_expect_tx(&full[s], C::P2, lead);
        mma::tma_load_2d(st, &maps.down, &full[s], n0, f_lo, lead);
        mma::tma_load_2d(st + kBox, &maps.down, &full[s], n0 + 64, f_lo,
                         lead);
      }
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  // a warp is done with stage s: its reads (ldmatrix, loads: the generic
  // proxy) are ordered before the TMA writes (the async proxy) that refill
  // the slot once every warp has arrived
  auto release = [&](int s) {
    mma::fence_async_smem();
    __syncwarp();
    mma::mbar_arrive(&empty[s], lane == 0);
  };
  if constexpr (NORM) {  // each row's 1 / rms
    for (int r = warp; r < kSRows; r += kStreamWarps) {
      float ss = 0.f;
      if (r0 + r < T_) {
        const bf16* xr = x + (long long)(r0 + r) * d;
        for (int c = lane; c < d; c += 32) {
          const float v = __bfloat162float(xr[c]);
          ss += v * v;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
      if (lane == 0) inv[r] = rsqrtf(ss / d + kEps);
    }
    mma::bar_sync(1, kStreamWarps * 32);
  }

  // ---- phase 1: warp w computes hidden columns 16 w .. 16 w + 15 ----
  float cu[2][4], cg[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) cu[j][e] = cg[j][e] = 0.f;
  for (int i = 0; i < kch; ++i) {
    const int s = i % C::STAGES;
    mma::mbar_wait(&full[s], (i / C::STAGES) & 1);
    const unsigned char* xs = smem + s * C::STAGE;
    const unsigned char* us = xs + C::X;
    const int k0 = i * kBK;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      unsigned ah[4], al[4];
      if constexpr (NORM) {
        // n(x) = x / rms (1 + scale) in f32, as bf16 hi + lo
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = g + 8 * (q & 1);
          const int c = kk * 16 + 2 * t + 8 * (q >> 1);
          const unsigned w2 = *reinterpret_cast<const unsigned*>(
              xs + mma::sw128<kSRows>(r, c));
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + c + e;
            const float sc =
                col < d ? 1.f + __bfloat162float(scale[col]) : 0.f;
            v[e] = __uint_as_float(e ? (w2 & 0xffff0000u) : (w2 << 16)) *
                   inv[r] * sc;
          }
          mma::split2(v[0], v[1], ah[q], al[q]);
        }
      } else {
        mma::load_a_x4_sw(ah, xs, 0, kk * 16, lane);
      }
      unsigned b[4];
      mma::load_b_trans_x4_sw(b, us, kk * 16, warp * 16, lane);
      mma::mma_bf16(cu[0], ah, b);
      mma::mma_bf16(cu[1], ah, b + 2);
      if constexpr (NORM) {
        mma::mma_bf16(cu[0], al, b);
        mma::mma_bf16(cu[1], al, b + 2);
      }
      if constexpr (GATED) {
        mma::load_b_trans_x4_sw(b, us + kBox, kk * 16, warp * 16, lane);
        mma::mma_bf16(cg[0], ah, b);
        mma::mma_bf16(cg[1], ah, b + 2);
        if constexpr (NORM) {
          mma::mma_bf16(cg[0], al, b);
          mma::mma_bf16(cg[1], al, b + 2);
        }
      }
    }
    release(s);
  }
  // activation in f32 (columns past F are zero); hidden as bf16 hi + lo
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = warp * 16 + j * 8 + 2 * t;
      float h[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int e = 2 * half + q;
        h[q] = f_lo + c + q < F ? activate(cu[j][e], cg[j][e], act) : 0.f;
      }
      unsigned hi, lo;
      mma::split2(h[0], h[1], hi, lo);
      const int r = g + 8 * half;
      *reinterpret_cast<unsigned*>(hh + r * kHP + c) = hi;
      *reinterpret_cast<unsigned*>(hl + r * kHP + c) = lo;
    }
  }
  mma::bar_sync(1, kStreamWarps * 32);  // the hidden is written

  // ---- phase 2: warp w adds output columns 32 w .. 32 w + 31 of a stage ----
  float* wsl = ws + (long long)blockIdx.y * T_ * d;
  for (int i = kch; i < kch + nto; ++i) {
    const int s = i % C::STAGES;
    mma::mbar_wait(&full[s], (i / C::STAGES) & 1);
    const unsigned char* blk = smem + s * C::STAGE + (warp >> 1) * kBox;
    float co[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) co[j][0] = co[j][1] = co[j][2] = co[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSlice / 16; ++kk) {
      unsigned ah[4], al[4];
      mma::load_a_x4(ah, hh, kHP, 0, kk * 16, lane);
      mma::load_a_x4(al, hl, kHP, 0, kk * 16, lane);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        unsigned b[4];
        mma::load_b_trans_x4_sw(b, blk, kk * 16, (warp & 1) * 32 + jp * 16,
                                lane);
        mma::mma_bf16(co[2 * jp], ah, b);
        mma::mma_bf16(co[2 * jp + 1], ah, b + 2);
        mma::mma_bf16(co[2 * jp], al, b);
        mma::mma_bf16(co[2 * jp + 1], al, b + 2);
      }
    }
    release(s);
    const int n0 = (i - kch) * kOutTile + warp * 32;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + j * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + g + 8 * half;
        if (r < T_ && c < d)
          *reinterpret_cast<float2*>(wsl + (long long)r * d + c) =
              make_float2(co[j][2 * half], co[j][2 * half + 1]);
      }
    }
  }
}

// out = bf16(sum of the slices' partials), 4 columns a thread: a block
// takes 16 groups of 4 columns, its 16 thread rows the slices k = 16 q + p
// in turn, summed in a fixed order (p = 0 .. 15 last).
constexpr int kRedCols = 16;
constexpr int kRedParts = 16;
__global__ void __launch_bounds__(kRedCols * kRedParts)
    reduce_kernel(const float* __restrict__ ws, bf16* __restrict__ out,
                  long long n4, int slices) {
  __shared__ float4 part[kRedParts][kRedCols];
  const int c = threadIdx.x % kRedCols, p = threadIdx.x / kRedCols;
  const long long i = blockIdx.x * (long long)kRedCols + c;
  const float4* w = reinterpret_cast<const float4*>(ws);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < n4) {
#pragma unroll 4
    for (int k = p; k < slices; k += kRedParts) {
      const float4 v = w[k * n4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
  }
  part[p][c] = s;
  __syncthreads();
  if (p == 0 && i < n4) {
#pragma unroll
    for (int q = 1; q < kRedParts; ++q) {
      s.x += part[q][c].x;
      s.y += part[q][c].y;
      s.z += part[q][c].z;
      s.w += part[q][c].w;
    }
    reinterpret_cast<uint2*>(out)[i] =
        make_uint2(mma::cvt2(s.x, s.y), mma::cvt2(s.z, s.w));
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

enum Path { kDecode = 0, kPrefill = 1 };

inline int sm_count() {
  return mma::device_attr<cudaDevAttrMultiProcessorCount>(132);
}

// The down product on 64-row tiles where that takes fewer rounds of the
// card's SMs (a round of them half the work of a 128-row tile's): T 1100
// and 300 at d 3840, not T 2000.
inline bool down_small(int T_, int d) {
  const long long sms = sm_count(), nt = (d + 255) / 256;
  const long long big = (T_ + 127) / 128 * nt, small = (T_ + 63) / 64 * nt;
  return (small + sms - 1) / sms < 2 * ((big + sms - 1) / sms);
}

// Workspace bytes of one launch: the slices' f32 partials (decode), or the
// hidden's two bf16 planes and, with has_norm, n(x)'s (prefill).
inline long long workspace_bytes(int path, int T_, int d, int F,
                                 int has_norm) {
  if (path == kDecode)
    return (long long)((F + kSlice - 1) / kSlice) * T_ * d * 4;
  return 4LL * T_ * F + (has_norm ? 4LL * T_ * d : 0);
}

// What a launch runs: out[0] path, out[1] kernels, then for the two main
// kernels (stream + reduce, or up + down) grid, threads, dynamic shared
// bytes and ring stages each (out[2..5], out[6..9]), out[10] workspace
// bytes, out[11..12] the rows and columns of the first kernel's tiles,
// out[13..14] the tiles (CTAs of the decode path) of each kernel,
// out[15..16] the rows and columns of the second kernel's tiles (0: the
// reduction has none).
inline void plan(int path, int T_, int d, int F, bool gated, bool norm,
                 long long* out) {
  out[0] = path;
  out[10] = workspace_bytes(path, T_, d, F, norm);
  if (path == kDecode) {
    const long long ctas =
        (long long)((T_ + kSRows - 1) / kSRows) * ((F + kSlice - 1) / kSlice);
    const long long n4 = (long long)T_ * d / 4;
    const long long red = (n4 + kRedCols - 1) / kRedCols;
    out[1] = 2;
    out[2] = ctas;
    out[3] = kStreamThreads;
    out[4] = gated ? Stream<true>::SMEM : Stream<false>::SMEM;
    out[5] = gated ? Stream<true>::STAGES : Stream<false>::STAGES;
    out[6] = red;
    out[7] = kRedCols * kRedParts;
    out[8] = 0;
    out[9] = 0;
    out[11] = kSRows;
    out[12] = kSlice;
    out[13] = ctas;
    out[14] = red;
    out[15] = 0;
    out[16] = 0;
    return;
  }
  const int bn = gated ? 128 : 256;
  const bool small = down_small(T_, d);
  const int bm2 = small ? Down<true>::BM : Down<false>::BM;
  const long long up_tiles = (long long)((T_ + kBM - 1) / kBM) *
                             ((F + bn - 1) / bn);
  const long long down_tiles = (long long)((T_ + bm2 - 1) / bm2) *
                               ((d + 255) / 256);
  const int sms = sm_count();
  out[1] = norm ? 3 : 2;
  out[2] = up_tiles < sms ? up_tiles : sms;
  out[3] = kGemmThreads;
  out[4] = gated ? (norm ? Up<true, true>::SMEM : Up<true, false>::SMEM)
                 : (norm ? Up<false, true>::SMEM : Up<false, false>::SMEM);
  out[5] = gated ? (norm ? Up<true, true>::STAGES : Up<true, false>::STAGES)
                 : (norm ? Up<false, true>::STAGES
                         : Up<false, false>::STAGES);
  out[6] = down_tiles < sms ? down_tiles : sms;
  out[7] = kGemmThreads;
  out[8] = small ? Down<true>::SMEM : Down<false>::SMEM;
  out[9] = small ? Down<true>::STAGES : Down<false>::STAGES;
  out[11] = kBM;
  out[12] = bn;
  out[13] = up_tiles;
  out[14] = down_tiles;
  out[15] = bm2;
  out[16] = 256;
}

template <bool GATED, bool NORM>
cudaError_t launch_stream(const void* x, const void* scale, const void* w_up,
                          const void* w_gate, const void* w_down, void* out,
                          void* ws, int T_, int d, int F, int act,
                          cudaStream_t stream) {
  using C = Stream<GATED>;
  StreamMaps maps;
  memset(&maps, 0, sizeof(maps));
  if (encode_tiled() == nullptr ||
      !encode_map(&maps.x, x, T_, d, d, kSRows) ||
      !encode_map(&maps.up, w_up, d, F, F, 64) ||
      (GATED && !encode_map(&maps.gate, w_gate, d, F, F, 64)) ||
      !encode_map(&maps.down, w_down, F, d, d, 64))
    return cudaErrorInvalidValue;
  auto kernel = stream_kernel<GATED, NORM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const int slices = (F + kSlice - 1) / kSlice;
  float* w = static_cast<float*>(ws);
  kernel<<<dim3((T_ + kSRows - 1) / kSRows, slices), kStreamThreads, C::SMEM,
           stream>>>(maps, static_cast<const bf16*>(x),
                     static_cast<const bf16*>(scale), w, T_, d, F, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n4 = (long long)T_ * d / 4;
  reduce_kernel<<<(unsigned)((n4 + kRedCols - 1) / kRedCols),
                  kRedCols * kRedParts, 0, stream>>>(
      w, static_cast<bf16*>(out), n4, slices);
  return cudaGetLastError();
}

template <bool SMALL>
cudaError_t launch_down(DownMaps& dm, bf16* hh, bf16* hl, void* out, int T_,
                        int d, int F, int sms, cudaStream_t stream) {
  using C = Down<SMALL>;
  if (!encode_map(&dm.hh, hh, T_, F, F, C::BM) ||
      !encode_map(&dm.hl, hl, T_, F, F, C::BM))
    return cudaErrorInvalidValue;
  auto kernel = down_kernel<SMALL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles = (T_ + C::BM - 1) / C::BM * ((d + C::BN - 1) / C::BN);
  kernel<<<tiles < sms ? tiles : sms, kGemmThreads, C::SMEM, stream>>>(
      dm, static_cast<bf16*>(out), T_, d, F);
  return cudaGetLastError();
}

template <bool GATED, bool NORM>
cudaError_t launch_gemms(const void* x, const void* scale, const void* w_up,
                         const void* w_gate, const void* w_down, void* out,
                         void* ws, int T_, int d, int F, int act,
                         cudaStream_t stream) {
  using U = Up<GATED, NORM>;
  bf16* hh = static_cast<bf16*>(ws);
  bf16* hl = hh + (long long)T_ * F;
  bf16* xh = hl + (long long)T_ * F;  // n(x) hi and lo, with has_norm
  bf16* xl = xh + (long long)T_ * d;
  if (encode_tiled() == nullptr) return cudaErrorInvalidValue;
  cudaError_t err;
  if constexpr (NORM) {
    norm_kernel<<<(T_ + 7) / 8, 256, 0, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(scale), xh, xl,
        T_, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  UpMaps um;
  DownMaps dm;
  memset(&um, 0, sizeof(um));
  memset(&dm, 0, sizeof(dm));
  if (!encode_map(&um.x, NORM ? static_cast<const void*>(xh) : x, T_, d, d,
                  kBM) ||
      (NORM && !encode_map(&um.xl, xl, T_, d, d, kBM)) ||
      !encode_map(&um.up, w_up, d, F, F, 64) ||
      (GATED && !encode_map(&um.gate, w_gate, d, F, F, 64)) ||
      !encode_map(&dm.down, w_down, F, d, d, 64))
    return cudaErrorInvalidValue;
  const int sms = sm_count();
  const int tm = (T_ + kBM - 1) / kBM;
  const int up_tiles = tm * ((F + U::BN - 1) / U::BN);
  auto up = up_kernel<GATED, NORM>;
  err = cudaFuncSetAttribute(up, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             U::SMEM);
  if (err != cudaSuccess) return err;
  up<<<up_tiles < sms ? up_tiles : sms, kGemmThreads, U::SMEM, stream>>>(
      um, hh, hl, T_, d, F, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (down_small(T_, d))
    return launch_down<true>(dm, hh, hl, out, T_, d, F, sms, stream);
  return launch_down<false>(dm, hh, hl, out, T_, d, F, sms, stream);
}

template <bool GATED, bool NORM>
cudaError_t launch_path(int path, const void* x, const void* scale,
                        const void* w_up, const void* w_gate,
                        const void* w_down, void* out, void* ws, int T_,
                        int d, int F, int act, cudaStream_t s) {
  if (path == kDecode)
    return launch_stream<GATED, NORM>(x, scale, w_up, w_gate, w_down, out, ws,
                                      T_, d, F, act, s);
  return launch_gemms<GATED, NORM>(x, scale, w_up, w_gate, w_down, out, ws,
                                   T_, d, F, act, s);
}

inline cudaError_t launch(int path, const void* x, const void* scale,
                          const void* w_up, const void* w_gate,
                          const void* w_down, void* out, void* ws, int T_,
                          int d, int F, int act, int has_norm,
                          cudaStream_t s) {
  const bool gated = act == kSwiglu;
  if (gated && has_norm)
    return launch_path<true, true>(path, x, scale, w_up, w_gate, w_down, out,
                                   ws, T_, d, F, act, s);
  if (gated)
    return launch_path<true, false>(path, x, scale, w_up, w_gate, w_down, out,
                                    ws, T_, d, F, act, s);
  if (has_norm)
    return launch_path<false, true>(path, x, scale, w_up, w_gate, w_down, out,
                                    ws, T_, d, F, act, s);
  return launch_path<false, false>(path, x, scale, w_up, w_gate, w_down, out,
                                   ws, T_, d, F, act, s);
}

}  // namespace wide
}  // namespace ffn
}  // namespace flame
