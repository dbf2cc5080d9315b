// Candidate scoring against a cached history: the code that kernel K1
// (fused_score.cu) and K4's self-slot form (flash_decode.cu) share.
//
// The function, per (batch row b, head h, candidate r): a two-segment
// softmax over
//   segment 1: the history K/V of pool row `row` (row_index[b]; with a
//              packed index row_index[b, r], a row per candidate; or b) in
//              its stored type — int8, bf16 or f32 — with the per-(row, kv
//              head) scale folded in, keys [0, len), len = lengths[row]
//              (S without lengths);
//   segment 2: "cached" — the candidate's own key k_cand[b, r] alone;
//              "extend" — the suffix keys k_cand[b, 0..r] (causal).
// Masked keys add exact zeros.  A row of a zero-length history sees its
// own key alone.
//
// A packed index (DSO v2 segment packing, cached mode only) lets the
// candidates of one block belong to several pool rows.  Both kernels then
// run segment 1 once for each distinct pool row among their candidates, in
// candidate order: the pass streams that row's tiles exactly as an
// unpacked call does, and the candidates of other rows leave their
// softmax state untouched (a predicate, not -inf arithmetic).  Every
// candidate so sees the tiles, in the warp order, of the unpacked call of
// its user: packed == unpacked bitwise, at any segment alignment.  A block
// whose candidates share one row (always so without a packed index) makes
// one pass.
//
// Three kernels compute it:
// - fused_score_kernel (one thread per query row, scalar f32 FMAs over
//   tiles dequantized into f32 shared memory): f32 q or f32 history, both
//   modes;
// - cs::cached_mma_kernel (bf16 q over int8 or bf16 history, cached mode):
//   both products on the tensor cores, described at its head below;
// - cs::extend_mma_kernel (extend_score.cuh; bf16 q over int8 or bf16
//   history, extend mode): this file's pieces, the causal suffix folded as
//   further key tiles of the same warp rotation.
#pragma once

#include <type_traits>

#include "attention_common.cuh"
#include "mma_bf16.cuh"

namespace flame {

enum ScoreMode { kCached = 0, kExtend = 1 };

struct ScoreArgs {
  const void *q, *k_hist, *v_hist;
  const float *k_scale, *v_scale;
  const void *k_cand, *v_cand;
  const int *row_index, *lengths;
  void* o;
  int B, M, H, Hkv, U, S;
  Strides st[6];  // q, k_hist, v_hist, k_cand, v_cand, o
  int mode;
  float scale;
  int packed;  // row_index is [B, M] (a pool row per candidate), not [B]
};

// The pool row of candidate r of batch row b, clamped into [0, U).
__device__ __forceinline__ int pool_row(const int* __restrict__ row_index,
                                        int packed, int b, int r, int M,
                                        int U) {
  const int row = row_index ? row_index[packed ? b * M + r : b] : b;
  return min(max(row, 0), U - 1);
}

// ---------------------------------------------------------------------------
// scalar kernel: one thread per query row (attention_common.cuh::Row)
// ---------------------------------------------------------------------------

template <typename TQ, typename TH, int D>
__global__ void __launch_bounds__(kRows) fused_score_kernel(
    const TQ* __restrict__ q, const TH* __restrict__ k_hist,
    const TH* __restrict__ v_hist, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const TQ* __restrict__ k_cand,
    const TQ* __restrict__ v_cand, const int* __restrict__ row_index,
    const int* __restrict__ lengths, TQ* __restrict__ o, int H, int Hkv,
    int M, int U, int S, Strides qs, Strides khs, Strides vhs, Strides kcs,
    Strides vcs, Strides os, int mode, float scale, int packed) {
  constexpr int BK = Tile<D>::keys;
  __shared__ __align__(16) float k_tile[BK * D];
  __shared__ __align__(16) float v_tile[BK * D];
  __shared__ int rows[kRows];  // each candidate's pool row

  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int kvh = h / (H / Hkv);
  const int r0 = blockIdx.x * kRows;
  const int r1 = min(r0 + kRows, M);
  const int r = r0 + threadIdx.x;
  const bool live = r < M;
  rows[threadIdx.x] = pool_row(row_index, packed, b, min(r, M - 1), M, U);
  __syncthreads();
  const int my_row = rows[threadIdx.x];

  Row<D> st;
  st.reset();
  st.load_q(q + b * qs.n + h * qs.h + (long long)(live ? r : r0) * qs.s, live,
            scale);

  // segment 1: pooled history, dequantized while staged, once for each
  // distinct pool row of the block's candidates
  for (int c = 0; c < (packed ? r1 - r0 : 1); ++c) {
    const int row = rows[c];
    bool seen = false;
    for (int c2 = 0; c2 < c; ++c2) seen |= rows[c2] == row;
    if (seen) continue;
    const bool mine = live && my_row == row;
    const int len = lengths ? min(max(lengths[row], 0), S) : S;
    const float ksc = k_scale ? k_scale[row * Hkv + kvh] : 1.f;
    const float vsc = v_scale ? v_scale[row * Hkv + kvh] : 1.f;
    const TH* kh = k_hist + row * khs.n + kvh * khs.h;
    const TH* vh = v_hist + row * vhs.n + kvh * vhs.h;
    for (int t0 = 0; t0 < len; t0 += BK) {
      const int n = min(BK, len - t0);
      __syncthreads();
      load_tile<TH, D>(k_tile, kh + t0 * khs.s, khs.s, n, ksc);
      load_tile<TH, D>(v_tile, vh + t0 * vhs.s, vhs.s, n, vsc);
      __syncthreads();
      st.fold(k_tile, v_tile, n, [&](int) { return mine; });
    }
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

template <typename TQ, typename TH, int D>
cudaError_t launch_scalar(const ScoreArgs& a, cudaStream_t stream) {
  const dim3 grid((a.M + kRows - 1) / kRows, a.B * a.H);
  fused_score_kernel<TQ, TH, D><<<grid, kRows, 0, stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TH*>(a.k_hist),
      static_cast<const TH*>(a.v_hist), a.k_scale, a.v_scale,
      static_cast<const TQ*>(a.k_cand), static_cast<const TQ*>(a.v_cand),
      a.row_index, a.lengths, static_cast<TQ*>(a.o), a.H, a.Hkv, a.M, a.U,
      a.S, a.st[0], a.st[1], a.st[2], a.st[3], a.st[4], a.st[5], a.mode,
      a.scale, a.packed);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tensor-core kernel: bf16 q, int8 or bf16 history, cached mode
// ---------------------------------------------------------------------------
//
// - A block of kWarps warps owns 16 candidate rows of one (batch row,
//   head).  Q stays in registers as bf16 A fragments; S = Q K^T and
//   O += P V run on mma.sync.m16n8k16 (bf16 in, f32 accumulate).
// - The warps split the history's key tiles: tile i (BK keys from i BK)
//   goes to warp i % kWarps, which streams its tiles through its own
//   two-slot ring in shared memory with no block barrier, so one warp's
//   chain is a quarter of the history.  The four partial softmax states
//   (running max, row sum, P V accumulator) are combined in warp order at
//   the end.  With 16 rows a block, the Climber scoring shape (4 rows x 4
//   heads x 128 candidates) runs 128 blocks on the 132 SMs.
// - The history is staged as bf16 codes: int8 codes are exact in bf16, so
//   an int8 tile is loaded into registers one tile ahead and converted
//   while it is stored to shared memory; a bf16 tile goes through cp.async.
//   The scales stay in f32: the raw scores are multiplied by ksc * scale
//   (and log2 e) after Q K^T, and the history's P V accumulator by vsc
//   before the self key is added.
// - P enters P V as bf16 hi + lo: one bf16 rounding of P breaks the bf16
//   gate for rows that see few keys.
// - The self key is a per-row dot product of q and k_cand in f32 from the
//   A fragments already in registers, each quad thread over its D / 4
//   columns, summed across the quad by two xor shuffles (the same sum on
//   all four), folded after the combine.
// - Bitwise: the tiles, and which warp folds each, are fixed by len alone
//   and the combine runs in warp order, so a row's output depends on its q
//   row, its pool row, len and its own candidate alone — not on M, B, the
//   block's other rows or how far S is padded; lengths == S is the call
//   without lengths; no atomics.
// - A packed index: each distinct pool row of the block's 16 candidates is
//   one pass of segment 1 (1 pass when the segments are aligned to 16, at
//   most 2 at the packer's default alignment of 8, at most 16 unaligned).
//   A thread's row outside the pass keeps its state through exact
//   arithmetic: its rescale factor is a selected 1 and its P a selected 0
//   (the P V products add exact zeros); a pass uses its row's len and k
//   scale, the epilogue each row's own v scale.  Packed and unpacked calls
//   run one instruction stream (the index's form is a runtime argument):
//   two instantiations were compiled with other FMA contractions and
//   rounded ~1 output element in 10^4 otherwise.

namespace cs {

using mma::bf16;
constexpr int kWarps = 4;  // per block, splitting the key tiles
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ bf16 to_bf16(bf16 x) { return x; }
__device__ __forceinline__ bf16 to_bf16(int8_t x) {
  return __float2bfloat16(static_cast<float>(x));  // exact
}

// 16 int8 codes -> 16 bf16 values (exact), as two 16-byte packs.
__device__ __forceinline__ void i8x16_to_bf16(const uint4& v, uint4& lo,
                                              uint4& hi) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  unsigned out[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float c0 = static_cast<float>(static_cast<int8_t>(w[i]));
    const float c1 = static_cast<float>(static_cast<int8_t>(w[i] >> 8));
    const float c2 = static_cast<float>(static_cast<int8_t>(w[i] >> 16));
    const float c3 = static_cast<float>(static_cast<int8_t>(w[i] >> 24));
    out[2 * i] = mma::cvt2(c0, c1);
    out[2 * i + 1] = mma::cvt2(c2, c3);
  }
  lo = make_uint4(out[0], out[1], out[2], out[3]);
  hi = make_uint4(out[4], out[5], out[6], out[7]);
}

// Keys per tile: an int8 tile of BK x D codes is four 16-byte loads per
// lane and operand.
template <int D>
struct Cfg {
  static constexpr int BK = D <= 16 ? 64 : 2048 / D;
  static constexpr int LD = D + 8;  // padded row: ldmatrix conflict-free
  static constexpr int WARP_BYTES = 2 * 2 * BK * LD * 2;  // 2 slots, K + V
  static constexpr int SMEM = kWarps * WARP_BYTES;
};

template <typename TH, int D>
__global__ void __launch_bounds__(kWarps * 32) cached_mma_kernel(
    const bf16* __restrict__ q, const TH* __restrict__ k_hist,
    const TH* __restrict__ v_hist, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const bf16* __restrict__ k_cand,
    const bf16* __restrict__ v_cand, const int* __restrict__ row_index,
    const int* __restrict__ lengths, bf16* __restrict__ o, int H, int Hkv,
    int M, int U, int S, Strides qs, Strides khs, Strides vhs, Strides kcs,
    Strides vcs, Strides os, float scale, int packed) {
  constexpr bool kInt8 = sizeof(TH) == 1;
  constexpr int BK = Cfg<D>::BK, LD = Cfg<D>::LD;
  constexpr int KD = D / 16, NS = BK / 8, NO = D / 8;
  constexpr int EPC = 16 / static_cast<int>(sizeof(TH));
  constexpr int CPR = D / EPC;
  constexpr int CHUNKS = BK * CPR;               // per operand and tile
  constexpr int PER = (CHUNKS + 31) / 32;        // per lane
  extern __shared__ __align__(16) unsigned char smem[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int kvh = h / (H / Hkv);
  const int w0 = blockIdx.x * 16;  // the block's first row

  // each candidate's pool row (rows past M take the last one's); without a
  // packed index the block's candidates share one
  __shared__ int rows[16];
  if (threadIdx.x < 16)
    rows[threadIdx.x] =
        pool_row(row_index, packed, b, min(w0 + (int)threadIdx.x, M - 1), M,
                 U);
  __syncthreads();
  const int my_row[2] = {rows[g], rows[g + 8]};
  const float c_self = scale * kLog2e;
  unsigned qf[KD][4];
  {
    const bf16* qb = q + b * qs.n + h * qs.h;
    const bool pairs =
        reinterpret_cast<uintptr_t>(qb) % 4 == 0 && qs.s % 2 == 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = w0 + g + 8 * half;
      const bf16* qr = qb + (long long)r * qs.s;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int c = kk * 16 + 2 * t + 8 * hi;
          unsigned w = 0u;
          if (r < M)
            w = pairs ? mma::ld32(qr + c) : mma::pack2(qr[c], qr[c + 1]);
          qf[kk][half + 2 * hi] = w;
        }
      }
    }
  }

  // the pass's pool row: set for each distinct row below, read by the
  // staging and compute lambdas
  const TH* kb = nullptr;
  const TH* vb = nullptr;
  bool vec = false;
  int len = 0, nk = 0;
  float c_hist = 0.f;
  bool in_pass[2] = {true, true};  // the thread's two rows are the pass's
  bf16* ring = reinterpret_cast<bf16*>(smem + warp * Cfg<D>::WARP_BYTES);
  auto k_slot = [&](int s) { return ring + s * 2 * BK * LD; };
  auto v_slot = [&](int s) { return ring + s * 2 * BK * LD + BK * LD; };
  // the warp's kc-th tile is tile warp + kWarps kc
  auto tile_t0 = [&](int kc) { return (warp + kc * kWarps) * BK; };

  auto copy = [&](int kc, int s) {  // rows off 16-byte boundaries
    const int t0 = tile_t0(kc), n = min(BK, len - t0);
    const bf16 zero = __float2bfloat16(0.f);
    bf16* kd = k_slot(s);
    bf16* vd = v_slot(s);
    for (int e = lane; e < BK * D; e += 32) {
      const int r = e / D, c = e - r * D;
      kd[r * LD + c] =
          r < n ? to_bf16(kb[(long long)(t0 + r) * khs.s + c]) : zero;
      vd[r * LD + c] =
          r < n ? to_bf16(vb[(long long)(t0 + r) * vhs.s + c]) : zero;
    }
  };
  auto stage = [&](int kc, int s) {  // bf16: cp.async, zero rows past n
    const int t0 = tile_t0(kc), n = min(BK, len - t0);
    bf16* kd0 = k_slot(s);
    bf16* vd0 = v_slot(s);
    for (int e = lane; e < CHUNKS; e += 32) {
      const int r = e / CPR, c = (e - r * CPR) * EPC;
      bf16* kd = kd0 + r * LD + c;
      bf16* vd = vd0 + r * LD + c;
      if (r < n) {
        mma::cp_async16(kd, kb + (long long)(t0 + r) * khs.s + c);
        mma::cp_async16(vd, vb + (long long)(t0 + r) * vhs.s + c);
      } else {
        *reinterpret_cast<uint4*>(kd) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vd) = make_uint4(0, 0, 0, 0);
      }
    }
  };
  uint4 pk[PER], pv[PER];
  auto fetch = [&](int kc) {  // int8 codes into registers
    const int t0 = tile_t0(kc), n = min(BK, len - t0);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = lane + j * 32;
      const int r = e / CPR, c = (e - r * CPR) * EPC;
      pk[j] = pv[j] = make_uint4(0, 0, 0, 0);
      if (e < CHUNKS && r < n) {
        pk[j] = __ldg(reinterpret_cast<const uint4*>(
            kb + (long long)(t0 + r) * khs.s + c));
        pv[j] = __ldg(reinterpret_cast<const uint4*>(
            vb + (long long)(t0 + r) * vhs.s + c));
      }
    }
  };
  auto put = [&](int s) {  // registers -> bf16 slot s
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = lane + j * 32;
      if (e < CHUNKS) {
        const int r = e / CPR, c = (e - r * CPR) * EPC;
        uint4 lo, hi;
        i8x16_to_bf16(pk[j], lo, hi);
        uint4* kd = reinterpret_cast<uint4*>(k_slot(s) + r * LD + c);
        kd[0] = lo;
        kd[1] = hi;
        i8x16_to_bf16(pv[j], lo, hi);
        uint4* vd = reinterpret_cast<uint4*>(v_slot(s) + r * LD + c);
        vd[0] = lo;
        vd[1] = hi;
      }
    }
  };

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  auto compute = [&](int kc, int s) {
    const int n = min(BK, len - tile_t0(kc));
    const bf16* kt = k_slot(s);
    const bf16* vt = v_slot(s);
    float sc[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        unsigned bfr[4];
        mma::load_b_rows_x4(bfr, kt, LD, j * 8, kk * 16, lane);
        mma::mma_bf16(sc[j], qf[kk], bfr);
        mma::mma_bf16(sc[j + 1], qf[kk], bfr + 2);
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        sc[j][e] = col < n ? sc[j][e] * c_hist : kNegInf;
      }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = m[half];
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(sc[j][2 * half], sc[j][2 * half + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // another pass's row keeps its state: its factor is an exact 1, so
      // both instantiations run the same (unpredicated) arithmetic and
      // round alike
      const bool mine = in_pass[half];
      const float corr = mine ? mma::ex2(m[half] - mx) : 1.f;
      l[half] *= corr;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        acc[j][2 * half] *= corr;
        acc[j][2 * half + 1] *= corr;
      }
      m[half] = mine ? mx : m[half];
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      float p[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // 0 for a row of another pass: its P V products add exact zeros
          p[jj][e] = in_pass[e >> 1]
                         ? mma::ex2(sc[2 * kk + jj][e] - m[e >> 1])
                         : 0.f;
          l[e >> 1] += p[jj][e];
        }
      if (kk * 16 < n) {
        unsigned ah[4], al[4], bv[NO / 2][4];
        mma::split2(p[0][0], p[0][1], ah[0], al[0]);
        mma::split2(p[0][2], p[0][3], ah[1], al[1]);
        mma::split2(p[1][0], p[1][1], ah[2], al[2]);
        mma::split2(p[1][2], p[1][3], ah[3], al[3]);
#pragma unroll
        for (int jp = 0; jp < NO / 2; ++jp)
          mma::load_b_trans_x4(bv[jp], vt, LD, kk * 16, jp * 16, lane);
#pragma unroll
        for (int j = 0; j < NO; ++j)
          mma::mma_bf16(acc[j], ah, bv[j / 2] + 2 * (j & 1));
#pragma unroll
        for (int j = 0; j < NO; ++j)
          mma::mma_bf16(acc[j], al, bv[j / 2] + 2 * (j & 1));
      }
    }
  };

  // segment 1, once for each distinct pool row of the block's candidates,
  // in candidate order (one pass without a packed index)
  for (int c = 0; c < (packed ? 16 : 1); ++c) {
    const int row = rows[c];
    bool seen = false;
    for (int c2 = 0; c2 < c; ++c2) seen |= rows[c2] == row;
    if (seen) continue;
    in_pass[0] = my_row[0] == row;
    in_pass[1] = my_row[1] == row;
    len = lengths ? min(max(lengths[row], 0), S) : S;
    c_hist = scale * (k_scale ? k_scale[row * Hkv + kvh] : 1.f) * kLog2e;
    kb = k_hist + row * khs.n + kvh * khs.h;
    vb = v_hist + row * vhs.n + kvh * vhs.h;
    vec = ((reinterpret_cast<uintptr_t>(kb) |
            reinterpret_cast<uintptr_t>(vb)) % 16 == 0) &&
          (khs.s * (long long)sizeof(TH)) % 16 == 0 &&
          (vhs.s * (long long)sizeof(TH)) % 16 == 0;
    const int nt = (len + BK - 1) / BK;
    nk = nt > warp ? (nt - warp + kWarps - 1) / kWarps : 0;
    if constexpr (kInt8) {
      if (nk > 0) {
        if (vec) {
          fetch(0);
          put(0);
          if (nk > 1) fetch(1);
        } else {
          copy(0, 0);
        }
      }
      __syncwarp();
      for (int kc = 0; kc < nk; ++kc) {
        if (kc + 1 < nk) {  // slot (kc + 1) & 1 was freed by the last syncwarp
          if (vec) {
            put((kc + 1) & 1);
            if (kc + 2 < nk) fetch(kc + 2);
          } else {
            copy(kc + 1, (kc + 1) & 1);
          }
        }
        compute(kc, kc & 1);
        __syncwarp();
      }
    } else {
      auto stage_any = [&](int kc, int s) {
        if (vec)
          stage(kc, s);
        else
          copy(kc, s);
        mma::cp_async_commit();
      };
      if (nk > 0) stage_any(0, 0);
      for (int kc = 0; kc < nk; ++kc) {
        if (kc + 1 < nk) {
          stage_any(kc + 1, (kc + 1) & 1);
          mma::cp_async_wait<1>();
        } else {
          mma::cp_async_wait<0>();
        }
        __syncwarp();
        compute(kc, kc & 1);
        __syncwarp();
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
  }

  // combine the warps' states in warp order (the rings are reused)
  constexpr int PERT = NO * 4 + 4;  // floats per thread: acc, m, l
  __syncthreads();
  float* st = reinterpret_cast<float*>(smem);
  if (warp > 0) {
    float* mine = st + ((warp - 1) * 32 + lane) * PERT;
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[j * 4 + e] = acc[j][e];
    mine[NO * 4] = m[0];
    mine[NO * 4 + 1] = m[1];
    mine[NO * 4 + 2] = l[0];
    mine[NO * 4 + 3] = l[1];
  }
  __syncthreads();
  if (warp > 0) return;  // no barrier follows
  float f[kWarps][2];
  {
    float mw[kWarps][2];
    mw[0][0] = m[0];
    mw[0][1] = m[1];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float* other = st + ((w - 1) * 32 + lane) * PERT;
      mw[w][0] = other[NO * 4];
      mw[w][1] = other[NO * 4 + 1];
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = mw[0][half];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, mw[w][half]);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) f[w][half] = mma::ex2(mw[w][half] - mx);
      m[half] = mx;
      l[half] *= f[0][half];
    }
  }
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= f[0][e >> 1];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    const float* other = st + ((w - 1) * 32 + lane) * PERT;
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = fmaf(other[j * 4 + e], f[w][e >> 1], acc[j][e]);
    l[0] = fmaf(other[NO * 4 + 2], f[w][0], l[0]);
    l[1] = fmaf(other[NO * 4 + 3], f[w][1], l[1]);
  }

  // segment 2: each row's own key, then the store
  const bf16* kcb = k_cand + b * kcs.n + kvh * kcs.h;
  const bf16* vcb = v_cand + b * vcs.n + kvh * vcs.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = w0 + g + 8 * half;
    const bool live = r < M;
    const bf16* kr = kcb + (long long)(live ? r : w0) * kcs.s;
    const bf16* vr = vcb + (long long)(live ? r : w0) * vcs.s;
    float dot = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const unsigned w = qf[kk][half + 2 * hi];
        const int c = kk * 16 + 2 * t + 8 * hi;
        dot = fmaf(__uint_as_float(w << 16), __bfloat162float(kr[c]), dot);
        dot = fmaf(__uint_as_float(w & 0xffff0000u),
                   __bfloat162float(kr[c + 1]), dot);
      }
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    dot += __shfl_xor_sync(0xffffffffu, dot, 2);
    const float xs = dot * c_self;
    const float mx = fmaxf(m[half], xs);
    const float corr = mma::ex2(m[half] - mx);
    const float p = mma::ex2(xs - mx);
    const float den = fmaxf(l[half] * corr + p, 1e-30f);
    const float fv =
        (v_scale ? v_scale[my_row[half] * Hkv + kvh] : 1.f) * corr;
    if (live) {
      bf16* orow = o + b * os.n + h * os.h + (long long)r * os.s;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const int c = j * 8 + 2 * t;
        const float o0 =
            fmaf(p, __bfloat162float(vr[c]), acc[j][2 * half] * fv);
        const float o1 =
            fmaf(p, __bfloat162float(vr[c + 1]), acc[j][2 * half + 1] * fv);
        orow[c] = __float2bfloat16(o0 / den);
        orow[c + 1] = __float2bfloat16(o1 / den);
      }
    }
  }
}

}  // namespace cs

template <typename TH, int D>
cudaError_t launch_mma(const ScoreArgs& a, cudaStream_t stream) {
  constexpr int bytes = cs::Cfg<D>::SMEM;
  auto kernel = cs::cached_mma_kernel<TH, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.M + 15) / 16, a.B * a.H);
  kernel<<<grid, 32 * cs::kWarps, bytes, stream>>>(
      static_cast<const mma::bf16*>(a.q), static_cast<const TH*>(a.k_hist),
      static_cast<const TH*>(a.v_hist), a.k_scale, a.v_scale,
      static_cast<const mma::bf16*>(a.k_cand),
      static_cast<const mma::bf16*>(a.v_cand), a.row_index, a.lengths,
      static_cast<mma::bf16*>(a.o), a.H, a.Hkv, a.M, a.U, a.S, a.st[0],
      a.st[1], a.st[2], a.st[3], a.st[4], a.st[5], a.scale, a.packed);
  return cudaGetLastError();
}

// Launch plan: out[0..3] = grid x, grid y, threads per block, shared
// bytes (dynamic for the tensor-core kernel, mma_kernel != 0; static for
// the scalar one).
inline void score_plan(int mma_kernel, int B, int M, int H, int D, int* out) {
  if (mma_kernel) {
    out[0] = (M + 15) / 16;
    out[1] = B * H;
    out[2] = 32 * cs::kWarps;
    out[3] = 2 * 2 * (D <= 16 ? 64 : 2048 / D) * (D + 8) * 2 * cs::kWarps;
  } else {
    out[0] = (M + kRows - 1) / kRows;
    out[1] = B * H;
    out[2] = kRows;
    out[3] = 2 * (D <= 64 ? 64 : 32) * D * 4;
  }
}

}  // namespace flame
