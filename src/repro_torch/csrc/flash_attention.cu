// Mask-aware GQA flash attention for Hopper (sm_90a) — kernel K2 of the port.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention_kernel (body _fa_kernel).  It computes the same function:
// softmax(q k^T / sqrt(D)) v per (batch, head) with GQA head groups, under one
// of four masks — full, causal, sliding (window), sumi (n_history causal
// rows, candidates see history + self) — with q_offset placing query row i
// at absolute key position q_offset + i (sumi and causal).
//
// Bound: at the Climber encode shape ([4, 257, 4, 64] bf16, causal) the
// function moves ~1 MB and does ~0.27 GFLOP, under a microsecond either way
// on an H100.  What sets the time is latency: how long the longest chain of
// dependent work in one block takes, and the launch.  The first version (one
// thread per query row, scalar f32 FMAs over keys converted to f32 in shared
// memory, 144 one-warp blocks) ran ~170x its bound.
//
// Design of the bf16 kernel (the serving path), against that latency:
// - both products on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//   accumulate), one warp per 16 query rows.  Q stays in registers as bf16
//   A fragments; S = Q K^T comes from K's rows by ldmatrix, is scaled by
//   1/sqrt(D) in f32 (1/sqrt(32) is not exact in bf16) and goes through the
//   online softmax in f32, row max and sum across the quad by shuffles, the
//   exponentials as 2^x on the special-function unit with the scale folded
//   into one FMA;
// - P enters the P V product as bf16 hi + lo (hi = bf16(p), lo = bf16(p -
//   hi)), with V's B fragments from ldmatrix.trans.  Rounding P once to
//   bf16 would err by up to 2^-9 of a weight, which for rows that see few
//   keys is more than the bf16 gate (1e-3 + 1.6e-2 |out|) admits near small
//   outputs; hi + lo keeps ~16 bits of P;
// - K and V staged as bf16 in a two-stage shared-memory ring filled by
//   cp.async, so the next key tile loads while this one computes.  Rows off
//   16-byte boundaries are staged element by element (the same kernel);
// - the mask's dead key ranges are loop bounds (the TPU kernel's block
//   skipping), a warp skips a tile that none of its rows sees, and the
//   per-element mask runs only in tiles that straddle a mask edge;
// - 4 warps per block (64 query rows) share each staged K / V tile: 80
//   blocks at the encode shape.  Measured on an H100, that beat 1 or 2
//   warps per block (more, smaller blocks that stage the same keys again)
//   and 8 at every path shape;
// - each query row is finished by one warp in a fixed key order: no
//   atomics, no split over keys, so two calls give bitwise equal outputs.
//   A masked key adds an exact zero and a fully masked row gives zeros.
// - head dims 16, 32, 64, 128 and 256 (the text models' 240 runs padded to
//   256 by the wrapper, 120 to 128).  At 256 a warp's [16, 256] f32 output
//   alone takes 128 registers a thread, so Q stays in shared memory (its A
//   fragments loaded by ldmatrix at each k step, instead of 64 registers
//   more) and V's B fragments are loaded a pair of n tiles at a time; the
//   staged K / V tiles and Q (~101 KB) live in dynamic shared memory.
// f32 operands keep the scalar kernel (attention_common.cuh), up to head dim
// 128: no tensor-core type holds f32 exactly.
#include <type_traits>

#include "attention_common.cuh"
#include "attention_mask.cuh"
#include "mma_bf16.cuh"

namespace flame {

// ---------------------------------------------------------------------------
// f32 operands: one thread per query row, scalar FMAs
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int H,
                           int Hkv, int Sq, int Sk, Strides qs, Strides ks,
                           Strides vs, Strides os, int mode, int window,
                           int n_history, int q_offset, float scale) {
  constexpr int BK = Tile<D>::keys;
  __shared__ __align__(16) float k_tile[BK * D];
  __shared__ __align__(16) float v_tile[BK * D];

  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int kvh = h / (H / Hkv);
  const int r0 = blockIdx.x * kRows;
  const int r1 = min(r0 + kRows, Sq);  // exclusive end of this q tile
  const int r = r0 + threadIdx.x;
  const bool live = r < Sq;
  const int a = r + q_offset;  // absolute key position of this query row

  Row<D> st;
  st.reset();
  st.load_q(q + b * qs.n + h * qs.h + (long long)(live ? r : r0) * qs.s, live,
            scale);

  auto visible = [&](int col) -> bool {
    if (!live) return false;
    switch (mode) {
      case kFull:
        return true;
      case kCausal:
        return col <= a;
      case kSliding:
        return col <= a && a - col < window;
      default:  // kSumi
        return a < n_history ? col <= a : (col < n_history || col == a);
    }
  };

  // key ranges [lo, hi) this q tile can see (uniform over the block)
  int lo0 = 0, hi0 = Sk, lo1 = 0, hi1 = 0;
  const int diag = min(Sk, q_offset + r1);  // one past the last row's own key
  if (mode == kCausal) {
    hi0 = diag;
  } else if (mode == kSliding) {
    lo0 = max(0, r0 + q_offset - window + 1);
    hi0 = diag;
  } else if (mode == kSumi) {
    hi0 = min(n_history, diag);                 // history keys
    lo1 = max(n_history, q_offset + r0);        // the rows' own keys
    hi1 = diag;
  }

  const T* kb = k + b * ks.n + kvh * ks.h;
  const T* vb = v + b * vs.n + kvh * vs.h;
  for (int seg = 0; seg < 2; ++seg) {
    const int lo = seg ? lo1 : lo0;
    const int hi = seg ? hi1 : hi0;
    for (int t0 = lo; t0 < hi; t0 += BK) {
      const int n = min(BK, hi - t0);
      __syncthreads();
      load_tile<T, D>(k_tile, kb + t0 * ks.s, ks.s, n, 1.f);
      load_tile<T, D>(v_tile, vb + t0 * vs.s, vs.s, n, 1.f);
      __syncthreads();
      st.fold(k_tile, v_tile, n, [&](int t) { return visible(t0 + t); });
    }
  }
  if (live) st.store(o + b * os.n + h * os.h + (long long)r * os.s);
}

// ---------------------------------------------------------------------------
// bf16 operands: tensor-core tiles
// ---------------------------------------------------------------------------

namespace fa2 {

using mma::bf16;
constexpr int kWarps = 4;  // per block, 16 query rows each

template <int D>
struct Cfg {
  static constexpr int BK = D <= 64 ? 64 : 32;  // keys per tile
  static constexpr int LD = D + 8;  // padded row: ldmatrix conflict-free
  // D 256: a warp's [16, 256] f32 output takes 128 registers a thread, so
  // Q stays in shared memory (A fragments by ldmatrix at each k step)
  // instead of 64 more registers, and K, V and Q live in dynamic shared
  // memory (~101 KB: past the 48 KB of static shared memory)
  static constexpr bool QS = D > 128;
  static constexpr int RING = BK * LD;  // elements of one staged tile
  static constexpr int DYN_BYTES =
      QS ? (4 * RING + kWarps * 16 * LD) * 2 : 0;
};

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
    flash_attention_mma_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               bf16* __restrict__ o, int H, int Hkv, int Sq,
                               int Sk, Strides qs, Strides ks, Strides vs,
                               Strides os, int mode, int window,
                               int n_history, int q_offset, float scale) {
  constexpr int BK = Cfg<D>::BK, LD = Cfg<D>::LD;
  constexpr int KD = D / 16;   // k steps of the scores
  constexpr int NS = BK / 8;   // n tiles of the scores
  constexpr int NO = D / 8;    // n tiles of the output
  constexpr int C8 = D / 8;    // 16-byte chunks of a K / V row
  constexpr bool QS = Cfg<D>::QS;
  constexpr int RING = Cfg<D>::RING;
  bf16* k_s;  // two ring slots of K tiles, then two of V (then Q, for QS)
  bf16* v_s;
  bf16* q_s = nullptr;
  if constexpr (QS) {
    extern __shared__ __align__(16) unsigned char fa_dyn[];
    k_s = reinterpret_cast<bf16*>(fa_dyn);
    v_s = k_s + 2 * RING;
    q_s = v_s + 2 * RING;
  } else {
    __shared__ __align__(16) bf16 k_st[2 * RING];
    __shared__ __align__(16) bf16 v_st[2 * RING];
    k_s = k_st;
    v_s = v_st;
  }

  constexpr int nthreads = kWarps * 32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int kvh = h / (H / Hkv);
  const int r0 = blockIdx.x * nthreads / 2;  // 16 rows per warp
  const int r1 = min(r0 + nthreads / 2, Sq);
  const int w0 = r0 + warp * 16;  // this warp's first row
  const bool warp_live = w0 < Sq;
  const int A0 = w0 + q_offset;                     // absolute positions
  const int A1 = min(w0 + 15, Sq - 1) + q_offset;   // of its live rows
  // scores go to the exponent in base 2: exp(s / sqrt(D)) = 2^(s scale2)
  const float scale2 = scale * 1.4426950408889634f;

  // Q as bf16 A fragments, rows w0 + g and w0 + g + 8 (pairs of columns as
  // one 32-bit load where the rows allow); for QS the warp's 16 rows into
  // its rows of q_s instead (zeros past Sq)
  unsigned qf[QS ? 1 : KD][4];
  if constexpr (QS) {
    const bf16* qb = q + b * qs.n + h * qs.h;
    const bf16 zero = __float2bfloat16(0.f);
    bf16* qw = q_s + warp * 16 * LD;
    for (int e = lane; e < 16 * D; e += 32) {
      const int r = e / D, c = e - r * D;
      qw[r * LD + c] = w0 + r < Sq ? qb[(long long)(w0 + r) * qs.s + c] : zero;
    }
    __syncwarp();
  } else {
    const bf16* qb = q + b * qs.n + h * qs.h;
    const bool pairs = reinterpret_cast<uintptr_t>(qb) % 4 == 0 &&
                       qs.s % 2 == 0;
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
          if (r < Sq)
            w = pairs ? mma::ld32(qr + c) : mma::pack2(qr[c], qr[c + 1]);
          qf[kk][half + 2 * hi] = w;
        }
      }
    }
  }

  // key ranges [lo, hi) this q tile can see (uniform over the block)
  int lo0 = 0, hi0 = Sk, lo1 = 0, hi1 = 0;
  const int diag = min(Sk, q_offset + r1);  // one past the last row's own key
  if (mode == kCausal) {
    hi0 = diag;
  } else if (mode == kSliding) {
    lo0 = max(0, r0 + q_offset - window + 1);
    hi0 = diag;
  } else if (mode == kSumi) {
    hi0 = min(n_history, diag);
    lo1 = max(n_history, q_offset + r0);
    hi1 = diag;
  }
  const int nt0 = hi0 > lo0 ? (hi0 - lo0 + BK - 1) / BK : 0;
  const int nt1 = hi1 > lo1 ? (hi1 - lo1 + BK - 1) / BK : 0;
  const int nt = nt0 + nt1;
  auto tile_at = [&](int i, int& t0, int& n) {
    const int lo = i < nt0 ? lo0 : lo1, hi = i < nt0 ? hi0 : hi1;
    t0 = lo + (i < nt0 ? i : i - nt0) * BK;
    n = min(BK, hi - t0);
  };

  const bf16* kb = k + b * ks.n + kvh * ks.h;
  const bf16* vb = v + b * vs.n + kvh * vs.h;
  const bool vec = ((reinterpret_cast<uintptr_t>(kb) |
                     reinterpret_cast<uintptr_t>(vb)) % 16 == 0) &&
                   ks.s % 8 == 0 && vs.s % 8 == 0;
  // stage key tile i into ring slot s: 16-byte cp.async (each thread one
  // column chunk of every rstep-th row), or element copies for rows off
  // 16-byte boundaries; rows past the tile's end are zero
  auto stage = [&](int i, int s) {
    int t0, n;
    tile_at(i, t0, n);
    bf16* kd = k_s + s * RING;
    bf16* vd = v_s + s * RING;
    if (vec) {
      const int rstep = nthreads / C8;
      const int c = (tid % C8) * 8;
      int r = tid / C8;
      const bf16* kp = kb + (long long)(t0 + r) * ks.s + c;
      const bf16* vp = vb + (long long)(t0 + r) * vs.s + c;
      const long long kstep = (long long)rstep * ks.s;
      const long long vstep = (long long)rstep * vs.s;
      for (; r < BK; r += rstep, kp += kstep, vp += vstep) {
        if (r < n) {
          mma::cp_async16(kd + r * LD + c, kp);
          mma::cp_async16(vd + r * LD + c, vp);
        } else {
          *reinterpret_cast<uint4*>(kd + r * LD + c) = make_uint4(0, 0, 0, 0);
          *reinterpret_cast<uint4*>(vd + r * LD + c) = make_uint4(0, 0, 0, 0);
        }
      }
    } else {
      const bf16 zero = __float2bfloat16(0.f);
      for (int e = tid; e < BK * D; e += nthreads) {
        const int r = e / D, c = e - r * D;
        kd[r * LD + c] = r < n ? kb[(long long)(t0 + r) * ks.s + c] : zero;
        vd[r * LD + c] = r < n ? vb[(long long)(t0 + r) * vs.s + c] : zero;
      }
    }
    mma::cp_async_commit();
  };

  float m[2] = {kNegInf, kNegInf};  // running max (unscaled) of g, g + 8
  float l[2] = {0.f, 0.f};          // this thread's part of the row sums
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  if (nt > 0) stage(0, 0);
  for (int i = 0; i < nt; ++i) {
    if (i + 1 < nt) {
      stage(i + 1, (i + 1) & 1);   // in flight while tile i computes
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    int t0, n;
    tile_at(i, t0, n);
    int state = warp_live ? tile_state(mode, A0, A1, t0, t0 + n - 1, window,
                                       n_history)
                          : 0;
    if (state == 1 && n < BK) state = 2;  // keys past n are padding
    if (state) {
      const bf16* kt = k_s + (i & 1) * RING;
      const bf16* vt = v_s + (i & 1) * RING;
      // S = Q K^T on the tensor cores
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        unsigned qa[4];
        if constexpr (QS)
          mma::load_a_x4(qa, q_s, LD, warp * 16, kk * 16, lane);
        const unsigned* af = QS ? qa : qf[QS ? 0 : kk];
#pragma unroll
        for (int j = 0; j < NS; j += 2) {
          unsigned bfr[4];
          mma::load_b_rows_x4(bfr, kt, LD, j * 8, kk * 16, lane);
          mma::mma_bf16(s[j], af, bfr);
          mma::mma_bf16(s[j + 1], af, bfr + 2);
        }
      }
      // masked keys (edge tiles only) get the sentinel kNegInf
      if (state == 2) {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = j * 8 + 2 * t + (e & 1);
            const int a = w0 + g + 8 * (e >> 1) + q_offset;
            if (col >= n || !visible(mode, a, t0 + col, window, n_history))
              s[j][e] = kNegInf;
          }
        }
      }
      // online softmax in f32: row max across the quad, rescale
      float ms[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float mx = m[half];
#pragma unroll
        for (int j = 0; j < NS; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * half], s[j][2 * half + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // 0 while the row has seen no visible key, so that its masked keys
        // still give exact zeros below
        ms[half] = mx == kNegInf ? 0.f : mx * scale2;
        const float corr = mma::ex2(m[half] * scale2 - ms[half]);
        l[half] *= corr;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          acc[j][2 * half] *= corr;
          acc[j][2 * half + 1] *= corr;
        }
        m[half] = mx;
      }
      // P in f32 (a masked key gives 2^-huge = +0) and O += P V with P as
      // bf16 hi + lo, one 16-key step at a time
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        float p[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[jj][e] = mma::ex2(fmaf(s[2 * kk + jj][e], scale2, -ms[e >> 1]));
            l[e >> 1] += p[jj][e];
          }
        if (kk * 16 < n) {
          unsigned ah[4], al[4];
          mma::split2(p[0][0], p[0][1], ah[0], al[0]);
          mma::split2(p[0][2], p[0][3], ah[1], al[1]);
          mma::split2(p[1][0], p[1][1], ah[2], al[2]);
          mma::split2(p[1][2], p[1][3], ah[3], al[3]);
          if constexpr (QS) {
            // V's fragments a pair of n tiles at a time (all 16 pairs
            // would take 64 registers); each accumulator still takes its
            // hi product, then its lo one
#pragma unroll
            for (int jp = 0; jp < NO / 2; ++jp) {
              unsigned bv[4];
              mma::load_b_trans_x4(bv, vt, LD, kk * 16, jp * 16, lane);
              mma::mma_bf16(acc[2 * jp], ah, bv);
              mma::mma_bf16(acc[2 * jp + 1], ah, bv + 2);
              mma::mma_bf16(acc[2 * jp], al, bv);
              mma::mma_bf16(acc[2 * jp + 1], al, bv + 2);
            }
          } else {
            unsigned bv[NO / 2][4];
#pragma unroll
            for (int jp = 0; jp < NO / 2; ++jp)
              mma::load_b_trans_x4(bv[jp], vt, LD, kk * 16, jp * 16, lane);
            // the hi products of every n tile, then the lo ones: no two
            // neighbouring MMAs share an accumulator
#pragma unroll
            for (int j = 0; j < NO; ++j)
              mma::mma_bf16(acc[j], ah, bv[j / 2] + 2 * (j & 1));
#pragma unroll
            for (int j = 0; j < NO; ++j)
              mma::mma_bf16(acc[j], al, bv[j / 2] + 2 * (j & 1));
          }
        }
      }
    }
    __syncthreads();  // every warp is done with slot i & 1
  }

  // finish: row sums across the quad, normalise, store bf16 pairs
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    const int r = w0 + g + 8 * half;
    if (r < Sq) {
      const float den = fmaxf(l[half], 1e-30f);
      bf16* orow = o + b * os.n + h * os.h + (long long)r * os.s;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const int c = j * 8 + 2 * t;
        orow[c] = __float2bfloat16(acc[j][2 * half] / den);
        orow[c + 1] = __float2bfloat16(acc[j][2 * half + 1] / den);
      }
    }
  }
}

}  // namespace fa2

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Hkv, int Sq, int Sk, const Strides* st,
                   int mode, int window, int n_history, int q_offset,
                   float scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const dim3 grid((Sq + 16 * fa2::kWarps - 1) / (16 * fa2::kWarps), B * H);
    constexpr int bytes = fa2::Cfg<D>::DYN_BYTES;
    if constexpr (bytes > 0) {
      const cudaError_t err = cudaFuncSetAttribute(
          fa2::flash_attention_mma_kernel<D>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return err;
    }
    fa2::flash_attention_mma_kernel<D><<<grid, 32 * fa2::kWarps, bytes,
                                         stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, Sq, Sk, st[0],
        st[1], st[2], st[3], mode, window, n_history, q_offset, scale);
  } else {
    const dim3 grid((Sq + kRows - 1) / kRows, B * H);
    flash_attention_kernel<T, D><<<grid, kRows, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, Sq, Sk, st[0],
        st[1], st[2], st[3], mode, window, n_history, q_offset, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, int B, int H, int Hkv, int Sq, int Sk,
                       const Strides* st, int mode, int window, int n_history,
                       int q_offset, float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, H, Hkv, Sq, Sk, st, mode, window,
                           n_history, q_offset, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, Hkv, Sq, Sk, st, mode, window,
                           n_history, q_offset, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, Hkv, Sq, Sk, st, mode, window,
                           n_history, q_offset, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, Hkv, Sq, Sk, st, mode, window,
                            n_history, q_offset, scale, stream);
    case 256:  // bf16 only: the f32 kernel's key tiles would pass 48 KB
      if constexpr (std::is_same<T, __nv_bfloat16>::value)
        return launch<T, 256>(q, k, v, o, B, H, Hkv, Sq, Sk, st, mode, window,
                              n_history, q_offset, scale, stream);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace flame

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).
// strides: 12 int64 — (batch, seq, head) element strides of q, k, v, o; o's
// rows must hold their D elements contiguously.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int B, int H, int Hkv,
                                   int Sq, int Sk, int D,
                                   const long long* strides, int mode,
                                   int window, int n_history, int q_offset,
                                   float scale, void* stream) {
  using namespace flame;
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Sq <= 0 || Sk <= 0 ||
      mode < kFull || mode > kSumi)
    return cudaErrorInvalidValue;
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, B, H, Hkv, Sq, Sk, st, mode,
                             window, n_history, q_offset, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, H, Hkv, Sq, Sk, st,
                                     mode, window, n_history, q_offset, scale,
                                     s);
  return cudaErrorInvalidValue;
}

// Launch plan of the kernel for these shapes: out[0..3] = grid x, grid y,
// threads per block, shared-memory bytes (static; dynamic at D 256).
extern "C" int flash_attention_plan(int dtype, int B, int H, int Sq, int D,
                                    int* out) {
  using namespace flame;
  if (B <= 0 || H <= 0 || Sq <= 0) return cudaErrorInvalidValue;
  if (dtype == 1) {
    const int bk = D <= 64 ? 64 : 32;
    out[0] = (Sq + 16 * fa2::kWarps - 1) / (16 * fa2::kWarps);
    out[1] = B * H;
    out[2] = 32 * fa2::kWarps;
    out[3] = 2 * 2 * bk * (D + 8) * 2 +
             (D > 128 ? fa2::kWarps * 16 * (D + 8) * 2 : 0);
  } else {
    out[0] = (Sq + kRows - 1) / kRows;
    out[1] = B * H;
    out[2] = kRows;
    out[3] = 2 * (D <= 64 ? 64 : 32) * D * 4;
  }
  return cudaSuccess;
}
